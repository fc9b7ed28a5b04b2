"""The port's signed-window MSM (plonky_tpu_torch.curves.msm with
signed=True, plain versions on the CPU) against the JAX package's
(plonky_tpu.curves.msm, signed=True) and a naive host MSM: the recoding at
edge scalars, `msm` at the JAX package's own cases and a multi-MSM,
`msm_chunked`, one BLS12-377 case, the signed accumulation against direct
signed bucket sums, the reduction at 1,025 and 2,049 buckets, and the
reduction's segment width, which the kernel and the plain version take
from one function.  Canonical ints and affine points are compared exactly
(ROADMAP C4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky_tpu.curves import TWEEDLEDEE as J_CURVE
from plonky_tpu.curves import msm as jmsm
from plonky_tpu.curves import ops as jcops
from plonky_tpu.fields import ops as jfops
from plonky_tpu_torch import _cuda
from plonky_tpu_torch.curves import BLS12_377
from plonky_tpu_torch.curves import TWEEDLEDEE as CURVE
from plonky_tpu_torch.curves import host as chost
from plonky_tpu_torch.curves import msm as cmsm
from plonky_tpu_torch.curves import ops as cops
from plonky_tpu_torch.fields import ops as fops
from plonky_tpu_torch.protocol.circuit import (device_points_to_host,
                                               ints_to_device_matrix,
                                               points_to_device)

# The plain versions run thousands of small tensor ops: extra intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)


def _points(curve, n, seed):
    g = chost.generator(curve)
    rng = np.random.default_rng(seed)
    pts = [chost.mul(g, int(rng.integers(2, 1 << 62))) for _ in range(n)]
    pts[min(3, n - 1)] = chost.zero_point(curve)     # an identity in the basis
    return pts


def _scalars(curve, k, n, seed):
    p = curve.scalar.p
    rng = np.random.default_rng(seed)
    rows = [[int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)]
            for _ in range(k)]
    rows[0][:3] = [0, 1, p - 1][:n]
    return rows


def _naive(curve, pts, row):
    acc = chost.zero_point(curve)
    for pt, s in zip(pts, row):
        acc = chost.add(acc, chost.mul(pt, s))
    return acc


def _edge_scalars(c):
    """0, 1, p - 1, windows at 2^(c-1) - 1, 2^(c-1) and 2^c - 1 (alone, in
    every window, alternating), a carry through every window, the top
    window at its largest, and 48 random scalars."""
    p = CURVE.scalar.p
    w = -(-CURVE.scalar.bits // c)
    half, full = 1 << (c - 1), (1 << c) - 1

    def spread(digits):
        return sum(d << (c * i) for i, d in enumerate(digits)) % p
    vals = [0, 1, p - 1, half - 1, half, full, half << c, full << (c * 3),
            spread([half] * (w - 1)), spread([half - 1] * (w - 1)),
            spread([full] * (w - 1)), spread([half, half - 1] * w),
            (1 << (c * (w - 1))) - 1, p - 1 - (half << c),
            ((1 << (CURVE.scalar.bits - 1)) - 1), 1 << (c * (w - 1))]
    rng = np.random.default_rng(c)
    vals += [int.from_bytes(rng.bytes(32), "little") for _ in range(48)]
    return [v % p for v in vals]


@pytest.mark.parametrize("c", [3, 4, 5, 8, 9, 10, 12])
def test_signed_digits_match_jax(c):
    vals = _edge_scalars(c)
    mags, signs = cmsm.scalar_window_digits_signed(
        CURVE.scalar, fops.from_ints(CURVE.scalar, vals, "cpu"), c)
    jm, js = jax.jit(lambda s: jmsm.scalar_window_digits_signed(
        J_CURVE.scalar, s, c))(jfops.from_ints(J_CURVE.scalar, vals))
    w = -(-CURVE.scalar.bits // c) + 1
    assert mags.shape == signs.shape == (w, len(vals))
    assert mags.tolist() == np.asarray(jm).tolist()
    assert signs.tolist() == np.asarray(js).tolist()
    assert int(mags.min()) >= 0 and int(mags.max()) <= 1 << (c - 1)
    for j, v in enumerate(vals):
        assert sum(int(signs[i, j]) * int(mags[i, j]) << (c * i)
                   for i in range(w)) == v


def _jax_msm(pts, rows, c):
    f = J_CURVE.base
    jpts = jcops.from_affine(
        J_CURVE, jfops.from_ints(f, [0 if p.zero else p.x for p in pts]),
        jfops.from_ints(f, [0 if p.zero else p.y for p in pts]),
        jnp.asarray(np.array([p.zero for p in pts])))
    if len(rows) == 1:
        jscal = jfops.from_ints(J_CURVE.scalar, rows[0])
    else:
        jscal = jnp.stack([jfops.from_ints(J_CURVE.scalar, r) for r in rows],
                          axis=1)
    jx, jy, jzero = jax.jit(lambda P, S: jcops.to_affine(
        J_CURVE, jmsm.msm_jit(J_CURVE, c, signed=True)(P, S)))(jpts, jscal)
    return [chost.zero_point(CURVE) if bool(z) else
            chost.AffinePoint(CURVE, int(x), int(y))
            for x, y, z in zip(np.asarray(jfops.to_ints(f, jx)).reshape(-1),
                               np.asarray(jfops.to_ints(f, jy)).reshape(-1),
                               np.asarray(jzero).reshape(-1))]


@pytest.mark.parametrize("n,c,k", [(8, 4, 1), (33, 8, 1), (16, 10, 1),
                                   (16, 8, 3)])
def test_msm_signed_matches_jax(n, c, k):
    """tests/test_curves.py's signed cases (n, c) = (8, 4), (33, 8),
    (16, 10), and a multi-MSM of K = 3 over one basis."""
    pts, rows = _points(CURVE, n, n + c), _scalars(CURVE, k, n, 3 * n + c + k)
    basis = cmsm.precompute_base(CURVE, points_to_device(CURVE, pts, "cpu"))
    scal = ints_to_device_matrix(CURVE.scalar, rows, "cpu")
    if k == 1:
        scal = scal[:, 0]
    got = device_points_to_host(CURVE, cmsm.msm(CURVE, basis, scal, c,
                                                signed=True))
    assert got == _jax_msm(pts, rows, c)
    assert got == [_naive(CURVE, pts, r) for r in rows]


def test_msm_signed_c12_matches_naive():
    """2,049 buckets and 23 windows; the reduction takes 64 buckets a
    segment there."""
    n, c = 13, 12
    pts, rows = _points(CURVE, n, 12), _scalars(CURVE, 2, n, 12)
    rows[1] = [CURVE.scalar.p - 1 - v for v in rows[0]]
    basis = cmsm.precompute_base(CURVE, points_to_device(CURVE, pts, "cpu"))
    got = device_points_to_host(CURVE, cmsm.msm(
        CURVE, basis, ints_to_device_matrix(CURVE.scalar, rows, "cpu"), c,
        signed=True))
    assert got == [_naive(CURVE, pts, r) for r in rows]


def test_msm_chunked_signed_matches_unsigned():
    """Three slices of 2^4 points, signed against unsigned and the host;
    N not a multiple of the slice is refused either way."""
    n, c = 48, 5
    pts, rows = _points(CURVE, n, 48), _scalars(CURVE, 2, n, 48)
    basis = cmsm.precompute_base(CURVE, points_to_device(CURVE, pts, "cpu"))
    scal = ints_to_device_matrix(CURVE.scalar, rows, "cpu")
    signed = device_points_to_host(CURVE, cmsm.msm_chunked(
        CURVE, basis, scal, window_bits=c, chunk_log=4, signed=True))
    unsigned = device_points_to_host(CURVE, cmsm.msm_chunked(
        CURVE, basis, scal, window_bits=c, chunk_log=4))
    assert signed == unsigned == [_naive(CURVE, pts, r) for r in rows]
    with pytest.raises(ValueError):
        cmsm.msm_chunked(CURVE, basis.slice(0, 40), scal[..., :40], c, 4,
                         signed=True)


def test_msm_signed_bls12_377():
    """BLS12-377 G1 at 12 limbs, 5 points, c = 4 and 9."""
    n = 5
    pts, rows = _points(BLS12_377, n, 377), _scalars(BLS12_377, 1, n, 377)
    basis = cmsm.precompute_base(BLS12_377, points_to_device(BLS12_377, pts, "cpu"))
    scal = ints_to_device_matrix(BLS12_377.scalar, rows, "cpu")[:, 0]
    for c in (4, 9):
        assert device_points_to_host(BLS12_377, cmsm.msm(
            BLS12_377, basis, scal, c, signed=True)) == [
                _naive(BLS12_377, pts, rows[0])]


N = 50


@pytest.fixture(scope="module")
def points():
    return _points(CURVE, N, 11)


def _signed_rows(c, seed):
    """[R, N] magnitudes in [0, 2^(c-1)] and signs: random, one bucket of
    both signs, all zero, two long runs of mixed signs."""
    rng = np.random.default_rng(seed)
    half = 1 << (c - 1)
    mags = [[int(v) if v % 3 else 0 for v in rng.integers(0, half + 1, N)],
            [half] * N, [0] * N, [half] * (N // 2) + [1] * (N - N // 2)]
    signs = [[1 if v else -1 for v in rng.integers(0, 2, N)] for _ in mags]
    return mags, signs


def _sorted_inputs(mags, signs, nb):
    rows = torch.tensor(mags, dtype=torch.int64)
    digits, order = torch.sort(rows, dim=-1, stable=True)
    sorted_signs = torch.gather(torch.tensor(signs), 1, order)
    return (digits.to(torch.int32), order.to(torch.int32),
            cmsm._run_starts(digits, nb), sorted_signs)


@pytest.mark.parametrize("chunk,tile", [(3, 4), (7, 1), (64, 128)])
def test_signed_accumulation_matches_signed_bucket_sums(points, chunk, tile):
    """Bucket j (plus its carries) is the sum of sign_i P_i over the
    positions of magnitude j; a negative sign negates Y at the gather."""
    c = 4
    nb = (1 << (c - 1)) + 1
    mags, signs = _signed_rows(c, chunk)
    digits, order, starts, sorted_signs = _sorted_inputs(mags, signs, nb)
    basis = cmsm.precompute_base(CURVE, points_to_device(CURVE, points, "cpu"))
    buckets, carries = cmsm.bucket_accumulate_plain(
        CURVE, basis, digits, order, starts, chunk=chunk, tile=tile,
        signs=sorted_signs)
    tp = chunk * tile
    for r in range(len(mags)):
        want = [chost.zero_point(CURVE) for _ in range(nb)]
        for pt, m, s in zip(points, mags[r], signs[r]):
            if m:
                want[m] = chost.add(want[m], pt if s > 0 else pt.neg())
        b = cmsm.unpack_points(CURVE, buckets[r])
        cs = cmsm.unpack_points(CURVE, carries[r])
        for j in range(1, nb):
            lo, hi = int(starts[r, j]), int(starts[r, j + 1])
            if hi == lo:
                assert not buckets[r, j].any()
                continue
            total = tuple(t[:, j:j + 1] for t in b)
            for t in range(lo // tp + 1, (hi - 1) // tp + 1):
                total = cops.add_plain(CURVE, total,
                                       tuple(x[:, t:t + 1] for x in cs))
            assert device_points_to_host(CURVE, total) == [want[j]], (r, j)
    # all signs positive: the unsigned accumulation, word for word
    plus = torch.ones_like(sorted_signs)
    assert all(torch.equal(a, b) for a, b in zip(
        cmsm.bucket_accumulate_plain(CURVE, basis, digits, order, starts,
                                     chunk=chunk, tile=tile, signs=plus),
        cmsm.bucket_accumulate_plain(CURVE, basis, digits, order, starts,
                                     chunk=chunk, tile=tile)))


@pytest.mark.parametrize("nb", [1025, 2049])
def test_wide_reduce_matches_direct_sum(nb):
    """The reduction at unsigned c = 10 (1,025 buckets a row) and signed
    c = 12 (2,049), at the segment widths of a few rows (8 and 16 a
    segment, 128 lanes) and of 2,048 rows (32 and 64, 32 lanes): sum_j
    j B_j over a few live buckets, the last bucket and its neighbours
    among them."""
    live = [1, 2, 17, 31, 32, 33, 500, nb - 2, nb - 1]
    pts = _points(CURVE, len(live), nb)
    pts[3] = chost.mul(chost.generator(CURVE), 5)
    rows = [[d for d in live], [live[-1]] * 3 + [0] * (len(live) - 3)]
    digits = torch.tensor(rows, dtype=torch.int64)
    sorted_digits, order = torch.sort(digits, dim=-1, stable=True)
    starts = cmsm._run_starts(sorted_digits, nb)
    basis = cmsm.precompute_base(CURVE, points_to_device(CURVE, pts, "cpu"))
    buckets, carries = cmsm.bucket_accumulate_plain(
        CURVE, basis, sorted_digits.to(torch.int32), order.to(torch.int32),
        starts)
    assert cmsm.reduce_seg(nb) == (8 if nb == 1025 else 16)
    assert cmsm.reduce_seg(nb, 2048) == (32 if nb == 1025 else 64)
    for seg in (cmsm.reduce_seg(nb), cmsm.reduce_seg(nb, 2048)):
        got = device_points_to_host(CURVE, cmsm.bucket_reduce_plain(
            CURVE, buckets, carries, starts, seg=seg))
        for r, row in enumerate(rows):
            want = chost.zero_point(CURVE)
            for pt, d in zip(pts, row):
                if d:
                    want = chost.add(want, chost.mul(pt, d))
            assert got[r] == want, (seg, r)


def test_reduce_seg_is_one_choice_for_kernel_and_plain(monkeypatch):
    """For every bucket count of c = 2 .. 12, unsigned (2^c) and signed
    (2^(c-1) + 1), at one row and at 513 (c <= 5), the segment width the
    kernel is launched with (its launch arguments, read with the launch
    stubbed out) is the one the plain version takes (read from its call of
    reduce_seg): the smallest power of two that leaves at most
    reduce_lanes(rows) segments (one a lane of the kernel's block): 128
    lanes up to 512 rows, then halved down to 32 while rows x lanes
    exceeds 2^16."""
    assert [cmsm.reduce_lanes(r) for r in (1, 512, 513, 1024, 1025, 2048, 10 ** 6)] \
        == [128, 128, 64, 64, 32, 32, 32]
    launched, planned = [], []
    real_seg = cmsm.reduce_seg

    def spy(nb, rows=1):
        planned.append((nb, rows, real_seg(nb, rows)))
        return real_seg(nb, rows)
    monkeypatch.setattr(cmsm, "reduce_seg", spy)
    monkeypatch.setattr(fops, "_dispatch", lambda t: True)
    monkeypatch.setattr(_cuda, "check", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "launch", lambda name, entry, tensors, *args:
                        launched.append(args[10]))
    w = cmsm.words(CURVE)
    for c in range(2, 13):
        for nb in (1 << c, (1 << (c - 1)) + 1):
            for rows in ((1, 513) if c <= 5 else (1,)):
                buckets = torch.zeros((rows, nb, w), dtype=torch.int32)
                carries = torch.zeros((rows, 1, w), dtype=torch.int32)
                starts = torch.zeros((rows, nb + 1), dtype=torch.int32)
                cmsm.bucket_reduce(CURVE, buckets, carries, starts)
                kernel_seg = launched[-1]
                planned.clear()
                with monkeypatch.context() as m:
                    m.setattr(fops, "_dispatch", lambda t: False)
                    cmsm.bucket_reduce(CURVE, buckets, carries, starts)
                assert planned == [(nb, rows, kernel_seg)], (c, nb, rows)
                lanes = cmsm.reduce_lanes(rows)
                nseg = -(-(nb - 1) // kernel_seg)
                assert nseg <= lanes <= cmsm.REDUCE_LANES
                assert kernel_seg == 1 or -(-(nb - 1) // (kernel_seg // 2)) > lanes
                assert kernel_seg & (kernel_seg - 1) == 0
                if c <= 7 and rows == 1:
                    assert kernel_seg == 1, (c, nb)


def test_signs_ride_in_bit_31_of_order(monkeypatch):
    """signed_order marks the order words of negative positions in bit 31
    and keeps the point index in the low 31 bits; the signed wrapper
    launches msm_bucket_accumulate_signed, the unsigned one
    msm_bucket_accumulate."""
    order = torch.tensor([[5, 0, 3, 1, 2, 4]], dtype=torch.int32)
    signs = torch.tensor([[1, -1, 1, -1, -1, 1]])
    packed = cmsm.signed_order(order, signs)
    assert packed.dtype == torch.int32
    assert (packed & 0x7FFFFFFF).tolist() == order.tolist()
    assert (packed < 0).tolist() == (signs < 0).tolist()
    pts = _points(CURVE, 6, 6)
    basis = cmsm.precompute_base(CURVE, points_to_device(CURVE, pts, "cpu"))
    seen = []
    monkeypatch.setattr(fops, "_dispatch", lambda t: True)
    monkeypatch.setattr(_cuda, "check", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "launch", lambda name, entry, tensors, *args:
                        seen.append((name, entry)))
    digits = torch.tensor([[0, 1, 1, 2, 3, 3]], dtype=torch.int32)
    starts = cmsm._run_starts(digits.to(torch.int64), 5)
    cmsm.bucket_accumulate(CURVE, basis, digits, order, starts, signs)
    cmsm.bucket_accumulate(CURVE, basis, digits, order, starts)
    assert seen == [("msm_bucket_accumulate_signed",
                     "pt_msm_bucket_accumulate_signed"),
                    ("msm_bucket_accumulate", "pt_msm_bucket_accumulate")]
