"""The MSM's bucket stages in the order the kernels take them, and
`msm_chunked` with one reduction and one Horner a call (plain versions on
the CPU).  The plain accumulation and reduction at 8 limbs (Tweedledee)
and 12 (BLS12-377) against host bucket sums B_j and sum_j j B_j: unsigned
and signed windows (an odd bucket count, 2^(c-1) + 1), an empty row, runs
that carry across tiles, a batch of rows that is not a power of two, and
segment widths whose segment count is not a power of two.  `msm_chunked`
over three small slices against the JAX package's `msm_chunked` (Tweedledee at
c = 8 signed, BLS12-377 at c = 4 unsigned), as affine points (read from
tests/fixtures/jax_msm.json, made again by a slow test), and its launches on
the card (read with the launches stubbed out): each slice's accumulation,
one reduction, one Horner and a tree of adds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_fixtures as jaxfx
from plonky_tpu import curves as jcurves
from plonky_tpu.curves import msm as jmsm
from plonky_tpu.curves import ops as jcops
from plonky_tpu.fields import ops as jfops
from plonky_tpu_torch import _cuda
from plonky_tpu_torch.curves import BLS12_377, TWEEDLEDEE
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

CURVES = {"tweedledee": TWEEDLEDEE, "bls12_377": BLS12_377}
J_CURVES = {"tweedledee": jcurves.TWEEDLEDEE, "bls12_377": jcurves.BLS12_377}
N = 40                 # points of a bucket row: several tiles of 3 x 2


def _points(curve, n, seed):
    g = chost.generator(curve)
    rng = np.random.default_rng(seed)
    pts = [chost.mul(g, int(rng.integers(2, 1 << 62))) for _ in range(n)]
    pts[3] = chost.zero_point(curve)             # an identity in the basis
    return pts


def _rows(c, signed):
    """Digit rows (magnitudes) and signs: random with a few empty
    buckets, an all-zero row, one run over every tile, two long runs and
    the top bucket alone; five rows (not a power of two)."""
    top = (1 << (c - 1)) if signed else (1 << c) - 1
    rng = np.random.default_rng(c + 10 * signed)
    mags = [[int(v) if v % 3 else 0 for v in rng.integers(0, top + 1, N)],
            [0] * N,
            [top // 2 + 1] * N,
            [top] * (N // 2) + [1] * (N - N // 2),
            [top] + [0] * (N - 1)]
    signs = [[1 if v or not signed else -1 for v in rng.integers(0, 2, N)]
             for _ in mags]
    return mags, signs


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("name", sorted(CURVES))
def test_plain_buckets_and_reduce_match_host_sums(name, signed):
    """Buckets plus their carries are the host's bucket sums (a negative
    sign adds -P); the reduction is sum_j j B_j at its default segment
    width (one bucket a segment: 15 segments unsigned, the scan and the
    trees over a count that is not a power of two; 8 signed) and at the
    widths that leave 8, 4, 2 and 1 segments (the last one short where
    15 buckets are cut)."""
    curve = CURVES[name]
    c = 4
    nb = (1 << (c - 1)) + 1 if signed else 1 << c
    pts = _points(curve, N, 7 + signed)
    mags, signs = _rows(c, signed)
    digits, order = torch.sort(torch.tensor(mags, dtype=torch.int64), dim=-1,
                               stable=True)
    starts = cmsm._run_starts(digits, nb)
    sorted_signs = torch.gather(torch.tensor(signs), 1, order) if signed else None
    basis = cmsm.precompute_base(curve, points_to_device(curve, pts, "cpu"))
    chunk, tile = 3, 2
    buckets, carries = cmsm.bucket_accumulate_plain(
        curve, basis, digits.to(torch.int32), order.to(torch.int32), starts,
        chunk=chunk, tile=tile, signs=sorted_signs)
    assert buckets.shape == (len(mags), nb, cmsm.words(curve))
    assert not buckets[1].any() and not carries[1].any()
    tp = chunk * tile
    want_sums = []
    for r, (row, sgn) in enumerate(zip(mags, signs)):
        want = [chost.zero_point(curve) for _ in range(nb)]
        for pt, m, s in zip(pts, row, sgn):
            if m:
                want[m] = chost.add(want[m], pt if s > 0 else pt.neg())
        b = cmsm.unpack_points(curve, buckets[r])
        cs = cmsm.unpack_points(curve, carries[r])
        for j in range(1, nb):
            lo, hi = int(starts[r, j]), int(starts[r, j + 1])
            total = tuple(t[:, j:j + 1] for t in b)
            for t in range(lo // tp + 1, (hi - 1) // tp + 1):
                total = cops.add_plain(curve, total, tuple(x[:, t:t + 1] for x in cs))
            assert device_points_to_host(curve, total) == [want[j]], (r, j)
        acc = chost.zero_point(curve)
        for j in range(1, nb):
            acc = chost.add(acc, chost.mul(want[j], j))
        want_sums.append(acc)
    assert any((int(st[2]) - 1) // tp > int(st[1]) // tp for st in starts)
    for seg in (None, 16, 8, 4, 2):
        got = cmsm.bucket_reduce_plain(curve, buckets, carries, starts,
                                       chunk=chunk, tile=tile, seg=seg)
        assert device_points_to_host(curve, got) == want_sums, seg
        assert all(torch.equal(t[:, 1], i[:, 0]) for t, i in
                   zip(got, cops.identity(curve, (1,), "cpu")))


def _jax_points(name, pts):
    jc = J_CURVES[name]
    xs = jfops.from_ints(jc.base, [0 if p.zero else p.x for p in pts])
    ys = jfops.from_ints(jc.base, [0 if p.zero else p.y for p in pts])
    zero = jnp.asarray(np.array([p.zero for p in pts]))
    return jcops.from_affine(jc, xs, ys, zero)


def _scalar_rows(curve, k, n, seed):
    r = curve.scalar.p
    rng = np.random.default_rng(seed)
    rows = [[int.from_bytes(rng.bytes(40), "little") % r for _ in range(n)]
            for _ in range(k)]
    rows[0][:4] = [0, 1, r - 1, r - 2]
    return rows


CHUNKED_CASES = [("tweedledee", 8, True), ("bls12_377", 4, False)]
CHUNK_LOG = 2


def _chunked_inputs(name, c, signed):
    """Three slices of 2^2 points and two scalar rows."""
    n = 3 << CHUNK_LOG
    return _points(CURVES[name], n, c + 3 * signed), _scalar_rows(CURVES[name], 2, n, c)


def _jax_msm_chunked(name, c, signed) -> list:
    """The JAX package's msm_chunked of _chunked_inputs (a jitted msm a
    slice, summed by adds; window_group 2, as its own test runs it),
    affine."""
    curve, jc = CURVES[name], J_CURVES[name]
    pts, rows = _chunked_inputs(name, c, signed)
    jscal = jnp.stack([jfops.from_ints(jc.scalar, r) for r in rows], axis=1)
    res = jmsm.msm_chunked(jc, _jax_points(name, pts), jscal, window_bits=c,
                           window_group=2, chunk_log=CHUNK_LOG, signed=signed)
    jx, jy, jzero = jax.jit(lambda p: jcops.to_affine(jc, p))(res)
    return [chost.zero_point(curve) if bool(z) else
            chost.AffinePoint(curve, int(x), int(y))
            for x, y, z in zip(*(np.asarray(jfops.to_ints(jc.base, v)).reshape(-1)
                                 for v in (jx, jy)), np.asarray(jzero).reshape(-1))]


@pytest.mark.parametrize("name,c,signed", CHUNKED_CASES)
def test_msm_chunked_matches_jax(name, c, signed):
    """Three slices of 2^2 points, two MSMs: the port's msm_chunked (each
    slice's buckets, one reduction over the slices' rows, one Horner, a
    tree of adds) against the JAX package's msm_chunked as affine points
    (read from tests/fixtures/jax_msm.json, made by
    test_jax_msm_chunked_fixture: a JAX MSM compile costs 20-45 s on the
    CPU at these shapes), the second MSM also against the host.  Each
    curve, window and sign once (chip_smoke.py's K4 sweep holds every
    c = 2..12, signed and unsigned, at both widths, against a discrete-log
    oracle)."""
    curve = CURVES[name]
    pts, rows = _chunked_inputs(name, c, signed)
    basis = cmsm.precompute_base(curve, points_to_device(curve, pts, "cpu"))
    got = device_points_to_host(curve, cmsm.msm_chunked(
        curve, basis, ints_to_device_matrix(curve.scalar, rows, "cpu"),
        window_bits=c, chunk_log=CHUNK_LOG, signed=signed))
    assert jaxfx.points(got) == jaxfx.load("msm", f"{name} chunked {c} {signed}")
    acc = chost.zero_point(curve)
    for pt, s in zip(pts, rows[1]):
        acc = chost.add(acc, chost.mul(pt, s))
    assert got[1] == acc


@pytest.mark.slow
@pytest.mark.parametrize("name,c,signed", CHUNKED_CASES)
def test_jax_msm_chunked_fixture(name, c, signed):
    """The JAX package's results that test_msm_chunked_matches_jax reads,
    made again."""
    jaxfx.check("msm", f"{name} chunked {c} {signed}",
                jaxfx.points(_jax_msm_chunked(name, c, signed)))


@pytest.mark.parametrize("slices", [3, 4, 5])
def test_msm_chunked_launches_one_reduce_and_one_horner(monkeypatch, slices):
    """On the card (launches stubbed out, so only their count and shapes
    are read): an accumulation a slice, one reduction over every slice's
    rows, one Horner over K = slices x MSMs, and ceil(log2 slices) adds
    halving the slices' points."""
    curve = BLS12_377
    size, k, c = 1 << 3, 2, 4
    n = slices * size
    pts = _points(curve, n, slices)
    basis = cmsm.precompute_base(curve, points_to_device(curve, pts, "cpu"))
    scal = ints_to_device_matrix(curve.scalar, _scalar_rows(curve, k, n, 1), "cpu")
    seen = []

    def launch(name, entry, tensors, *args):
        seen.append((name, args))
    monkeypatch.setattr(fops, "_dispatch", lambda t: True)
    monkeypatch.setattr(_cuda, "check", lambda *a, **kw: None)
    monkeypatch.setattr(_cuda, "launch", launch)
    out = cmsm.msm_chunked(curve, basis, scal, window_bits=c, chunk_log=3)
    assert tuple(out[0].shape) == (12, k)
    names = [name for name, _args in seen]
    n_windows = -(-curve.scalar.bits // c)
    adds = (slices - 1).bit_length()
    assert names == (["msm_bucket_accumulate_l12"] * slices
                     + ["msm_bucket_reduce_l12", "curve_horner_l12"]
                     + ["curve_add_l12"] * adds)
    reduce_args = seen[slices][1]
    assert reduce_args[6] == slices * k * n_windows          # rows
    assert reduce_args[10] == cmsm.reduce_seg(1 << c, slices * k * n_windows)
    horner_args = seen[slices + 1][1]
    assert horner_args[6:9] == (slices * k, n_windows, c)    # K, W, c
    # the tree's adds: halves of the points, the odd one carried up
    widths, m = [], slices
    while m > 1:
        widths.append((m // 2) * k)
        m = m // 2 + m % 2
    assert [args[-2] for name, args in seen if name == "curve_add_l12"] == widths
