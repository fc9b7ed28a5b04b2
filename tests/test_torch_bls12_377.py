"""BLS12-377 G1 in the port (12-limb base field, 8-limb scalar field; plain
versions on the CPU) against the JAX package and the host: field ops on
both fields, point add and double (the JAX package's 50-digit results
carried in by `interop`), `msm` at K = 1 and 3 with c = 4 and 8 against
the JAX package's `msm_jit` (its bench's entry point), `msm_chunked`
against `msm`, and the 150-point summation of bin/microbench.py as a tree
of adds.  tests/test_torch_fields.py holds the other field ops and the
digit round trip at both BLS12-377 fields.  Canonical ints and affine
points are compared, with exact equality (ROADMAP C4)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky_tpu.curves import BLS12_377 as J_CURVE
from plonky_tpu.curves import msm as jmsm
from plonky_tpu.curves import ops as jcops
from plonky_tpu.fields import BLS12_377_BASE as J_BASE
from plonky_tpu.fields import BLS12_377_SCALAR as J_SCALAR
from plonky_tpu.fields import ops as jfops
from plonky_tpu_torch import _cuda, interop
from plonky_tpu_torch.curves import BLS12_377 as CURVE
from plonky_tpu_torch.curves import host as chost
from plonky_tpu_torch.curves import msm as cmsm
from plonky_tpu_torch.curves import ops as cops
from plonky_tpu_torch.fields import (BLS12_377_BASE, BLS12_377_SCALAR,
                                     TWEEDLEDEE_BASE)
from plonky_tpu_torch.fields import ops as fops
from plonky_tpu_torch.hashing import rescue
from plonky_tpu_torch.poly import fft as pfft
from plonky_tpu_torch.protocol import generate_proof, verify_proof
from plonky_tpu_torch.protocol.circuit import (build_circuit,
                                               device_points_to_host,
                                               ints_to_device_matrix,
                                               points_to_device)

# The plain versions run thousands of small tensor ops: extra intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

FIELDS = [(BLS12_377_BASE, J_BASE), (BLS12_377_SCALAR, J_SCALAR)]
N = 19          # a ragged batch


def _ints(x):
    return [int(v) for v in np.asarray(x).reshape(-1)]


def _values(p: int, seed: int, n: int = N):
    rng = np.random.default_rng(seed)
    edge = [0, 1, p - 1, p - 2, (p - 1) // 2, (1 << 256) % p]
    return edge + [int.from_bytes(rng.bytes(56), "little") % p
                   for _ in range(n - len(edge))]


def test_widths_and_constants():
    """12 limbs for the 377-bit field, 8 for the rest; the generator lies on
    y^2 = x^3 + 1 and has order r (r G = O, checked as (r - 1) G = -G)."""
    assert BLS12_377_BASE.limbs == 12 and BLS12_377_BASE.bits == 377
    assert BLS12_377_SCALAR.limbs == 8 and BLS12_377_SCALAR.bits == 253
    assert TWEEDLEDEE_BASE.limbs == 8
    assert BLS12_377_BASE.p == J_BASE.p and BLS12_377_SCALAR.p == J_SCALAR.p
    assert CURVE.b == J_CURVE.b and CURVE.generator_affine == J_CURVE.generator_affine
    g = chost.generator(CURVE)
    assert g.is_valid()
    assert chost.mul(g, CURVE.scalar.p - 1) == g.neg()
    buf = [int(v) for v in cops._consts_host(CURVE)]
    assert len(buf) == 3 * 12 + 1
    value = lambda at: sum(v << (32 * i) for i, v in enumerate(buf[at:at + 12]))
    assert value(0) == BLS12_377_BASE.p
    assert value(13) == 3
    assert value(25) == pow(2, 768, BLS12_377_BASE.p)


@pytest.mark.parametrize("spec,jspec", FIELDS, ids=lambda s: s.name)
def test_field_ops_match_jax(spec, jspec):
    p = spec.p
    av, bv = _values(p, 1), _values(p, 2)[::-1]
    a, b = (fops.from_ints(spec, v, "cpu") for v in (av, bv))
    assert a.shape == (spec.limbs, N)
    ja, jb = (jfops.from_ints(jspec, v) for v in (av, bv))

    @jax.jit
    def reference(ja, jb):
        return {"add": jfops.add(jspec, ja, jb), "sub": jfops.sub(jspec, ja, jb),
                "neg": jfops.neg(jspec, ja), "mul": jfops.mul(jspec, ja, jb),
                "inverse": jfops.inverse(jspec, ja)}

    want = {k: _ints(jfops.to_ints(jspec, v))
            for k, v in reference(ja, jb).items()}
    got = {"add": fops.add(spec, a, b), "sub": fops.sub(spec, a, b),
           "neg": fops.neg(spec, a), "mul": fops.mul(spec, a, b),
           "inverse": fops.inverse(spec, a)}
    for k in want:
        assert _ints(fops.to_ints(spec, got[k])) == want[k], k
    assert want["mul"] == [x * y % p for x, y in zip(av, bv)]
    assert want["inverse"] == [pow(x, p - 2, p) for x in av]
    # a broadcast [L, 1] operand
    col = fops.column(spec, bv[7], "cpu")
    assert _ints(fops.to_ints(spec, fops.mul(spec, col, a))) == [
        bv[7] * x % p for x in av]


def _cases():
    g = chost.generator(CURVE)
    rng = np.random.default_rng(11)
    r = [chost.mul(g, int(rng.integers(2, 1 << 62))) for _ in range(3)]
    zero = chost.zero_point(CURVE)
    pts_a = [g, g, g, g.double(), chost.mul(g, 5), zero, zero, r[0], r[1]]
    pts_b = [g, g.neg(), zero, g, chost.mul(g, 3), g, zero, r[1], r[2]]
    return pts_a, pts_b


def _jax_points(pts):
    f = J_CURVE.base
    xs = jfops.from_ints(f, [0 if p.zero else p.x for p in pts])
    ys = jfops.from_ints(f, [0 if p.zero else p.y for p in pts])
    zero = jnp.asarray(np.array([p.zero for p in pts]))
    return jcops.from_affine(J_CURVE, xs, ys, zero)


def test_add_double_match_jax_and_host():
    """P + P, P + (-P), the identity on either side, and a double of the
    sums (Z != 1); projective triples equal the JAX package's, and the JAX
    loose digits (50 of them) read back through interop."""
    pts_a, pts_b = _cases()
    a = points_to_device(CURVE, pts_a, "cpu")
    b = points_to_device(CURVE, pts_b, "cpu")
    s = cops.add(CURVE, a, b)
    d = cops.double(CURVE, s)
    sums = [chost.add(p, q) for p, q in zip(pts_a, pts_b)]
    assert device_points_to_host(CURVE, s) == sums
    assert device_points_to_host(CURVE, d) == [x.double() for x in sums]

    js, jd = jax.jit(lambda p, q: (
        jcops.add(J_CURVE, p, q),
        jcops.double(J_CURVE, jcops.add(J_CURVE, p, q))))(
            _jax_points(pts_a), _jax_points(pts_b))
    f = CURVE.base
    for got, want in zip((*s, *d), (*js, *jd)):
        assert _ints(fops.to_ints(f, got)) == _ints(jfops.to_ints(J_BASE, want))
    assert np.asarray(jd[0]).shape[0] == J_BASE.n_digits == 50
    back = interop.points_from_jax(CURVE, tuple(np.asarray(t) for t in jd), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(back, d))


def _points(n, seed):
    g = chost.generator(CURVE)
    rng = np.random.default_rng(seed)
    pts = [chost.mul(g, int(rng.integers(2, 1 << 62))) for _ in range(n)]
    pts[3] = chost.zero_point(CURVE)
    return pts


def _scalars(k, n, seed):
    r = CURVE.scalar.p
    rng = np.random.default_rng(seed)
    rows = [[int.from_bytes(rng.bytes(40), "little") % r for _ in range(n)]
            for _ in range(k)]
    rows[0][:4] = [0, 1, r - 1, 0]
    if k > 1:
        rows[1] = [0] * n
    return rows


def _naive(pts, row):
    acc = chost.zero_point(CURVE)
    for pt, s in zip(pts, row):
        acc = chost.add(acc, chost.mul(pt, s))
    return acc


@pytest.mark.parametrize("c", [4, 8])
@pytest.mark.parametrize("n,k", [(37, 1), (64, 3)])
def test_msm_matches_jax(n, k, c):
    pts, rows = _points(n, n + c), _scalars(k, n, 7 * n + k + c)
    basis = cmsm.precompute_base(CURVE, points_to_device(CURVE, pts, "cpu"))
    assert basis.mont.shape == (n, 36)
    got = device_points_to_host(CURVE, cmsm.msm(
        CURVE, basis, ints_to_device_matrix(CURVE.scalar, rows, "cpu"), c))

    jscal = jnp.stack([jfops.from_ints(J_SCALAR, r) for r in rows], axis=1)
    jx, jy, jzero = jax.jit(lambda P, S: jcops.to_affine(
        J_CURVE, jmsm.msm_jit(J_CURVE, c)(P, S)))(_jax_points(pts), jscal)
    want = [chost.zero_point(CURVE) if bool(z) else
            chost.AffinePoint(CURVE, int(x), int(y))
            for x, y, z in zip(_ints(jfops.to_ints(J_BASE, jx)),
                               _ints(jfops.to_ints(J_BASE, jy)),
                               np.asarray(jzero).reshape(-1))]
    assert got == want
    assert got[0] == _naive(pts, rows[0])
    if k > 1:
        assert got[1] == chost.zero_point(CURVE)


def test_msm_chunked_matches_msm():
    """Three chunks of 2^4 points (and one, at N = 2^chunk_log) against one
    msm call; N not a multiple of the chunk is refused."""
    n = 48
    pts, rows = _points(n, 5), _scalars(2, n, 9)
    basis = cmsm.precompute_base(CURVE, points_to_device(CURVE, pts, "cpu"))
    scal = ints_to_device_matrix(CURVE.scalar, rows, "cpu")
    whole = device_points_to_host(CURVE, cmsm.msm(CURVE, basis, scal, 5))
    chunked = device_points_to_host(
        CURVE, cmsm.msm_chunked(CURVE, basis, scal, window_bits=5, chunk_log=4))
    assert chunked == whole == [_naive(pts, r) for r in rows]
    sub = basis.slice(16, 32)
    assert sub.n == 16 and sub.mont.data_ptr() % 16 == 0
    assert device_points_to_host(CURVE, cmsm.msm_chunked(
        CURVE, sub, scal[..., 16:32], window_bits=5, chunk_log=4)) == [
            _naive(pts[16:32], r[16:32]) for r in rows]
    with pytest.raises(ValueError):
        cmsm.msm_chunked(CURVE, basis.slice(0, 40), scal[..., :40], 5, 4)


def test_summation_of_150_points():
    """bin/microbench.py:134-171: 150 points padded with the identity to
    256 and summed by a halving tree of adds, against the host sum."""
    n, pad = 150, 256
    g = chost.generator(CURVE)
    pts = [chost.mul(g, 7)]
    for _ in range(n - 1):
        pts.append(chost.add(pts[-1], pts[-1]))
    p = points_to_device(CURVE, pts + [chost.zero_point(CURVE)] * (pad - n), "cpu")
    m = pad
    while m > 1:
        p = cops.add(CURVE, tuple(t[:, :m // 2] for t in p),
                     tuple(t[:, m // 2:m] for t in p))
        m //= 2
    want = chost.zero_point(CURVE)
    for q in pts:
        want = chost.add(want, q)
    assert device_points_to_host(CURVE, p) == [want]
    assert want == chost.mul(g, 7 * ((1 << n) - 1))


def test_unported_kernels_refuse_a_12_limb_field():
    """Every kernel has a 12-limb build: `_cuda.kernel(name, 12)` names the
    `_l12` entry of the product sum, both NTT kernels and Rescue as of the
    others, and a width of neither 8 nor 12 limbs is refused.  What still
    refuses a 12-limb field is the circuit build, the prover and the
    verifier (a 12-limb scalar field, which no curve of the port has);
    the product sum's plain version takes the field on the CPU."""
    f = BLS12_377_BASE
    for name in ("field_product_sum", "ntt_pass", "ntt_twiddle_transpose",
                 "rescue_permutation", "field_mul"):
        assert _cuda.kernel(name, 12) == (f"{name}_l12", f"pt_{name}_l12")
        assert _cuda.kernel(name, 8) == (name, f"pt_{name}")
        assert _cuda.LAUNCHES[f"{name}_l12"] == 0
        assert f"pt_{name}_l12" in _cuda._SIGNATURES
        with pytest.raises(NotImplementedError):
            _cuda.kernel(name, 10)
    wide = SimpleNamespace(scalar=f)
    with pytest.raises(NotImplementedError, match="ROADMAP B2"):
        build_circuit(SimpleNamespace(curve=wide), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP B2"):
        generate_proof(SimpleNamespace(curve=CURVE, spec=f), None)
    with pytest.raises(NotImplementedError, match="ROADMAP B2"):
        verify_proof([], None, [], SimpleNamespace(curve=wide), CURVE, True,
                     device="cpu")
    # the product sum's plain version is width-generic on the CPU
    p = f.p
    x = fops.from_ints(f, [1, 2, 3], "cpu")
    assert pfft.powers_dyn(f, x[:, :1], 4).shape == (12, 4)
    assert len(rescue.kernel_consts(f, 128)) == 478 + 16 * 96
    big = fops.from_ints(f, [p - 1, p - 2, 0], "cpu")
    got = fops.product_sum(f, [(big, big, -1)] * 32 + [(big, None, -1)])
    assert _ints(fops.to_ints(f, got)) == [
        (-32 * v * v - v) % p for v in (p - 1, p - 2, 0)]
