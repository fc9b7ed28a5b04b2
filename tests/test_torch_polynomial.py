"""The rest of the port's op surface against the JAX package, on the CPU.

Each function is held to its JAX counterpart on the same inputs, compared
as canonical ints or affine points (the tests of tests/test_fft.py:66-160
and tests/test_curves.py:69, on both packages; inv_mod_xn and
polynomial_division against the JAX package only in a slow test, its
compiles taking ~55 s, and against the host's identities in the fast
tier):
* poly/polynomial.py: eval_at, mul_polys, inv_mod_xn, degree_host,
  polynomial_division, poly_from_ints and eval_host;
* fields/ops.py: exp_dyn and kth_root; the Field wrapper and get_field;
* curves/ops.py: scalar_mul_bits and eq_points.
"""

import jax
import numpy as np
import pytest
import torch

from plonky_tpu.curves import TWEEDLEDEE as J_DEE
from plonky_tpu.curves import ops as jcops
from plonky_tpu.fields import TWEEDLEDUM_BASE as J_SPEC
from plonky_tpu.fields import get_field as jax_get_field
from plonky_tpu.fields import ops as jfops
from plonky_tpu.poly import polynomial as jpoly
from plonky_tpu_torch.curves import TWEEDLEDEE
from plonky_tpu_torch.curves import host as chost
from plonky_tpu_torch.curves import ops as cops
from plonky_tpu_torch.fields import PALLAS_BASE, TWEEDLEDUM_BASE as SPEC
from plonky_tpu_torch.fields import Field, get_field
from plonky_tpu_torch.fields import ops as fops
from plonky_tpu_torch.poly import polynomial as poly
from plonky_tpu_torch.protocol.circuit import (device_points_to_host,
                                               points_to_device)

torch.set_num_threads(1)

P = SPEC.p


def _rand(rng, k):
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(k)]


def _ints(x):
    return [int(v) for v in np.asarray(x).reshape(-1)]


def _port(values):
    return fops.from_ints(SPEC, values, "cpu")


def _same(port, jax_arr):
    return _ints(fops.to_ints(SPEC, port)) == _ints(jfops.to_ints(J_SPEC, jax_arr))


def test_eval_and_products_match_jax():
    """eval_at at a host point (and eval_host), mul_polys, poly_from_ints,
    degree_host."""
    rng = np.random.default_rng(3)
    a, b = _rand(rng, 5), _rand(rng, 3)
    z = 987654321
    ja, jb = jfops.from_ints(J_SPEC, a), jfops.from_ints(J_SPEC, b)
    got_eval = poly.eval_at(SPEC, poly.poly_from_ints(SPEC, a, "cpu"), z)
    assert _same(got_eval, jax.jit(lambda c: jpoly.eval_at(J_SPEC, c, z))(ja))
    assert fops.to_ints(SPEC, got_eval) == poly.eval_host(SPEC, a, z) == \
        jpoly.eval_host(J_SPEC, a, z)
    prod = poly.mul_polys(SPEC, _port(a), _port(b))
    assert _same(prod, jax.jit(lambda x, y: jpoly.mul_polys(J_SPEC, x, y))(ja, jb))
    assert _ints(fops.to_ints(SPEC, prod))[:3] == [
        a[0] * b[0] % P, (a[0] * b[1] + a[1] * b[0]) % P,
        (a[0] * b[2] + a[1] * b[1] + a[2] * b[0]) % P]
    for coeffs in ([0, 0, 0], [1, 0, 0, 0], a + [0, 0], [0, 0, 5, 0]):
        assert poly.degree_host(SPEC, _port(coeffs)) == jpoly.degree_host(
            J_SPEC, jfops.from_ints(J_SPEC, coeffs))
    # a batch of two polynomials: the degree over the batch
    both = torch.stack([_port([1, 2, 0, 0]), _port([3, 0, 4, 0])], dim=1)
    assert poly.degree_host(SPEC, both) == 2


def _division_inputs():
    rng = np.random.default_rng(11)
    f = _rand(rng, 6)
    f[0] |= 1
    a, b = _rand(rng, 13), _rand(rng, 6)
    a[-1] |= 1
    b[-1] |= 1
    return f, a, b


def test_inverse_and_division_hold():
    """inv_mod_xn: f g = 1 mod x^11; polynomial_division: a = q b + r at
    three points with deg r < deg b, a dividend of lower degree than the
    divisor, a constant divisor, and the zero divisor refused."""
    f, a, b = _division_inputs()
    gi = _ints(fops.to_ints(SPEC, poly.inv_mod_xn(SPEC, _port(f), 11)))
    prod = [0] * 11
    for i, fi in enumerate(f):
        for j, gj in enumerate(gi):
            if i + j < 11:
                prod[i + j] = (prod[i + j] + fi * gj) % P
    assert prod == [1] + [0] * 10

    q, r = poly.polynomial_division(SPEC, _port(a), _port(b))
    qi, ri = _ints(fops.to_ints(SPEC, q)), _ints(fops.to_ints(SPEC, r))
    assert len(qi) == 8 and len(ri) == 5
    for z in (3, 987654321, P - 5):
        assert poly.eval_host(SPEC, a, z) == (
            poly.eval_host(SPEC, qi, z) * poly.eval_host(SPEC, b, z)
            + poly.eval_host(SPEC, ri, z)) % P
    q0, r0 = poly.polynomial_division(SPEC, _port(b), _port(a))
    assert _ints(fops.to_ints(SPEC, q0)) == [0] and r0.shape == (8, 6)
    qc, rc = poly.polynomial_division(SPEC, _port(a), _port([7]))
    assert _ints(fops.to_ints(SPEC, qc)) == [x * pow(7, -1, P) % P for x in a]
    assert _ints(fops.to_ints(SPEC, rc)) == [0]
    with pytest.raises(ZeroDivisionError):
        poly.polynomial_division(SPEC, _port(a), _port([0, 0]))


@pytest.mark.slow
def test_inverse_and_division_match_jax():
    """The same inputs through the JAX package's inv_mod_xn and
    polynomial_division (~55 s on one CPU process, its compiles)."""
    f, a, b = _division_inputs()
    assert _same(poly.inv_mod_xn(SPEC, _port(f), 11),
                 jpoly.inv_mod_xn(J_SPEC, jfops.from_ints(J_SPEC, f), 11))
    q, r = poly.polynomial_division(SPEC, _port(a), _port(b))
    jq, jr = jpoly.polynomial_division(J_SPEC, jfops.from_ints(J_SPEC, a),
                                       jfops.from_ints(J_SPEC, b), 12, 5)
    assert _same(q, jq) and _same(r, jr)


def test_exp_dyn_kth_root_and_field_match_jax():
    rng = np.random.default_rng(5)
    xs = [0, 1, P - 1] + _rand(rng, 5)
    es = [0, 1, 2, 5] + [int(rng.integers(1, 1 << 60)) for _ in range(4)]
    nbits = max(e.bit_length() for e in es)
    bits = np.array([[(e >> i) & 1 for e in es] for i in range(nbits)],
                    dtype=np.int32)
    got = fops.exp_dyn(SPEC, _port(xs), torch.from_numpy(bits))
    want = jax.jit(lambda x, b: jfops.exp_dyn(J_SPEC, x, b))(
        jfops.from_ints(J_SPEC, xs), bits)
    assert _same(got, want)
    assert _ints(fops.to_ints(SPEC, got)) == [pow(x, e, P) for x, e in zip(xs, es)]

    for k in (5, 7):
        root = fops.kth_root(SPEC, _port(xs), k)
        assert _same(root, jax.jit(lambda x: jfops.kth_root(J_SPEC, x, k))(
            jfops.from_ints(J_SPEC, xs)))
        assert _ints(fops.to_ints(SPEC, fops.exp_const(SPEC, root, k))) == xs

    f, jf = get_field(SPEC), jax_get_field(J_SPEC)
    assert isinstance(f, Field) and get_field(SPEC) is f
    assert get_field(PALLAS_BASE).p == PALLAS_BASE.p
    a, b = f.from_ints(xs, "cpu"), f.from_ints(xs[::-1], "cpu")
    ja, jb = jf.from_ints(xs), jf.from_ints(xs[::-1])
    for name in ("add", "sub", "mul"):
        assert _same(getattr(f, name)(a, b), getattr(jf, name)(ja, jb)), name
    for name in ("neg", "square", "inverse"):
        assert _same(getattr(f, name)(a), getattr(jf, name)(ja)), name
    assert _same(f.exp_const(a, 12345), jf.exp_const(ja, 12345))
    assert _same(f.kth_root(a, 5), jf.kth_root(ja, 5))
    assert _same(f.constant(9, (3,), "cpu"), jf.constant(9, (3,)))
    assert f.to_ints(f.from_ints([4], "cpu")).tolist() == [4]
    for name, args in (("h_inverse", (12345,)), ("h_exp", (3, 1000)),
                       ("h_sqrt", (4,)), ("h_kth_root", (8, 5)),
                       ("h_root_of_unity", (5,))):
        assert getattr(f, name)(*args) == getattr(jf, name)(*args), name
    assert repr(f) == repr(jf)


def _jax_points(pts):
    fb = J_DEE.base
    return jcops.from_affine(
        J_DEE, jfops.from_ints(fb, [0 if p.zero else p.x for p in pts]),
        jfops.from_ints(fb, [0 if p.zero else p.y for p in pts]),
        jax.numpy.asarray(np.array([p.zero for p in pts])))


def test_scalar_mul_bits_and_eq_points_match_jax():
    """tests/test_curves.py:test_scalar_mul_bits on the port, its
    projective result equal to the JAX package's coordinate for
    coordinate; eq_points on equal, different and identity points."""
    curve = TWEEDLEDEE
    g = chost.generator(curve)
    scalars = [0, 1, 2, 12345678901234567890, curve.scalar.p - 1]
    pts = [g, g, chost.mul(g, 3), g, chost.mul(g, 7)]
    bits = fops.to_bits(curve.scalar, fops.from_ints(curve.scalar, scalars, "cpu"),
                        curve.scalar.bits)
    got = cops.scalar_mul_bits(curve, points_to_device(curve, pts, "cpu"), bits)
    assert device_points_to_host(curve, got) == [
        chost.mul(p, s) for p, s in zip(pts, scalars)]
    want = jax.jit(lambda p, b: cops_jax_mul(p, b))(
        _jax_points(pts), jax.numpy.asarray(bits.numpy().astype(np.int32)))
    for t, w in zip(got, want):
        assert _ints(fops.to_ints(curve.base, t)) == _ints(
            jfops.to_ints(J_DEE.base, w))

    zero = chost.zero_point(curve)
    a_pts = [g, g, zero, zero, chost.mul(g, 5)]
    b_pts = [g, chost.mul(g, 2), zero, g, chost.mul(g, 5)]
    a = points_to_device(curve, a_pts, "cpu")
    # b projective with Z != 1 (a doubling of its halves where it can)
    b = points_to_device(curve, b_pts, "cpu")
    b = cops.add(curve, b, cops.identity(curve, (5,), "cpu"))
    eq = cops.eq_points(curve, a, b)
    assert eq.tolist() == [True, False, True, False, True]
    j_eq = jax.jit(lambda p, q: jcops.eq_points(J_DEE, p, q))(
        _jax_points(a_pts), _jax_points(b_pts))
    assert np.asarray(j_eq).tolist() == eq.tolist()


def cops_jax_mul(p, bits):
    return jcops.scalar_mul_bits(J_DEE, p, bits)


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        poly.poly_from_ints(SPEC, [1, 2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_field(SPEC).from_ints([1, 2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_field(SPEC).constant(1, (2,))
