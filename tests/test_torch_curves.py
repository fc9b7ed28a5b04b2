"""The port's point add and double (plonky_tpu_torch.curves.ops, plain
versions on the CPU) against the JAX package's plonky_tpu.curves.ops and the
host formulas, including P + P, P + (-P) and the identity (BLS12-377 G1's
add and double: tests/test_torch_bls12_377.py).  The two packages
evaluate the same RCB15 formulas, so even the projective triples agree."""

import jax
import numpy as np
import pytest
import torch

from plonky_tpu.curves import TWEEDLEDEE as J_DEE, TWEEDLEDUM as J_DUM
from plonky_tpu.curves import ops as jcops
from plonky_tpu.fields import ops as jfops
from plonky_tpu_torch import interop
from plonky_tpu_torch.curves import BLS12_377, TWEEDLEDEE, TWEEDLEDUM
from plonky_tpu_torch.curves import host as chost
from plonky_tpu_torch.curves import ops as cops
from plonky_tpu_torch.fields import ops as fops
from plonky_tpu_torch.protocol.circuit import (device_points_to_host,
                                               points_to_device)

# The plain versions run thousands of small tensor ops: extra intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

CURVES = [(TWEEDLEDEE, J_DEE), (TWEEDLEDUM, J_DUM)]


def _cases(curve):
    g = chost.generator(curve)
    rng = np.random.default_rng(11)
    r = [chost.mul(g, int(rng.integers(2, 1 << 62))) for _ in range(3)]
    zero = chost.zero_point(curve)
    pts_a = [g, g, g, g.double(), chost.mul(g, 5), zero, zero, r[0], r[1]]
    pts_b = [g, g.neg(), zero, g, chost.mul(g, 3), g, zero, r[1], r[2]]
    return pts_a, pts_b


def _jax_points(jcurve, pts):
    f = jcurve.base
    xs = jfops.from_ints(f, [0 if p.zero else p.x for p in pts])
    ys = jfops.from_ints(f, [0 if p.zero else p.y for p in pts])
    zero = jax.numpy.asarray(np.array([p.zero for p in pts]))
    return jcops.from_affine(jcurve, xs, ys, zero)


def _ints(spec, x):
    return [int(v) for v in np.asarray(fops.to_ints(spec, x)).reshape(-1)]


@pytest.mark.parametrize("curve,jcurve", CURVES, ids=lambda c: c.name)
def test_add_double_match_jax_and_host(curve, jcurve):
    pts_a, pts_b = _cases(curve)
    a = points_to_device(curve, pts_a, "cpu")
    b = points_to_device(curve, pts_b, "cpu")
    s = cops.add(curve, a, b)
    d = cops.double(curve, s)          # projective inputs with Z != 1
    assert device_points_to_host(curve, s) == [
        chost.add(p, q) for p, q in zip(pts_a, pts_b)]
    assert device_points_to_host(curve, d) == [
        chost.add(p, q).double() for p, q in zip(pts_a, pts_b)]

    ja, jb = _jax_points(jcurve, pts_a), _jax_points(jcurve, pts_b)
    js, jd = jax.jit(lambda p, q: (
        jcops.add(jcurve, p, q),
        jcops.double(jcurve, jcops.add(jcurve, p, q))))(ja, jb)
    f = curve.base
    for got, want in zip((*s, *d), (*js, *jd)):
        assert _ints(f, got) == [int(v) for v in
                                 np.asarray(jfops.to_ints(jcurve.base, want))]
    # the JAX loose-digit triples, read back through interop
    back = interop.points_from_jax(curve, tuple(np.asarray(t) for t in jd),
                                   "cpu")
    assert all(torch.equal(g, w) for g, w in zip(back, d))


@pytest.mark.parametrize("curve", [TWEEDLEDEE, TWEEDLEDUM, BLS12_377],
                         ids=lambda c: c.name)
def test_affine_neg_select_identity(curve):
    pts_a, pts_b = _cases(curve)
    a = points_to_device(curve, pts_a, "cpu")
    x, y, zero = cops.to_affine(curve, a)
    assert zero.tolist() == [p.zero for p in pts_a]
    assert cops.is_identity(curve, a).tolist() == [p.zero for p in pts_a]
    f = curve.base
    assert _ints(f, x) == [0 if p.zero else p.x for p in pts_a]
    assert _ints(f, y) == [0 if p.zero else p.y for p in pts_a]
    assert device_points_to_host(curve, cops.neg(curve, a)) == [
        p.neg() for p in pts_a]
    b = points_to_device(curve, pts_b, "cpu")
    mask = torch.tensor([i % 2 == 0 for i in range(len(pts_a))])
    assert device_points_to_host(curve, cops.select(mask, a, b)) == [
        p if i % 2 == 0 else q for i, (p, q) in enumerate(zip(pts_a, pts_b))]
    ident = cops.identity(curve, (len(pts_a),), "cpu")
    assert device_points_to_host(curve, cops.add(curve, a, ident)) == pts_a
