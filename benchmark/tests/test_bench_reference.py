"""The plain reference against values worked by hand on tiny fields and
curves, and against brute force where the sizes allow it."""

import random

import pytest
import torch

from benchmark.reference import curve as rcurve
from benchmark.reference import field as rfield
from benchmark.reference import msm as rmsm
from benchmark.reference import ntt as rntt

# y^2 = x^3 + 3 over F_7: 13 points (prime order), G = (1, 2).
TINY = rcurve.Curve(p=7, b=3, r=13, generator=(1, 2))
P254 = (1 << 254) + 0x38AA1276C3F59B9A14064E200000001      # TweedledumBase


def limbs(values, shape, nl=8):
    """Python ints -> int32 limbs [nl, *shape]."""
    t = torch.tensor([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(nl)] for v in values],
                     dtype=torch.int64).T.reshape(nl, *shape)
    return (t - ((t >> 31) << 32)).to(torch.int32)


def test_tiny_curve_by_hand():
    g = TINY.generator
    assert rcurve.add(TINY, g, g) == (6, 3)
    assert rcurve.mul(TINY, g, 3) == (2, 2)
    assert rcurve.mul(TINY, g, 12) == (1, 5)
    assert rcurve.mul(TINY, g, 13) is None
    assert rcurve.add(TINY, g, (1, 5)) is None
    assert all(TINY.on_curve(rcurve.mul(TINY, g, e)) for e in range(13))


def test_chain_logs_and_msm_oracle():
    a, m, n = 5, 2, 8
    chain = rmsm.chain_points(TINY, a, m + 2)
    basis = []
    for i in range(n):
        pt = chain[i % m]
        for t in range(2):
            if (i // m) >> t & 1:
                pt = rcurve.add(TINY, pt, chain[m + t])
        basis.append(pt)
        assert pt == rcurve.mul(TINY, TINY.generator, rmsm.point_log(a, m, i, TINY.r))
    rng = random.Random(1)
    rows = [[rng.randrange(1 << 40) for _ in range(n)] for _ in range(3)]
    scal = limbs([v for row in rows for v in row], (3, n))
    want = []
    for row in rows:
        acc = None
        for s, pt in zip(row, basis):
            acc = rcurve.add(TINY, acc, rcurve.mul(TINY, pt, s))
        want.append(acc)
    assert rmsm.expected_points(TINY, scal, a, m) == want
    cut = rmsm.expected_points(TINY, scal, a, m, keep_bits=8)
    assert cut == rmsm.expected_points(TINY, limbs([v & 0xFF for row in rows for v in row],
                                                   (3, n)), a, m)


def test_truncated():
    v = (1 << 250) + (1 << 200) + 12345
    got = rfield.ints_from_limbs(rmsm.truncated(limbs([v], (1,)), 248))
    assert got == [(1 << 200) + 12345]


def test_tiny_transform_by_hand():
    """a = 1 + x over F_17 at n = 4 (w = 3^4 = 13): values 2, 14, 0, 5."""
    p, w4 = 17, rfield.root_of_unity(17, 3, 4, 2)
    assert w4 == 13
    coeffs, values = limbs([1, 1, 0, 0], (1, 4)), limbs([2, 14, 0, 5], (1, 4))
    check = rntt.TransformCheck(p, 2, w4, 4, 4, "cpu")
    assert check.mismatches(coeffs, values) == 0
    assert check.mismatches(coeffs, limbs([2, 14, 1, 5], (1, 4))) == 1


@pytest.mark.parametrize("lg,lg_dom", [(3, 3), (3, 5), (4, 6)])
def test_transform_check_against_brute_force(lg, lg_dom):
    p = P254
    rng = random.Random(lg * 10 + lg_dom)
    w = rfield.root_of_unity(p, 5, 33, lg_dom)
    k = 3
    a = [[rng.randrange(p) for _ in range(1 << lg)] for _ in range(k)]
    v = [[sum(c * pow(w, j * i, p) for j, c in enumerate(row)) % p
          for i in range(1 << lg_dom)] for row in a]
    check = rntt.TransformCheck(p, rng.randrange(2, p), w, 1 << lg_dom, 1 << lg, "cpu")
    ta = limbs([x for row in a for x in row], (k, 1 << lg))
    tv = limbs([x for row in v for x in row], (k, 1 << lg_dom))
    assert check.mismatches(ta, tv) == 0
    tv[0, 1, 3] ^= 1
    assert check.mismatches(ta, tv) == 1


def test_dot_mod_below_plus_p():
    p = P254
    rng = random.Random(5)
    xs = [[rng.randrange(p) for _ in range(50)] for _ in range(2)]
    ws = [rng.randrange(p) for _ in range(50)]
    wb = torch.from_numpy(rfield.ints_to_bytes(ws, 32).copy())
    x = limbs([v for row in xs for v in row], (2, 50))
    assert rfield.dot_mod(wb, x, p) == [sum(a * b for a, b in zip(ws, row)) % p for row in xs]
    assert bool(rfield.below(x, p).all())
    lazy = rfield.plus_p(x, p)
    assert not bool(rfield.below(lazy, p).any())
    assert rfield.ints_from_limbs(lazy.reshape(8, -1)) == [v + p for row in xs for v in row]
    edge = limbs([p - 1, p, 0], (3,))
    assert rfield.below(edge, p).tolist() == [True, False, True]
