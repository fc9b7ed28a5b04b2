"""The port's MSM (plonky_tpu_torch.curves.msm, plain versions on the CPU)
against the JAX package's plonky_tpu.curves.msm at the window the main path
picks (commit_window_bits), and against a naive host MSM at every window
from 2 to 12 (the reduction widens its segments above c = 9)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky_tpu.curves import TWEEDLEDEE as J_CURVE
from plonky_tpu.curves import msm as jmsm
from plonky_tpu.curves import ops as jcops
from plonky_tpu.fields import ops as jfops
from plonky_tpu_torch.curves import TWEEDLEDEE as CURVE
from plonky_tpu_torch.curves import host as chost
from plonky_tpu_torch.curves import msm as cmsm
from plonky_tpu_torch.fields import ops as fops
from plonky_tpu_torch.protocol.circuit import (commit_window_bits,
                                               device_points_to_host,
                                               ints_to_device_matrix,
                                               points_to_device)

# The plain versions run thousands of small tensor ops: extra intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)


def _points(n):
    g = chost.generator(CURVE)
    rng = np.random.default_rng(n)
    pts = [chost.mul(g, int(rng.integers(2, 1 << 62))) for _ in range(n)]
    pts[3] = chost.zero_point(CURVE)          # an identity in the basis
    return pts


def _scalars(k, n, seed):
    p = CURVE.scalar.p
    rng = np.random.default_rng(seed)
    rows = [[int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)]
            for _ in range(k)]
    rows[0][:4] = [0, 1, p - 1, 0]
    if k > 1:
        rows[1] = [0] * n                      # an all-zero MSM
    return rows


def _naive(pts, row):
    acc = chost.zero_point(CURVE)
    for pt, s in zip(pts, row):
        acc = chost.add(acc, chost.mul(pt, s))
    return acc


@pytest.mark.parametrize("n,k", [(37, 1), (64, 3)])
def test_msm_matches_jax(n, k):
    pts, rows = _points(n), _scalars(k, n, 7 * n + k)
    c = commit_window_bits(n)
    basis = cmsm.precompute_base(CURVE, points_to_device(CURVE, pts, "cpu"))
    got = device_points_to_host(
        CURVE, cmsm.msm(CURVE, basis, ints_to_device_matrix(
            CURVE.scalar, rows, "cpu"), c))

    f = J_CURVE.base
    jpts = jcops.from_affine(
        J_CURVE, jfops.from_ints(f, [0 if p.zero else p.x for p in pts]),
        jfops.from_ints(f, [0 if p.zero else p.y for p in pts]),
        jnp.asarray(np.array([p.zero for p in pts])))
    jscal = jnp.stack([jfops.from_ints(J_CURVE.scalar, r) for r in rows], axis=1)
    jx, jy, jzero = jax.jit(lambda P, S: jcops.to_affine(
        J_CURVE, jmsm.msm(J_CURVE, P, S, window_bits=c)))(jpts, jscal)
    xs, ys = jfops.to_ints(f, jx), jfops.to_ints(f, jy)
    want = [chost.zero_point(CURVE) if bool(z) else
            chost.AffinePoint(CURVE, int(x), int(y))
            for x, y, z in zip(np.asarray(xs).reshape(-1),
                               np.asarray(ys).reshape(-1),
                               np.asarray(jzero).reshape(-1))]
    assert got == want
    assert got[0] == _naive(pts, rows[0])


@pytest.mark.parametrize("c", range(2, 13))
def test_msm_windows_match_naive(c):
    n = 13
    pts, rows = _points(n), _scalars(2, n, c)
    rows[1] = rows[0][::-1]
    basis = cmsm.precompute_base(CURVE, points_to_device(CURVE, pts, "cpu"))
    got = device_points_to_host(CURVE, cmsm.msm(
        CURVE, basis, ints_to_device_matrix(CURVE.scalar, rows, "cpu"), c))
    assert got == [_naive(pts, r) for r in rows]


def test_window_digits_and_basis_type():
    p = CURVE.scalar.p
    vals = [0, 1, p - 1, 0x123456789ABCDEF << 190, (1 << 254) - 12345]
    x = fops.from_ints(CURVE.scalar, vals, "cpu")
    for c in (3, 5, 8):
        d = cmsm.scalar_window_digits(CURVE.scalar, x, c)
        w = -(-CURVE.scalar.bits // c)
        assert d.shape == (w, len(vals))
        for j, v in enumerate(vals):
            assert [int(t) for t in d[:, j]] == [
                (v >> (c * i)) & ((1 << c) - 1) for i in range(w)]
    pts = points_to_device(CURVE, _points(5), "cpu")
    with pytest.raises(TypeError):
        cmsm.msm(CURVE, pts, x, 3)
    basis = cmsm.precompute_base(CURVE, pts)
    assert basis.n == 5 and basis.device == torch.device("cpu")
