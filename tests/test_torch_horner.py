"""The MSM's Horner across windows (plonky_tpu_torch.curves.msm.horner_plain,
the plain version of the curve_horner kernel, on the CPU) against the JAX
package's Horner (plonky_tpu/curves/msm.py:401-411, a fori_loop of
jcops.double / jcops.add), projective triple for triple, and against
sum_w 2^(c w) ws[w] on the host; and the point kernels' constant buffer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky_tpu.curves import TWEEDLEDEE as J_DEE, TWEEDLEDUM as J_DUM
from plonky_tpu.curves import ops as jcops
from plonky_tpu.fields import ops as jfops
from plonky_tpu_torch.curves import BLS12_377, TWEEDLEDEE, TWEEDLEDUM
from plonky_tpu_torch.curves import host as chost
from plonky_tpu_torch.curves import msm as cmsm
from plonky_tpu_torch.curves import ops as cops
from plonky_tpu_torch.fields import ops as fops
from plonky_tpu_torch.fields.spec import LIMBS
from plonky_tpu_torch.protocol.circuit import device_points_to_host

torch.set_num_threads(1)

CURVES = {"Tweedledee": (TWEEDLEDEE, J_DEE), "Tweedledum": (TWEEDLEDUM, J_DUM)}


def _window_sums(curve, k, n_windows, seed):
    """Window sums [K, W] as host points and as projective ints: real points
    with a random Z != 1, and the identity (0 : 1 : 0) at a few places (one
    whole window when W > 1, as an all-zero window row gives)."""
    p = curve.base.p
    g = chost.generator(curve)
    rng = np.random.default_rng(seed)
    pts, coords = [], []
    for m in range(k):
        for w in range(n_windows):
            if (w == 1 and n_windows > 1) or (m + w) % 4 == 3:
                pts.append(chost.zero_point(curve))
                coords.append((0, 1, 0))
                continue
            pt = chost.mul(g, int(rng.integers(2, 1 << 62)))
            lam = int.from_bytes(rng.bytes(32), "little") % (p - 1) + 1
            pts.append(pt)
            coords.append((pt.x * lam % p, pt.y * lam % p, lam))
    return pts, [[c[i] for c in coords] for i in range(3)]


def _jax_horner(jcurve, ws, c):
    """plonky_tpu/curves/msm.py:401-411 with c as an argument."""
    n_windows = ws[0].shape[-1]
    acc = tuple(t[..., n_windows - 1] for t in ws)

    def horner_step(j, acc):
        acc = jax.lax.fori_loop(0, c, lambda _i, q: jcops.double(jcurve, q), acc)
        w = n_windows - 2 - j
        win = tuple(jax.lax.dynamic_index_in_dim(
            t, w, axis=t.ndim - 1, keepdims=False) for t in ws)
        return jcops.add(jcurve, acc, win)

    return jax.lax.fori_loop(0, n_windows - 1, horner_step, acc)


_JAX_HORNER = jax.jit(_jax_horner, static_argnums=0)


@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("n_windows", [1, 2, 5])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name", list(CURVES))
def test_horner_plain_matches_jax_and_host(name, k, n_windows, c):
    curve, jcurve = CURVES[name]
    f = curve.base
    pts, ints = _window_sums(curve, k, n_windows, 100 * k + 10 * n_windows + c)
    ws = tuple(fops.from_ints(f, v, "cpu").reshape(LIMBS, k, n_windows)
               for v in ints)
    got = cmsm.horner_plain(curve, ws, c)
    assert all(t.shape == (LIMBS, k) for t in got)
    # on a CPU tensor the wrapper is the plain version
    assert all(torch.equal(a, b) for a, b in zip(cmsm.horner(curve, ws, c), got))

    jws = tuple(jfops.from_ints(jcurve.base, v).reshape(-1, k, n_windows)
                for v in ints)
    want = _JAX_HORNER(jcurve, jws, jnp.int32(c))
    for g, w in zip(got, want):
        assert ([int(v) for v in np.asarray(fops.to_ints(f, g)).reshape(-1)]
                == [int(v) for v in np.asarray(jfops.to_ints(jcurve.base, w))
                    .reshape(-1)])

    for m, res in enumerate(device_points_to_host(curve, got)):
        acc = chost.zero_point(curve)
        for w in range(n_windows):
            acc = chost.add(acc, chost.mul(pts[m * n_windows + w], 1 << (c * w)))
        assert res == acc, m


@pytest.mark.parametrize("name", [*CURVES, "Bls12377"])
def test_consts_buffer_holds_r_squared(name):
    """[p, -p^-1 mod 2^32, b3, R^2 mod p] at the base field's L limbs, R =
    2^(32 L): 2^512 mod p at 8 limbs, 2^768 mod p on BLS12-377 (12)."""
    curve = CURVES[name][0] if name in CURVES else BLS12_377
    p, nl = curve.base.p, curve.base.limbs
    buf = [int(v) for v in cops._consts_host(curve)]
    assert len(buf) == 3 * nl + 1

    def value(at):
        return sum(v << (32 * i) for i, v in enumerate(buf[at:at + nl]))

    assert value(0) == p
    assert buf[nl] == (-pow(p, -1, 1 << 32)) % (1 << 32)
    assert value(nl + 1) == 3 * curve.b % p
    assert value(2 * nl + 1) == pow(2, 64 * nl, p)
