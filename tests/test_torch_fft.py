"""The port's FFTs and polynomial helpers (plonky_tpu_torch.poly, plain
versions on the CPU) against the JAX package's plonky_tpu.poly on a [9, n]
batch, plus the roll convention the prover's shifts rely on."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky_tpu.fields import TWEEDLEDUM_BASE as J_SPEC
from plonky_tpu.fields import ops as jfops
from plonky_tpu_torch import interop
from plonky_tpu_torch.fields import TWEEDLEDUM_BASE as SPEC
from plonky_tpu_torch.fields import ops as fops
from plonky_tpu_torch.poly import fft as pfft
from plonky_tpu_torch.poly import polynomial as ppoly

# The plain versions run thousands of small tensor ops: extra intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

jfft = importlib.import_module("plonky_tpu.poly.fft")
jpoly = importlib.import_module("plonky_tpu.poly.polynomial")


def _rand(rng, shape):
    p = SPEC.p
    return [[int.from_bytes(rng.bytes(40), "little") % p
             for _ in range(shape[1])] for _ in range(shape[0])]


def _port(rows):
    from plonky_tpu_torch.protocol.circuit import ints_to_device_matrix
    return ints_to_device_matrix(SPEC, rows, "cpu")


def _jax(rows):
    return jnp.stack([jfops.from_ints(J_SPEC, r) for r in rows], axis=1)


def _same(port, jax_arr):
    got = np.asarray(fops.to_ints(SPEC, port)).reshape(-1)
    want = np.asarray(jfops.to_ints(J_SPEC, jax_arr)).reshape(-1)
    return [int(v) for v in got] == [int(v) for v in want]


@pytest.mark.parametrize("n", [16, 64])
def test_fft_family_matches_jax(n):
    rng = np.random.default_rng(n)
    rows = _rand(rng, (9, n))
    low = [r[: n // 8] for r in rows]
    pre, jpre = pfft.FftPrecomputation(SPEC, n), jfft.FftPrecomputation(J_SPEC, n)
    shift = SPEC.generator

    @jax.jit
    def reference(x, xl):
        return (jfft.fft(jpre, x), jfft.ifft(jpre, x), jfft.lde(jpre, xl),
                jfft.coset_fft(jpre, x, shift), jfft.coset_ifft(jpre, x, shift))

    want = reference(_jax(rows), _jax(low))
    x, xl = _port(rows), _port(low)
    got = (pfft.fft(pre, x), pfft.ifft(pre, x), pfft.lde(pre, xl),
           pfft.coset_fft(pre, x, shift), pfft.coset_ifft(pre, x, shift))
    for name, g, w in zip(("fft", "ifft", "lde", "coset_fft", "coset_ifft"),
                          got, want):
        assert _same(g, w), name
    assert _same(pfft.ifft(pre, pfft.fft(pre, x)), _jax(rows))


def test_eval_divide_and_powers_match_jax():
    n, big = 8, 64
    rng = np.random.default_rng(3)
    rows = _rand(rng, (2, n))
    point = 0xABCDEF123456789 % SPEC.p
    col = fops.column(SPEC, point, "cpu")
    jcol = jfops.from_ints(J_SPEC, [point])
    assert _same(ppoly.eval_at_dyn(SPEC, _port(rows), col),
                 jax.jit(lambda c, pt: jpoly.eval_at_dyn(J_SPEC, c, pt))(
                     _jax(rows), jcol))
    assert _same(pfft.powers_dyn(SPEC, col, 37),
                 jax.jit(lambda pt: jfft.powers_dyn(J_SPEC, pt, 37))(jcol))
    # an exactly divisible polynomial: q * (X^n - 1)
    q = _rand(rng, (1, big - n))[0]
    prod = [0] * big
    for i, c in enumerate(q):
        prod[i] = (prod[i] - c) % SPEC.p
        prod[i + n] = (prod[i + n] + c) % SPEC.p
    got = ppoly.divide_by_z_h(SPEC, _port([prod])[:, 0], n)
    assert [int(v) for v in fops.to_ints(SPEC, got)] == q + [0] * n
    want = jax.jit(lambda c: jpoly.divide_by_z_h(J_SPEC, c, n))(_jax([prod])[:, 0])
    assert _same(got, want)


def test_circuit_tensors_from_jax():
    """JAX [D, 6, n] coefficient and value tensors read back as the port's."""
    n = 16
    rng = np.random.default_rng(9)
    rows = _rand(rng, (6, n))
    jpre, jpre8 = jfft.FftPrecomputation(J_SPEC, n), jfft.FftPrecomputation(J_SPEC, 8 * n)
    jpolys = jax.jit(lambda v: jfft.ifft(jpre, v))(_jax(rows))
    j8 = jax.jit(lambda c: jfft.lde(jpre8, c))(jpolys)
    got = interop.circuit_tensors_from_jax(SPEC, {
        "constant_polynomials": np.asarray(jpolys),
        "constants_8n": np.asarray(j8)}, "cpu")
    polys = pfft.ifft(pfft.FftPrecomputation(SPEC, n), _port(rows))
    assert torch.equal(got["constant_polynomials"], polys)
    assert torch.equal(got["constants_8n"],
                       pfft.lde(pfft.FftPrecomputation(SPEC, 8 * n), polys))


def test_roll_sign_matches_jnp_roll():
    """The prover's shifts (z and wires by -8 and -8 * GRID_WIDTH) use
    torch.roll where the JAX package uses jnp.roll."""
    x = np.arange(3 * 40).reshape(3, 40)
    for shift in (-8, -8 * 65, 3):
        assert np.array_equal(torch.roll(torch.from_numpy(x), shift, dims=-1).numpy(),
                              np.asarray(jnp.roll(x, shift, axis=-1)))
