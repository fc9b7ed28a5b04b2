"""The port's four-step FFT (plonky_tpu_torch.poly.fft.fft_four_step and
four_step_twiddles, plain versions on the CPU) against the JAX package's
(plonky_tpu.poly.fft, run as tests/test_fft.py runs it; the sha256 of its
outputs read from tests/fixtures/jax_fft.json, made again by slow tests)
and the port's flat
`ntt`, forward and inverse, with and without a batch; and the plain version
of the ntt_twiddle_transpose kernel against a direct per-element
reference at a non-square shape.  Canonical ints are compared exactly
(ROADMAP C4)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_fixtures as jaxfx
from plonky_tpu.fields import TWEEDLEDEE_BASE as J_SPEC
from plonky_tpu.fields import ops as jfops
from plonky_tpu_torch.fields import TWEEDLEDEE_BASE as SPEC
from plonky_tpu_torch.fields import ops as fops
from plonky_tpu_torch.poly import fft as pfft

# The plain versions run thousands of small tensor ops: extra intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

jfft = importlib.import_module("plonky_tpu.poly.fft")


def _rand(rng, count):
    return [int.from_bytes(rng.bytes(40), "little") % SPEC.p for _ in range(count)]


def _ints(x):
    return [int(v) for v in np.asarray(x).reshape(-1)]


TWIDDLE_CASES = [(6, 3), (8, 3), (10, 5)]


@pytest.mark.parametrize("lg_n,lg_n1", TWIDDLE_CASES)
def test_four_step_twiddles_match_jax(lg_n, lg_n1):
    """[8, n1, n2] = w_n^(+-i1 k2), canonical, equal to the JAX package's
    table (its sha256, tests/fixtures/jax_fft.json, made by
    test_jax_four_step_twiddles_fixture); the kernel's cached copy is
    w 2^256 mod p."""
    n, n1 = 1 << lg_n, 1 << lg_n1
    n2 = n // n1
    for inverse in (False, True):
        tw = pfft.four_step_twiddles(SPEC, n, lg_n1, inverse, device="cpu")
        assert tw.canonical.shape == tw.montgomery.shape == (8, n1, n2)
        got = _ints(fops.to_ints(SPEC, tw.canonical))
        assert jaxfx.digest(got) == jaxfx.load("fft", f"four-step twiddles {lg_n} {lg_n1} {inverse}")
        mont = _ints(fops.to_ints(SPEC, tw.montgomery))
        assert mont == [v * pow(2, 256, SPEC.p) % SPEC.p for v in got]
        assert pfft.four_step_twiddles(SPEC, n, lg_n1, inverse, "cpu") is tw


@pytest.mark.slow
@pytest.mark.parametrize("lg_n,lg_n1", TWIDDLE_CASES)
def test_jax_four_step_twiddles_fixture(lg_n, lg_n1):
    for inverse in (False, True):
        want = jfops.to_ints(J_SPEC, jfft.four_step_twiddles(
            J_SPEC, 1 << lg_n, lg_n1, inverse=inverse))
        jaxfx.check("fft", f"four-step twiddles {lg_n} {lg_n1} {inverse}",
                    jaxfx.digest(_ints(want)))


FOUR_STEP_CASES = [(6, 3, None), (8, 3, 3), (10, 5, None), (10, 5, 3)]


def _four_step_rows(lg_n, lg_n1, batch):
    rng = np.random.default_rng(lg_n * 10 + lg_n1 + (batch or 0))
    return [_rand(rng, 1 << lg_n) for _ in range(batch or 1)]


@pytest.mark.parametrize("lg_n,lg_n1,batch", FOUR_STEP_CASES)
def test_fft_four_step_matches_jax_and_flat(lg_n, lg_n1, batch):
    """Forward and inverse against the JAX package's fft_four_step (under
    jit, as tests/test_fft.py runs it; the sha256 of its outputs,
    tests/fixtures/jax_fft.json, made by test_jax_fft_four_step_fixture)
    and the port's flat ntt; the inverse of the forward is the input."""
    n = 1 << lg_n
    rows = _four_step_rows(lg_n, lg_n1, batch)
    if batch is None:
        x = fops.from_ints(SPEC, rows[0], "cpu")
    else:
        x = torch.stack([fops.from_ints(SPEC, r, "cpu") for r in rows], dim=1)
    pre = pfft.FftPrecomputation(SPEC, n)
    for inverse in (False, True):
        tw = pfft.four_step_twiddles(SPEC, n, lg_n1, inverse, "cpu")
        got = pfft.fft_four_step(SPEC, x, tw, lg_n1, inverse)
        assert got.shape == x.shape
        assert jaxfx.digest(_ints(fops.to_ints(SPEC, got))) == jaxfx.load(
            "fft", f"four-step {lg_n} {lg_n1} {batch} {inverse}")
        assert torch.equal(got, pfft.ntt(pre, x, inverse))
    fwd = pfft.fft_four_step(SPEC, x, pfft.four_step_twiddles(SPEC, n, lg_n1,
                                                              device="cpu"), lg_n1)
    back = pfft.fft_four_step(SPEC, fwd, pfft.four_step_twiddles(
        SPEC, n, lg_n1, True, "cpu"), lg_n1, inverse=True)
    assert torch.equal(back, x)


@pytest.mark.slow
@pytest.mark.parametrize("lg_n,lg_n1,batch", FOUR_STEP_CASES)
def test_jax_fft_four_step_fixture(lg_n, lg_n1, batch):
    rows = _four_step_rows(lg_n, lg_n1, batch)
    if batch is None:
        jx = jfops.from_ints(J_SPEC, rows[0])
    else:
        jx = jnp.stack([jfops.from_ints(J_SPEC, r) for r in rows], axis=1)
    for inverse in (False, True):
        jtw = jfft.four_step_twiddles(J_SPEC, 1 << lg_n, lg_n1, inverse=inverse)
        if batch is not None:     # the JAX ops broadcast from the left
            jtw = jtw[:, None]
        want = jax.jit(lambda v, t: jfft.fft_four_step(
            J_SPEC, v, t, lg_n1, inverse=inverse))(jx, jtw)
        jaxfx.check("fft", f"four-step {lg_n} {lg_n1} {batch} {inverse}",
                    jaxfx.digest(_ints(jfops.to_ints(J_SPEC, want))))


def test_twiddle_transpose_plain_is_the_direct_product():
    """[8, 2, 3, 5] times [8, 3, 5], transposed to [8, 2, 5, 3]:
    y[b, j, i] = x[b, i, j] tw[i, j] mod p, element by element; without a
    table, the transpose alone."""
    p = SPEC.p
    rng = np.random.default_rng(35)
    xs = [_rand(rng, 15) for _ in range(2)]
    ws = _rand(rng, 15)
    ws[:3] = [0, 1, p - 1]
    x = torch.stack([fops.from_ints(SPEC, r, "cpu") for r in xs], 1).reshape(8, 2, 3, 5)
    tw = pfft.Twiddles.of(SPEC, fops.from_ints(SPEC, ws, "cpu").reshape(8, 3, 5))
    got = pfft.twiddle_transpose_plain(SPEC, x, tw)
    assert got.shape == (8, 2, 5, 3) and got.is_contiguous()
    vals = fops.to_ints(SPEC, got)
    bare = fops.to_ints(SPEC, pfft.twiddle_transpose_plain(SPEC, x))
    for b in range(2):
        for i in range(3):
            for j in range(5):
                assert int(vals[b, j, i]) == xs[b][5 * i + j] * ws[5 * i + j] % p
                assert int(bare[b, j, i]) == xs[b][5 * i + j]
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(pfft.twiddle_transpose(SPEC, x, tw), got)


def test_four_step_refuses_bad_shapes():
    x = torch.zeros((8, 64), dtype=torch.int32)
    tw = pfft.four_step_twiddles(SPEC, 64, 3, device="cpu")
    with pytest.raises(ValueError):
        pfft.fft_four_step(SPEC, x, tw, 2)            # tw of another split
    with pytest.raises(ValueError):
        pfft.fft_four_step(SPEC, x[:, :60], tw, 3)    # n not n1 n2
    with pytest.raises(ValueError):
        pfft.four_step_twiddles(SPEC, 64, 7, device="cpu")
