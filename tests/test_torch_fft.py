"""The port's FFTs and polynomial helpers (plonky_tpu_torch.poly, plain
versions on the CPU) against the JAX package's plonky_tpu.poly on a [9, n]
batch and ragged batches (the transforms' outputs held to the sha256 of
the JAX package's, tests/fixtures/jax_fft.json, which slow tests make
again), plus the roll convention the prover's shifts rely on."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_fixtures as jaxfx
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


FAMILY = ("fft", "ifft", "lde", "coset_fft", "coset_ifft")


def _family_inputs(n, batch, seed):
    rng = np.random.default_rng(seed)
    rows = _rand(rng, (batch, n))
    return rows, [r[: max(1, n // 8)] for r in rows]


def _port_family(n, rows, low):
    pre, shift = pfft.FftPrecomputation(SPEC, n), SPEC.generator
    x, xl = _port(rows), _port(low)
    return pre, x, (pfft.fft(pre, x), pfft.ifft(pre, x), pfft.lde(pre, xl),
                    pfft.coset_fft(pre, x, shift), pfft.coset_ifft(pre, x, shift))


def _jax_family(n, rows, low) -> dict:
    """sha256 of each of the JAX package's five transforms of the rows."""
    jpre, shift = jfft.FftPrecomputation(J_SPEC, n), SPEC.generator

    @jax.jit
    def reference(x, xl):
        return (jfft.fft(jpre, x), jfft.ifft(jpre, x), jfft.lde(jpre, xl),
                jfft.coset_fft(jpre, x, shift), jfft.coset_ifft(jpre, x, shift))
    want = reference(_jax(rows), _jax(low))
    return {name: jaxfx.digest(np.asarray(jfops.to_ints(J_SPEC, w)).reshape(-1))
            for name, w in zip(FAMILY, want)}


def _family_digests(got) -> dict:
    return {name: jaxfx.digest(np.asarray(fops.to_ints(SPEC, g)).reshape(-1))
            for name, g in zip(FAMILY, got)}


@pytest.mark.parametrize("n", [16, 64])
def test_fft_family_matches_jax(n):
    """fft, ifft, lde and the coset pair on [9, n] against the JAX
    package's (the sha256 of its canonical outputs,
    tests/fixtures/jax_fft.json, made by test_jax_fft_family_fixture), and
    the round trip."""
    rows, low = _family_inputs(n, 9, n)
    pre, x, got = _port_family(n, rows, low)
    assert _family_digests(got) == jaxfx.load("fft", f"family {n}")
    assert _same(pfft.ifft(pre, pfft.fft(pre, x)), _jax(rows))


@pytest.mark.slow
@pytest.mark.parametrize("n", [16, 64])
def test_jax_fft_family_fixture(n):
    jaxfx.check("fft", f"family {n}", _jax_family(n, *_family_inputs(n, 9, n)))


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


BATCHES = [(2, 1), (2, 3), (2, 9), (16, 1), (16, 3), (64, 1), (64, 3),
           (1024, 1), (1024, 3), (1024, 9)]


@pytest.mark.parametrize("n,batch", BATCHES)
def test_fft_family_batches_match_jax(n, batch):
    """The whole-transform plain version (ntt_plain, the CPU path of fft,
    ifft, lde, coset_fft and coset_ifft) against the JAX package (the
    sha256 of its canonical outputs, tests/fixtures/jax_fft.json, made by
    test_jax_fft_batches_fixture), below one group of a pass (n = 2, 16,
    64), across two passes (n = 2^10) and over ragged batches."""
    rows, low = _family_inputs(n, batch, 100 * n + batch)
    _pre, _x, got = _port_family(n, rows, low)
    for name, g in zip(FAMILY, got):
        assert g.shape == (8, batch, n), name
    assert _family_digests(got) == jaxfx.load("fft", f"batches {n} {batch}")


@pytest.mark.slow
@pytest.mark.parametrize("n,batch", BATCHES)
def test_jax_fft_batches_fixture(n, batch):
    jaxfx.check("fft", f"batches {n} {batch}",
                _jax_family(n, *_family_inputs(n, batch, 100 * n + batch)))


@pytest.mark.parametrize("max_layers", [1, 2, 3, 9])
def test_pass_plan(max_layers):
    """Every layer of 2^lg points in exactly one pass, in order, at most
    max_layers a pass, in ceil(lg / max_layers) passes, spread evenly."""
    for lg in range(0, 23):
        plan = pfft.pass_plan(lg, max_layers)
        assert len(plan) == -(-lg // max_layers)
        layers = [l0 + d for l0, kp in plan for d in range(kp)]
        assert layers == list(range(lg))
        sizes = [kp for _l0, kp in plan]
        assert all(1 <= kp <= max_layers for kp in sizes)
        assert not sizes or max(sizes) - min(sizes) <= 1
    assert pfft.pass_plan(17) == [(0, 6), (6, 6), (12, 5)]
    assert pfft.pass_plan(14) == [(0, 7), (7, 7)]
    assert pfft.pass_plan(6) == [(0, 6)]
    # the 12-limb kernel's own plan (NTT_L12_MAX_LAYERS layers a pass)
    assert pfft.pass_plan(22, limbs=12) == [(0, 6), (6, 6), (12, 5), (17, 5)]
    assert pfft.pass_plan(20, limbs=12) == [(0, 7), (7, 7), (14, 6)]
    assert pfft.pass_plan(14, limbs=12) == [(0, 7), (7, 7)]
    assert pfft.pass_plan(7, limbs=12) == [(0, 7)]
    assert pfft.pass_plan(22, max_layers, limbs=12) == pfft.pass_plan(22, max_layers)


def _kernel_defines(limbs: int = 8):
    """ntt_kernels.cu's limits of ntt_pass at a field width (NTT_* at 8
    limbs, NTT_L12_* at 12), without the prefix."""
    import os
    import re
    path = os.path.join(os.path.dirname(pfft.__file__), "..", "csrc", "ntt_kernels.cu")
    with open(path) as f:
        found = re.findall(r"^#define (NTT_\w+) (\d+)$", f.read(), re.M)
    if limbs == 8:
        return {k[len("NTT_"):]: int(v) for k, v in found if not k.startswith("NTT_L")}
    prefix = f"NTT_L{limbs}_"
    return {k[len(prefix):]: int(v) for k, v in found if k.startswith(prefix)}


# The kernel's shared memory a block at 12 limbs (dynamic, allowed by the C
# entry up to the H100's 227 KB a block).
SMEM_L12_MAX = 232448


@pytest.mark.parametrize("limbs,batch", [(8, 1), (8, 3), (8, 9), (12, 1), (12, 3),
                                         (12, 9)],
                         ids=["1", "3", "9", "l12-1", "l12-3", "l12-9"])
def test_ntt_launches_fit_the_kernel(limbs, batch):
    """ntt_kernels.cu's limits at each width are fft.py's, and every pass
    that ntt() launches (n = 2 .. 2^22) stays inside them: at most the
    width's layers a pass, a block's groups at most its elements a block
    and, with their padding, at most the shared memory (the static array
    at 8 limbs; at 12 the dynamic allowance, 48 B an element, and the
    threads at most NTT_L12_THREADS, a multiple of 32); no block beyond the
    groups but the last one's tail; a launch's blocks within the grid's
    2^31 - 1."""
    defines = _kernel_defines(limbs)
    max_layers, block_elems = pfft.ntt_shape(limbs)
    assert (defines["MAX_LAYERS"], defines["BLOCK_ELEMS"]) == (max_layers, block_elems)
    smem_elems = (block_elems + (1 << max_layers) if limbs == 8
                  else SMEM_L12_MAX // (4 * limbs))
    if limbs == 12:
        assert defines["THREADS"] % 32 == 0 and defines["MIN_BLOCKS"] >= 1
    for lg in range(1, 23):
        for _l0, kp in pfft.pass_plan(lg, limbs=limbs):
            lg_groups = pfft.block_groups(batch, lg, kp, limbs)
            size, groups = 1 << kp, 1 << lg_groups
            assert kp <= defines["MAX_LAYERS"]
            assert size * groups <= defines["BLOCK_ELEMS"]
            assert size * (groups + 1) <= smem_elems
            assert groups < 2 * (batch << (lg - kp))
            assert -(-(batch << (lg - kp)) // groups) < 1 << 31


def _layers_reference(pre, x, inverse, shift):
    """The layer-by-layer transform: a bit-reversal gather, lg n layers of
    butterflies over the whole row, then the scales, with python ints."""
    p, n = SPEC.p, pre.n
    root = pre.g_inv if inverse else pre.g
    out = []
    for row in x:
        if shift is not None and not inverse:
            row = [v * pow(shift, i, p) % p for i, v in enumerate(row)]
        lg = pre.lg_n
        y = [row[int(format(i, f"0{lg}b")[::-1], 2) if lg else 0] for i in range(n)]
        m = 1
        while m < n:
            w = pow(root, n // (2 * m), p)
            for g0 in range(0, n, 2 * m):
                for j in range(m):
                    e, o = y[g0 + j], y[g0 + j + m] * pow(w, j, p) % p
                    y[g0 + j], y[g0 + j + m] = (e + o) % p, (e - o) % p
            m *= 2
        if inverse:
            s_inv = pow(shift, -1, p) if shift is not None else 1
            y = [v * pre.n_inv * pow(s_inv, i, p) % p for i, v in enumerate(y)]
        out.append(y)
    return out


@pytest.mark.parametrize("max_layers", [1, 2, 3])
@pytest.mark.parametrize("inverse,coset", [(False, False), (True, False),
                                           (False, True), (True, True)],
                         ids=["fft", "ifft", "coset_fft", "coset_ifft"])
def test_pass_decomposition_equals_layers(max_layers, inverse, coset):
    """With passes of at most 1, 2 or 3 layers forced, the kernel's
    decomposition (bit-reversed first-pass groups, strided later groups,
    twiddle indices, the scales in the first and last pass) equals the
    layer-by-layer transform, at n = 2^6 over a ragged batch of 3."""
    n = 64
    rng = np.random.default_rng(7 + max_layers)
    rows = _rand(rng, (3, n))
    pre = pfft.FftPrecomputation(SPEC, n)
    shift = SPEC.generator if coset else None
    got = pfft.ntt_plain(pre, _port(rows), inverse, shift, max_layers=max_layers)
    want = _layers_reference(pre, rows, inverse, shift)
    assert [[int(v) for v in r] for r in fops.to_ints(SPEC, got)] == want


@pytest.mark.parametrize("lg", [1, 5, 10, 17])
def test_pass_groups_cover_every_position(lg):
    """Each pass reads and writes every position of a row exactly once, and
    the first pass reads through the bit reversal."""
    for l0, kp in pfft.pass_plan(lg):
        src, dst = pfft._pass_groups(lg, l0, kp, "cpu")
        assert src.shape == (1 << (lg - kp), 1 << kp)
        for idx in (src, dst):
            assert torch.equal(idx.reshape(-1).sort().values, torch.arange(1 << lg))
        if l0 == 0:
            rev = pfft._bit_reverse(dst, lg)
            assert torch.equal(rev, src)


def _twiddle_ints(pre, inverse):
    """The twiddle table as python ints, layer by layer: layer ell
    (half-size m = 2^ell) holds [w^j, j < m], w = g^(n / 2m)."""
    p = SPEC.p
    root = pre.g_inv if inverse else pre.g
    out = []
    for ell in range(pre.lg_n):
        m = 1 << ell
        w = pow(root, pre.n // (2 * m), p)
        out += [pow(w, j, p) for j in range(m)]
    return out


def test_montgomery_tables():
    """The kernel's tables: twiddles w 2^256, coset powers shift^i 2^256
    and inverse scales n^-1 (shift^-i) 2^256, all mod p."""
    p, n, R = SPEC.p, 32, 1 << 256
    pre = pfft.FftPrecomputation(SPEC, n)
    shift = SPEC.generator
    for inverse in (False, True):
        plain = [int(v) for v in fops.to_ints(SPEC, pre.twiddles("cpu", inverse)).reshape(-1)]
        mont = [int(v) for v in fops.to_ints(
            SPEC, pre.twiddles("cpu", inverse, montgomery=True)).reshape(-1)]
        assert plain == _twiddle_ints(pre, inverse)
        assert mont == [w * R % p for w in plain]
    coset = fops.to_ints(SPEC, pre.coset_powers("cpu", shift, montgomery=True))
    assert [int(v) for v in coset.reshape(-1)] == [
        pow(shift, i, p) * R % p for i in range(n)]
    scale = fops.to_ints(SPEC, pre.inverse_scale("cpu", shift, montgomery=True))
    assert [int(v) for v in scale.reshape(-1)] == [
        pre.n_inv * pow(shift, -i, p) * R % p for i in range(n)]
    col = fops.to_ints(SPEC, pre.inverse_scale("cpu", montgomery=True))
    assert [int(v) for v in col.reshape(-1)] == [pre.n_inv * R % p]


@pytest.mark.parametrize("n", [2, 32, 1024])
def test_device_twiddle_build_equals_host(n):
    """The twiddle table as every device builds it (powers of the root by
    K1's doubling, every (n / 2m)-th for layer m), run here with the plain
    versions, equals the layer-by-layer python-int table in both forms and
    directions."""
    pre = pfft.FftPrecomputation(SPEC, n)
    R = pow(2, 256, SPEC.p)
    for inverse in (False, True):
        want = _twiddle_ints(pre, inverse)
        for montgomery in (False, True):
            got = fops.to_ints(SPEC, pre.twiddles("cpu", inverse, montgomery))
            assert [int(v) for v in got.reshape(-1)] == (
                [w * R % SPEC.p for w in want] if montgomery else want)