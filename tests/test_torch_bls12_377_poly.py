"""The 12-limb polynomial layer, product sum and Rescue in the port (plain
versions on the CPU) against the JAX package over BLS12-377's base field
Fq (377 bits, 12 limbs), and its FFTs over the scalar field Fr (8 limbs):
`fft`, `ifft`, `coset_fft` / `coset_ifft` at [2, 8], `fft_four_step` at
n = 2^6, n1 = 2^3, `product_sum` with 33 signed terms (crossing
MAX_TERMS), `divide_by_z_h` and `eval_at_dyn`, `rescue_permutation` at 128
bits, the sharded FFTs of `parallel/`, and the slice as a whole: a coset
LDE, a product-sum quotient numerator, its coset iFFT and the division by
Z_H, against the same chain in JAX.  Inputs are made from a seed with
numpy and passed to both packages; the JAX package's outputs come back
through `interop` and every result is compared as canonical ints, with
exact equality.  Each JAX function is compiled once for the file
(`jax_out`), as one compile at 377 bits costs seconds."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky_tpu.fields import BLS12_377_BASE as J_FQ
from plonky_tpu.fields import BLS12_377_SCALAR as J_FR
from plonky_tpu.fields import ops as jfops
from plonky_tpu.hashing import rescue as jrescue
from plonky_tpu_torch import interop
from plonky_tpu_torch.fields import BLS12_377_BASE as FQ
from plonky_tpu_torch.fields import BLS12_377_SCALAR as FR
from plonky_tpu_torch.fields import ops as fops
from plonky_tpu_torch.hashing import rescue as prescue
from plonky_tpu_torch.parallel import (default_mesh, fft_sharded_batch,
                                       fft_sharded_domain)
from plonky_tpu_torch.poly import fft as pfft
from plonky_tpu_torch.poly import polynomial as ppoly

torch.set_num_threads(1)

jfft = importlib.import_module("plonky_tpu.poly.fft")
jpoly = importlib.import_module("plonky_tpu.poly.polynomial")

N = 8           # the transforms' domain
BATCH = 2
DEG = 4         # the chain's Z_H = X^DEG - 1, its LDE domain 2 DEG = N
FOUR_STEP = (6, 3)
TERMS = 33      # one more than MAX_TERMS: two reductions


def _rand(spec, rng, count):
    """count seeded elements, 0, 1, p - 1 and p - 2 first."""
    p = spec.p
    edges = [0, 1, p - 1, p - 2]
    return (edges + [int.from_bytes(rng.bytes(4 * spec.limbs + 8), "little") % p
                     for _ in range(count)])[:count]


def _port(spec, rows):
    return torch.stack([fops.from_ints(spec, r, "cpu") for r in rows], dim=1)


def _jax(jspec, rows):
    return jnp.stack([jfops.from_ints(jspec, r) for r in rows], axis=1)


def _ints(spec, x):
    return [int(v) for v in np.asarray(fops.to_ints(spec, x)).reshape(-1)]


def _from_jax(spec, arr):
    """A JAX digit array as canonical ints, through interop."""
    return _ints(spec, interop.field_from_jax_digits(spec, np.asarray(arr), "cpu"))


def _poly_mul(a, b, p):
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] = (out[i + j] + x * y) % p
    return out


def _inputs():
    """Every test's inputs, from one seed."""
    rng = np.random.default_rng(377)
    p = FQ.p
    out = {spec.name: [_rand(spec, rng, N) for _ in range(BATCH)]
           for spec in (FQ, FR)}
    out["four_step"] = _rand(FQ, rng, 1 << FOUR_STEP[0])
    out["ps"] = [_rand(FQ, rng, N) for _ in range(TERMS + 1)]
    out["signs"] = [int(s) for s in rng.choice([-1, 1], size=TERMS)]
    out["point"] = _rand(FQ, rng, 5)[4]
    out["rescue"] = [_rand(FQ, rng, 3) for _ in range(4)]
    # the chain: a, b of degree < DEG, q of degree < DEG - 1 and c = a b -
    # q (X^DEG - 1), so that a b - c = q Z_H is divisible by Z_H
    a, b = _rand(FQ, rng, DEG), _rand(FQ, rng, DEG)
    q = _rand(FQ, rng, DEG - 1)
    qz = [(-v) % p for v in q] + [0] * DEG
    for i, v in enumerate(q):
        qz[i + DEG] = (qz[i + DEG] + v) % p
    c = [(x - y) % p for x, y in zip(_poly_mul(a, b, p), qz)]
    pad = [0] * (2 * DEG)
    out["chain"] = [(a + pad)[:N], (b + pad)[:N], (c + pad)[:N]]
    out["quotient"] = q
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _four_step_table(spec, lg, lg1):
    """w_n^(i1 k2), i1 < n1, k2 < n2, on the host."""
    p, n1 = spec.p, 1 << lg1
    w = pow(spec.generator, (p - 1) >> lg, p)
    return [[pow(w, i1 * k2, p) for k2 in range((1 << lg) // n1)]
            for i1 in range(n1)]


@pytest.fixture(scope="module")
def jax_out(inputs):
    """The JAX package's results for every test, traced and compiled once
    (tracing the field ops at 377 bits is most of a JAX call's cost here):
    one jit for everything but Rescue, whose scan is compiled by its first
    call.  The coset transforms of the family and of the chain share one
    call each (batches [5, 8] and [3, 8]); fft_four_step takes the host's
    table (the JAX package builds its own eagerly, in seconds)."""
    pq, pr = jfft.FftPrecomputation(J_FQ, N), jfft.FftPrecomputation(J_FR, N)
    lg, lg1 = FOUR_STEP
    sq, sr = J_FQ.generator, J_FR.generator
    W = jfops.WORK_DB
    signs = inputs["signs"]

    @jax.jit
    def reference(xq, chain, xr, x4, tw4, point, ps):
        values = jfft.coset_fft(pq, jnp.concatenate([xq, chain], axis=1), sq)
        num = jfops.product_sum(J_FQ, [(values[:, 2], W, values[:, 3], W, 1),
                                       (values[:, 4], W, None, 0, -1)])
        back = jfft.coset_ifft(pq, jnp.concatenate([xq, num[:, None]], axis=1), sq)
        fam = {"fq": (jfft.fft(pq, xq), jfft.ifft(pq, xq), values[:, :BATCH],
                      back[:, :BATCH]),
               "fr": (jfft.fft(pr, xr), jfft.ifft(pr, xr),
                      jfft.coset_fft(pr, xr, sr), jfft.coset_ifft(pr, xr, sr))}
        chain_out = (values[:, BATCH:], num, back[:, BATCH],
                     jpoly.divide_by_z_h(J_FQ, back[:, BATCH], DEG))
        terms = [(ps[i], W, ps[i + 1], W, s) for i, s in enumerate(signs[:-1])]
        terms.append((ps[-1], W, None, 0, signs[-1]))
        return (fam, jfft.fft_four_step(J_FQ, x4, tw4, lg1),
                jpoly.eval_at_dyn(J_FQ, xq, point), chain_out,
                jfops.product_sum(J_FQ, terms))
    fam, four, ev, chain, ps = reference(
        _jax(J_FQ, inputs[FQ.name]), _jax(J_FQ, inputs["chain"]),
        _jax(J_FR, inputs[FR.name]), jfops.from_ints(J_FQ, inputs["four_step"]),
        _jax(J_FQ, _four_step_table(FQ, lg, lg1)),
        jfops.from_ints(J_FQ, [inputs["point"]]),
        [jfops.from_ints(J_FQ, r) for r in inputs["ps"]])
    rescue = jrescue.rescue_permutation(
        J_FQ, [jfops.from_ints(J_FQ, r) for r in inputs["rescue"]], 128)
    return {"fam": fam, "four": four, "ev": ev, "chain": chain, "ps": ps,
            "rescue": rescue}


@pytest.mark.parametrize("spec", [FQ, FR], ids=["fq", "fr"])
def test_fft_family_matches_jax(spec, inputs, jax_out):
    """fft, ifft, coset_fft and coset_ifft of [2, 8] (ntt_plain, the
    path of ntt_pass_l12 and ntt_pass on the card), and the round trips."""
    pre = pfft.FftPrecomputation(spec, N)
    x = _port(spec, inputs[spec.name])
    s = spec.generator
    got = (pfft.fft(pre, x), pfft.ifft(pre, x), pfft.coset_fft(pre, x, s),
           pfft.coset_ifft(pre, x, s))
    want = jax_out["fam"]["fq" if spec is FQ else "fr"]
    for name, g, w in zip(("fft", "ifft", "coset_fft", "coset_ifft"), got, want):
        assert _ints(spec, g) == _from_jax(spec, w), name
    assert torch.equal(pfft.ifft(pre, got[0]), x)
    assert torch.equal(pfft.coset_ifft(pre, got[2], s), x)
    # the first row's evaluations at the domain points, on the host
    p = spec.p
    row = inputs[spec.name][0]
    assert _ints(spec, got[0][:, 0]) == [
        sum(c * pow(w, i, p) for i, c in enumerate(row)) % p
        for w in pre.subgroup]


def test_fft_four_step_matches_jax(inputs, jax_out):
    """fft_four_step over Fq at n = 2^6, n1 = 2^3 (twiddle_transpose_plain
    and ntt_plain, the path of ntt_twiddle_transpose_l12 and ntt_pass_l12)
    against the JAX package's on the same table, which four_step_twiddles
    builds equal to the host's; forward against the flat fft, inverse
    against the flat ifft."""
    lg, lg1 = FOUR_STEP
    x = fops.from_ints(FQ, inputs["four_step"], "cpu")
    tw = pfft.four_step_twiddles(FQ, 1 << lg, lg1, device="cpu")
    assert _ints(FQ, tw.canonical) == [
        v for row in _four_step_table(FQ, lg, lg1) for v in row]
    fwd = pfft.fft_four_step(FQ, x, tw, lg1)
    assert _ints(FQ, fwd) == _from_jax(FQ, jax_out["four"])
    pre = pfft.FftPrecomputation(FQ, 1 << lg)
    assert torch.equal(fwd, pfft.fft(pre, x))
    inv = pfft.fft_four_step(FQ, x, pfft.four_step_twiddles(
        FQ, 1 << lg, lg1, inverse=True, device="cpu"), lg1, inverse=True)
    assert torch.equal(inv, pfft.ifft(pre, x))


def test_product_sum_33_signed_terms_matches_jax(inputs, jax_out):
    """product_sum over Fq with 32 signed products and a signed single
    (33 terms: two reductions, product_sums_plain, the path of
    field_product_sum_l12), against the JAX package's and python ints."""
    p = FQ.p
    rows = inputs["ps"]
    ps = [fops.from_ints(FQ, r, "cpu") for r in rows]
    signs = inputs["signs"]
    terms = [(ps[i], ps[i + 1], s) for i, s in enumerate(signs[:-1])]
    terms.append((ps[-1], None, signs[-1]))
    got = _ints(FQ, fops.product_sum(FQ, terms))
    assert got == _from_jax(FQ, jax_out["ps"])
    assert got == [(sum(s * rows[i][k] * rows[i + 1][k]
                        for i, s in enumerate(signs[:-1]))
                    + signs[-1] * rows[-1][k]) % p for k in range(N)]


def test_eval_and_divide_by_z_h_match_jax(inputs, jax_out):
    """eval_at_dyn of [2, 8] at a point and divide_by_z_h of the chain's
    numerator over Fq, against the JAX package's and the host."""
    x = _port(FQ, inputs[FQ.name])
    point = inputs["point"]
    got = _ints(FQ, ppoly.eval_at_dyn(FQ, x, fops.column(FQ, point, "cpu")))
    assert got == _from_jax(FQ, jax_out["ev"])
    assert got == [ppoly.eval_host(FQ, r, point) for r in inputs[FQ.name]]
    num = fops.from_ints(FQ, _from_jax(FQ, jax_out["chain"][2]), "cpu")
    quo = ppoly.divide_by_z_h(FQ, num, DEG)
    assert _ints(FQ, quo) == _from_jax(FQ, jax_out["chain"][3])
    assert _ints(FQ, quo) == inputs["quotient"] + [0] * (N - DEG + 1)


def test_rescue_permutation_matches_jax(inputs, jax_out):
    """rescue_permutation over Fq at 128 bits (16 rounds; the plain version
    of rescue_permutation_l12) on 3 states, 0 and p - 1 among them,
    against the JAX package's and the host permutation."""
    state = [fops.from_ints(FQ, r, "cpu") for r in inputs["rescue"]]
    got = [_ints(FQ, o) for o in prescue.rescue_permutation(FQ, state, 128)]
    assert got == [_from_jax(FQ, o) for o in jax_out["rescue"]]
    assert [list(c) for c in zip(*got)] == [
        prescue.rescue_permutation_host(FQ, list(s), 128)
        for s in zip(*inputs["rescue"])]


def test_slice_chain_matches_jax(inputs, jax_out):
    """The slice as a whole over Fq: the coset LDE of a, b and c (N = 2
    DEG), the quotient numerator a b - c as one product sum on the coset,
    its coset iFFT and the division by Z_H = X^DEG - 1, each step against
    the JAX package's same chain; the quotient is the q that c was made
    from."""
    pre = pfft.FftPrecomputation(FQ, N)
    s = FQ.generator
    values = pfft.coset_fft(pre, _port(FQ, inputs["chain"]), s)
    num = fops.product_sum(FQ, [(values[:, 0], values[:, 1], 1),
                                (values[:, 2], None, -1)])
    coeffs = pfft.coset_ifft(pre, num, s)
    quo = ppoly.divide_by_z_h(FQ, coeffs, DEG)
    for name, g, w in zip(("lde", "numerator", "coeffs", "quotient"),
                          (values, num, coeffs, quo), jax_out["chain"]):
        assert _ints(FQ, g) == _from_jax(FQ, w), name
    assert _ints(FQ, quo)[:DEG - 1] == inputs["quotient"]


def test_sharded_ffts_match_jax(inputs, jax_out):
    """parallel.fft_sharded_domain over Fq at n = 2^6 on a mesh of 4 CPU
    entries (row_twiddles, K3 and K1 at 12 limbs on the card) against the
    JAX package's four-step transform of the same input (the flat fft),
    and fft_sharded_batch of [2, 8] over 2 entries against its fft."""
    mesh = default_mesh(4, device="cpu")
    x = fops.from_ints(FQ, inputs["four_step"], "cpu")[:, None]
    got = fft_sharded_domain(mesh, FQ, x)
    assert _ints(FQ, got) == _from_jax(FQ, jax_out["four"])
    batch = fft_sharded_batch(default_mesh(2, device="cpu"),
                              pfft.FftPrecomputation(FQ, N),
                              _port(FQ, inputs[FQ.name]))
    assert _ints(FQ, batch) == _from_jax(FQ, jax_out["fam"]["fq"][0])
