"""The Pallas/Vesta cycle in the port, against the JAX package, on the CPU.

In the fast tier, against the JAX package's host arithmetic (no JAX
compile) and python ints:
* K1's operations, powers and the FFT family (K3) on both Pasta base
  fields (each the other curve's scalar field);
* K2's add and double on both curves (P + P, P + (-P) and the identity
  among the cases) and the MSM (K4 and the Horner) at N = 16, K = 2;
* the batch Rescue permutation (K5's plain version) on both fields at
  128 bits (K5's model at 128 and 64 bits: tests/test_torch_rescue.py).
Slow (each costs 7-35 s on one CPU process, most of it JAX compiles, or a
port proof of ~25 s, most of it the plain Horner): the same operations
against the JAX package's device code under jit, coordinate for
coordinate; the port's four small proofs and vks byte-equal to the JAX
package's (tests/fixtures/{proof,vk}_{trivial,sum_pi}_{pallas,vesta}.hex,
made by the JAX package under tests/test_proof_fixture.py's pinned random
source; chip_smoke.py holds the card's four to them too); and the four
fixtures made again by the JAX package.
All comparisons are exact, of canonical ints, points or bytes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plonky_tpu.circuit.builder as jbuilder_mod
import plonky_tpu.protocol.halo as jhalo_mod
import plonky_tpu_torch.circuit.builder as builder_mod
import plonky_tpu_torch.protocol.halo as halo_mod
from chip_smoke import small_circuits
from plonky_tpu import hashing as jhash
from plonky_tpu.circuit import CircuitBuilder as JCircuitBuilder
from plonky_tpu.circuit import PartialWitness as JPartialWitness
from plonky_tpu.curves import PALLAS as J_PALLAS, VESTA as J_VESTA
from plonky_tpu.curves import host as jchost
from plonky_tpu.curves import msm as jmsm
from plonky_tpu.curves import ops as jcops
from plonky_tpu.fields import host as jfhost
from plonky_tpu.fields import ops as jfops
from plonky_tpu.protocol import generate_proof as jax_generate_proof
from plonky_tpu.protocol.serialization import proof_to_bytes as jax_proof_to_bytes
from plonky_tpu.protocol.serialization import vk_to_bytes as jax_vk_to_bytes
from plonky_tpu_torch.curves import PALLAS, VESTA
from plonky_tpu_torch.curves import host as chost
from plonky_tpu_torch.curves import msm as cmsm
from plonky_tpu_torch.curves import ops as cops
from plonky_tpu_torch.fields import ops as fops
from plonky_tpu_torch.hashing import rescue as prescue
from plonky_tpu_torch.poly import fft as pfft
from plonky_tpu_torch.protocol import generate_proof
from plonky_tpu_torch.protocol.circuit import (commit_window_bits,
                                               device_points_to_host,
                                               ints_to_device_matrix,
                                               points_to_device)
from plonky_tpu_torch.protocol.serialization import proof_to_bytes, vk_to_bytes

torch.set_num_threads(1)

jfft = __import__("importlib").import_module("plonky_tpu.poly.fft")

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CURVES = [(PALLAS, J_PALLAS), (VESTA, J_VESTA)]
IDS = [c.name for c, _j in CURVES]


def _values(spec, rng, n):
    """n canonical elements: 0, 1, p - 1, p - 2 first, then seeded ones."""
    p = spec.p
    vals = [0, 1, p - 1, p - 2] + [int.from_bytes(rng.bytes(40), "little") % p
                                   for _ in range(n)]
    return vals[:n]


def _ints(x):
    return [int(v) for v in np.asarray(x).reshape(-1)]


@pytest.mark.parametrize("curve,jcurve", CURVES, ids=IDS)
def test_field_ops_and_fft_match_jax_host(curve, jcurve):
    """K1's operations and K3's transforms on the curve's base field
    against the JAX package's host arithmetic (plonky_tpu.fields.host) and
    python ints: add, sub, mul, a product sum, inverse, powers_dyn, and
    fft, ifft and the coset pair at n = 16 (a batch of 3) against direct
    evaluation at the JAX package's roots of unity."""
    spec, jspec = curve.base, jcurve.base
    p = spec.p
    rng = np.random.default_rng(len(spec.name))
    av, bv, cv = (_values(spec, rng, 13) for _ in range(3))
    col = _values(spec, rng, 5)[4]
    a, b, c = (fops.from_ints(spec, v, "cpu") for v in (av, bv, cv))
    ccol = fops.column(spec, col, "cpu")
    got = {"add": fops.add(spec, a, b), "sub": fops.sub(spec, a, b),
           "mul": fops.mul(spec, a, b),
           "product_sum": fops.product_sum(spec, [(ccol, a, 1), (b, c, -1),
                                                  (a, None, 1)]),
           "inverse": fops.inverse(spec, a)}
    want = {"add": [(x + y) % p for x, y in zip(av, bv)],
            "sub": [(x - y) % p for x, y in zip(av, bv)],
            "mul": [x * y % p for x, y in zip(av, bv)],
            "product_sum": [(col * x - y * z + x) % p
                            for x, y, z in zip(av, bv, cv)],
            "inverse": [jfhost.exp(jspec, x, p - 2) for x in av]}
    for k in want:
        assert _ints(fops.to_ints(spec, got[k])) == want[k], k
    assert _ints(fops.to_ints(spec, pfft.powers_dyn(spec, ccol, 9))) == [
        jfhost.exp(jspec, col, i) for i in range(9)]

    n = 16
    rows = [_values(spec, rng, n)[::-1] for _ in range(3)]
    x = ints_to_device_matrix(spec, rows, "cpu")
    pre = pfft.FftPrecomputation(spec, n)
    w = jfhost.primitive_root_of_unity(jspec, 4)
    shift = spec.generator

    def evals(row, root, scale=1):
        return [sum(cf * pow(scale, i, p) * pow(root, i * j, p)
                    for i, cf in enumerate(row)) % p for j in range(n)]
    n_inv = pow(n, -1, p)
    for name, out, want_rows in (
            ("fft", pfft.fft(pre, x), [evals(r, w) for r in rows]),
            ("coset_fft", pfft.coset_fft(pre, x, shift),
             [evals(r, w, shift) for r in rows]),
            ("ifft", pfft.ifft(pre, x),
             [[v * n_inv % p for v in evals(r, pow(w, -1, p))] for r in rows]),
            ("coset_ifft", pfft.coset_ifft(pre, x, shift),
             [[v * n_inv % p * pow(shift, -i, p) % p
               for i, v in enumerate(evals(r, pow(w, -1, p)))] for r in rows])):
        got_rows = np.asarray(fops.to_ints(spec, out)).tolist()
        assert [[int(v) for v in r] for r in got_rows] == want_rows, name


@pytest.mark.parametrize("curve,jcurve", CURVES, ids=IDS)
def test_curve_ops_and_msm_match_jax_host(curve, jcurve):
    """K2's add and double (P + P, P + (-P) and the identity among the
    cases) and the MSM of 16 points with K = 2 at the main path's window,
    against the JAX package's host curve arithmetic
    (plonky_tpu.curves.host)."""
    jg = jchost.generator(jcurve)
    rng = np.random.default_rng(len(curve.name))
    jr = [jchost.mul(jg, int(rng.integers(2, 1 << 62))) for _ in range(16)]
    jzero = jchost.zero_point(jcurve)
    ja_pts = [jg, jg, jg, jzero, jzero, jr[0], jr[1]]
    jb_pts = [jg, jg.neg(), jzero, jg, jzero, jr[1], jr[2]]

    def port(pts):
        return [chost.zero_point(curve) if q.zero else
                chost.AffinePoint(curve, q.x, q.y) for q in pts]
    a = points_to_device(curve, port(ja_pts), "cpu")
    b = points_to_device(curve, port(jb_pts), "cpu")
    s = cops.add(curve, a, b)
    sums = [jchost.add(p, q) for p, q in zip(ja_pts, jb_pts)]
    assert device_points_to_host(curve, s) == port(sums)
    assert device_points_to_host(curve, cops.double(curve, s)) == port(
        [jchost.add(q, q) for q in sums])

    pts = jr[:]
    pts[3] = jzero
    sf = curve.scalar
    rows = [_values(sf, rng, 16), _values(sf, rng, 16)[::-1]]
    basis = cmsm.precompute_base(curve, points_to_device(curve, port(pts), "cpu"))
    got = device_points_to_host(curve, cmsm.msm(
        curve, basis, ints_to_device_matrix(sf, rows, "cpu"),
        commit_window_bits(16)))
    want = []
    for row in rows:
        acc = jzero
        for q, sc in zip(pts, row):
            acc = jchost.add(acc, jchost.mul(q, sc))
        want.append(acc)
    assert got == port(want)


@pytest.mark.parametrize("curve,jcurve", CURVES, ids=IDS)
def test_rescue_permutation_matches_jax_host(curve, jcurve):
    """A batch of 3 width-4 states (0 and p - 1 among them) through the
    port's rescue_permutation on CPU tensors (K5's plain version) and the
    JAX package's host permutation, at 128 bits."""
    spec, jspec = curve.base, jcurve.base
    rng = np.random.default_rng(7)
    cols = [_values(spec, rng, 3) for _ in range(4)]
    cols[1] = cols[1][::-1]
    got = prescue.rescue_permutation(
        spec, [fops.from_ints(spec, col, "cpu") for col in cols], 128)
    ints = [_ints(fops.to_ints(spec, g)) for g in got]
    for i in range(3):
        assert [col[i] for col in ints] == jhash.rescue_permutation_host(
            jspec, [col[i] for col in cols], 128)


@pytest.mark.slow
@pytest.mark.parametrize("curve,jcurve", CURVES, ids=IDS)
def test_field_ops_and_fft_match_jax(curve, jcurve):
    """K1 (add, sub, mul, square, a product sum with a column operand, a
    negative product and singles, inverse) and K3 (fft, ifft, coset fft
    and ifft at n = 16, a batch of 3) and powers_dyn, on the curve's base
    field."""
    spec, jspec = curve.base, jcurve.base
    rng = np.random.default_rng(len(spec.name))
    av, bv, cv = (_values(spec, rng, 13) for _ in range(3))
    col = _values(spec, rng, 5)[4]
    rows = [_values(spec, rng, 16)[::-1] for _ in range(3)]
    W = jfops.WORK_DB
    jpre = jfft.FftPrecomputation(jspec, 16)
    shift = spec.generator

    @jax.jit
    def reference(ja, jb, jc, jcol, jx):
        return (jfops.add(jspec, ja, jb), jfops.sub(jspec, ja, jb),
                jfops.mul(jspec, ja, jb), jfops.square(jspec, ja),
                jfops.product_sum(jspec, [(jcol, W, ja, W, 1), (jb, W, jc, W, -1),
                                          (ja, W, None, 0, 1)]),
                jfops.inverse(jspec, ja),
                jfft.fft(jpre, jx), jfft.ifft(jpre, jx),
                jfft.coset_fft(jpre, jx, shift), jfft.coset_ifft(jpre, jx, shift),
                jfft.powers_dyn(jspec, jcol, 9))

    want = reference(*(jfops.from_ints(jspec, v) for v in (av, bv, cv, [col])),
                     jnp.stack([jfops.from_ints(jspec, r) for r in rows], axis=1))
    a, b, c = (fops.from_ints(spec, v, "cpu") for v in (av, bv, cv))
    ccol = fops.column(spec, col, "cpu")
    x = ints_to_device_matrix(spec, rows, "cpu")
    pre = pfft.FftPrecomputation(spec, 16)
    got = (fops.add(spec, a, b), fops.sub(spec, a, b), fops.mul(spec, a, b),
           fops.square(spec, a),
           fops.product_sum(spec, [(ccol, a, 1), (b, c, -1), (a, None, 1)]),
           fops.inverse(spec, a), pfft.fft(pre, x), pfft.ifft(pre, x),
           pfft.coset_fft(pre, x, shift), pfft.coset_ifft(pre, x, shift),
           pfft.powers_dyn(spec, ccol, 9))
    names = ("add", "sub", "mul", "square", "product_sum", "inverse", "fft",
             "ifft", "coset_fft", "coset_ifft", "powers_dyn")
    for name, g, w in zip(names, got, want):
        assert _ints(fops.to_ints(spec, g)) == _ints(jfops.to_ints(jspec, w)), name
    p = spec.p
    assert _ints(fops.to_ints(spec, got[4])) == [
        (col * x - y * z + x) % p for x, y, z in zip(av, bv, cv)]


def _jax_points(jcurve, pts):
    f = jcurve.base
    return jcops.from_affine(
        jcurve, jfops.from_ints(f, [0 if q.zero else q.x for q in pts]),
        jfops.from_ints(f, [0 if q.zero else q.y for q in pts]),
        jnp.asarray(np.array([q.zero for q in pts])))


@pytest.mark.slow
@pytest.mark.parametrize("curve,jcurve", CURVES, ids=IDS)
def test_curve_ops_and_msm_match_jax(curve, jcurve):
    """K2's add and double, coordinate for coordinate; the MSM of 16
    points (an identity among them) with K = 2 at the window the main path
    picks, against the JAX package's and a naive host sum."""
    g = chost.generator(curve)
    rng = np.random.default_rng(len(curve.name))
    r = [chost.mul(g, int(rng.integers(2, 1 << 62))) for _ in range(16)]
    zero = chost.zero_point(curve)
    pts_a = [g, g, g, zero, zero, r[0], r[1]]
    pts_b = [g, g.neg(), zero, g, zero, r[1], r[2]]
    a = points_to_device(curve, pts_a, "cpu")
    b = points_to_device(curve, pts_b, "cpu")
    s = cops.add(curve, a, b)
    d = cops.double(curve, s)
    assert device_points_to_host(curve, s) == [chost.add(p, q)
                                               for p, q in zip(pts_a, pts_b)]
    js, jd = jax.jit(lambda p, q: (jcops.add(jcurve, p, q), jcops.double(
        jcurve, jcops.add(jcurve, p, q))))(_jax_points(jcurve, pts_a),
                                           _jax_points(jcurve, pts_b))
    for got, want in zip((*s, *d), (*js, *jd)):
        assert _ints(fops.to_ints(curve.base, got)) == _ints(
            jfops.to_ints(jcurve.base, want))

    pts = r[:]
    pts[3] = zero
    sf = curve.scalar
    rows = [_values(sf, rng, 16), _values(sf, rng, 16)[::-1]]
    c = commit_window_bits(16)
    basis = cmsm.precompute_base(curve, points_to_device(curve, pts, "cpu"))
    got = device_points_to_host(curve, cmsm.msm(
        curve, basis, ints_to_device_matrix(sf, rows, "cpu"), c))
    jx, jy, jzero = jax.jit(lambda P, S: jcops.to_affine(
        jcurve, jmsm.msm(jcurve, P, S, window_bits=c)))(
        _jax_points(jcurve, pts),
        jnp.stack([jfops.from_ints(jcurve.scalar, row) for row in rows], axis=1))
    want = [zero if bool(z) else chost.AffinePoint(curve, int(x), int(y))
            for x, y, z in zip(_ints(jfops.to_ints(jcurve.base, jx)),
                               _ints(jfops.to_ints(jcurve.base, jy)),
                               np.asarray(jzero).reshape(-1))]
    assert got == want
    for row, pt in zip(rows, got):
        acc = zero
        for q, sc in zip(pts, row):
            acc = chost.add(acc, chost.mul(q, sc))
        assert pt == acc


@pytest.mark.slow
@pytest.mark.parametrize("curve,jcurve", CURVES, ids=IDS)
def test_rescue_permutation_matches_jax(curve, jcurve):
    """A batch of 3 width-4 states (0 and p - 1 among them) through the
    port's rescue_permutation on CPU tensors (K5's plain version) and the
    JAX package's under jit, and the host permutation."""
    spec, jspec = curve.base, jcurve.base
    rng = np.random.default_rng(7)
    cols = [_values(spec, rng, 3) for _ in range(4)]
    cols[1] = cols[1][::-1]
    got = prescue.rescue_permutation(
        spec, [fops.from_ints(spec, col, "cpu") for col in cols], 128)
    jout = jax.jit(lambda s: jhash.rescue_permutation(jspec, s, 128))(
        [jfops.from_ints(jspec, col) for col in cols])
    for g, w in zip(got, jout):
        assert _ints(fops.to_ints(spec, g)) == _ints(jfops.to_ints(jspec, w))
    ints = [_ints(fops.to_ints(spec, g)) for g in got]
    for i in range(3):
        assert [col[i] for col in ints] == prescue.rescue_permutation_host(
            spec, [col[i] for col in cols], 128)


def pinned_source():
    """tests/test_proof_fixture.py's pinned random source, fresh."""
    rng = np.random.default_rng(1337)
    return lambda p: int.from_bytes(rng.bytes(40), "little") % p


def _fixture(kind, name, curve):
    with open(os.path.join(FIXTURES, f"{kind}_{name}_{curve.name.lower()}.hex")) as f:
        return f.read().strip()


def _port_proof(curve, name):
    """(proof hex, vk hex) of the port's proof of circuit `name` over
    `curve` on the CPU, under a fresh pinned source."""
    saved = (builder_mod.RANDOM_SOURCE, halo_mod.RANDOM_SOURCE)
    builder_mod.RANDOM_SOURCE = halo_mod.RANDOM_SOURCE = pinned_source()
    try:
        builder, inputs = small_circuits(curve)[name]()
        circuit = builder.build(device="cpu")
        proof = generate_proof(circuit, circuit.generate_witness(inputs),
                               old_proofs=[], blinding=True)
    finally:
        builder_mod.RANDOM_SOURCE, halo_mod.RANDOM_SOURCE = saved
    return proof_to_bytes(curve, proof).hex(), vk_to_bytes(circuit.to_vk()).hex()


@pytest.mark.slow
@pytest.mark.parametrize("curve,name", [
    (PALLAS, "trivial"), (VESTA, "sum_pi"), (PALLAS, "sum_pi"),
    (VESTA, "trivial")], ids=["Pallas-trivial", "Vesta-sum_pi",
                              "Pallas-sum_pi", "Vesta-trivial"])
def test_port_proof_matches_jax_fixture(curve, name):
    proof_hex, vk_hex = _port_proof(curve, name)
    assert proof_hex == _fixture("proof", name, curve)
    assert vk_hex == _fixture("vk", name, curve)


def _jax_small(jcurve, name):
    """The JAX package's `name` circuit over jcurve (chip_smoke.small_circuits'
    circuits, built with the JAX package's builder)."""
    b = JCircuitBuilder(jcurve, security_bits=128)
    w = JPartialWitness()
    if name == "trivial":
        t = b.constant_wire(42)
        b.assert_zero(b.sub(t, b.constant_wire(42)))
    else:
        x, y = b.add_public_input(), b.add_public_input()
        z = b.add(x, y)
        out = b.add_public_input()
        b.copy(z, out)
        w.set_target(x, 3)
        w.set_target(y, 39)
        w.set_target(out, 42)
    return b, w


@pytest.mark.slow
@pytest.mark.parametrize("curve,jcurve", CURVES, ids=IDS)
def test_jax_makes_the_pasta_fixtures(curve, jcurve, monkeypatch):
    """The fixtures made again by the JAX package (~3 min a curve on one
    CPU process, most of it compiles); PLONKY_WRITE_FIXTURES=1 writes
    them."""
    for name in ("trivial", "sum_pi"):
        source = pinned_source()
        monkeypatch.setattr(jbuilder_mod, "RANDOM_SOURCE", source)
        monkeypatch.setattr(jhalo_mod, "RANDOM_SOURCE", source)
        builder, inputs = _jax_small(jcurve, name)
        circuit = builder.build()
        proof = jax_generate_proof(circuit, circuit.generate_witness(inputs),
                                   old_proofs=[], blinding=True)
        got = {"proof": jax_proof_to_bytes(jcurve, proof).hex(),
               "vk": jax_vk_to_bytes(circuit.to_vk()).hex()}
        for kind, data in got.items():
            path = os.path.join(FIXTURES, f"{kind}_{name}_{curve.name.lower()}.hex")
            if os.environ.get("PLONKY_WRITE_FIXTURES"):
                with open(path, "w") as f:
                    f.write(data + "\n")
            assert data == _fixture(kind, name, curve), (kind, name)
