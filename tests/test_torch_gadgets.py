"""The port's gadget library (plonky_tpu_torch/circuit/gadgets) against the
JAX package's.

The witness tests mirror tests/test_gadgets.py: each circuit is built in
both packages (light mode, the builder's random source pinned to one seed
in both) and the port's witness values must equal the JAX package's and the
integers they stand for.  The proof tests mirror
tests/test_prove_verify_gadgets.py through chip_smoke.gadget_circuits: the
port proves each circuit on the CPU with the random source that file pins,
its public inputs must be the values the JAX package's host arithmetic
gives, the port's verifier must accept it with the G check, and its sha256
must be chip_smoke.GADGET_PROOF_SHA256's, the hash chip_smoke.py asserts
for the card's proof; the JAX package's proof of each circuit must hash to
the same value (curve_double's, in the fast tier, read from
tests/fixtures/jax_proofs.json and equal to the port's bytes).  The in-circuit MSM (~2^11 gates) is slow-marked as in the
reference; its test proves the circuit in both packages and holds the two
proofs' bytes equal and to the pinned hash.
"""

import functools
import hashlib
import types

import numpy as np
import pytest
import torch

import _jax_fixtures as jaxfx
import plonky_tpu.circuit.builder as jbuilder_mod
import plonky_tpu.protocol.halo as jhalo_mod
import plonky_tpu_torch.circuit.builder as builder_mod
from chip_smoke import (GADGET_PROOF_SHA256, gadget_circuits, gadget_random,
                        pinned_proof, port_modules)
from plonky_tpu import circuit as jcircuit
from plonky_tpu.circuit import gadgets as jgadgets
from plonky_tpu.circuit.gadgets import curve as jcurve_gadgets
from plonky_tpu.curves import TWEEDLEDEE as J_DEE, TWEEDLEDUM as J_DUM
from plonky_tpu.curves import host as jchost
from plonky_tpu.hashing import rescue_hash_n_to_1_host as jax_rescue_hash
from plonky_tpu.protocol import generate_proof as jax_generate_proof
from plonky_tpu.protocol.serialization import proof_to_bytes as jax_proof_to_bytes
from plonky_tpu_torch import circuit as pcircuit
from plonky_tpu_torch.circuit import gadgets as pgadgets
from plonky_tpu_torch.curves import TWEEDLEDUM

torch.set_num_threads(1)

# (circuit package, gadgets, the inner curve, build's keywords) of each
# package
PACKAGES = {"port": (pcircuit, pgadgets, TWEEDLEDUM, {"device": "cpu"}),
            "jax": (jcircuit, jgadgets, J_DUM, {})}
JAX_MODULES = types.SimpleNamespace(
    CircuitBuilder=jcircuit.CircuitBuilder, PartialWitness=jcircuit.PartialWitness,
    gadgets=jcurve_gadgets, TWEEDLEDEE=J_DEE, TWEEDLEDUM=J_DUM, chost=jchost,
    rescue_hash_n_to_1_host=jax_rescue_hash)


@pytest.fixture(autouse=True)
def deterministic_randomness(monkeypatch):
    """One source per package, both from the seed tests/test_gadgets.py
    uses."""
    for mod in (builder_mod, jbuilder_mod):
        rng = np.random.default_rng(2718)
        monkeypatch.setattr(mod, "RANDOM_SOURCE",
                            lambda p, rng=rng: int.from_bytes(rng.bytes(40), "little") % p)
    yield


def witness_both(build_fn, inputs_fn=None):
    """build_fn(gadgets, builder) in each package on its Tweedledum
    builder, light build; returns {package: (partial witness, build_fn's
    result)}."""
    out = {}
    for name, (circ, gadgets, curve, kwargs) in PACKAGES.items():
        builder = circ.CircuitBuilder(curve, security_bits=128)
        made = build_fn(gadgets, builder)
        circuit = builder.build(light=True, **kwargs)
        inputs = circ.PartialWitness()
        if inputs_fn is not None:
            inputs_fn(inputs, made)
        out[name] = (circuit.generate_partial_witness(inputs), made)
    return out


def _values(results, read):
    """read(gadgets, pw, made) in each package: the two must agree."""
    got = {name: read(PACKAGES[name][1], pw, made)
           for name, (pw, made) in results.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def test_bigint_add():
    x = 22222222222222222222222222222222222222
    y = 33333333333333333333333333333333333333
    res = witness_both(lambda g, b: g.bigint_add(b, g.constant_bigint(b, x),
                                                 g.constant_bigint(b, y)))
    assert _values(res, lambda g, pw, z: g.get_bigint_target(pw, z)) == x + y


def test_bigint_mul():
    x = 123123123123123123123123123123123123
    y = 456456456456456456456456456456456456
    res = witness_both(lambda g, b: g.bigint_mul(b, g.constant_bigint(b, x),
                                                 g.constant_bigint(b, y)))
    assert _values(res, lambda g, pw, z: g.get_bigint_target(pw, z)) == x * y


def test_bigint_div_rem():
    x = 456456456456456456456456456456456456
    y = 123123123123123123123123123123123123
    res = witness_both(lambda g, b: g.bigint_div_rem(b, g.constant_bigint(b, x),
                                                     g.constant_bigint(b, y)))
    got = _values(res, lambda g, pw, dr: (g.get_bigint_target(pw, dr[0]),
                                          g.get_bigint_target(pw, dr[1])))
    assert got == (x // y, x % y)


def test_foreign_field_ops():
    rng = np.random.default_rng(5)
    p = TWEEDLEDUM.scalar.p
    x = int.from_bytes(rng.bytes(40), "little") % p
    y = int.from_bytes(rng.bytes(40), "little") % p

    def build(g, b):
        ff = b.curve.scalar        # foreign to the builder's own field
        xt, yt = g.constant_foreign_field(b, ff, x), g.constant_foreign_field(b, ff, y)
        return g.foreign_field_add(b, xt, yt), g.foreign_field_mul(b, xt, yt)

    res = witness_both(build)
    got = _values(res, lambda g, pw, sm: (g.get_foreign_field_target(pw, sm[0]),
                                          g.get_foreign_field_target(pw, sm[1])))
    assert got == ((x + y) % p, x * y % p)


def test_builder_logic_gadgets():
    def build(_g, b):
        t = b.add_virtual_target()
        z = b.is_zero(t)
        nz = b.is_nonzero(t)
        sel = b.select(z, b.constant_wire(10), b.constant_wire(20))
        inv = b.inv(b.constant_wire(7))
        sqrt = b.deterministic_square_root(b.constant_wire(16))
        return t, z, nz, sel, inv, sqrt

    res = witness_both(build, lambda inputs, made: inputs.set_target(made[0], 0))
    z, nz, sel, inv, sqrt = _values(
        res, lambda _g, pw, made: tuple(pw.get_target(t) for t in made[1:]))
    p = TWEEDLEDUM.scalar.p
    assert (z, nz, sel) == (1, 0, 10)
    assert inv * 7 % p == 1
    assert sqrt * sqrt % p == 16 and sqrt % 2 == 0


# ---------------------------------------------------------------------------
# Proofs (tests/test_prove_verify_gadgets.py)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def port_gadget_proof(name):
    """The port's proof of gadget circuit `name` on the CPU under a fresh
    gadget_random(), verified by the port's verifier with the G check:
    (proof bytes, public inputs, the JAX package's expected public
    inputs); made once a process (the source is pinned)."""
    def build():
        builder, inputs, _want = gadget_circuits(port_modules())[name]()
        return builder.build(device="cpu"), inputs
    got = pinned_proof(build, gadget_random(), device="cpu")
    return got["bytes"], got["pis"], gadget_circuits(JAX_MODULES)[name]()[2]


FAST_GADGETS = ["rescue", "curve_add", "curve_double", "base4sum"]


@pytest.mark.parametrize("name", FAST_GADGETS)
def test_port_gadget_proof_verifies(name):
    proof, pis, want = port_gadget_proof(name)
    assert pis == want
    assert hashlib.sha256(proof).hexdigest() == GADGET_PROOF_SHA256[name]


def jax_gadget_proof_bytes(name):
    """The JAX package's proof bytes of gadget circuit `name` on the CPU
    under a fresh gadget_random()."""
    saved = (jbuilder_mod.RANDOM_SOURCE, jhalo_mod.RANDOM_SOURCE)
    jbuilder_mod.RANDOM_SOURCE = jhalo_mod.RANDOM_SOURCE = gadget_random()
    try:
        builder, inputs, _want = gadget_circuits(JAX_MODULES)[name]()
        circuit = builder.build()
        witness = circuit.generate_witness(inputs)
        proof = jax_generate_proof(circuit, witness, old_proofs=[], blinding=True)
    finally:
        jbuilder_mod.RANDOM_SOURCE, jhalo_mod.RANDOM_SOURCE = saved
    return jax_proof_to_bytes(J_DEE, proof)


# Each JAX proof costs 90-300 s on one CPU worker, most of it compiles: the
# cheapest (curve_double, degree 8) runs in the fast tier from its bytes
# in tests/fixtures/jax_proofs.json (test_jax_gadget_fixture makes them
# again), the rest are slow.
@pytest.mark.parametrize("name", [
    name if name == "curve_double" else pytest.param(name, marks=pytest.mark.slow)
    for name in FAST_GADGETS])
def test_jax_gadget_proof_is_the_pinned_sha256(name):
    """The JAX package's proof of each small gadget circuit hashes to the
    value the port's proof is held to, here and on the card; curve_double's
    bytes are also the port's."""
    if name == "curve_double":
        proof = bytes.fromhex(jaxfx.load("proofs", "gadget curve_double"))
        assert proof == port_gadget_proof(name)[0]
    else:
        proof = jax_gadget_proof_bytes(name)
    assert hashlib.sha256(proof).hexdigest() == GADGET_PROOF_SHA256[name]


@pytest.mark.slow
def test_jax_gadget_fixture():
    """The JAX package's curve_double proof bytes that
    test_jax_gadget_proof_is_the_pinned_sha256 reads, made again."""
    jaxfx.check("proofs", "gadget curve_double", jax_gadget_proof_bytes("curve_double").hex())


@pytest.mark.slow
def test_curve_msm_proof_matches_jax():
    """The ~2^11-gate in-circuit MSM: the port's proof verifies, its bytes
    are the JAX package's, and their sha256 is the one chip_smoke.py
    asserts on the card."""
    proof_bytes, pis, want = port_gadget_proof("curve_msm")
    assert pis == want
    want_bytes = jax_gadget_proof_bytes("curve_msm")
    assert hashlib.sha256(want_bytes).hexdigest() == GADGET_PROOF_SHA256["curve_msm"]
    assert proof_bytes == want_bytes
