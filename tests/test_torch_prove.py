"""The port's prover and verifier on the CPU: with the randomness pinned as
tests/test_proof_fixture.py pins it, the port's `trivial`, `sum_pi` and
`curve_add` proofs and vks are byte-equal to the committed fixtures; the
port's verifier accepts them (with the G check) and rejects a changed
opening; and the JAX package's verifier accepts the port's proof (with the
G check: tests/fixtures/jax_proofs.json records what it accepted, and a
slow test runs it again)."""

import hashlib
import os

import numpy as np
import pytest
import torch

import _jax_fixtures as jaxfx
import plonky_tpu_torch.circuit.builder as builder_mod
import plonky_tpu_torch.protocol.halo as halo_mod
from plonky_tpu.protocol import verify_proof as jax_verify_proof
from plonky_tpu.protocol.serialization import proof_from_bytes as jax_proof_from_bytes
from plonky_tpu.protocol.serialization import vk_from_bytes as jax_vk_from_bytes
from plonky_tpu.curves import TWEEDLEDEE as J_DEE, TWEEDLEDUM as J_DUM
from chip_smoke import gadget_circuits, port_modules
from plonky_tpu_torch.circuit import CircuitBuilder, PartialWitness
from plonky_tpu_torch.curves import TWEEDLEDEE, TWEEDLEDUM
from plonky_tpu_torch.protocol import (VerificationError, generate_proof,
                                       verify_proof)
from plonky_tpu_torch.protocol.serialization import (proof_from_bytes,
                                                     proof_to_bytes,
                                                     vk_to_bytes)

# The plain versions run thousands of small tensor ops: extra intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")
NAMES = ["trivial", "sum_pi", "curve_add"]


def _trivial():
    b = CircuitBuilder(TWEEDLEDEE, security_bits=128)
    t = b.constant_wire(42)
    b.assert_zero(b.sub(t, b.constant_wire(42)))
    return b, PartialWitness()


def _sum_pi():
    b = CircuitBuilder(TWEEDLEDEE, security_bits=128)
    x, y = b.add_public_input(), b.add_public_input()
    z = b.add(x, y)
    out = b.add_public_input()
    b.copy(z, out)
    w = PartialWitness()
    w.set_target(x, 3)
    w.set_target(y, 39)
    w.set_target(out, 42)
    return b, w


def _curve_add():
    """The in-circuit add of 7 G and 11 G on Tweedledum, exported as public
    inputs (tests/test_proof_fixture.py:_curve_add_gadget_proof)."""
    builder, inputs, _want = gadget_circuits(port_modules())["curve_add"]()
    return builder, inputs


@pytest.fixture(scope="module")
def proofs():
    """{name: (proof bytes, vk bytes, vk, public inputs)}, each proved with
    a fresh pinned RNG, as the fixture test does per test."""
    saved = (builder_mod.RANDOM_SOURCE, halo_mod.RANDOM_SOURCE)
    out = {}
    try:
        for name, make in zip(NAMES, (_trivial, _sum_pi, _curve_add)):
            rng = np.random.default_rng(1337)
            source = lambda p, rng=rng: int.from_bytes(rng.bytes(40), "little") % p
            builder_mod.RANDOM_SOURCE = halo_mod.RANDOM_SOURCE = source
            builder, inputs = make()
            circuit = builder.build(device="cpu")
            witness = circuit.generate_witness(inputs)
            proof = generate_proof(circuit, witness, old_proofs=[],
                                   blinding=True)
            vk = circuit.to_vk()
            out[name] = (proof_to_bytes(TWEEDLEDEE, proof), vk_to_bytes(vk),
                         vk, circuit.get_public_inputs(witness))
    finally:
        builder_mod.RANDOM_SOURCE, halo_mod.RANDOM_SOURCE = saved
    return out


def _fixture(kind, name):
    with open(os.path.join(FIXTURE_DIR, f"{kind}_{name}.hex")) as f:
        return f.read().strip()


@pytest.mark.parametrize("name", NAMES)
def test_proof_and_vk_bytes_match_fixture(proofs, name):
    proof_bytes, vk_bytes, _vk, _pis = proofs[name]
    assert proof_bytes.hex() == _fixture("proof", name)
    assert vk_bytes.hex() == _fixture("vk", name)


@pytest.mark.parametrize("name", NAMES)
def test_port_verifier_accepts(proofs, name):
    proof_bytes, _vkb, vk, pis = proofs[name]
    proof = proof_from_bytes(TWEEDLEDEE, proof_bytes)
    assert verify_proof(pis, proof, [], vk, TWEEDLEDUM, verify_g=True,
                        device="cpu") is None


def test_port_verifier_rejects_changed_opening(proofs):
    """One wire opening changed.  Most changes already break the transcript
    (an IPA challenge with no square root); take the first that does not,
    so that the verifier's own checks must reject it."""
    proof_bytes, _vkb, vk, pis = proofs["sum_pi"]
    p = TWEEDLEDEE.scalar.p
    for delta in range(1, 256):
        proof = proof_from_bytes(TWEEDLEDEE, proof_bytes)
        proof.o_local.o_wires[0] = (proof.o_local.o_wires[0] + delta) % p
        try:
            proof.get_challenges(TWEEDLEDEE, pis, [])
        except ValueError:
            continue
        break
    else:
        pytest.fail("no changed opening kept a valid transcript")
    with pytest.raises(VerificationError):
        verify_proof(pis, proof, [], vk, TWEEDLEDUM, verify_g=True,
                     device="cpu")


def _verified(proof_bytes, vk_bytes, pis) -> dict:
    """What the JAX verifier was given, as its fixture entry records it."""
    return {"proof_sha256": hashlib.sha256(proof_bytes).hexdigest(),
            "vk_sha256": hashlib.sha256(vk_bytes).hexdigest(),
            "public_inputs": jaxfx.digest(pis), "verify_g": True}


@pytest.mark.parametrize("name", NAMES)
def test_jax_verifier_accepts_port_proof(proofs, name):
    """The JAX package's verifier accepts the port's proof with the G
    check: the port's proof, vk and public inputs are the ones it accepted
    (tests/fixtures/jax_proofs.json, made by test_jax_verifier_fixture,
    which runs the JAX verifier on them)."""
    proof_bytes, vk_bytes, _vk, pis = proofs[name]
    assert _verified(proof_bytes, vk_bytes, pis) == jaxfx.load(
        "proofs", f"jax verifier {name}")


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_jax_verifier_fixture(proofs, name):
    proof_bytes, vk_bytes, _vk, pis = proofs[name]
    proof = jax_proof_from_bytes(J_DEE, proof_bytes)
    vk = jax_vk_from_bytes(J_DEE, vk_bytes)
    assert jax_verify_proof(pis, proof, [], vk, J_DUM,
                            verify_g=True) is None
    jaxfx.check("proofs", f"jax verifier {name}", _verified(proof_bytes, vk_bytes, pis))
