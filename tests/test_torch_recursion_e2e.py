"""End-to-end recursive proofs in the port, on the CPU.

Mirrors tests/test_recursion_e2e.py: a level-1 recursion proof (over
Tweedledee) of a circuit that verifies a 2^8-gate inner proof (over
Tweedledum), made and verified with the G check (slow: the recursion
circuit has 2^15 gates, which the plain versions of the kernels prove for
a long time on the CPU).

The card's level-1 proof of chip_smoke.py:phase_recursion (inner degree
2^14; tests/fixtures/recursion_l1_proof.hex, _vk.hex and _pis.txt; the
proof hashes to chip_smoke.RECURSION_L1_SHA256, the hash that phase
asserts on the card) is verified on the CPU: by the port's
verifier without the linear-time G check (tier-1), and with it by the
port's and by the JAX package's verifiers (slow: the G check hashes 2^15
Pedersen bases and runs a 2^15-point MSM on the CPU).
"""

import hashlib
import os

import numpy as np
import pytest
import torch

import plonky_tpu_torch.circuit.builder as builder_mod
import plonky_tpu_torch.protocol.halo as halo_mod
from chip_smoke import RECURSION_L1_SHA256
from plonky_tpu.curves import TWEEDLEDEE as J_DEE, TWEEDLEDUM as J_DUM
from plonky_tpu.protocol import verify_proof as jax_verify_proof
from plonky_tpu.protocol.serialization import proof_from_bytes as jax_proof_from_bytes
from plonky_tpu.protocol.serialization import vk_from_bytes as jax_vk_from_bytes
from plonky_tpu_torch.circuit import PartialWitness
from plonky_tpu_torch.curves import TWEEDLEDEE, TWEEDLEDUM
from plonky_tpu_torch.protocol import generate_proof, verify_proof
from plonky_tpu_torch.protocol.serialization import proof_from_bytes, vk_from_bytes
from plonky_tpu_torch.protocol.recursion import recursive_verification_circuit
from plonky_tpu_torch.recursion_demo import buffer_inner_circuit

torch.set_num_threads(1)

INNER_DEGREE_POW = 8
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture
def pinned_randomness(monkeypatch):
    rng = np.random.default_rng(161803)

    def fake_random(p):
        return int.from_bytes(rng.bytes(40), "little") % p

    monkeypatch.setattr(builder_mod, "RANDOM_SOURCE", fake_random)
    monkeypatch.setattr(halo_mod, "RANDOM_SOURCE", fake_random)


@pytest.mark.slow
def test_level1_recursion_proof_end_to_end(pinned_randomness):
    inner_circuit = buffer_inner_circuit(INNER_DEGREE_POW, "cpu")
    inner_witness = inner_circuit.generate_witness(PartialWitness())
    inner_proof = generate_proof(inner_circuit, inner_witness,
                                 old_proofs=[], blinding=True)
    inner_vk = inner_circuit.to_vk()
    assert verify_proof([], inner_proof, [], inner_vk, TWEEDLEDEE,
                        verify_g=True, device="cpu") is None

    rc = recursive_verification_circuit(
        TWEEDLEDEE, TWEEDLEDUM, inner_circuit.degree_pow(),
        security_bits=128, num_public_inputs=0, num_old_proofs=0,
        inner_vk=inner_vk, device="cpu")
    inputs = PartialWitness()
    rc.proof.populate_witness(inputs, inner_proof, [])
    recursion_witness = rc.circuit.generate_witness(inputs)
    pis1 = rc.circuit.get_public_inputs(recursion_witness)

    recursion_proof = generate_proof(rc.circuit, recursion_witness,
                                     old_proofs=[], blinding=True)
    assert verify_proof(pis1, recursion_proof, [], rc.circuit.to_vk(),
                        TWEEDLEDUM, verify_g=True, device="cpu") is None


def _fixture(name):
    with open(os.path.join(FIXTURES, f"recursion_l1_{name}")) as f:
        return f.read()


@pytest.fixture(scope="module")
def card_level1():
    """(proof bytes, vk bytes, public inputs) of the card's level-1 proof."""
    return (bytes.fromhex(_fixture("proof.hex").strip()),
            bytes.fromhex(_fixture("vk.hex").strip()),
            [int(x) for x in _fixture("pis.txt").split()])


def test_card_level1_proof_is_the_pinned_one(card_level1):
    assert hashlib.sha256(card_level1[0]).hexdigest() == RECURSION_L1_SHA256


def test_port_verifier_accepts_card_level1_proof(card_level1):
    """Every check but the linear-time G check, which is deferred: the
    returned OldProof carries it."""
    proof_bytes, vk_bytes, pis = card_level1
    vk = vk_from_bytes(TWEEDLEDEE, vk_bytes)
    old = verify_proof(pis, proof_from_bytes(TWEEDLEDEE, proof_bytes), [], vk,
                       TWEEDLEDUM, verify_g=False, device="cpu")
    assert old is not None and len(old.halo_us) == vk.degree.bit_length() - 1


@pytest.mark.slow
def test_port_verifier_g_check_accepts_card_level1_proof(card_level1):
    proof_bytes, vk_bytes, pis = card_level1
    assert verify_proof(pis, proof_from_bytes(TWEEDLEDEE, proof_bytes), [],
                        vk_from_bytes(TWEEDLEDEE, vk_bytes), TWEEDLEDUM,
                        verify_g=True, device="cpu") is None


@pytest.mark.slow
def test_jax_verifier_accepts_card_level1_proof(card_level1):
    proof_bytes, vk_bytes, pis = card_level1
    assert jax_verify_proof(pis, jax_proof_from_bytes(J_DEE, proof_bytes), [],
                            jax_vk_from_bytes(J_DEE, vk_bytes), J_DUM,
                            verify_g=True) is None
