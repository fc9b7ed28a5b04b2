"""The full two-level recursion cycle in the port, on the CPU.

Mirrors tests/test_recursion_cycle.py.  Level 0: a 2^8-gate circuit over
Tweedledum -> proof P0, its G check deferred (OldProof old0).  Level 1: a
circuit over Tweedledee verifying P0 -> P1.  Level 2: a circuit over
Tweedledum verifying P1 and re-checking (verify_assumptions) everything
level 1 deferred about P0 -> P2, which consumes old0.  P2 is verified with
the G check, P1's G check is closed natively, and the chain ends with
verify_assumptions_native on P2's public inputs.  Slow: it proves two
recursion circuits of 2^15 and 2^16 gates with the plain versions of the
kernels (chip_smoke.py:phase_recursion runs the same cycle on the card).
"""

import numpy as np
import pytest
import torch

import plonky_tpu_torch.circuit.builder as builder_mod
import plonky_tpu_torch.protocol.halo as halo_mod
from plonky_tpu_torch.circuit import PartialWitness
from plonky_tpu_torch.curves import TWEEDLEDEE, TWEEDLEDUM
from plonky_tpu_torch.protocol import generate_proof, verify_proof
from plonky_tpu_torch.protocol.recursion import (
    recursive_verification_circuit,
    verify_assumptions_native,
)
from plonky_tpu_torch.recursion_demo import buffer_inner_circuit

torch.set_num_threads(1)

INNER_DEGREE_POW = 8


@pytest.fixture
def pinned_randomness(monkeypatch):
    rng = np.random.default_rng(299792458)

    def fake_random(p):
        return int.from_bytes(rng.bytes(40), "little") % p

    monkeypatch.setattr(builder_mod, "RANDOM_SOURCE", fake_random)
    monkeypatch.setattr(halo_mod, "RANDOM_SOURCE", fake_random)


@pytest.mark.slow
def test_two_level_recursion_cycle(pinned_randomness):
    # --- level 0: inner proof over Tweedledum -------------------------------
    inner_circuit = buffer_inner_circuit(INNER_DEGREE_POW, "cpu")
    inner_witness = inner_circuit.generate_witness(PartialWitness())
    inner_proof = generate_proof(inner_circuit, inner_witness,
                                 old_proofs=[], blinding=True)
    inner_vk = inner_circuit.to_vk()
    old0 = verify_proof([], inner_proof, [], inner_vk, TWEEDLEDEE,
                        verify_g=False, device="cpu")
    assert old0 is not None

    # --- level 1: Tweedledee circuit verifying P0 ---------------------------
    rc1 = recursive_verification_circuit(
        TWEEDLEDEE, TWEEDLEDUM, inner_circuit.degree_pow(),
        security_bits=128, num_public_inputs=0, num_old_proofs=0,
        inner_vk=inner_vk, device="cpu")
    inputs1 = PartialWitness()
    rc1.proof.populate_witness(inputs1, inner_proof, [])
    w1 = rc1.circuit.generate_witness(inputs1)
    pis1 = rc1.circuit.get_public_inputs(w1)
    proof1 = generate_proof(rc1.circuit, w1, old_proofs=[], blinding=True)
    vk1 = rc1.circuit.to_vk()
    assert verify_proof(pis1, proof1, [], vk1, TWEEDLEDUM, verify_g=False,
                        device="cpu") is not None

    # --- level 2: Tweedledum circuit verifying P1, consuming P0's OldProof --
    rc2 = recursive_verification_circuit(
        TWEEDLEDUM, TWEEDLEDEE, rc1.circuit.degree_pow(),
        security_bits=128, num_public_inputs=len(pis1), num_old_proofs=0,
        inner_vk=vk1, device="cpu", inner_recursion={
            "degree_pow": inner_circuit.degree_pow(),
            "num_old_proofs": 0,
            "num_inner_pis": 0,
            "num_gates_without_pis": inner_vk.num_gates_without_pis,
        })
    inputs2 = PartialWitness()
    rc2.proof.populate_witness(inputs2, proof1, pis1)
    w2 = rc2.circuit.generate_witness(inputs2)
    pis2 = rc2.circuit.get_public_inputs(w2)
    proof2 = generate_proof(rc2.circuit, w2, old_proofs=[old0],
                            blinding=True)
    assert verify_proof(pis2, proof2, [old0], rc2.circuit.to_vk(), TWEEDLEDEE,
                        verify_g=True, device="cpu") is None

    # --- native termination -------------------------------------------------
    assert verify_proof(pis1, proof1, [], vk1, TWEEDLEDUM, verify_g=True,
                        device="cpu") is None
    verify_assumptions_native(
        pis2, TWEEDLEDEE, TWEEDLEDUM, rc1.circuit.degree_pow(),
        num_inner_pis=len(pis1),
        num_gates_without_pis=vk1.num_gates_without_pis)
