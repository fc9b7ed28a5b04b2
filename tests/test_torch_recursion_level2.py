"""The level-2 recursion circuit of both packages, on the CPU.

The level-2 circuit (over Tweedledum) verifies a level-1 recursion proof
(over Tweedledee) and re-checks, through `inner_recursion`, the values
level 1 deferred: `num_public_inputs=len(pis1)` and the inner circuit's
description chain the checks (plonky_tpu_torch/protocol/recursion.py,
recursive_verification_circuit).  Both packages build it light (no
Pedersen bases) from the card's level-1 proof
(tests/fixtures/recursion_l1_{proof,vk}.hex, recursion_l1_pis.txt, made
by chip_smoke.py:phase_recursion over a 2^14-gate inner circuit), and
their degree, gate count, public-input layout, exports and wire values
must be equal.  Neither package proves anything here.  Slow: the two
builds and witnesses of the 2^17-row circuit take ~3 min on one CPU
process.
"""

import os

import pytest
import torch

import plonky_tpu.circuit.builder as jbuilder_mod
import plonky_tpu.protocol.halo as jhalo_mod
import plonky_tpu.protocol.recursion as jrec
import plonky_tpu_torch.circuit.builder as builder_mod
import plonky_tpu_torch.protocol.halo as halo_mod
from chip_smoke import RECURSION_INNER_LG
from plonky_tpu.circuit import PartialWitness as JPartialWitness
from plonky_tpu.curves import TWEEDLEDEE as J_DEE, TWEEDLEDUM as J_DUM
from plonky_tpu.protocol.serialization import proof_from_bytes as jax_proof_from_bytes
from plonky_tpu.protocol.serialization import vk_from_bytes as jax_vk_from_bytes
from plonky_tpu_torch.circuit import CircuitBuilder, PartialWitness
from plonky_tpu_torch.circuit.gates import BufferGate
from plonky_tpu_torch.curves import TWEEDLEDEE, TWEEDLEDUM
from plonky_tpu_torch.protocol.recursion import recursive_verification_circuit
from plonky_tpu_torch.protocol.serialization import proof_from_bytes, vk_from_bytes
from test_torch_recursion import SECURITY_BITS, Pinned, _pi_layout

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _fixture(name):
    with open(os.path.join(FIXTURES, f"recursion_l1_{name}")) as f:
        return f.read()


def _inner_gates_without_pis() -> int:
    """num_gates_without_pis of the 2^RECURSION_INNER_LG BufferGate inner
    circuit (recursion_demo.buffer_inner_circuit), read from its builder:
    the gate count the level-2 circuit's inner_recursion carries."""
    b = CircuitBuilder(TWEEDLEDUM, security_bits=SECURITY_BITS)
    while b.num_gates() < (1 << RECURSION_INNER_LG) - 3:
        b.add_gate_no_constants(BufferGate(b.num_gates()))
    return b.num_gates()


@pytest.fixture(scope="module")
def level2():
    proof_bytes = bytes.fromhex(_fixture("proof.hex").strip())
    vk_bytes = bytes.fromhex(_fixture("vk.hex").strip())
    pis1 = [int(x) for x in _fixture("pis.txt").split()]
    vk1 = vk_from_bytes(TWEEDLEDEE, vk_bytes)
    degree_pow = vk1.degree.bit_length() - 1
    inner_recursion = {"degree_pow": RECURSION_INNER_LG, "num_old_proofs": 0,
                       "num_inner_pis": 0,
                       "num_gates_without_pis": _inner_gates_without_pis()}
    with Pinned(builder_mod, halo_mod):
        rc = recursive_verification_circuit(
            TWEEDLEDUM, TWEEDLEDEE, degree_pow, SECURITY_BITS,
            num_public_inputs=len(pis1), num_old_proofs=0, inner_vk=vk1,
            inner_recursion=inner_recursion, light=True, device="cpu")
        inputs = PartialWitness()
        rc.proof.populate_witness(
            inputs, proof_from_bytes(TWEEDLEDEE, proof_bytes), pis1)
        witness = rc.circuit.generate_witness(inputs)
    with Pinned(jbuilder_mod, jhalo_mod):
        j_rc = jrec.recursive_verification_circuit(
            J_DUM, J_DEE, degree_pow, SECURITY_BITS,
            num_public_inputs=len(pis1), num_old_proofs=0,
            inner_vk=jax_vk_from_bytes(J_DEE, vk_bytes),
            inner_recursion=inner_recursion, light=True)
        j_inputs = JPartialWitness()
        j_rc.proof.populate_witness(
            j_inputs, jax_proof_from_bytes(J_DEE, proof_bytes), pis1)
        j_witness = j_rc.circuit.generate_witness(j_inputs)
    return {"rc": rc, "witness": witness, "j_rc": j_rc,
            "j_witness": j_witness, "pis1": pis1}


@pytest.mark.slow
def test_level2_circuit_matches_jax(level2):
    """Degree, gates without public inputs, public-input count and layout,
    exports and every wire value of the two packages' level-2 circuits."""
    rc, j_rc = level2["rc"], level2["j_rc"]
    assert rc.circuit.degree() == j_rc.circuit.degree() == 1 << 17
    assert rc.circuit.num_gates_without_pis == j_rc.circuit.num_gates_without_pis
    assert rc.circuit.num_public_inputs == j_rc.circuit.num_public_inputs
    assert _pi_layout(rc.public_inputs) == _pi_layout(j_rc.public_inputs)
    assert len(rc.public_inputs.inner_pis) == len(level2["pis1"])
    pis = rc.circuit.get_public_inputs(level2["witness"])
    j_pis = j_rc.circuit.get_public_inputs(level2["j_witness"])
    assert [int(x) for x in pis] == [int(x) for x in j_pis]
    assert level2["witness"].wire_values == level2["j_witness"].wire_values
