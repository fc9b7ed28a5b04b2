"""The port's proof bytes against the JAX package's above degree 8.

The BufferGate circuit of chip_smoke.py:buffer_circuit (bench.py's prover
workload) is built and proved on the CPU in both packages, each with a
fresh random source pinned as tests/test_proof_fixture.py pins it
(np.random.default_rng(1337), for the build and the prove).  The proof and
vk bytes must be equal, and the JAX package's verifier must accept the
port's proof with the G check.  Rungs: 2^5 in the fast tier, against the
JAX package's bytes kept in tests/fixtures/jax_proofs.json (a slow test
makes them again and runs the JAX verifier on them); 2^9 and 2^10
slow-marked (each proves for minutes on the CPU in either package).  The
2^10 rung's proof also hashes to chip_smoke.PROOF_2E10_SHA256, the value
chip_smoke.py asserts for the card's proof.  The slow 2^14 test reproduces chip_smoke.py's phase_prove
sequence in the JAX package (build, first prove, steady prove, one pinned
source) and holds the steady proof's sha256 against PROOF_2E14_SHA256.
"""

import hashlib

import pytest
import torch

import _jax_fixtures as jaxfx
import plonky_tpu.circuit.builder as jbuilder_mod
import plonky_tpu.protocol.halo as jhalo_mod
from chip_smoke import (PROOF_2E10_SHA256, PROOF_2E14_SHA256, buffer_circuit,
                        pinned_proof, pinned_random)
from plonky_tpu.circuit import CircuitBuilder as JCircuitBuilder
from plonky_tpu.circuit import PartialWitness as JPartialWitness
from plonky_tpu.circuit.gates import BufferGate as JBufferGate
from plonky_tpu.curves import TWEEDLEDEE as J_DEE, TWEEDLEDUM as J_DUM
from plonky_tpu.protocol import generate_proof as jax_generate_proof
from plonky_tpu.protocol import verify_proof as jax_verify_proof
from plonky_tpu.protocol.serialization import proof_from_bytes as jax_proof_from_bytes
from plonky_tpu.protocol.serialization import proof_to_bytes as jax_proof_to_bytes
from plonky_tpu.protocol.serialization import vk_from_bytes as jax_vk_from_bytes
from plonky_tpu.protocol.serialization import vk_to_bytes as jax_vk_to_bytes
from plonky_tpu_torch.protocol.serialization import vk_to_bytes

torch.set_num_threads(1)


def jax_buffer_proof(lg: int, proves: int = 1):
    """The JAX package's proof of the 2^lg BufferGate circuit on the CPU:
    (proof bytes of the last of `proves` proves, vk bytes, public inputs),
    one pinned source for the build and every prove."""
    saved = (jbuilder_mod.RANDOM_SOURCE, jhalo_mod.RANDOM_SOURCE)
    jbuilder_mod.RANDOM_SOURCE = jhalo_mod.RANDOM_SOURCE = pinned_random()
    try:
        builder = JCircuitBuilder(J_DEE, security_bits=128)
        while builder.num_gates() < (1 << lg) - 3:
            builder.add_gate_no_constants(JBufferGate(builder.num_gates()))
        circuit = builder.build()
        witness = circuit.generate_witness(JPartialWitness())
        for _ in range(proves):
            proof = jax_generate_proof(circuit, witness, old_proofs=[],
                                       blinding=True)
    finally:
        jbuilder_mod.RANDOM_SOURCE, jhalo_mod.RANDOM_SOURCE = saved
    return (jax_proof_to_bytes(J_DEE, proof), jax_vk_to_bytes(circuit.to_vk()),
            circuit.get_public_inputs(witness))


def port_buffer_proof(lg: int):
    """The port's proof of the same circuit on the CPU, pinned the same
    way and verified by the port's verifier with the G check: (proof
    bytes, vk bytes)."""
    got = pinned_proof(lambda: buffer_circuit(lg, device="cpu"),
                       pinned_random(), device="cpu")
    return got["bytes"], vk_to_bytes(got["circuit"].to_vk())


def _check_rung(lg: int):
    proof_bytes, vk_bytes = port_buffer_proof(lg)
    want_proof, want_vk, pis = jax_buffer_proof(lg)
    assert proof_bytes == want_proof
    assert vk_bytes == want_vk
    vk = jax_vk_from_bytes(J_DEE, vk_bytes)
    assert jax_verify_proof(pis, jax_proof_from_bytes(J_DEE, proof_bytes), [],
                            vk, J_DUM, verify_g=True) is None
    return hashlib.sha256(want_proof).hexdigest()


def test_ladder_2e5_bytes_match_jax():
    """The rung above the fixtures' degree 8 that fits the fast tier: 32
    gates, five IPA rounds against the fixtures' three.  The port's proof
    and vk bytes equal the JAX package's (tests/fixtures/jax_proofs.json,
    made, and its proof accepted by the JAX verifier with the G check, by
    test_jax_ladder_2e5_fixture)."""
    proof_bytes, vk_bytes = port_buffer_proof(5)
    want = jaxfx.load("proofs", "buffer 2^5")
    assert proof_bytes.hex() == want["proof"]
    assert vk_bytes.hex() == want["vk"]


@pytest.mark.slow
def test_jax_ladder_2e5_fixture():
    """The JAX package's 2^5 proof and vk that test_ladder_2e5_bytes_match_jax
    reads, made again, and the JAX verifier's acceptance of that proof
    with the G check (~6 min on one CPU process, the compiles)."""
    proof_bytes, vk_bytes, pis = jax_buffer_proof(5)
    jaxfx.check("proofs", "buffer 2^5", {"proof": proof_bytes.hex(), "vk": vk_bytes.hex()})
    assert jax_verify_proof(pis, jax_proof_from_bytes(J_DEE, proof_bytes), [],
                            jax_vk_from_bytes(J_DEE, vk_bytes), J_DUM,
                            verify_g=True) is None


@pytest.mark.slow
def test_ladder_2e9_bytes_match_jax():
    _check_rung(9)


@pytest.mark.slow
def test_ladder_2e10_bytes_match_jax():
    """Degree 2^10: the port's bytes are the JAX package's, the JAX verifier
    accepts the port's proof, and the JAX proof's sha256 is the one
    chip_smoke.py asserts on the card."""
    assert _check_rung(10) == PROOF_2E10_SHA256


@pytest.mark.slow
def test_jax_steady_2e14_proof_is_the_pinned_sha256():
    """chip_smoke.py:phase_prove's pinned sequence in the JAX package on the
    CPU: its steady proof's sha256 must be PROOF_2E14_SHA256, the hash the
    port's proof on the card is held to."""
    proof_bytes, _vk, _pis = jax_buffer_proof(14, proves=2)
    assert hashlib.sha256(proof_bytes).hexdigest() == PROOF_2E14_SHA256
