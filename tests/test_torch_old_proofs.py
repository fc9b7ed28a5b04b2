"""A proof that carries an old proof, in the port and in the JAX package.

Mirrors tests/test_prove_verify.py:test_proof_with_old_proofs: proof A of
the trivial circuit over Tweedledee defers its linear G check
(verify_g=False), and proof B of the same circuit consumes A's OldProof,
opening A's g polynomial at its own zeta.  Each package builds the circuit
and makes both proofs on the CPU under its own fresh
chip_smoke.pinned_random() (the builder's and the IPA's random source, for
the build and both proves).  Both proofs' bytes must be equal across the
packages, and each package's verifier must accept the other's proof B
with the G check.
"""

import pytest
import torch

import plonky_tpu.circuit.builder as jbuilder_mod
import plonky_tpu.protocol.halo as jhalo_mod
import plonky_tpu_torch.circuit.builder as builder_mod
import plonky_tpu_torch.protocol.halo as halo_mod
from chip_smoke import pinned_random
from plonky_tpu.circuit import CircuitBuilder as JCircuitBuilder
from plonky_tpu.circuit import PartialWitness as JPartialWitness
from plonky_tpu.curves import TWEEDLEDEE as J_DEE, TWEEDLEDUM as J_DUM
from plonky_tpu.curves.host import AffinePoint as JAffinePoint
from plonky_tpu.protocol import generate_proof as jax_generate_proof
from plonky_tpu.protocol import verify_proof as jax_verify_proof
from plonky_tpu.protocol.proof import OldProof as JOldProof
from plonky_tpu.protocol.serialization import proof_from_bytes as jax_proof_from_bytes
from plonky_tpu.protocol.serialization import proof_to_bytes as jax_proof_to_bytes
from plonky_tpu.protocol.serialization import vk_from_bytes as jax_vk_from_bytes
from plonky_tpu.protocol.serialization import vk_to_bytes as jax_vk_to_bytes
from plonky_tpu_torch.circuit import CircuitBuilder, PartialWitness
from plonky_tpu_torch.curves import TWEEDLEDEE, TWEEDLEDUM
from plonky_tpu_torch.curves.host import AffinePoint
from plonky_tpu_torch.protocol import generate_proof, verify_proof
from plonky_tpu_torch.protocol.proof import OldProof
from plonky_tpu_torch.protocol.serialization import (proof_from_bytes,
                                                     proof_to_bytes,
                                                     vk_from_bytes,
                                                     vk_to_bytes)

torch.set_num_threads(1)


def _two_proofs(CB, PW, dee, dum, prove, verify, to_bytes, vk_bytes, mods,
                **device):
    """Build the trivial circuit and prove it twice, the second proof
    carrying the first's OldProof, under one fresh pinned_random():
    (proof A bytes, proof B bytes, vk bytes, A's OldProof)."""
    saved = [m.RANDOM_SOURCE for m in mods]
    source = pinned_random()
    for m in mods:
        m.RANDOM_SOURCE = source
    try:
        b = CB(dee, security_bits=128)
        t = b.constant_wire(42)
        b.assert_zero(b.sub(t, b.constant_wire(42)))
        circuit = b.build(**device)
        vk = circuit.to_vk()
        witness = circuit.generate_witness(PW())
        proof_a = prove(circuit, witness, old_proofs=[], blinding=True)
        old_a = verify([], proof_a, [], vk, dum, verify_g=False, **device)
        assert old_a is not None
        assert len(old_a.halo_us) == circuit.degree_pow()
        proof_b = prove(circuit, witness, old_proofs=[old_a], blinding=True)
        assert verify([], proof_b, [old_a], vk, dum, verify_g=True,
                      **device) is None
    finally:
        for m, s in zip(mods, saved):
            m.RANDOM_SOURCE = s
    return to_bytes(dee, proof_a), to_bytes(dee, proof_b), vk_bytes(vk), old_a


@pytest.fixture(scope="module")
def both():
    port = _two_proofs(CircuitBuilder, PartialWitness, TWEEDLEDEE, TWEEDLEDUM,
                       generate_proof, verify_proof, proof_to_bytes,
                       vk_to_bytes, (builder_mod, halo_mod), device="cpu")
    jax = _two_proofs(JCircuitBuilder, JPartialWitness, J_DEE, J_DUM,
                      jax_generate_proof, jax_verify_proof, jax_proof_to_bytes,
                      jax_vk_to_bytes, (jbuilder_mod, jhalo_mod))
    return port, jax


def test_old_proof_bytes_match_jax(both):
    """Proof A, proof B (which carries A's OldProof) and the vk: the port's
    bytes are the JAX package's, and so is A's deferred OldProof."""
    (pa, pb, pvk, pold), (ja, jb, jvk, jold) = both
    assert pvk == jvk
    assert pa == ja
    assert pold.halo_us == jold.halo_us
    assert (pold.halo_g.x, pold.halo_g.y) == (jold.halo_g.x, jold.halo_g.y)
    assert pb == jb


def test_each_verifier_accepts_the_others_old_proof_proof(both):
    """The JAX verifier accepts the port's proof B and the port's verifier
    the JAX package's, each with the G check and the old proof rebuilt
    from the other package's values."""
    (_pa, pb, pvk, pold), (_ja, jb, jvk, jold) = both
    j_old = JOldProof(halo_g=JAffinePoint(J_DEE, pold.halo_g.x, pold.halo_g.y),
                      halo_us=list(pold.halo_us))
    assert jax_verify_proof([], jax_proof_from_bytes(J_DEE, pb), [j_old],
                            jax_vk_from_bytes(J_DEE, pvk), J_DUM,
                            verify_g=True) is None
    p_old = OldProof(halo_g=AffinePoint(TWEEDLEDEE, jold.halo_g.x, jold.halo_g.y),
                     halo_us=list(jold.halo_us))
    assert verify_proof([], proof_from_bytes(TWEEDLEDEE, jb), [p_old],
                        vk_from_bytes(TWEEDLEDEE, jvk), TWEEDLEDUM,
                        verify_g=True, device="cpu") is None


def test_old_proof_of_a_smaller_circuit_rides_a_larger_proof():
    """An OldProof of the trivial circuit rides a proof of the 2^5
    BufferGate circuit (as the recursion cycle's level 2 consumes the
    inner proof's): its g polynomial is padded to the larger degree, and
    the port's verifier accepts the proof with the G check."""
    from chip_smoke import buffer_circuit
    saved = (builder_mod.RANDOM_SOURCE, halo_mod.RANDOM_SOURCE)
    builder_mod.RANDOM_SOURCE = halo_mod.RANDOM_SOURCE = pinned_random()
    try:
        b = CircuitBuilder(TWEEDLEDEE, security_bits=128)
        t = b.constant_wire(42)
        b.assert_zero(b.sub(t, b.constant_wire(42)))
        small = b.build(device="cpu")
        proof_a = generate_proof(small, small.generate_witness(PartialWitness()),
                                 old_proofs=[], blinding=True)
        old_a = verify_proof([], proof_a, [], small.to_vk(), TWEEDLEDUM,
                             verify_g=False, device="cpu")
        large, inputs = buffer_circuit(5, device="cpu")
        assert large.degree() > small.degree()
        proof_b = generate_proof(large, large.generate_witness(inputs),
                                 old_proofs=[old_a], blinding=True)
    finally:
        builder_mod.RANDOM_SOURCE, halo_mod.RANDOM_SOURCE = saved
    assert len(proof_b.o_local.o_old_proofs) == 1
    assert verify_proof([], proof_b, [old_a], large.to_vk(), TWEEDLEDUM,
                        verify_g=True, device="cpu") is None
