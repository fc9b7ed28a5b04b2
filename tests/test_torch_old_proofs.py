"""A proof that carries an old proof, in the port and in the JAX package.

Mirrors tests/test_prove_verify.py:test_proof_with_old_proofs: proof A of
the trivial circuit over Tweedledee defers its linear G check
(verify_g=False), and proof B of the same circuit consumes A's OldProof,
opening A's g polynomial at its own zeta.  Each package builds the circuit
and makes both proofs on the CPU under its own fresh
chip_smoke.pinned_random() (the builder's and the IPA's random source, for
the build and both proves).  Both proofs' bytes must be equal across the
packages, and each package's verifier must accept the other's proof B
with the G check.  The JAX package's proofs are read from
tests/fixtures/jax_proofs.json; a slow test makes them again and runs the
JAX verifier.
"""

import pytest
import torch

import _jax_fixtures as jaxfx
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
def port():
    return _two_proofs(CircuitBuilder, PartialWitness, TWEEDLEDEE, TWEEDLEDUM,
                       generate_proof, verify_proof, proof_to_bytes,
                       vk_to_bytes, (builder_mod, halo_mod), device="cpu")


def _jax_two_proofs():
    return _two_proofs(JCircuitBuilder, JPartialWitness, J_DEE, J_DUM,
                       jax_generate_proof, jax_verify_proof, jax_proof_to_bytes,
                       jax_vk_to_bytes, (jbuilder_mod, jhalo_mod))


def _record(proofs) -> dict:
    """Proof A, proof B and the vk in hex, and A's OldProof, as JSON."""
    a, b, vk, old = proofs
    return {"proof_a": a.hex(), "proof_b": b.hex(), "vk": vk.hex(),
            "halo_us": [hex(u) for u in old.halo_us],
            "halo_g": [hex(old.halo_g.x), hex(old.halo_g.y)]}


def test_old_proof_bytes_match_jax(port):
    """Proof A, proof B (which carries A's OldProof) and the vk: the port's
    bytes are the JAX package's, and so is A's deferred OldProof (the JAX
    package's, tests/fixtures/jax_proofs.json, made by
    test_jax_old_proofs_fixture)."""
    assert _record(port) == jaxfx.load("proofs", "old proofs")


def test_each_verifier_accepts_the_others_old_proof_proof(port):
    """The port's verifier accepts the JAX package's proof B with the G
    check and the old proof rebuilt from the JAX package's values; the
    JAX verifier's acceptance of the port's proof B (whose bytes are the
    JAX package's) is test_jax_old_proofs_fixture's."""
    want = jaxfx.load("proofs", "old proofs")
    gx, gy = (int(v, 16) for v in want["halo_g"])
    p_old = OldProof(halo_g=AffinePoint(TWEEDLEDEE, gx, gy),
                     halo_us=[int(u, 16) for u in want["halo_us"]])
    assert verify_proof([], proof_from_bytes(TWEEDLEDEE, bytes.fromhex(want["proof_b"])),
                        [p_old], vk_from_bytes(TWEEDLEDEE, bytes.fromhex(want["vk"])),
                        TWEEDLEDUM, verify_g=True, device="cpu") is None
    assert port[1].hex() == want["proof_b"]


@pytest.mark.slow
def test_jax_old_proofs_fixture():
    """The JAX package's two proofs, vk and OldProof that the tests above
    read, made again, and the JAX verifier's acceptance of proof B (the
    port's bytes) with the G check and the old proof rebuilt from its
    values."""
    jax_proofs = _jax_two_proofs()
    rec = _record(jax_proofs)
    jaxfx.check("proofs", "old proofs", rec)
    jold = jax_proofs[3]
    j_old = JOldProof(halo_g=JAffinePoint(J_DEE, jold.halo_g.x, jold.halo_g.y),
                      halo_us=list(jold.halo_us))
    assert jax_verify_proof([], jax_proof_from_bytes(J_DEE, bytes.fromhex(rec["proof_b"])),
                            [j_old], jax_vk_from_bytes(J_DEE, bytes.fromhex(rec["vk"])),
                            J_DUM, verify_g=True) is None


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
