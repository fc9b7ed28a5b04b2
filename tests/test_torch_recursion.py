"""The port's recursion layer against the JAX package's, on the CPU.

Mirrors tests/test_recursion.py:
* (a) RecursiveChallenger gives the host Challenger's challenges, and the
  JAX package's, for the same inputs;
* (b) every gate's constraints evaluated through BuilderAlgebra (gates in a
  circuit) equal HostAlgebra's on random values;
* (c) the level-1 recursion circuits of both packages, built light from
  ONE inner proof (the circuit of tests/test_recursion.py:level1, proved by
  the port on the CPU; the JAX package reads it through proof_from_bytes
  and vk_from_bytes and proves nothing), have the same gate count, public
  input layout, exported public inputs and wire values;
* (d) the port's witness satisfies every gate and copy constraint, and its
  exports are the native transcript's values;
* (e) verify_assumptions in a level-2 circuit accepts the real exports;
* (f) verify_assumptions_native accepts them and rejects three corrupted
  ones.
Without a card, recursive_verification_circuit and the runner raise unless
given device="cpu".
"""

import numpy as np
import pytest
import torch

import plonky_tpu.circuit.builder as jbuilder_mod
import plonky_tpu.protocol.halo as jhalo_mod
import plonky_tpu.protocol.recursion as jrec
import plonky_tpu_torch.circuit.builder as builder_mod
import plonky_tpu_torch.protocol.halo as halo_mod
from plonky_tpu.circuit import PartialWitness as JPartialWitness
from plonky_tpu.curves import TWEEDLEDEE as J_DEE, TWEEDLEDUM as J_DUM
from plonky_tpu.hashing.challenger import Challenger as JChallenger
from plonky_tpu.protocol.serialization import proof_from_bytes as jax_proof_from_bytes
from plonky_tpu.protocol.serialization import vk_from_bytes as jax_vk_from_bytes
from plonky_tpu_torch import recursion_demo
from plonky_tpu_torch.circuit import CircuitBuilder, PartialWitness, Witness
from plonky_tpu_torch.circuit.algebra import BuilderAlgebra, HostAlgebra
from plonky_tpu_torch.circuit.gates import (ALL_GATES, GateCtx,
                                            evaluate_all_constraints)
from plonky_tpu_torch.circuit.target import NUM_CONSTANTS, NUM_WIRES
from plonky_tpu_torch.curves import TWEEDLEDEE, TWEEDLEDUM
from plonky_tpu_torch.hashing.challenger import Challenger, RecursiveChallenger
from plonky_tpu_torch.protocol import generate_proof, verify_proof
from plonky_tpu_torch.protocol.checks import (ConstraintViolation,
                                              check_circuit_constraints,
                                              check_copy_constraints)
from plonky_tpu_torch.protocol.recursion import (_pi_index_layout,
                                                 recursive_verification_circuit,
                                                 verify_assumptions,
                                                 verify_assumptions_native)
from plonky_tpu_torch.protocol.serialization import proof_to_bytes, vk_to_bytes
from plonky_tpu_torch.protocol.verifier import VerificationError

torch.set_num_threads(1)

SECURITY_BITS = 128
RECURSION_PI_FIELDS = ("beta", "gamma", "alpha", "zeta", "v", "u",
                       "u_scaling", "reduced_opening", "halo_b")
RECURSION_PI_LISTS = ("halo_us", "ipa_rs", "u_pows", "osr", "w_invsq",
                      "inner_pis", "old_proofs")


def pinned_source():
    """tests/test_recursion.py's pinned random source, fresh."""
    rng = np.random.default_rng(271828)
    return lambda p: int.from_bytes(rng.bytes(40), "little") % p


class Pinned:
    """RANDOM_SOURCE of the builder and halo modules set to one fresh
    pinned_source() inside the block."""

    def __init__(self, *mods):
        self.mods = mods

    def __enter__(self):
        self.saved = [m.RANDOM_SOURCE for m in self.mods]
        source = pinned_source()
        for m in self.mods:
            m.RANDOM_SOURCE = source

    def __exit__(self, *exc):
        for m, s in zip(self.mods, self.saved):
            m.RANDOM_SOURCE = s


def test_recursive_challenger_matches_native():
    """(a) reference: plonk_challenger.rs:230-277."""
    spec = TWEEDLEDEE.scalar
    inputs = [5, 7, 11, 13, 17, 19, 23]

    def host(challenger):
        challenger.observe_elements(inputs[:2])
        out = [challenger.get_challenge()]
        challenger.observe_elements(inputs[2:])
        return out + challenger.get_n_challenges(4)

    expected = host(Challenger(spec, SECURITY_BITS))
    assert expected == host(JChallenger(J_DEE.scalar, SECURITY_BITS))

    b = CircuitBuilder(TWEEDLEDEE, SECURITY_BITS)
    rc = RecursiveChallenger(b)
    in_targets = [b.constant_wire(v) for v in inputs]
    rc.observe_elements(in_targets[:2])
    got_targets = [rc.get_challenge()]
    rc.observe_elements(in_targets[2:])
    got_targets += rc.get_n_challenges(4)
    circuit = b.build(light=True, device="cpu")
    pw = circuit.generate_partial_witness(PartialWitness())
    assert [pw.get_target(t) for t in got_targets] == expected


def _targets_vs_host(evaluate, seed):
    """evaluate(alg, ctx, lc, lw, rw, bw) through BuilderAlgebra, on
    virtual targets set to random values, and through HostAlgebra on the
    same values: (circuit values, host values)."""
    spec = TWEEDLEDEE.scalar
    rng = np.random.default_rng(seed)
    sizes = (NUM_CONSTANTS, NUM_WIRES, NUM_WIRES, NUM_WIRES)
    vals = [[int.from_bytes(rng.bytes(40), "little") % spec.p
             for _ in range(k)] for k in sizes]
    ctx = GateCtx(spec, TWEEDLEDUM)
    want = evaluate(HostAlgebra(spec), ctx, *vals)

    b = CircuitBuilder(TWEEDLEDEE, SECURITY_BITS)
    targets = [b.add_virtual_targets(k) for k in sizes]
    outs = evaluate(BuilderAlgebra(b), ctx, *targets)
    circuit = b.build(light=True, device="cpu")
    inputs = PartialWitness()
    for ts, vs in zip(targets, vals):
        inputs.set_targets(ts, vs)
    pw = circuit.generate_partial_witness(inputs)
    return [pw.get_target(t) for t in outs], want


@pytest.mark.parametrize("gate", ALL_GATES, ids=lambda g: g.NAME)
def test_builder_algebra_matches_host(gate):
    """(b) Each gate's filtered constraints (its `*_recursively` form)."""
    got, want = _targets_vs_host(gate.evaluate_filtered, seed=len(gate.NAME))
    assert got == want


def test_builder_algebra_all_constraints_match_host():
    """(b) The sum over all gates that verify_assumptions re-evaluates."""
    got, want = _targets_vs_host(evaluate_all_constraints, seed=7)
    assert got == want and len(got) > 0


@pytest.fixture(scope="module")
def level1():
    """One inner proof (the port's, on the CPU) and both packages' light
    level-1 recursion circuits with their witnesses."""
    with Pinned(builder_mod, halo_mod):
        ib = CircuitBuilder(TWEEDLEDUM, SECURITY_BITS)
        t = ib.constant_wire(42)
        ib.assert_zero(ib.sub(t, ib.constant_wire(42)))
        inner_circuit = ib.build(inner_curve=TWEEDLEDEE, device="cpu")
        inner_witness = inner_circuit.generate_witness(PartialWitness())
        inner_proof = generate_proof(inner_circuit, inner_witness,
                                     old_proofs=[], blinding=True)
    inner_vk = inner_circuit.to_vk()
    verify_proof([], inner_proof, [], inner_vk, TWEEDLEDEE, verify_g=True,
                 device="cpu")
    proof_bytes = proof_to_bytes(TWEEDLEDUM, inner_proof)
    vk_bytes = vk_to_bytes(inner_vk)
    degree_pow = inner_circuit.degree_pow()

    with Pinned(builder_mod):
        rc = recursive_verification_circuit(
            TWEEDLEDEE, TWEEDLEDUM, degree_pow, SECURITY_BITS,
            num_public_inputs=0, num_old_proofs=0, inner_vk=inner_vk,
            light=True, device="cpu")
        inputs = PartialWitness()
        rc.proof.populate_witness(inputs, inner_proof, [])
        witness = rc.circuit.generate_witness(inputs)

    with Pinned(jbuilder_mod, jhalo_mod):
        j_proof = jax_proof_from_bytes(J_DUM, proof_bytes)
        j_rc = jrec.recursive_verification_circuit(
            J_DEE, J_DUM, degree_pow, SECURITY_BITS, num_public_inputs=0,
            num_old_proofs=0, inner_vk=jax_vk_from_bytes(J_DUM, vk_bytes),
            light=True)
        j_inputs = JPartialWitness()
        j_rc.proof.populate_witness(j_inputs, j_proof, [])
        j_witness = j_rc.circuit.generate_witness(j_inputs)
    return {"inner_circuit": inner_circuit, "inner_proof": inner_proof,
            "rc": rc, "witness": witness, "j_rc": j_rc, "j_witness": j_witness}


def _pi_layout(pis):
    """Every RecursionPublicInputs field as public-input indices."""
    out = {name: getattr(pis, name).index for name in RECURSION_PI_FIELDS}
    out.update({name: [t.index for t in getattr(pis, name)]
                for name in RECURSION_PI_LISTS})
    out["openings"] = [[t.index for t in s] for s in pis.openings]
    out["num_old"] = pis.num_old
    return out


def test_level1_circuit_matches_jax(level1):
    """(c) Gate count, public-input layout, exports and wire values of the
    two packages' level-1 circuits from one inner proof."""
    rc, j_rc = level1["rc"], level1["j_rc"]
    assert rc.circuit.degree() == j_rc.circuit.degree()
    assert rc.circuit.num_gates_without_pis == j_rc.circuit.num_gates_without_pis
    assert rc.circuit.num_public_inputs == j_rc.circuit.num_public_inputs
    assert _pi_layout(rc.public_inputs) == _pi_layout(j_rc.public_inputs)
    num_kappa = len(rc.public_inputs.u_pows)
    dp = level1["inner_circuit"].degree_pow()
    assert _pi_index_layout(dp, num_kappa) == jrec._pi_index_layout(dp, num_kappa)
    pis = rc.circuit.get_public_inputs(level1["witness"])
    j_pis = j_rc.circuit.get_public_inputs(level1["j_witness"])
    assert [int(x) for x in pis] == [int(x) for x in j_pis]
    assert level1["witness"].wire_values == level1["j_witness"].wire_values


def test_level1_constraints_hold(level1):
    """(d) Every row's gate constraints and every copy class hold on the
    port's witness, and the exports are the native transcript's values."""
    rc, witness, proof = level1["rc"], level1["witness"], level1["inner_proof"]
    check_circuit_constraints(rc.circuit, witness)
    check_copy_constraints(rc.circuit, witness)

    challs = proof.get_challenges(TWEEDLEDUM, [], [])
    pis = rc.circuit.get_public_inputs(witness)
    p = rc.public_inputs
    for name in ("beta", "gamma", "alpha", "zeta", "v", "u", "u_scaling"):
        assert pis[getattr(p, name).index] == getattr(challs, name)
    assert [pis[x.index] for x in p.halo_us] == challs.halo_us
    assert [pis[x.index] for x in p.o_constants] == proof.o_local.o_constants
    assert [pis[x.index] for x in p.o_plonk_t] == proof.o_local.o_plonk_t


def test_level1_checks_reject_a_changed_wire(level1):
    """(d) One routed wire of the witness changed (a wire of a copy class
    of two or more) breaks a copy class and, being a gate's input, that
    gate's constraints."""
    rc, witness = level1["rc"], level1["witness"]
    wires = rc.circuit.routing_target_partitions.to_wire_partitions()
    wire = next(part[0] for part in wires.partitions if len(part) > 1)
    rows = [list(row) for row in witness.wire_values]
    rows[wire.gate][wire.input] = (rows[wire.gate][wire.input] + 1) % \
        TWEEDLEDEE.scalar.p
    changed = Witness(rows)
    with pytest.raises(ConstraintViolation):
        check_copy_constraints(rc.circuit, changed)
    with pytest.raises(ConstraintViolation):
        check_circuit_constraints(rc.circuit, changed,
                                  rows=[wire.gate - 1, wire.gate])


def test_verify_assumptions_on_real_exports(level1):
    """(e) A level-2 circuit over Tweedledum holding only
    verify_assumptions, fed level 1's real exports, is satisfied."""
    rc, witness = level1["rc"], level1["witness"]
    pis = rc.circuit.get_public_inputs(witness)
    b2 = CircuitBuilder(TWEEDLEDUM, SECURITY_BITS)
    pi_targets = b2.add_virtual_targets(len(pis))
    verify_assumptions(b2, TWEEDLEDEE, level1["inner_circuit"].degree_pow(),
                       pi_targets, num_old_proofs=0, num_inner_pis=0)
    c2 = b2.build(inner_curve=TWEEDLEDEE, light=True, device="cpu")
    inputs = PartialWitness()
    inputs.set_targets(pi_targets, pis)
    w2 = c2.generate_witness(inputs)
    check_circuit_constraints(c2, w2)
    check_copy_constraints(c2, w2)


def test_verify_assumptions_native_accepts(level1):
    """(f) The host-native chain end accepts the real exports."""
    pis = level1["rc"].circuit.get_public_inputs(level1["witness"])
    verify_assumptions_native(pis, TWEEDLEDUM, TWEEDLEDEE,
                              level1["inner_circuit"].degree_pow())


@pytest.mark.parametrize("where", ["alpha", "opening", "last"])
def test_verify_assumptions_native_rejects(level1, where):
    """(f) One corrupted export: alpha (the quotient identity), an opening
    (a reduction), the last public input (a w_invsq: the IPA round
    check)."""
    pis = list(level1["rc"].circuit.get_public_inputs(level1["witness"]))
    idx = {"alpha": 2, "opening": 20, "last": len(pis) - 1}[where]
    pis[idx] = (pis[idx] + 1) % TWEEDLEDUM.scalar.p
    with pytest.raises(VerificationError):
        verify_assumptions_native(pis, TWEEDLEDUM, TWEEDLEDEE,
                                  level1["inner_circuit"].degree_pow())


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    """Without CUDA the recursion circuit and the runner raise by default:
    neither falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        recursive_verification_circuit(TWEEDLEDEE, TWEEDLEDUM, 3,
                                       SECURITY_BITS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        recursion_demo.main(["--inner-degree-pow", "3"])
