"""End-to-end recursion run of the port (reference: src/bin/recursion.rs).

Flow: build an inner circuit over Tweedledum -> prove it -> verify it
natively -> build the recursion circuit over Tweedledee (the verifier in a
circuit, with the real inner vk wired in) -> generate its witness -> check
its constraints on the host -> prove it -> verify that proof natively.
With --levels 2, a level-2 circuit over Tweedledum verifies the level-1
proof, re-checks everything level 1 deferred (verify_assumptions) and its
proof consumes the inner proof's OldProof; the chain ends with
verify_assumptions_native on the level-2 proof's public inputs.

Prints each phase and its seconds, and each recursion circuit's gate count.

    python -m plonky_tpu_torch.recursion_demo [--inner-degree-pow N]
        [--levels 1|2] [--check-only] [--device cuda|cpu]

--check-only stops after the host constraint checks (no recursive proof).
The device is the card unless --device cpu is given; without a card the
default raises.
"""

from __future__ import annotations

import argparse
import time

import torch

from .circuit import CircuitBuilder, PartialWitness
from .circuit.gates import BufferGate
from .curves import TWEEDLEDEE, TWEEDLEDUM
from .device import resolve
from .protocol import generate_proof, verify_proof
from .protocol.checks import check_circuit_constraints, check_copy_constraints
from .protocol.recursion import (recursive_verification_circuit,
                                 verify_assumptions, verify_assumptions_native)


def buffer_inner_circuit(degree_pow: int, device):
    """The reference's inner circuit: BufferGates over Tweedledum padded to
    2^degree_pow gates."""
    builder = CircuitBuilder(TWEEDLEDUM, security_bits=128)
    while builder.num_gates() < (1 << degree_pow) - 3:
        builder.add_gate_no_constants(BufferGate(builder.num_gates()))
    return builder.build(inner_curve=TWEEDLEDEE, device=device)


def gate_count(circuit) -> str:
    return (f"  gate count: {circuit.degree()} (2^{circuit.degree_pow()}; "
            f"{circuit.num_gates_without_pis} gates before the public inputs)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inner-degree-pow", type=int, default=8)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--levels", type=int, default=1, choices=(1, 2),
                    help="2 = full cycle: a level-2 circuit over the partner "
                    "curve verifies the level-1 proof (verify_assumptions "
                    "re-checks everything level 1 deferred) while consuming "
                    "the inner proof's OldProof")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    def phase(name):
        print(f"{name}...", flush=True)
        return time.perf_counter()

    def done(t0):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        print(f"  finished in {time.perf_counter() - t0:.2f}s", flush=True)

    def check(circuit, witness):
        check_circuit_constraints(circuit, witness)
        check_copy_constraints(circuit, witness)

    t0 = phase("Generating inner circuit")
    inner_circuit = buffer_inner_circuit(args.inner_degree_pow, dev)
    done(t0)

    t0 = phase("Generating inner witness")
    inner_witness = inner_circuit.generate_witness(PartialWitness())
    done(t0)

    t0 = phase("Generating inner proof")
    inner_proof = generate_proof(inner_circuit, inner_witness,
                                 old_proofs=[], blinding=True)
    done(t0)

    t0 = phase("Verifying inner proof")
    inner_vk = inner_circuit.to_vk()
    # The inner proof's deferred G check is an OldProof over Tweedledum: at
    # --levels 2 the level-2 proof (over Tweedledum) consumes it; at
    # --levels 1 the linear G check is paid here.
    old0 = verify_proof([], inner_proof, [], inner_vk, TWEEDLEDEE,
                        verify_g=(args.levels == 1), device=dev)
    done(t0)

    t0 = phase("Generating recursion circuit")
    rc = recursive_verification_circuit(
        TWEEDLEDEE, TWEEDLEDUM, inner_circuit.degree_pow(),
        security_bits=128, num_public_inputs=0, num_old_proofs=0,
        inner_vk=inner_vk, light=args.check_only, device=dev)
    done(t0)
    print(gate_count(rc.circuit))

    t0 = phase("Generating recursion witness")
    inputs = PartialWitness()
    rc.proof.populate_witness(inputs, inner_proof, [])
    recursion_witness = rc.circuit.generate_witness(inputs)
    done(t0)

    t0 = phase("Checking recursion circuit constraints (host)")
    check(rc.circuit, recursion_witness)
    done(t0)

    pis1 = rc.circuit.get_public_inputs(recursion_witness)
    inner_recursion = {
        "degree_pow": inner_circuit.degree_pow(),
        "num_old_proofs": 0,
        "num_inner_pis": 0,
        "num_gates_without_pis": inner_vk.num_gates_without_pis,
    }

    if args.check_only:
        if args.levels == 2:
            # The level-2 deferred checks alone: a circuit holding only
            # verify_assumptions, fed level 1's exported public inputs.
            t0 = phase("Checking level-2 verify_assumptions (host)")
            b2 = CircuitBuilder(TWEEDLEDUM, security_bits=128)
            pi_targets = b2.add_virtual_targets(len(pis1))
            verify_assumptions(b2, TWEEDLEDEE, inner_circuit.degree_pow(),
                               pi_targets,
                               num_gates_without_pis=(
                                   inner_vk.num_gates_without_pis))
            c2 = b2.build(inner_curve=TWEEDLEDEE, light=True, device=dev)
            inputs2 = PartialWitness()
            inputs2.set_targets(pi_targets, pis1)
            check(c2, c2.generate_witness(inputs2))
            done(t0)
        print("check-only: all recursion constraints satisfied; skipping "
              "recursive proof generation")
        return

    t0 = phase("Generating level-1 recursion proof")
    recursion_proof = generate_proof(rc.circuit, recursion_witness,
                                     old_proofs=[], blinding=True)
    done(t0)

    t0 = phase("Verifying level-1 recursion proof")
    print(f"  number of public inputs: {rc.circuit.num_public_inputs}")
    vk1 = rc.circuit.to_vk()
    # At --levels 2 the level-1 proof's G check would ride a level-3 proof;
    # it is closed natively at the end instead.
    verify_proof(pis1, recursion_proof, [], vk1, TWEEDLEDUM,
                 verify_g=(args.levels == 1), device=dev)
    done(t0)
    print("Level-1 recursive proof verified.")

    if args.levels == 1:
        return

    t0 = phase("Generating level-2 recursion circuit")
    rc2 = recursive_verification_circuit(
        TWEEDLEDUM, TWEEDLEDEE, rc.circuit.degree_pow(),
        security_bits=128, num_public_inputs=len(pis1), num_old_proofs=0,
        inner_vk=vk1, inner_recursion=inner_recursion, device=dev)
    done(t0)
    print(gate_count(rc2.circuit))

    t0 = phase("Generating level-2 recursion witness")
    inputs2 = PartialWitness()
    rc2.proof.populate_witness(inputs2, recursion_proof, pis1)
    w2 = rc2.circuit.generate_witness(inputs2)
    done(t0)

    t0 = phase("Checking level-2 circuit constraints (host)")
    check(rc2.circuit, w2)
    done(t0)

    t0 = phase("Generating level-2 recursion proof (consuming inner OldProof)")
    proof2 = generate_proof(rc2.circuit, w2, old_proofs=[old0],
                            blinding=True)
    done(t0)

    t0 = phase("Verifying level-2 recursion proof")
    pis2 = rc2.circuit.get_public_inputs(w2)
    verify_proof(pis2, proof2, [old0], rc2.circuit.to_vk(), TWEEDLEDEE,
                 verify_g=True, device=dev)
    done(t0)

    t0 = phase("Closing the level-1 OldProof natively (final G check)")
    verify_proof(pis1, recursion_proof, [], vk1, TWEEDLEDUM, verify_g=True,
                 device=dev)
    done(t0)

    t0 = phase("Terminating the chain natively (verify_assumptions_native)")
    verify_assumptions_native(
        pis2, TWEEDLEDEE, TWEEDLEDUM, rc.circuit.degree_pow(),
        num_inner_pis=len(pis1),
        num_gates_without_pis=vk1.num_gates_without_pis)
    done(t0)
    print("Level-2 recursive proof verified; full cycle closed.")


if __name__ == "__main__":
    main()
