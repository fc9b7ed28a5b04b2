"""Host-side circuit constraint checking.

`check_circuit_constraints(circuit, witness)` evaluates every gate's
filtered constraints on every row of a dense witness (python ints) and
raises on the first violation.  This is the debugging / testing counterpart
of the prover's batched 8n-point vanishing evaluation: satisfaction here is
exactly "the vanishing polynomial vanishes on H", so a witness that passes
will (with the same public inputs) yield a valid proof.

The reference has no such checker -- constraint bugs there surface only as
opaque proof-verification failures (or not at all, since witness values can
silently satisfy copies while violating gate equations).
"""

from __future__ import annotations

from typing import Optional

from ..circuit.algebra import HostAlgebra
from ..circuit.gates import ALL_GATES
from ..circuit.target import GRID_WIDTH


class ConstraintViolation(Exception):
    pass


def _gate_type_of_row(constants) -> Optional[type]:
    """Identify the gate type from the prefix bits packed in the constants
    (the prefix tree is prefix-free, so at most one gate matches)."""
    for g in ALL_GATES:
        if all(constants[i] == (1 if b else 0)
               for i, b in enumerate(g.PREFIX)):
            return g
    return None


def check_circuit_constraints(circuit, witness, rows=None):
    """Check every row's own gate constraints (the prefix tree guarantees
    all other gates' filters vanish on the row).  `rows`: optional iterable
    of row indices to restrict to."""
    spec = circuit.spec
    alg = HostAlgebra(spec)
    ctx = circuit.ctx
    n = circuit.degree()
    wv = witness.wire_values
    constants = circuit.gate_constants
    row_iter = range(n) if rows is None else rows
    for i in row_iter:
        g = _gate_type_of_row(constants[i])
        if g is None:
            raise ConstraintViolation(
                f"row {i}: constants {constants[i]} match no gate prefix")
        lw = wv[i]
        rw = wv[(i + 1) % n]
        bw = wv[(i + GRID_WIDTH) % n]
        cs = g.constraints(alg, ctx, constants[i], lw, rw, bw)
        for k, c in enumerate(cs):
            if c % spec.p != 0:
                raise ConstraintViolation(
                    f"row {i} ({g.NAME}): constraint {k} = {c} != 0")


def check_copy_constraints(circuit, witness):
    """Verify the sigma-partition copy classes are value-consistent: every
    wire of a class holds the value of its first wire (one pass over each
    class)."""
    parts = circuit.routing_target_partitions.to_wire_partitions().partitions
    for part in parts:
        if not part:
            continue
        v = witness.get(part[0])
        for s in part[1:]:
            if witness.get(s) != v:
                raise ConstraintViolation(
                    f"copy class of {part[0]} has differing values at {s}")
