"""Routing targets (reference: src/target.rs).

Targets are hashable value types: PublicInput(index), VirtualTarget(index),
Wire(gate, input).  A wire is routable iff its input index is below
NUM_ROUTED_WIRES.
"""

from __future__ import annotations

from dataclasses import dataclass

NUM_WIRES = 9
NUM_ROUTED_WIRES = 6
NUM_ADVICE_WIRES = NUM_WIRES - NUM_ROUTED_WIRES
NUM_CONSTANTS = 6
GRID_WIDTH = 65
QUOTIENT_POLYNOMIAL_DEGREE_MULTIPLIER = 7
SECURITY_BITS = 128


@dataclass(frozen=True)
class VirtualTarget:
    index: int


@dataclass(frozen=True)
class Wire:
    gate: int
    input: int

    def is_routable(self) -> bool:
        return self.input < NUM_ROUTED_WIRES


@dataclass(frozen=True)
class PublicInput:
    index: int

    def original_wire(self, offset: int) -> Wire:
        """The wire this public input is stored in (reference: target.rs:84-88)."""
        gate = offset + (self.index // NUM_WIRES) * 2
        inp = self.index % NUM_WIRES
        return Wire(gate, inp)

    def routable_target(self, offset: int) -> Wire:
        """Advice wires spill into the following BufferGate
        (reference: target.rs:90-99)."""
        w = self.original_wire(offset)
        gate, inp = w.gate, w.input
        if inp >= NUM_ROUTED_WIRES:
            gate += 1
            inp -= NUM_ROUTED_WIRES
        return Wire(gate, inp)


# Cheap integer hashes (the dataclass-generated __hash__ allocates and
# hashes a tuple per call; targets are the keys of every hot dict in the
# builder/partition/witness layers, measured ~15% of circuit build time).
# Cross-type collisions are harmless (eq still discriminates by type);
# VirtualTarget uses negative ints so it never collides with Wire.
Wire.__hash__ = lambda self: (self.gate << 4) | self.input
VirtualTarget.__hash__ = lambda self: -self.index - 1
PublicInput.__hash__ = lambda self: (self.index << 20) | 0x91F5

# A Target is any of VirtualTarget | Wire | PublicInput.
Target = object


@dataclass(frozen=True)
class BoundedTarget:
    """A target with an inclusive upper bound (reference: target.rs:63-69)."""
    target: object
    max: int
