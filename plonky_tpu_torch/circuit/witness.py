"""Witness containers (reference: src/witness.rs).

`PartialWitness` is a sparse Target -> int map used during witness
generation (host side, data-dependent); `Witness` is the dense
[n_gates][NUM_WIRES] matrix handed to the prover.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .target import (
    NUM_ADVICE_WIRES,
    NUM_ROUTED_WIRES,
    NUM_WIRES,
    PublicInput,
    Wire,
)


class PartialWitness:
    def __init__(self):
        self.wire_values: Dict[object, int] = {}

    def is_empty(self) -> bool:
        return not self.wire_values

    def contains_target(self, target) -> bool:
        return target in self.wire_values

    def contains_wire(self, wire: Wire) -> bool:
        return wire in self.wire_values

    def contains_all_targets(self, targets) -> bool:
        return all(t in self.wire_values for t in targets)

    def all_populated_targets(self):
        return list(self.wire_values.keys())

    def get_target(self, target) -> int:
        return self.wire_values[target]

    def get_targets(self, targets):
        return [self.wire_values[t] for t in targets]

    def get_wire(self, wire: Wire) -> int:
        return self.wire_values[wire]

    def get_point_target(self, point_target):
        from ..curves.host import AffinePoint
        x = self.get_target(point_target.x)
        y = self.get_target(point_target.y)
        return AffinePoint(point_target.curve, x, y)

    def set_target(self, target, value: int):
        old = self.wire_values.get(target)
        if old is not None:
            assert old == value, f"Target {target} set twice with different values"
        self.wire_values[target] = value

    def set_targets(self, targets, values):
        assert len(targets) == len(values)
        for t, v in zip(targets, values):
            self.set_target(t, v)

    def set_wire(self, wire: Wire, value: int):
        self.set_target(wire, value)

    def set_point_target(self, point_target, point):
        self.set_target(point_target.x, point.x)
        self.set_target(point_target.y, point.y)

    def extend(self, other: "PartialWitness"):
        for t, v in other.wire_values.items():
            self.set_target(t, v)

    def replace_public_inputs(self, offset: int):
        """PublicInput targets -> their storage wires (reference: witness.rs:180-191)."""
        new_items = []
        for t, v in self.wire_values.items():
            if isinstance(t, PublicInput):
                new_items.append((t.original_wire(offset), v))
        self.wire_values = {t: v for t, v in self.wire_values.items()
                            if not isinstance(t, PublicInput)}
        for t, v in new_items:
            self.wire_values[t] = v

    def copy_buffer_to_pi_gate(self, offset: int):
        """Copy PI-buffer wires back into the PI gate's advice wires
        (reference: witness.rs:196-206)."""
        new_items = []
        for t, v in self.wire_values.items():
            if isinstance(t, Wire) and t.gate > offset and \
                    (t.gate - offset) % 2 == 1 and t.input < NUM_ADVICE_WIRES:
                new_items.append((Wire(t.gate - 1, NUM_ROUTED_WIRES + t.input), v))
        for t, v in new_items:
            self.wire_values[t] = v


class Witness:
    """Dense wire-value matrix [n_gates][NUM_WIRES] of python ints."""

    def __init__(self, wire_values: List[List[int]]):
        self.wire_values = wire_values

    def get(self, wire: Wire) -> int:
        return self.wire_values[wire.gate][wire.input]

    def get_indices(self, i: int, j: int) -> int:
        return self.wire_values[i][j]

    def transpose(self):
        return [list(col) for col in zip(*self.wire_values)]

    @staticmethod
    def from_partial(pw: PartialWitness, degree: int) -> "Witness":
        rows = []
        for i in range(degree):
            row = []
            for j in range(NUM_WIRES):
                w = Wire(i, j)
                row.append(pw.wire_values.get(w, 0))
            rows.append(row)
        return Witness(rows)


class WitnessGenerator:
    """Base interface (reference: witness.rs:253-258)."""

    def dependencies(self):
        raise NotImplementedError

    def generate(self, constants, witness: PartialWitness) -> PartialWitness:
        raise NotImplementedError


class LambdaGenerator(WitnessGenerator):
    def __init__(self, deps, fn):
        self._deps = list(deps)
        self._fn = fn

    def dependencies(self):
        return self._deps

    def generate(self, constants, witness):
        return self._fn(constants, witness)
