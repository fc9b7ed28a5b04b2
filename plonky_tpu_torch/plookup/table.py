"""Lookup tables (reference: plookup/src/table.rs): width-N tables built
from functions over domains, reduced to vectors with a table-derived
challenge before proving."""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, List, Sequence

from ..curves.spec import CurveSpec
from ..hashing.challenger import Challenger
from .plookup import SECURITY_BITS, prove, verify


@dataclass
class Table:
    """rows: list of equal-width tuples of field elements (python ints)."""
    rows: List[tuple]
    spec: object  # FieldSpec the entries live in

    @staticmethod
    def from_function(spec, f: Callable, domain: Sequence[tuple]) -> "Table":
        return Table([(*a, f(*a)) for a in domain], spec)

    @staticmethod
    def from_function_cartesian(spec, f: Callable, domain: Sequence[int],
                                arity: int) -> "Table":
        rows = [(*a, f(*a))
                for a in itertools.product(domain, repeat=arity)]
        return Table(rows, spec)

    def get_challenge(self) -> int:
        """Table-derived reduction challenge (reference: table.rs:54-61).
        NOTE: the sponge runs over the table's own field."""
        ch = Challenger(self.spec, SECURITY_BITS)
        for row in self.rows:
            ch.observe_elements(row)
        return ch.get_challenge()

    def to_vec(self) -> List[int]:
        return self.reduce_with([])[0]

    def reduce_with(self, witness_rows: List[tuple]):
        alpha = self.get_challenge()
        p = self.spec.p

        def red(rows):
            return [_fold(alpha, row, p) for row in rows]
        return red(self.rows), red(witness_rows)

    def prove_row(self, curve: CurveSpec, witness_rows: List[tuple],
                  device=None):
        """Prove that each witness row appears in the table
        (reference: table.rs:105-109)."""
        t_vec, f_vec = self.reduce_with(witness_rows)
        return prove(curve, f_vec, t_vec, device=device)

    def prove_column(self, curve: CurveSpec, columns: List[List[int]],
                     device=None):
        """Column-major witness variant (reference: table.rs:111-118)."""
        h = len(columns[0])
        rows = [tuple(col[i] for col in columns) for i in range(h)]
        return self.prove_row(curve, rows, device=device)

    def verify(self, curve: CurveSpec, proof, device=None):
        """reference: table.rs:120-123."""
        verify(curve, self.to_vec(), proof, device=device)


def _fold(alpha, row, p):
    acc = 0
    for x in row:
        acc = (alpha * acc + x) % p
    return acc
