"""Curve specifications: short Weierstrass y^2 = x^3 + b (a = 0 for every
curve), with the Halo endomorphism constants for the recursion-capable ones.

Mirrors the reference's `Curve` / `HaloCurve` traits
(reference: src/curve/curve.rs:15-70) as data.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ..fields.spec import FieldSpec


@dataclass(frozen=True)
class CurveSpec:
    name: str
    base: FieldSpec          # coordinates live here
    scalar: FieldSpec        # the group order field
    b: int                   # curve constant (A = 0 for all instances)
    generator_affine: Tuple[int, int]
    # HaloCurve endomorphism phi(x, y) = (zeta * x, y) corresponds to scalar
    # multiplication by zeta_scalar (reference: src/curve/curve.rs:67-70).
    zeta: Optional[int] = None
    zeta_scalar: Optional[int] = None

    @property
    def is_halo(self) -> bool:
        return self.zeta is not None

    def __hash__(self):
        return hash((self.name, self.b))
