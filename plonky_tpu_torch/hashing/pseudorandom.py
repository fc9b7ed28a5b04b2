"""PRF / PRG utilities (reference: src/pseudorandom.rs).

A Rescue-based PRF (reference: src/rescue.rs:6-20 RescuePrf) and a
PRF-chained PRG (reference: pseudorandom.rs:11-40).  Host-side: these are
tiny sequential utilities (the reference barely uses them outside tests).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.spec import FieldSpec
from .rescue import rescue_hash_n_to_1_host


@dataclass
class RescuePrf:
    """PRF(key, x) = rescue_hash([key, x]) (reference: rescue.rs:6-20)."""
    key: int = 0
    security_bits: int = 128

    def rand(self, spec: FieldSpec, x: int) -> int:
        return rescue_hash_n_to_1_host(spec, [self.key, x % spec.p],
                                       self.security_bits)


class PrfBasedPrg:
    """PRG chaining a PRF: state <- PRF(state) (reference:
    pseudorandom.rs:11-40)."""

    def __init__(self, spec: FieldSpec, prf: RescuePrf, seed: int = 0):
        self.spec = spec
        self.prf = prf
        self.state = seed % spec.p

    def next_field(self) -> int:
        f = self.prf.rand(self.spec, self.state)
        self.state = f
        return f

    def next_u32(self) -> int:
        return self.next_field() & 0xFFFFFFFF

    def next_bool(self) -> bool:
        return bool(self.next_u32() & 1)
