"""Hash-to-curve (host, setup time).

Derives the Pedersen commitment bases deterministically, byte-exactly
matching the reference:

* `blake_hash_usize_to_curve` -- BLAKE3 XOF try-and-increment
  (reference: src/hash_to_curve.rs:13-76); used by CircuitBuilder::build to
  make pedersen_g[i], pedersen_h, u (reference: src/circuit_builder.rs:1127-1129).
* `hash_base_field_to_curve` -- the slower Rescue-sponge variant
  (reference: src/hash_to_curve.rs:79-104).
"""

from __future__ import annotations

from ..curves.host import AffinePoint
from ..curves.spec import CurveSpec
from ..fields import host as fhost
from .blake3 import blake3_hash
from .rescue import rescue_sponge_host


def _field_to_le_bytes(spec, x: int) -> bytes:
    return int(x).to_bytes(spec.bytes_, "little")


def blake_field(spec, iter_: int, seed: int):
    """(x, y_neg) = H(seed, iter) via BLAKE3 XOF try-and-increment
    (reference: src/hash_to_curve.rs:13-51)."""
    byte_length = spec.bytes_
    base = bytearray(_field_to_le_bytes(spec, seed)) + bytes(2)
    base[byte_length] = iter_ & 0xFF
    j = 0
    while True:
        base[byte_length + 1] = j & 0xFF
        out = bytearray(blake3_hash(bytes(base), byte_length + 1))
        out[byte_length - 1] >>= 8 * byte_length - spec.bits
        x = int.from_bytes(bytes(out[:byte_length]), "little")
        if x < spec.p:
            y_neg = out[byte_length] & 1 == 1
            return x, y_neg
        j += 1


def blake_hash_base_field_to_curve(curve: CurveSpec, seed: int) -> AffinePoint:
    """MapToGroup: try x = H(seed, i) until x^3 + b is square
    (reference: src/hash_to_curve.rs:53-76)."""
    spec = curve.base
    i = 0
    while True:
        x, y_neg = blake_field(spec, i, seed)
        cand = (x * x % spec.p * x + curve.b) % spec.p
        y = fhost.square_root(spec, cand)
        if y is not None:
            if y_neg:
                y = (-y) % spec.p
            return AffinePoint(curve, x, y)
        i += 1


def blake_hash_usize_to_curve(curve: CurveSpec, seed: int) -> AffinePoint:
    return blake_hash_base_field_to_curve(curve, seed)


def hash_base_field_to_curve(curve: CurveSpec, seed: int,
                             security_bits: int) -> AffinePoint:
    """Rescue-sponge variant (reference: src/hash_to_curve.rs:79-104)."""
    spec = curve.base
    i = 0
    while True:
        outputs = rescue_sponge_host(spec, [seed, i], 2, security_bits)
        x = outputs[0]
        y_neg = outputs[1] & 1 == 1
        cand = (x * x % spec.p * x + curve.b) % spec.p
        y = fhost.square_root(spec, cand)
        if y is not None:
            if y_neg:
                y = (-y) % spec.p
            return AffinePoint(curve, x, y)
        i += 1


def hash_usize_to_curve(curve: CurveSpec, seed: int,
                        security_bits: int) -> AffinePoint:
    return hash_base_field_to_curve(curve, seed, security_bits)
