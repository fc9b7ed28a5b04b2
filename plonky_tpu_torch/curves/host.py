"""Host-side curve arithmetic on python ints (setup, transcript, oracles).

Affine/projective point ops mirroring the reference's behavior
(reference: src/curve/curve.rs, curve_adds.rs, curve_multiplication.rs);
used for hash-to-curve setup, small verifier-side computations and as the
oracle for the batched device kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..fields import host
from .spec import CurveSpec


@dataclass(frozen=True)
class AffinePoint:
    curve: CurveSpec
    x: int
    y: int
    zero: bool = False

    def __eq__(self, other):
        if self.zero or other.zero:
            return self.zero == other.zero
        return self.x == other.x and self.y == other.y and self.curve.name == other.curve.name

    def __hash__(self):
        return hash((self.curve.name, self.x, self.y, self.zero))

    def is_valid(self) -> bool:
        if self.zero:
            return True
        p = self.curve.base.p
        return (self.y * self.y - (self.x ** 3 + self.curve.b)) % p == 0

    def endomorphism(self) -> "AffinePoint":
        """phi(x, y) = (zeta*x, y) (reference: src/curve/curve.rs:140-150)."""
        assert self.curve.zeta is not None
        p = self.curve.base.p
        return AffinePoint(self.curve, self.x * self.curve.zeta % p, self.y, self.zero)

    def neg(self) -> "AffinePoint":
        if self.zero:
            return self
        return AffinePoint(self.curve, self.x, (-self.y) % self.curve.base.p)

    def double(self) -> "AffinePoint":
        return add(self, self)

    def mul(self, scalar: int) -> "AffinePoint":
        return mul(self, scalar)


def zero_point(curve: CurveSpec) -> AffinePoint:
    return AffinePoint(curve, 0, 0, True)


def generator(curve: CurveSpec) -> AffinePoint:
    return AffinePoint(curve, *curve.generator_affine)


def add(a: AffinePoint, b: AffinePoint) -> AffinePoint:
    """Complete affine addition (host, branchy; reference: curve_adds.rs)."""
    if a.zero:
        return b
    if b.zero:
        return a
    p = a.curve.base.p
    if a.x == b.x:
        if (a.y + b.y) % p == 0:
            return zero_point(a.curve)
        # doubling
        lam = 3 * a.x * a.x % p * pow(2 * a.y % p, -1, p) % p
    else:
        lam = (b.y - a.y) % p * pow((b.x - a.x) % p, -1, p) % p
    x3 = (lam * lam - a.x - b.x) % p
    y3 = (lam * (a.x - x3) - a.y) % p
    return AffinePoint(a.curve, x3, y3)


def mul(pt: AffinePoint, scalar: int) -> AffinePoint:
    """Double-and-add (host oracle; scalar taken mod group order)."""
    scalar %= pt.curve.scalar.p
    acc = zero_point(pt.curve)
    addend = pt
    while scalar:
        if scalar & 1:
            acc = add(acc, addend)
        addend = add(addend, addend)
        scalar >>= 1
    return acc


def batch_to_affine_host(curve: CurveSpec, xs, ys, zs):
    """Projective -> affine with one batch inversion (host helper)."""
    p = curve.base.p
    nonzero = [z for z in zs if z % p != 0]
    inv_map = dict(zip([z % p for z in nonzero],
                       host.batch_inverse(curve.base, nonzero)))
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z % p == 0:
            out.append(zero_point(curve))
        else:
            zi = inv_map[z % p]
            out.append(AffinePoint(curve, x * zi % p, y * zi % p))
    return out
