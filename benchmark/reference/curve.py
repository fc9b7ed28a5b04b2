"""Short Weierstrass curves y^2 = x^3 + b over a prime field, in affine
coordinates on Python ints (None is the point at infinity)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Curve:
    """A curve of prime order r over F_p with its published generator."""
    p: int
    b: int
    r: int
    generator: tuple

    @classmethod
    def of(cls, config: dict) -> "Curve":
        """The curve a configuration file states (hex or decimal strings)."""
        c = config["curve"]
        return cls(int(c["p"], 0), int(c["b"], 0), int(c["r"], 0),
                   (int(c["generator"][0], 0), int(c["generator"][1], 0)))

    def on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - x * x * x - self.b) % self.p == 0


def add(c: Curve, a, b):
    """a + b, complete (doubling and inverses included)."""
    if a is None:
        return b
    if b is None:
        return a
    p = c.p
    if a[0] == b[0]:
        if (a[1] + b[1]) % p == 0:
            return None
        lam = 3 * a[0] * a[0] * pow(2 * a[1], -1, p) % p
    else:
        lam = (b[1] - a[1]) * pow(b[0] - a[0], -1, p) % p
    x = (lam * lam - a[0] - b[0]) % p
    return x, (lam * (a[0] - x) - a[1]) % p


def mul(c: Curve, pt, e: int):
    """e pt by double-and-add, e taken mod r."""
    e %= c.r
    acc = None
    while e:
        if e & 1:
            acc = add(c, acc, pt)
        pt = add(c, pt, pt)
        e >>= 1
    return acc
