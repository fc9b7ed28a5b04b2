"""Protocol utilities (reference: src/plonk_util.rs).

Host-side scalar helpers (transcript-adjacent, tiny) plus device helpers for
the bulk reductions.
"""

from __future__ import annotations

from typing import List

from ..curves import host as chost
from ..curves.spec import CurveSpec
from ..fields import host as fhost
from ..fields.spec import FieldSpec


def eval_zero_poly(spec: FieldSpec, n: int, x: int) -> int:
    """Z_H(x) = x^n - 1 (reference: plonk_util.rs:7-11)."""
    return (pow(x, n, spec.p) - 1) % spec.p


def eval_l_1(spec: FieldSpec, n: int, x: int) -> int:
    """L_1(x) = (x^n - 1) / (n (x - 1)), L_1(1) = 1 (reference: :14-24)."""
    p = spec.p
    if x % p == 1:
        return 1
    num = eval_zero_poly(spec, n, x)
    den = n % p * ((x - 1) % p) % p
    return num * pow(den, -1, p) % p


def reduce_with_powers(spec: FieldSpec, terms, alpha: int) -> int:
    """Horner fold: sum_i alpha^i terms[i] (reference: :27-33)."""
    p = spec.p
    s = 0
    for t in reversed(list(terms)):
        s = (s * alpha + t) % p
    return s


def powers(spec: FieldSpec, x: int, n: int) -> List[int]:
    out = []
    cur = 1
    for i in range(n):
        if i != 0:
            cur = cur * x % spec.p
        out.append(cur)
    return out


def halo_n(curve: CurveSpec, s_bits: List[bool]) -> int:
    """The injective endomorphism map n(x) (Halo Alg. 2 variant starting at
    (a,b)=(0,0); reference: plonk_util.rs:50-76).  s_bits little-endian,
    length = security_bits (even); processed in (lo, hi) bit pairs from the
    HIGH end first.

    PAIR-ORDER NOTE: the reference's native map processes pairs from the LOW
    end (plonk_util.rs chunks(2) over the LE bit vec) while its in-circuit
    endo walk processes them from the HIGH end
    (circuit_curve.rs:459 `.step_by(2).rev()`) -- the two encodings
    disagree, one of the reasons its recursive verification cannot pass.
    n() only needs to be a fixed injective map, so we define BOTH the native
    map and the circuit walk as HIGH-first (the circuit layout's natural
    order, which also lets the unsigned in-gate accumulator compose the
    scalar MSB-first)."""
    spec = curve.scalar  # result lives in the scalar field of `curve`
    p = spec.p
    assert len(s_bits) % 2 == 0
    a = 0
    b = 0
    for i in range(len(s_bits) - 2, -1, -2):
        bit_lo = s_bits[i]
        bit_hi = s_bits[i + 1]
        sign = 1 if bit_lo else p - 1
        c, d = (sign, 0) if bit_hi else (0, sign)
        a = (2 * a + c) % p
        b = (2 * b + d) % p
    return (a * curve.zeta_scalar + b) % p


def halo_n_mul(curve: CurveSpec, s_bits: List[bool],
               pt: chost.AffinePoint) -> chost.AffinePoint:
    """[n(s)] P via the endomorphism (Halo Alg. 1 variant; reference:
    :79-110).  Pair order HIGH-first, matching halo_n and the CurveEndoGate
    walk (see halo_n's pair-order note)."""
    assert len(s_bits) % 2 == 0
    p_p = pt
    p_n = pt.neg()
    endo_p = pt.endomorphism()
    endo_n = endo_p.neg()
    acc = chost.zero_point(curve)
    for i in range(len(s_bits) - 2, -1, -2):
        bit_lo = s_bits[i]
        bit_hi = s_bits[i + 1]
        if bit_hi:
            s = endo_p if bit_lo else endo_n
        else:
            s = p_p if bit_lo else p_n
        acc = chost.add(chost.add(acc, acc), s)
    return acc


def scalar_to_bits_le(x: int, n_bits: int) -> List[bool]:
    return [bool((x >> i) & 1) for i in range(n_bits)]


def halo_s(spec: FieldSpec, us: List[int]) -> List[int]:
    """The s vector: tensor expansion of g(X, u) coefficients
    (reference: plonk_util.rs:311-326)."""
    p = spec.p
    n = 1 << len(us)
    res = [1] * n
    us_inv = fhost.batch_inverse(spec, us)
    for j, (u, u_inv) in enumerate(zip(reversed(us), reversed(us_inv))):
        for i in range(n):
            if i & (1 << j) == 0:
                res[i] = res[i] * u_inv % p
            else:
                res[i] = res[i] * u % p
    return res


def halo_g(spec: FieldSpec, x: int, us: List[int]) -> int:
    """g(x, {u_i}) = prod_i (u_i x^(2^i) + u_i^-1) (reference: :329-339)."""
    p = spec.p
    product = 1
    x_power = x % p
    for u in reversed(us):
        u_inv = pow(u, -1, p)
        product = product * ((u * x_power + u_inv) % p) % p
        x_power = x_power * x_power % p
    return product


def try_convert(value: int, target_spec: FieldSpec) -> int:
    """Field-to-field conversion; raises if out of range
    (reference: field.rs:476-479 try_convert)."""
    if value >= target_spec.p:
        raise ValueError("Conversion between fields failed: value out of range")
    return value
