"""Host-side field arithmetic on python ints.

Used for (a) the sequential Fiat-Shamir transcript (tiny, inherently serial,
kept off-device per SURVEY.md section 7), (b) circuit construction / setup
constants, and (c) as the oracle in tests for the device kernels.

Semantics mirror the reference's `Field` trait default methods
(reference: src/field/field.rs) so that challenge derivation, square roots,
and k-th roots pick the SAME representatives as the Rust implementation.
"""

from __future__ import annotations

import functools

from .spec import FieldSpec


def exp(spec: FieldSpec, x: int, e: int) -> int:
    return pow(x, e, spec.p)


def inverse(spec: FieldSpec, x: int) -> int:
    assert x % spec.p != 0, "no inverse of zero"
    return pow(x, -1, spec.p)


def batch_inverse(spec: FieldSpec, xs):
    """Montgomery's trick (reference: src/field/field.rs:251-278)."""
    p = spec.p
    n = len(xs)
    if n == 0:
        return []
    acc = []
    cur = 1
    for x in xs:
        cur = cur * x % p
        acc.append(cur)
    inv = pow(acc[-1], -1, p)
    out = [0] * n
    for i in range(n - 1, 0, -1):
        out[i] = acc[i - 1] * inv % p
        inv = inv * xs[i] % p
    out[0] = inv
    return out


def is_quadratic_residue(spec: FieldSpec, x: int) -> bool:
    """Euler's criterion (reference: src/field/field.rs:377-392)."""
    x %= spec.p
    if x == 0:
        return True
    e = pow(x, (spec.p - 1) // 2, spec.p)
    if e == 1:
        return True
    assert e == spec.p - 1
    return False


def square_root(spec: FieldSpec, x: int):
    """Deterministic square root, or None for a non-residue.

    Ports the exact algorithm of the reference (src/field/field.rs:440-473,
    itself from zexe) so the SAME root of the two is returned -- this matters
    for bit-exact proofs (the IPA challenges are square roots).
    """
    p = spec.p
    x %= p
    if x == 0:
        return 0
    if not is_quadratic_residue(spec, x):
        return None
    T = spec.t
    z = pow(spec.generator, T, p)
    w = pow(x, (T - 1) // 2, p)
    xx = w * x % p
    b = xx * w % p
    v = spec.two_adicity
    while b != 1:
        k = 0
        b2k = b
        while b2k != 1:
            b2k = b2k * b2k % p
            k += 1
        j = v - k - 1
        w = z
        for _ in range(j):
            w = w * w % p
        z = w * w % p
        b = b * z % p
        xx = xx * w % p
        v = k
    return xx


@functools.lru_cache(maxsize=None)
def kth_root_exponent(spec: FieldSpec, k: int) -> int:
    """Same search as the reference (src/field/field.rs:346-375)."""
    p = spec.p
    p_minus_1 = p - 1
    numerator = p
    n = 0
    while n < k:
        n += 1
        numerator += p_minus_1
        if numerator % k == 0:
            return (numerator // k) % p_minus_1
    raise ValueError(f"x^{k} is not a permutation mod {p}")


def kth_root(spec: FieldSpec, x: int, k: int) -> int:
    return pow(x, kth_root_exponent(spec, k), spec.p)


def primitive_root_of_unity(spec: FieldSpec, n_power: int) -> int:
    """2^n_power-th primitive root (reference: src/field/field.rs:429-435)."""
    assert n_power <= spec.two_adicity
    base = pow(spec.generator, spec.t, spec.p)
    return pow(base, 1 << (spec.two_adicity - n_power), spec.p)


def cyclic_subgroup_known_order(spec: FieldSpec, generator: int, order: int):
    out = []
    cur = 1
    for _ in range(order):
        out.append(cur)
        cur = cur * generator % spec.p
    return out


def num_bits(x: int) -> int:
    return x.bit_length()


def rand_from_rng(spec: FieldSpec, rng) -> int:
    """Replicates the reference's `rand_from_rng`: uniformly sample the
    MONTGOMERY limbs below ORDER (reference: src/field/tweedledee_base.rs:203,
    src/bigint/bigint_arithmetic.rs:98-117 `rand_range_from_rng`), so the
    canonical value is sample * R^{-1} mod p.
    """
    n_u64 = -(-spec.bits // 64)
    sample = rand_range_from_rng(spec.p, n_u64, rng)
    r_inv = pow(spec.ref_monty_r, -1, spec.p)
    return sample * r_inv % spec.p


def rand_range_from_rng(limit: int, n_u64: int, rng) -> int:
    """Reference rand_range_from_rng: draw n_u64 u64s, strip the top limb's
    leading zero bits, retry until < limit."""
    top_limb = limit >> (64 * (n_u64 - 1))
    bits_to_strip = 64 - top_limb.bit_length() if top_limb else 64
    while True:
        limbs = [rng.next_u64() for _ in range(n_u64)]
        limbs[n_u64 - 1] >>= bits_to_strip
        v = 0
        for i, l in enumerate(limbs):
            v |= l << (64 * i)
        if v < limit:
            return v


def canonical_square_root(spec: FieldSpec, x: int):
    """The EVEN square root (or None for a non-residue).

    The IPA challenges u_j = sqrt(n(r_j)) must use one canonical root at
    every site (prover, verifier replay, recursion witness), and the
    in-circuit decomposition check pins parity 0 (builder
    deterministic_square_root, reference circuit_builder.rs:474-566), so the
    even root is the protocol-wide choice."""
    s = square_root(spec, x)
    if s is None:
        return None
    return s if s % 2 == 0 else spec.p - s
