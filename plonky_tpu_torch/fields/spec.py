"""Field specification: the prime's constants and the tables the device
arithmetic needs.

A device field element is CANONICAL (an integer in [0, p)) and stored as
little-endian 32-bit limbs in an int32 tensor of shape
``[spec.limbs, *batch]``: 8 limbs for p < 2^255 (the Tweedle fields,
BLS12-377's scalar field), 12 for p < 2^383 (BLS12-377's base field).  The
batch axes come last so that, on the card, thread i reads limb k at
``k * N + i`` (coalesced).  The CUDA kernels read the limbs as uint32; the
plain PyTorch versions split them into 16-bit halves held in int64 so that
every partial product and column sum stays exact.

A single product (K1's field_mul) over L limbs is a 64L-bit schoolbook
product and one Barrett reduction by ``mu = floor(2^(64 L) / p)``; a
product sum (of at most MAX_TERMS terms) reduces its accumulator once, by
Barrett with ``floor(2^(32 (2L + 1)) / p)``.  Either way the result is
canonical, with no Montgomery form visible outside a kernel.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

LIMBS = 8                 # 32-bit limbs of the fields below 2^255
WIDE_LIMBS = 12           # 32-bit limbs of the fields below 2^383
LIMB_BITS = 32
MAX_TERMS = 32            # terms of one reduced product sum (< 32 p^2)

# The Barrett range of field_mul and of the product sum at each width
# (csrc/field.cuh, cc_mul_mod and cc_sum_mod): lo < p < hi, as exponents
# of two (see FieldSpec.barrett_mu and FieldSpec.sum_mu).
BARRETT_RANGE = {LIMBS: (226, 255), WIDE_LIMBS: (354, 383)}


def mu_sum_limbs(limbs: int) -> int:
    """Limbs of the product sum's Barrett factor floor(2^(32 (2L + 1)) /
    p) at L limbs (csrc/field.cuh: PT_MU_SUM_LIMBS): L + 2, as p >
    2^(32 (L - 1))."""
    return limbs + 2


def int_to_limbs(v: int, n: int = LIMBS) -> np.ndarray:
    """Little-endian 32-bit limbs of v as uint32[n]."""
    assert 0 <= v < (1 << (LIMB_BITS * n)), (v, n)
    return np.frombuffer(v.to_bytes(4 * n, "little"), dtype="<u4").copy()


def require_eight_limbs(spec: "FieldSpec", what: str) -> None:
    """Raise for a field wider than 8 limbs: `what` (the circuit build,
    the prover and the verifier) takes an 8-limb scalar field.  Every
    kernel has a 12-limb build; a 12-limb scalar field is what no curve of
    the port has (BLS12-377's is 8-limb), so these entries refuse one
    (ROADMAP B2)."""
    if spec.limbs != LIMBS:
        raise NotImplementedError(
            f"{what}: {spec.name} takes {spec.limbs} limbs; the circuit, "
            "prover and verifier take 8-limb scalar fields (ROADMAP B2)")


@dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field (the constants of the
    reference's src/field/*.rs, as canonical integers)."""

    name: str
    p: int                      # field order
    generator: int              # MULTIPLICATIVE_SUBGROUP_GENERATOR (canonical)
    alpha: int                  # smallest a with x^a a permutation
    two_adicity: int

    @property
    def bits(self) -> int:
        return self.p.bit_length()

    @property
    def limbs(self) -> int:
        """32-bit limbs of an element: 8 below 2^255, 12 below 2^383 (one
        bit of headroom, so that a + b of canonical values never carries
        out)."""
        if self.bits <= LIMB_BITS * LIMBS - 1:
            return LIMBS
        if self.bits <= LIMB_BITS * WIDE_LIMBS - 1:
            return WIDE_LIMBS
        raise ValueError(f"{self.name}: {self.bits}-bit fields are not "
                         "supported (at most 383 bits)")

    @property
    def bytes_(self) -> int:
        return -(-self.bits // 8)

    @property
    def t(self) -> int:
        """T = (p - 1) / 2^two_adicity (reference: src/field/field.rs:53)."""
        return (self.p - 1) >> self.two_adicity

    # Montgomery radix of the *reference* implementation: R = 2^(64*ceil)
    # Used only to replicate `rand_from_rng` (which fills the Montgomery
    # limbs with uniform bits; reference: src/field/tweedledee_base.rs:203).
    @property
    def ref_monty_r(self) -> int:
        n_u64 = -(-self.bits // 64)
        return pow(2, 64 * n_u64, self.p)

    # ------------------------------------------------------------------
    # Kernel constants
    # ------------------------------------------------------------------
    @functools.cached_property
    def p_inv_neg(self) -> int:
        """-p^-1 mod 2^32, the REDC multiplier (one limb at any width)."""
        return (-pow(self.p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @functools.cached_property
    def kernel_consts(self) -> np.ndarray:
        """The constant buffer the CUDA kernels take by value
        (csrc/field.cuh:field_consts_from): [p (L limbs), -p^-1 mod 2^32]
        as uint32, L = self.limbs."""
        return np.concatenate([
            int_to_limbs(self.p, self.limbs),
            np.array([self.p_inv_neg], dtype=np.uint32)])

    @property
    def mu_limbs(self) -> int:
        """Limbs of the Barrett factor floor(2^(64 L) / p): L + 1."""
        return self.limbs + 1

    @property
    def mu_sum_limbs(self) -> int:
        """Limbs of the product sum's floor(2^(32 (2L + 1)) / p): L + 2."""
        return mu_sum_limbs(self.limbs)

    def _check_barrett_range(self) -> None:
        lo, hi = BARRETT_RANGE[self.limbs]
        assert (1 << lo) < self.p < (1 << hi), (
            f"{self.name}: the one-subtraction Barrett bound at "
            f"{self.limbs} limbs needs 2^{lo} < p < 2^{hi}")

    @functools.cached_property
    def barrett_mu(self) -> int:
        """floor(2^(64 L) / p), the Barrett factor of field_mul (csrc/
        field.cuh, cc_mul_mod).  For x = a b < p^2, q1 = floor(x /
        2^(32 (L - 1))) and q3 = floor(q1 mu / 2^(32 (L + 1))) with the
        limb products of columns 0 .. L - 2 of q1 mu skipped (together
        below (L - 1) 2^-32 of a unit of q3), the truncated q1 mu /
        2^(32 (L + 1)) falls short of x / p by less than
          x / 2^(64 L) + 2^(32 (L - 1)) / p + (L - 1) 2^-32 < 1:
        at 8 limbs for 2^226 < p < 2^255 (p^2 / 2^512 < 1/4, 2^224 / p <
        1/4), at 12 limbs for 2^354 < p < 2^383 (p^2 / 2^768 < 1/4,
        2^352 / p < 1/4, 11 2^-32 < 2^-28).  So the quotient is floor(x /
        p) or one less (x / p - q3 < 2), x - q3 p < 2p < 2^(32 L), and one
        conditional subtraction suffices.  tests/test_torch_barrett.py
        models these steps limb by limb at both widths."""
        self._check_barrett_range()
        return (1 << (2 * LIMB_BITS * self.limbs)) // self.p

    @functools.cached_property
    def sum_mu(self) -> int:
        """floor(2^(32 (2L + 1)) / p), the Barrett factor of a product sum
        (csrc/field.cuh, cc_sum_mod; the plain version,
        fields/ops.py:_reduce_columns).  For a sum S < 32 p^2 (MAX_TERMS
        terms below p^2, so S < 2^(64 L + 3)), q1 = floor(S / 2^(32 (L -
        1))) and q3 = floor(q1 mu / 2^(32 (L + 2))) with the limb products
        of columns 0 .. L - 1 of q1 mu skipped (below L 2^-32 (1 + 2^-31)
        of a unit of q3), the truncated q1 mu / 2^(32 (L + 2)) falls short
        of S / p by less than
          S / 2^(32 (2L + 1)) + 2^(32 (L - 1)) / p + L 2^-32 (1 + 2^-31) < 1:
        2^-29 + 2^-2 + 2^-29 at 8 limbs, 2^-29 + 2^-2 + 2^-28 at 12, for p
        in BARRETT_RANGE at either width (asserted).  So q3 is floor(S /
        p) or one less, S - q3 p < 2p, and one conditional subtraction
        suffices.  tests/test_torch_product_sum.py models these steps limb
        by limb at both widths."""
        self._check_barrett_range()
        return (1 << (LIMB_BITS * (2 * self.limbs + 1))) // self.p

    @functools.cached_property
    def mul_consts(self) -> np.ndarray:
        """The constant buffer of K1 (csrc/field.cuh:mul_consts_from):
        kernel_consts, then the Barrett factors of a product (mu_limbs
        limbs) and of a product sum (mu_sum_limbs limbs)."""
        return np.concatenate([self.kernel_consts,
                               int_to_limbs(self.barrett_mu, self.mu_limbs),
                               int_to_limbs(self.sum_mu, self.mu_sum_limbs)])

    def __hash__(self):
        return hash((self.name, self.p))
