"""Field specification: the prime's constants and the tables the device
arithmetic needs.

A device field element is CANONICAL (an integer in [0, p)) and stored as
little-endian 32-bit limbs in an int32 tensor of shape ``[LIMBS, *batch]``.
The batch axes come last so that, on the card, thread i reads limb k at
``k * N + i`` (coalesced).  The CUDA kernels read the limbs as uint32; the
plain PyTorch versions split them into 16-bit halves held in int64 so that
every partial product and column sum stays exact.

A single product (K1's field_mul) is a 512-bit schoolbook product and one
Barrett reduction by ``mu = floor(2^512 / p)``; a product sum (of at most
MAX_TERMS terms, below 2^515) reduces its 17-limb accumulator once, by
Barrett with ``floor(2^544 / p)``.  Either way the result is canonical,
with no Montgomery form visible outside a kernel.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

LIMBS = 8                 # 32-bit limbs per element (fields below 2^255)
LIMB_BITS = 32
MAX_TERMS = 32            # terms of one reduced product sum (< 32 p^2 < 2^515)
MU_LIMBS = 9              # limbs of the Barrett factor floor(2^512 / p)
MU_SUM_LIMBS = 10         # limbs of the product sum's floor(2^544 / p)


def int_to_limbs(v: int, n: int = LIMBS) -> np.ndarray:
    """Little-endian 32-bit limbs of v as uint32[n]."""
    assert 0 <= v < (1 << (LIMB_BITS * n)), (v, n)
    return np.frombuffer(v.to_bytes(4 * n, "little"), dtype="<u4").copy()


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
        """-p^-1 mod 2^32, the REDC multiplier."""
        return (-pow(self.p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @functools.cached_property
    def kernel_consts(self) -> np.ndarray:
        """The constant buffer the CUDA kernels take by value
        (csrc/field.cuh:field_consts_from): [p (8 limbs), -p^-1 mod 2^32]
        as uint32."""
        assert self.bits <= LIMB_BITS * LIMBS - 1, (
            f"{self.name}: {self.bits}-bit fields need more than {LIMBS} limbs")
        return np.concatenate([
            int_to_limbs(self.p), np.array([self.p_inv_neg], dtype=np.uint32)])

    def _check_barrett_range(self) -> None:
        assert (1 << 226) < self.p < (1 << 255), (
            f"{self.name}: the one-subtraction Barrett bound needs "
            "2^226 < p < 2^255")

    @functools.cached_property
    def barrett_mu(self) -> int:
        """floor(2^512 / p), the Barrett factor of field_mul (csrc/field.cuh,
        cc_mul_mod).  Only for 2^226 < p < 2^255 does the truncated
        q1 mu / 2^288 fall short of x / p by less than 1 before its floor,
        so that the quotient is floor(x / p) or one less (x / p - q3 < 2)
        and one conditional subtraction suffices."""
        self._check_barrett_range()
        return (1 << (2 * LIMB_BITS * LIMBS)) // self.p

    @functools.cached_property
    def sum_mu(self) -> int:
        """floor(2^544 / p), the Barrett factor of a product sum
        (csrc/field.cuh, cc_sum_mod): for sums below 2^515 and p in
        barrett_mu's range the quotient is floor(S / p) or one less."""
        self._check_barrett_range()
        return (1 << (LIMB_BITS * (2 * LIMBS + 1))) // self.p

    @functools.cached_property
    def mul_consts(self) -> np.ndarray:
        """The constant buffer of K1 (csrc/field.cuh:mul_consts_from):
        kernel_consts, then the Barrett factors of a product (MU_LIMBS
        limbs) and of a product sum (MU_SUM_LIMBS limbs)."""
        return np.concatenate([self.kernel_consts,
                               int_to_limbs(self.barrett_mu, MU_LIMBS),
                               int_to_limbs(self.sum_mu, MU_SUM_LIMBS)])

    def __hash__(self):
        return hash((self.name, self.p))
