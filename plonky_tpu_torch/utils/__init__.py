"""Small pure-host utilities (reference: src/util.rs)."""

from __future__ import annotations


def ceil_div(a: int, b: int) -> int:
    """Ceiling division (reference: src/util.rs ceil_div_usize)."""
    return -(-a // b)


def log2_ceil(n: int) -> int:
    """Smallest k with 2^k >= n (reference: src/util.rs log2_ceil)."""
    assert n > 0
    return (n - 1).bit_length()


def log2_strict(n: int) -> int:
    """log2 of n, requiring n to be a power of two (reference: src/util.rs log2_strict)."""
    k = n.bit_length() - 1
    assert 1 << k == n, f"{n} is not a power of two"
    return k


def is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0
