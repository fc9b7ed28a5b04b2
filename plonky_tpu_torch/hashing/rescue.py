"""Rescue permutation and sponge (host).

Behavioral parity with the reference (src/rescue.rs): width-4 sponge with
rate 3, rounds = max(ceil(security_bits / (2*width)), 10), round constants
sampled from ChaCha8Rng seeded with 1337 exactly as `generate_rescue_constants`
does (reference: src/rescue.rs:97-121).

Python ints only: the sequential Fiat-Shamir challenger and the gates'
round constants are its callers.
"""

from __future__ import annotations

import functools

from ..fields import host
from ..fields.spec import FieldSpec
from .chacha import ChaCha8Rng

RESCUE_SPONGE_WIDTH = 4
RESCUE_SPONGE_RATE = 3


def recommended_rounds(width: int, security_bits: int) -> int:
    """reference: src/rescue.rs:123-125."""
    return max(-(-security_bits // (2 * width)), 10)


@functools.lru_cache(maxsize=None)
def mds_matrix(spec: FieldSpec, n: int):
    """Cauchy MDS matrix: entry (r, c) = 1/(x_r - y_c), x_r = n+r, y_c = c.
    (reference: src/mds.rs:63-77)"""
    p = spec.p
    return tuple(
        tuple(pow((n + r - c) % p, -1, p) for c in range(n))
        for r in range(n)
    )


@functools.lru_cache(maxsize=None)
def rescue_constants(spec: FieldSpec, width: int, security_bits: int):
    """Round constants, identical to the reference's ChaCha8(1337) stream
    (reference: src/rescue.rs:97-121)."""
    rng = ChaCha8Rng.seed_from_u64(1337)
    rounds = recommended_rounds(width, security_bits)
    out = []
    for _ in range(rounds):
        step_a = tuple(host.rand_from_rng(spec, rng) for _ in range(width))
        step_b = tuple(host.rand_from_rng(spec, rng) for _ in range(width))
        out.append((step_a, step_b))
    return tuple(out)


# ---------------------------------------------------------------------------
# Host implementation (python ints)
# ---------------------------------------------------------------------------

def _apply_mds_host(spec: FieldSpec, state):
    p = spec.p
    n = len(state)
    mds = mds_matrix(spec, n)
    return [sum(mds[r][c] * state[c] for c in range(n)) % p for r in range(n)]


def rescue_permutation_host(spec: FieldSpec, state, security_bits: int):
    """reference: src/rescue.rs:70-88."""
    p = spec.p
    state = list(state)
    inv_alpha = host.kth_root_exponent(spec, spec.alpha)
    for step_a_c, step_b_c in rescue_constants(spec, len(state), security_bits):
        state = [pow(x, inv_alpha, p) for x in state]
        state = _apply_mds_host(spec, state)
        state = [(x + c) % p for x, c in zip(state, step_a_c)]
        state = [pow(x, spec.alpha, p) for x in state]
        state = _apply_mds_host(spec, state)
        state = [(x + c) % p for x, c in zip(state, step_b_c)]
    return state
