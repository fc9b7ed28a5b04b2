"""Exponent chains on the card: the host side of csrc/field.cuh's
exp_chain, which K5's S-boxes (hashing/rescue.py) and field_exp
(fields/ops.py:exp_const) run.

A chain computes x^e by a left-to-right sliding window (sbox_schedule):
a table of odd powers of x, then one step a window, each "load a slot,
square, multiply by a slot, store", uploaded as one word a step
(step_word).  Its products are lazy Montgomery products, below 2p only
while lazy_chain_bound says so; their REDC takes the sparse rows where
the prime has the shape of sparse_prime.
"""

from __future__ import annotations

import functools

import numpy as np

from .spec import LIMB_BITS, FieldSpec, int_to_limbs

NO_SLOT = 31
# The widest window sbox_schedule builds: a w-bit window's table takes
# slots 0 .. 2^(w-1), which must stay below NO_SLOT.
SBOX_MAX_WINDOW = 5
# field_exp's limits (csrc/field_kernels.cu: EXP_MAX_STEPS, EXP_MAX_SLOTS):
# steps of a chain and table slots an element (windows up to
# SBOX_MAX_WINDOW bits: x, x^3, ..., x^31 and x^2).
EXP_MAX_STEPS = 128
EXP_MAX_SLOTS = 1 + (1 << (SBOX_MAX_WINDOW - 1))


def sbox_schedule(e: int, w: int) -> tuple:
    """x^e by a left-to-right sliding window of up to w bits, as K5 and
    field_exp run it (csrc/field.cuh: exp_chain):
    a tuple of steps (load, squares, mul, store), each applied to the
    running value s as: s = slot[load], then `squares` squares, then
    s = s slot[mul], then slot[store] = s (NO_SLOT: the part is skipped).
    s starts as x.  The table: slot 0 is x and, for w > 1, slots 1 ..
    n - 1 (n = 2^(w-1)) x^3, x^5, ..., x^(2n - 1), built by one square
    (x^2, kept in slot n) and n - 1 multiplies.  Then the first window is
    loaded from the table, and every later bit costs a square and every
    later window a multiply.  w is at most SBOX_MAX_WINDOW: a wider
    window's table would name the slot NO_SLOT."""
    if not 1 <= w <= SBOX_MAX_WINDOW:
        raise ValueError(f"sbox_schedule: a {w}-bit window; windows of 1 "
                         f"to {SBOX_MAX_WINDOW} bits keep every table slot "
                         f"below NO_SLOT = {NO_SLOT}")
    bits = bin(e)[2:]
    n = 1 << (w - 1)
    steps = [(NO_SLOT, 0, NO_SLOT, 0)]
    if n > 1:
        steps += [(NO_SLOT, 1, NO_SLOT, n), (NO_SLOT, 0, 0, 1)]
        steps += [(NO_SLOT, 0, n, j) for j in range(2, n)]
    load, squares, i = None, 0, 0
    while i < len(bits):
        if bits[i] == "0":
            squares, i = squares + 1, i + 1
            continue
        j = min(i + w, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        slot = int(bits[i:j], 2) >> 1
        if load is None:
            load = slot
        else:
            steps.append((load, squares + j - i, slot, NO_SLOT))
            load, squares = NO_SLOT, 0
        i = j
    if load != NO_SLOT or squares:
        steps.append((load, squares, NO_SLOT, NO_SLOT))
    return tuple(steps)


def schedule_counts(steps) -> tuple:
    """(squares, multiplies) of a chain of sbox_schedule's steps."""
    return (sum(sq for _l, sq, _m, _s in steps),
            sum(m != NO_SLOT for _l, _sq, m, _s in steps))


def schedule_slots(steps) -> int:
    """Table slots a chain uses (1 + the highest slot it names)."""
    return 1 + max(v for step in steps for v in (step[0], step[2], step[3])
                   if v != NO_SLOT)


def step_word(step) -> int:
    """One step as the kernel reads it: load slot in bits 0-4, multiply
    slot 5-9, store slot 10-14, squares 16-31."""
    load, squares, m, store = step
    assert all(0 <= v <= NO_SLOT for v in (load, m, store)) and squares < 1 << 16
    return load | m << 5 | store << 10 | squares << 16


def lazy_chain_bound(p: int, n: int, limbs: int = 8) -> int:
    """A strict bound on the values of a chain of n lazy Montgomery products
    (csrc/field.cuh: cc_mont_sqr, cc_mont_mul_sos, no conditional
    subtraction; R = 2^(32 limbs)) from inputs below p: B_0 = p, B_(k+1) =
    floor(((B_k - 1)^2 + (R - 1) p) / R) + 1.  K5 and field_exp make a
    chain canonical with one subtraction, so they need B_n <= 2p."""
    r = 1 << (LIMB_BITS * limbs)
    b = p
    for _ in range(n):
        b = ((b - 1) ** 2 + (r - 1) * p) // r + 1
    return b


def sparse_prime(spec: FieldSpec) -> bool:
    """p = 2^254 + c with c < 2^128 and p = 1 mod 2^32 (32-bit limbs [1,
    c1, c2, c3, 0, 0, 0, 2^30]): the shape whose REDC runs with 3 limb
    products a row (csrc/field.cuh, cc_redc's SPARSE rows: the 8-limb point
    kernels', and K5's and field_exp's where the field has it).  The
    Tweedle and Pasta base fields have it; BLS12-377's fields do not."""
    c = spec.p - (1 << 254)
    return 0 <= c < 1 << 128 and spec.p % (1 << LIMB_BITS) == 1


def exp_schedule(e: int) -> tuple:
    """The chain field_exp runs for x^e, e > 0: sbox_schedule's with the
    fewest squares and multiplies over windows of 1 to SBOX_MAX_WINDOW
    bits (the smaller window where two tie)."""
    return min((sbox_schedule(e, w) for w in range(1, SBOX_MAX_WINDOW + 1)),
               key=lambda steps: sum(schedule_counts(steps)))


@functools.lru_cache(maxsize=None)
def exp_consts(spec: FieldSpec, e: int) -> np.ndarray:
    """field_exp's constant buffer for x^e (csrc/field_kernels.cu,
    ExpConsts, at the field's width L), uint32 words: the field's [p,
    -p^-1 mod 2^32] (FieldSpec.kernel_consts), R^2 mod p (R = 2^(32 L)),
    the sparse flag (sparse_prime: the kernel's instance), the table slots
    an element, the step count and the chain (exp_schedule, EXP_MAX_STEPS
    words, step_word).  Refuses e <= 0, a chain past the kernel's limits,
    and one whose lazy values may leave [0, 2p) (lazy_chain_bound)."""
    if e <= 0:
        raise ValueError(f"field_exp: the exponent must be positive, got {e}")
    chain = exp_schedule(e)
    if len(chain) > EXP_MAX_STEPS:
        raise ValueError(f"field_exp: a chain of {len(chain)} steps, the "
                         f"kernel takes at most {EXP_MAX_STEPS}")
    slots = schedule_slots(chain)
    assert slots <= EXP_MAX_SLOTS
    p, nl = spec.p, spec.limbs
    if lazy_chain_bound(p, sum(schedule_counts(chain)), nl) > 2 * p:
        raise ValueError(f"field_exp: {spec.name}'s chain for x^{e} may leave "
                         "[0, 2p) without reductions")
    steps = np.zeros(EXP_MAX_STEPS, dtype=np.uint32)
    steps[:len(chain)] = [step_word(st) for st in chain]
    mont = 1 << (LIMB_BITS * nl)
    return np.concatenate([
        spec.kernel_consts, int_to_limbs(mont * mont % p, nl),
        np.array([int(sparse_prime(spec)), slots, len(chain)], dtype=np.uint32),
        steps])
