"""Rescue permutation and sponge (host + device).

Behavioral parity with the reference (src/rescue.rs): width-4 sponge with
rate 3, rounds = max(ceil(security_bits / (2*width)), 10), round constants
sampled from ChaCha8Rng seeded with 1337 exactly as `generate_rescue_constants`
does (reference: src/rescue.rs:97-121).

Two implementations:
* host (python ints): the sequential Fiat-Shamir challenger, the sponge and
  the gates' round constants.
* device (canonical limb tensors [LIMBS, *batch], one tensor per state
  element): a batch of permutations.  On a CUDA tensor `rescue_permutation`
  launches K5 (csrc/rescue_kernels.cu), which runs every round of a
  permutation in registers; on a CPU tensor it runs
  `rescue_permutation_plain`, the same rounds over the plain field ops.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _cuda
from ..fields import host
from ..fields import ops as fops
from ..fields.spec import (LIMB_BITS, LIMBS, FieldSpec, int_to_limbs,
                           require_eight_limbs)
from .chacha import ChaCha8Rng

RESCUE_SPONGE_WIDTH = 4
RESCUE_SPONGE_RATE = 3
# Rounds K5 takes (csrc/rescue_kernels.cu, RESCUE_MAX_ROUNDS): 512 bits.
KERNEL_MAX_ROUNDS = 64
# K5's exponent chains (sbox_schedule, csrc/rescue_kernels.cu): the widest
# window the kernel's chains take, steps an S-box (RESCUE_MAX_STEPS), table
# slots an element (RESCUE_MAX_SLOTS: x, x^3, x^5, x^7 and x^2), and the
# field of a step that names no slot (RESCUE_NO_SLOT).
KERNEL_WINDOW = 3
KERNEL_MAX_STEPS = 128
KERNEL_MAX_SLOTS = 1 + (1 << (KERNEL_WINDOW - 1))
NO_SLOT = 31
# The widest window sbox_schedule builds: a w-bit window's table takes
# slots 0 .. 2^(w-1), which must stay below NO_SLOT.
SBOX_MAX_WINDOW = 5


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


def rescue_sponge_host(spec: FieldSpec, inputs, num_outputs: int,
                       security_bits: int):
    """reference: src/rescue.rs:40-68."""
    rate, width = RESCUE_SPONGE_RATE, RESCUE_SPONGE_WIDTH
    state = [0] * width
    for i in range(0, len(inputs), rate):
        chunk = inputs[i:i + rate]
        for j, x in enumerate(chunk):
            state[j] = (state[j] + x) % spec.p
        state = rescue_permutation_host(spec, state, security_bits)
    outputs = []
    while True:
        for j in range(rate):
            outputs.append(state[j])
            if len(outputs) == num_outputs:
                return outputs
        state = rescue_permutation_host(spec, state, security_bits)


def rescue_hash_n_to_1_host(spec: FieldSpec, inputs, security_bits: int) -> int:
    return rescue_sponge_host(spec, inputs, 1, security_bits)[0]


# ---------------------------------------------------------------------------
# Device implementation (batched canonical limb tensors)
# ---------------------------------------------------------------------------

def _check_state(state) -> None:
    if len(state) != RESCUE_SPONGE_WIDTH:
        raise ValueError(f"rescue_permutation: a width-{RESCUE_SPONGE_WIDTH} "
                         f"state, got {len(state)} elements")


def rescue_permutation_plain(spec: FieldSpec, state, security_bits: int):
    """K5's plain version: the rounds of `rescue_permutation_host` over the
    plain field ops, on tensors of any device, with the 4 elements stacked
    into one [LIMBS, 4, *batch] tensor.  Each S-box is a left-to-right
    square-and-multiply; each MDS row and its round constant is one
    product sum."""
    require_eight_limbs(spec, "rescue_permutation_plain")
    _check_state(state)
    batch = fops.batch_shape(*state)
    dev = state[0].device
    s = torch.stack([fops._expand(x, batch) for x in state], dim=1)
    col = functools.partial(fops.column, spec, device=dev)
    mds_cols = [[col(v) for v in row]
                for row in mds_matrix(spec, RESCUE_SPONGE_WIDTH)]

    def sbox(x, e):
        acc = x
        for bit in bin(e)[3:]:
            acc = fops.mul_plain(spec, acc, acc)
            if bit == "1":
                acc = fops.mul_plain(spec, acc, x)
        return acc

    def mds_add(x, consts):
        return torch.stack([fops.product_sum_plain(
            spec, [(m, x[:, c], 1) for c, m in enumerate(row)]
            + [(col(k), None, 1)]) for row, k in zip(mds_cols, consts)], dim=1)

    inv_alpha = host.kth_root_exponent(spec, spec.alpha)
    for step_a, step_b in rescue_constants(spec, RESCUE_SPONGE_WIDTH,
                                           security_bits):
        s = mds_add(sbox(s, inv_alpha), step_a)
        s = mds_add(sbox(s, spec.alpha), step_b)
    return list(s.unbind(1))


def sbox_schedule(e: int, w: int) -> tuple:
    """x^e by a left-to-right sliding window of up to w bits, as K5 runs it:
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


def kernel_schedule(e: int) -> tuple:
    """The chain K5 runs for x^e: sbox_schedule's with the fewest squares
    and multiplies over windows of 1 to KERNEL_WINDOW bits (the smaller
    window where two tie): 3 bits for the 254-bit inverse exponents, 1 for
    x^5."""
    return min((sbox_schedule(e, w) for w in range(1, KERNEL_WINDOW + 1)),
               key=lambda steps: sum(schedule_counts(steps)))


def lazy_chain_bound(p: int, n: int) -> int:
    """A strict bound on the values of a chain of n lazy Montgomery products
    (csrc/field.cuh: cc_mont_sqr, cc_mont_mul_sos, no conditional
    subtraction; R = 2^256) from inputs below p: B_0 = p, B_(k+1) =
    floor(((B_k - 1)^2 + (R - 1) p) / R) + 1.  K5 makes a chain canonical
    with one subtraction, so it needs B_n <= 2p."""
    r = 1 << (LIMB_BITS * LIMBS)
    b = p
    for _ in range(n):
        b = ((b - 1) ** 2 + (r - 1) * p) // r + 1
    return b


def sparse_prime(spec: FieldSpec) -> bool:
    """p = 2^254 + c with c < 2^128 and p = 1 mod 2^32 (32-bit limbs [1,
    c1, c2, c3, 0, 0, 0, 2^30]): the shape whose REDC K5 runs with 3 limb
    products a row (csrc/field.cuh, cc_redc's SPARSE rows).  Both Tweedle
    base fields have it."""
    c = spec.p - (1 << 254)
    return 0 <= c < 1 << 128 and spec.p % (1 << LIMB_BITS) == 1


@functools.lru_cache(maxsize=None)
def kernel_consts(spec: FieldSpec, security_bits: int) -> np.ndarray:
    """K5's constant buffer (csrc/rescue_kernels.cu, RescueConsts), uint32
    words: the field's [p, -p^-1 mod 2^32] (FieldSpec.kernel_consts),
    R^2 = 2^512 mod p (R = 2^256), the sparse flag (sparse_prime: the
    kernel's instance), the round count, the table slots an element, the
    two S-boxes' step counts and their chains (kernel_schedule,
    x^(1/alpha) first, KERNEL_MAX_STEPS words each, step_word), the MDS matrix
    [row][column] and the round constants [round][half][element], these
    two in Montgomery form (v R mod p).  The MDS mix reduces a sum of four
    products once, to below 4 p^2 / R + p, which must fit 256 bits, and
    each chain's values must stay below 2p (lazy_chain_bound)."""
    require_eight_limbs(spec, "rescue_permutation")
    p = spec.p
    width = RESCUE_SPONGE_WIDTH
    consts = rescue_constants(spec, width, security_bits)
    if len(consts) > KERNEL_MAX_ROUNDS:
        raise ValueError(f"rescue_permutation: {len(consts)} rounds, the "
                         f"kernel takes at most {KERNEL_MAX_ROUNDS}")
    mont = 1 << (LIMB_BITS * LIMBS)
    if 4 * p * p + p * mont >= mont * mont:
        raise ValueError(f"rescue_permutation: {spec.name}'s MDS sums "
                         "overflow 256 bits")
    chains = [kernel_schedule(e) for e in
              (host.kth_root_exponent(spec, spec.alpha), spec.alpha)]
    if max(map(len, chains)) > KERNEL_MAX_STEPS:
        raise ValueError("rescue_permutation: an exponent chain longer than "
                         f"{KERNEL_MAX_STEPS} steps")
    slots = max(map(schedule_slots, chains))
    if slots > KERNEL_MAX_SLOTS:
        raise ValueError(f"rescue_permutation: the chains need {slots} table "
                         f"slots, the kernel has {KERNEL_MAX_SLOTS}")
    if lazy_chain_bound(p, max(sum(schedule_counts(c)) for c in chains)) > 2 * p:
        raise ValueError(f"rescue_permutation: {spec.name}'s exponent chains "
                         "may leave [0, 2p) without reductions")
    steps = np.zeros((2, KERNEL_MAX_STEPS), dtype=np.uint32)
    for half, chain in enumerate(chains):
        steps[half, :len(chain)] = [step_word(st) for st in chain]

    def limbs(values):
        return [int_to_limbs(v * mont % p) for v in values]
    mds = [v for row in mds_matrix(spec, width) for v in row]
    rc = [v for step_a, step_b in consts for v in (*step_a, *step_b)]
    return np.concatenate([
        spec.kernel_consts, int_to_limbs(mont * mont % p),
        np.array([int(sparse_prime(spec)), len(consts), slots, *map(len, chains)],
                 dtype=np.uint32),
        steps.reshape(-1), *limbs(mds), *limbs(rc)])


def rescue_permutation(spec: FieldSpec, state, security_bits: int):
    """A batch of Rescue permutations: state is a list of 4 canonical
    tensors [LIMBS, *batch] (broadcast to one batch), the result the list
    of the 4 permuted elements, [LIMBS, *batch] each.  On a CUDA tensor it
    launches K5 (one launch) or raises; on a CPU tensor it runs
    rescue_permutation_plain."""
    require_eight_limbs(spec, "rescue_permutation")
    _check_state(state)
    if not fops._dispatch(state[0]):
        return rescue_permutation_plain(spec, state, security_bits)
    batch = fops.batch_shape(*state)
    stacked = torch.stack([fops._expand(x, batch) for x in state]).contiguous()
    _cuda.check("rescue_permutation", stacked[0], LIMBS)
    out = torch.empty_like(stacked)
    n = stacked[0, 0].numel()
    if n:
        consts = kernel_consts(spec, security_bits)
        _cuda.launch("rescue_permutation", "pt_rescue_permutation",
                     (out, stacked), out.data_ptr(), stacked.data_ptr(), n,
                     consts.ctypes.data, consts.size)
    return list(out)
