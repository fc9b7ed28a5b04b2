"""Rescue permutation and sponge (host + device).

Behavioral parity with the reference (src/rescue.rs): width-4 sponge with
rate 3, rounds = max(ceil(security_bits / (2*width)), 10), round constants
sampled from ChaCha8Rng seeded with 1337 exactly as `generate_rescue_constants`
does (reference: src/rescue.rs:97-121).

Two implementations:
* host (python ints): the sequential Fiat-Shamir challenger, the sponge and
  the gates' round constants.
* device (canonical limb tensors [L, *batch], L = spec.limbs, one tensor
  per state element): a batch of permutations.  On a CUDA tensor
  `rescue_permutation` launches K5 (csrc/rescue_kernels.cu, its 8- or
  12-limb build), which runs every round of a permutation in registers; on
  a CPU tensor it runs `rescue_permutation_plain`, the same rounds over
  the plain field ops.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _cuda
from ..fields import host
from ..fields import ops as fops
from ..fields.chain import (NO_SLOT, SBOX_MAX_WINDOW, lazy_chain_bound,  # noqa: F401
                            sbox_schedule, schedule_counts, schedule_slots,
                            sparse_prime, step_word)
from ..fields.spec import LIMB_BITS, FieldSpec, int_to_limbs
from .chacha import ChaCha8Rng

RESCUE_SPONGE_WIDTH = 4
RESCUE_SPONGE_RATE = 3
# Rounds K5 takes (csrc/rescue_kernels.cu, RESCUE_MAX_ROUNDS): 512 bits.
KERNEL_MAX_ROUNDS = 64
# K5's exponent chains (fields/chain.py:sbox_schedule,
# csrc/rescue_kernels.cu): the widest window the kernel's chains take,
# steps an S-box (RESCUE_MAX_STEPS) and table slots an element
# (RESCUE_MAX_SLOTS: x, x^3, x^5, x^7 and x^2).
KERNEL_WINDOW = 3
KERNEL_MAX_STEPS = 128
KERNEL_MAX_SLOTS = 1 + (1 << (KERNEL_WINDOW - 1))


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
    into one [L, 4, *batch] tensor.  Each S-box is a left-to-right
    square-and-multiply; each MDS row and its round constant is one
    product sum."""
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


def kernel_schedule(e: int) -> tuple:
    """The chain K5 runs for x^e: sbox_schedule's with the fewest squares
    and multiplies over windows of 1 to KERNEL_WINDOW bits (the smaller
    window where two tie): 3 bits for the 254-bit inverse exponents, 1 for
    x^5."""
    return min((sbox_schedule(e, w) for w in range(1, KERNEL_WINDOW + 1)),
               key=lambda steps: sum(schedule_counts(steps)))


@functools.lru_cache(maxsize=None)
def kernel_consts(spec: FieldSpec, security_bits: int) -> np.ndarray:
    """K5's constant buffer (csrc/rescue_kernels.cu, RescueConsts, at the
    field's width L), uint32 words: the field's [p, -p^-1 mod 2^32]
    (FieldSpec.kernel_consts), R^2 mod p (R = 2^(32 L)), the sparse flag
    (sparse_prime: the kernel's instance), the round count, the table
    slots an element, the two S-boxes' step counts and their chains
    (kernel_schedule, x^(1/alpha) first, KERNEL_MAX_STEPS words each,
    step_word), the MDS matrix [row][column] and the round constants
    [round][half][element], these two in Montgomery form (v R mod p).
    The MDS mix reduces a sum of four products once, to below 4 p^2 / R +
    p, which must fit 32 L bits, and each chain's values must stay below
    2p (lazy_chain_bound)."""
    p, nl = spec.p, spec.limbs
    width = RESCUE_SPONGE_WIDTH
    consts = rescue_constants(spec, width, security_bits)
    if len(consts) > KERNEL_MAX_ROUNDS:
        raise ValueError(f"rescue_permutation: {len(consts)} rounds, the "
                         f"kernel takes at most {KERNEL_MAX_ROUNDS}")
    mont = 1 << (LIMB_BITS * nl)
    if 4 * p * p + p * mont >= mont * mont:
        raise ValueError(f"rescue_permutation: {spec.name}'s MDS sums "
                         f"overflow {LIMB_BITS * nl} bits")
    chains = [kernel_schedule(e) for e in
              (host.kth_root_exponent(spec, spec.alpha), spec.alpha)]
    if max(map(len, chains)) > KERNEL_MAX_STEPS:
        raise ValueError("rescue_permutation: an exponent chain longer than "
                         f"{KERNEL_MAX_STEPS} steps")
    slots = max(map(schedule_slots, chains))
    if slots > KERNEL_MAX_SLOTS:
        raise ValueError(f"rescue_permutation: the chains need {slots} table "
                         f"slots, the kernel has {KERNEL_MAX_SLOTS}")
    if lazy_chain_bound(p, max(sum(schedule_counts(c)) for c in chains),
                        nl) > 2 * p:
        raise ValueError(f"rescue_permutation: {spec.name}'s exponent chains "
                         "may leave [0, 2p) without reductions")
    steps = np.zeros((2, KERNEL_MAX_STEPS), dtype=np.uint32)
    for half, chain in enumerate(chains):
        steps[half, :len(chain)] = [step_word(st) for st in chain]

    def limbs(values):
        return [int_to_limbs(v * mont % p, nl) for v in values]
    mds = [v for row in mds_matrix(spec, width) for v in row]
    rc = [v for step_a, step_b in consts for v in (*step_a, *step_b)]
    return np.concatenate([
        spec.kernel_consts, int_to_limbs(mont * mont % p, nl),
        np.array([int(sparse_prime(spec)), len(consts), slots, *map(len, chains)],
                 dtype=np.uint32),
        steps.reshape(-1), *limbs(mds), *limbs(rc)])


def rescue_permutation(spec: FieldSpec, state, security_bits: int):
    """A batch of Rescue permutations: state is a list of 4 canonical
    tensors [L, *batch] (broadcast to one batch), the result the list
    of the 4 permuted elements, [L, *batch] each.  On a CUDA tensor it
    launches K5 at the field's width (one launch) or raises; on a CPU
    tensor it runs rescue_permutation_plain."""
    _check_state(state)
    if not fops._dispatch(state[0]):
        return rescue_permutation_plain(spec, state, security_bits)
    name, entry = _cuda.kernel("rescue_permutation", spec.limbs)
    batch = fops.batch_shape(*state)
    stacked = torch.stack([fops._expand(x, batch) for x in state]).contiguous()
    _cuda.check(name, stacked[0], spec.limbs)
    out = torch.empty_like(stacked)
    n = stacked[0, 0].numel()
    if n:
        consts = kernel_consts(spec, security_bits)
        _cuda.launch(name, entry, (out, stacked), out.data_ptr(),
                     stacked.data_ptr(), n, consts.ctypes.data, consts.size)
    return list(out)
