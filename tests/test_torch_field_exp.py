"""field_exp (csrc/field_kernels.cu; fields/ops.py:exp_const, inverse and
kth_root on the card) on the CPU: the chain the kernel runs, decoded from
the constant buffer it is handed (fields/chain.py:exp_consts) and replayed
step by step on Python ints as csrc/field.cuh:exp_chain runs it, gives x^e
for the inverse's p - 2 and the kth_root exponents of every field of both
packages, within the kernel's limits and the lazy products' bound; and the
port's exp_const and inverse (their plain version on CPU tensors) equal the
JAX package's on a seeded batch with 0, 1 and p - 1 at 8 and 12 limbs."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from plonky_tpu.fields import ALL_FIELDS as J_FIELDS
from plonky_tpu.fields import ops as jfops
from plonky_tpu_torch.fields import (ALL_FIELDS, BLS12_377_BASE, BLS12_377_SCALAR,
                                     TWEEDLEDUM_BASE)
from plonky_tpu_torch.fields import chain
from plonky_tpu_torch.fields import ops as fops
from plonky_tpu_torch.fields.host import kth_root_exponent

torch.set_num_threads(1)

CSRC = Path(chain.__file__).resolve().parents[1] / "csrc"
B32 = 1 << 32


def _exponents(spec):
    """p - 2 and the kth_root exponents of the port and of the JAX package
    (its own kth_root_exponent over its field of the same p) for every
    small k with x -> x^k a permutation."""
    jspec = next(f for f in J_FIELDS if f.p == spec.p)
    ks = [k for k in range(2, 20) if math.gcd(k, spec.p - 1) == 1]
    assert spec.alpha in ks
    exps = {"p-2": spec.p - 2}
    for k in ks:
        e = kth_root_exponent(spec, k)
        assert e == jfops.kth_root_exponent(jspec, k)
        exps[f"1/{k}"] = e
    return exps


def _decode(spec, words):
    """exp_consts' buffer -> (p, -p^-1, R^2, sparse, slots, steps)."""
    nl = spec.limbs
    w = [int(v) for v in words]
    value = lambda ws: sum(x << (32 * k) for k, x in enumerate(ws))  # noqa: E731
    p, pinv, r2 = value(w[:nl]), w[nl], value(w[nl + 1:2 * nl + 1])
    sparse, slots, n_steps = w[2 * nl + 1:2 * nl + 4]
    steps = w[2 * nl + 4:]
    assert len(steps) == chain.EXP_MAX_STEPS and not any(steps[n_steps:])
    return p, pinv, r2, sparse, slots, steps[:n_steps]


def _replay(spec, words, x: int) -> int:
    """field_exp on one element as the kernel runs it: into Montgomery form
    by a product with R^2, exp_chain's steps (load, squares, multiply,
    store; every product a b / R mod p, every value kept below 2p as the
    lazy products keep it, asserted), then a product with 1."""
    p, pinv, r2, sparse, slots, steps = _decode(spec, words)
    big_r = B32 ** spec.limbs
    r_inv = pow(big_r, -1, p)
    assert (p * pinv + 1) % B32 == 0 and r2 == big_r * big_r % p
    assert sparse == chain.sparse_prime(spec)
    assert 1 <= slots <= chain.EXP_MAX_SLOTS and len(steps) <= chain.EXP_MAX_STEPS

    def mont(a, b):
        assert a < 2 * p and b < 2 * p
        return a * b * r_inv % p
    s = mont(x, r2)
    tab = [None] * slots
    for word in steps:
        load, m, store, squares = word & 31, (word >> 5) & 31, (word >> 10) & 31, word >> 16
        if load != chain.NO_SLOT:
            s = tab[load]
        for _ in range(squares):
            s = mont(s, s)
        if m != chain.NO_SLOT:
            s = mont(s, tab[m])
        if store != chain.NO_SLOT:
            tab[store] = s
    return mont(s, 1)


@pytest.mark.parametrize("spec", ALL_FIELDS, ids=lambda s: s.name)
def test_chain_replay_gives_the_power(spec):
    """For p - 2 and every kth_root exponent: the chain within
    EXP_MAX_STEPS steps and EXP_MAX_SLOTS slots, its lazy values below 2p
    (lazy_chain_bound), the cheapest of the windows 1 to 5, and its replay
    x^e at 0, 1, p - 1 and seeded values."""
    rng = np.random.default_rng(1600 + spec.limbs)
    xs = [0, 1, spec.p - 1] + [int.from_bytes(rng.bytes(48), "little") % spec.p
                               for _ in range(3)]
    for label, e in _exponents(spec).items():
        steps = chain.exp_schedule(e)
        cost = sum(chain.schedule_counts(steps))
        assert cost == min(sum(chain.schedule_counts(chain.sbox_schedule(e, w)))
                           for w in range(1, chain.SBOX_MAX_WINDOW + 1))
        assert len(steps) <= chain.EXP_MAX_STEPS, label
        assert chain.lazy_chain_bound(spec.p, cost, spec.limbs) <= 2 * spec.p
        words = chain.exp_consts(spec, e)
        assert words.dtype == np.uint32 and words.size == 2 * spec.limbs + 4 + chain.EXP_MAX_STEPS
        for x in xs:
            assert _replay(spec, words, x) == pow(x, e, spec.p), (label, x)


def test_limits_match_the_kernel():
    """EXP_MAX_STEPS and EXP_MAX_SLOTS as field_kernels.cu defines them,
    ExpConsts' words as exp_consts lays them out, the no-slot field as
    field.cuh's; e <= 0 and a chain the kernel cannot hold are refused."""
    text = (CSRC / "field_kernels.cu").read_text()
    defined = {k: int(v) for k, v in re.findall(r"#define (EXP_\w+) (\d+)\b", text)}
    assert defined["EXP_MAX_STEPS"] == chain.EXP_MAX_STEPS
    assert defined["EXP_MAX_SLOTS"] == chain.EXP_MAX_SLOTS == 17
    assert "#define PT_NO_SLOT 31" in (CSRC / "field.cuh").read_text()
    assert chain.NO_SLOT == 31
    for bad in (0, -1):
        with pytest.raises(ValueError, match="positive"):
            chain.exp_consts(TWEEDLEDUM_BASE, bad)
    # 2^1000 - 1: ~200 windows of 5 bits, past EXP_MAX_STEPS
    with pytest.raises(ValueError, match="steps"):
        chain.exp_consts(TWEEDLEDUM_BASE, (1 << 1000) - 1)


def _values(p: int, seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [0, 1, p - 1] + [int.from_bytes(rng.bytes(56), "little") % p
                            for _ in range(n - 3)]


@pytest.mark.parametrize("spec", [TWEEDLEDUM_BASE, BLS12_377_SCALAR, BLS12_377_BASE],
                         ids=lambda s: s.name)
def test_inverse_and_exp_const_match_jax(spec):
    """The port's inverse and exp_const on CPU tensors (exp_const_plain)
    against the JAX package's inverse and exp_const on the CPU, canonical
    values, at 8 limbs (a sparse and a dense field) and 12; inverse(0) = 0;
    e = 0 gives 1 on the host."""
    jspec = next(f for f in J_FIELDS if f.p == spec.p)
    vals = _values(spec.p, spec.limbs + spec.p % 97, 11)
    x = fops.from_ints(spec, vals, "cpu")
    jx = jfops.from_ints(jspec, vals)
    e = kth_root_exponent(spec, spec.alpha)
    got = {"inverse": fops.inverse(spec, x), "root": fops.exp_const(spec, x, e),
           "cube": fops.exp_const(spec, x, 3), "zero": fops.exp_const(spec, x, 0)}
    want = {"inverse": jfops.inverse(jspec, jx), "root": jfops.exp_const(jspec, jx, e),
            "cube": jfops.exp_const(jspec, jx, 3), "zero": jfops.exp_const(jspec, jx, 0)}
    for k in got:
        g = [int(v) for v in fops.to_ints(spec, got[k])]
        w = [int(v) for v in np.asarray(jfops.to_ints(jspec, want[k])).reshape(-1)]
        assert g == w, k
    assert int(fops.to_ints(spec, got["inverse"])[0]) == 0
    assert [int(v) for v in fops.to_ints(spec, got["inverse"])[1:]] == \
        [pow(v, -1, spec.p) for v in vals[1:]]


def test_exp_const_takes_any_batch_shape():
    """exp_const over a [L, 2, 3] batch and an expanded [L, 1] column is
    the same function elementwise (the card's wrapper flattens the batch
    for its one launch)."""
    spec = BLS12_377_BASE
    vals = _values(spec.p, 7, 6)
    x = fops.from_ints(spec, vals, "cpu").reshape(spec.limbs, 2, 3)
    got = fops.to_ints(spec, fops.inverse(spec, x))
    assert got.shape == (2, 3)
    assert [int(v) for v in got.reshape(-1)] == [pow(v, spec.p - 2, spec.p) for v in vals]
    col = fops.from_ints(spec, [vals[4]], "cpu").expand(spec.limbs, 5)
    assert [int(v) for v in fops.to_ints(spec, fops.exp_const(spec, col, 5))] == \
        [pow(vals[4], 5, spec.p)] * 5
