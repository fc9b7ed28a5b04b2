"""K1's product sum (field_product_sum) on the CPU.

A Python model, limb by limb, of the kernel's accumulate-and-reduce
(plonky_tpu_torch/csrc/field.cuh: cc_acc_product, cc_acc_single,
cc_acc_fold, cc_sum_mod; field_kernels.cu: the split of a sum's terms among
threads): it forms the same chains, counters and windows as the kernel,
asserts every bound the kernel relies on, and is held against python's
sum % p at the extremes of the widest sum and on seeded sums, for both
Tweedle fields, reaching both outcomes of the Barrett quotient.  Then the
port's product_sum and product_sums (their plain versions, which the CPU
runs) against the JAX package's product_sum at each launch shape of a
steady prove (chip_smoke.product_sum_shapes), at N = 64.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from chip_smoke import product_sum_inputs, product_sum_shapes
from plonky_tpu.fields import TWEEDLEDUM_BASE as J_DUM
from plonky_tpu.fields import ops as jfops
from plonky_tpu_torch.fields import TWEEDLEDEE_BASE, TWEEDLEDUM_BASE
from plonky_tpu_torch.fields import ops as fops
from plonky_tpu_torch.fields.spec import LIMBS, MAX_TERMS, MU_SUM_LIMBS

torch.set_num_threads(1)

SPECS = [TWEEDLEDEE_BASE, TWEEDLEDUM_BASE]
B32 = 1 << 32
M32 = B32 - 1
CSRC = Path(fops.__file__).resolve().parents[1] / "csrc"


def _limbs(v: int, n: int):
    assert 0 <= v < B32 ** n, (v, n)
    return [(v >> (32 * k)) & M32 for k in range(n)]


def _value(limbs) -> int:
    return sum(int(x) << (32 * k) for k, x in enumerate(limbs))


def _chain(acc, lo: int, width: int, add: int) -> int:
    """acc[lo .. lo + width - 1] += add on one carry chain; returns the
    carry out (the kernel counts it), which must be 0 or 1."""
    v = _value(acc[lo:lo + width]) + add
    acc[lo:lo + width] = _limbs(v & (B32 ** width - 1), width)
    carry = v >> (32 * width)
    assert carry in (0, 1)
    return carry


def accumulate(terms, p: int):
    """cc_acc_product / cc_acc_single over terms (a, b or None, sign) of
    canonical ints: returns (acc[0..15], cnt[0..8], S)."""
    acc, cnt = [0] * 16, [0] * 9
    total = 0
    for a, b, sign in terms:
        if b is None:
            z = p - a if sign < 0 else a              # cc_negate
            cnt[0] += _chain(acc, 0, LIMBS, z)
            total += z
            continue
        y = p - b if sign < 0 else b                  # cc_negate
        assert y <= p
        xl, yl = _limbs(a, LIMBS), _limbs(y, LIMBS)
        for i in range(LIMBS):                        # cc_acc_row<i>
            prods = [xl[i] * yk for yk in yl]
            lo = sum((pr & M32) << (32 * k) for k, pr in enumerate(prods))
            hi = sum((pr >> 32) << (32 * k) for k, pr in enumerate(prods))
            cnt[i] += _chain(acc, i, LIMBS, lo)       # carry into limb i + 8
            cnt[i + 1] += _chain(acc, i + 1, LIMBS, hi)   # into limb i + 9
        total += a * y
    # acc plus the counted carries is the sum exactly
    assert _value(acc) + sum(c << (32 * (8 + k)) for k, c in enumerate(cnt)) == total
    assert max(cnt) <= 2 * len(terms) <= 2 * MAX_TERMS
    return acc, cnt, total


def fold(acc, cnt) -> list:
    """cc_acc_fold: the 17 limbs of acc + the counters (no carry out)."""
    hi = _value(acc[8:]) + _value(cnt)
    assert hi < B32 ** 9
    return acc[:8] + _limbs(hi, 9)


def reduce_model(s, spec) -> dict:
    """cc_sum_mod on the 17 limbs s: q1 = s[7..16], the rows of q1 mu from
    mu limb 8 - i up (row 9 one limb up) into u = columns 8..20, q3's low
    limbs = u[2..9], r = (x - q3 p) mod 2^256, one conditional
    subtraction."""
    p, mu = spec.p, spec.sum_mu
    x = _value(s)
    assert x < 1 << 515
    mul = _limbs(mu, MU_SUM_LIMBS)
    u = 0
    for i in range(10):
        j0 = max(0, 8 - i)
        off = max(0, i + j0 - 8)
        width = (MU_SUM_LIMBS - j0) + 2               # cc_mac_row<N> window
        win = (u >> (32 * off)) + s[7 + i] * _value(mul[j0:]) * (
            B32 ** (i + j0 - 8 - off))
        assert win < B32 ** width, "carry out of a cc_mac_row window"
        u = (u & (B32 ** off - 1)) | (win << (32 * off))
    assert u < B32 ** 13
    # the truncated product is q1 mu less the skipped columns 0..7
    q1 = x >> 224
    skipped = sum(s[7 + i] * mul[j] << (32 * (i + j))
                  for i in range(10) for j in range(MU_SUM_LIMBS) if i + j < 8)
    assert skipped < 1 << 292
    assert u << 256 == q1 * mu - skipped
    # before q3's floor, u / 2^64 falls short of x / p by less than 1
    assert 0 <= (x << 64) - u * p < p << 64
    q3_full = u >> 64
    q = x // p
    assert q - 1 <= q3_full <= q, (q, q3_full)
    q3 = q3_full & (B32 ** LIMBS - 1)                 # u[2..9]
    v = q3 * p % B32 ** LIMBS                         # cc_barrett_finish
    r = (x - v) % B32 ** LIMBS
    assert r == x - q3_full * p and r < 2 * p
    return {"out": r - p if r >= p else r, "q": q, "q3": q3_full, "r": r}


def kernel_model(terms, spec, splits: int = 1) -> dict:
    """The whole kernel for one element: thread group g of `splits` takes
    terms g, g + splits, ...; the groups' folded sums are added over 17
    limbs (cc_add17), then reduced once."""
    parts = [fold(*accumulate(terms[g::splits], spec.p)[:2]) for g in range(splits)]
    total = sum(_value(s) for s in parts)
    assert total < B32 ** 17
    m = reduce_model(_limbs(total, 17), spec)
    want = sum((a * b if b is not None else a) * (1 if sg >= 0 else -1)
               for a, b, sg in terms) % spec.p
    assert m["out"] == want
    return m


def _extremes(p: int):
    top = p - 1
    return {
        "32 (p-1)^2, all +": [(top, top, 1)] * 32,
        "32 (p-1)^2, all -": [(top, top, -1)] * 32,
        "32 (p-1) 0, all - (the largest accumulator)": [(top, 0, -1)] * 32,
        "mixed signs with singles": ([(top, top, 1), (top, 0, -1)] * 12
                                     + [(top, None, 1), (0, None, -1)] * 4),
        "all zero": [(0, 0, 1), (0, None, -1), (0, 0, -1)],
    }


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_model_extremes(spec):
    """The widest sums the kernel takes, in every thread split."""
    for label, terms in _extremes(spec.p).items():
        for splits in (1, 2, 4):
            kernel_model(terms, spec, splits)
    biggest = kernel_model(_extremes(spec.p)["32 (p-1) 0, all - (the largest accumulator)"], spec)
    assert biggest["r"] < 2 * spec.p


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_model_seeded_and_both_quotients(spec):
    """Seeded sums of 1-32 terms, plus sums that are exact multiples of p
    (a b + a (p - b) = a p), which reach q3 = floor(S / p) - 1 and the
    final subtraction; random sums reach q3 = floor(S / p) without it."""
    p = spec.p
    rng = np.random.default_rng(21)

    def elem():
        return int.from_bytes(rng.bytes(40), "little") % p
    seen = set()
    for trial in range(60):
        count = 1 + trial % MAX_TERMS
        if trial % 3 == 0:      # pairs a b - a b: S = p sum a exactly
            pairs = [(elem(), elem()) for _ in range(max(1, count // 2))]
            terms = [(a, b, sign) for a, b in pairs for sign in (1, -1)]
        else:
            terms = [(elem(), None if rng.integers(4) == 0 else elem(),
                      1 if rng.integers(2) else -1) for _ in range(count)]
        m = kernel_model(terms, spec, splits=1 + trial % 2)
        seen.add((m["q"] - m["q3"], m["r"] >= p))
    assert seen == {(0, False), (1, True)}


def test_kernel_limits_match_the_wrapper():
    """The limits and flags that field_kernels.cu / field.cuh define equal
    fields/ops.py's and fields/spec.py's."""
    text = (CSRC / "field_kernels.cu").read_text() + (CSRC / "field.cuh").read_text()
    defined = dict(re.findall(r"#define (PS_\w+|PT_MAX_TERMS|PT_MU_SUM_LIMBS) (\d+)", text))
    assert {k: int(v) for k, v in defined.items()} == {
        "PS_MAX_SUMS": fops.PS_MAX_SUMS, "PS_MAX_ENTRIES": fops.PS_MAX_ENTRIES,
        "PS_MAX_SPLITS": fops.PS_MAX_SPLITS, "PS_A_BCAST": fops.PS_A_BCAST,
        "PS_B_BCAST": fops.PS_B_BCAST, "PS_NEG": fops.PS_NEG,
        "PT_MAX_TERMS": MAX_TERMS, "PT_MU_SUM_LIMBS": MU_SUM_LIMBS}
    fill = 1 << 16
    assert [fops._splits(1 << 14, t, fill) for t in (30, 9, 3, 1)] == [4, 4, 4, 1]
    assert fops._splits(2 << 14, 2, fill) == 1
    assert fops._splits(12 << 14, 3, fill) == 1
    assert fops._splits(1 << 17, 30, fill) == 1


def _jax_product_sum(jspec, terms):
    W = jfops.WORK_DB
    return jfops.product_sum(jspec, [
        (a, W, b, W if b is not None else 0, sign) for a, b, sign in terms])


SHAPES = product_sum_shapes()


@pytest.mark.parametrize("index", range(len(SHAPES)),
                         ids=[s[0].split()[1] for s in SHAPES])
def test_prove_shapes_match_jax(index):
    """product_sums (and product_sum for each sum) against the JAX
    package's product_sum on seeded inputs with the shape's term structure
    and broadcast pattern, N = 64, in the prover's scalar field."""
    named = SHAPES[index][4]
    spec, jspec = TWEEDLEDUM_BASE, J_DUM
    p = spec.p
    n = 64
    rng = np.random.default_rng(100 + index)
    edges = [0, 1, p - 1, p - 2]

    def ints(count):
        return edges[:count] + [int.from_bytes(rng.bytes(40), "little") % p
                                for _ in range(count - len(edges[:count]))]
    values = {}
    sums = product_sum_inputs(
        named,
        lambda name: fops.from_ints(spec, values.setdefault(name, ints(n)), "cpu"),
        lambda name: fops.from_ints(spec, values.setdefault(name, ints(1)), "cpu"))
    got = fops.product_sums(spec, sums)
    assert len(got) == len(sums)

    @jax.jit
    def reference(arrays):
        return [_jax_product_sum(jspec, [
            (arrays[a], None if b is None else arrays[b], sign)
            for a, b, sign in terms]) for terms in named]
    want = reference({k: jfops.from_ints(jspec, v) for k, v in values.items()})
    full = {k: v * n if len(v) == 1 else v for k, v in values.items()}
    for g, w, terms, jterms in zip(got, want, sums, named):
        w_ints = [int(v) for v in np.asarray(jfops.to_ints(jspec, w)).reshape(-1)]
        assert [int(v) for v in fops.to_ints(spec, g)] == w_ints
        assert [int(v) for v in fops.to_ints(spec, fops.product_sum(spec, terms))] == w_ints
        # and against python ints
        assert w_ints == [sum(sign * full[a][i] * (1 if b is None else full[b][i])
                              for a, b, sign in jterms) % p for i in range(n)]
