"""K1's product sum (field_product_sum) on the CPU.

A Python model, limb by limb, of the kernel's accumulate-and-reduce
(plonky_tpu_torch/csrc/field.cuh: cc_acc_product, cc_acc_single,
cc_acc_fold, cc_sum_mod; field_kernels.cu: the split of a sum's terms among
threads) at L limbs: it forms the same chains, counters and windows as the
kernel, asserts every bound the kernel relies on, and is held against
python's sum % p at the extremes of the widest sum and on seeded sums, for
both Tweedle fields (8 limbs) and BLS12-377's base field (12 limbs),
reaching both outcomes of the Barrett quotient.  Then the
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
from plonky_tpu_torch.fields import (BLS12_377_BASE, TWEEDLEDEE_BASE,
                                     TWEEDLEDUM_BASE)
from plonky_tpu_torch.fields import ops as fops
from plonky_tpu_torch.fields.spec import MAX_TERMS, mu_sum_limbs

torch.set_num_threads(1)

SPECS = [TWEEDLEDEE_BASE, TWEEDLEDUM_BASE, BLS12_377_BASE]
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


def accumulate(terms, p: int, nl: int):
    """cc_acc_product / cc_acc_single over terms (a, b or None, sign) of
    canonical ints at L = nl limbs: returns (acc[0..2L-1], cnt[0..L],
    S)."""
    acc, cnt = [0] * (2 * nl), [0] * (nl + 1)
    total = 0
    for a, b, sign in terms:
        if b is None:
            z = p - a if sign < 0 else a              # cc_negate
            cnt[0] += _chain(acc, 0, nl, z)
            total += z
            continue
        y = p - b if sign < 0 else b                  # cc_negate
        assert y <= p
        xl, yl = _limbs(a, nl), _limbs(y, nl)
        for i in range(nl):                           # cc_acc_row<i>
            prods = [xl[i] * yk for yk in yl]
            lo = sum((pr & M32) << (32 * k) for k, pr in enumerate(prods))
            hi = sum((pr >> 32) << (32 * k) for k, pr in enumerate(prods))
            cnt[i] += _chain(acc, i, nl, lo)          # carry into limb i + L
            cnt[i + 1] += _chain(acc, i + 1, nl, hi)  # into limb i + L + 1
        total += a * y
    # acc plus the counted carries is the sum exactly
    assert _value(acc) + sum(c << (32 * (nl + k)) for k, c in enumerate(cnt)) == total
    assert max(cnt) <= 2 * len(terms) <= 2 * MAX_TERMS
    return acc, cnt, total


def fold(acc, cnt) -> list:
    """cc_acc_fold: the 2L + 1 limbs of acc + the counters (no carry
    out)."""
    nl = len(cnt) - 1
    hi = _value(acc[nl:]) + _value(cnt)
    assert hi < B32 ** (nl + 1)
    return acc[:nl] + _limbs(hi, nl + 1)


def reduce_model(s, spec) -> dict:
    """cc_sum_mod on the 2L + 1 limbs s: q1 = s[L-1..2L], the rows of q1
    mu from mu limb L - i up (row L + 1 one limb up) into u = columns
    L..2L+4, q3's low limbs = u[2..L+1], r = (x - q3 p) mod 2^(32 L), one
    conditional subtraction.  At 8 limbs: q1 = s[7..16], u = columns
    8..20, r mod 2^256."""
    p, mu, nl = spec.p, spec.sum_mu, spec.limbs
    nm = mu_sum_limbs(nl)
    assert nm == spec.mu_sum_limbs and mu < B32 ** nm
    x = _value(s)
    assert x < 32 * p * p < 1 << (64 * nl + 3)        # 2^515 at 8 limbs
    mul = _limbs(mu, nm)
    u = 0
    for i in range(nl + 2):                           # cc_sum_rows<i>
        j0 = max(0, nl - i)
        off = max(0, i + j0 - nl)
        width = (nm - j0) + 2                         # cc_mac_row<N> window
        assert width == (i + 2 if i <= nl else nm) + 2
        win = (u >> (32 * off)) + s[nl - 1 + i] * _value(mul[j0:]) * (
            B32 ** (i + j0 - nl - off))
        assert win < B32 ** width, "carry out of a cc_mac_row window"
        u = (u & (B32 ** off - 1)) | (win << (32 * off))
    assert u < B32 ** (nl + 5)                        # u[0 .. L+4]
    # the truncated product is q1 mu less the skipped columns 0..L-1
    q1 = x >> (32 * (nl - 1))
    skipped = sum(s[nl - 1 + i] * mul[j] << (32 * (i + j))
                  for i in range(nl + 2) for j in range(nm) if i + j < nl)
    assert skipped < nl * (1 << (32 * (nl + 1))) * (1 + 2 ** -31)
    assert u << (32 * nl) == q1 * mu - skipped
    # before q3's floor, u / 2^64 falls short of x / p by less than 1
    assert 0 <= (x << 64) - u * p < p << 64
    q3_full = u >> 64
    q = x // p
    assert q - 1 <= q3_full <= q, (q, q3_full)
    q3 = q3_full & (B32 ** nl - 1)                    # u[2..L+1]
    v = q3 * p % B32 ** nl                            # cc_barrett_finish
    r = (x - v) % B32 ** nl
    assert r == x - q3_full * p and r < 2 * p
    return {"out": r - p if r >= p else r, "q": q, "q3": q3_full, "r": r}


def kernel_model(terms, spec, splits: int = 1) -> dict:
    """The whole kernel for one element: thread group g of `splits` takes
    terms g, g + splits, ...; the groups' folded sums are added over 2L + 1
    limbs (cc_add_acc), then reduced once."""
    nl = spec.limbs
    parts = [fold(*accumulate(terms[g::splits], spec.p, nl)[:2])
             for g in range(splits)]
    total = sum(_value(s) for s in parts)
    assert total < B32 ** (2 * nl + 1)
    m = reduce_model(_limbs(total, 2 * nl + 1), spec)
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
        return int.from_bytes(rng.bytes(4 * spec.limbs + 8), "little") % p
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
    fields/ops.py's and fields/spec.py's (the product sum's Barrett factor
    takes L + 2 limbs at either width)."""
    text = (CSRC / "field_kernels.cu").read_text() + (CSRC / "field.cuh").read_text()
    defined = dict(re.findall(r"#define (PS_\w+|PT_MAX_TERMS) (\d+)", text))
    assert {k: int(v) for k, v in defined.items()} == {
        "PS_MAX_SUMS": fops.PS_MAX_SUMS, "PS_MAX_ENTRIES": fops.PS_MAX_ENTRIES,
        "PS_MAX_SPLITS": fops.PS_MAX_SPLITS, "PS_A_BCAST": fops.PS_A_BCAST,
        "PS_B_BCAST": fops.PS_B_BCAST, "PS_NEG": fops.PS_NEG,
        "PT_MAX_TERMS": MAX_TERMS}
    assert "#define PT_MU_SUM_LIMBS (PT_LIMBS + 2)" in text
    assert [mu_sum_limbs(nl) for nl in (8, 12)] == [10, 14]
    assert [s.mu_sum_limbs for s in SPECS] == [10, 10, 14]
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
