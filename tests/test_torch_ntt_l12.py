"""The 12-limb NTT kernel's lazy arithmetic (plonky_tpu_torch/csrc/
ntt_kernels.cu, its 12-limb section) on the CPU, over BLS12-377's base
field Fq (p < 2^377, R = 2^384).

Limb-level models of what ntt_pass_l12 computes: its products (the pair
layout and dense REDC, tests/test_torch_barrett.py's product_model and
redc_model, with no conditional subtraction), its butterfly (e + t,
e + (2p - t) on carry chains with no correction) and its last store
(the scale product and one conditional subtraction, or ntt_canonical's
quotient from the top limb).  They show, at worst-case inputs on every
layer up to the largest transform the kernel takes, that no chain
overflows 384 bits, that every value after layer ell is below
2p (ell + 2), and that the last store is canonical; then a model of whole
transforms walked as the kernel walks them (poly/fft.py:_pass_groups,
_twiddle_index), which equals ntt_plain and so the canonical transform.
"""

import numpy as np
import pytest
import torch

from plonky_tpu_torch.fields import BLS12_377_BASE, TWEEDLEDUM_BASE
from plonky_tpu_torch.fields import ops as fops
from plonky_tpu_torch.fields.spec import FieldSpec
from plonky_tpu_torch.poly import fft as pfft
from test_torch_barrett import _limbs, product_model, redc_model

torch.set_num_threads(1)

FQ = BLS12_377_BASE
P = FQ.p
NL = 12
R = 1 << 384
B32 = 1 << 32
TOP = P >> 352                       # p's top limb


def mont_lazy(a: int, w: int) -> int:
    """cc_mont_mul_sos<false> at 12 limbs: a w / R mod p, not reduced;
    below a w / R + p, so below 2p for a < R and w < p."""
    e, o = product_model(a, w, NL)
    r = redc_model(e, FQ, False, o)["r"]
    assert r % P == a * w * pow(R, -1, P) % P
    assert r * R < a * w + P * R
    return r


def add_wide(a: int, b: int) -> int:
    """cc_add_wide: one chain over 12 limbs whose carry out is dropped."""
    _limbs(a, NL), _limbs(b, NL)
    assert a + b < R, "carry out of a 384-bit add"
    return a + b


def sub_wide(a: int, b: int) -> int:
    """cc_sub_wide: one chain whose borrow out is dropped."""
    assert 0 <= b <= a < R, "borrow out of a 384-bit subtract"
    return a - b


def butterfly(e: int, t: int) -> tuple:
    """ntt_butterfly: (e + t, e + (2p - t)) for t below 2p."""
    assert t < 2 * P
    return add_wide(e, t), add_wide(e, sub_wide(2 * P, t))


def csub(v: int) -> int:
    """cc_csub: v < 2p -> v mod p."""
    assert v < 2 * P
    return v - P if v >= P else v


def canonical(v: int) -> int:
    """ntt_canonical: q = floor(v_11 / (p_11 + 1)), q p on one row of
    limb products mod 2^384 (cc_mac_row_lo), v - q p below 2p, then one
    conditional subtraction."""
    _limbs(v, NL)
    q = (v >> 352) // (TOP + 1)
    assert q * P < R and q * P <= v
    r = sub_wide(v, q * P)
    return csub(r)


def last_store(v: int, scale=None) -> int:
    """The last pass's store: the scale product and cc_csub, or
    ntt_canonical."""
    return canonical(v) if scale is None else csub(mont_lazy(v, scale))


def bound(ell: int) -> int:
    """Every value below this after layer ell (inputs: ell = -1)."""
    return 2 * P * (ell + 2)


MAX_LG = max(lg for lg in range(200) if pfft.lazy_ntt_fits(FQ, lg))


def test_lazy_fit_limits():
    """lazy_ntt_fits against the model's bounds: Fq takes every transform
    up to 2^75 points (beyond its two-adicity of 46), and at each the last
    bound 2p (lg + 1) fits 384 bits (the tests below run the model on every
    such layer and size); one more layer is refused.  A 12-limb field just
    below 2^383, whose first layer's bound 4p leaves 384 bits, is refused,
    and so is one with a top limb below 2^17, where the excess of
    ntt_canonical's quotient error over 1, below (2 lg + 3) / p_11, is not
    bounded below 1 for every size; every 8-limb field fits (that kernel reduces
    every value)."""
    assert MAX_LG == 75 and FQ.two_adicity <= MAX_LG
    assert bound(MAX_LG - 1) <= R
    assert not pfft.lazy_ntt_fits(FQ, MAX_LG + 1)
    wide = FieldSpec(name="wide", p=(1 << 383) - 187, generator=3, alpha=5,
                     two_adicity=1)
    assert wide.limbs == NL and 4 * wide.p > R and not pfft.lazy_ntt_fits(wide, 1)
    small = FieldSpec(name="small", p=(1 << 360) + 7, generator=3, alpha=5,
                      two_adicity=1)
    assert small.limbs == NL and not pfft.lazy_ntt_fits(small, 1)
    assert pfft.lazy_ntt_fits(TWEEDLEDUM_BASE, 60)


def _worst(b: int, rng) -> list:
    """Values below the bound b: its ends, the edges of 2p and p, random."""
    return sorted({0, 1, P - 1, P, 2 * P - 1, b - 1, b - 2, b - P}
                  | {int(v) % b for v in rng.integers(0, 1 << 62, 3)}
                  | {int.from_bytes(rng.bytes(48), "little") % b})


def test_butterfly_bound_on_every_layer():
    """On every layer of the largest transform, at the bound's worst
    inputs: the twiddle product (below 2p, where w < p: twiddles are held
    canonical, w 2^384 mod p) and both sums fit 384 bits, and both outputs
    stay below the next layer's bound; on layer 0 the odd value is the
    input itself, below 2p."""
    rng = np.random.default_rng(15)
    twiddles = [1, P - 1, R % P, int.from_bytes(rng.bytes(48), "little") % P]
    for ell in range(MAX_LG):
        b = bound(ell - 1)
        for e in (0, b - 1):
            for o in _worst(2 * P if ell == 0 else b, rng)[-3:] + [0]:
                ts = [o] if ell == 0 else [mont_lazy(o, w) for w in twiddles]
                for t in ts:
                    hi, lo = butterfly(e, t)
                    assert hi < bound(ell) and lo < bound(ell)
                    assert (hi - e - t) % P == 0 and (lo - e + t) % P == 0


def test_last_store_is_canonical():
    """The last store from any value below 2p (lg + 1), for every lg the
    kernel takes: ntt_canonical (the quotient at most floor(v / p), v - q p
    below 2p) and the scale product with its conditional subtraction."""
    rng = np.random.default_rng(16)
    scales = [1, P - 1, int.from_bytes(rng.bytes(48), "little") % P]
    r_inv = pow(R, -1, P)
    for lg in range(1, MAX_LG + 1):
        b = bound(lg - 1)
        values = _worst(b, rng) + [k * P - 1 for k in range(1, 2 * lg + 3)]
        for v in values:
            assert last_store(v) == v % P
        for v in values[-4:]:
            for sc in scales:
                assert last_store(v, sc) == v * sc * r_inv % P


def _ints(t: torch.Tensor) -> list:
    return [int(v) for v in fops.to_ints(FQ, t.reshape(NL, -1))]


def kernel_model(pre, rows, inverse, shift, max_layers=None):
    """ntt_pass_l12's transform of python-int rows, pass by pass as the
    kernel walks it (the width's plan unless max_layers is given): the
    groups of each pass, the coset product on the first pass's load, lazy
    butterflies on Montgomery twiddles, the last pass's store; every value
    checked against the bound of its layer."""
    n, lg = pre.n, pre.lg_n
    tw = _ints(pre.twiddles("cpu", inverse, montgomery=True))
    coset = (_ints(pre.coset_powers("cpu", shift, montgomery=True))
             if shift is not None and not inverse else None)
    post = _ints(pre.inverse_scale("cpu", shift, montgomery=True)) if inverse else None
    plan = pfft.pass_plan(lg, max_layers, limbs=NL)
    out = []
    for row in rows:
        y = list(row)
        for i, (l0, kp) in enumerate(plan):
            src, dst = (t.tolist() for t in pfft._pass_groups(lg, l0, kp, "cpu"))
            v = [[y[k] for k in grp] for grp in src]
            if i == 0 and coset is not None:
                v = [[mont_lazy(x, coset[k]) for x, k in zip(vs, grp)]
                     for vs, grp in zip(v, src)]
            assert max(map(max, v)) < bound(l0 - 1)
            for d in range(kp):
                se, so, j = (t.tolist() for t in pfft._twiddle_index(
                    l0, d, len(src), len(src[0]), "cpu"))
                m = 1 << (l0 + d)
                for r, vs in enumerate(v):
                    for b, (a, c) in enumerate(zip(se, so)):
                        t = vs[c] if m == 1 else mont_lazy(vs[c], tw[m - 1 + j[r][b]])
                        vs[a], vs[c] = butterfly(vs[a], t)
                assert max(map(max, v)) < bound(l0 + d)
            if i == len(plan) - 1:
                v = [[last_store(x, None if post is None else
                                 post[0 if len(post) == 1 else k])
                      for x, k in zip(vs, grp)] for vs, grp in zip(v, dst)]
            y = [0] * n
            for vs, grp in zip(v, dst):
                for x, k in zip(vs, grp):
                    y[k] = x
        out.append(y)
    return out


@pytest.mark.parametrize("max_layers", [None, 2])
def test_lazy_transform_equals_ntt_plain(max_layers):
    """The kernel's lazy transform of a batch of 2 at n = 2^6, the four
    kinds, with the 12-limb plan (one pass) and with passes of at most 2
    layers forced (the first, middle and last pass apart): equal to
    ntt_plain, the canonical transform, on every value."""
    n = 64
    rng = np.random.default_rng(17)
    rows = [[int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]
            for _ in range(2)]
    rows[0][:3] = [P - 1, P - 1, 0]
    pre = pfft.FftPrecomputation(FQ, n)
    x = torch.stack([fops.from_ints(FQ, r, "cpu") for r in rows], dim=1)
    for inverse in (False, True):
        for shift in (None, FQ.generator):
            got = kernel_model(pre, rows, inverse, shift, max_layers)
            want = pfft.ntt_plain(pre, x, inverse, shift, max_layers)
            assert got == [_ints(want[:, k]) for k in range(2)], (inverse, shift)


@pytest.mark.parametrize("spec", [TWEEDLEDUM_BASE, FQ], ids=lambda s: s.name)
def test_coset_tables_built_on_the_device_equal_the_host_loop(spec):
    """FftPrecomputation's coset and inverse-coset tables, built by K1
    (powers_dyn, then the scale's product; the plain versions here), equal
    the host loop they replaced (scale base^i mod p, i < n), in both
    forms, at both widths."""
    p = spec.p
    r = pow(2, 32 * spec.limbs, p)
    for n in (1, 2, 64):
        pre = pfft.FftPrecomputation(spec, n)
        shift = spec.generator
        tables = ((pre.coset_powers, (shift,), shift, 1),
                  (pre.inverse_scale, (shift,), pow(shift, -1, p), pre.n_inv))
        for make, args, base, scale in tables:
            want, cur = [], scale
            for _ in range(n):
                want.append(cur)
                cur = cur * base % p
            for mont in (False, True):
                got = [int(v) for v in fops.to_ints(spec, make("cpu", *args, montgomery=mont))
                       .reshape(-1)]
                assert got == [w * r % p if mont else w for w in want]
