"""Python models, limb by limb, of the carry-chain multiplies in
plonky_tpu_torch/csrc/field.cuh: field_mul's one-reduction Barrett product
(cc_mul_mod, at 8 limbs and at the 12 of BLS12-377's base field) and the
Montgomery product (cc_mont_mul).  Each model forms the same partial sums
in the same windows as the kernel, asserts the bounds the kernel relies on
(no carry leaves a window, the Barrett quotient is floor(x / p) or one
less, the value before the last subtraction is below 2p), and is held
against python's a * b % p on adversarial and random values.  The Barrett
range of each width (fields/spec.py:BARRETT_RANGE) is derived from the
error bound, and a field outside both ranges is refused."""

from fractions import Fraction

import numpy as np
import pytest
import torch

try:   # the property tests need hypothesis; the seeded sweeps do not
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    given = None

from plonky_tpu_torch.fields import (BLS12_377_BASE, BLS12_377_SCALAR,
                                     PALLAS_BASE, TWEEDLEDEE_BASE,
                                     TWEEDLEDUM_BASE, VESTA_BASE)
from plonky_tpu_torch.fields.spec import BARRETT_RANGE, FieldSpec

SPECS = [TWEEDLEDEE_BASE, TWEEDLEDUM_BASE, BLS12_377_BASE, BLS12_377_SCALAR]
B32 = 1 << 32


def _limbs(v: int, n: int):
    assert 0 <= v < B32 ** n, (v, n)
    return [(v >> (32 * k)) & (B32 - 1) for k in range(n)]


def _value(limbs) -> int:
    return sum(int(x) << (32 * k) for k, x in enumerate(limbs))


def _mac_row(acc: int, width: int, x: int, y) -> int:
    """cc_mac_row: acc (a window of `width` = N + 2 limbs) += x * y; the
    kernel drops any carry out of the window, so the sum must fit."""
    out = acc + x * _value(y)
    assert out < B32 ** width, "carry out of a cc_mac_row window"
    return out


def barrett_model(a: int, b: int, spec) -> dict:
    """cc_mul_mod step by step at L = spec.limbs; returns the intermediate
    values."""
    p, mu, nl, nmu = spec.p, spec.barrett_mu, spec.limbs, spec.mu_limbs
    assert nmu == nl + 1 and mu < B32 ** nmu
    mul = _limbs(mu, nmu)
    # x = a b: row i adds a_i b into the window w[i .. i + L + 1]
    al, bl = _limbs(a, nl), _limbs(b, nl)
    x = 0
    for i in range(nl):
        win = x >> (32 * i)
        win = _mac_row(win, nl + 2, al[i], bl)
        x = (x & (B32 ** i - 1)) | (win << (32 * i))
    assert x == a * b and x < B32 ** (2 * nl)
    w = _limbs(x, 2 * nl)
    # u = columns >= L - 1 of q1 mu, q1 = w[L-1 .. 2L-1] (cc_barrett_rows):
    # row i starts at mu limb max(0, L - 1 - i), row L one limb up
    top = nl - 1
    u = 0
    for i in range(nmu):
        j0 = max(0, top - i)
        off = i + j0 - top
        n = nmu - j0
        win = _mac_row(u >> (32 * off), n + 2, w[top + i], mul[j0:])
        u = (u & (B32 ** off - 1)) | (win << (32 * off))
    assert u < B32 ** (nl + 4)
    q3 = (u >> 64) & (B32 ** nl - 1)
    assert u >> (64 + 32 * nl) == 0, f"q3 wider than {nl} limbs"
    # the truncated product equals q1 mu less the skipped columns' terms,
    # which fall below (L - 1) 2^-32 (1 + 2^-31) of a unit of q3
    q1 = x >> (32 * top)
    skipped = sum(w[top + i] * mul[j] << (32 * (i + j))
                  for i in range(nmu) for j in range(nmu) if i + j < top)
    assert (u << (32 * top)) == q1 * mu - skipped
    assert Fraction(skipped, B32 ** (nl + 1)) < Fraction(top, B32) * (1 + Fraction(2, B32))
    # before q3's floor, u / 2^64 falls short of x / p by less than 1
    assert 0 <= (x << 64) - u * p < p << 64
    q = x // p
    assert q - 1 <= q3 <= q, (q, q3)
    # r = x - q3 p mod 2^(32 L) from the low limbs only (cc_barrett_finish)
    v = (q3 * p) % B32 ** nl
    r = (x - v) % B32 ** nl
    assert r == x - q3 * p and r < 2 * p
    out = r - p if r >= p else r
    return {"out": out, "q": q, "q3": q3, "r": r}


def mont_model(a: int, b: int, spec) -> int:
    """cc_mont_mul (and mf_mul's rounds): L rounds of a_i b then m p into
    the window t[i .. i + L + 1]; returns a b 2^(-32 L) mod p."""
    p, nl = spec.p, spec.limbs
    al = _limbs(a, nl)
    t = 0                         # the value of t[i ..] at round i
    for i in range(nl):
        t = _mac_row(t, nl + 2, al[i], _limbs(b, nl))
        m = (t & (B32 - 1)) * spec.p_inv_neg % B32
        t = _mac_row(t, nl + 2, m, _limbs(p, nl))
        assert t % B32 == 0
        t >>= 32
        assert t < 2 * p + 1
    return t - p if t >= p else t


def _edges(p: int):
    return [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2, 1 << 128,
            (1 << 254) % p, ((1 << 255) - 1) % p, p - (1 << 128), B32 - 1]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_barrett_edges_and_both_branches(spec):
    """Every pair of edge values, plus a seeded sweep that must reach both
    outcomes of the quotient (q3 = q and q3 = q - 1) and of the final
    subtraction."""
    p = spec.p
    seen = set()
    vals = _edges(p)
    rng = np.random.default_rng(11)
    pairs = [(a, b) for a in vals for b in vals]
    pairs += [(int.from_bytes(rng.bytes(56), "little") % p,
               int.from_bytes(rng.bytes(56), "little") % p) for _ in range(400)]
    for a, b in pairs:
        m = barrett_model(a, b, spec)
        assert m["out"] == a * b % p
        seen.add((m["q"] - m["q3"], m["r"] >= p))
    assert {0, 1} <= {d for d, _ in seen}
    assert {True, False} <= {s for _, s in seen}


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_montgomery_edges_and_random(spec):
    """Every pair of edge values and a seeded sweep: against a table entry
    w 2^(32 L) mod p, the Montgomery product is a w mod p."""
    p = spec.p
    vals = _edges(p)
    rng = np.random.default_rng(12)
    pairs = [(a, w) for a in vals for w in vals]
    pairs += [(int.from_bytes(rng.bytes(56), "little") % p,
               int.from_bytes(rng.bytes(56), "little") % p) for _ in range(200)]
    for a, w in pairs:
        assert mont_model(a, w * (1 << (32 * spec.limbs)) % p, spec) == a * w % p


if given is not None:
    @pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
    @settings(max_examples=300, deadline=None, database=None)
    @given(data=st.data())
    def test_barrett_model_matches_python(spec, data):
        p = spec.p
        elem = st.one_of(st.sampled_from(_edges(p)), st.integers(0, p - 1),
                         st.integers(p - (1 << 64), p - 1))
        a, b = data.draw(elem), data.draw(elem)
        assert barrett_model(a, b, spec)["out"] == a * b % p

    @pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
    @settings(max_examples=200, deadline=None, database=None)
    @given(data=st.data())
    def test_montgomery_model_matches_python(spec, data):
        """With b = w 2^(32 L) mod p (a twiddle or scale table entry) the
        product is a w mod p exactly."""
        p = spec.p
        elem = st.one_of(st.sampled_from(_edges(p)), st.integers(0, p - 1))
        a, w = data.draw(elem), data.draw(elem)
        assert mont_model(a, w * (1 << (32 * spec.limbs)) % p, spec) == a * w % p


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_mul_consts_layout(spec):
    """mul_consts = kernel_consts (what the point kernels read: p and
    -p^-1 mod 2^32) + mu = floor(2^(64 L) / p) + the product sum's
    floor(2^(32 (2L + 1)) / p): floor(2^512 / p) and floor(2^544 / p) at 8
    limbs."""
    nl = spec.limbs
    assert nl == (12 if spec is BLS12_377_BASE else 8)
    c = spec.mul_consts
    words = nl + 1
    assert c.dtype == np.uint32 and c.shape == (words + (nl + 1) + (nl + 2),)
    assert np.array_equal(c[:words], spec.kernel_consts)
    assert _value(c[:nl]) == spec.p
    assert (int(c[nl]) * spec.p) % B32 == B32 - 1
    assert _value(c[words:words + nl + 1]) == (1 << (64 * nl)) // spec.p
    assert _value(c[words + nl + 1:]) == (1 << (32 * (2 * nl + 1))) // spec.p


def _error_bound(p: int, nl: int) -> Fraction:
    """How far, at most, the kernel's truncated q1 mu / 2^(32 (L + 1)) falls
    short of x / p for x < p^2 (field.cuh, cc_mul_mod): x / 2^(64 L) +
    2^(32 (L - 1)) / p + the skipped columns' (L - 1) 2^-32 (1 + 2^-31)."""
    return (Fraction(p * p, 1 << (64 * nl)) + Fraction(1 << (32 * (nl - 1)), p)
            + Fraction(nl - 1, B32) * (1 + Fraction(2, B32)))


@pytest.mark.parametrize("nl", sorted(BARRETT_RANGE))
def test_barrett_range_keeps_the_error_below_one(nl):
    """Inside BARRETT_RANGE[L] the error bound is below 1 at both ends (it
    is largest there: one term grows with p, the other falls), so the
    quotient is floor(x / p) or one less; the ranges fit the limbs with a
    bit of headroom (a + b of canonical values does not carry out)."""
    lo, hi = BARRETT_RANGE[nl]
    assert hi == 32 * nl - 1
    for p in ((1 << lo) + 1, (1 << hi) - 1):
        assert _error_bound(p, nl) < 1, (nl, p.bit_length())
    # each term alone stays at or below 1/4 over the range
    assert Fraction(1 << (32 * (nl - 1)), 1 << lo) <= Fraction(1, 4)
    assert Fraction(1 << (2 * hi), 1 << (64 * nl)) <= Fraction(1, 4)
    for spec in SPECS:
        if spec.limbs == nl:
            assert (1 << lo) < spec.p < (1 << hi)
            assert _error_bound(spec.p, nl) < Fraction(1, 8)
    # BLS12-377's base field (2^376 < p < 2^377) sits far inside its range
    assert _error_bound(BLS12_377_BASE.p, 12) < Fraction(1, 1 << 14)


def _is_prime(n: int) -> bool:
    """Miller-Rabin with the first twelve primes as bases (deterministic
    far beyond the sizes used here for these inputs' purpose: a test
    modulus, not a proof)."""
    small = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)
    if n < 2 or any(n % q == 0 for q in small):
        return n in small
    d, s = n - 1, 0
    while d % 2 == 0:
        d, s = d // 2, s + 1
    for a in small:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _next_prime(n: int) -> int:
    while not _is_prime(n):
        n += 1
    return n


@pytest.mark.parametrize("p,error", [
    ((1 << 127) - 1, AssertionError),                  # 8 limbs, below 2^226
    (_next_prime(1 << 320), AssertionError),           # 12 limbs, below 2^354
    ((1 << 384) - (1 << 128) - (1 << 96) + (1 << 32) - 1, ValueError),  # P-384
    ((1 << 521) - 1, ValueError),                      # wider than 12 limbs
], ids=["M127", "nextprime(2^320)", "P-384", "M521"])
def test_fields_outside_both_ranges_are_refused(p, error):
    spec = FieldSpec(name="outside", p=p, generator=3, alpha=5, two_adicity=1)
    assert _is_prime(p)
    with pytest.raises(error):
        spec.mul_consts


# ---------------------------------------------------------------------------
# K5's separated Montgomery products (csrc/field.cuh: cc_square, cc_redc,
# cc_mont_sqr, cc_mont_mul_sos; 8 limbs)
# ---------------------------------------------------------------------------

RESCUE_SPECS = [TWEEDLEDEE_BASE, TWEEDLEDUM_BASE, BLS12_377_SCALAR]


def _window_add(limbs, at: int, width: int, add: int) -> int:
    """limbs[at .. at + width - 1] += add as one carry chain; returns the
    chain's carry out (which the kernel puts in a counter)."""
    win = _value(limbs[at:at + width]) + add
    limbs[at:at + width] = _limbs(win % B32 ** width, width)
    return win >> (32 * width)


def _pairs_chain(acc, at: int, x: int, ys) -> None:
    """cc_mac_pairs: acc[at ..] += x y_k 2^(64 k) on one chain, each
    product's halves on a pair of limbs, the carry into acc[at + 2n]; that
    limb has only been reached by carries so far, so it cannot wrap."""
    n = len(ys)
    assert acc[at + 2 * n] < 8
    carry = _window_add(acc, at, 2 * n,
                        sum(x * y << (64 * k) for k, y in enumerate(ys)))
    acc[at + 2 * n] += carry


def _merge(e, o, nl: int = 8) -> int:
    """cc_merge: e + o over limbs 0..2L-1, nothing above."""
    assert o[0] == 0
    total = _value(e) + _value(o)
    assert total < B32 ** (2 * nl)
    return total


def product_model(a: int, b: int, nl: int = 8) -> tuple:
    """cc_product at L = nl limbs: row i's products a_i b_j into e where
    i + j is even, o where it is odd (cc_product_rows: two chains a row of
    L / 2 pairs each); returns (e, o) as values, e + o = a b."""
    al, bl = _limbs(a, nl), _limbs(b, nl)
    e, o = [0] * (2 * nl + 1), [0] * (2 * nl + 1)
    for i in range(nl):
        if i % 2 == 0:
            _pairs_chain(e, i, al[i], bl[0::2])
            _pairs_chain(o, i + 1, al[i], bl[1::2])
        else:
            _pairs_chain(e, i + 1, al[i], bl[1::2])
            _pairs_chain(o, i, al[i], bl[0::2])
    assert o[0] == 0 and _merge(e, o, nl) == a * b
    return _value(e), _value(o)


def square_model(a: int) -> int:
    """cc_square: the cross products a_i a_j (j > i) split as in
    product_model (cc_cross_rows: j = i + 1, i + 3, ... into o at limb
    2 i + 1, j = i + 2, i + 4, ... into e at limb 2 i + 2), merged,
    doubled by a shift, then the diagonal a_i^2 at limb 2 i on one chain."""
    al = _limbs(a, 8)
    e, o = [0] * 17, [0] * 17
    for i in range(7):
        _pairs_chain(o, 2 * i + 1, al[i], al[i + 1::2])
        if i < 6:
            _pairs_chain(e, 2 * i + 2, al[i], al[i + 2::2])
    t = _merge(e, o)
    assert t == sum(al[i] * al[j] << (32 * (i + j))
                    for i in range(8) for j in range(i + 1, 8))
    assert t < 1 << 511                 # the shift drops no bit
    t = (t << 1) + sum(al[i] * al[i] << (64 * i) for i in range(8))
    assert t < B32 ** 16                # the diagonal chain's carry out is 0
    return t


def redc_model(t: int, spec, sparse: bool, o_value: int = 0) -> dict:
    """cc_redc limb by limb over T = e + o (e holds t, o o_value): row I
    folds limb I (e[I] + o[I] + cnt[I], overflow into cnt[I + 1]), takes
    m, and adds m p's products on pairs of limbs of the accumulator of
    their parity (y: that of I, x: the other), the chains' carries into
    the counters cnt; then limbs 8..15 of e + o + the counters (+ the
    sparse rows' deferred m 2^254 terms).  Returns r (not yet canonical),
    the m of each row and each row's limb products.  At the field's width
    L: 8 limbs, or 12 (dense rows only: the 12-limb point kernels' mf_mul
    over BLS12-377's base field)."""
    p, nl = spec.p, spec.limbs
    assert (nl == 8 or not sparse) and t + o_value < B32 ** (2 * nl)
    acc = {"e": _limbs(t, 2 * nl + 1), "o": _limbs(o_value, 2 * nl + 1)}
    cnt = [0] * (2 * nl + 1)
    pl = _limbs(p, nl)
    total = t + o_value
    ms, products = [], []
    for i in range(nl):
        y, x = (acc["e"], acc["o"]) if i % 2 == 0 else (acc["o"], acc["e"])
        s = y[i] + x[i] + cnt[i]                   # limb I, exact
        x[i] = y[i] = cnt[i] = 0
        cnt[i + 1] += s >> 32
        s %= B32
        m = s * spec.p_inv_neg % B32
        if sparse:
            assert spec.p_inv_neg == B32 - 1 and m == -s % B32
            assert pl[0] == 1 and pl[4:7] == [0, 0, 0] and pl[7] == 1 << 30
            carry_in = (s + m) >> 32               # limb I + m p_0
            assert (s + m) % B32 == 0
            cnt[i + 5] += _window_add(x, i + 1, 4, carry_in + (m * pl[1] << 0)
                                      + (m * pl[3] << 64))
            cnt[i + 4] += _window_add(y, i + 2, 2, m * pl[2])
            if i == 0:                             # m_0 2^254's part in limb 7
                cnt[8] += _window_add(acc["o"], 7, 1, (m << 30) % B32)
            products.append(3)
        else:
            y[i] = s
            cnt[i + nl] += _window_add(y, i, nl, sum(m * pl[k] << (32 * k)
                                                     for k in range(0, nl, 2)))
            assert y[i] == 0
            cnt[i + nl + 1] += _window_add(x, i + 1, nl, sum(
                m * pl[k] << (32 * (k - 1)) for k in range(1, nl, 2)))
            products.append(nl)
        assert max(cnt) < 8
        ms.append(m)
        # the sparse rows' m 2^254 terms wait for the end, but m_0's low
        # part (in limb 7, read by row 7)
        deferred = (sum(mj << (32 * j) for j, mj in enumerate(ms)) << 254
                    if sparse else 0) - (ms[0] << 254) % B32 ** 8 * sparse
        value = (_value(acc["e"]) + _value(acc["o"])
                 + sum(c << (32 * k) for k, c in enumerate(cnt)) + deferred)
        assert value == total + sum(mj * p << (32 * j) for j, mj in enumerate(ms))
    top = sum((acc["e"][k] + acc["o"][k] + cnt[k]) << (32 * (k - nl))
              for k in range(nl, 2 * nl + 1))
    if sparse:     # + M 2^30's limbs 1 .. 8: funnel shifts of m pairs
        mm = ms + [0]
        top += sum(((mm[k] >> 2) | (mm[k + 1] << 30)) % B32 << (32 * k)
                   for k in range(8))
    assert top < B32 ** nl, "the result leaves 32 L bits"
    r = top % B32 ** nl
    big_r = B32 ** nl
    assert _value(ms) < big_r and r == (total + _value(ms) * p) >> (32 * nl)
    # r < floor(T / R) + p, but where T mod R is a non-zero multiple k p of
    # p: there M = R - k and r = floor(T / R) + p (the lazy NTT's inputs
    # reach that case, canonical ones never do)
    low = total % big_r
    if low and low % p == 0:
        assert _value(ms) == big_r - low // p and r == total // big_r + p
    else:
        assert r < total // big_r + p
    return {"r": r, "m": ms, "products": products}


def _mont_inputs(p: int, rng, n: int):
    """What K5's products take: canonical values (the state, the MDS
    entries) and the lazy chain's values below 2p: the edges, 2p - 1 and
    p + 1, and a seeded sweep below 2p."""
    return _edges(p) + [2 * p - 1, p + 1] + [
        int.from_bytes(rng.bytes(40), "little") % (2 * p) for _ in range(n)]


@pytest.mark.parametrize("spec", RESCUE_SPECS, ids=lambda s: s.name)
def test_mont_sqr_model_matches_python(spec):
    """cc_mont_sqr = cc_square + cc_redc, lazy: a^2 2^-256 (mod p), below
    2p, at 0, 1, p - 1, the other edges and random values below 2p, by the
    field's REDC (sparse where fields/chain.py:sparse_prime); one
    conditional subtraction makes it canonical."""
    from plonky_tpu_torch.hashing.rescue import sparse_prime
    p = spec.p
    r_inv = pow(1 << 256, -1, p)
    for a in _mont_inputs(p, np.random.default_rng(21), 300):
        t = square_model(a)
        assert t == a * a
        m = redc_model(t, spec, sparse_prime(spec))
        assert m["r"] < 2 * p
        assert (m["r"] - p if m["r"] >= p else m["r"]) == a * a * r_inv % p


@pytest.mark.parametrize("spec", RESCUE_SPECS, ids=lambda s: s.name)
def test_lazy_chains_stay_below_2p(spec):
    """fields/chain.py:lazy_chain_bound is the REDC's own bound applied
    step by step (r <= (T + (2^256 - 1) p) / 2^256, T below the square of
    the last bound), it stays at most 2p over 10^4 products on every
    field K5 runs (its chains take ~320) and over K5's chains, which
    kernel_consts checks; a field just below 2^255 leaves 2p within a few
    products and is refused."""
    from plonky_tpu_torch.fields.host import kth_root_exponent
    from plonky_tpu_torch.hashing import rescue as hr
    p = spec.p
    r_big = 1 << 256
    b = p
    for n in range(1, 6):
        worst = redc_model((b - 1) ** 2, spec, False)["r"]
        b = ((b - 1) ** 2 + (r_big - 1) * p) // r_big + 1
        assert hr.lazy_chain_bound(p, n) == b and worst < b <= 2 * p
    assert hr.lazy_chain_bound(p, 10_000) <= 2 * p
    e = kth_root_exponent(spec, spec.alpha)
    chain = hr.kernel_schedule(e)
    assert hr.lazy_chain_bound(p, sum(hr.schedule_counts(chain))) <= 2 * p
    big = (1 << 255) - 19
    assert hr.lazy_chain_bound(big, 4) > 2 * big


@pytest.mark.parametrize("spec", RESCUE_SPECS, ids=lambda s: s.name)
def test_redc_rows_sparse_and_dense(spec):
    """cc_product's model on pairs of values below 2p, and both kinds of
    REDC row on their products (cc_mont_mul_sos; the result within the
    REDC's bound, below 2p from canonical
    values) and on the MDS mix's sum of four canonical products (below
    4 p^2: the result below 4 p^2 / 2^256 + p, under 3p and 2^256): the
    dense rows on every field,
    the sparse ones on the 2^254 + c fields, the same r; every counter
    small, every row's carries kept."""
    from plonky_tpu_torch.hashing.rescue import sparse_prime
    p = spec.p
    r_inv = pow(1 << 256, -1, p)
    rng = np.random.default_rng(22)
    vals = _mont_inputs(p, rng, 40)
    kinds = (False, True) if sparse_prime(spec) else (False,)
    pairs = [(a, b) for a in vals[:12] for b in vals[:12]]
    pairs += [(vals[rng.integers(len(vals))], vals[rng.integers(len(vals))])
              for _ in range(200)]
    for a, b in pairs:
        e, o = product_model(a, b)
        for sparse in kinds:
            r = redc_model(e, spec, sparse, o)["r"]
            assert r % p == a * b * r_inv % p
            assert r <= (a * b + ((1 << 256) - 1) * p) >> 256
            assert r < 2 * p or max(a, b) >= p
    for _ in range(100):
        xs = [vals[rng.integers(len(vals))] % p for _ in range(8)]
        total = sum(xs[c] * xs[4 + c] for c in range(4))
        for sparse in kinds:
            r = redc_model(total, spec, sparse)["r"]
            assert r < 3 * p and r % p == total * r_inv % p
    worst = redc_model(4 * (p - 1) ** 2, spec, False)["r"]
    assert worst < 3 * p


@pytest.mark.parametrize("spec", RESCUE_SPECS, ids=lambda s: s.name)
def test_sparse_redc_shape_and_counts(spec):
    """sparse_prime holds exactly for the 2^254 + c fields (limbs [1, c1,
    c2, c3, 0, 0, 0, 2^30]); there -p^-1 mod 2^32 = 0xffffffff, so each
    row's m is -limb_I; -p^-1 p_0 + 1 is 0 mod 2^32 on every field (the
    zero cc_redc's sparse rows multiply the top limb by); each sparse row
    takes 3 limb products and each
    dense one 8, as chip_smoke.py's bounds count them (48 and 136 IMAD
    slots a reduction with the dense rows' low-half multiplies)."""
    from chip_smoke import REDC_OPS, SPARSE_REDC_OPS, WIDE
    from plonky_tpu_torch.hashing.rescue import sparse_prime
    p = spec.p
    pl = _limbs(p, 8)
    shape = pl[0] == 1 and pl[4:7] == [0, 0, 0] and pl[7] == 1 << 30
    assert sparse_prime(spec) == shape == (spec is not BLS12_377_SCALAR)
    if shape:
        assert spec.p_inv_neg == 0xFFFFFFFF
    # the sparse REDC's row 0 waits for the product's top limb through a
    # product with -p^-1 p_0 + 1, a zero the compiler cannot see
    assert (spec.p_inv_neg * pl[0] + 1) % B32 == 0
    t = (p - 1) * (p - 2)
    for sparse in ((False, True) if shape else (False,)):
        m = redc_model(t, spec, sparse)
        if sparse:
            assert m["m"][0] == -(t % B32) % B32
            assert sum(m["products"]) * WIDE == SPARSE_REDC_OPS == 48
        else:
            assert sum(m["products"]) * WIDE + 8 == REDC_OPS == 136


def test_mont_product_at_12_limbs():
    """The 12-limb point kernels' mf_mul (field.cuh): cc_product's pairs
    at 12 limbs, the 12 dense REDC rows and one conditional subtraction
    give a b 2^-384 mod p on BLS12-377's base field, at the edges, at
    values just below p and at random; every counter small, the value
    before the subtraction below 2p.  (The field's p = 1 mod 2^46, so p_0 =
    1 and -p^-1 = 2^32 - 1 mod 2^32; the dense rows do not rely on it.)"""
    spec = BLS12_377_BASE
    p, nl = spec.p, spec.limbs
    assert nl == 12 and p % (1 << 46) == 1 and spec.p_inv_neg == B32 - 1
    r_inv = pow(1 << 384, -1, p)
    rng = np.random.default_rng(12)
    vals = _edges(p) + [p - 1 - int(v) for v in rng.integers(0, 1 << 40, 6)] + [
        int.from_bytes(rng.bytes(56), "little") % p for _ in range(40)]
    pairs = [(a, b) for a in vals[:14] for b in vals[:14]]
    pairs += [(vals[rng.integers(len(vals))], vals[rng.integers(len(vals))])
              for _ in range(150)]
    for a, b in pairs:
        e, o = product_model(a, b, nl)
        m = redc_model(e, spec, False, o)
        assert m["r"] < 2 * p and m["products"] == [nl] * nl
        r = m["r"] - p if m["r"] >= p else m["r"]
        assert r == a * b * r_inv % p


POINT_SPECS = [TWEEDLEDEE_BASE, TWEEDLEDUM_BASE, PALLAS_BASE, VESTA_BASE]


@pytest.mark.parametrize("spec", POINT_SPECS, ids=lambda s: s.name)
def test_point_product_at_8_limbs(spec):
    """The 8-limb point kernels' mf_mul (field.cuh: cc_product, the sparse
    cc_redc rows, cc_csub) and mf_sqr (cc_square instead of the product)
    give a b 2^-256 mod p, canonical, on every sparse base field of the
    port's 8-limb curves, for the edge operands 0, 1, p - 1 and R mod p
    (and the rest of _edges) pairwise and for seeded values below p; the
    value before the subtraction below 2p, three limb products a row."""
    from plonky_tpu_torch.fields.chain import sparse_prime
    p = spec.p
    assert spec.limbs == 8 and sparse_prime(spec)
    r_inv = pow(1 << 256, -1, p)
    rng = np.random.default_rng(16)
    vals = [(1 << 256) % p] + _edges(p) + [
        int.from_bytes(rng.bytes(40), "little") % p for _ in range(30)]
    pairs = [(a, b) for a in vals[:14] for b in vals[:14]]
    pairs += [(vals[rng.integers(len(vals))], vals[rng.integers(len(vals))])
              for _ in range(150)]
    for a, b in pairs:
        e, o = product_model(a, b)
        m = redc_model(e, spec, True, o)
        assert m["r"] < 2 * p and m["products"] == [3] * 8
        r = m["r"] - p if m["r"] >= p else m["r"]
        assert r == a * b * r_inv % p
    for a in vals:
        m = redc_model(square_model(a), spec, True)
        assert m["r"] < 2 * p
        assert (m["r"] - p if m["r"] >= p else m["r"]) == a * a * r_inv % p


def test_point_kernels_take_sparse_base_fields():
    """Every 8-limb curve of the port has a base field of the sparse shape
    (fields/chain.py:sparse_prime), which the 8-limb point kernels' product
    needs; precompute_base and the point kernels' constants refuse a
    made-up 8-limb curve over a field without it (BLS12-377's scalar
    field), and take BLS12-377 G1 (12 limbs, the dense rows)."""
    import dataclasses

    from plonky_tpu_torch.curves import ALL_CURVES, BLS12_377
    from plonky_tpu_torch.curves import msm as cmsm
    from plonky_tpu_torch.curves import ops as cops
    from plonky_tpu_torch.fields.chain import sparse_prime
    eight = [c for c in ALL_CURVES if c.base.limbs == 8]
    assert sorted(c.name for c in eight) == ["Pallas", "Tweedledee", "Tweedledum", "Vesta"]
    assert all(sparse_prime(c.base) for c in eight)
    for c in ALL_CURVES:
        cops.require_sparse_base(c, "test")
        assert len(cops._consts_host(c)) == 1 + 3 * c.base.limbs
    dense = dataclasses.replace(BLS12_377, name="Dense8", base=BLS12_377_SCALAR)
    assert dense.base.limbs == 8 and not sparse_prime(dense.base)
    pts = tuple(torch.zeros((8, 4), dtype=torch.int32) for _ in range(3))
    with pytest.raises(ValueError, match="2\\^254 \\+ c"):
        cmsm.precompute_base(dense, pts)
    with pytest.raises(ValueError, match="2\\^254 \\+ c"):
        cops._consts_host(dense)


if given is not None:
    @pytest.mark.parametrize("spec", RESCUE_SPECS, ids=lambda s: s.name)
    @settings(max_examples=200, deadline=None, database=None)
    @given(data=st.data())
    def test_mont_sqr_and_mul_sos_models_match_python(spec, data):
        from plonky_tpu_torch.hashing.rescue import sparse_prime
        p = spec.p
        elem = st.one_of(st.sampled_from(_edges(p)), st.integers(0, p - 1),
                         st.integers(p - (1 << 64), p - 1))
        a, b = data.draw(elem), data.draw(elem)
        r_inv = pow(1 << 256, -1, p)
        for (t, o), want in (((square_model(a), 0), a * a),
                             (product_model(a, b), a * b)):
            assert t + o == want
            r = redc_model(t, spec, sparse_prime(spec), o)["r"]
            assert r < 2 * p and r % p == want * r_inv % p
