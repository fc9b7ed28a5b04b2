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

try:   # the property tests need hypothesis; the seeded sweeps do not
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    given = None

from plonky_tpu_torch.fields import (BLS12_377_BASE, BLS12_377_SCALAR,
                                     TWEEDLEDEE_BASE, TWEEDLEDUM_BASE)
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
