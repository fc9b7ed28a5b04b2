"""Python models, limb by limb, of the carry-chain multiplies in
plonky_tpu_torch/csrc/field.cuh: field_mul's one-reduction Barrett product
(cc_mul_mod) and the NTT's unrolled Montgomery product (cc_mont_mul).  Each
model forms the same partial sums in the same windows as the kernel,
asserts the bounds the kernel relies on (no carry leaves a window, the
Barrett quotient is floor(x / p) or one less, the value before the last
subtraction is below 2p), and is held against python's a * b % p on
adversarial and random values."""

import numpy as np
import pytest

try:   # the property tests need hypothesis; the seeded sweeps do not
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    given = None

from plonky_tpu_torch.fields import TWEEDLEDEE_BASE, TWEEDLEDUM_BASE
from plonky_tpu_torch.fields.spec import LIMBS, MU_LIMBS, MU_SUM_LIMBS

SPECS = [TWEEDLEDEE_BASE, TWEEDLEDUM_BASE]
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
    """cc_mul_mod step by step; returns the intermediate values."""
    p, mu = spec.p, spec.barrett_mu
    assert mu < B32 ** MU_LIMBS
    mul = _limbs(mu, MU_LIMBS)
    # x = a b: row i adds a_i b into the window w[i .. i + 9]
    al, bl = _limbs(a, LIMBS), _limbs(b, LIMBS)
    x = 0
    for i in range(LIMBS):
        win = x >> (32 * i)
        win = _mac_row(win, LIMBS + 2, al[i], bl)
        x = (x & (B32 ** i - 1)) | (win << (32 * i))
    assert x == a * b and x < B32 ** (2 * LIMBS)
    w = _limbs(x, 2 * LIMBS)
    # u = columns >= 7 of q1 mu, q1 = w[7..15]; row i starts at mu limb
    # max(0, 7 - i), row 8 one limb up
    u = 0
    for i in range(MU_LIMBS):
        j0 = max(0, 7 - i)
        off = i + j0 - 7
        n = MU_LIMBS - j0
        win = _mac_row(u >> (32 * off), n + 2, w[7 + i], mul[j0:])
        u = (u & (B32 ** off - 1)) | (win << (32 * off))
    assert u < B32 ** 12
    q3 = (u >> 64) & (B32 ** LIMBS - 1)
    assert u >> (64 + 32 * LIMBS) == 0, "q3 wider than 8 limbs"
    # the truncated product equals q1 mu less the skipped columns' terms
    q1 = x >> 224
    skipped = sum(w[7 + i] * mul[j] << (32 * (i + j))
                  for i in range(MU_LIMBS) for j in range(MU_LIMBS) if i + j < 7)
    assert (u << 224) == q1 * mu - skipped
    # before q3's floor, u / 2^64 falls short of x / p by less than 1
    assert 0 <= (x << 64) - u * p < p << 64
    q = x // p
    assert q - 1 <= q3 <= q, (q, q3)
    # r = x - q3 p mod 2^256 from the low limbs only
    v = (q3 * p) % B32 ** LIMBS
    r = (x - v) % B32 ** LIMBS
    assert r == x - q3 * p and r < 2 * p
    out = r - p if r >= p else r
    return {"out": out, "q": q, "q3": q3, "r": r}


def mont_model(a: int, b: int, spec) -> int:
    """cc_mont_mul: eight rounds of a_i b then m p into the window
    t[i .. i + 9]; returns a b 2^-256 mod p."""
    p = spec.p
    al = _limbs(a, LIMBS)
    t = 0                         # the value of t[i ..] at round i
    for i in range(LIMBS):
        t = _mac_row(t, LIMBS + 2, al[i], _limbs(b, LIMBS))
        m = (t & (B32 - 1)) * spec.p_inv_neg % B32
        t = _mac_row(t, LIMBS + 2, m, _limbs(p, LIMBS))
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
    pairs += [(int.from_bytes(rng.bytes(40), "little") % p,
               int.from_bytes(rng.bytes(40), "little") % p) for _ in range(400)]
    for a, b in pairs:
        m = barrett_model(a, b, spec)
        assert m["out"] == a * b % p
        seen.add((m["q"] - m["q3"], m["r"] >= p))
    assert {0, 1} <= {d for d, _ in seen}
    assert {True, False} <= {s for _, s in seen}


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_montgomery_edges_and_random(spec):
    """Every pair of edge values and a seeded sweep: against a table entry
    w 2^256 mod p, the Montgomery product is a w mod p."""
    p = spec.p
    vals = _edges(p)
    rng = np.random.default_rng(12)
    pairs = [(a, w) for a in vals for w in vals]
    pairs += [(int.from_bytes(rng.bytes(40), "little") % p,
               int.from_bytes(rng.bytes(40), "little") % p) for _ in range(200)]
    for a, w in pairs:
        assert mont_model(a, w * (1 << 256) % p, spec) == a * w % p


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
        """With b = w 2^256 mod p (a twiddle or scale table entry) the product
        is a w mod p exactly."""
        p = spec.p
        elem = st.one_of(st.sampled_from(_edges(p)), st.integers(0, p - 1))
        a, w = data.draw(elem), data.draw(elem)
        assert mont_model(a, w * (1 << 256) % p, spec) == a * w % p


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_mul_consts_layout(spec):
    """mul_consts = kernel_consts (what the point kernels read: p and
    -p^-1 mod 2^32) + mu + the product sum's floor(2^544 / p)."""
    c = spec.mul_consts
    words = LIMBS + 1
    assert c.dtype == np.uint32 and c.shape == (words + MU_LIMBS + MU_SUM_LIMBS,)
    assert np.array_equal(c[:words], spec.kernel_consts)
    assert _value(c[:LIMBS]) == spec.p
    assert (int(c[LIMBS]) * spec.p) % B32 == B32 - 1
    assert _value(c[words:words + MU_LIMBS]) == (1 << 512) // spec.p
    assert _value(c[words + MU_LIMBS:]) == (1 << 544) // spec.p
