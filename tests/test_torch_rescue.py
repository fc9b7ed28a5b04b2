"""The port's Rescue on the CPU, held against the JAX package.

The host half (sponge, n-to-1 hash, PRF, PRF-chained PRG, Rescue
hash-to-curve) equals the JAX package's on the same inputs; the device
entry `rescue_permutation` (on CPU tensors: its plain version) equals the
JAX package's `rescue_permutation` run under jax.jit on the CPU, compared
as canonical ints, on both Tweedle base fields at 128 and 64 security
bits.  K5 itself runs only on the card (chip_smoke.py); here a Python
model of its rounds, reading the constant buffer the wrapper hands it word
by word, is held against the host permutation, and the buffer's layout
against the kernel source's.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from plonky_tpu import hashing as jhash
from plonky_tpu.curves import TWEEDLEDEE as J_DEE, TWEEDLEDUM as J_DUM
from plonky_tpu.fields import TWEEDLEDEE_BASE as J_DEE_BASE
from plonky_tpu.fields import TWEEDLEDUM_BASE as J_DUM_BASE
from plonky_tpu.fields import ops as jfops
from plonky_tpu.hashing import pseudorandom as jprf
from plonky_tpu_torch import hashing as phash
from plonky_tpu_torch.curves import TWEEDLEDEE, TWEEDLEDUM
from plonky_tpu_torch.fields import TWEEDLEDEE_BASE, TWEEDLEDUM_BASE
from plonky_tpu_torch.fields import ops as fops
from plonky_tpu_torch.fields.spec import LIMBS
from plonky_tpu_torch.hashing import pseudorandom as pprf
from plonky_tpu_torch.hashing import rescue as prescue
from plonky_tpu_torch.interop import field_from_jax_digits

torch.set_num_threads(1)

CSRC = Path(prescue.__file__).resolve().parents[1] / "csrc"
# (port field, JAX field, port curve over it, JAX curve)
FIELDS = {"dee": (TWEEDLEDEE_BASE, J_DEE_BASE, TWEEDLEDEE, J_DEE),
          "dum": (TWEEDLEDUM_BASE, J_DUM_BASE, TWEEDLEDUM, J_DUM)}
CASES = [(name, bits) for name in FIELDS for bits in (128, 64)]
IDS = [f"{name}-{bits}" for name, bits in CASES]


def _values(spec, rng, n):
    """n seeded canonical elements, with 0 and p - 1 first."""
    vals = [0, spec.p - 1] + [int.from_bytes(rng.bytes(40), "little") % spec.p
                              for _ in range(n)]
    return vals[:n]


@pytest.mark.parametrize("name,bits", CASES, ids=IDS)
def test_host_sponge_prf_and_hash_to_curve_match_jax(name, bits):
    spec, jspec, curve, jcurve = FIELDS[name]
    rng = np.random.default_rng(bits)
    ins = _values(spec, rng, 7)
    for n_in in (0, 1, 3, 4, 7):
        for n_out in (1, 2, 4):
            assert (phash.rescue_sponge_host(spec, ins[:n_in], n_out, bits)
                    == jhash.rescue_sponge_host(jspec, ins[:n_in], n_out, bits))
    assert (phash.rescue_hash_n_to_1_host(spec, ins, bits)
            == jhash.rescue_hash_n_to_1_host(jspec, ins, bits))
    assert (phash.rescue_prf_host(spec, ins[2], bits)
            == jhash.rescue_prf_host(jspec, ins[2], bits))
    key, seed = ins[3], ins[4]
    assert (pprf.RescuePrf(key, bits).rand(spec, ins[5])
            == jprf.RescuePrf(key, bits).rand(jspec, ins[5]))
    prg = pprf.PrfBasedPrg(spec, pprf.RescuePrf(key, bits), seed)
    jprg = jprf.PrfBasedPrg(jspec, jprf.RescuePrf(key, bits), seed)
    assert ([prg.next_field(), prg.next_u32(), prg.next_bool()]
            == [jprg.next_field(), jprg.next_u32(), jprg.next_bool()])
    for s in (0, 5):
        pt = phash.hash_usize_to_curve(curve, s, bits)
        jpt = jhash.hash_usize_to_curve(jcurve, s, bits)
        assert pt.is_valid() and (pt.x, pt.y) == (jpt.x, jpt.y)


@pytest.mark.parametrize("name,bits", CASES, ids=IDS)
def test_rescue_permutation_matches_jax(name, bits):
    """A batch of 3 states (0 and p - 1 among them), through the port's
    rescue_permutation on CPU tensors and the JAX package's under jit."""
    spec, jspec = FIELDS[name][:2]
    rng = np.random.default_rng(7 + bits)
    cols = [_values(spec, rng, 3) for _ in range(4)]
    cols[1] = cols[1][::-1]
    got = prescue.rescue_permutation(
        spec, [fops.from_ints(spec, c, "cpu") for c in cols], bits)
    jout = jax.jit(lambda s: jhash.rescue_permutation(jspec, s, bits))(
        [jfops.from_ints(jspec, c) for c in cols])
    for g, j in zip(got, jout):
        want = field_from_jax_digits(spec, np.asarray(j), "cpu")
        assert fops.to_ints(spec, g).tolist() == fops.to_ints(spec, want).tolist()
    host = [prescue.rescue_permutation_host(spec, s, bits) for s in zip(*cols)]
    assert [fops.to_ints(spec, g).tolist() for g in got] == [
        list(c) for c in zip(*host)]


def test_rescue_permutation_broadcasts_and_checks_width():
    """An [8, 1] element broadcast against [8, 2, 3] ones; a state that is
    not of width 4 is refused."""
    spec = TWEEDLEDEE_BASE
    rng = np.random.default_rng(3)
    vals = [_values(spec, rng, 6) for _ in range(3)]
    state = [fops.from_ints(spec, [11], "cpu")] + [
        fops.from_ints(spec, v, "cpu").reshape(LIMBS, 2, 3) for v in vals]
    out = prescue.rescue_permutation(spec, state, 64)
    assert all(tuple(o.shape) == (LIMBS, 2, 3) for o in out)
    ints = [fops.to_ints(spec, o).reshape(-1).tolist() for o in out]
    for i in range(6):
        want = prescue.rescue_permutation_host(spec, [11] + [v[i] for v in vals], 64)
        assert [col[i] for col in ints] == want
    with pytest.raises(ValueError, match="width-4"):
        prescue.rescue_permutation(spec, state[:3], 64)


# ---------------------------------------------------------------------------
# A model of K5 (csrc/rescue_kernels.cu) over its constant buffer
# ---------------------------------------------------------------------------

def _defines():
    text = (CSRC / "rescue_kernels.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"#define (RESCUE_\w+) (\d+)\n", text)}


def _word_value(words) -> int:
    return sum(int(w) << (32 * k) for k, w in enumerate(words))


def kernel_model(spec, words, state):
    """rescue_permutation_kernel's rounds on python ints, every constant read
    from the buffer `words` at the RescueConsts offsets: Montgomery form
    (R = 2^256) in and out, each S-box the kernel's loop of one multiply
    site (a square, then a multiply by the input after each set bit), each
    MDS row the sum of the quad's four products and the round constant."""
    p = spec.p
    r_inv = pow(1 << 256, -1, p)

    def mont(a, b):
        return a * b * r_inv % p

    assert _word_value(words[:8]) == p
    r2 = _word_value(words[9:17])
    exps = [_word_value(words[17 + 8 * h:25 + 8 * h]) for h in range(2)]
    tops = [int(words[33]), int(words[34])]
    rounds = int(words[35])
    head = 36
    mds = [[_word_value(words[head + 8 * (4 * r + c):head + 8 * (4 * r + c + 1)])
            for c in range(4)] for r in range(4)]
    rc_at = head + 128

    def rc(rnd, half, r):
        k = rc_at + 8 * (8 * rnd + 4 * half + r)
        return _word_value(words[k:k + 8])

    def sbox(s, half):
        x, i, mul_step = s, tops[half] - 1, False
        while i >= 0:
            s = mont(s, x if mul_step else s)
            if mul_step:
                mul_step, i = False, i - 1
            elif (exps[half] >> i) & 1:
                mul_step = True
            else:
                i -= 1
        return s

    s = [mont(v, r2) for v in state]
    for rnd in range(rounds):
        for half in range(2):
            y = [sbox(v, half) for v in s]
            s = [(rc(rnd, half, r) + sum(mont(y[c], mds[r][c]) for c in range(4))) % p
                 for r in range(4)]
    return [mont(v, 1) for v in s]


@pytest.mark.parametrize("name,bits", CASES, ids=IDS)
def test_kernel_model_matches_host(name, bits):
    spec = FIELDS[name][0]
    words = prescue.kernel_consts(spec, bits)
    rounds = prescue.recommended_rounds(4, bits)
    assert words.dtype == np.uint32
    assert words.size == 36 + 16 * LIMBS + rounds * 8 * LIMBS
    rng = np.random.default_rng(bits)
    for state in ([0, 0, 0, 0], [spec.p - 1] * 4, _values(spec, rng, 4)):
        assert kernel_model(spec, words, state) == \
            prescue.rescue_permutation_host(spec, state, bits)


def test_kernel_limits_match_the_wrapper():
    """The round limit and block shape of rescue_kernels.cu against the
    wrapper's; the largest constant buffer fits the 32,764 bytes of kernel
    parameters it is passed in; the round count words; a round count past
    the limit is refused before any launch."""
    d = _defines()
    assert d["RESCUE_MAX_ROUNDS"] == prescue.KERNEL_MAX_ROUNDS
    header_words = 36 + 16 * LIMBS
    assert 4 * (header_words + d["RESCUE_MAX_ROUNDS"] * 8 * LIMBS) <= 32764
    assert d["RESCUE_WIDTH"] == prescue.RESCUE_SPONGE_WIDTH
    assert d["RESCUE_THREADS"] % 32 == 0
    spec = TWEEDLEDUM_BASE
    assert int(prescue.kernel_consts(spec, 128)[35]) == 16
    assert int(prescue.kernel_consts(spec, 64)[35]) == 10
    bits = 2 * 4 * (prescue.KERNEL_MAX_ROUNDS + 1)
    with pytest.raises(ValueError, match="at most"):
        prescue.kernel_consts(spec, bits)


@pytest.mark.parametrize("name", list(FIELDS))
def test_sbox_bound_counts_a_real_chain(name):
    """chip_smoke.py's operations bound for K5 counts each S-box by the
    shortest sliding-window chain (window_pow, windows of 1 to 8 bits):
    every window's chain computes x^e, and the chain counted for the inverse
    S-box is shorter than the kernel's square-and-multiply."""
    from chip_smoke import MUL_OPS, SQR_OPS, window_pow
    from plonky_tpu_torch.fields.host import kth_root_exponent

    spec = FIELDS[name][0]
    e = kth_root_exponent(spec, spec.alpha)
    rng = np.random.default_rng(7)
    for x in _values(spec, rng, 4):
        for exp in (e, spec.alpha):
            for w in range(1, 9):
                assert window_pow(x, exp, w, spec.p)[0] == pow(x, exp, spec.p)
    _v, sq1, m1 = window_pow(2, e, 1, spec.p)
    assert (sq1, m1) == (e.bit_length() - 1, bin(e).count("1") - 1)
    best = min(sq * SQR_OPS + m * MUL_OPS
               for _v, sq, m in (window_pow(2, e, w, spec.p) for w in range(1, 9)))
    assert best < sq1 * SQR_OPS + m1 * MUL_OPS
