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
from plonky_tpu_torch.fields import (BLS12_377_SCALAR, PALLAS_BASE,
                                     TWEEDLEDEE_BASE, TWEEDLEDUM_BASE,
                                     VESTA_BASE)
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

# Every field K5 runs: both Tweedle and both Pasta base fields (the sparse
# reduction) and BLS12-377's scalar field (alpha = 11, the dense one).
KERNEL_FIELDS = {"dee": TWEEDLEDEE_BASE, "dum": TWEEDLEDUM_BASE,
                 "pallas": PALLAS_BASE, "vesta": VESTA_BASE,
                 "bls_scalar": BLS12_377_SCALAR}
KERNEL_CASES = [(name, bits) for name in KERNEL_FIELDS for bits in (128, 64)]
KERNEL_IDS = [f"{name}-{bits}" for name, bits in KERNEL_CASES]


def _defines():
    text = (CSRC / "rescue_kernels.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"#define (RESCUE_\w+) (\d+)\b", text)}


def _word_value(words) -> int:
    return sum(int(w) << (32 * k) for k, w in enumerate(words))


def decode_step(word: int) -> tuple:
    """One step word of a chain (hashing/rescue.py:step_word) as (load,
    squares, mul, store)."""
    return (word & 31, word >> 16, (word >> 5) & 31, (word >> 10) & 31)


def run_schedule(steps, x, mul, sqr):
    """x^e by the chain `steps`, through mul(a, b) and sqr(a)."""
    slots, s = {}, x
    for load, squares, m, store in steps:
        if load != prescue.NO_SLOT:
            s = slots[load]
        for _ in range(squares):
            s = sqr(s)
        if m != prescue.NO_SLOT:
            s = mul(s, slots[m])
        if store != prescue.NO_SLOT:
            slots[store] = s
    return s


def buffer_layout(words) -> dict:
    """The fields of a RescueConsts buffer, read at the kernel's offsets:
    p and -p^-1 (9 words), R^2 (8), sparse, rounds, slots, the two step
    counts, the two chains (KERNEL_MAX_STEPS words each), the MDS matrix
    (16 x 8) and the round constants (8 x 8 a round)."""
    steps_at = 9 + 8 + 5
    max_steps = prescue.KERNEL_MAX_STEPS
    head = steps_at + 2 * max_steps
    n_steps = [int(words[20]), int(words[21])]
    return {
        "p": _word_value(words[:8]), "pinv": int(words[8]),
        "r2": _word_value(words[9:17]), "sparse": int(words[17]),
        "rounds": int(words[18]), "slots": int(words[19]),
        "chains": [tuple(decode_step(int(w)) for w in
                         words[steps_at + h * max_steps:
                               steps_at + h * max_steps + n_steps[h]])
                   for h in range(2)],
        "mds": [[_word_value(words[head + 8 * (4 * r + c):head + 8 * (4 * r + c + 1)])
                 for c in range(4)] for r in range(4)],
        "rc_at": head + 128, "header_words": head + 128}


def kernel_model(spec, words, state):
    """rescue_permutation_kernel's rounds on python ints, every constant read
    from the buffer `words` at the RescueConsts offsets: Montgomery form
    (R = 2^256) in and out, each S-box the chain of steps read from the
    buffer (load a slot, square, multiply by a slot, store to a slot) over
    a table of `slots` slots, each MDS row one reduction of the sum of the
    four products, then the round constant."""
    p = spec.p
    r_inv = pow(1 << 256, -1, p)
    lay = buffer_layout(words)
    assert lay["p"] == p

    def mont(a, b):
        return a * b * r_inv % p

    def sbox(s, half):
        slots = {}
        for load, squares, mul, store in lay["chains"][half]:
            if load != prescue.NO_SLOT:
                s = slots[load]
            for _ in range(squares):
                s = mont(s, s)
            if mul != prescue.NO_SLOT:
                s = mont(s, slots[mul])
            if store != prescue.NO_SLOT:
                assert store < lay["slots"]
                slots[store] = s
        return s

    def rc(rnd, half, r):
        k = lay["rc_at"] + 8 * (8 * rnd + 4 * half + r)
        return _word_value(words[k:k + 8])

    s = [mont(v, lay["r2"]) for v in state]
    for rnd in range(lay["rounds"]):
        for half in range(2):
            y = [sbox(v, half) for v in s]
            s = [(sum(y[c] * lay["mds"][r][c] for c in range(4)) * r_inv
                  + rc(rnd, half, r)) % p for r in range(4)]
    return [mont(v, 1) for v in s]


@pytest.mark.parametrize("name,bits", KERNEL_CASES, ids=KERNEL_IDS)
def test_kernel_model_matches_host(name, bits):
    spec = KERNEL_FIELDS[name]
    words = prescue.kernel_consts(spec, bits)
    rounds = prescue.recommended_rounds(4, bits)
    assert words.dtype == np.uint32
    assert words.size == buffer_layout(words)["header_words"] + rounds * 8 * LIMBS
    assert buffer_layout(words)["sparse"] == int(name != "bls_scalar")
    rng = np.random.default_rng(bits)
    for state in ([0, 0, 0, 0], [spec.p - 1] * 4, _values(spec, rng, 4)):
        assert kernel_model(spec, words, state) == \
            prescue.rescue_permutation_host(spec, state, bits)


def test_kernel_limits_match_the_wrapper():
    """The limits and block shape of rescue_kernels.cu against the
    wrapper's; RescueConsts's header (sizeof, the round count's word) as
    the kernel source counts it, and the largest buffer within the 32,764
    bytes of kernel parameters it is passed in; the round count words; a
    round count past the limit is refused before any launch."""
    d = _defines()
    assert d["RESCUE_MAX_ROUNDS"] == prescue.KERNEL_MAX_ROUNDS
    assert d["RESCUE_MAX_STEPS"] == prescue.KERNEL_MAX_STEPS
    assert d["RESCUE_MAX_SLOTS"] == prescue.KERNEL_MAX_SLOTS == \
        1 + (1 << (prescue.KERNEL_WINDOW - 1))
    assert d["RESCUE_NO_SLOT"] == prescue.NO_SLOT
    assert d["RESCUE_WIDTH"] == prescue.RESCUE_SPONGE_WIDTH
    assert d["RESCUE_THREADS"] % 32 == 0 and d["RESCUE_LANES"] == 4
    # the table (RESCUE_THREADS columns of slots) in the default 48 KB
    assert d["RESCUE_THREADS"] * d["RESCUE_MAX_SLOTS"] * LIMBS * 4 <= 48 * 1024
    spec = TWEEDLEDUM_BASE
    words = prescue.kernel_consts(spec, 128)
    header = buffer_layout(words)["header_words"]
    # PT_FIELD_WORDS + PT_LIMBS + 5 + 2 RESCUE_MAX_STEPS + 16 PT_LIMBS
    assert header == 9 + 8 + 5 + 2 * d["RESCUE_MAX_STEPS"] + 16 * LIMBS
    assert 4 * (header + d["RESCUE_MAX_ROUNDS"] * 8 * LIMBS) <= 32764
    assert int(words[9 + 8 + 1]) == 16      # RESCUE_ROUNDS_WORD
    assert int(prescue.kernel_consts(spec, 64)[18]) == 10
    assert buffer_layout(words)["slots"] == 1 + (1 << (prescue.KERNEL_WINDOW - 1))
    bits = 2 * 4 * (prescue.KERNEL_MAX_ROUNDS + 1)
    with pytest.raises(ValueError, match="at most"):
        prescue.kernel_consts(spec, bits)


@pytest.mark.parametrize("name", list(KERNEL_FIELDS))
def test_host_schedule_is_the_counted_chain(name):
    """For every field, sbox_schedule's chain at every window of 1 to 5 bits
    (SBOX_MAX_WINDOW; a wider one is refused: its table would name the
    slot NO_SLOT) computes x^e for the inverse and the forward exponent,
    and the squares and multiplies it runs are those schedule_counts
    reports; the bound
    (chip_smoke.sbox_ops) is the cheapest of those chains at the field's
    costs (chip_smoke.rescue_costs), and rescue_work adds them up."""
    import chip_smoke
    from plonky_tpu_torch.fields.host import kth_root_exponent

    spec = KERNEL_FIELDS[name]
    p = spec.p
    rng = np.random.default_rng(5)
    exps = (kth_root_exponent(spec, spec.alpha), spec.alpha)
    sqr_c, mul_c, redc_c = chip_smoke.rescue_costs(spec)
    for e in exps:
        costs = []
        with pytest.raises(ValueError, match="window"):
            prescue.sbox_schedule(e, prescue.SBOX_MAX_WINDOW + 1)
        for w in range(1, prescue.SBOX_MAX_WINDOW + 1):
            chain = prescue.sbox_schedule(e, w)
            ran = {"sq": 0, "mul": 0}

            def mul(a, b, ran=ran):
                ran["mul"] += 1
                return a * b % p

            def sqr(a, ran=ran):
                ran["sq"] += 1
                return a * a % p
            for x in _values(spec, rng, 3):
                ran.update(sq=0, mul=0)
                assert run_schedule(chain, x, mul, sqr) == pow(x, e, p)
                assert (ran["sq"], ran["mul"]) == prescue.schedule_counts(chain)
            costs.append(ran["sq"] * sqr_c + ran["mul"] * mul_c)
        assert chip_smoke.sbox_ops(spec, e) == min(costs)
    _bytes, ops = chip_smoke.rescue_work(spec, 128, 3)
    assert ops == 3 * 16 * (4 * sum(chip_smoke.sbox_ops(spec, e) for e in exps)
                            + 8 * (4 * chip_smoke.PRODUCT_OPS + redc_c))
    assert redc_c == (48 if name != "bls_scalar" else 136)


@pytest.mark.parametrize("name", list(KERNEL_FIELDS))
def test_sbox_bound_counts_a_real_chain(name):
    """chip_smoke.py's operations bound for K5 counts each S-box by the
    cheapest sliding-window chain (windows of 1 to 5 bits); the kernel's
    own chains, read from its constant buffer, compute x^e and x^alpha, are
    kernel_schedule's (windows of up to KERNEL_WINDOW bits), cost no less
    than the bound's, and the inverse one is cheaper than the
    square-and-multiply of the kernel before them."""
    from chip_smoke import rescue_costs, sbox_ops
    from plonky_tpu_torch.fields.host import kth_root_exponent

    spec = KERNEL_FIELDS[name]
    p = spec.p
    sqr_c, mul_c, _redc = rescue_costs(spec)
    e = kth_root_exponent(spec, spec.alpha)
    chains = buffer_layout(prescue.kernel_consts(spec, 64))["chains"]
    rng = np.random.default_rng(7)
    for exp, chain in zip((e, spec.alpha), chains):
        assert chain == prescue.kernel_schedule(exp)
        for x in _values(spec, rng, 4):
            assert run_schedule(chain, x, lambda a, b: a * b % p,
                                        lambda a: a * a % p) == pow(x, exp, p)
        sq, m = prescue.schedule_counts(chain)
        assert sq * sqr_c + m * mul_c >= sbox_ops(spec, exp)
    sq1, m1 = prescue.schedule_counts(prescue.sbox_schedule(e, 1))
    assert (sq1, m1) == (e.bit_length() - 1, bin(e).count("1") - 1)
    sq, m = prescue.schedule_counts(chains[0])
    assert sq <= sq1 and m < m1
    assert sbox_ops(spec, e) < sq1 * sqr_c + m1 * mul_c


def test_bls12_377_scalar_plain_matches_host():
    """The plain version on BLS12-377's scalar field (alpha = 11, K5's dense
    instance), 3 states against the host permutation at 64 bits."""
    spec = BLS12_377_SCALAR
    rng = np.random.default_rng(11)
    cols = [_values(spec, rng, 3) for _ in range(4)]
    got = prescue.rescue_permutation(
        spec, [fops.from_ints(spec, c, "cpu") for c in cols], 64)
    host = [prescue.rescue_permutation_host(spec, s, 64) for s in zip(*cols)]
    assert [fops.to_ints(spec, g).tolist() for g in got] == [
        list(c) for c in zip(*host)]
