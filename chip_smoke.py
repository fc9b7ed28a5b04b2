#!/usr/bin/env python3
"""Chip check of plonky_tpu_torch on one NVIDIA GPU (written for the H100).

Builds the CUDA kernels from plonky_tpu_torch/csrc, holds every kernel
against its plain PyTorch version on the card at the main path's shapes
(exact equality: all of it is integer arithmetic; the NTT at every
transform shape of the prove and the fixtures), drives the batch Rescue
permutation's path (K5 against its plain version on a ragged batch of both
Tweedle base fields at 128 and 64 security bits, one launch for 2^14
permutations held against the host permutation at sampled lanes, timed at
2^14 and 2^16 and held there against the plain version on every lane),
reproduces the three committed fixture proofs byte for byte, proves and
verifies the gadget circuits and the 2^10 BufferGate circuit, each at the
JAX package's sha256, then builds, proves (twice) and verifies the 2^14-gate BufferGate
circuit with the random source pinned, checks the steady proof's sha256,
and shows that the steady prove launched every kernel of the main path
(curve_add and curve_double, checked here, are off it: the MSM's Horner
runs in curve_horner; rescue_permutation has its own path).

    python3 chip_smoke.py

Every phase prints one JSON line.  The line before the last is the card's
`nvidia-smi --query-gpu=name,power.limit` line; the last line is
{"ok": true, "device": {...}}.  Any failure raises: the exit code is not 0
and the ok line is not printed.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
# sha256 of proof_to_bytes of the steady 2^14 proof under pinned_random()
# (phase_prove): fixed by the protocol's values, whatever the kernels' inner
# representation or order of adds.
PROOF_2E14_SHA256 = ("7eddf299bab9296d33bb070c11a7d95a"
                     "a1af70768d056f2083063145c2a799e2")
# The JAX package's sha256 of proofs on the CPU, which the card's must equal
# (tests/test_torch_ladder.py and tests/test_torch_gadgets.py assert them
# there): the 2^10 BufferGate proof under a fresh pinned_random() for its
# build and one prove (phase_ladder), and each gadget circuit's proof
# (gadget_circuits) under a fresh gadget_random() (phase_gadgets).
PROOF_2E10_SHA256 = ("cc27a990e8184516d14e8afb4345d269"
                     "6e3b5831cba7813b9f9755be5e904df7")
GADGET_PROOF_SHA256 = {
    "rescue": ("cd0dab38016dd9235dfa82f1f59f170a"
               "ec35ed6c854250f2a3982e908db4c63f"),
    "curve_add": ("71ab67481a8561050e9b7842d51d6837"
                  "024160e20c818c589d4aca6f206d56de"),
    "curve_double": ("0b3dbd47793ea809728bca3d010e4b7a"
                     "b40faf5f9cabad58ef45150d904ed44a"),
    "base4sum": ("9e5b3413a0d2ad30ad36d89131c690f1"
                 "5690931a07abe1a7ed852dd67c503819"),
    "curve_msm": ("cfbac3c6463bcd7f42d28d8b9f2f9107"
                  "c46a9b920029f1b2452d6c486a6662e9"),
}

# name -> (source, the TPU kernel it replaces, its CUDA function's name)
_CSRC = "plonky_tpu_torch/csrc/"
_PK = "plonky_tpu/fields/pallas_kernels.py"
KERNELS = {
    "field_add": (_CSRC + "field_kernels.cu", _PK + ":110",
                  "field_binary_kernel<0>"),
    "field_sub": (_CSRC + "field_kernels.cu", _PK + ":110",
                  "field_binary_kernel<1>"),
    "field_mul": (_CSRC + "field_kernels.cu", _PK + ":197",
                  "field_binary_kernel<2>"),
    "field_product_sum": (_CSRC + "field_kernels.cu", _PK + ":68",
                          "field_product_sum_kernel"),
    "curve_add": (_CSRC + "curve_kernels.cu", "plonky_tpu/curves/ops.py:93",
                  "curve_add_kernel"),
    "curve_double": (_CSRC + "curve_kernels.cu", "plonky_tpu/curves/ops.py:93",
                     "curve_double_kernel"),
    "curve_horner": (_CSRC + "curve_kernels.cu", "plonky_tpu/curves/msm.py:401",
                     "curve_horner_kernel"),
    "ntt_pass": (_CSRC + "ntt_kernels.cu", "plonky_tpu/poly/fft.py:124",
                 "ntt_pass_kernel"),
    "msm_bucket_accumulate": (_CSRC + "msm_kernels.cu",
                              "plonky_tpu/curves/msm.py:95",
                              "msm_bucket_accumulate_kernel"),
    "msm_bucket_reduce": (_CSRC + "msm_kernels.cu",
                          "plonky_tpu/curves/msm.py:376",
                          "msm_bucket_reduce_kernel"),
    "rescue_permutation": (_CSRC + "rescue_kernels.cu",
                           "plonky_tpu/hashing/rescue.py:162",
                           "rescue_permutation_kernel"),
}
# Checked against their plain versions, but off the prove's path: the MSM's
# Horner runs in curve_horner, and the batch Rescue permutation has its own
# path (phase_rescue).
OFF_PATH = ("curve_add", "curve_double", "rescue_permutation")

# The operations bound counts the multiplies a function needs at least, in
# 32-bit IMAD issue slots (64 per SM per clock): a 32 x 32 -> 64-bit
# product is two of them (its low and its high half).  An 8-limb product is
# 64 wide products; a square 36 (8 squares, 28 doubled cross products); one
# Montgomery reduction is 8 rounds of a low-half quotient digit and 8 wide
# products.  Additions, and multiplies by the small constants 3 and
# b3 = 3b (15 or 21), are not counted: the bound is a floor.
WIDE = 2
REDC_OPS = 8 * (1 + 8 * WIDE)                   # 136
PRODUCT_OPS = 64 * WIDE                         # 128
MUL_OPS = PRODUCT_OPS + REDC_OPS                # 264
SQR_OPS = 36 * WIDE + REDC_OPS                  # 208
ADD_OPS = 12 * MUL_OPS          # RCB15 Alg. 7 (a = 0): 12 M + 2 by b3
DBL_OPS = 6 * MUL_OPS + 2 * SQR_OPS             # Alg. 9: 6 M + 2 S + 1 by b3
# A batch of n Rescue permutations of width 4 (rescue_work): per round, each
# element's inverse S-box x^e (e = kth_root_exponent(p, 5), 254 bits) and
# forward S-box x^5, each counted by the shortest of the sliding-window
# chains of 1 to 8 bits (window_pow: for e, 5-bit windows, 250 squares and
# 56 multiplies on TweedledeeBase, 55 on TweedledumBase; for 5, 2 squares
# and 1 multiply), and the two MDS mixes (4 products and one reduction an
# output element); 4 elements read and written per permutation.
# A whole NTT of B rows of n = 2^lg: B (n / 2) (lg - 1) twiddle products
# (layer 0's twiddles are all 1), plus B n scale products where the
# transform scales (coset input, inverse output); it reads the data, the
# twiddles of layers 1 .. lg - 1 (n - 2) and any scale table once and writes
# the data once (ntt_work).


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Checker:
    """Times kernels with CUDA events and compares them with their plain
    versions; collects one record per kernel."""

    def __init__(self, torch, clock_hz: float, int_ops_per_s: float):
        self.torch = torch
        self.clock_hz = clock_hz
        self.rate = int_ops_per_s
        self.flush = torch.empty(1 << 25, dtype=torch.int32, device="cuda")
        self.records = {}
        self.errors = {}

    def time_ms(self, fn, reps: int) -> float:
        """Mean time per call of `reps` calls in a row, host work included
        wherever the host is slower than the card."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def queued_ms(self, fn, reps: int) -> float:
        """Mean device time per call of `reps` calls enqueued while the card
        sleeps, so that the events time the card alone and not the host's
        enqueue; retried with a longer sleep if the host fell behind."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        sleep_s = 2e-3
        for _ in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(sleep_s * self.clock_hz))
            start.record()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            host_s = time.perf_counter() - t0
            end.record()
            torch.cuda.synchronize()
            if host_s < sleep_s:
                return start.elapsed_time(end) / reps
            sleep_s = 2 * host_s + 1e-3
        raise AssertionError("the host could not enqueue ahead of the card")

    def measure(self, kernel_fn, plain_fn, bytes_, ops, reps=20,
                plain_reps=2) -> dict:
        """ms: device time per launch with the L2 cache warm; cold_ms: the
        same with the 50 MB L2 flushed before each launch (the flush's own
        time taken off); call_ms: a wrapper call timed back to back, host
        included; plain_ms: the plain version's call."""
        flush = self.flush.zero_
        cold = self.queued_ms(lambda: (flush(), kernel_fn()), reps)
        t_bytes = bytes_ / HBM_BYTES_PER_S
        t_ops = ops / self.rate
        return {"ms": self.queued_ms(kernel_fn, reps),
                "cold_ms": cold - self.queued_ms(flush, reps),
                "call_ms": self.time_ms(kernel_fn, reps),
                "plain_ms": self.time_ms(plain_fn, plain_reps),
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    def compare(self, name: str, got, want) -> None:
        """Exact equality of a kernel's output with its plain version's;
        keeps the largest limb difference seen per kernel."""
        torch = self.torch
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if len(got) != len(want):
            raise AssertionError(f"{name}: {len(got)} outputs vs plain "
                                 f"{len(want)}")
        err = 0
        for g, w in zip(got, want):
            if tuple(g.shape) != tuple(w.shape):
                raise AssertionError(f"{name}: shape {tuple(g.shape)} vs "
                                     f"plain {tuple(w.shape)}")
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max().item()))
        torch.cuda.synchronize()
        self.errors[name] = max(self.errors.get(name, 0), err)
        if err:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs limb error {err})")

    def record(self, name, shapes, kernel_fn=None, plain_fn=None, bytes_=0,
               ops=0, reps=20, plain_reps=2, by_shape=None, measured=None):
        """One kernel's record; `measured` (a measure() result, extra keys
        ignored) stands in for timing kernel_fn and plain_fn here."""
        source, replaces, _symbol = KERNELS[name]
        if measured is None:
            measured = self.measure(kernel_fn, plain_fn, bytes_, ops, reps,
                                    plain_reps)
        timing = {k: measured[k] for k in ("ms", "cold_ms", "call_ms",
                                           "plain_ms", "bound_ms", "bound_by")}
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": None,
               "max_abs_err": self.errors[name], **timing,
               "library_ms": None, "checked": True, "shapes": shapes}
        if by_shape is not None:
            rec["by_shape"] = by_shape
        self.records[name] = rec
        emit({"phase": f"kernel:{name}", **rec})


def rand_field(np, torch, rng, shape, device):
    """Canonical random elements (< 2^254 < p) with 0, 1, p-1, p-2 first."""
    limbs = rng.integers(0, 1 << 32, size=(8,) + tuple(shape),
                         dtype=np.uint64).astype(np.uint32)
    limbs[7] &= 0x3FFFFFFF
    return torch.from_numpy(limbs.view(np.int32).copy()).to(device)


def with_edges(fops, spec, x):
    flat = x.reshape(8, -1)
    edges = fops.from_ints(spec, [0, 1, spec.p - 1, spec.p - 2], x.device)
    k = min(4, flat.shape[1])
    flat[:, :k] = edges[:, :k]
    return x


def check_horner(ck: Checker, cops, cmsm, curve, ws, c):
    """The Horner steps of curves/msm.py:horner_plain through the
    elementwise K2 kernels on window sums ws [LIMBS, K, W], each step held
    against the plain version on the same inputs, with non-contiguous
    window slices; the chain's result held against curve_horner's.
    Returns the last step's operands."""
    n_windows = ws[0].shape[-1]
    acc = tuple(t[..., n_windows - 1].contiguous() for t in ws)
    for w in range(n_windows - 2, -1, -1):
        for _ in range(c):
            nxt = cops.double(curve, acc)
            ck.compare("curve_double", nxt, cops.double_plain(curve, acc))
            acc = nxt
        win = tuple(t[..., w] for t in ws)
        nxt = cops.add(curve, acc, win)
        ck.compare("curve_add", nxt, cops.add_plain(curve, acc, win))
        last, acc = acc, nxt
    ck.compare("curve_horner", cmsm.horner(curve, ws, c), acc)
    return last, win


def horner_cases(torch, window_sums):
    """(label, window sums [LIMBS, K, W]) for curve_horner's checks: the
    window sums of every K4 case (the main path's K = 9, 7, 2 with IPA-round
    scalars, 1; random K = 2, a skewed row, the all-zero rows, a ragged
    N), one window (W = 1: no step), and a ragged K = 33 (a block's warps
    not filled) made of the K = 9 and K = 2 sums with their windows
    rotated."""
    cases = list(window_sums.items())
    cases.append(("W=1", tuple(t[..., :1].contiguous() for t in window_sums["K=9"])))
    parts = [tuple(torch.roll(t, r, dims=2) for t in window_sums[label])
             for label in ("K=9", "K=2") for r in range(3)]
    cases.append(("K=33", tuple(torch.cat(ts, dim=1).contiguous()
                                for ts in zip(*parts))))
    return cases


def horner_work(ws, c):
    """Bytes and IMAD slots of curve_horner's bounds: the window sums read
    once, one point an MSM written; (W - 1) (c doublings + 1 add) an MSM."""
    k, n_windows = ws[0].shape[1], ws[0].shape[2]
    return (3 * 32 * k * (n_windows + 1),
            k * (n_windows - 1) * (c * DBL_OPS + ADD_OPS))


def window_pow(x: int, e: int, w: int, p: int):
    """x^e mod p by a left-to-right sliding window of up to w bits:
    (x^e mod p, squares, multiplies).  The table x^1, x^3, ...,
    x^(2^w - 1) costs one square (x^2) and 2^(w-1) - 1 multiplies; the
    first window is read from it, and every later bit costs a square and
    every later window a multiply."""
    bits = bin(e)[2:]
    table = {1: x % p}
    squares = mults = 0
    if w > 1:
        x2 = x * x % p
        squares += 1
        for k in range(3, 1 << w, 2):
            table[k] = table[k - 2] * x2 % p
            mults += 1
    acc, i = None, 0
    while i < len(bits):
        if bits[i] == "0":
            acc, squares, i = acc * acc % p, squares + 1, i + 1
            continue
        j = min(i + w, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        if acc is None:
            acc = table[int(bits[i:j], 2)]
        else:
            for _ in range(j - i):
                acc = acc * acc % p
            acc = acc * table[int(bits[i:j], 2)] % p
            squares, mults = squares + j - i, mults + 1
        i = j
    return acc, squares, mults


def rescue_work(spec, security_bits: int, n: int):
    """Bytes and IMAD slots of K5's bounds for n permutations (top of
    file)."""
    from plonky_tpu_torch.fields.host import kth_root_exponent
    from plonky_tpu_torch.hashing.rescue import recommended_rounds

    def sbox(e):
        return min(sq * SQR_OPS + m * MUL_OPS for _x, sq, m in
                   (window_pow(2, e, w, spec.p) for w in range(1, 9)))
    per_round = (4 * (sbox(kth_root_exponent(spec, spec.alpha)) + sbox(spec.alpha))
                 + 2 * 4 * (4 * PRODUCT_OPS + REDC_OPS))
    return 2 * 4 * 32 * n, n * recommended_rounds(4, security_bits) * per_round


def ntt_cases():
    """(label, B, lg n, inverse, coset) of every transform of a steady prove
    of the 2^14 circuit (wires B = 9, the rest B = 1; n = 2^14 and the LDE
    domain 8n) and of its build (B = 6), the same at the fixtures' degree 8,
    and n = 2 and a ragged B = 5 at n = 2^10 in all four kinds."""
    cases = []
    for lg_n in (14, 3):
        lg8 = lg_n + 3
        for label, batch, lg, inverse, coset in (
                ("wire_ifft", 9, lg_n, True, False),
                ("wire_lde", 9, lg8, False, False),
                ("z_ifft", 1, lg_n, True, False),
                ("z8_fft", 1, lg8, False, False),
                ("vanishing_ifft", 1, lg8, True, False),
                ("coset_fft_8n", 1, lg8, False, True),
                ("coset_ifft_8n", 1, lg8, True, True),
                ("coset_fft_n", 1, lg_n, False, True),
                ("coset_ifft_n", 1, lg_n, True, True),
                ("build_ifft", 6, lg_n, True, False),
                ("build_lde", 6, lg8, False, False)):
            cases.append((f"2^{lg_n} {label}", batch, lg, inverse, coset))
    for batch, lg in ((3, 1), (5, 10)):
        for inverse in (False, True):
            for coset in (False, True):
                cases.append((f"[{batch}, 2^{lg}]", batch, lg, inverse, coset))
    return cases


def ntt_work(batch, lg, inverse, coset):
    """Bytes and IMAD slots of a whole transform's bounds (top of file)."""
    n = 1 << lg
    scaled = inverse or coset
    table = 32 * n if coset else (32 if inverse else 0)
    return (2 * 32 * batch * n + 32 * max(n - 2, 0) + table,
            MUL_OPS * (batch * (n // 2) * max(lg - 1, 0)
                       + (batch * n if scaled else 0)))


def product_sum_shapes():
    """(label, call site, N in units of the degree n (1, or 8 on the LDE
    domain), launches a steady prove makes ("rounds": one a round of the
    IPA, lg n in all), sums) of every product-sum launch of a steady prove
    of the BufferGate circuit.  A sum is a list of (a, b or None, sign);
    an operand name starting with "F" is a full [8, N] column, with "C" an
    [8, 1] challenge or constant; one name is one tensor, shared as the
    prove shares it."""
    def perm():
        f = [[(f"Ck{j}", "Fsubgroup", 1), (f"Fw{j}", None, 1), ("Cgamma", None, 1)]
             for j in range(6)]
        g = [[("Cbeta", f"Fsigma{j}", 1), (f"Fw{j}", None, 1), ("Cgamma", None, 1)]
             for j in range(6)]
        return f + g

    def fold(k):
        return [[(f"Cs{i}", f"Fp{i}", 1) for i in range(k)]]
    return [
        ("#1 ipa_fold", "protocol/halo.py:_ipa_fold", 1, "rounds",
         [[("Cu_inv", "Fa_hi", 1), ("Cu", "Fa", 1)],
          [("Cu_inv", "Fb", 1), ("Cu", "Fb_hi", 1)]]),
        ("#2 permutation", "protocol/prover.py:_permutation_parts", 1, 1, perm()),
        ("#3 halo_b", "protocol/halo.py:_build_halo_b", 1, 1, fold(3)),
        ("#4 pi_quotient", "protocol/prover.py:_pi_quotient", 1, 1, fold(9)),
        ("#5 halo_a", "protocol/halo.py:batch_opening_proof", 1, 1, fold(30)),
        ("#6 v_shift", "protocol/prover.py:_vanishing_poly", 8, 1,
         [[("Ff", "Fz", 1), ("Fg", "Fz_right", -1)]]),
        ("#7 vanishing_parts", "protocol/prover.py:_permutation_parts", 8, 1,
         perm()),
        ("#8 alpha_fold", "protocol/prover.py:_vanishing_poly", 8, 1, fold(10)),
    ]


def product_sum_inputs(named, full, col):
    """The sums `named` with each operand name replaced by a tensor,
    full(name) for an "F" name, col(name) for a "C" name, one per name."""
    made = {}

    def get(name):
        if name is not None and name not in made:
            made[name] = (full if name[0] == "F" else col)(name)
        return made.get(name)
    return [[(get(a), get(b), sign) for a, b, sign in terms] for terms in named]


def product_sum_counts(named) -> dict:
    """A launch's sums, products, singles, distinct full and [8, 1]
    operands and negative terms."""
    terms = [t for sum_ in named for t in sum_]
    names = {x for a, b, _s in terms for x in (a, b) if x is not None}
    return {"sums": len(named),
            "products": sum(b is not None for _a, b, _s in terms),
            "singles": sum(b is None for _a, b, _s in terms),
            "full_operands": sum(x[0] == "F" for x in names),
            "column_operands": sum(x[0] == "C" for x in names),
            "negatives": sum(s < 0 for _a, _b, s in terms)}


PS_KEYS = ("N", "sums", "products", "singles", "full_operands", "negatives")


def product_sum_key(named, n) -> tuple:
    """The PS_KEYS of a launch of the sums `named` over N = n."""
    c = product_sum_counts(named)
    return (n, *(c[k] for k in PS_KEYS[1:]))


@contextlib.contextmanager
def counting_product_sums(fops):
    """While open, counts field_product_sum's launches (one a call of
    fops._product_sums_launch) in a Counter keyed on PS_KEYS; a full
    operand is a distinct tensor of more than one element a limb."""
    counts = collections.Counter()
    launch = fops._product_sums_launch

    def counted(spec, sums, batch, splits=None):
        out = launch(spec, sums, batch, splits)
        terms = [t for sum_ in sums for t in sum_]
        full = {id(x) for a, b, _s in terms for x in (a, b)
                if x is not None and x[0].numel() > 1}
        counts[(out[0][0].numel(), len(sums),
                sum(b is not None for _a, b, _s in terms),
                sum(b is None for _a, b, _s in terms), len(full),
                sum(s < 0 for _a, _b, s in terms))] += 1
        return out
    fops._product_sums_launch = counted
    try:
        yield counts
    finally:
        fops._product_sums_launch = launch


def product_sum_work(named, n):
    """Bytes and IMAD slots of a product-sum launch's bounds: each distinct
    operand read once, each sum's output written once; per element and sum
    its products (PRODUCT_OPS each) and one reduction (REDC_OPS)."""
    c = product_sum_counts(named)
    return (32 * (n * (c["full_operands"] + c["sums"]) + c["column_operands"]),
            n * (c["products"] * PRODUCT_OPS + c["sums"] * REDC_OPS))


def k4_cases(np, torch, rng, dev):
    """(label, scalars [8, K, N] on the card) for every shape the main path
    gives K4 at the 2^14 circuit, and three edge cases: the commitments'
    K = 9 (wires) and 7 (t), K = 1 (z, pi, halo_g), the IPA rounds' K = 2
    with random and with round scalars (s_L zero where bit 13 of the index is
    clear, s_R where it is set, as protocol/halo.py:_ipa_round_scalars makes
    them in the first round), every scalar equal (each window row in one
    bucket), all zero, and a ragged N = 1000."""
    n = 1 << 14
    cases = []
    for k in (9, 7, 2, 1):
        scal = rand_field(np, torch, rng, (k, n), dev)
        if k == 9:
            scal[:, 0, :7] = 0
        cases.append((f"K={k}", scal))
    ipa = rand_field(np, torch, rng, (2, n), dev)
    bit = (torch.arange(n, device=dev) >> 13) & 1
    ipa[:, 0] *= bit.to(torch.int32)
    ipa[:, 1] *= (1 - bit).to(torch.int32)
    cases.append(("K=2 ipa", ipa))
    same = rand_field(np, torch, rng, (1, 1), dev)
    cases.append(("skewed", same.expand(8, 1, n).contiguous()))
    cases.append(("zero", torch.zeros((8, 1, n), dtype=torch.int32, device=dev)))
    cases.append(("ragged", rand_field(np, torch, rng, (2, 1000), dev)))
    return cases


def k4_inputs(torch, cmsm, sf, basis, scal, c):
    """msm's steps 1-2 (curves/msm.py) for scalars [8, K, N] over the first
    N points of `basis`: (sub-basis, sorted digits, order, run starts, the
    unsorted digit rows)."""
    from plonky_tpu_torch.curves import TWEEDLEDEE
    k, n = scal.shape[1], scal.shape[2]
    sub = cmsm.precompute_base(TWEEDLEDEE, (basis.x[:, :n], basis.y[:, :n],
                                            basis.z[:, :n]))
    digits = cmsm.scalar_window_digits(sf, scal, c)
    w = digits.shape[0]
    rows = digits.reshape(w, k, n).transpose(0, 1).reshape(k * w, n)
    sorted_digits, order = torch.sort(rows, dim=-1, stable=True)
    starts = cmsm._run_starts(sorted_digits, 1 << c)
    return (sub, sorted_digits.to(torch.int32).contiguous(),
            order.to(torch.int32).contiguous(), starts, rows)


def k4_work(rows, starts, acc):
    """Bytes and IMAD slots of K4's bounds for this run's digits.
    Accumulation: the basis, the sorted digits, the order and the run
    starts read once, the buckets and carries written once; one add per
    point beyond the first of each non-empty bucket.  Reduction: the
    buckets, carries and run starts read once, one point per row written;
    two adds per non-empty bucket (its running sum and its weighted sum)."""
    r, n = rows.shape
    live = int((rows != 0).sum().item())
    nonempty = int(((starts[:, 2:] - starts[:, 1:-1]) > 0).sum().item())
    out_bytes = 4 * sum(t.numel() for t in acc)
    acc_bytes = 96 * n + 8 * r * n + 4 * starts.numel() + out_bytes
    red_bytes = out_bytes + 4 * starts.numel() + 96 * r
    return (acc_bytes, ADD_OPS * (live - nonempty), red_bytes,
            ADD_OPS * 2 * nonempty)


def check_product_sums(ck: Checker, torch, np, dev, fops, sf) -> None:
    """field_product_sum held against product_sum_plain at every launch
    shape of a steady 2^14 prove (product_sum_shapes; random canonical
    values with the edge values first), each timed; then a ragged N, N = 1,
    32 products of (p - 1)(p - 1) all positive, all negative, and with
    b = 0 (the largest accumulator), 33 terms (two reductions and an add),
    12 mixed sums in one launch and 20 in two, and 1, 2 and 4 threads an
    element forced."""
    rng = np.random.default_rng(55)
    n = 1 << 14
    p = sf.p

    def inputs(named, n_elems):
        return product_sum_inputs(
            named,
            lambda _name: with_edges(fops, sf, rand_field(np, torch, rng, (n_elems,), dev)),
            lambda _name: rand_field(np, torch, rng, (1,), dev))

    def calls(sums):
        """(kernel call, plain call): product_sum for one sum, else
        product_sums."""
        if len(sums) == 1:
            return (lambda: fops.product_sum(sf, sums[0]),
                    lambda: fops.product_sum_plain(sf, sums[0]))
        return (lambda: tuple(fops.product_sums(sf, sums)),
                lambda: tuple(fops.product_sums_plain(sf, sums)))

    by_shape = []
    shapes = product_sum_shapes()
    for label, site, scale, launches, named in shapes:
        sums = inputs(named, scale * n)
        kernel, plain = calls(sums)
        ck.compare("field_product_sum", kernel(), plain())
        nbytes, nops = product_sum_work(named, scale * n)
        by_shape.append({"shape": label, "site": site, "N": scale * n,
                         **product_sum_counts(named), **ck.measure(
                             kernel, plain, nbytes, nops, plain_reps=1)})
    # edge cases, compared only
    fold = dict((s[0], s[4]) for s in shapes)
    for named, n_elems in ((fold["#8 alpha_fold"], (1 << 17) + 1),
                           (fold["#2 permutation"], (1 << 17) + 1),
                           (fold["#5 halo_a"], 1), (fold["#6 v_shift"], 1)):
        kernel, plain = calls(inputs(named, n_elems))
        ck.compare("field_product_sum", kernel(), plain())
    top = fops.from_ints(sf, [p - 1] * 1000, dev)
    zero = torch.zeros_like(top)
    for terms in ([(top, top, 1)] * 32, [(top, top, -1)] * 32,
                  [(top, zero, -1)] * 32, [(top, top, -1)] * 32 + [(top, None, -1)]):
        ck.compare("field_product_sum", fops.product_sum(sf, terms),
                   fops.product_sum_plain(sf, terms))
    n_mixed = n + 5
    for count in (12, 20):
        named = [[(f"{'C' if (i + t) % 3 == 0 and t else 'F'}a{i}_{t}",
                   None if t % 4 == 3 else f"{'C' if (i * t) % 5 == 1 else 'F'}b{i}_{t}",
                   -1 if (i + 2 * t) % 3 == 0 else 1) for t in range(1 + i % 12)]
                 for i in range(count)]
        kernel, plain = calls(inputs(named, n_mixed))
        ck.compare("field_product_sum", kernel(), plain())
    sums = inputs(fold["#5 halo_a"] + fold["#3 halo_b"], n)
    for splits in (1, 2, 4):
        got = fops._product_sums_launch(sf, sums, (n,), splits=splits)
        ck.compare("field_product_sum", tuple(got),
                   tuple(fops.product_sums_plain(sf, sums)))
    # the headline numbers are at #8, the launch with the largest bound
    ck.record("field_product_sum", {
        "main": "#8 alpha_fold", "n": n, "timed": [b["shape"] for b in by_shape],
        "checked": ["ragged 2^17 + 1", "N = 1", "32 x (p-1)^2, +, -, b = 0",
                    "33 terms", "12 and 20 mixed sums", "splits 1, 2, 4"]},
        by_shape=by_shape,
        measured=next(b for b in by_shape if b["shape"] == "#8 alpha_fold"))


def phase_kernels(ck: Checker, torch, np, dev) -> None:
    from plonky_tpu_torch.curves import TWEEDLEDEE
    from plonky_tpu_torch.curves import msm as cmsm
    from plonky_tpu_torch.curves import ops as cops
    from plonky_tpu_torch.fields import ops as fops
    from plonky_tpu_torch.poly import fft as pfft
    from plonky_tpu_torch.protocol.circuit import (pedersen_bases,
                                                   points_to_device)

    rng = np.random.default_rng(2024)
    sf = TWEEDLEDEE.scalar

    # K1 at the wire batch 9 n and one past it (a ragged grid)
    n1 = 9 << 14
    for n in (n1 + 1, n1):
        a, b, c = (with_edges(fops, sf, rand_field(np, torch, rng, (n,), dev))
                   for _ in range(3))
        col = rand_field(np, torch, rng, (1,), dev)
        for name, fn, plain in (("field_add", fops.add, fops.add_plain),
                                ("field_sub", fops.sub, fops.sub_plain),
                                ("field_mul", fops.mul, fops.mul_plain)):
            ck.compare(name, fn(sf, a, b), plain(sf, a, b))
            ck.compare(name, fn(sf, col, b), plain(sf, col, b))
            ck.compare(name, fn(sf, b, b), plain(sf, b, b))
        # an edge check of the product sum: column and full products, one
        # negative, and singles of both signs
        terms = [(col, a, 1), (b, c, -1), (a, None, 1), (c, None, -1)]
        ck.compare("field_product_sum", fops.product_sum(sf, terms),
                   fops.product_sum_plain(sf, terms))
    shapes = {"N": n1, "ragged_N": n1 + 1}
    for name, fn, plain in (("field_add", fops.add, fops.add_plain),
                            ("field_sub", fops.sub, fops.sub_plain)):
        ck.record(name, shapes, lambda fn=fn: fn(sf, a, b),
                  lambda plain=plain: plain(sf, a, b), 3 * 32 * n1, 0)
    # field_mul also at the sizes most launches of a steady prove take
    # (N = 2^14 and 2^17; N = 1 in the inversions' square-and-multiply)
    mul_by = []
    for n in (n1, 1 << 14, 1 << 17, 1):
        x, y = (rand_field(np, torch, rng, (n,), dev) for _ in range(2))
        ck.compare("field_mul", fops.mul(sf, x, y), fops.mul_plain(sf, x, y))
        mul_by.append({"N": n, **ck.measure(
            lambda x=x, y=y: fops.mul(sf, x, y),
            lambda x=x, y=y: fops.mul_plain(sf, x, y), 3 * 32 * n, MUL_OPS * n)})
    ck.record("field_mul", {**shapes, "timed_N": [b["N"] for b in mul_by]},
              by_shape=mul_by, measured=mul_by[0])
    check_product_sums(ck, torch, np, dev, fops, sf)

    # the Pedersen basis of the 2^14 circuit: real points for K2 and K4
    g_pts, _h, _u = pedersen_bases(TWEEDLEDEE, 1 << 14)
    basis = cmsm.precompute_base(TWEEDLEDEE, points_to_device(
        TWEEDLEDEE, g_pts, dev))

    # K2 on a ragged grid, 2^14 + 3: basis points plus the identity, P + P
    # and P + (-P)
    n2 = (1 << 14) + 3
    ident = cops.identity(TWEEDLEDEE, (1,), dev)
    g0 = tuple(t[:, :1] for t in (basis.x, basis.y, basis.z))
    g0_neg = cops.neg(TWEEDLEDEE, g0)
    p1 = tuple(torch.cat([t, i, g, g], dim=1).contiguous() for t, i, g in
               zip((basis.x, basis.y, basis.z), ident, g0))
    p2 = tuple(torch.cat([torch.roll(t, 1, dims=1), g, g, gn], dim=1)
               .contiguous() for t, g, gn in
               zip((basis.x, basis.y, basis.z), g0, g0_neg))
    assert p1[0].shape[1] == n2
    ck.compare("curve_add", cops.add(TWEEDLEDEE, p1, p2),
               cops.add_plain(TWEEDLEDEE, p1, p2))
    dbl_in = cops.add(TWEEDLEDEE, p1, p2)       # projective, Z != 1
    ck.compare("curve_double", cops.double(TWEEDLEDEE, dbl_in),
               cops.double_plain(TWEEDLEDEE, dbl_in))

    # K3: every transform of the steady 2^14 prove and of the circuit build,
    # the same at the fixtures' degree 8, and n = 2 (below one group) and a
    # ragged batch of 5 at n = 2^10, each held against the plain version;
    # timed at the 2^14 prove's shapes
    ntt_by = []
    for label, batch, lg, inverse, coset in ntt_cases():
        n = 1 << lg
        pre = pfft.FftPrecomputation(sf, n)
        x = with_edges(fops, sf, rand_field(np, torch, rng, (batch, n), dev))
        shift = sf.generator if coset else None
        ck.compare("ntt_pass", pfft.ntt(pre, x, inverse, shift),
                   pfft.ntt_plain(pre, x, inverse, shift))
        if label.startswith("2^14 "):
            nb, nops = ntt_work(batch, lg, inverse, coset)
            ntt_by.append({"shape": label, "B": batch, "n": n,
                           "inverse": inverse, "coset": coset,
                           "passes": len(pfft.pass_plan(lg)), **ck.measure(
                lambda pre=pre, x=x, inverse=inverse, shift=shift:
                    pfft.ntt(pre, x, inverse, shift),
                lambda pre=pre, x=x, inverse=inverse, shift=shift:
                    pfft.ntt_plain(pre, x, inverse, shift),
                nb, nops, reps=10, plain_reps=1)})
    # the headline numbers are at the wires' LDE, [9, 2^17] forward
    ck.record("ntt_pass", {"main": "2^14 wire_lde", "checked": [
        c[0] for c in ntt_cases()]}, by_shape=ntt_by,
        measured=next(b for b in ntt_by if b["shape"] == "2^14 wire_lde"))

    # K4 at every shape the main path gives it; the window sums feed the
    # checks of K2
    window_sums = {}
    acc_by, red_by = [], []
    c = 8
    for label, scal in k4_cases(np, torch, rng, dev):
        sub, digits, order, starts, rows = k4_inputs(torch, cmsm, sf, basis, scal, c)
        k, n = scal.shape[1], scal.shape[2]
        acc = cmsm.bucket_accumulate(TWEEDLEDEE, sub, digits, order, starts)
        ck.compare("msm_bucket_accumulate", acc, cmsm.bucket_accumulate_plain(
            TWEEDLEDEE, sub, digits, order, starts))
        ws = cmsm.bucket_reduce(TWEEDLEDEE, *acc, starts)
        ck.compare("msm_bucket_reduce", ws,
                   cmsm.bucket_reduce_plain(TWEEDLEDEE, *acc, starts))
        window_sums[label] = tuple(t.reshape(8, k, -1) for t in ws)
        shape = {"shape": label, "N": n, "K": k, "c": c, "rows": rows.shape[0]}
        acc_bytes, acc_ops, red_bytes, red_ops = k4_work(rows, starts, acc)
        acc_by.append({**shape, **ck.measure(
            lambda: cmsm.bucket_accumulate(TWEEDLEDEE, sub, digits, order, starts),
            lambda: cmsm.bucket_accumulate_plain(TWEEDLEDEE, sub, digits, order,
                                                 starts),
            acc_bytes, acc_ops, reps=10, plain_reps=1)})
        red_by.append({**shape, **ck.measure(
            lambda: cmsm.bucket_reduce(TWEEDLEDEE, *acc, starts),
            lambda: cmsm.bucket_reduce_plain(TWEEDLEDEE, *acc, starts),
            red_bytes, red_ops, reps=10, plain_reps=1)})
    # the headline numbers are at K = 9, the commitments' shape; by_shape
    # holds every shape
    shapes = {"main": "K=9", "N": 1 << 14, "c": c,
              "checked": [b["shape"] for b in acc_by]}
    ck.record("msm_bucket_accumulate", shapes, by_shape=acc_by,
              measured=acc_by[0])
    ck.record("msm_bucket_reduce", shapes, by_shape=red_by, measured=red_by[0])

    # K2's curve_horner on the window sums of every K4 case, W = 1 and a
    # ragged K, timed at the main path's K = 9 (wires), 7 (t), 2 (the IPA
    # rounds) and 1 (z, pi, halo_g)
    horner_by = []
    cases = horner_cases(torch, window_sums)
    for label, ws in cases:
        ck.compare("curve_horner", cmsm.horner(TWEEDLEDEE, ws, c),
                   cmsm.horner_plain(TWEEDLEDEE, ws, c))
        if label in ("K=9", "K=7", "K=2 ipa", "K=1"):
            hb, hops = horner_work(ws, c)
            horner_by.append({"shape": label, "K": ws[0].shape[1],
                              "W": ws[0].shape[2], "c": c, **ck.measure(
                lambda ws=ws: cmsm.horner(TWEEDLEDEE, ws, c),
                lambda ws=ws: cmsm.horner_plain(TWEEDLEDEE, ws, c),
                hb, hops, plain_reps=1)})
    # the headline numbers are at K = 2, the shape of 14 of the 19 MSMs of
    # a steady prove (the IPA rounds)
    ck.record("curve_horner", {"main": "K=2 ipa", "c": c,
                               "checked": [label for label, _ws in cases]},
              by_shape=horner_by,
              measured=next(b for b in horner_by if b["shape"] == "K=2 ipa"))

    # the elementwise K2 kernels, off the main path: every Horner step of
    # K = 9, 7, 2, 1 held against the plain version (and the chain's
    # result against curve_horner's), timed there and at 2^14 + 3
    add_by, dbl_by = [], []
    timed = {}
    for label in ("K=9", "K=7", "K=2 ipa", "K=1"):
        ws = window_sums[label]
        k = ws[0].shape[1]
        acc, win = check_horner(ck, cops, cmsm, TWEEDLEDEE, ws, c)
        timed[k] = (acc, win)
        add_by.append({"shape": [8, k], **ck.measure(
            lambda acc=acc, win=win: cops.add(TWEEDLEDEE, acc, win),
            lambda acc=acc, win=win: cops.add_plain(TWEEDLEDEE, acc, win),
            9 * 32 * k, ADD_OPS * k)})
        dbl_by.append({"shape": [8, k], **ck.measure(
            lambda acc=acc: cops.double(TWEEDLEDEE, acc),
            lambda acc=acc: cops.double_plain(TWEEDLEDEE, acc),
            6 * 32 * k, DBL_OPS * k)})
    add_by.append({"shape": [8, n2], **ck.measure(
        lambda: cops.add(TWEEDLEDEE, p1, p2),
        lambda: cops.add_plain(TWEEDLEDEE, p1, p2), 9 * 32 * n2,
        ADD_OPS * n2)})
    dbl_by.append({"shape": [8, n2], **ck.measure(
        lambda: cops.double(TWEEDLEDEE, dbl_in),
        lambda: cops.double_plain(TWEEDLEDEE, dbl_in), 6 * 32 * n2,
        DBL_OPS * n2)})
    # the headline numbers are at [8, 2], the shape of 14 of the 19 MSMs
    # of a steady prove (the IPA rounds)
    acc, win = timed[2]
    shapes = {"main": [8, 2], "horner_checked": [[8, k] for k in timed],
              "ragged_N": n2}
    ck.record("curve_add", shapes,
              lambda: cops.add(TWEEDLEDEE, acc, win),
              lambda: cops.add_plain(TWEEDLEDEE, acc, win), 9 * 32 * 2,
              ADD_OPS * 2, by_shape=add_by)
    ck.record("curve_double", shapes,
              lambda: cops.double(TWEEDLEDEE, acc),
              lambda: cops.double_plain(TWEEDLEDEE, acc), 6 * 32 * 2,
              DBL_OPS * 2, by_shape=dbl_by)


def phase_rescue(ck: Checker, torch, np, dev, name_power: str) -> int:
    """K5 against its plain version on a ragged batch of 2^10 + 3 for both
    Tweedle base fields at 128 and 64 security bits; the batch entry
    point's path (rescue_permutation on 2^14 states, the JAX package's bench
    size) driven with the launch counts reset, which must show one K5
    launch and nothing else, and held against the host permutation at 8
    lanes (the states 0 and p - 1 among them); then timed at 2^14 and 2^16
    beside its bound, and each whole batch (the path's output at 2^14)
    held against the plain version's output from its timing.  Returns the
    path's K5 launches."""
    from plonky_tpu_torch import _cuda
    from plonky_tpu_torch.fields import TWEEDLEDEE_BASE, TWEEDLEDUM_BASE
    from plonky_tpu_torch.fields import ops as fops
    from plonky_tpu_torch.hashing import rescue as hr

    rng = np.random.default_rng(1337)

    def states(spec, n):
        return [with_edges(fops, spec, rand_field(np, torch, rng, (n,), dev))
                for _ in range(4)]

    for spec in (TWEEDLEDEE_BASE, TWEEDLEDUM_BASE):
        for bits in (128, 64):
            state = states(spec, (1 << 10) + 3)
            ck.compare("rescue_permutation",
                       tuple(hr.rescue_permutation(spec, state, bits)),
                       tuple(hr.rescue_permutation_plain(spec, state, bits)))
    spec, bits, n = TWEEDLEDEE_BASE, 128, 1 << 14
    state = states(spec, n)
    lanes = [0, 1, 2, 3, n // 3, n // 2, n - 2, n - 1]
    for t in state:
        t[:, 0] = 0                                  # the zero state
        t[:, 1] = fops.column(spec, spec.p - 1, dev)[:, 0]
    _cuda.reset_launches()
    out = hr.rescue_permutation(spec, state, bits)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    if {k: v for k, v in launches.items() if v} != {"rescue_permutation": 1}:
        raise AssertionError(f"the Rescue batch launched {launches}, expected "
                             "one rescue_permutation")
    got = [fops.to_ints(spec, o[:, lanes]) for o in out]
    ins = [fops.to_ints(spec, t[:, lanes]) for t in state]
    for j, lane in enumerate(lanes):
        want = hr.rescue_permutation_host(spec, [int(x[j]) for x in ins], bits)
        if [int(g[j]) for g in got] != want:
            raise AssertionError(f"rescue_permutation differs from the host "
                                 f"permutation at lane {lane}")
    by_n = []
    for n_t in (n, 1 << 16):
        st = state if n_t == n else states(spec, n_t)
        if n_t == n:
            k5_out = out                             # the path's launch
        else:
            before = _cuda.LAUNCHES["rescue_permutation"]
            k5_out = hr.rescue_permutation(spec, st, bits)
            if _cuda.LAUNCHES["rescue_permutation"] != before + 1:
                raise AssertionError("one rescue_permutation launch a call "
                                     "expected")
        nb, nops = rescue_work(spec, bits, n_t)
        plain = {}

        def plain_fn(st=st, plain=plain):
            plain["out"] = hr.rescue_permutation_plain(spec, st, bits)
        m = ck.measure(lambda st=st: hr.rescue_permutation(spec, st, bits),
                       plain_fn, nb, nops, reps=10, plain_reps=1)
        # the whole batch against the plain output that was just timed
        ck.compare("rescue_permutation", tuple(k5_out), tuple(plain["out"]))
        by_n.append({"N": n_t, "security_bits": bits, "field": spec.name,
                     "perms_per_s": n_t / (m["ms"] * 1e-3), **m})
    emit({"phase": "rescue", "nvidia_smi": name_power, "path_launches": launches,
          "host_lanes": lanes, "perms_per_s": {
              str(b["N"]): b["perms_per_s"] for b in by_n}})
    ck.record("rescue_permutation", {
        "main": "2^14, TweedledeeBase, 128 bits", "lanes_vs_host": lanes,
        "checked": ["N = 2^10 + 3 x {TweedledeeBase, TweedledumBase} x "
                    "{128, 64} bits", "N = 2^14 and 2^16, TweedledeeBase, "
                    "128 bits, every lane"]},
        by_shape=by_n, measured=by_n[0])
    return launches["rescue_permutation"]


def pinned_random():
    import numpy as np
    rng = np.random.default_rng(1337)
    return lambda p: int.from_bytes(rng.bytes(40), "little") % p


def pinned_proof(build, source, device=None) -> dict:
    """With RANDOM_SOURCE (builder and halo) set to `source` throughout:
    build() -> (circuit, witness inputs), the witness and one prove; the
    proof verified with the G check on `device` (the card by default).
    Returns the circuit, public inputs, proof, its bytes and sha256, and
    the seconds taken."""
    import hashlib

    import plonky_tpu_torch.circuit.builder as builder_mod
    import plonky_tpu_torch.protocol.halo as halo_mod
    from plonky_tpu_torch.curves import TWEEDLEDEE, TWEEDLEDUM
    from plonky_tpu_torch.protocol import generate_proof, verify_proof
    from plonky_tpu_torch.protocol.serialization import proof_to_bytes

    saved = (builder_mod.RANDOM_SOURCE, halo_mod.RANDOM_SOURCE)
    builder_mod.RANDOM_SOURCE = halo_mod.RANDOM_SOURCE = source
    try:
        t0 = time.perf_counter()
        circuit, inputs = build()
        witness = circuit.generate_witness(inputs)
        proof = generate_proof(circuit, witness, old_proofs=[], blinding=True)
        prove_s = time.perf_counter() - t0
    finally:
        builder_mod.RANDOM_SOURCE, halo_mod.RANDOM_SOURCE = saved
    pis = circuit.get_public_inputs(witness)
    t0 = time.perf_counter()
    verify_proof(pis, proof, [], circuit.to_vk(), TWEEDLEDUM, verify_g=True,
                 device=device)
    data = proof_to_bytes(TWEEDLEDEE, proof)
    return {"circuit": circuit, "pis": pis, "proof": proof, "bytes": data,
            "sha256": hashlib.sha256(data).hexdigest(), "build_prove_s": prove_s,
            "verify_s": time.perf_counter() - t0}


def phase_fixtures() -> None:
    """The three committed fixtures (tests/test_proof_fixture.py) proved on
    the card under a fresh pinned_random(): proof and vk byte-equal to the
    files, and verified with the G check."""
    from plonky_tpu_torch.circuit import CircuitBuilder, PartialWitness
    from plonky_tpu_torch.curves import TWEEDLEDEE
    from plonky_tpu_torch.protocol.serialization import vk_to_bytes

    def trivial():
        b = CircuitBuilder(TWEEDLEDEE, security_bits=128)
        t = b.constant_wire(42)
        b.assert_zero(b.sub(t, b.constant_wire(42)))
        return b, PartialWitness()

    def sum_pi():
        b = CircuitBuilder(TWEEDLEDEE, security_bits=128)
        x, y = b.add_public_input(), b.add_public_input()
        z = b.add(x, y)
        out = b.add_public_input()
        b.copy(z, out)
        w = PartialWitness()
        w.set_target(x, 3)
        w.set_target(y, 39)
        w.set_target(out, 42)
        return b, w

    def curve_add():
        return gadget_circuits(port_modules())["curve_add"]()[:2]

    result = {"phase": "fixtures"}
    for name, make in (("trivial", trivial), ("sum_pi", sum_pi),
                       ("curve_add", curve_add)):
        def build(make=make):
            builder, inputs = make()
            return builder.build(), inputs
        got = pinned_proof(build, pinned_random())
        with open(os.path.join(FIXTURES, f"proof_{name}.hex")) as f:
            want_proof = f.read().strip()
        with open(os.path.join(FIXTURES, f"vk_{name}.hex")) as f:
            want_vk = f.read().strip()
        if got["bytes"].hex() != want_proof:
            raise AssertionError(f"{name}: proof bytes differ from the fixture")
        if vk_to_bytes(got["circuit"].to_vk()).hex() != want_vk:
            raise AssertionError(f"{name}: vk bytes differ from the fixture")
        result[name] = {"bytes_equal": True, "verified": True,
                        "build_prove_s": got["build_prove_s"],
                        "verify_s": got["verify_s"]}
    emit(result)


def phase_gadgets() -> None:
    """The circuits of tests/test_prove_verify_gadgets.py (gadget_circuits)
    proved on the card under a fresh gadget_random() each and verified with
    the G check; their public inputs must be the host's values, and each
    proof must hash to the JAX package's GADGET_PROOF_SHA256."""
    result = {"phase": "gadgets"}
    for name, make in gadget_circuits(port_modules()).items():
        want = []

        def build(make=make, want=want):
            builder, inputs, expected = make()
            want.extend(expected)
            return builder.build(), inputs
        got = pinned_proof(build, gadget_random())
        if got["pis"] != want:
            raise AssertionError(f"{name}: public inputs {got['pis']}, "
                                 f"expected {want}")
        if got["sha256"] != GADGET_PROOF_SHA256[name]:
            raise AssertionError(f"{name}: proof sha256 {got['sha256']}, the "
                                 f"JAX package's is {GADGET_PROOF_SHA256[name]}")
        result[name] = {"degree": got["circuit"].degree(), "verified": True,
                        "sha256": got["sha256"],
                        "build_prove_s": got["build_prove_s"],
                        "verify_s": got["verify_s"]}
    emit(result)


def phase_ladder(lg: int = 10) -> None:
    """The 2^lg BufferGate circuit built and proved once on the card under a
    fresh pinned_random(), verified with the G check; its proof must hash
    to the JAX package's PROOF_2E10_SHA256."""
    got = pinned_proof(lambda: buffer_circuit(lg), pinned_random())
    emit({"phase": f"ladder_2e{lg}", "sha256": got["sha256"], "verified": True,
          "degree": got["circuit"].degree(),
          "build_prove_s": got["build_prove_s"], "verify_s": got["verify_s"]})
    if got["sha256"] != PROOF_2E10_SHA256:
        raise AssertionError(f"the 2^{lg} proof's sha256 is {got['sha256']}, the "
                             f"JAX package's is {PROOF_2E10_SHA256}")


def port_modules():
    """The port's modules that gadget_circuits builds with."""
    import types

    from plonky_tpu_torch.circuit import CircuitBuilder, PartialWitness
    from plonky_tpu_torch.circuit.gadgets import curve as gadgets
    from plonky_tpu_torch.curves import TWEEDLEDEE, TWEEDLEDUM
    from plonky_tpu_torch.curves import host as chost
    from plonky_tpu_torch.hashing import rescue_hash_n_to_1_host
    return types.SimpleNamespace(
        CircuitBuilder=CircuitBuilder, PartialWitness=PartialWitness,
        gadgets=gadgets, TWEEDLEDEE=TWEEDLEDEE, TWEEDLEDUM=TWEEDLEDUM,
        chost=chost, rescue_hash_n_to_1_host=rescue_hash_n_to_1_host)


def gadget_circuits(m) -> dict:
    """name -> make(), each make() returning (builder, witness inputs, the
    expected public inputs) of the circuits of
    tests/test_prove_verify_gadgets.py on Tweedledee, built with the modules
    of the namespace m (port_modules(), or the same names from another
    package); "curve_add" is also the circuit of the curve_add fixture
    (tests/test_proof_fixture.py)."""
    g = m.chost.generator(m.TWEEDLEDUM)

    def builder():
        return m.CircuitBuilder(m.TWEEDLEDEE, security_bits=128)

    def export(b, point):
        pix, piy = b.add_public_input(), b.add_public_input()
        b.copy(point.x, pix)
        b.copy(point.y, piy)

    def rescue():
        ins = [12345, 67890]
        b = builder()
        out = b.rescue_hash_n_to_1([b.constant_wire(v) for v in ins])
        b.copy(out, b.add_public_input())
        return b, m.PartialWitness(), [m.rescue_hash_n_to_1_host(
            m.TWEEDLEDEE.scalar, ins, 128)]

    def curve_add():
        p1, p2 = m.chost.mul(g, 7), m.chost.mul(g, 11)
        b = builder()
        export(b, m.gadgets.curve_add(b, m.gadgets.constant_affine_point(b, p1),
                                      m.gadgets.constant_affine_point(b, p2)))
        want = m.chost.add(p1, p2)
        return b, m.PartialWitness(), [want.x, want.y]

    def curve_double():
        p1 = m.chost.mul(g, 5)
        b = builder()
        export(b, m.gadgets.curve_double(b, m.gadgets.constant_affine_point(b, p1)))
        want = m.chost.add(p1, p1)
        return b, m.PartialWitness(), [want.x, want.y]

    def base4sum():
        b = builder()
        x = b.add_virtual_target()
        b.assert_dibit_length(x, 8)   # x < 4^8
        b.copy(x, b.add_public_input())
        w = m.PartialWitness()
        w.set_target(x, 54321)
        return b, w, [54321]

    def curve_msm():
        p1, p2 = m.chost.mul(g, 3), m.chost.mul(g, 19)
        s1, s2 = 123456789, 987654321
        b = builder()
        ops = [m.gadgets.CurveMulOp(b.constant_wire(s), m.gadgets.constant_affine_point(b, pt))
               for s, pt in ((s1, p1), (s2, p2))]
        export(b, m.gadgets.curve_msm(b, m.TWEEDLEDUM, ops))
        want = m.chost.add(m.chost.mul(p1, s1), m.chost.mul(p2, s2))
        return b, m.PartialWitness(), [want.x, want.y]

    return {"rescue": rescue, "curve_add": curve_add, "curve_double": curve_double,
            "base4sum": base4sum, "curve_msm": curve_msm}


def gadget_random():
    """The random source tests/test_prove_verify_gadgets.py pins, fresh."""
    import numpy as np
    rng = np.random.default_rng(271828)
    return lambda p: int.from_bytes(rng.bytes(40), "little") % p


def buffer_circuit(lg: int, device=None):
    """The reference workload: a 2^lg-gate BufferGate circuit on Tweedledee
    (as bench.py builds it), built on `device` (the card by default), and
    its witness's inputs."""
    from plonky_tpu_torch.circuit import CircuitBuilder, PartialWitness
    from plonky_tpu_torch.circuit.gates import BufferGate
    from plonky_tpu_torch.curves import TWEEDLEDEE
    builder = CircuitBuilder(TWEEDLEDEE, security_bits=128)
    while builder.num_gates() < (1 << lg) - 3:
        builder.add_gate_no_constants(BufferGate(builder.num_gates()))
    return builder.build(device=device), PartialWitness()


def phase_prove(torch, lg: int = 14, want_sha256=None,
                check_launches: bool = True) -> dict:
    """Builds the 2^lg circuit, proves it twice and verifies the second
    proof, with RANDOM_SOURCE pinned for the whole phase (circuit build
    included), so the steady proof's bytes are fixed: their sha256 must be
    `want_sha256` when one is given.  With `check_launches`, the steady
    prove must have launched every kernel of KERNELS but OFF_PATH, none of
    OFF_PATH, curve_horner once per MSM, ntt_pass once per pass of each
    transform (len(pass_plan(lg n)) = ceil(lg n / NTT_MAX_LAYERS)), and
    field_product_sum at each shape of product_sum_shapes as often as it
    says, counted by shape (counting_product_sums).  Returns the steady
    prove's launches by kernel and, with `check_launches`, its product-sum
    launches by label of product_sum_shapes."""
    import hashlib

    import plonky_tpu_torch.circuit.builder as builder_mod
    import plonky_tpu_torch.protocol.halo as halo_mod
    from plonky_tpu_torch import _cuda
    from plonky_tpu_torch.curves import TWEEDLEDEE, TWEEDLEDUM
    from plonky_tpu_torch.fields import ops as fops
    from plonky_tpu_torch.protocol import generate_proof, verify_proof
    from plonky_tpu_torch.protocol.serialization import proof_to_bytes
    from plonky_tpu_torch.utils.timing import record_phases

    out = {"phase": f"prove_2e{lg}"}
    saved = (builder_mod.RANDOM_SOURCE, halo_mod.RANDOM_SOURCE)
    builder_mod.RANDOM_SOURCE = halo_mod.RANDOM_SOURCE = pinned_random()
    try:
        t0 = time.perf_counter()
        circuit, inputs = buffer_circuit(lg)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        witness = circuit.generate_witness(inputs)
        out["witness_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        generate_proof(circuit, witness, old_proofs=[], blinding=True)
        torch.cuda.synchronize()
        out["first_prove_s"] = time.perf_counter() - t0
        transforms = []
        counting = (counting_product_sums(fops) if check_launches
                    else contextlib.nullcontext(collections.Counter()))
        if check_launches:
            from plonky_tpu_torch.poly import fft as pfft
            ntt = pfft.ntt

            def counted(pre, x, inverse=False, shift=None):
                transforms.append(pre.lg_n)
                return ntt(pre, x, inverse, shift)
            pfft.ntt = counted
        _cuda.reset_launches()
        t0 = time.perf_counter()
        try:
            with record_phases() as phases, counting as ps_counts:
                proof = generate_proof(circuit, witness, old_proofs=[],
                                       blinding=True)
            torch.cuda.synchronize()
        finally:
            if check_launches:
                pfft.ntt = ntt
        out["steady_prove_s"] = time.perf_counter() - t0
    finally:
        builder_mod.RANDOM_SOURCE, halo_mod.RANDOM_SOURCE = saved
    launches = dict(_cuda.LAUNCHES)
    out["phases_s"] = phases
    out["launches"] = launches
    if check_launches:
        out["ntt_transforms"] = len(transforms)
        out["ntt_passes_expected"] = sum(len(pfft.pass_plan(t)) for t in transforms)
        expected = {label: (product_sum_key(named, scale << lg),
                            lg if times == "rounds" else times)
                    for label, _s, scale, times, named in product_sum_shapes()}
        ps_by_label = {label: ps_counts[key]
                       for label, (key, _t) in expected.items()}
        out["product_sum_launches_expected"] = sum(
            t for _k, t in expected.values())
        out["product_sum_by_shape"] = [
            {**dict(zip(PS_KEYS, k)), "launches": c}
            for k, c in sorted(ps_counts.items())]
    out["proof_sha256"] = hashlib.sha256(
        proof_to_bytes(TWEEDLEDEE, proof)).hexdigest()
    t0 = time.perf_counter()
    verify_proof(circuit.get_public_inputs(witness), proof, [],
                 circuit.to_vk(), TWEEDLEDUM, verify_g=True)
    out["verify_s"] = time.perf_counter() - t0
    out["verified"] = True
    out["degree"] = circuit.degree()
    emit(out)
    if want_sha256 is not None and out["proof_sha256"] != want_sha256:
        raise AssertionError(f"the pinned 2^{lg} proof's sha256 is "
                             f"{out['proof_sha256']}, not {want_sha256}")
    if check_launches:
        missing = [k for k, v in launches.items() if v == 0 and k not in OFF_PATH]
        if missing:
            raise AssertionError(f"the steady prove launched no {missing}")
        off = {k: launches[k] for k in OFF_PATH if launches[k]}
        if off:
            raise AssertionError(f"the steady prove launched {off} off its path")
        if launches["curve_horner"] != launches["msm_bucket_reduce"]:
            raise AssertionError("one curve_horner launch per MSM expected, got "
                                 f"{launches['curve_horner']} for "
                                 f"{launches['msm_bucket_reduce']} MSMs")
        if launches["field_product_sum"] != out["product_sum_launches_expected"]:
            raise AssertionError(f"{launches['field_product_sum']} field_product_sum "
                                 "launches, expected "
                                 f"{out['product_sum_launches_expected']}")
        if collections.Counter(dict(expected.values())) != ps_counts:
            raise AssertionError("field_product_sum launches by shape "
                                 f"{dict(ps_counts)}, expected "
                                 f"{dict(expected.values())}")
        if launches["ntt_pass"] != out["ntt_passes_expected"]:
            raise AssertionError(f"{launches['ntt_pass']} ntt_pass launches for "
                                 f"{len(transforms)} transforms, expected "
                                 f"{out['ntt_passes_expected']}")
        return launches, ps_by_label
    return launches, {}


def card(torch):
    """The card's nvidia-smi name/power line, its max SM clock in Hz, and
    its 32-bit IMAD issue rate (64 per SM per clock)."""
    name_power = smi("name,power.limit")
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return name_power, clock_hz, sms, 64.0 * sms * clock_hz


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import numpy as np
    from plonky_tpu_torch import _cuda

    dev = torch.device("cuda")
    name_power, clock_hz, sms, int_rate = card(torch)
    t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    ptxas = []
    if os.path.exists(_cuda.BUILD_LOG):
        with open(_cuda.BUILD_LOG) as f:
            ptxas = [ln.strip() for ln in f if "registers" in ln
                     or "spill" in ln]
    emit({"phase": "env", "nvidia_smi": name_power,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "sms": sms, "max_sm_clock_mhz": clock_hz / 1e6,
          "int32_imad_per_s": int_rate, "build_s": build_s,
          "built_now": _cuda.BUILD_SECONDS[0] is not None, "ptxas": ptxas})

    ck = Checker(torch, clock_hz, int_rate)
    phase_kernels(ck, torch, np, dev)
    rescue_launches = phase_rescue(ck, torch, np, dev, name_power)
    phase_fixtures()
    phase_gadgets()
    phase_ladder()
    launches, ps_by_label = phase_prove(torch, want_sha256=PROOF_2E14_SHA256)
    launches["rescue_permutation"] = rescue_launches
    for name, rec in ck.records.items():
        rec["launches"] = launches[name]
    for row in ck.records["field_product_sum"]["by_shape"]:
        row["launches_per_prove"] = ps_by_label[row["shape"]]
    emit({"kernels": list(ck.records.values())})
    print(name_power, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
