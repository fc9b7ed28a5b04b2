#!/usr/bin/env python3
"""Chip check of plonky_tpu_torch on one NVIDIA GPU (written for the H100).

Builds the CUDA kernels from plonky_tpu_torch/csrc, holds every kernel
against its plain PyTorch version on the card at the main path's shapes
(exact equality: all of it is integer arithmetic; the NTT at every
transform shape of the prove and the fixtures), drives the batch Rescue
permutation's path (K5 against its plain version on a ragged batch of both
Tweedle base fields and BLS12-377's scalar field at 128 and 64 security
bits, one launch for 2^14 permutations held against the host permutation
at sampled lanes, timed at 2^14 and 2^16 and held there against the plain
version on every lane),
drives BLS12-377 G1 (phase_bls12_377: the 12-limb builds of K1, K2 and K4
held against their plain versions at ragged shapes, the JAX package's
microbench sizes timed, the path driven once with the launch counts reset,
and `msm_chunked` at 2^16 to 2^22 points timed and held against a
discrete-log oracle, with signed windows beside unsigned), drives the
polynomial path over BLS12-377's base field (phase_bls12_377_poly: the
12-limb NTT, four-step transpose, product sum and Rescue against their
plain versions, then fft / ifft at 2^22 and [9, 2^20], the coset pair,
divide_by_z_h and eval_at_dyn at 2^20, fft_four_step and the sharded FFT
at 2^22, product sums at 2^20 and Rescue at 2^14 and 2^16 once with the
launch counts reset, every result checked and each kernel timed), sweeps
K4 over every window width from 2 to 12, signed and unsigned, at both widths
(k4_sweep), runs the probe (phase_probe: the flat NTT against the
four-step FFT at 2^20 and 2^22, the Tweedledee MSM at 2^18 unsigned
against signed windows, every result checked, both paths' launches
asserted), drives plonky_tpu_torch/parallel (phase_parallel: the cards
counted and named, the domain-sharded FFT at 2^22 over 4 shards, the
batch-sharded FFT of [9, 2^17] over 3, the sharded MSM at 2^18 over 4 and
at 5 x 256 over 5, on virtual shards of the first card and, with two
cards or more, over the cards, each equal to the one-card result and
timed beside it, every mesh card launched on, a launch on two cards
refused, every shape held against its plain version; then the
distributed step in NCCL processes), reproduces the three committed fixture proofs byte
for byte, proves and verifies the gadget circuits and the 2^10 BufferGate
circuit, each at the JAX package's sha256, then builds, proves (twice) and
verifies the 2^14-gate BufferGate circuit with the random source pinned,
checks the steady proof's sha256, and shows that the steady prove launched
every kernel of the main path (field_exp once per exp_const call, which
phase_kernels holds on 0, 1 and at N = 1, 2^14 + 3 and 2^17, and
phase_bls12_377 at 12 limbs at N = 1, 2^16 + 3 and 2^16, where the path's
to_affine makes exactly one; curve_add and curve_double, checked here,
are off it: the MSM's Horner runs in curve_horner; rescue_permutation,
the 12-limb kernels, the signed accumulate and ntt_twiddle_transpose have
their own paths), and last drives the reference's recursion workload
(phase_recursion: a 2^14-gate inner proof, the level-1 recursion circuit
that verifies it and its proof, the level-2 circuit that verifies that
proof and consumes the inner proof's OldProof, each recursive prove at a
pinned sha256 and launching every kernel of the main path, every shape
they give a kernel held against its plain version), then the Pallas/Vesta
cycle (phase_pasta: K1-K4 held against their plain versions on both Pasta
fields and curves in phase_kernels, K5 in phase_rescue; the trivial and
sum_pi proofs over both curves byte-equal to the JAX package's fixtures,
and the 2^14 BufferGate circuit over Pallas proved and verified at a
pinned sha256), and last plookup (phase_plookup: the reference test's
n = 7 proof at the JAX package's sha256, then a 16-bit range check,
n + 1 = 2^16, proved at a pinned sha256, verified, a changed opening
rejected and a value outside the table refused; every shape of both new
paths held against its plain version).

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
import operator
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
# sha256 of proof_to_bytes of phase_recursion's level-1 and level-2 proofs
# (the recursion circuits over Tweedledee and Tweedledum that verify the
# 2^RECURSION_INNER_LG-gate inner proof, then the level-1 proof) under one
# pinned_random(): the port's own values, taken on the H100; the JAX
# package has not made these proofs.
RECURSION_INNER_LG = 14
RECURSION_L1_SHA256 = ("3bdbaf42974da9a08778b53e3fc5c0ea"
                       "c5a0590b92cbb7aa6a44c549b134c05a")
RECURSION_L2_SHA256 = ("f26dcfb2e35904b845dbcb3d9359f40e"
                       "00e0def73f7285bf54a9383aece646e0")
# phase_pasta: the 2^PASTA_LG BufferGate circuit over Pallas (Vesta the
# inner curve); the sha256 of proof_to_bytes of its steady proof under
# pinned_random(), the port's own value, taken on the H100.
PASTA_LG = 14
PROOF_PALLAS_2E14_SHA256 = ("5e4c3256b440faf0397de26bccd09e5f"
                            "fee7a6f9abe9d611d89edd5ffcdb68db")
# phase_plookup: a range check over [0, 2^PLOOKUP_LG) on Tweedledee; the
# sha256 of PlookupProof.to_bytes of its proof under pinned_random() (the
# port's own value, taken on the H100), and of the reference test's n = 7
# proof (tests/test_plookup.py's inputs and random source), the JAX
# package's value under tests/test_torch_plookup.py's adapter.
PLOOKUP_LG = 16
PLOOKUP_2E16_SHA256 = ("ebe68555ce38ea7525da40c1181e8c48"
                       "01dd940c837581e03a0bf2c1d2335e3b")
PLOOKUP_N7_SHA256 = ("1a80a1de3d9b53499aa018f38f65d491"
                     "1d1218d95346ad1fac13e4194c6f8bf5")
# The fields of each shape the recursion phase holds against its plain
# version (PathRecorder.hold), as its recursion_shapes line lists them.
RECURSION_SHAPE_KEYS = ("shape", "launches_level1", "launches_level2", "ms",
                        "cold_ms", "plain_ms", "bound_ms", "bound_by", "share")
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
    "field_exp": (_CSRC + "field_kernels.cu", "plonky_tpu/fields/ops.py:598",
                  "field_exp_kernel"),
    "curve_add": (_CSRC + "curve_kernels.cu", "plonky_tpu/curves/ops.py:93",
                  "curve_add_kernel"),
    "curve_double": (_CSRC + "curve_kernels.cu", "plonky_tpu/curves/ops.py:93",
                     "curve_double_kernel"),
    "curve_horner": (_CSRC + "curve_kernels.cu", "plonky_tpu/curves/msm.py:401",
                     "curve_horner_kernel"),
    "ntt_pass": (_CSRC + "ntt_kernels.cu", "plonky_tpu/poly/fft.py:124",
                 "ntt_pass_kernel"),
    "ntt_twiddle_transpose": (_CSRC + "ntt_kernels.cu",
                              "plonky_tpu/poly/fft.py:256",
                              "ntt_twiddle_transpose_kernel"),
    "msm_bucket_accumulate": (_CSRC + "msm_kernels.cu",
                              "plonky_tpu/curves/msm.py:95",
                              "msm_bucket_accumulate_kernel"),
    "msm_bucket_accumulate_signed": (_CSRC + "msm_kernels.cu",
                                     "plonky_tpu/curves/msm.py:351",
                                     "msm_bucket_accumulate_signed_kernel"),
    "msm_bucket_reduce": (_CSRC + "msm_kernels.cu",
                          "plonky_tpu/curves/msm.py:376",
                          "msm_bucket_reduce_kernel"),
    "rescue_permutation": (_CSRC + "rescue_kernels.cu",
                           "plonky_tpu/hashing/rescue.py:162",
                           "rescue_permutation_kernel"),
}
# The 12-limb builds of every kernel (BLS12-377's base field; the same
# sources built with -DPT_LIMBS=12, kernels in namespace pt_l12), which
# replace the same TPU kernels instantiated at BLS12_377_BASE.
KERNELS.update({f"{k}_l12": (source, replaces, "pt_l12::" + symbol)
                for k, (source, replaces, symbol) in list(KERNELS.items())})
# The kernels of the unsigned BLS12-377 G1 path (phase_bls12_377's path
# run); the signed accumulate has a run of its own there.
BLS_PATH = ("field_add", "field_sub", "field_mul", "field_exp", "curve_add",
            "curve_double", "curve_horner", "msm_bucket_accumulate",
            "msm_bucket_reduce")
# The 12-limb kernels of the polynomial path over BLS12-377's base field
# (phase_bls12_377_poly): the NTT, the four-step transpose, the product
# sum and Rescue.
BLS_POLY_PATH = ("ntt_pass", "ntt_twiddle_transpose", "field_product_sum",
                 "rescue_permutation")
# Checked against their plain versions, but off the prove's path: the MSM's
# Horner runs in curve_horner, the batch Rescue permutation has its own
# path (phase_rescue), and so do the 12-limb kernels (phase_bls12_377 and
# phase_bls12_377_poly), the signed-window MSM and the four-step FFT
# (phase_probe).
OFF_PATH = ("curve_add", "curve_double", "rescue_permutation",
            "msm_bucket_accumulate_signed", "ntt_twiddle_transpose",
            *(k for k in KERNELS if k.endswith("_l12")))

# The operations bound counts the multiplies a function needs at least, in
# 32-bit IMAD issue slots (64 per SM per clock): a 32 x 32 -> 64-bit
# product is two of them (its low and its high half).  An L-limb product is
# L^2 wide products (64 at 8 limbs, 144 at 12); a square L (L + 1) / 2 (L
# squares, the doubled cross products); one Montgomery reduction is L
# rounds of a low-half quotient digit and L wide products.  Additions, and
# multiplies by the small constants 3 and b3 = 3b (3, 15 or 21), are not
# counted: the bound is a floor.
WIDE = 2


def product_ops(nl: int) -> int:
    return nl * nl * WIDE                       # 128 at 8 limbs, 288 at 12


def redc_ops(nl: int) -> int:
    return nl * (1 + nl * WIDE)                 # 136 at 8 limbs, 300 at 12


def mul_ops(nl: int) -> int:
    return product_ops(nl) + redc_ops(nl)       # 264 at 8 limbs, 588 at 12


def sqr_ops(nl: int) -> int:
    return nl * (nl + 1) // 2 * WIDE + redc_ops(nl)   # 208, 456


REDC_OPS = redc_ops(8)
PRODUCT_OPS = product_ops(8)
# The reduction for p = 2^254 + c, c < 2^128, p = 1 mod 2^32 (both Tweedle
# base fields; csrc/field.cuh, cc_redc's SPARSE rows): -p^-1 = -1 mod
# 2^32, so a row's quotient digit m is a negation, not a multiply, and m p
# is m + m c1 2^32 + m c2 2^64 + m c3 2^96 + m 2^254, three wide products
# and a shift: 8 rows of 3 wide products, 48 slots where the dense
# reduction takes 136.  A multiply is then 128 + 48 = 176 slots, a square
# 72 + 48 = 120.  Every kernel's bound over such a field counts these
# (field_costs; the Pasta base fields have the shape too), every other
# field's the dense ones.
SPARSE_REDC_OPS = 8 * 3 * WIDE
SPARSE_MUL_OPS = PRODUCT_OPS + SPARSE_REDC_OPS
SPARSE_SQR_OPS = 8 * 9 // 2 * WIDE + SPARSE_REDC_OPS
# A batch of n Rescue permutations of width 4 (rescue_work): per round, each
# element's inverse S-box x^e (e = kth_root_exponent(p, alpha), 254 bits)
# and forward S-box x^alpha, each counted by the cheapest of the
# sliding-window chains of 1 to 5 bits (sbox_ops: for e, 5-bit windows,
# 250 squares and 56 multiplies on TweedledeeBase, 55 on TweedledumBase;
# for 5, 2 squares and 1 multiply), and the two MDS mixes (4 products and
# one reduction an output element), at the field's costs (field_costs:
# 120-slot squares, 176-slot multiplies and 48-slot reductions on the
# Tweedle base fields, ~41,400 slots an element and round; 208, 264 and
# 136 on others); 4 elements read and written per permutation.
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


def share(timing: dict) -> float:
    """bound_ms over the kernel's time: the L2-flushed time where the bound
    is device-memory bytes (an L2-warm launch can beat that bound), the
    warm time where it is operations."""
    cold = timing["bound_by"] == "bytes"
    return timing["bound_ms"] / timing["cold_ms" if cold else "ms"]


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

    def time_ms(self, fn, reps: int, warm: bool = True) -> float:
        """Mean time per call of `reps` calls in a row, host work included
        wherever the host is slower than the card; after one call more
        unless `warm` is False."""
        torch = self.torch
        if warm:
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

    def plain_ms(self, fn, reps: int) -> float:
        """A plain version's time per call: `reps` calls after a warm one,
        or the warm call's own time where it took a second or more."""
        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        if first_s >= 1.0:
            return first_s * 1e3
        return self.time_ms(fn, reps, warm=False)

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
        included; plain_ms: the plain version's call, after one warm call
        where that call took under a second (the plain versions of K4 and
        K5 take seconds a call: their time is that one cold call)."""
        flush = self.flush.zero_
        cold = self.queued_ms(lambda: (flush(), kernel_fn()), reps)
        t_bytes = bytes_ / HBM_BYTES_PER_S
        t_ops = ops / self.rate
        return {"ms": self.queued_ms(kernel_fn, reps),
                "cold_ms": cold - self.queued_ms(flush, reps),
                "call_ms": self.time_ms(kernel_fn, reps),
                "plain_ms": self.plain_ms(plain_fn, plain_reps),
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    def hold(self, name: str, kernel_fn, plain_fn, bytes_, ops, reps=10) -> dict:
        """kernel_fn's output held against plain_fn's, the plain call run
        (and timed) once; then measure()'s device times of kernel_fn."""
        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain_fn()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        self.compare(name, kernel_fn(), want)
        del want
        flush = self.flush.zero_
        cold = self.queued_ms(lambda: (flush(), kernel_fn()), reps)
        ms = self.queued_ms(kernel_fn, reps)
        t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / self.rate
        bound_ms = max(t_bytes, t_ops) * 1e3
        out = {"ms": ms, "cold_ms": cold - self.queued_ms(flush, reps),
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        return {**out, "share": share(out)}

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
               "share": share(timing),
               "library_ms": None, "checked": True, "shapes": shapes}
        if by_shape is not None:
            rec["by_shape"] = by_shape
        self.records[name] = rec
        emit({"phase": f"kernel:{name}", **rec})


def rand_field(np, torch, rng, shape, device, spec=None):
    """Canonical random elements below 2^(bits - 1) < p (2^254 for the
    Tweedle fields, the default) as [L, *shape]."""
    nl, bits = (8, 255) if spec is None else (spec.limbs, spec.bits)
    limbs = rng.integers(0, 1 << 32, size=(nl,) + tuple(shape),
                         dtype=np.uint64).astype(np.uint32)
    top = bits - 1 - 32 * (nl - 1)
    limbs[nl - 1] &= (1 << top) - 1
    return torch.from_numpy(limbs.view(np.int32).copy()).to(device)


def with_edges(fops, spec, x):
    """x with 0, 1, p-1, p-2 as its first elements."""
    flat = x.reshape(x.shape[0], -1)
    edges = fops.from_ints(spec, [0, 1, spec.p - 1, spec.p - 2], x.device)
    k = min(4, flat.shape[1])
    flat[:, :k] = edges[:, :k]
    return x


def exp_cases(spec) -> dict:
    """The exponents field_exp is held at: the inverse's p - 2 and the
    alpha-th root's (the Rescue S-box's and kth_root's exponent)."""
    from plonky_tpu_torch.fields.host import kth_root_exponent
    return {"p-2": spec.p - 2,
            f"1/{spec.alpha}": kth_root_exponent(spec, spec.alpha)}


def check_exp(ck: Checker, torch, np, rng, dev, spec, sizes, main_n: int) -> None:
    """field_exp (or field_exp_l12) held against exp_const_plain on the
    card: on 0, 1 and a random value at N = 1, and at each of `sizes` with
    0, 1, p - 1 and p - 2 first, for each of exp_cases, and on a [L, 3, 5]
    batch and an expanded [L, 1] column; timed for p - 2 at N = 1 and at
    each of `sizes` (the record's headline at main_n)."""
    from plonky_tpu_torch.fields import ops as fops
    name = "field_exp" if spec.limbs == 8 else f"field_exp_l{spec.limbs}"
    exps = exp_cases(spec)
    e = spec.p - 2
    ones = [fops.from_ints(spec, [v], dev) for v in (0, 1)]
    ones.append(rand_field(np, torch, rng, (1,), dev, spec))
    inputs = [(1, x) for x in ones] + [
        (n, with_edges(fops, spec, rand_field(np, torch, rng, (n,), dev, spec)))
        for n in sizes]
    inputs.append((15, rand_field(np, torch, rng, (3, 5), dev, spec)))
    inputs.append((7, rand_field(np, torch, rng, (1,), dev, spec).expand(spec.limbs, 7)))
    by = []
    for n, x in inputs:
        timed = n in sizes or x is ones[-1]
        for ek in exps.values():
            if timed and ek == e:      # held and timed, the plain chain run once
                def kernel(x=x):
                    return fops.exp_const(spec, x, e)
                by.append({"N": n, "e": "p-2", **ck.hold(
                    name, kernel, lambda x=x: fops.exp_const_plain(spec, x, e),
                    *exp_work(spec, e, n)), "call_ms": ck.time_ms(kernel, 10)})
            else:
                ck.compare(name, fops.exp_const(spec, x, ek),
                           fops.exp_const_plain(spec, x, ek))
    ck.record(name, {"main": f"N = {main_n}, e = p - 2", "exponents": list(exps),
                     "checked": ["N = 1: 0, 1, random", *(f"N = {n}" for n in sizes),
                                 "[3, 5]", "[1] expanded to 7"]},
              by_shape=by, measured=next(b for b in by if b["N"] == main_n))


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


def horner_work(ws, c, f):
    """Bytes and IMAD slots of curve_horner's bounds over base field f: the
    window sums read once, one point an MSM written; (W - 1) (c doublings
    + 1 add) an MSM."""
    k, n_windows = ws[0].shape[1], ws[0].shape[2]
    add, dbl = point_costs(f)
    return (3 * 4 * f.limbs * k * (n_windows + 1),
            k * (n_windows - 1) * (c * dbl + add))


def sbox_ops(spec, e: int) -> int:
    """IMAD slots of the least work for x^e: the cheapest of the sliding
    window chains of 1 to 5 bits (fields/chain.py:sbox_schedule, which
    makes K5's and field_exp's chains), its squares and multiplies at the
    field's costs (field_costs)."""
    from plonky_tpu_torch.fields import chain
    sqr, mul, _redc = field_costs(spec)
    return min(sq * sqr + m * mul for sq, m in
               (chain.schedule_counts(chain.sbox_schedule(e, w))
                for w in range(1, chain.SBOX_MAX_WINDOW + 1)))


def field_costs(spec) -> tuple:
    """(square, multiply, reduction) in IMAD slots over a field: the sparse
    REDC's where p = 2^254 + c (fields/chain.py:sparse_prime: 120, 176 and
    48), else the dense ones at the field's width (208, 264 and 136 at 8
    limbs, 456, 588 and 300 at 12)."""
    from plonky_tpu_torch.fields.chain import sparse_prime
    if sparse_prime(spec):
        return SPARSE_SQR_OPS, SPARSE_MUL_OPS, SPARSE_REDC_OPS
    nl = spec.limbs
    return sqr_ops(nl), mul_ops(nl), redc_ops(nl)


def point_costs(f) -> tuple:
    """(add, double) in IMAD slots over base field f: RCB15 Alg. 7 (a = 0)
    12 M (+ 2 by b3), Alg. 9 6 M + 2 S (+ 1 by b3)."""
    sqr, mul, _redc = field_costs(f)
    return 12 * mul, 6 * mul + 2 * sqr


def exp_work(spec, e: int, n: int):
    """Bytes and IMAD slots of field_exp's bounds for x^e over n elements:
    x read and x^e written once; the cheapest sliding-window chain's
    squares and multiplies at the field's costs (sbox_ops)."""
    return 2 * 4 * spec.limbs * n, n * sbox_ops(spec, e)


def rescue_work(spec, security_bits: int, n: int):
    """Bytes and IMAD slots of K5's bounds for n permutations (top of
    file), at the field's width."""
    from plonky_tpu_torch.fields.host import kth_root_exponent
    from plonky_tpu_torch.hashing.rescue import recommended_rounds
    _sqr, _mul, redc = field_costs(spec)
    nl = spec.limbs
    per_round = (4 * (sbox_ops(spec, kth_root_exponent(spec, spec.alpha))
                      + sbox_ops(spec, spec.alpha))
                 + 2 * 4 * (4 * product_ops(nl) + redc))
    return (2 * 4 * 4 * nl * n,
            n * recommended_rounds(4, security_bits) * per_round)


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


def ntt_work(batch, lg, inverse, coset, f):
    """Bytes and IMAD slots of a whole transform's bounds (top of file)
    over field f (an element is 4 L bytes, a product field_costs(f)'s
    multiply: 176 slots on the sparse 8-limb fields, 588 at 12 limbs)."""
    n = 1 << lg
    scaled = inverse or coset
    elem = 4 * f.limbs
    table = elem * n if coset else (elem if inverse else 0)
    return (2 * elem * batch * n + elem * max(n - 2, 0) + table,
            field_costs(f)[1] * (batch * (n // 2) * max(lg - 1, 0)
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


@contextlib.contextmanager
def counting_exps(fops):
    """While open, counts fops.exp_const's calls with an exponent above 0
    (each one field_exp launch on the card; e = 0 stays on the host) in a
    Counter keyed on (field, N, exponent bits)."""
    counts = collections.Counter()
    exp_const = fops.exp_const

    def counted(spec, x, e):
        if e > 0:
            counts[(spec.name, x[0].numel(), e.bit_length())] += 1
        return exp_const(spec, x, e)
    fops.exp_const = counted
    try:
        yield counts
    finally:
        fops.exp_const = exp_const


def product_sum_work(named, n, f):
    """Bytes and IMAD slots of a product-sum launch's bounds over field f:
    each distinct operand read once, each sum's output written once; per
    element and sum its products (product_ops: 128 at 8 limbs, 288 at 12)
    and one reduction (field_costs: 48 sparse, 136 dense at 8 limbs; 300
    at 12)."""
    c = product_sum_counts(named)
    nl = f.limbs
    return (4 * nl * (n * (c["full_operands"] + c["sums"]) + c["column_operands"]),
            n * (c["products"] * product_ops(nl) + c["sums"] * field_costs(f)[2]))


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


def k4_rows(torch, cmsm, sf, scal, c):
    """msm's steps 1-2 (curves/msm.py) for scalars [8, K, N]: (sorted
    digits, order, run starts, the unsorted digit rows)."""
    k, n = scal.shape[1], scal.shape[2]
    digits = cmsm.scalar_window_digits(sf, scal, c)
    w = digits.shape[0]
    rows = digits.reshape(w, k, n).transpose(0, 1).reshape(k * w, n)
    sorted_digits, order = torch.sort(rows, dim=-1, stable=True)
    starts = cmsm._run_starts(sorted_digits, 1 << c)
    return (sorted_digits.to(torch.int32).contiguous(),
            order.to(torch.int32).contiguous(), starts, rows)


def k4_inputs(torch, cmsm, sf, basis, scal, c):
    """k4_rows over the first N points of `basis`, with that sub-basis
    first."""
    from plonky_tpu_torch.curves import TWEEDLEDEE
    n = scal.shape[2]
    sub = cmsm.precompute_base(TWEEDLEDEE, (basis.x[:, :n], basis.y[:, :n],
                                            basis.z[:, :n]))
    return (sub, *k4_rows(torch, cmsm, sf, scal, c))


def k4_work(rows, starts, acc, f):
    """Bytes and IMAD slots of K4's bounds for this run's digits over base
    field f (L = f.limbs limbs a coordinate).  Accumulation: the basis, the sorted digits, the
    order and the run starts read once, the buckets and carries written
    once; one add per point beyond the first of each non-empty bucket.
    Reduction: the buckets, carries and run starts read once, one point per
    row written; two adds per non-empty bucket (its running sum and its
    weighted sum)."""
    r, n = rows.shape
    point = 12 * f.limbs                     # bytes of X, Y, Z
    add = point_costs(f)[0]
    live = int((rows != 0).sum().item())
    nonempty = int(((starts[:, 2:] - starts[:, 1:-1]) > 0).sum().item())
    out_bytes = 4 * sum(t.numel() for t in acc)
    acc_bytes = point * n + 8 * r * n + 4 * starts.numel() + out_bytes
    red_bytes = out_bytes + 4 * starts.numel() + point * r
    return (acc_bytes, add * (live - nonempty), red_bytes, add * 2 * nonempty)


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
        nbytes, nops = product_sum_work(named, scale * n, sf)
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


def check_twiddle_tables(torch, spec, lg: int, dev) -> None:
    """The twiddle tables the card builds at n = 2^lg, forward and
    inverse, against python ints: layer ell (half-size m = 2^ell) holds
    w^j, j < m, w = g^(n / 2m), in Montgomery form."""
    from plonky_tpu_torch.fields import ops as fops
    from plonky_tpu_torch.poly import fft as pfft
    pre = pfft.FftPrecomputation(spec, 1 << lg)
    for inverse in (False, True):
        root, ints = pre.g_inv if inverse else pre.g, []
        for ell in range(pre.lg_n):
            w, cur = pow(root, pre.n >> (ell + 1), spec.p), 1 << 256
            for _ in range(1 << ell):
                ints.append(cur % spec.p)
                cur = cur % spec.p * w
        if not torch.equal(pre.twiddles(dev, inverse, montgomery=True),
                           fops.from_ints(spec, ints, dev)):
            raise AssertionError(f"{spec.name}: the card's twiddle table is "
                                 "not the host's")


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
            lambda x=x, y=y: fops.mul_plain(sf, x, y), 3 * 32 * n,
            field_costs(sf)[1] * n)})
    ck.record("field_mul", {**shapes, "timed_N": [b["N"] for b in mul_by]},
              by_shape=mul_by, measured=mul_by[0])
    check_product_sums(ck, torch, np, dev, fops, sf)
    # field_exp at N = 1 (an inversion of one value), a ragged N and the
    # prove's 8n
    check_exp(ck, torch, np, rng, dev, sf, ((1 << 14) + 3, 1 << 17), 1 << 17)

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
            nb, nops = ntt_work(batch, lg, inverse, coset, sf)
            ntt_by.append({"shape": label, "B": batch, "n": n,
                           "inverse": inverse, "coset": coset,
                           "passes": len(pfft.pass_plan(lg)), **ck.measure(
                lambda pre=pre, x=x, inverse=inverse, shift=shift:
                    pfft.ntt(pre, x, inverse, shift),
                lambda pre=pre, x=x, inverse=inverse, shift=shift:
                    pfft.ntt_plain(pre, x, inverse, shift),
                nb, nops, reps=10, plain_reps=1)})
    check_twiddle_tables(torch, sf, 17, dev)
    # the headline numbers are at the wires' LDE, [9, 2^17] forward
    ck.record("ntt_pass", {"main": "2^14 wire_lde", "checked": [
        c[0] for c in ntt_cases()]}, by_shape=ntt_by,
        measured=next(b for b in ntt_by if b["shape"] == "2^14 wire_lde"))

    # ntt_twiddle_transpose (the four-step FFT's steps): tiles below one
    # (2^3 x 2^3), a batch of 3 at [2^5, 2^7], the square 2^11 x 2^11 of
    # 2^22, and the split 2^10 x 2^12 either way, with and without a table;
    # timed at 2^22 (the table of four_step_twiddles, as the probe runs it)
    fs = TWEEDLEDEE.base
    tt_by = []
    for batch, r, s_ in ((1, 8, 8), (3, 32, 128), (1, 2048, 2048),
                         (1, 1024, 4096), (1, 4096, 1024)):
        x = rand_field(np, torch, rng, (batch, r, s_), dev)
        if r * s_ == 1 << 22:
            tw = pfft.four_step_twiddles(fs, 1 << 22, (r - 1).bit_length(),
                                         device=dev)
        else:
            tw = pfft.Twiddles.of(fs, with_edges(
                fops, fs, rand_field(np, torch, rng, (r, s_), dev)))
        for table in (None, tw):
            ck.compare("ntt_twiddle_transpose", pfft.twiddle_transpose(fs, x, table),
                       pfft.twiddle_transpose_plain(fs, x, table))
            if r * s_ == 1 << 22:
                elems = batch * r * s_
                tt_by.append({"shape": [8, batch, r, s_], "twiddles": table is not None,
                              **ck.measure(
                    lambda x=x, table=table: pfft.twiddle_transpose(fs, x, table),
                    lambda x=x, table=table: pfft.twiddle_transpose_plain(fs, x, table),
                    (96 if table is not None else 64) * elems,
                    field_costs(fs)[1] * elems if table is not None else 0,
                    plain_reps=1),
                    # without twiddles the function is one PyTorch call
                    "library_ms": None if table is not None else ck.queued_ms(
                        lambda x=x: x.transpose(-1, -2).contiguous(), 20)})
    ck.record("ntt_twiddle_transpose", {
        "main": "[8, 1, 2^11, 2^11] with twiddles (2^22, lg n1 = 11)",
        "checked": ["[8, 1, 2^3, 2^3]", "[8, 3, 2^5, 2^7]", "[8, 1, 2^11, 2^11]",
                    "[8, 1, 2^10, 2^12]", "[8, 1, 2^12, 2^10]"]},
        by_shape=tt_by, measured=tt_by[1])

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
        acc_bytes, acc_ops, red_bytes, red_ops = k4_work(rows, starts, acc,
                                                         TWEEDLEDEE.base)
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

    # K4 at every window width from 2 to 12, signed and unsigned, on both
    # widths, each whole MSM held against the discrete-log oracle
    from plonky_tpu_torch.curves import BLS12_377
    sweep_rng = np.random.default_rng(4101)
    for curve in (TWEEDLEDEE, BLS12_377):
        t0 = time.perf_counter()
        a = int(sweep_rng.integers(2, 1 << 62))
        _chain, chain_dev = doubling_chain(curve, a, dev)
        nbs = k4_sweep(ck, torch, np, dev, curve, chain_dev, a, sweep_rng,
                       SWEEP_CASES)
        emit({"phase": f"k4_sweep_l{curve.base.limbs}", "N": SWEEP_N,
              "cases": [list(c) for c in SWEEP_CASES], "nb_checked": nbs,
              "seconds": time.perf_counter() - t0})

    # K2's curve_horner on the window sums of every K4 case, W = 1 and a
    # ragged K, timed at the main path's K = 9 (wires), 7 (t), 2 (the IPA
    # rounds) and 1 (z, pi, halo_g)
    horner_by = []
    cases = horner_cases(torch, window_sums)
    for label, ws in cases:
        ck.compare("curve_horner", cmsm.horner(TWEEDLEDEE, ws, c),
                   cmsm.horner_plain(TWEEDLEDEE, ws, c))
        if label in ("K=9", "K=7", "K=2 ipa", "K=1"):
            hb, hops = horner_work(ws, c, TWEEDLEDEE.base)
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
    add_ops, dbl_ops = point_costs(TWEEDLEDEE.base)
    for label in ("K=9", "K=7", "K=2 ipa", "K=1"):
        ws = window_sums[label]
        k = ws[0].shape[1]
        acc, win = check_horner(ck, cops, cmsm, TWEEDLEDEE, ws, c)
        timed[k] = (acc, win)
        add_by.append({"shape": [8, k], **ck.measure(
            lambda acc=acc, win=win: cops.add(TWEEDLEDEE, acc, win),
            lambda acc=acc, win=win: cops.add_plain(TWEEDLEDEE, acc, win),
            9 * 32 * k, add_ops * k)})
        dbl_by.append({"shape": [8, k], **ck.measure(
            lambda acc=acc: cops.double(TWEEDLEDEE, acc),
            lambda acc=acc: cops.double_plain(TWEEDLEDEE, acc),
            6 * 32 * k, dbl_ops * k)})
    add_by.append({"shape": [8, n2], **ck.measure(
        lambda: cops.add(TWEEDLEDEE, p1, p2),
        lambda: cops.add_plain(TWEEDLEDEE, p1, p2), 9 * 32 * n2,
        add_ops * n2)})
    dbl_by.append({"shape": [8, n2], **ck.measure(
        lambda: cops.double(TWEEDLEDEE, dbl_in),
        lambda: cops.double_plain(TWEEDLEDEE, dbl_in), 6 * 32 * n2,
        dbl_ops * n2)})
    # the headline numbers are at [8, 2], the shape of 14 of the 19 MSMs
    # of a steady prove (the IPA rounds)
    acc, win = timed[2]
    shapes = {"main": [8, 2], "horner_checked": [[8, k] for k in timed],
              "ragged_N": n2}
    ck.record("curve_add", shapes,
              lambda: cops.add(TWEEDLEDEE, acc, win),
              lambda: cops.add_plain(TWEEDLEDEE, acc, win), 9 * 32 * 2,
              add_ops * 2, by_shape=add_by)
    ck.record("curve_double", shapes,
              lambda: cops.double(TWEEDLEDEE, acc),
              lambda: cops.double_plain(TWEEDLEDEE, acc), 6 * 32 * 2,
              dbl_ops * 2, by_shape=dbl_by)

    # the same kernels on the Pallas/Vesta cycle's fields and curves
    t0 = time.perf_counter()
    pasta = pasta_kernel_checks(ck, torch, np, dev)
    emit({"phase": "kernels_pasta", "checked": pasta,
          "seconds": time.perf_counter() - t0})


def phase_rescue(ck: Checker, torch, np, dev, name_power: str) -> int:
    """K5 against its plain version on a ragged batch of 2^10 + 3 for both
    Tweedle base fields (its sparse instance) and BLS12-377's scalar field
    (alpha = 11, its dense one) at 128 and 64 security bits and both Pasta
    base fields (sparse) at 128; the batch entry point's path
    (rescue_permutation on 2^14 states, the JAX package's bench size)
    driven with the launch counts reset, which must show one K5
    launch and nothing else, and held against the host permutation at 8
    lanes (the states 0 and p - 1 among them); then timed at 2^14 and 2^16
    beside its bound, and each whole batch (the path's output at 2^14)
    held against the plain version's output from its timing.  Returns the
    path's K5 launches."""
    from plonky_tpu_torch import _cuda
    from plonky_tpu_torch.fields import (BLS12_377_SCALAR, PALLAS_BASE,
                                         TWEEDLEDEE_BASE, TWEEDLEDUM_BASE,
                                         VESTA_BASE)
    from plonky_tpu_torch.fields import ops as fops
    from plonky_tpu_torch.hashing import rescue as hr

    rng = np.random.default_rng(1337)

    def states(spec, n):
        return [with_edges(fops, spec, rand_field(np, torch, rng, (n,), dev,
                                                  spec))
                for _ in range(4)]

    for spec in (TWEEDLEDEE_BASE, TWEEDLEDUM_BASE, BLS12_377_SCALAR):
        for bits in (128, 64):
            state = states(spec, (1 << 10) + 3)
            ck.compare("rescue_permutation",
                       tuple(hr.rescue_permutation(spec, state, bits)),
                       tuple(hr.rescue_permutation_plain(spec, state, bits)))
    pasta_rng = np.random.default_rng(1338)
    for spec in (PALLAS_BASE, VESTA_BASE):
        state = [with_edges(fops, spec, rand_field(
            np, torch, pasta_rng, ((1 << 10) + 3,), dev, spec)) for _ in range(4)]
        ck.compare("rescue_permutation",
                   tuple(hr.rescue_permutation(spec, state, 128)),
                   tuple(hr.rescue_permutation_plain(spec, state, 128)))
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
        "checked": ["N = 2^10 + 3 x {TweedledeeBase, TweedledumBase, "
                    "Bls12377Scalar} x {128, 64} bits and {PallasBase, "
                    "VestaBase} x 128 bits",
                    "N = 2^14 and 2^16, "
                    "TweedledeeBase, 128 bits, every lane"]},
        by_shape=by_n, measured=by_n[0])
    return launches["rescue_permutation"]


# BLS12-377 G1 (phase_bls12_377): msm_chunked at 2^16 .. 2^22 points in
# slices of 2^16 (bench.py:phase_bls_msm's chunk_log and window), over a
# basis tiled from a host doubling chain of 2^12 points.
BLS_LADDER = (16, 18, 20, 22)
BLS_CHUNK_LOG = 16
BLS_WINDOW = 8
BLS_CHAIN = 1 << 12


def bls_scalars(np, torch, rng, spec, n, dev):
    """n canonical scalars of `spec` (8 limbs) as [8, n] on the card: random
    limbs with the top limb below p's (so every value is below p), then 0,
    1 and p - 1 first; and the same limbs as a numpy array."""
    limbs = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
    limbs[7] %= spec.p >> 224
    for i, v in enumerate((0, 1, spec.p - 1)):
        limbs[:, i] = [(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
    limbs = limbs.astype(np.uint32)
    return torch.from_numpy(limbs.view(np.int32)).to(dev), limbs


def chain_oracle(np, r, limbs, a: int) -> int:
    """e with sum_i s_i P_i = e G for P_i = 2^(i mod 2^12) (a G): e = a
    sum_i s_i 2^(i mod 2^12) mod r, from the scalars' limbs [8, n] (the
    residue classes summed in numpy, each below 2^42)."""
    limbs = np.pad(limbs, ((0, 0), (0, -limbs.shape[1] % BLS_CHAIN)))
    n = limbs.shape[1]
    sums = limbs.astype(np.uint64).reshape(8, n // BLS_CHAIN, BLS_CHAIN).sum(1)
    e = 0
    for j in range(BLS_CHAIN):
        e += sum(int(sums[k, j]) << (32 * k) for k in range(8)) << j
    return a * e % r


def kernel_device_ms(prof) -> tuple:
    """Device ms per kernel of KERNELS in a profiler trace (the longest
    matching symbol wins, so a pt_l12:: kernel is not read as its 8-limb
    twin), and the other device ms (torch's own kernels; those of its
    sorts also under "torch_sort" in the first dict)."""
    ours, other = {}, 0.0
    symbols = sorted(KERNELS.items(), key=lambda kv: -len(kv[1][2]))
    for evt in prof.key_averages():
        us = next((float(getattr(evt, a)) for a in
                   ("device_time_total", "cuda_time_total")
                   if getattr(evt, a, None)), 0.0)
        name = next((k for k, (_s, _r, sym) in symbols if sym in evt.key), None)
        if name is None:
            other += us / 1e3
            if "sort" in evt.key.lower():
                ours["torch_sort"] = ours.get("torch_sort", 0.0) + us / 1e3
        else:
            ours[name] = ours.get(name, 0.0) + us / 1e3
    return ours, other


def doubling_chain(curve, a: int, dev):
    """[2^i (a G), i < BLS_CHAIN] on the host and as device points
    ([L, 2^12], Z = 1)."""
    from plonky_tpu_torch.curves import host as chost
    from plonky_tpu_torch.protocol.circuit import points_to_device
    chain = [chost.mul(chost.generator(curve), a)]
    for _ in range(BLS_CHAIN - 1):
        chain.append(chost.add(chain[-1], chain[-1]))
    return chain, points_to_device(curve, chain, dev)


def median_s(torch, fn, reps: int = 3) -> tuple:
    """(median seconds, all seconds, the last call's result) of `reps`
    calls, each ended by every card's synchronize (host clock: what a
    caller waits); the caller makes the warm call, and checks its
    result."""
    import statistics
    times = []
    for _ in range(reps):
        sync_cards(torch)
        t0 = time.perf_counter()
        out = fn()
        sync_cards(torch)
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times, out


def sync_cards(torch) -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def profiled(torch, fn, tries: int = 3) -> tuple:
    """(device ms by kernel of KERNELS, the other device ms, launches) of
    one call of fn under torch.profiler, the launch counts reset first.
    A trace that lacks a kernel the call launched, or torch's own work, is
    taken again (the profiler on the H100 machine has dropped a short
    call's events), up to `tries` calls; the fullest trace is kept."""
    from torch.profiler import ProfilerActivity, profile

    from plonky_tpu_torch import _cuda
    best = None
    for _ in range(tries):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ours, other = kernel_device_ms(prof)
        launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        if best is None or sum(ours.values()) + other > sum(best[0].values()) + best[1]:
            best = (ours, other, launches)
        if other > 0 and all(k in ours for k in launches):
            break
    return best


# The K4 sweep (k4_sweep): every window width from 2 to 12, unsigned and
# signed, at a ragged N over two accumulate tiles (8 limbs) or more.
SWEEP_N = (1 << 12) + 5
# (K, c, signed): K = 1 at every window, unsigned and signed; K = 3
# signed at the windows the probe compares
SWEEP_CASES = (tuple((1, c, signed) for c in range(2, 13) for signed in (False, True))
               + tuple((3, c, True) for c in (5, 8, 9, 10, 12)))


def sweep_basis(torch, curve, chain_dev):
    """The chain's 2^12 points, then P_0 again, -P_0, the identity twice
    and P_1 again, and each one's discrete log over P_0 = a G."""
    from plonky_tpu_torch.curves import ops as cops
    p0 = tuple(t[:, :1] for t in chain_dev)
    p1 = tuple(t[:, 1:2] for t in chain_dev)
    ident = cops.identity(curve, (2,), chain_dev[0].device)
    pts = tuple(torch.cat(parts, 1).contiguous() for parts in
                zip(chain_dev, p0, cops.neg(curve, p0), ident, p1))
    r = curve.scalar.p
    logs = [pow(2, i, r) for i in range(BLS_CHAIN)] + [1, r - 1, 0, 0, 2]
    return pts, logs


def k4_sweep(ck: Checker, torch, np, dev, curve, chain_dev, a: int, rng,
             cases) -> dict:
    """For each (K, c, signed) of `cases`: K4's accumulate (signed or not)
    and reduce held against their plain versions, then the whole `msm` on
    the card held against the discrete-log oracle, over sweep_basis (so
    that buckets take P + P, P + (-P) and the identity: basis point 2^12
    and 2^12 + 1 take point 0's scalars, 2^12 + 4 point 1's) with random
    scalars whose first four are 0, 1, p - 1, p - 2.  Returns the bucket
    counts checked, by kernel."""
    from plonky_tpu_torch.curves import host as chost
    from plonky_tpu_torch.curves import msm as cmsm
    from plonky_tpu_torch.fields import ops as fops
    from plonky_tpu_torch.protocol.circuit import device_points_to_host

    sf = curve.scalar
    suffix = "" if curve.base.limbs == 8 else "_l12"
    pts, logs = sweep_basis(torch, curve, chain_dev)
    basis = cmsm.precompute_base(curve, pts)
    g = chost.generator(curve)
    nbs = collections.defaultdict(list)
    for k, c, signed in cases:
        scal = with_edges(fops, sf, rand_field(np, torch, rng, (k, SWEEP_N), dev, sf))
        for dst, src in ((BLS_CHAIN, 0), (BLS_CHAIN + 1, 0), (BLS_CHAIN + 4, 1)):
            scal[:, :, dst] = scal[:, :, src]
        digits, order, starts, signs, _w = cmsm.window_rows(curve, scal, c, signed)
        name = "msm_bucket_accumulate" + ("_signed" if signed else "") + suffix
        acc = cmsm.bucket_accumulate(curve, basis, digits, order, starts, signs)
        ck.compare(name, acc, cmsm.bucket_accumulate_plain(
            curve, basis, digits, order, starts, signs=signs))
        ws = cmsm.bucket_reduce(curve, *acc, starts)
        ck.compare("msm_bucket_reduce" + suffix, ws,
                   cmsm.bucket_reduce_plain(curve, *acc, starts))
        nb = starts.shape[1] - 1
        nbs[name].append(nb)
        nbs["msm_bucket_reduce" + suffix].append(nb)
        got = device_points_to_host(curve, cmsm.msm(curve, basis, scal, c,
                                                     signed=signed))
        vals = fops.to_ints(sf, scal)
        for j in range(k):
            e = a * sum(int(v) * w for v, w in zip(vals[j], logs)) % sf.p
            if got[j] != chost.mul(g, e):
                raise AssertionError(f"msm (K = {k}, c = {c}, signed = "
                                     f"{signed}) is not the oracle's point")
    return {key: sorted(set(v)) for key, v in nbs.items()}




# The four-step FFT probe (phase_probe): bin/tpu_probe_r5.py's comparison
# at 2^22 with lg n1 = 11 and one split with n1 != n2, and at 2^20; the
# flat oracle checked at 2^20, 2^21 and 2^22.
FFT_PROBE = {20: (10,), 21: (), 22: (11, 10)}
# The signed-window MSM probe: Tweedledee at 2^18 (bin/tpu_probe_r5.py's
# size), unsigned c = 8 against signed c = 8, 9, 10 and 12; unsigned
# c = 10 and 12 beside them (widths whose reduction the port refused
# before it took its segments from reduce_seg).
MSM_PROBE_LOG = 18
MSM_PROBE = ((8, False), (8, True), (9, True), (10, True), (12, True),
             (10, False), (12, False))
# Classes of the inputs summed for the cheap host evaluations: at g^k of
# order dividing 2^12 the transform is sum_r z^r (the inputs at i = r mod
# 2^12).
EVAL_CLASSES = 1 << 12


# Coefficients of ntt_host_check's Horner steps between two reductions mod p
# (a power of two, so it divides every n checked: 2^20 and up).
HORNER_STEP = 64


def ntt_host_check(np, torch, spec, pre, x, flat, rng) -> list:
    """flat = ntt(pre, x) at sampled points X[k] = sum_i x_i g^(i k), on the
    host: k = 0, n / 2, 3 n / 4 and a random odd multiple of n / 2^12 from
    the inputs' residue classes mod 2^12 (numpy sums of limbs, each below
    2^52), and one random k by Horner over every input.  Returns the k
    checked."""
    from plonky_tpu_torch.fields import ops as fops
    p, n, nl = spec.p, pre.n, spec.limbs
    limbs = x.reshape(nl, n).cpu().numpy().view(np.uint32)
    step = n // EVAL_CLASSES
    sums = limbs.astype(np.uint64).reshape(nl, step, EVAL_CLASSES).sum(1)
    classes = [sum(int(sums[l, r]) << (32 * l) for l in range(nl))
               for r in range(EVAL_CLASSES)]
    ks = [0, n // 2, 3 * n // 4, step * (2 * int(rng.integers(0, EVAL_CLASSES // 2)) + 1)]
    want = {}
    for k in ks:
        z = pow(pre.g, k, p)
        acc = 0
        for v in reversed(classes):
            acc = (acc * z + v) % p
        want[k] = acc
    k = int(rng.integers(1, n))
    z = pow(pre.g, k, p)
    # Horner from the top coefficient, HORNER_STEP coefficients a reduction;
    # each coefficient read as 4 nl big-endian bytes (int.from_bytes's
    # default order), so that map converts and multiplies without a Python
    # step an element
    assert n % HORNER_STEP == 0, n
    rows = np.ascontiguousarray(limbs[::-1, ::-1].T.astype(">u4"))
    coeffs = list(map(int.from_bytes, rows.view(np.dtype((np.void, 4 * nl))).ravel().tolist()))
    zs = [pow(z, j, p) for j in range(HORNER_STEP - 1, -1, -1)]
    z_step = pow(z, HORNER_STEP, p)
    acc = 0
    for i in range(0, n, HORNER_STEP):
        acc = (acc * z_step + sum(map(operator.mul, coeffs[i:i + HORNER_STEP], zs))) % p
    want[k] = acc
    got = fops.to_ints(spec, flat.reshape(nl, n)[:, list(want)])
    for (k, w), v in zip(want.items(), got):
        if int(v) != w:
            raise AssertionError(f"ntt at 2^{pre.lg_n}: X[{k}] is not the host's")
    return list(want)


def phase_probe(ck: Checker, torch, np, dev, name_power: str) -> dict:
    """The port's answer to bin/tpu_probe_r5.py, every result checked before
    its time is written.  FFT (TweedledeeBase): the flat ntt at 2^20, 2^21
    and 2^22 held against the host at sampled points (ntt_host_check) and
    its inverse returning the input; fft_four_step forward and inverse at
    2^22 (lg n1 = 11 and 10) and 2^20 (lg n1 = 10) held equal to the flat
    transform and to the input; ms and butterflies/s (n / 2 lg n a
    transform) of both forms, each the median of three warm calls ended
    by a synchronize; the device ms of each (CUDA events) and of the
    four-step's five steps alone.  The
    four-step path once with the launch counts reset: ntt_pass once a pass
    of the two sub-transforms, ntt_twiddle_transpose three times, nothing
    else.  MSM (Tweedledee, 2^18 points over a tiled doubling chain): each
    of MSM_PROBE warm, then three timed calls, each held against the
    discrete-log oracle, one profiled for its per-kernel device ms; the
    signed path once with the launch counts reset.  The signed accumulate
    and the reduce timed at each probe shape against their bounds.
    Returns the launches of the two paths' new kernels."""
    from plonky_tpu_torch import _cuda
    from plonky_tpu_torch.curves import TWEEDLEDEE as C
    from plonky_tpu_torch.curves import host as chost
    from plonky_tpu_torch.curves import msm as cmsm
    from plonky_tpu_torch.curves import ops as cops
    from plonky_tpu_torch.poly import fft as pfft
    from plonky_tpu_torch.protocol.circuit import device_points_to_host

    rng = np.random.default_rng(518)
    spec = C.base
    launches = {}
    for lg in sorted(FFT_PROBE):
        n = 1 << lg
        butterflies = n // 2 * lg
        x = rand_field(np, torch, rng, (n,), dev)
        t0 = time.perf_counter()
        pre = pfft.FftPrecomputation(spec, n)
        flat = pfft.ntt(pre, x)
        back = pfft.ntt(pre, flat, inverse=True)
        torch.cuda.synchronize()
        rec = {"phase": f"probe_fft_2e{lg}", "nvidia_smi": name_power,
               "log_n": lg, "tables_and_first_calls_s": time.perf_counter() - t0}
        if not torch.equal(back, x):
            raise AssertionError(f"the inverse ntt at 2^{lg} is not the input")
        t0 = time.perf_counter()
        rec["host_checked_k"] = ntt_host_check(np, torch, spec, pre, x, flat, rng)
        rec["host_check_s"] = time.perf_counter() - t0
        med, times, again = median_s(torch, lambda: pfft.ntt(pre, x))
        med_i, _t, back = median_s(torch, lambda: pfft.ntt(pre, flat, inverse=True))
        if not (torch.equal(again, flat) and torch.equal(back, x)):
            raise AssertionError(f"the timed ntt calls at 2^{lg} differ")
        rec["flat"] = {"ms": med * 1e3, "seconds": times, "inverse_ms": med_i * 1e3,
                       "butterflies_per_s": butterflies / med,
                       "passes": len(pfft.pass_plan(lg)),
                       "device_ms": ck.queued_ms(lambda: pfft.ntt(pre, x), 10)}
        rec["four_step"] = []
        for lg_n1 in FFT_PROBE[lg]:
            t0 = time.perf_counter()
            tw = pfft.four_step_twiddles(spec, n, lg_n1, device=dev)
            twi = pfft.four_step_twiddles(spec, n, lg_n1, True, dev)
            torch.cuda.synchronize()
            row = {"lg_n1": lg_n1, "twiddles_s": time.perf_counter() - t0}
            if not torch.equal(pfft.fft_four_step(spec, x, tw, lg_n1), flat):
                raise AssertionError(f"four-step 2^{lg}, lg n1 = {lg_n1}: not "
                                     "the flat transform")
            if not torch.equal(pfft.fft_four_step(spec, flat, twi, lg_n1,
                                                  inverse=True), x):
                raise AssertionError(f"inverse four-step 2^{lg}, lg n1 = "
                                     f"{lg_n1}: not the input")
            med, times, fwd = median_s(torch, lambda: pfft.fft_four_step(spec, x, tw, lg_n1))
            med_i, _t, inv = median_s(torch, lambda: pfft.fft_four_step(
                spec, flat, twi, lg_n1, inverse=True))
            if not (torch.equal(fwd, flat) and torch.equal(inv, x)):
                raise AssertionError(f"the timed four-step calls at 2^{lg} differ")
            row.update(ms=med * 1e3, seconds=times, inverse_ms=med_i * 1e3,
                       butterflies_per_s=butterflies / med)
            # its steps one by one (median ms of each, ended by a synchronize)
            n1, n2 = 1 << lg_n1, n >> lg_n1
            pre1, pre2 = pfft.FftPrecomputation(spec, n1), pfft.FftPrecomputation(spec, n2)
            cols = pfft.twiddle_transpose(spec, x.reshape(8, n2, n1))
            inner = pfft.ntt(pre2, cols)
            mid = pfft.twiddle_transpose(spec, inner, tw)
            outer = pfft.ntt(pre1, mid)
            row["steps_device_ms"] = {name: ck.queued_ms(fn, 10) for name, fn in (
                ("transpose_in", lambda: pfft.twiddle_transpose(
                    spec, x.reshape(8, n2, n1))),
                (f"ntt_n2: {n1} rows of {n2}", lambda: pfft.ntt(pre2, cols)),
                ("twiddle_transpose", lambda: pfft.twiddle_transpose(spec, inner, tw)),
                (f"ntt_n1: {n2} rows of {n1}", lambda: pfft.ntt(pre1, mid)),
                ("transpose_out", lambda: pfft.twiddle_transpose(spec, outer)))}
            row["device_ms"] = ck.queued_ms(
                lambda: pfft.fft_four_step(spec, x, tw, lg_n1), 10)
            del cols, inner, mid, outer
            torch.cuda.synchronize()
            _cuda.reset_launches()
            pfft.fft_four_step(spec, x, tw, lg_n1)
            torch.cuda.synchronize()
            path = {k: v for k, v in _cuda.LAUNCHES.items() if v}
            row["launches"] = path
            want = {"ntt_pass": len(pfft.pass_plan(lg - lg_n1))
                    + len(pfft.pass_plan(lg_n1)), "ntt_twiddle_transpose": 3}
            if path != want:
                raise AssertionError(f"the four-step path launched {path}, "
                                     f"not {want}")
            launches["ntt_twiddle_transpose"] = path["ntt_twiddle_transpose"]
            rec["four_step"].append(row)
        emit(rec)
        del x, flat, back

    # the signed-window MSM at 2^18
    n = 1 << MSM_PROBE_LOG
    a = int(rng.integers(2, 1 << 62))
    _chain, chain_dev = doubling_chain(C, a, dev)
    basis = cmsm.precompute_base(C, tuple(t.repeat(1, n // BLS_CHAIN)
                                          for t in chain_dev))
    scal, limbs = bls_scalars(np, torch, rng, C.scalar, n, dev)
    want = chost.mul(chost.generator(C), chain_oracle(np, C.scalar.p, limbs, a))
    rows = []
    for c, signed in MSM_PROBE:
        def call(c=c, signed=signed):
            return cmsm.msm(C, basis, scal, c, signed=signed)
        if device_points_to_host(C, call()) != [want]:
            raise AssertionError(f"msm at 2^{MSM_PROBE_LOG}, c = {c}, signed = "
                                 f"{signed}: not the oracle's point")
        med, times, res = median_s(torch, call)
        if device_points_to_host(C, res) != [want]:
            raise AssertionError(f"msm at 2^{MSM_PROBE_LOG}, c = {c}, signed = "
                                 f"{signed} (timed): not the oracle's point")
        ours, other, path = profiled(torch, call)
        rows.append({"c": c, "signed": signed, "ms": med * 1e3, "seconds": times,
                     "points_per_s": n / med, "kernel_device_ms": ours,
                     "other_device_ms": other, "launches": path})
    # the signed path once, with the counts reset
    _cuda.reset_launches()
    cops.to_affine(C, cmsm.msm(C, basis, scal, 8, signed=True))
    torch.cuda.synchronize()
    path = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    if (path.get("msm_bucket_accumulate_signed") != 1
            or path.get("msm_bucket_reduce") != 1 or path.get("curve_horner") != 1
            or path.get("msm_bucket_accumulate")):
        raise AssertionError(f"the signed MSM launched {path}")
    launches["msm_bucket_accumulate_signed"] = path["msm_bucket_accumulate_signed"]
    emit({"phase": f"probe_msm_2e{MSM_PROBE_LOG}", "nvidia_smi": name_power,
          "curve": C.name, "configs": rows, "path_launches": path})

    # the signed accumulate and the reduce at the probe's shapes
    acc_by, red_by = [], []
    for c, signed in MSM_PROBE:
        digits, order, starts, signs, _w = cmsm.window_rows(C, scal, c, signed)
        acc = cmsm.bucket_accumulate(C, basis, digits, order, starts, signs)
        shape = {"shape": f"2^{MSM_PROBE_LOG} c={c}" + (" signed" if signed else ""),
                 "N": n, "K": 1, "c": c, "signed": signed, "rows": digits.shape[0],
                 "nb": starts.shape[1] - 1,
                 "seg": cmsm.reduce_seg(starts.shape[1] - 1, digits.shape[0])}
        acc_b, acc_ops, red_b, red_ops = k4_work(digits, starts, acc, C.base)
        if signed:
            ck.compare("msm_bucket_accumulate_signed", acc,
                       cmsm.bucket_accumulate_plain(C, basis, digits, order, starts,
                                                    signs=signs))
            acc_by.append({**shape, **ck.measure(
                lambda: cmsm.bucket_accumulate(C, basis, digits, order, starts, signs),
                lambda: cmsm.bucket_accumulate_plain(C, basis, digits, order, starts,
                                                     signs=signs),
                acc_b, acc_ops, reps=10, plain_reps=1)})
        if (c, signed) == (8, False):
            continue              # the reduce at 256 buckets is the prove's
        ck.compare("msm_bucket_reduce", cmsm.bucket_reduce(C, *acc, starts),
                   cmsm.bucket_reduce_plain(C, *acc, starts))
        red_by.append({**shape, **ck.measure(
            lambda: cmsm.bucket_reduce(C, *acc, starts),
            lambda: cmsm.bucket_reduce_plain(C, *acc, starts),
            red_b, red_ops, reps=10, plain_reps=1)})
    ck.record("msm_bucket_accumulate_signed", {
        "main": acc_by[0]["shape"], "checked": "k4_sweep (8 limbs)",
        "timed": [b["shape"] for b in acc_by]}, by_shape=acc_by, measured=acc_by[0])
    ck.records["msm_bucket_reduce"]["by_shape"].extend(red_by)
    emit({"phase": "probe_msm_bucket_reduce", "by_shape": red_by})
    return launches


# The parallel phase (phase_parallel): plonky_tpu_torch/parallel's sharded
# FFTs and MSM on meshes of virtual shards of the first card and, with two
# cards or more, on meshes over the cards (default_mesh cycles them, a
# mesh of m entries using up to m cards); then the distributed step
# (dist_worker) in 2 processes under NCCL where there are two cards, else
# in 1.
PAR_DOMAIN_LG = 22          # fft_sharded_domain over PAR_DOMAIN_MESH shards
PAR_DOMAIN_MESH = 4
PAR_BATCH = (9, 17)         # fft_sharded_batch of [9, 2^17] (the wires' LDE)
PAR_BATCH_MESH = 3
PAR_MSM_LOG = 18            # msm_sharded at the probe's size and points
PAR_MSM_MESH = 4
PAR_RAGGED = (5, 256)       # N = 5 x 256 over a mesh of 5 (tests/test_parallel.py)
PAR_WINDOW = 8
DIST_MSM_LOG = 16           # the distributed step: 2 local shards a process,
DIST_FFT_LG = 20            # an MSM of 2^16 points and an FFT of 2^20


def ragged_scalars(np, torch, rng, spec, n, dev) -> tuple:
    """bls_scalars made identity-heavy as tests/test_parallel.py makes
    them: every fourth zero, the ones after them repeating others."""
    _s, limbs = bls_scalars(np, torch, rng, spec, n, dev)
    limbs[:, 0::4] = 0
    limbs[:, 1::4] = limbs[:, (np.arange(1, n, 4) + 4) % n]
    return torch.from_numpy(limbs.view(np.int32).copy()).to(dev), limbs


def phase_parallel(ck: Checker, torch, np, dev, name_power: str) -> dict:
    """plonky_tpu_torch/parallel on the card.  Prints the cards (count,
    names).  One-card references first: `fft` of one 2^22 domain and of
    [9, 2^17], `msm` at 2^18 Tweedledee points (the probe's chain and
    scalars, held against its discrete-log oracle) and at 5 x 256 with
    identity-heavy scalars (held against the chain's oracle); each timed
    (median of three calls, host clock to every card's synchronize).  Then
    for each mesh kind (4 virtual shards of the first card; with two cards
    or more also default_mesh over the cards): the counts reset, one
    counted run of fft_sharded_domain (4 shards), fft_sharded_batch (3),
    msm_sharded (4) and the ragged msm_sharded (5), each equal to its
    reference, with its seconds and memory by card (`first_call`), every
    card of the meshes launched on; then each timed.
    With two cards, a launch whose operands lie on two cards must raise.
    Every shape the phase gave a kernel is held against its plain version
    (PathRecorder).  Last the distributed step (dist_worker's processes,
    each exit code checked).  Returns the counted runs' curve_add
    launches (the MSM's tree)."""
    from plonky_tpu_torch import _cuda
    from plonky_tpu_torch.curves import TWEEDLEDEE as C
    from plonky_tpu_torch.curves import host as chost
    from plonky_tpu_torch.curves import msm as cmsm
    from plonky_tpu_torch.fields import ops as fops
    from plonky_tpu_torch.parallel import (default_mesh, fft_sharded_batch,
                                           fft_sharded_domain, msm_sharded,
                                           shard_basis)
    from plonky_tpu_torch.poly import fft as pfft
    from plonky_tpu_torch.protocol.circuit import device_points_to_host

    count = torch.cuda.device_count()
    cards = {"count": count,
             "names": [torch.cuda.get_device_name(i) for i in range(count)]}
    emit({"phase": "parallel_cards", "nvidia_smi": name_power, **cards})
    rng = np.random.default_rng(1212)
    spec = C.base
    x_dom = rand_field(np, torch, rng, (1 << PAR_DOMAIN_LG,), dev)
    k, lg = PAR_BATCH
    x_bat = rand_field(np, torch, rng, (k, 1 << lg), dev)
    pre_dom = pfft.FftPrecomputation(spec, 1 << PAR_DOMAIN_LG)
    pre_bat = pfft.FftPrecomputation(spec, 1 << lg)
    a = int(rng.integers(2, 1 << 62))
    _chain, chain_dev = doubling_chain(C, a, dev)
    n = 1 << PAR_MSM_LOG
    basis = cmsm.precompute_base(C, tuple(t.repeat(1, n // BLS_CHAIN)
                                          for t in chain_dev))
    scal, limbs = bls_scalars(np, torch, rng, C.scalar, n, dev)
    want_msm = chost.mul(chost.generator(C), chain_oracle(np, C.scalar.p, limbs, a))
    m_r, per = PAR_RAGGED
    rbasis = cmsm.precompute_base(C, tuple(t[:, :m_r * per].contiguous()
                                           for t in chain_dev))
    rscal, rlimbs = ragged_scalars(np, torch, rng, C.scalar, m_r * per, dev)
    want_ragged = chost.mul(chost.generator(C),
                            chain_oracle(np, C.scalar.p, rlimbs, a))

    sizes = {"fft_domain": PAR_DOMAIN_MESH, "fft_batch": PAR_BATCH_MESH,
             "msm": PAR_MSM_MESH, "msm_ragged": m_r}
    one_card = {"fft_domain": lambda: pfft.fft(pre_dom, x_dom),
                "fft_batch": lambda: pfft.fft(pre_bat, x_bat),
                "msm": lambda: cmsm.msm(C, basis, scal, PAR_WINDOW),
                "msm_ragged": lambda: cmsm.msm(C, rbasis, rscal, PAR_WINDOW)}

    def sharded(name, mesh):
        if name == "fft_domain":
            return lambda: fft_sharded_domain(mesh, spec, x_dom)
        if name == "fft_batch":
            return lambda: fft_sharded_batch(mesh, pre_bat, x_bat)
        b, s = (basis, scal) if name == "msm" else (rbasis, rscal)
        shards = shard_basis(mesh, b)
        return lambda: msm_sharded(mesh, C, shards, s, PAR_WINDOW)

    def check(name, got, want):
        if name.startswith("msm"):
            if device_points_to_host(C, got) != [want_msm if name == "msm"
                                                 else want_ragged]:
                raise AssertionError(f"{name}: not the oracle's point")
        elif not torch.equal(got, want):
            raise AssertionError(f"{name}: the sharded transform is not the "
                                 "one-card transform")

    rec = PathRecorder()
    out = {"phase": "parallel", "nvidia_smi": name_power, "cards": cards}
    kinds = [("virtual", lambda m: default_mesh(m, dev))]
    if count >= 2:
        kinds.append(("cards", default_mesh))
    levels = ["reference"]
    with rec:
        rec.level = "reference"
        refs = {name: fn() for name, fn in one_card.items()}
        for name, ref in refs.items():
            check(name, ref, ref)
        rec.level = "timing"
        one_card_s = {name: median_s(torch, fn)[0]
                      for name, fn in one_card.items()}
        for kind, mk in kinds:
            meshes = {name: mk(size) for name, size in sizes.items()}
            fns = {name: sharded(name, mesh) for name, mesh in meshes.items()}
            used = sorted({d.index for mesh in meshes.values()
                           for d in mesh.devices})
            sync_cards(torch)
            rec.level = kind
            levels.append(kind)
            _cuda.reset_launches()
            first = {}
            for name, fn in fns.items():
                first[name], got = first_call(torch, fn, used)
                check(name, got, refs[name])
            path = {k: v for k, v in _cuda.LAUNCHES.items() if v}
            by_card = dict(_cuda.DEVICE_LAUNCHES)
            if any(not by_card.get(i) for i in used):
                raise AssertionError(f"{kind}: cards {used} received launches "
                                     f"{by_card}")
            seen = collections.Counter()
            for kname, _shape, calls in rec.by_shape(kind):
                seen[kname] += calls
            if dict(seen) != path:
                raise AssertionError(f"{kind}: launches by shape {dict(seen)} "
                                     f"are not the run's {path}")
            rec.level = "timing"
            timed = {}
            for name, fn in fns.items():
                med, times, got = median_s(torch, fn)
                check(name, got, refs[name])
                timed[name] = {"shards": sizes[name], "s": med, "seconds": times,
                               "one_card_s": one_card_s[name]}
            out[kind] = {"cards": used, "launches": path,
                         "launches_by_card": by_card, "first_call": first,
                         "timed": timed}
    if count >= 2:
        a0 = x_bat[:, 0, :64].contiguous()
        try:
            fops.mul(spec, a0, a0.to("cuda:1"))
        except ValueError as err:
            out["two_card_launch_refused"] = str(err)
        else:
            raise AssertionError("a launch on two cards did not raise")
    emit(out)
    hold_path(ck, rec, "parallel", levels)
    emit(distributed_step(name_power, count))
    return {"curve_add": out["virtual"]["launches"]["curve_add"]}


def first_call(torch, fn, cards) -> tuple:
    """(record, result) of one call of fn, its first on its mesh: host
    seconds to every card's synchronize, and for each card of `cards` the
    MiB allocated above the call's start at its peak and after it (the
    tables it cached, and the result on the card that holds it)."""
    sync_cards(torch)
    start = {}
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
        start[i] = torch.cuda.memory_allocated(i)
    t0 = time.perf_counter()
    out = fn()
    sync_cards(torch)
    sec = time.perf_counter() - t0
    mib = float(1 << 20)
    return {"s": sec,
            "peak_mib": {i: (torch.cuda.max_memory_allocated(i) - start[i]) / mib
                         for i in cards},
            "kept_mib": {i: (torch.cuda.memory_allocated(i) - start[i]) / mib
                         for i in cards}}, out


def distributed_step(name_power: str, count: int) -> dict:
    """dist_worker in 2 processes under NCCL (ranks on cuda:0 and cuda:1)
    where there are two cards, else in 1; each must exit 0 and print its
    checks' line."""
    import socket
    world = 2 if count >= 2 else 1
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.dist_worker()"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    t0 = time.perf_counter()
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    rec = {"phase": "parallel_distributed", "nvidia_smi": name_power,
           "world": world, "seconds": time.perf_counter() - t0, "ranks": []}
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"distributed rank {rank} exited {p.returncode}:"
                                 f"\n{text[-4000:]}")
        rec["ranks"].append(json.loads(text.strip().splitlines()[-1]))
    if world == 1:
        rec["untested"] = ("one card: the distributed step ran at world size 1 "
                           "under NCCL; copies between cards and an exchange "
                           "between two processes went untested")
    return rec


def dist_worker(device=None) -> None:
    """One rank of the distributed step (run by distributed_step with
    torchrun's variables set): joins the NCCL group on cuda:LOCAL_RANK,
    runs 2 local shards of the card, and checks a sum over the whole mesh,
    the MSM of every process's share of 2^16 chain points (against the
    discrete-log oracle) and the domain-sharded FFT of 2^20 points across
    the processes (against the one-card `fft`); every shape the checked
    runs gave a kernel is held against its plain version (PathRecorder);
    prints one JSON line with the checks and their times."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from plonky_tpu_torch.curves import TWEEDLEDEE as C
    from plonky_tpu_torch.curves import host as chost
    from plonky_tpu_torch.curves import msm as cmsm
    from plonky_tpu_torch.parallel import distributed
    from plonky_tpu_torch.parallel import msm as pmsm
    from plonky_tpu_torch.poly import fft as pfft
    from plonky_tpu_torch.protocol.circuit import device_points_to_host

    dev = distributed.initialize(device)
    mesh = distributed.hybrid_mesh(2, device=dev)
    out = {"rank": mesh.rank, "world": mesh.processes, "device": str(dev),
           "backend": dist.get_backend(), "mesh": list(mesh.shape)}
    nloc = mesh.local.size
    rng = np.random.default_rng(1213)          # the same on every rank
    a = int(rng.integers(2, 1 << 62))
    _chain, chain_dev = doubling_chain(C, a, dev)
    n = 1 << DIST_MSM_LOG
    basis = cmsm.precompute_base(C, tuple(t.repeat(1, n // BLS_CHAIN)
                                          for t in chain_dev))
    scal, limbs = bls_scalars(np, torch, rng, C.scalar, n, dev)
    want = chost.mul(chost.generator(C), chain_oracle(np, C.scalar.p, limbs, a))
    lo, hi = distributed.process_local_slice(n)
    shards = pmsm.shard_basis(mesh.local, basis.slice(lo, hi))
    spec = C.base
    x = rand_field(np, torch, rng, (1 << DIST_FFT_LG,), dev)

    def msm():
        return distributed.msm_sharded(mesh, C, shards, scal[:, lo:hi], PAR_WINDOW)

    def fft():
        return distributed.fft_sharded_domain(mesh, spec, x)

    rec = PathRecorder()
    with rec:
        rec.level = "distributed"
        parts = [torch.full((1,), mesh.rank * nloc + l + 1, dtype=torch.int64,
                            device=d) for l, d in enumerate(mesh.local.devices)]
        out["psum"] = int(distributed.psum(mesh, parts).item())
        if out["psum"] != mesh.size * (mesh.size + 1) // 2:
            raise AssertionError(f"psum gave {out['psum']}")
        if device_points_to_host(C, msm()) != [want]:
            raise AssertionError("the distributed MSM is not the oracle's point")
        if not torch.equal(fft(), pfft.fft(pfft.FftPrecomputation(
                spec, 1 << DIST_FFT_LG), x)):
            raise AssertionError("the distributed FFT is not the one-card fft")
    out["msm_s"] = median_s(torch, msm)[0]
    out["fft_s"] = median_s(torch, fft)[0]
    dist.destroy_process_group()
    for key, (kernel_fn, plain_fn, _work, _device) in rec.calls.items():
        got, plain = kernel_fn(), plain_fn()
        got = got if isinstance(got, tuple) else (got,)
        plain = plain if isinstance(plain, tuple) else (plain,)
        if len(got) != len(plain) or not all(
                torch.equal(g, w) for g, w in zip(got, plain)):
            raise AssertionError(f"{key}: the kernel differs from its plain "
                                 "version")
    out["shapes_held"] = len(rec.calls)
    out["launches_by_shape"] = rec.by_shape("distributed")
    print(json.dumps(out), flush=True)


def phase_bls12_377(ck: Checker, torch, np, dev, name_power: str) -> dict:
    """BLS12-377 G1 on the 12-limb builds of K1, K2 and K4.  Each 12-limb
    kernel held against its plain version, exactly: K1 at N = 2^12 + 3 with
    the edge values, a broadcast operand either side and a square; K2's
    add and double at [12, 2^10 + 3] with the identity, P + P and
    P + (-P); K4 at N = 2^12 + 5, K = 1 and 3, c = 8 and 5 (51 windows,
    the last of 3 bits); curve_horner on those window sums (W = 32 and
    51); the 8-limb field_mul on the scalar field at N = 2^12 + 3; and the
    12-limb product sum, NTT and Rescue on K1's operands (their path is
    phase_bls12_377_poly's); field_exp at both widths (check_exp; the
    8-limb dense instance on the scalar field at N = 2^12 + 3).  Timed
    at the JAX package's microbench sizes (bin/microbench.py: field ops at
    2^16 on both fields, G1 add and double at 2^14, the 150-point
    summation; the multiply and field_exp_l12 also at N = 1) and K4 and
    the Horner at one slice of the ladder (N = 2^16, K = 1, c = 8).  Then
    the path once, with the launch counts reset (K1 at 2^16, K2 at 2^14,
    the summation, msm_chunked at 2^16 and its affine value): every
    kernel of BLS_PATH launched at 12 limbs, no other kernel, and exactly
    one field_exp_l12 and three field_mul_l12 launches.  Then the
    ladder: msm_chunked at 2^16 .. 2^22 points (slices of 2^16, c = 8), a
    warm call and three timed ones (median, ended by a synchronize), each
    result held against ((a sum_i s_i 2^(i mod 2^12)) mod r) G on the host
    for the basis P_i = 2^(i mod 2^12) (a G), and one call profiled for
    its per-kernel device ms and launches, which must be each slice's
    accumulate, ONE reduce, ONE Horner and a tree of ceil(log2 slices)
    curve_adds; at 2^22 the reduce over the call's 2,048 rows is held
    against its plain version and timed (the reduce's second shape).
    Returns the path's launches of the 12-limb kernels."""
    from plonky_tpu_torch import _cuda
    from plonky_tpu_torch.curves import BLS12_377 as C
    from plonky_tpu_torch.curves import host as chost
    from plonky_tpu_torch.curves import msm as cmsm
    from plonky_tpu_torch.curves import ops as cops
    from plonky_tpu_torch.fields import ops as fops

    bf, sf = C.base, C.scalar
    nl = bf.limbs
    rng = np.random.default_rng(377)
    out = {"phase": "bls12_377", "nvidia_smi": name_power, "limbs": nl}
    g = chost.generator(C)
    a = int(rng.integers(2, 1 << 62))
    chain, chain_dev = doubling_chain(C, a, dev)       # [12, 2^12], Z = 1

    def affine_is(res, want, what):
        x, y, zero = cops.to_affine(C, res)
        got = (bool(zero.reshape(-1)[0].item()),
               int(fops.to_ints(bf, x.reshape(nl, -1)[:, 0])),
               int(fops.to_ints(bf, y.reshape(nl, -1)[:, 0])))
        if got != (want.zero, want.x, want.y):
            raise AssertionError(f"{what}: the result is not the oracle's point")

    def field_pair(spec, n):
        return (with_edges(fops, spec, rand_field(np, torch, rng, (n,), dev, spec)),
                rand_field(np, torch, rng, (n,), dev, spec))

    ops = (("field_add", fops.add, fops.add_plain),
           ("field_sub", fops.sub, fops.sub_plain),
           ("field_mul", fops.mul, fops.mul_plain))
    # K1, both fields, against the plain versions at a ragged N
    n1 = (1 << 12) + 3
    x, y = field_pair(bf, n1)
    col = rand_field(np, torch, rng, (1,), dev, bf)
    for name, fn, plain in ops:
        for u, v in ((x, y), (col, y), (y, col), (y, y)):
            ck.compare(f"{name}_l12", fn(bf, u, v), plain(bf, u, v))
    xs, ys = field_pair(sf, n1)
    for u, v in ((xs, ys), (ys, ys)):
        ck.compare("field_mul", fops.mul(sf, u, v), fops.mul_plain(sf, u, v))
    # the 8-limb field_exp's dense instance on the scalar field
    for e in exp_cases(sf).values():
        ck.compare("field_exp", fops.exp_const(sf, xs, e), fops.exp_const_plain(sf, xs, e))

    # K2 at [12, 2^10 + 3]: chain points plus the identity, P + P, P + (-P)
    n2 = (1 << 10) + 3
    g0 = tuple(t[:, :1] for t in chain_dev)
    ident = cops.identity(C, (1,), dev)
    p1 = tuple(torch.cat([t[:, :n2 - 3], i, q, q], 1).contiguous()
               for t, i, q in zip(chain_dev, ident, g0))
    p2 = tuple(torch.cat([torch.roll(t[:, :n2 - 3], 1, 1), q, q, m], 1)
               .contiguous() for t, q, m in zip(chain_dev, g0, cops.neg(C, g0)))
    ck.compare("curve_add_l12", cops.add(C, p1, p2), cops.add_plain(C, p1, p2))
    s12 = cops.add(C, p1, p2)                          # Z != 1
    ck.compare("curve_double_l12", cops.double(C, s12), cops.double_plain(C, s12))

    # K4 at N = 2^12 + 5, then the Horner on its window sums
    n4 = (1 << 12) + 5
    sub = cmsm.precompute_base(C, tuple(torch.cat([t, t[:, :5]], 1)
                                        for t in chain_dev))
    window_sums = {}
    for k in (1, 3):
        scal = with_edges(fops, sf, rand_field(np, torch, rng, (k, n4), dev, sf))
        for c in (8, 5):
            digits, order, starts, _rows = k4_rows(torch, cmsm, sf, scal, c)
            acc = cmsm.bucket_accumulate(C, sub, digits, order, starts)
            ck.compare("msm_bucket_accumulate_l12", acc,
                       cmsm.bucket_accumulate_plain(C, sub, digits, order, starts))
            ws = cmsm.bucket_reduce(C, *acc, starts)
            ck.compare("msm_bucket_reduce_l12", ws,
                       cmsm.bucket_reduce_plain(C, *acc, starts))
            window_sums[(k, c)] = tuple(t.reshape(nl, k, -1) for t in ws)
    for (k, c), ws in window_sums.items():
        ck.compare("curve_horner_l12", cmsm.horner(C, ws, c),
                   cmsm.horner_plain(C, ws, c))
    # the 12-limb product sum, NTT and Rescue on the same operands (their
    # paths and timings are phase_bls12_377_poly's)
    from plonky_tpu_torch.hashing import rescue as hr
    from plonky_tpu_torch.poly import fft as pfft
    terms = [(x, y, 1), (col, y, -1), (x, None, -1)]
    ck.compare("field_product_sum_l12", fops.product_sum(bf, terms),
               fops.product_sum_plain(bf, terms))
    pre12 = pfft.FftPrecomputation(bf, 1 << 12)
    ck.compare("ntt_pass_l12", pfft.fft(pre12, x[:, :1 << 12]),
               pfft.ntt_plain(pre12, x[:, :1 << 12]))
    state = [t[:, :67] for t in (x, y, x.flip(1), y.flip(1))]
    ck.compare("rescue_permutation_l12", tuple(hr.rescue_permutation(bf, state, 64)),
               tuple(hr.rescue_permutation_plain(bf, state, 64)))
    checked = {"K1": "N = 2^12 + 3, edges, [12, 1] either side, squares",
               "K2": "[12, 2^10 + 3], identity, P + P, P + (-P)",
               "K4": "N = 2^12 + 5, K = 1, 3, c = 8, 5; the reduce also at "
                     "2,048 and 2,112 rows (2^22)",
               "curve_horner": "K = 1, 3, 64, W = 32, 33 (c = 8), 51 (c = 5)"}

    # timed at the microbench sizes: K1 at 2^16 on both fields, and the
    # multiply also at N = 1 (the shape of the Fermat inverse's products
    # before field_exp)
    nf = 1 << 16
    x, y = field_pair(bf, nf)
    x1, y1 = field_pair(bf, 1)
    for name, fn, plain in ops:
        ck.compare(f"{name}_l12", fn(bf, x, y), plain(bf, x, y))
        by = []
        for n, u, v in ((nf, x, y), (1, x1, y1))[:2 if name == "field_mul" else 1]:
            ck.compare(f"{name}_l12", fn(bf, u, v), plain(bf, u, v))
            by.append({"N": n, **ck.measure(
                lambda fn=fn, u=u, v=v: fn(bf, u, v),
                lambda plain=plain, u=u, v=v: plain(bf, u, v), 3 * 4 * nl * n,
                field_costs(bf)[1] * n if name == "field_mul" else 0)})
        ck.record(f"{name}_l12", {"main": "N = 2^16", "checked": checked["K1"]},
                  by_shape=by, measured=by[0])
    # field_exp_l12 at N = 1 (to_affine's inverse of one point), a ragged N
    # and the microbench's 2^16
    check_exp(ck, torch, np, rng, dev, bf, ((1 << 16) + 3, nf), nf)
    xs, ys = field_pair(sf, nf)
    out["scalar_field_2e16"] = {name: ck.measure(
        lambda fn=fn: fn(sf, xs, ys), lambda plain=plain: plain(sf, xs, ys),
        3 * 32 * nf, field_costs(sf)[1] * nf if name == "field_mul" else 0)
        for name, fn, plain in ops}
    # K2 at 2^14: chain points plus the chain rotated by one
    nc = 1 << 14
    pa = tuple(t.repeat(1, nc // BLS_CHAIN).contiguous() for t in chain_dev)
    pb = tuple(torch.roll(t, 1, 1).contiguous() for t in pa)
    ck.compare("curve_add_l12", cops.add(C, pa, pb), cops.add_plain(C, pa, pb))
    sc = cops.add(C, pa, pb)
    ck.compare("curve_double_l12", cops.double(C, sc), cops.double_plain(C, sc))
    ck.record("curve_add_l12", {"main": [nl, nc], "checked": checked["K2"]},
              lambda: cops.add(C, pa, pb), lambda: cops.add_plain(C, pa, pb),
              9 * 4 * nl * nc, point_costs(bf)[0] * nc)
    ck.record("curve_double_l12", {"main": [nl, nc], "checked": checked["K2"]},
              lambda: cops.double(C, sc), lambda: cops.double_plain(C, sc),
              6 * 4 * nl * nc, point_costs(bf)[1] * nc)
    # the 150-point summation (bin/microbench.py:134-171): 150 chain points
    # padded with the identity to 256, a halving tree of adds
    ps = tuple(torch.cat([t[:, :150], i.expand(nl, 106)], 1).contiguous()
               for t, i in zip(chain_dev, ident))

    def summation():
        p, m = ps, 256
        while m > 1:
            p = cops.add(C, tuple(t[:, :m // 2] for t in p),
                         tuple(t[:, m // 2:m] for t in p))
            m //= 2
        return p
    want150 = chost.mul(chain[0], (1 << 150) - 1)
    affine_is(summation(), want150, "the 150-point summation")
    out["summation_150_ms"] = ck.time_ms(summation, 20)

    # K4 and the Horner at one slice of the ladder: N = 2^16, K = 1, c = 8
    basis16 = cmsm.precompute_base(C, tuple(t.repeat(1, nf // BLS_CHAIN)
                                            for t in chain_dev))
    scal16, _limbs = bls_scalars(np, torch, rng, sf, nf, dev)
    scal16 = scal16[:, None, :]
    digits, order, starts, rows = k4_rows(torch, cmsm, sf, scal16, BLS_WINDOW)
    acc = cmsm.bucket_accumulate(C, basis16, digits, order, starts)
    ck.compare("msm_bucket_accumulate_l12", acc, cmsm.bucket_accumulate_plain(
        C, basis16, digits, order, starts))
    ws = cmsm.bucket_reduce(C, *acc, starts)
    ck.compare("msm_bucket_reduce_l12", ws,
               cmsm.bucket_reduce_plain(C, *acc, starts))
    ws = tuple(t.reshape(nl, 1, -1) for t in ws)
    acc_b, acc_ops, red_b, red_ops = k4_work(rows, starts, acc, bf)
    shape = {"main": f"N = 2^16, K = 1, c = {BLS_WINDOW}", "checked": checked["K4"]}
    slices22 = 1 << (BLS_LADDER[-1] - BLS_CHUNK_LOG)   # the top call's slices
    ck.record("msm_bucket_accumulate_l12", shape,
              lambda: cmsm.bucket_accumulate(C, basis16, digits, order, starts),
              lambda: cmsm.bucket_accumulate_plain(C, basis16, digits, order, starts),
              acc_b, acc_ops, reps=10, plain_reps=1)
    red32 = ck.measure(lambda: cmsm.bucket_reduce(C, *acc, starts),
                       lambda: cmsm.bucket_reduce_plain(C, *acc, starts),
                       red_b, red_ops, 10, 1)
    ck.record("msm_bucket_reduce_l12",
              {"main": f"{rows.shape[0]} rows (one slice: N = 2^16, K = 1, "
                       f"c = {BLS_WINDOW}); "
                       f"{rows.shape[0] * slices22} rows and "
                       f"{(rows.shape[0] + 1) * slices22} signed (msm_chunked at "
                       f"2^{BLS_LADDER[-1]}, by_shape)",
               "checked": checked["K4"]},
              by_shape=[{"rows": rows.shape[0], "seg": cmsm.reduce_seg(
                  starts.shape[1] - 1, rows.shape[0]), "signed": False, **red32,
                  "share": share(red32)}], measured=red32)
    # the signed accumulate at the same slice
    s_digits, s_order, s_starts, s_signs, _w = cmsm.window_rows(
        C, scal16, BLS_WINDOW, signed=True)
    s_acc = cmsm.bucket_accumulate(C, basis16, s_digits, s_order, s_starts, s_signs)
    ck.compare("msm_bucket_accumulate_signed_l12", s_acc,
               cmsm.bucket_accumulate_plain(C, basis16, s_digits, s_order, s_starts,
                                            signs=s_signs))
    ck.compare("msm_bucket_reduce_l12", cmsm.bucket_reduce(C, *s_acc, s_starts),
               cmsm.bucket_reduce_plain(C, *s_acc, s_starts))
    s_b, s_ops, _rb, _ro = k4_work(s_digits, s_starts, s_acc, bf)
    ck.record("msm_bucket_accumulate_signed_l12",
              {"main": f"N = 2^16, K = 1, c = {BLS_WINDOW} signed",
               "checked": "k4_sweep (12 limbs)"},
              lambda: cmsm.bucket_accumulate(C, basis16, s_digits, s_order, s_starts,
                                             s_signs),
              lambda: cmsm.bucket_accumulate_plain(C, basis16, s_digits, s_order,
                                                   s_starts, signs=s_signs),
              s_b, s_ops, reps=10, plain_reps=1)
    del s_acc
    ck.compare("curve_horner_l12", cmsm.horner(C, ws, BLS_WINDOW),
               cmsm.horner_plain(C, ws, BLS_WINDOW))
    hb, hops = horner_work(ws, BLS_WINDOW, bf)
    hor1 = ck.measure(lambda: cmsm.horner(C, ws, BLS_WINDOW),
                      lambda: cmsm.horner_plain(C, ws, BLS_WINDOW), hb, hops, 10, 1)
    ck.record("curve_horner_l12", {"main": f"K = 1, W = {ws[0].shape[2]}, "
                                   f"c = {BLS_WINDOW}; K = {slices22} (msm_chunked "
                                   f"at 2^{BLS_LADDER[-1]}, both signs, by_shape)",
                                   "checked": checked["curve_horner"]},
              by_shape=[{"K": 1, "W": ws[0].shape[2], "signed": False, **hor1,
                         "share": share(hor1)}], measured=hor1)

    # the path, once, with the launch counts reset
    def chunked(basis, scal, signed=False):
        return cmsm.msm_chunked(C, basis, scal, window_bits=BLS_WINDOW,
                                chunk_log=BLS_CHUNK_LOG, signed=signed)
    _cuda.reset_launches()
    for _name, fn, _plain in ops:
        fn(bf, x, y)
    cops.double(C, cops.add(C, pa, pb))
    summation()
    res = chunked(basis16, scal16[:, 0])
    x16, _y16, _z16 = cops.to_affine(C, res)
    torch.cuda.synchronize()
    path = dict(_cuda.LAUNCHES)
    missing = [f"{k}_l12" for k in BLS_PATH if not path[f"{k}_l12"]]
    off = {k: v for k, v in path.items()
           if v and (not k.endswith("_l12") or k.startswith("msm_bucket_accumulate_signed"))}
    # to_affine: one field_exp (the Fermat inverse) and two products; one
    # more product in the K1 loop
    exact = {"field_exp_l12": 1, "field_mul_l12": 3}
    if missing or off or any(path[k] != v for k, v in exact.items()):
        raise AssertionError(f"the BLS12-377 path launched {path}: none of "
                             f"{missing}, {off} off it, and not {exact}")
    want16 = chost.mul(g, chain_oracle(np, sf.p, _limbs, a))
    affine_is(res, want16, "msm_chunked at 2^16")
    out["path_launches"] = {k: v for k, v in path.items() if v}
    # the signed path, once, with the launch counts reset
    _cuda.reset_launches()
    res = chunked(basis16, scal16[:, 0], signed=True)
    cops.to_affine(C, res)
    torch.cuda.synchronize()
    signed_path = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    if (signed_path.get("msm_bucket_accumulate_signed_l12") != 1
            or signed_path.get("msm_bucket_reduce_l12") != 1
            or signed_path.get("curve_horner_l12") != 1
            or any(k.startswith("msm_bucket_accumulate") and "signed" not in k
                   for k in signed_path)):
        raise AssertionError(f"the signed BLS12-377 path launched {signed_path}")
    affine_is(res, want16, "msm_chunked(signed=True) at 2^16")
    out["signed_path_launches"] = signed_path
    path["msm_bucket_accumulate_signed_l12"] = signed_path[
        "msm_bucket_accumulate_signed_l12"]

    # the ladder
    del basis16, scal16, acc

    def chunked_launches(lg, signed, launches):
        """One msm_chunked call's launches: each slice's accumulate, ONE
        reduce and ONE Horner, a tree of ceil(log2 slices) curve_adds."""
        slices = 1 << max(0, lg - BLS_CHUNK_LOG)
        acc_name = ("msm_bucket_accumulate_signed_l12" if signed
                    else "msm_bucket_accumulate_l12")
        want = {acc_name: slices, "msm_bucket_reduce_l12": 1, "curve_horner_l12": 1}
        if slices > 1:
            want["curve_add_l12"] = (slices - 1).bit_length()
        if launches != want:
            raise AssertionError(f"msm_chunked(signed={signed}) at 2^{lg} launched "
                                 f"{launches}, not {want}")

    def spied(fn):
        """fn()'s result, the arguments of its bucket_reduce call and the
        window sums its horner call took."""
        seen = {}
        real_reduce, real_horner = cmsm.bucket_reduce, cmsm.horner

        def reduce_spy(curve, buckets, carries, starts):
            seen["reduce"] = (buckets, carries, starts)
            return real_reduce(curve, buckets, carries, starts)

        def horner_spy(curve, ws, c):
            seen["horner"] = ws
            return real_horner(curve, ws, c)
        cmsm.bucket_reduce, cmsm.horner = reduce_spy, horner_spy
        try:
            res = fn()
        finally:
            cmsm.bucket_reduce, cmsm.horner = real_reduce, real_horner
        return res, seen["reduce"], seen["horner"]

    def hold_call(lg, signed, fn, want):
        """The 2^lg call's reduce (over every slice's rows) and Horner (K =
        its slices), each held against its plain version on the inputs the
        call gave it and timed: one by_shape row each."""
        tag = "(signed=True)" if signed else ""
        res, (bk, cr, st), ws = spied(fn)
        affine_is(res, want, f"msm_chunked{tag} at 2^{lg} (its reduce and Horner held)")
        rb, rops = reduce_work(st, (bk, cr), bf)
        red = ck.hold("msm_bucket_reduce_l12", lambda: cmsm.bucket_reduce(C, bk, cr, st),
                      lambda: cmsm.bucket_reduce_plain(C, bk, cr, st), rb, rops)
        ck.records["msm_bucket_reduce_l12"]["by_shape"].append(
            {"rows": st.shape[0], "seg": cmsm.reduce_seg(st.shape[1] - 1, st.shape[0]),
             "signed": signed, **red})
        hb, hops = horner_work(ws, BLS_WINDOW, bf)
        hor = ck.hold("curve_horner_l12", lambda: cmsm.horner(C, ws, BLS_WINDOW),
                      lambda: cmsm.horner_plain(C, ws, BLS_WINDOW), hb, hops)
        ck.records["curve_horner_l12"]["by_shape"].append(
            {"K": ws[0].shape[1], "W": ws[0].shape[2], "signed": signed, **hor})
    ladder, signed_ladder = [], []
    for lg in BLS_LADDER:
        n = 1 << lg
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        basis = cmsm.precompute_base(C, tuple(t.repeat(1, n // BLS_CHAIN)
                                              for t in chain_dev))
        scal, limbs = bls_scalars(np, torch, rng, sf, n, dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        want = chost.mul(g, chain_oracle(np, sf.p, limbs, a))
        affine_is(chunked(basis, scal), want, f"msm_chunked at 2^{lg} (warm)")
        med, times, res = median_s(torch, lambda: chunked(basis, scal))
        affine_is(res, want, f"msm_chunked at 2^{lg}")
        kernel_ms, other_ms, path_lg = profiled(torch, lambda: chunked(basis, scal))
        chunked_launches(lg, False, path_lg)
        if lg == BLS_LADDER[-1]:
            hold_call(lg, False, lambda: chunked(basis, scal), want)
        ladder.append({"log_n": lg, "seconds": times, "median_s": med,
                       "points_per_s": n / med, "setup_s": setup_s,
                       "launches": path_lg, "kernel_device_ms": kernel_ms,
                       "other_device_ms": other_ms})
        emit({"phase": f"bls12_377_msm_2e{lg}", "nvidia_smi": name_power,
              **ladder[-1]})
        # beside it, the signed windows on the same points and scalars
        affine_is(chunked(basis, scal, signed=True), want,
                  f"msm_chunked(signed=True) at 2^{lg} (warm)")
        med, times, res = median_s(torch, lambda: chunked(basis, scal, signed=True))
        affine_is(res, want, f"msm_chunked(signed=True) at 2^{lg}")
        kernel_ms, other_ms, path_lg = profiled(
            torch, lambda: chunked(basis, scal, signed=True))
        chunked_launches(lg, True, path_lg)
        if lg == BLS_LADDER[-1]:
            hold_call(lg, True, lambda: chunked(basis, scal, signed=True), want)
        signed_ladder.append({"log_n": lg, "seconds": times, "median_s": med,
                              "points_per_s": n / med, "launches": path_lg,
                              "kernel_device_ms": kernel_ms,
                              "other_device_ms": other_ms})
        emit({"phase": f"bls12_377_msm_signed_2e{lg}", "nvidia_smi": name_power,
              **signed_ladder[-1]})
        del basis, scal, res
    out["ladder_points_per_s"] = {str(r["log_n"]): r["points_per_s"]
                                  for r in ladder}
    out["signed_ladder_points_per_s"] = {str(r["log_n"]): r["points_per_s"]
                                         for r in signed_ladder}
    emit(out)
    return {k: v for k, v in path.items() if k.endswith("_l12")}


# The polynomial path over BLS12-377's base field (phase_bls12_377_poly):
# the flat FFT at 2^22 and [9, 2^20] (the outer prover's transforms on the
# BW6-761 side of the two-chain), the coset pair and the polynomial ops at
# 2^20, the four-step FFT at 2^22 (lg n1 = 11), product sums at 2^20 and
# Rescue at 2^14 and 2^16 permutations.
POLY_LG = 22
POLY_BATCH = (9, 20)
POLY_COSET_LG = 20
POLY_FOUR_STEP_N1 = 11
POLY_PS_LG = 20
POLY_PS_TERMS = (2, 9, 30, 33)
POLY_RESCUE = (14, 16)
POLY_MESH = 4
# rows of the [9, 2^20] transforms a plain call holds (its digit columns
# take ~14 GB a call at 3 rows)
POLY_HOLD_ROWS = 3


def poly_product_sums() -> dict:
    """The product sums of phase_bls12_377_poly, one sum each, named as
    product_sum_shapes names its operands ("F" a full [12, N] column, "C"
    an [12, 1] one): terms from a pool of 34 full operands, signs
    alternating by three, one [12, 1] operand and one single each."""
    out = {}
    for t in POLY_PS_TERMS:
        terms = [("Cc" if i == 0 else f"F{i}", f"F{i + 1}",
                  -1 if i % 3 == 1 else 1) for i in range(t - 1)]
        out[f"{t} terms"] = [terms + [(f"F{t}", None, -1)]]
    return out


def ntt_l12_edges() -> list:
    """(B, lg n) of the 12-limb NTT's edge holds in phase_bls12_377_poly:
    every lg n from 1 to 13 at B = 3, B = 5 at 2^12, and B = 1 on both
    sides of each lg n where len(pass_plan(lg n, limbs=12)) grows, up to
    2^22, and at 2^21 and 2^22."""
    from plonky_tpu_torch.poly import fft as pfft
    cases = {(3, lg) for lg in range(1, 14)} | {(5, 12), (1, POLY_LG - 1), (1, POLY_LG)}
    for lg in range(14, POLY_LG + 1):     # below, B = 3 holds both sides
        if len(pfft.pass_plan(lg, limbs=12)) > len(pfft.pass_plan(lg - 1, limbs=12)):
            cases |= {(1, lg - 1), (1, lg)}
    return sorted(cases, key=lambda c: (c[1], c[0]))


def phase_bls12_377_poly(ck: Checker, torch, np, dev, name_power: str) -> dict:
    """The 12-limb NTT (ntt_pass_l12, ntt_twiddle_transpose_l12), product
    sum (field_product_sum_l12) and Rescue (rescue_permutation_l12) over
    BLS12-377's base field Fq.  First each held against its plain version
    at ragged shapes: the four transforms at [3, 2^11] and [5, 2^10] and
    at the 12-limb plan's edges (ntt_l12_edges; at 2^22 the coset pair
    here, fft and ifft on the path's outputs below), the transpose at
    [12, 3, 2^5, 2^7] and [12, 2, 33, 65] with and without a table, the
    product sums at N = 2^10 + 3 (2, 9, 30, 33 terms, splits 1, 2, 4
    forced); Rescue's ragged hold is phase_bls12_377's (67
    permutations at 64 bits).  Then the path once, with the launch counts
    reset, through the entry points: fft and ifft at [1, 2^22] and [9, 2^20], coset_fft and
    coset_ifft at [1, 2^20], fft_four_step at 2^22 (lg n1 = 11, its table
    built on the card), product_sums of 2, 9, 30 and 33 terms at [12,
    2^20], divide_by_z_h of a 2^20-coefficient multiple of Z_H (n = 2^19)
    and eval_at_dyn at 2^20, rescue_permutation at 2^14 and 2^16 (128
    bits), fft_sharded_domain at 2^22 over 4 virtual shards, and fft /
    ifft over the scalar field Fr (8 limbs) at [1, 2^22]: each of the
    four 12-limb kernels launched.  Every result checked: ifft(fft(x)) = x
    on every lane, the flat transforms against the host at sampled points
    (ntt_host_check), the four-step and the sharded FFT equal to the flat
    one, the product sums against their plain versions and against python
    ints at sampled lanes, the division by multiplying back, the
    evaluation against the host's Horner, Rescue against its plain
    version on every lane at 2^14 and on the last 2^10 + 3 lanes at 2^16
    (the plain version at 12 limbs took 27 s at 2^14 and 96 s at 2^16 on
    the H100), and against the host permutation at sampled lanes; the
    coset pair and the 2^22 transposes against their plain versions.  Then
    each kernel timed at the path's shapes beside its bound.  Returns the
    path's launches of the four kernels."""
    from plonky_tpu_torch import _cuda
    from plonky_tpu_torch.fields import BLS12_377_BASE as Fq
    from plonky_tpu_torch.fields import BLS12_377_SCALAR as Fr
    from plonky_tpu_torch.fields import ops as fops
    from plonky_tpu_torch.hashing import rescue as hr
    from plonky_tpu_torch.parallel import default_mesh, fft_sharded_domain
    from plonky_tpu_torch.poly import fft as pfft
    from plonky_tpu_torch.poly import polynomial as ppoly

    nl = Fq.limbs
    rng = np.random.default_rng(3770)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3770)
    out = {"phase": "bls12_377_poly", "nvidia_smi": name_power, "limbs": nl}
    seconds = {}

    def field(shape, spec=Fq):
        """Canonical random elements below 2^(bits - 1) as [L, *shape],
        made on the card from the seeded generator, the edge values
        first."""
        x = torch.randint(0, 1 << 32, (spec.limbs, *shape), generator=gen,
                          dtype=torch.int64, device=dev)
        x[-1] &= (1 << (spec.bits - 1 - 32 * (spec.limbs - 1))) - 1
        x = torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
        return with_edges(fops, spec, x)

    def ints(spec, x, lanes):
        return [int(v) for v in fops.to_ints(spec, x.reshape(spec.limbs, -1)[:, lanes])]

    # ragged shapes against the plain versions
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
    for batch, lg in ((3, 11), (5, 10)):
        pre = pfft.FftPrecomputation(Fq, 1 << lg)
        x = field((batch, 1 << lg))
        for inverse in (False, True):
            for shift in (None, Fq.generator):
                ck.compare("ntt_pass_l12", pfft.ntt(pre, x, inverse, shift),
                           pfft.ntt_plain(pre, x, inverse, shift))
    for batch, r, s_ in ((3, 32, 128), (2, 33, 65)):
        x = field((batch, r, s_))
        tw = pfft.Twiddles.of(Fq, field((r, s_)))
        for table in (None, tw):
            ck.compare("ntt_twiddle_transpose_l12", pfft.twiddle_transpose(Fq, x, table),
                       pfft.twiddle_transpose_plain(Fq, x, table))
    lap("ragged_ntt")
    # the 12-limb plan's edges (ntt_l12_edges): plans of one and more
    # passes, blocks of several groups, a batch that is not a power of two,
    # where the pass count changes, and the four transforms at each (at
    # 2^22 the path's own fft and ifft are held below); a row of p - 1
    # where the batch has two, the lazy butterflies' largest inputs
    for batch, lg in ntt_l12_edges():
        pre = pfft.FftPrecomputation(Fq, 1 << lg)
        x = field((batch, 1 << lg))
        if batch > 1:
            x[:, 1] = fops.column(Fq, Fq.p - 1, dev)
        for inverse in (False, True):
            for shift in (None, Fq.generator):
                if lg == POLY_LG and shift is None:
                    continue
                ck.compare("ntt_pass_l12", pfft.ntt(pre, x, inverse, shift),
                           pfft.ntt_plain(pre, x, inverse, shift))
        del x
    lap("edges_ntt")
    n_r = (1 << 10) + 3
    named_ps = poly_product_sums()

    def ps_inputs(n_elems):
        return {label: product_sum_inputs(
            named, lambda _name: field((n_elems,)),
            lambda _name: rand_field(np, torch, rng, (1,), dev, Fq))
            for label, named in named_ps.items()}
    for label, sums in ps_inputs(n_r).items():
        ck.compare("field_product_sum_l12", tuple(fops.product_sums(Fq, sums)),
                   tuple(fops.product_sums_plain(Fq, sums)))
        cut = [s[:32] for s in sums]
        for splits in (1, 2, 4):
            ck.compare("field_product_sum_l12",
                       tuple(fops._product_sums_launch(Fq, cut, (n_r,), splits=splits)),
                       tuple(fops.product_sums_plain(Fq, cut)))
    lap("ragged_product_sum")

    # inputs of the path (made on the card before the counts are reset)
    n22, n20 = 1 << POLY_LG, 1 << POLY_COSET_LG
    kb, lgb = POLY_BATCH
    x22, xb, x20 = field((1, n22)), field((kb, 1 << lgb)), field((1, n20))
    xr = field((1, n22), Fr)
    pre22, preb = pfft.FftPrecomputation(Fq, n22), pfft.FftPrecomputation(Fq, 1 << lgb)
    pre20, pre_r = pfft.FftPrecomputation(Fq, n20), pfft.FftPrecomputation(Fr, n22)
    n_ps = 1 << POLY_PS_LG
    ps = ps_inputs(n_ps)
    half = n20 // 2
    q = field((half,))
    f_zh = torch.cat([fops.neg(Fq, q), q], dim=1)          # q (X^half - 1)
    z = int(rng.integers(2, 1 << 62)) * 0x9E3779B97F4A7C15 % Fq.p
    z_col = fops.column(Fq, z, dev)
    states = {lg: [field((1 << lg,)) for _ in range(4)] for lg in POLY_RESCUE}
    mesh = default_mesh(POLY_MESH, device=dev)
    torch.cuda.synchronize()
    lap("inputs")

    # the path, once, with the launch counts reset
    _cuda.reset_launches()
    flat22 = pfft.fft(pre22, x22)
    back22 = pfft.ifft(pre22, flat22)
    flatb = pfft.fft(preb, xb)
    backb = pfft.ifft(preb, flatb)
    t1 = time.perf_counter()
    coset20 = pfft.coset_fft(pre20, x20, Fq.generator)
    torch.cuda.synchronize()
    seconds["coset_first_call"] = time.perf_counter() - t1   # its host table
    coset_back = pfft.coset_ifft(pre20, coset20, Fq.generator)
    t1 = time.perf_counter()
    tw22 = pfft.four_step_twiddles(Fq, n22, POLY_FOUR_STEP_N1, device=dev)
    torch.cuda.synchronize()
    seconds["four_step_table"] = time.perf_counter() - t1
    four22 = pfft.fft_four_step(Fq, x22, tw22, POLY_FOUR_STEP_N1)
    ps_out = {label: fops.product_sums(Fq, sums) for label, sums in ps.items()}
    quo = ppoly.divide_by_z_h(Fq, f_zh, half)
    ev_q = ppoly.eval_at_dyn(Fq, q, z_col)
    ev_f = ppoly.eval_at_dyn(Fq, f_zh, z_col)
    perms = {lg: hr.rescue_permutation(Fq, st, 128) for lg, st in states.items()}
    sharded = fft_sharded_domain(mesh, Fq, x22)
    flat_r = pfft.fft(pre_r, xr)
    back_r = pfft.ifft(pre_r, flat_r)
    torch.cuda.synchronize()
    lap("path")
    path = dict(_cuda.LAUNCHES)
    missing = [f"{k}_l12" for k in BLS_POLY_PATH if not path[f"{k}_l12"]]
    if missing:
        raise AssertionError(f"the BLS12-377 polynomial path launched {path}: "
                             f"none of {missing}")
    out["path_launches"] = {k: v for k, v in path.items() if v}

    # what came out
    checks = {}
    for name, x, back in (("[1, 2^22]", x22, back22),
                          (f"[{kb}, 2^{lgb}]", xb, backb),
                          ("coset [1, 2^20]", x20, coset_back),
                          ("Fr [1, 2^22]", xr, back_r)):
        if not torch.equal(back, x):
            raise AssertionError(f"ifft(fft(x)) != x at {name}")
    checks["round_trips"] = "every lane"
    checks["host_k"] = {
        "[1, 2^22]": ntt_host_check(np, torch, Fq, pre22, x22, flat22, rng),
        f"[{kb}, 2^{lgb}] rows 0, {kb - 1}": [
            ntt_host_check(np, torch, Fq, preb, xb[:, j].contiguous(),
                           flatb[:, j].contiguous(), rng) for j in (0, kb - 1)],
        "Fr [1, 2^22]": ntt_host_check(np, torch, Fr, pre_r, xr, flat_r, rng)}
    lap("checks_host")
    if not torch.equal(four22, flat22):
        raise AssertionError("fft_four_step at 2^22 differs from the flat fft")
    if not torch.equal(sharded, flat22):
        raise AssertionError("fft_sharded_domain at 2^22 differs from the flat fft")
    lanes = [0, 1, 2, 3, n_ps // 3, n_ps - 1]
    for label, sums in ps.items():
        ck.compare("field_product_sum_l12", tuple(ps_out[label]),
                   tuple(fops.product_sums_plain(Fq, sums)))
        terms = [(ints(Fq, a, [0] if a.shape[1] == 1 else lanes),
                  None if b is None else ints(Fq, b, lanes), sign)
                 for a, b, sign in sums[0]]
        want = [sum(sign * (a[0] if len(a) == 1 else a[j]) * (1 if b is None else b[j])
                    for a, b, sign in terms) % Fq.p for j in range(len(lanes))]
        if ints(Fq, ps_out[label][0], lanes) != want:
            raise AssertionError(f"product_sums ({label}) differ from python ints")
    lap("checks_ntt_product_sum")
    if not (torch.equal(quo[:, :half], q) and not quo[:, half:].any()):
        raise AssertionError("divide_by_z_h: the quotient times Z_H is not the input")
    q_host = [int(v) for v in fops.to_ints(Fq, q)]
    want_q = 0
    for c in reversed(q_host):
        want_q = (want_q * z + c) % Fq.p
    want_f = want_q * (pow(z, half, Fq.p) - 1) % Fq.p
    if (int(fops.to_ints(Fq, ev_q)), int(fops.to_ints(Fq, ev_f))) != (want_q, want_f):
        raise AssertionError("eval_at_dyn differs from the host's Horner")
    rescue_plain_s = {}
    for lg, st in states.items():
        # at 2^16 (the plain version takes ~100 s on the whole batch) one
        # lane in every 64, at a different place in each run of 64 so that
        # every block and every thread's place mod 64 is held, and the last 3
        n = 1 << lg
        lanes_held = (slice(None) if lg == POLY_RESCUE[0] else torch.tensor(
            [k * 64 + (7 * k) % 64 for k in range(n // 64)] + [n - 3, n - 2, n - 1],
            device=dev))
        t1 = time.perf_counter()
        plain = hr.rescue_permutation_plain(
            Fq, [t[:, lanes_held].contiguous() for t in st], 128)
        torch.cuda.synchronize()
        rescue_plain_s[lg] = time.perf_counter() - t1
        ck.compare("rescue_permutation_l12",
                   tuple(o[:, lanes_held] for o in perms[lg]), tuple(plain))
        del plain
        r_lanes = [0, 1, 2, (1 << lg) // 2, (1 << lg) - 1]
        ins = [ints(Fq, t, r_lanes) for t in st]
        got = [ints(Fq, o, r_lanes) for o in perms[lg]]
        for j, lane in enumerate(r_lanes):
            if [g[j] for g in got] != hr.rescue_permutation_host(
                    Fq, [i[j] for i in ins], 128):
                raise AssertionError(f"rescue_permutation at 2^{lg} differs from "
                                     f"the host permutation at lane {lane}")
    checks["rescue_vs_plain"] = ("every lane at 2^14; at 2^16 lane 64 k + 7 k mod 64 "
                                 "for every k, and the last 3")
    checks["rescue_lanes_vs_host"] = "0, 1, 2, N / 2, N - 1"
    lap("checks_rescue")

    # the 2^22 transposes against their plain versions, and timed
    r1 = 1 << POLY_FOUR_STEP_N1
    xt = field((1, r1, n22 // r1))
    tt_by = []
    for table in (None, tw22):
        ck.compare("ntt_twiddle_transpose_l12", pfft.twiddle_transpose(Fq, xt, table),
                   pfft.twiddle_transpose_plain(Fq, xt, table))
        tt_by.append({"shape": [nl, 1, r1, n22 // r1], "twiddles": table is not None,
                      **ck.measure(
            lambda table=table: pfft.twiddle_transpose(Fq, xt, table),
            lambda table=table: pfft.twiddle_transpose_plain(Fq, xt, table),
            (3 if table is not None else 2) * 4 * nl * n22,
            field_costs(Fq)[1] * n22 if table is not None else 0, reps=10,
            plain_reps=1),
            # without twiddles the function is one PyTorch call
            "library_ms": None if table is not None else ck.queued_ms(
                lambda: xt.transpose(-1, -2).contiguous(), 10)})
    ck.record("ntt_twiddle_transpose_l12", {
        "main": f"[12, 1, 2^{POLY_FOUR_STEP_N1}, 2^{POLY_LG - POLY_FOUR_STEP_N1}] "
                "with twiddles (fft_four_step at 2^22)",
        "checked": ["[12, 3, 2^5, 2^7]", "[12, 2, 33, 65]", "[12, 1, 2^11, 2^11]",
                    "fft_four_step at 2^22 = fft"]},
        by_shape=tt_by, measured=tt_by[1])
    lap("timing_transpose")

    # the NTT at the path's shapes, each output of the path held against
    # the plain version on the same input: the call that times it, or at
    # [9, 2^20] (43 GB of the plain version's digit columns at once) three
    # calls of POLY_HOLD_ROWS rows, their times summed
    ntt_by = []
    for label, pre, x, got, inverse, shift in (
            ("fft [1, 2^22]", pre22, x22, flat22, False, None),
            ("ifft [1, 2^22]", pre22, flat22, back22, True, None),
            (f"fft [{kb}, 2^{lgb}]", preb, xb, flatb, False, None),
            (f"ifft [{kb}, 2^{lgb}]", preb, flatb, backb, True, None),
            ("coset_fft [1, 2^20]", pre20, x20, coset20, False, Fq.generator),
            ("coset_ifft [1, 2^20]", pre20, coset20, coset_back, True,
             Fq.generator)):
        batch = x.reshape(nl, -1, pre.n).shape[1]
        nb, nops = ntt_work(batch, pre.lg_n, inverse, shift is not None, Fq)
        big = batch * pre.n > n22
        torch.cuda.empty_cache()
        want = {}

        def plain(pre=pre, x=x, inverse=inverse, shift=shift):
            want["out"] = pfft.ntt_plain(pre, x, inverse, shift)
        m = ck.measure(lambda pre=pre, x=x, inverse=inverse, shift=shift:
                       pfft.ntt(pre, x, inverse, shift),
                       (lambda: None) if big else plain,
                       nb, nops, reps=5, plain_reps=1)
        if big:
            plain_s = 0.0
            for j in range(0, batch, POLY_HOLD_ROWS):
                rows = slice(j, j + POLY_HOLD_ROWS)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                want_rows = pfft.ntt_plain(pre, x[:, rows].contiguous(), inverse,
                                           shift)
                torch.cuda.synchronize()
                plain_s += time.perf_counter() - t1
                ck.compare("ntt_pass_l12", got[:, rows], want_rows)
                del want_rows
                torch.cuda.empty_cache()
            m["plain_ms"] = plain_s * 1e3
        else:
            ck.compare("ntt_pass_l12", got, want.pop("out"))
        ntt_by.append({"shape": label, "B": batch, "n": pre.n,
                       "passes": len(pfft.pass_plan(pre.lg_n, limbs=nl)), **m,
                       "share": share(m)})
    ck.record("ntt_pass_l12", {
        "main": "fft [1, 2^22]", "checked": [
            "[3, 2^11], [5, 2^10] x fft, ifft, coset pair vs plain",
            "the 12-limb plan's edges x the four transforms vs plain, a row of "
            f"p - 1 where B > 1: {ntt_l12_edges()} (at 2^22 the coset pair; "
            "fft and ifft on the path's outputs)",
            "the path's fft, ifft at [1, 2^22] and [9, 2^20] (3 rows a call) "
            "and coset pair at [1, 2^20] vs plain",
            "round trips on every lane",
            "host points at 2^22, [9, 2^20], Fr 2^22"]},
        by_shape=ntt_by, measured=ntt_by[0])
    lap("timing_ntt")

    # the product sums at 2^20
    ps_by = []
    for label, sums in ps.items():
        nb, nops = product_sum_work(named_ps[label], n_ps, Fq)
        m = ck.measure(lambda sums=sums: fops.product_sums(Fq, sums),
                       lambda sums=sums: fops.product_sums_plain(Fq, sums),
                       nb, nops, reps=5, plain_reps=1)
        ps_by.append({"shape": label, "N": n_ps,
                      **product_sum_counts(named_ps[label]), **m, "share": share(m)})
    ck.record("field_product_sum_l12", {
        "main": "9 terms, N = 2^20", "checked": [
            f"N = 2^10 + 3 and 2^20 x {list(POLY_PS_TERMS)} terms, signed, "
            "an [12, 1] operand", "splits 1, 2, 4", "python ints at 6 lanes"]},
        by_shape=ps_by, measured=ps_by[1])
    lap("timing_product_sum")

    # Rescue at 2^14 and 2^16
    r_by = []
    for lg, st in states.items():
        nb, nops = rescue_work(Fq, 128, 1 << lg)
        m = ck.measure(lambda st=st: hr.rescue_permutation(Fq, st, 128),
                       lambda: None, nb, nops, reps=5, plain_reps=1)
        # the plain call held above (at 2^16 on 2^10 + 3 lanes only)
        m["plain_ms"] = rescue_plain_s[lg] * 1e3 if lg == POLY_RESCUE[0] else None
        r_by.append({"N": 1 << lg, "security_bits": 128,
                     "plain_held_ms": rescue_plain_s[lg] * 1e3,
                     "perms_per_s": (1 << lg) / (m["ms"] * 1e-3), **m,
                     "share": share(m)})
    ck.record("rescue_permutation_l12", {
        "main": "2^14, Bls12377Base, 128 bits", "checked": [
            "N = 67 at 64 bits (phase_bls12_377)",
            "N = 2^14 at 128 bits, every lane vs plain",
            "N = 2^16 at 128 bits, 2^10 + 3 lanes (one in every 64, and the "
            "last 3) vs plain",
            "5 lanes a size vs host"]},
        by_shape=r_by, measured=r_by[0])
    lap("timing_rescue")
    out.update({"checks": checks, "seconds": seconds,
                "rescue_perms_per_s": {str(r["N"]): r["perms_per_s"] for r in r_by}})
    emit(out)
    return {f"{k}_l12": path[f"{k}_l12"] for k in BLS_POLY_PATH}


def pinned_random():
    import numpy as np
    rng = np.random.default_rng(1337)
    return lambda p: int.from_bytes(rng.bytes(40), "little") % p


def pinned_proof(build, source, device=None, curve=None) -> dict:
    """With RANDOM_SOURCE (builder and halo) set to `source` throughout:
    build() -> (circuit, witness inputs), the witness and one prove; the
    proof verified with the G check on `device` (the card by default).
    `curve` is the circuit's (Tweedledee by default).  Returns the circuit,
    public inputs, proof, its bytes and sha256, and the seconds taken."""
    import hashlib

    import plonky_tpu_torch.circuit.builder as builder_mod
    import plonky_tpu_torch.protocol.halo as halo_mod
    from plonky_tpu_torch.curves import TWEEDLEDEE
    from plonky_tpu_torch.protocol import generate_proof, verify_proof
    from plonky_tpu_torch.protocol.circuit import cycle_partner
    from plonky_tpu_torch.protocol.serialization import proof_to_bytes

    curve = curve or TWEEDLEDEE

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
    verify_proof(pis, proof, [], circuit.to_vk(), cycle_partner(curve),
                 verify_g=True, device=device)
    data = proof_to_bytes(curve, proof)
    return {"circuit": circuit, "pis": pis, "proof": proof, "bytes": data,
            "sha256": hashlib.sha256(data).hexdigest(), "build_prove_s": prove_s,
            "verify_s": time.perf_counter() - t0}


def small_circuits(curve) -> dict:
    """name -> make() -> (builder, witness inputs) of the fixtures' two
    small circuits (tests/test_proof_fixture.py) over `curve`: `trivial`
    (42 - 42 = 0) and `sum_pi` (3 + 39 = 42, three public inputs)."""
    from plonky_tpu_torch.circuit import CircuitBuilder, PartialWitness

    def trivial():
        b = CircuitBuilder(curve, security_bits=128)
        t = b.constant_wire(42)
        b.assert_zero(b.sub(t, b.constant_wire(42)))
        return b, PartialWitness()

    def sum_pi():
        b = CircuitBuilder(curve, security_bits=128)
        x, y = b.add_public_input(), b.add_public_input()
        z = b.add(x, y)
        out = b.add_public_input()
        b.copy(z, out)
        w = PartialWitness()
        w.set_target(x, 3)
        w.set_target(y, 39)
        w.set_target(out, 42)
        return b, w
    return {"trivial": trivial, "sum_pi": sum_pi}


def fixture_proofs(curve, makes, suffix: str = "") -> dict:
    """Each circuit of `makes` (name -> make()) proved on the card under a
    fresh pinned_random() and verified with the G check; its proof and vk
    must equal tests/fixtures/{proof,vk}_<name><suffix>.hex byte for byte.
    Returns each one's seconds."""
    from plonky_tpu_torch.protocol.serialization import vk_to_bytes

    result = {}
    for name, make in makes.items():
        def build(make=make):
            builder, inputs = make()
            return builder.build(), inputs
        got = pinned_proof(build, pinned_random(), curve=curve)
        with open(os.path.join(FIXTURES, f"proof_{name}{suffix}.hex")) as f:
            want_proof = f.read().strip()
        with open(os.path.join(FIXTURES, f"vk_{name}{suffix}.hex")) as f:
            want_vk = f.read().strip()
        if got["bytes"].hex() != want_proof:
            raise AssertionError(f"{name}{suffix}: proof bytes differ from "
                                 "the fixture")
        if vk_to_bytes(got["circuit"].to_vk()).hex() != want_vk:
            raise AssertionError(f"{name}{suffix}: vk bytes differ from the "
                                 "fixture")
        result[name + suffix] = {"bytes_equal": True, "verified": True,
                                 "build_prove_s": got["build_prove_s"],
                                 "verify_s": got["verify_s"]}
    return result


def phase_fixtures() -> None:
    """The three committed fixtures (tests/test_proof_fixture.py) proved on
    the card under a fresh pinned_random(): proof and vk byte-equal to the
    files, and verified with the G check."""
    from plonky_tpu_torch.curves import TWEEDLEDEE

    makes = small_circuits(TWEEDLEDEE)
    makes["curve_add"] = lambda: gadget_circuits(port_modules())["curve_add"]()[:2]
    emit({"phase": "fixtures", **fixture_proofs(TWEEDLEDEE, makes)})


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


def buffer_circuit(lg: int, device=None, curve=None):
    """The reference workload: a 2^lg-gate BufferGate circuit on `curve`
    (Tweedledee by default; as bench.py builds it), built on `device` (the
    card by default), and its witness's inputs."""
    from plonky_tpu_torch.circuit import CircuitBuilder, PartialWitness
    from plonky_tpu_torch.circuit.gates import BufferGate
    from plonky_tpu_torch.curves import TWEEDLEDEE
    builder = CircuitBuilder(curve or TWEEDLEDEE, security_bits=128)
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
    says, counted by shape (counting_product_sums), and field_exp once per
    exp_const call (counting_exps).  Returns the steady prove's launches by
    kernel and, with `check_launches`, its product-sum launches by label of
    product_sum_shapes."""
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
            with record_phases() as phases, counting as ps_counts, \
                    counting_exps(fops) as exp_counts:
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
    out["exp_const_calls"] = [[*k, v] for k, v in sorted(exp_counts.items())]
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
        if launches["field_exp"] != sum(exp_counts.values()):
            raise AssertionError(f"{launches['field_exp']} field_exp launches for "
                                 f"{sum(exp_counts.values())} exp_const calls")
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


class PathRecorder:
    """While open, wraps the kernel wrappers a prove runs (K1's elementwise
    launch, its product sums and field_exp, a whole NTT, K4's two stages
    and the Horner) and counts their calls by shape under `level`; the first call
    of each shape keeps its arguments, so that `hold` can run it again
    beside its plain version.  A shape is the kernel, the field or curve and
    every size the launch takes."""

    def __init__(self):
        self.level = None
        self.counts = collections.Counter()      # (level, key) -> calls
        self.calls = {}                          # key -> (kernel, plain, work)

    def _note(self, key, launches, kernel_fn, plain_fn, work, device):
        self.counts[(self.level, key)] += launches
        if key not in self.calls:
            self.calls[key] = (kernel_fn, plain_fn, work, device)

    def __enter__(self):
        from plonky_tpu_torch.curves import msm as cmsm
        from plonky_tpu_torch.curves import ops as cops
        from plonky_tpu_torch.fields import ops as fops
        from plonky_tpu_torch.poly import fft as pfft
        wrapped = ((fops, "_launch_binary"), (fops, "_product_sums_launch"),
                   (fops, "_launch_exp"), (pfft, "ntt"), (cmsm, "bucket_accumulate"),
                   (cmsm, "bucket_reduce"), (cmsm, "horner"),
                   (cops, "_launch_point"))
        self.saved = [(m, name, getattr(m, name)) for m, name in wrapped]
        orig = {name: fn for _m, name, fn in self.saved}
        plain_binary = {"field_add": fops.add_plain, "field_sub": fops.sub_plain,
                        "field_mul": fops.mul_plain}

        def binary(kernel, spec, a, b):
            out = orig["_launch_binary"](kernel, spec, a, b)
            n = out[0].numel()
            full = [x[0].numel() > 1 for x in (a, b)]
            self._note((kernel, spec.name, *("full" if f else "col" for f in full), n), 1,
                       lambda: orig["_launch_binary"](kernel, spec, a, b),
                       lambda: plain_binary[kernel](spec, a, b),
                       lambda: (4 * spec.limbs * (n * (1 + sum(full)) + 2 - sum(full)),
                                field_costs(spec)[1] * n if kernel == "field_mul"
                                else 0),
                       out.device)
            return out

        def product_sums(spec, sums, batch, splits=None):
            out = orig["_product_sums_launch"](spec, sums, batch, splits)
            n = out[0][0].numel()
            terms = [t for sum_ in sums for t in sum_]
            operands = {id(x): x for a, b, _s in terms for x in (a, b) if x is not None}
            full = sum(x[0].numel() > 1 for x in operands.values())
            products = sum(b is not None for _a, b, _s in terms)
            key = ("field_product_sum", spec.name, n, len(sums), products,
                   len(terms) - products, full, sum(s < 0 for _a, _b, s in terms))
            self._note(key, 1,
                       lambda: tuple(orig["_product_sums_launch"](spec, sums, batch, splits)),
                       lambda: tuple(fops.product_sums_plain(spec, sums)),
                       lambda: (4 * spec.limbs * (n * (full + len(sums))
                                                  + len(operands) - full),
                                n * (products * product_ops(spec.limbs)
                                     + len(sums) * field_costs(spec)[2])),
                       out[0].device)
            return out

        def exp(spec, x, e):
            out = orig["_launch_exp"](spec, x, e)
            n = out[0].numel()
            self._note(("field_exp", spec.name, n, "p-2" if e == spec.p - 2 else hex(e)),
                       1, lambda: orig["_launch_exp"](spec, x, e),
                       lambda: fops.exp_const_plain(spec, x, e),
                       lambda: exp_work(spec, e, n), out.device)
            return out

        def ntt(pre, x, inverse=False, shift=None):
            out = orig["ntt"](pre, x, inverse, shift)
            batch = x[0].numel() // pre.n
            coset = shift is not None
            self._note(("ntt_pass", pre.spec.name, batch, pre.lg_n, inverse, coset),
                       len(pfft.pass_plan(pre.lg_n, limbs=pre.spec.limbs)),
                       lambda: orig["ntt"](pre, x, inverse, shift),
                       lambda: pfft.ntt_plain(pre, x, inverse, shift),
                       lambda: ntt_work(batch, pre.lg_n, inverse, coset, pre.spec),
                       out.device)
            return out

        def accumulate(curve, basis, digits, order, starts, signs=None):
            out = orig["bucket_accumulate"](curve, basis, digits, order, starts, signs)
            name = "msm_bucket_accumulate" + ("" if signs is None else "_signed")
            self._note((name, curve.name, basis.n, *starts.shape), 1,
                       lambda: orig["bucket_accumulate"](curve, basis, digits, order,
                                                         starts, signs),
                       lambda: cmsm.bucket_accumulate_plain(curve, basis, digits, order,
                                                            starts, signs=signs),
                       lambda: k4_work(digits, starts, out, curve.base)[:2],
                       out[0].device)
            return out

        def reduce(curve, buckets, carries, starts):
            out = orig["bucket_reduce"](curve, buckets, carries, starts)
            self._note(("msm_bucket_reduce", curve.name, *starts.shape), 1,
                       lambda: orig["bucket_reduce"](curve, buckets, carries, starts),
                       lambda: cmsm.bucket_reduce_plain(curve, buckets, carries, starts),
                       lambda: reduce_work(starts, (buckets, carries), curve.base),
                       out[0].device)
            return out

        def horner(curve, ws, c):
            out = orig["horner"](curve, ws, c)
            self._note(("curve_horner", curve.name, *ws[0].shape[1:], c), 1,
                       lambda: orig["horner"](curve, ws, c),
                       lambda: cmsm.horner_plain(curve, ws, c),
                       lambda: horner_work(ws, c, curve.base), out[0].device)
            return out

        def point(kernel, curve, coords):
            out = orig["_launch_point"](kernel, curve, coords)
            n, nl = out[0][0].numel(), curve.base.limbs
            add = kernel == "curve_add"
            self._note((kernel, curve.name, n), 1,
                       lambda: orig["_launch_point"](kernel, curve, coords),
                       lambda: (cops.add_plain(curve, coords[:3], coords[3:]) if add
                                else cops.double_plain(curve, coords)),
                       lambda: (4 * nl * n * (len(coords) + 3),
                                n * point_costs(curve.base)[0 if add else 1]),
                       out[0].device)
            return out

        for (m, name), fn in zip(wrapped, (binary, product_sums, exp, ntt,
                                           accumulate, reduce, horner, point)):
            setattr(m, name, fn)
        return self

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)

    def by_shape(self, level) -> list:
        """[kernel, shape, calls, launches] of one level's prove, launches
        counting an NTT's passes."""
        return [[key[0], list(key[1:]), n] for (lv, key), n in
                sorted(self.counts.items(), key=str) if lv == level]

    def hold(self, ck: Checker, levels) -> dict:
        """Every recorded shape's first call run again, held against its
        plain version (the plain call timed once) and timed: kernel ->
        [record]; each record carries the launches of each level's
        prove."""
        out = {}
        for key, (kernel_fn, plain_fn, work, device) in self.calls.items():
            nbytes, nops = work()
            with ck.torch.cuda.device(device):
                held = ck.hold(key[0], kernel_fn, plain_fn, nbytes, nops)
            rec = {"shape": list(key[1:]),
                   **{f"launches_{lv}": self.counts[(lv, key)] for lv in levels},
                   **held}
            out.setdefault(key[0], []).append(rec)
        self.calls.clear()
        return out


def reduce_work(starts, acc, f):
    """Bytes and IMAD slots of msm_bucket_reduce's bounds (k4_work's
    reduction) over base field f from the run starts and the
    accumulation's output."""
    nonempty = int(((starts[:, 2:] - starts[:, 1:-1]) > 0).sum().item())
    out_bytes = 4 * sum(t.numel() for t in acc)
    return (out_bytes + 4 * starts.numel() + 12 * f.limbs * starts.shape[0],
            point_costs(f)[0] * 2 * nonempty)


def hold_path(ck: Checker, rec: PathRecorder, path: str, levels) -> None:
    """Every shape `rec` recorded held against its plain version and timed
    (PathRecorder.hold): one `<path>_shapes` line of them all, keyed as
    RECURSION_SHAPE_KEYS with one launches column a level, and in each
    kernel's record under `path` its shape count, launches by level and
    costliest shape."""
    keys = ("shape", *(f"launches_{lv}" for lv in levels),
            *RECURSION_SHAPE_KEYS[3:])
    held = rec.hold(ck, levels)
    emit({"phase": f"{path}_shapes", "keys": keys,
          "by_kernel": {name: [[r[k] for k in keys] for r in rows]
                        for name, rows in held.items()}})
    for name, rows in held.items():
        top = max(rows, key=lambda r: r["bound_ms"])
        ck.records[name][path] = {
            "shapes": len(rows),
            **{f"launches_{lv}": sum(r[f"launches_{lv}"] for r in rows)
               for lv in levels},
            "largest": {k: top[k] for k in keys}}


def shapes_add_up(rec: PathRecorder, level: str, launches: dict) -> list:
    """rec's launches by shape at `level`, which must add up to the
    launch counts of that run for every kernel of the main path."""
    by_shape = rec.by_shape(level)
    seen = collections.Counter()
    for name, _shape, n in by_shape:
        seen[name] += n
    if any(seen[k] != launches[k] for k in recursion_path_kernels()):
        raise AssertionError(f"{level}: launches by shape {dict(seen)} do "
                             f"not add up to {launches}")
    return by_shape


def recursion_path_kernels() -> set:
    """The kernels a prove must launch: every kernel of KERNELS but
    OFF_PATH."""
    return {k for k in KERNELS if k not in OFF_PATH}


def check_path_launches(launches: dict, what: str, unused=()) -> None:
    """Every kernel of the main path launched, none off it; the kernels
    `unused` (of the main path, which this prove has no use for) not at
    all."""
    missing = sorted(k for k in recursion_path_kernels() - set(unused)
                     if not launches[k])
    if missing:
        raise AssertionError(f"{what} launched no {missing}")
    used = {k: launches[k] for k in unused if launches[k]}
    if used:
        raise AssertionError(f"{what} launched {used}, which it has no use for")
    off = {k: launches[k] for k in OFF_PATH if launches[k]}
    if off:
        raise AssertionError(f"{what} launched {off} off its path")


def busy_share(torch, fn) -> dict:
    """One call of fn under torch.profiler: its wall seconds, the device
    seconds by kernel of KERNELS and of torch's own kernels, and the share
    of the wall time the card was busy (profile_prove.py's measure)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()       # the tracer's start-up, not timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    ours, other = kernel_device_ms(prof)
    ours.pop("torch_sort", None)
    busy_s = (sum(ours.values()) + other) / 1e3
    return {"profiled_wall_s": wall_s, "device_s": busy_s,
            "kernel_device_s": {k: v / 1e3 for k, v in ours.items()},
            "other_device_s": other / 1e3, "busy_share": busy_s / wall_s}


def phase_recursion(ck: Checker, torch) -> None:
    """The reference's recursion workload (src/bin/recursion.rs) through the
    port's entry points on the card, under one pinned_random() from the
    inner build to the level-2 proof:
    level 1: a 2^RECURSION_INNER_LG-gate BufferGate circuit over
    Tweedledum, proved
    and verified natively without the G check (its OldProof old0 kept);
    the recursion circuit over Tweedledee with the real inner vk, its
    witness, the host constraint checks, the proof, verified
    with the G check; level 2: the recursion circuit over Tweedledum that
    verifies the level-1 proof and re-checks level 1's deferred values,
    its proof consuming old0, verified with the G check, and the chain
    ended by verify_assumptions_native on its public inputs.  The two
    recursive proofs' sha256 must be RECURSION_L1_SHA256 and
    RECURSION_L2_SHA256; each recursive prove must launch every kernel of
    the main path (the counts reset just before it).  Afterwards every
    shape the two proves gave a kernel (PathRecorder) is held against its
    plain version and timed, and each recursive prove is run once more
    under torch.profiler for the card's busy share, after a steady prove
    timed with its phases.  Prints the held shapes' line and one line per
    level.  tests/fixtures/recursion_l1_* hold the level-1 proof, its vk
    and public inputs, as this phase made them."""
    import hashlib

    import plonky_tpu_torch.circuit.builder as builder_mod
    import plonky_tpu_torch.protocol.halo as halo_mod
    from plonky_tpu_torch import _cuda
    from plonky_tpu_torch.circuit import PartialWitness
    from plonky_tpu_torch.curves import TWEEDLEDEE, TWEEDLEDUM
    from plonky_tpu_torch.protocol import circuit as pcircuit
    from plonky_tpu_torch.protocol import generate_proof, verify_proof
    from plonky_tpu_torch.protocol.checks import (check_circuit_constraints,
                                                  check_copy_constraints)
    from plonky_tpu_torch.protocol.recursion import (
        recursive_verification_circuit, verify_assumptions_native)
    from plonky_tpu_torch.protocol.serialization import proof_to_bytes
    from plonky_tpu_torch.recursion_demo import buffer_inner_circuit
    from plonky_tpu_torch.utils.timing import record_phases

    bases_s = [0.0]
    bases = pcircuit.pedersen_bases

    def timed_bases(curve, degree):
        t0 = time.perf_counter()
        out = bases(curve, degree)
        bases_s[0] += time.perf_counter() - t0
        return out

    def clock(out, key, fn, *args, **kwargs):
        """fn's result; its seconds, the card synchronized, under out[key],
        less the Pedersen hashing it did (under out["bases_s"])."""
        bases_s[0] = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args, **kwargs)
        torch.cuda.synchronize()
        out[key] = time.perf_counter() - t0 - bases_s[0]
        if bases_s[0]:
            out["bases_s"] = out.get("bases_s", 0.0) + bases_s[0]
        return res

    def checks(circuit, witness):
        check_circuit_constraints(circuit, witness)
        check_copy_constraints(circuit, witness)

    def sha(curve, proof):
        return hashlib.sha256(proof_to_bytes(curve, proof)).hexdigest()

    inner, l1, l2 = {}, {"phase": "recursion_level1"}, {"phase": "recursion_level2"}
    rec = PathRecorder()
    saved = (builder_mod.RANDOM_SOURCE, halo_mod.RANDOM_SOURCE)
    builder_mod.RANDOM_SOURCE = halo_mod.RANDOM_SOURCE = pinned_random()
    pcircuit.pedersen_bases = timed_bases
    try:
        # the inner proof over Tweedledum; its G check deferred (old0)
        inner_circuit = clock(inner, "build_s", buffer_inner_circuit,
                              RECURSION_INNER_LG, "cuda")
        inner_witness = clock(inner, "witness_s", inner_circuit.generate_witness,
                              PartialWitness())
        inner_proof = clock(inner, "prove_s", generate_proof, inner_circuit,
                            inner_witness, old_proofs=[], blinding=True)
        inner_vk = inner_circuit.to_vk()
        old0 = clock(inner, "verify_s", verify_proof, [], inner_proof, [], inner_vk,
                     TWEEDLEDEE, verify_g=False)
        inner["degree"] = inner_circuit.degree()

        # level 1 over Tweedledee
        rc1 = clock(l1, "build_s", recursive_verification_circuit, TWEEDLEDEE,
                    TWEEDLEDUM, RECURSION_INNER_LG, 128, num_public_inputs=0,
                    num_old_proofs=0, inner_vk=inner_vk)
        inputs = PartialWitness()
        rc1.proof.populate_witness(inputs, inner_proof, [])
        w1 = clock(l1, "witness_s", rc1.circuit.generate_witness, inputs)
        clock(l1, "check_s", checks, rc1.circuit, w1)
        pis1 = rc1.circuit.get_public_inputs(w1)
        _cuda.reset_launches()
        rec.level = "level1"
        with rec, record_phases() as phases:
            proof1 = clock(l1, "prove_s", generate_proof, rc1.circuit, w1,
                           old_proofs=[], blinding=True)
        l1["prove_phases_s"] = phases
        l1["launches"] = dict(_cuda.LAUNCHES)
        check_path_launches(l1["launches"], "the level-1 recursive prove")
        vk1 = rc1.circuit.to_vk()
        clock(l1, "verify_s", verify_proof, pis1, proof1, [], vk1, TWEEDLEDUM,
              verify_g=True)

        # level 2 over Tweedledum: verifies proof1, re-checks level 1's
        # deferred values, consumes old0
        rc2 = clock(l2, "build_s", recursive_verification_circuit, TWEEDLEDUM,
                    TWEEDLEDEE, rc1.circuit.degree_pow(), 128,
                    num_public_inputs=len(pis1), num_old_proofs=0, inner_vk=vk1,
                    inner_recursion={
                        "degree_pow": RECURSION_INNER_LG, "num_old_proofs": 0,
                        "num_inner_pis": 0,
                        "num_gates_without_pis": inner_vk.num_gates_without_pis})
        inputs = PartialWitness()
        rc2.proof.populate_witness(inputs, proof1, pis1)
        w2 = clock(l2, "witness_s", rc2.circuit.generate_witness, inputs)
        clock(l2, "check_s", checks, rc2.circuit, w2)
        pis2 = rc2.circuit.get_public_inputs(w2)
        _cuda.reset_launches()
        rec.level = "level2"
        with rec, record_phases() as phases:
            proof2 = clock(l2, "prove_s", generate_proof, rc2.circuit, w2,
                           old_proofs=[old0], blinding=True)
        l2["prove_phases_s"] = phases
        l2["launches"] = dict(_cuda.LAUNCHES)
        check_path_launches(l2["launches"], "the level-2 recursive prove")
        clock(l2, "verify_s", verify_proof, pis2, proof2, [old0], rc2.circuit.to_vk(),
              TWEEDLEDEE, verify_g=True)
        clock(l2, "verify_assumptions_native_s", verify_assumptions_native, pis2,
              TWEEDLEDEE, TWEEDLEDUM, rc1.circuit.degree_pow(),
              num_inner_pis=len(pis1),
              num_gates_without_pis=vk1.num_gates_without_pis)
    finally:
        builder_mod.RANDOM_SOURCE, halo_mod.RANDOM_SOURCE = saved
        pcircuit.pedersen_bases = bases

    for out, rc, proof, curve in ((l1, rc1, proof1, TWEEDLEDEE),
                                  (l2, rc2, proof2, TWEEDLEDUM)):
        out.update({"gates": rc.circuit.num_gates_without_pis,
                    "degree": rc.circuit.degree(),
                    "public_inputs": rc.circuit.num_public_inputs,
                    "proof_sha256": sha(curve, proof), "verified": True})
    l1["inner"] = inner
    l2["old_proofs"] = 1
    l2["verify_assumptions_native"] = True

    # every shape of the two proves against its plain version, timed: one
    # line of them all, and a summary in each kernel's record
    hold_path(ck, rec, "recursion", ("level1", "level2"))
    for out, level in ((l1, "level1"), (l2, "level2")):
        out["launches_by_shape"] = shapes_add_up(rec, level, out["launches"])
    # each recursive prove again (the random source no longer pinned): a
    # steady prove timed with its phases, then one under torch.profiler for
    # the card's busy share
    for out, rc, w, olds in ((l1, rc1, w1, []), (l2, rc2, w2, [old0])):
        def prove(rc=rc, w=w, olds=olds):
            return generate_proof(rc.circuit, w, old_proofs=olds, blinding=True)
        with record_phases() as phases:
            clock(out, "steady_prove_s", prove)
        out["phases_s"] = phases
        out.update(busy_share(torch, prove))
    emit(l1)
    emit(l2)
    for out, want in ((l1, RECURSION_L1_SHA256), (l2, RECURSION_L2_SHA256)):
        if out["proof_sha256"] != want:
            raise AssertionError(f"{out['phase']}: proof sha256 "
                                 f"{out['proof_sha256']}, pinned {want}")


def path_prove(torch, rec: PathRecorder, level: str, fn, what: str, unused=()):
    """fn() (a prove) with the launch counts reset just before it and
    read just after, its shapes recorded under `level`: (its result, its
    seconds, its phases, its launches); every kernel of the main path but
    `unused` must have launched, and those not (check_path_launches)."""
    from plonky_tpu_torch import _cuda
    from plonky_tpu_torch.utils.timing import record_phases

    torch.cuda.synchronize()
    _cuda.reset_launches()
    rec.level = level
    t0 = time.perf_counter()
    with rec, record_phases() as phases:
        out = fn()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    check_path_launches(launches, what, unused)
    return out, seconds, phases, launches


def pasta_kernel_checks(ck: Checker, torch, np, dev) -> dict:
    """K1 and K3 on both Pasta base fields and K2 and K4 on both Pasta
    curves against their plain versions at ragged shapes: K1's add, sub
    and mul at N = 9 2^14 + 1 (full and column operands), a product sum
    with negative terms and singles, and field_exp at N = 1000 (exp_cases,
    the edge values first); the card's twiddle tables at 2^17
    against the host; K3 at B = 3 and 5 (n = 2 and 2^10) in all four kinds
    and [1, 2^17] on a coset; K2's add and double at the 2^12 + 5 points of
    sweep_basis (P + P, P + (-P) and the identity among them); K4 (k4_sweep,
    each MSM against the discrete-log oracle) at K = 1, 2 and 9 with c = 8,
    K = 1 with c = 5 and signed c = 8; and every Horner step of the K = 2
    window sums through K2 (check_horner).  Returns what was checked."""
    from plonky_tpu_torch.curves import PALLAS, VESTA
    from plonky_tpu_torch.curves import msm as cmsm
    from plonky_tpu_torch.curves import ops as cops
    from plonky_tpu_torch.fields import ops as fops
    from plonky_tpu_torch.poly import fft as pfft

    rng = np.random.default_rng(31415)
    done = {}
    for curve in (PALLAS, VESTA):
        sf = curve.base                  # the other curve's scalar field
        n = (9 << 14) + 1
        a, b, c = (with_edges(fops, sf, rand_field(np, torch, rng, (n,), dev, sf))
                   for _ in range(3))
        col = rand_field(np, torch, rng, (1,), dev, sf)
        for name, fn, plain in (("field_add", fops.add, fops.add_plain),
                                ("field_sub", fops.sub, fops.sub_plain),
                                ("field_mul", fops.mul, fops.mul_plain)):
            for x, y in ((a, b), (col, b), (b, b), (a, col)):
                ck.compare(name, fn(sf, x, y), plain(sf, x, y))
        terms = [(col, a, 1), (b, c, -1), (a, None, 1), (c, None, -1)]
        ck.compare("field_product_sum", fops.product_sum(sf, terms),
                   fops.product_sum_plain(sf, terms))
        for e in exp_cases(sf).values():
            ck.compare("field_exp", fops.exp_const(sf, a[:, :1000], e),
                       fops.exp_const_plain(sf, a[:, :1000], e))

        check_twiddle_tables(torch, sf, 17, dev)
        ntt_shapes = [(bt, lg, inv, cos) for bt, lg in ((3, 1), (5, 10))
                      for inv in (False, True) for cos in (False, True)]
        ntt_shapes.append((1, 17, False, True))
        for batch, lg, inverse, coset in ntt_shapes:
            pre = pfft.FftPrecomputation(sf, 1 << lg)
            x = with_edges(fops, sf, rand_field(np, torch, rng, (batch, 1 << lg),
                                                dev, sf))
            shift = sf.generator if coset else None
            ck.compare("ntt_pass", pfft.ntt(pre, x, inverse, shift),
                       pfft.ntt_plain(pre, x, inverse, shift))

        a_log = int(rng.integers(2, 1 << 62))
        _chain, chain_dev = doubling_chain(curve, a_log, dev)
        pts, _logs = sweep_basis(torch, curve, chain_dev)
        rolled = tuple(torch.roll(t, 1, dims=1).contiguous() for t in pts)
        ck.compare("curve_add", cops.add(curve, pts, rolled),
                   cops.add_plain(curve, pts, rolled))
        ck.compare("curve_add", cops.add(curve, pts, pts),
                   cops.add_plain(curve, pts, pts))
        summed = cops.add(curve, pts, rolled)
        ck.compare("curve_double", cops.double(curve, summed),
                   cops.double_plain(curve, summed))
        cases = ((1, 8, False), (2, 8, False), (9, 8, False), (1, 5, False),
                 (1, 8, True))
        nbs = k4_sweep(ck, torch, np, dev, curve, chain_dev, a_log, rng, cases)
        scal = rand_field(np, torch, rng, (2, SWEEP_N), dev, curve.scalar)
        digits, order, starts, signs, w = cmsm.window_rows(curve, scal, 8)
        basis = cmsm.precompute_base(curve, pts)
        ws = cmsm.bucket_reduce(curve, *cmsm.bucket_accumulate(
            curve, basis, digits, order, starts, signs), starts)
        check_horner(ck, cops, cmsm, curve, tuple(t.reshape(8, 2, w) for t in ws), 8)
        done[curve.name] = {"field": sf.name, "k1_N": n, "ntt": ntt_shapes,
                            "k2_N": SWEEP_N, "k4_cases": [list(c) for c in cases],
                            "k4_buckets": nbs, "horner": [8, 2, w]}
    return done


def phase_pasta(ck: Checker, torch, name_power: str) -> None:
    """The Pallas/Vesta cycle through the port's entry points: the trivial
    and sum_pi circuits over Pallas and over Vesta under a fresh
    pinned_random() each, proof and vk byte-equal to the JAX package's
    (tests/fixtures/{proof,vk}_{trivial,sum_pi}_{pallas,vesta}.hex) and
    verified with the G check; then the 2^14 BufferGate circuit over Pallas
    (Vesta the inner curve) with the random source pinned from its build,
    proved first and steady (its launches counted by shape, every kernel of
    the main path launched), verified with the G check, its proof at
    PROOF_PALLAS_2E14_SHA256, and every shape of the steady prove held
    against its plain version."""
    import hashlib

    import plonky_tpu_torch.circuit.builder as builder_mod
    import plonky_tpu_torch.protocol.halo as halo_mod
    from plonky_tpu_torch.curves import PALLAS, VESTA
    from plonky_tpu_torch.protocol import circuit as pcircuit
    from plonky_tpu_torch.protocol import generate_proof, verify_proof
    from plonky_tpu_torch.protocol.serialization import proof_to_bytes

    out = {"phase": f"pasta_2e{PASTA_LG}", "nvidia_smi": name_power,
           "fixtures": {}}
    for curve in (PALLAS, VESTA):
        out["fixtures"].update(fixture_proofs(
            curve, small_circuits(curve), "_" + curve.name.lower()))

    rec = PathRecorder()
    saved = (builder_mod.RANDOM_SOURCE, halo_mod.RANDOM_SOURCE)
    builder_mod.RANDOM_SOURCE = halo_mod.RANDOM_SOURCE = pinned_random()
    try:
        t0 = time.perf_counter()
        pcircuit.pedersen_bases(PALLAS, 1 << PASTA_LG)
        out["bases_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        circuit, inputs = buffer_circuit(PASTA_LG, curve=PALLAS)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        witness = circuit.generate_witness(inputs)
        out["witness_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        generate_proof(circuit, witness, old_proofs=[], blinding=True)
        torch.cuda.synchronize()
        out["first_prove_s"] = time.perf_counter() - t0
        proof, out["steady_prove_s"], out["phases_s"], out["launches"] = \
            path_prove(torch, rec, "pallas", lambda: generate_proof(
                circuit, witness, old_proofs=[], blinding=True),
                "the steady Pallas prove")
    finally:
        builder_mod.RANDOM_SOURCE, halo_mod.RANDOM_SOURCE = saved
    out["proof_sha256"] = hashlib.sha256(proof_to_bytes(PALLAS, proof)).hexdigest()
    t0 = time.perf_counter()
    verify_proof(circuit.get_public_inputs(witness), proof, [], circuit.to_vk(),
                 VESTA, verify_g=True)
    out["verify_s"] = time.perf_counter() - t0
    out["verified"] = True
    out["degree"] = circuit.degree()
    out["launches_by_shape"] = shapes_add_up(rec, "pallas", out["launches"])
    hold_path(ck, rec, "pasta", ("pallas",))
    emit(out)
    if out["proof_sha256"] != PROOF_PALLAS_2E14_SHA256:
        raise AssertionError(f"the pinned Pallas 2^{PASTA_LG} proof's sha256 is "
                             f"{out['proof_sha256']}, not {PROOF_PALLAS_2E14_SHA256}")


def plookup_range_check(np):
    """A 16-bit range check: (f, t) with t = [0, 2^16) and f 2^16 - 1
    values drawn from t by a seeded generator (repeats among them), so
    that n + 1 = 2^16."""
    t = list(range(1 << PLOOKUP_LG))
    rng = np.random.default_rng(PLOOKUP_LG)
    f = [int(v) for v in rng.integers(0, 1 << PLOOKUP_LG, (1 << PLOOKUP_LG) - 1)]
    return f, t


def changed_opening_proof(f, t, device=None):
    """A 2^16 plookup proof whose f opening at zeta is one more than the
    polynomial's, made by the prover itself, so that its transcript (the
    changed opening observed, the IPA blinded until each n(r) is a square)
    replays: only the verifier's quotient check can reject it."""
    import plonky_tpu_torch.plookup.plookup as plookup_mod
    from plonky_tpu_torch.curves import TWEEDLEDEE

    honest = plookup_mod._open_all
    p = TWEEDLEDEE.scalar.p

    def changed(*args):
        o = honest(*args)
        o.f = plookup_mod.Opening((o.f.local + 1) % p, o.f.right)
        return o
    plookup_mod._open_all = changed
    try:
        return plookup_mod.prove(TWEEDLEDEE, f, t, device=device)
    finally:
        plookup_mod._open_all = honest


def rejected(curve, t, bad, message: str, device=None) -> str:
    """plookup.verify's message for `bad`, whose transcript must replay:
    the rejection must be the check named by `message`."""
    from plonky_tpu_torch import plookup

    bad.get_challenges(curve)
    try:
        plookup.verify(curve, t, bad, device=device)
    except ValueError as e:
        if message not in str(e):
            raise AssertionError(f"plookup.verify rejected with {e!r}, "
                                 f"not {message!r}") from e
        return str(e)
    raise AssertionError(f"plookup.verify accepted a proof that must fail "
                         f"with {message!r}")


def phase_plookup(ck: Checker, torch, np, name_power: str) -> None:
    """plookup's entry points on the card.  The reference test's case (n =
    7, tests/test_plookup.py's random source) first: its proof's sha256
    (PlookupProof.to_bytes) must be PLOOKUP_N7_SHA256, the JAX package's
    (tests/test_torch_plookup.py).  Then the 16-bit range check of
    plookup_range_check over Tweedledee (2^17 Pedersen bases hashed first,
    timed apart), with pinned_random(): one prove (launches counted by
    shape, every kernel of the main path launched; the host setup, the sort,
    the grand product and the Lagrange constants, timed apart), its sha256
    at PLOOKUP_2E16_SHA256, verified; a proof with one changed opening
    and a valid transcript must fail the quotient check, one with a changed
    Schnorr z1 the IPA check, and a value outside the table must raise; a
    steady prove under torch.profiler for the card's busy share; every
    shape of the first prove held against its plain version.  The twiddle
    tables are dropped before the counted prove, so that its launches are
    its own and not those left by earlier phases."""
    import dataclasses
    import hashlib

    import plonky_tpu_torch.protocol.halo as halo_mod
    from plonky_tpu_torch import plookup
    from plonky_tpu_torch.curves import TWEEDLEDEE
    from plonky_tpu_torch.poly.fft import FftPrecomputation
    from plonky_tpu_torch.protocol.circuit import pedersen_bases

    def sha(proof):
        return hashlib.sha256(proof.to_bytes(TWEEDLEDEE)).hexdigest()

    out = {"phase": f"plookup_2e{PLOOKUP_LG}", "nvidia_smi": name_power}
    saved = halo_mod.RANDOM_SOURCE
    try:
        rng = np.random.default_rng(99)
        halo_mod.RANDOM_SOURCE = lambda p: int.from_bytes(rng.bytes(40), "little") % p
        t_small = [1, 2, 3, 5, 7, 11, 13]
        small = plookup.prove(TWEEDLEDEE, [2, 2, 5, 11], t_small)
        plookup.verify(TWEEDLEDEE, t_small, small)
        out["n7_sha256"] = sha(small)
        if out["n7_sha256"] != PLOOKUP_N7_SHA256:
            raise AssertionError(f"the n = 7 plookup proof's sha256 is "
                                 f"{out['n7_sha256']}, the JAX package's is "
                                 f"{PLOOKUP_N7_SHA256}")

        f, t = plookup_range_check(np)
        n = (1 << PLOOKUP_LG) - 1
        t0 = time.perf_counter()
        pedersen_bases(TWEEDLEDEE, 2 * n + 2)
        out["bases_s"] = time.perf_counter() - t0
        rec = PathRecorder()
        halo_mod.RANDOM_SOURCE = pinned_random()
        FftPrecomputation.cache_clear()
        proof, out["prove_s"], phases, out["launches"] = path_prove(
            torch, rec, "plookup", lambda: plookup.prove(TWEEDLEDEE, f, t),
            "the plookup prove", unused=("field_exp",))   # no inverse on the card
        out["prove_phases_s"] = phases
        out["host_setup_s"] = {k: phases[f"plookup.{k}"] for k in
                               ("sort", "grand_product", "vanishing_consts")}
        out["proof_sha256"] = sha(proof)
        t0 = time.perf_counter()
        plookup.verify(TWEEDLEDEE, t, proof)
        out["verify_s"] = time.perf_counter() - t0
        out["changed_opening_rejected"] = rejected(
            TWEEDLEDEE, t, changed_opening_proof(f, t),
            "Incorrect quotient opening")
        hp = proof.halo_proof
        bad_ipa = dataclasses.replace(proof, halo_proof=dataclasses.replace(
            hp, schnorr_proof=dataclasses.replace(
                hp.schnorr_proof,
                z1=(hp.schnorr_proof.z1 + 1) % TWEEDLEDEE.scalar.p)))
        out["changed_z1_rejected"] = rejected(TWEEDLEDEE, t, bad_ipa,
                                              "Invalid IPA proof")
        try:
            plookup.prove(TWEEDLEDEE, f[:-1] + [1 << PLOOKUP_LG], t)
        except KeyError as e:
            out["outside_table_raised"] = f"KeyError {e}"
        else:
            raise AssertionError("plookup.prove took a value outside the table")
        out.update(busy_share(torch, lambda: plookup.prove(TWEEDLEDEE, f, t)))
    finally:
        halo_mod.RANDOM_SOURCE = saved
    out["n"] = proof.n
    out["launches_by_shape"] = shapes_add_up(rec, "plookup", out["launches"])
    hold_path(ck, rec, "plookup", ("plookup",))
    emit(out)
    if out["proof_sha256"] != PLOOKUP_2E16_SHA256:
        raise AssertionError(f"the 2^{PLOOKUP_LG} plookup proof's sha256 is "
                             f"{out['proof_sha256']}, not {PLOOKUP_2E16_SHA256}")


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

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name_power, clock_hz, sms, int_rate = card(torch)
    t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    # ptxas's register and spill lines by object (field_kernels, ...,
    # field_kernels_l12, ...), in the build log's order
    ptxas, obj = {}, None
    if os.path.exists(_cuda.BUILD_LOG):
        with open(_cuda.BUILD_LOG) as f:
            for ln in f:
                if ln.startswith("== "):
                    obj = ln.split()[1]
                    ptxas[obj] = []
                elif obj and ("registers" in ln or "spill" in ln):
                    ptxas[obj].append(ln.strip())
    emit({"phase": "env", "nvidia_smi": name_power,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "sms": sms, "max_sm_clock_mhz": clock_hz / 1e6,
          "int32_imad_per_s": int_rate, "build_s": build_s,
          "built_now": _cuda.BUILD_SECONDS[0] is not None,
          "object_s": dict(_cuda.OBJECT_SECONDS), "ptxas": ptxas})

    ck = Checker(torch, clock_hz, int_rate)
    seconds = {}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = time.perf_counter() - t0
        return out
    timed("kernels", phase_kernels, ck, torch, np, dev)
    rescue_launches = timed("rescue", phase_rescue, ck, torch, np, dev, name_power)
    bls_launches = timed("bls12_377", phase_bls12_377, ck, torch, np, dev, name_power)
    poly_launches = timed("bls12_377_poly", phase_bls12_377_poly, ck, torch, np, dev,
                          name_power)
    probe_launches = timed("probe", phase_probe, ck, torch, np, dev, name_power)
    parallel_launches = timed("parallel", phase_parallel, ck, torch, np, dev,
                              name_power)
    timed("fixtures", phase_fixtures)
    timed("gadgets", phase_gadgets)
    timed("ladder", phase_ladder)
    launches, ps_by_label = timed("prove", phase_prove, torch,
                                  want_sha256=PROOF_2E14_SHA256)
    timed("recursion", phase_recursion, ck, torch)
    timed("pasta", phase_pasta, ck, torch, name_power)
    timed("plookup", phase_plookup, ck, torch, np, name_power)
    launches["rescue_permutation"] = rescue_launches
    launches.update(bls_launches)
    launches.update(poly_launches)
    launches.update(probe_launches)
    launches.update(parallel_launches)
    emit({"phase": "seconds", "build_s": build_s, **seconds,
          "total_s": time.perf_counter() - t_start})
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
