#!/usr/bin/env python3
"""Times the MSM's kernels (K4, the bucket kernels, and the Horner across
windows) of one or more plonky_tpu_torch trees on one NVIDIA GPU, at every
shape of chip_smoke.k4_cases, K1's field multiply, K1's product sums and
whole NTT calls at the prove's shapes, and proves the pinned 2^14 circuit
with each tree.

    python3 k4_compare.py [ROOT ...]

Each ROOT (default: this checkout) is a directory holding a
plonky_tpu_torch package, for instance an earlier commit unpacked with
`git archive`.  The trees run one after the other, each in a process of
its own, in the order given: give them in turns (A B B A) to compare two
on one card.  Per tree it prints the card's nvidia-smi line, then one JSON
line: per shape, the device time per launch of each K4 kernel (CUDA events
over launches queued behind a sleep, L2 warm and flushed, as chip_smoke.py
takes them), the device time of the Horner of the shape's window sums
(`msm.horner` where the tree has it, else the loop of `ops.double` /
`ops.add` that `msm` ran before it; L2 warm), a whole `msm` call, and the
sha256 of the Horner's and the MSM's affine results (the reduce's order,
and so the window sums' projective coordinates, may differ between trees);
the elementwise curve_add / curve_double at two shapes; `fops.mul` at
N = 9 2^14, 2^14, 2^17 and 1 (L2 warm and flushed) and whole `pfft.fft` /
`ifft` / `lde` / `coset_fft` / `coset_ifft` calls at the 2^14 prove's
shapes (device time of the whole call, however many launches it makes,
where the host can queue calls ahead of the card, and a call's time back
to back, host included), each with the sha256 of its output; the product
sums of every launch shape of chip_smoke.product_sum_shapes (device time
of one launch's sums, as one `product_sums` call or, in a tree without
it, one `product_sum` launch a sum; L2 warm and flushed; the sha256 of
the outputs); K5 (rescue_permutation) on 2^14 and 2^16 TweedledeeBase
states at 128 bits (device ms of a launch, L2 warm, and the sha256 of the
output); BLS12-377 G1 at 12 limbs at the bench's settings (chunk_log 16,
c = 8; `_bls_rows`): both accumulate entries on one 2^16 slice, the reduce
at that slice's 32 rows and at the 2,048 rows of all 64 slices of 2^22
points (L2 warm and flushed), and whole `msm_chunked` calls at 2^22,
unsigned and signed (median seconds of three, host clock to a
synchronize), each result hashed as affine points; the Fq transforms at
12 limbs of chip_smoke.py's `bls12_377_poly` path (FQ_TRANSFORMS: fft and
ifft at [1, 2^22] and [9, 2^20], the coset pair at [1, 2^20],
fft_four_step at 2^22; device ms of the whole call, however many launches
it makes, L2 warm and flushed, and the sha256 of each output); the
probe's bucket accumulation (Tweedledee, 2^18 points, chip_smoke.MSM_PROBE:
unsigned and signed windows, L2 warm and flushed, its buckets hashed);
`fops.inverse` at EXP_SHAPES (one field_exp launch, or in a tree without
it exp_const's chain of field_mul launches; device ms of the whole call,
L2 warm and flushed, and the call back to back, host included) and the 12-limb field_mul at N = 1 and 2^16; then
chip_smoke.py's pinned prove line.  Last, one line compares the trees: every hash must
agree (the pinned proof's too), or the exit code is not 0.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BLS_LOG = 22         # points of _bls_rows's msm_chunked calls: 2^22


def _smoke():
    """This checkout's chip_smoke.py, loaded by path: its helpers import
    plonky_tpu_torch lazily, so they use the tree first on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "k4_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _k4_calls(cmsm, curve, sub, digits, order, starts):
    """(accumulate, reduce) closures over one shape's inputs.  A tree whose
    MsmBasis has no Montgomery copy is the one before the redesign, whose
    kernels take (order, starts) and the bucket sums alone."""
    if hasattr(sub, "mont"):
        def acc():
            return cmsm.bucket_accumulate(curve, sub, digits, order, starts)
        out = acc()

        def red():
            return cmsm.bucket_reduce(curve, *out, starts)
    else:
        def acc():
            return cmsm.bucket_accumulate(curve, sub, order, starts)
        out = acc()

        def red():
            return cmsm.bucket_reduce(curve, out)
    return acc, red


def _horner_call(cmsm, cops, curve, ws, c):
    """(the Horner of window sums ws [8, K, W], calls to time in a row): one
    curve_horner launch, or in a tree without it, the (W - 1) (c + 1)
    launches of curves/msm.py's loop before it, timed one call at a time
    so that the launch queue never fills and stalls the host."""
    if hasattr(cmsm, "horner"):
        return (lambda: cmsm.horner(curve, ws, c)), 10

    def loop():
        n_windows = ws[0].shape[-1]
        acc = tuple(t[..., n_windows - 1].contiguous() for t in ws)
        for w in range(n_windows - 2, -1, -1):
            for _ in range(c):
                acc = cops.double(curve, acc)
            acc = cops.add(curve, acc, tuple(t[..., w] for t in ws))
        return acc
    return loop, 1


def _elementwise_rows(smoke, ck, np, torch, cops, curve, dev):
    """curve_add / curve_double on random limbs at [8, 2] (a Horner step's
    shape on the IPA rounds) and [8, 2^14 + 3]: device ms per launch, L2
    warm and flushed, and the sha256 of the outputs."""
    rng = np.random.default_rng(99)
    flush = ck.flush.zero_
    rows = []
    for n in (2, (1 << 14) + 3):
        a, b = (tuple(smoke.rand_field(np, torch, rng, (n,), dev) for _ in range(3))
                for _ in range(2))
        for name, fn in (("curve_add", lambda a=a, b=b: cops.add(curve, a, b)),
                         ("curve_double", lambda a=a: cops.double(curve, a))):
            rows.append({"name": name, "shape": [8, n],
                         "sha256": hashlib.sha256(torch.cat(fn()).cpu().numpy()
                                                  .tobytes()).hexdigest(),
                         "ms": ck.queued_ms(fn, 20),
                         "cold_ms": (ck.queued_ms(lambda fn=fn: (flush(), fn()), 20)
                                     - ck.queued_ms(flush, 20))})
    return rows


# (label, function name, B, lg n of the call's input, coset) of the
# transforms timed: the wires' LDE input [9, 2^14] and its [9, 2^17] FFT,
# the wires' iFFT, and the B = 1 transforms of the t quotient.
TRANSFORMS = (("fft [9, 2^17]", "fft", 9, 17, False),
              ("lde [9, 2^14] -> 2^17", "lde", 9, 14, False),
              ("ifft [9, 2^14]", "ifft", 9, 14, False),
              ("ifft [1, 2^17]", "ifft", 1, 17, False),
              ("coset_fft [1, 2^17]", "coset_fft", 1, 17, True),
              ("coset_ifft [1, 2^17]", "coset_ifft", 1, 17, True),
              ("coset_fft [1, 2^14]", "coset_fft", 1, 14, True))


def _k1_k3_rows(smoke, ck, np, torch, dev):
    """fops.mul at four sizes and the TRANSFORMS: device ms of a call, L2
    warm (and flushed for the multiply), and the sha256 of the output."""
    from plonky_tpu_torch.curves import TWEEDLEDEE
    from plonky_tpu_torch.fields import ops as fops
    from plonky_tpu_torch.poly import fft as pfft
    sf = TWEEDLEDEE.scalar
    rng = np.random.default_rng(77)
    flush = ck.flush.zero_

    def digest(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
    def queued(fn, reps):
        """Device ms per call, or None where the call waits on the card
        (the parent's coset transforms upload a column each call)."""
        try:
            return ck.queued_ms(fn, reps)
        except AssertionError:
            return None
    rows = []
    # N = 9 2^14 (the wires), and the prove's most common sizes (PERF.md)
    for n in (9 << 14, 1 << 14, 1 << 17, 1):
        a, b = (smoke.rand_field(np, torch, rng, (n,), dev) for _ in range(2))
        rows.append({"name": "field_mul", "shape": [8, n],
                     "sha256": digest(fops.mul(sf, a, b)),
                     "ms": ck.queued_ms(lambda: fops.mul(sf, a, b), 50),
                     "cold_ms": (ck.queued_ms(lambda: (flush(), fops.mul(sf, a, b)), 50)
                                 - ck.queued_ms(flush, 50))})
    for label, fn_name, batch, lg, coset in TRANSFORMS:
        x = smoke.rand_field(np, torch, rng, (batch, 1 << lg), dev)
        pre = pfft.FftPrecomputation(sf, (1 << lg) * (8 if fn_name == "lde" else 1))
        fn = getattr(pfft, fn_name)
        call = ((lambda fn=fn, pre=pre, x=x: fn(pre, x, sf.generator)) if coset
                else (lambda fn=fn, pre=pre, x=x: fn(pre, x)))
        rows.append({"name": fn_name, "shape": label, "sha256": digest(call()),
                     "ms": queued(call, 10), "call_ms": ck.time_ms(call, 10)})
    return rows


def _product_sum_rows(smoke, ck, np, torch, dev):
    """The product sums at every launch shape of a steady 2^14 prove
    (chip_smoke.product_sum_shapes): device ms of the launch's sums, L2
    warm and flushed, through `product_sums` where the tree has it, else
    one `product_sum` launch per sum, and the sha256 of the outputs."""
    from plonky_tpu_torch.curves import TWEEDLEDEE
    from plonky_tpu_torch.fields import ops as fops
    sf = TWEEDLEDEE.scalar
    rng = np.random.default_rng(88)
    flush = ck.flush.zero_
    rows = []
    for label, _site, scale, _launches, named in smoke.product_sum_shapes():
        n = scale << 14
        sums = smoke.product_sum_inputs(
            named,
            lambda _name, n=n: smoke.rand_field(np, torch, rng, (n,), dev),
            lambda _name: smoke.rand_field(np, torch, rng, (1,), dev))
        if hasattr(fops, "product_sums"):
            def call(sums=sums):
                return fops.product_sums(sf, sums)
        else:
            def call(sums=sums):
                return [fops.product_sum(sf, terms) for terms in sums]
        digest = hashlib.sha256(torch.cat(call()).cpu().numpy().tobytes()).hexdigest()
        rows.append({"name": "product_sum", "shape": label, "N": n,
                     "sums": len(sums), "sha256": digest,
                     "ms": ck.queued_ms(call, 20),
                     "cold_ms": (ck.queued_ms(lambda call=call: (flush(), call()), 20)
                                 - ck.queued_ms(flush, 20))})
    return rows


def _k5_rows(smoke, ck, np, torch, dev):
    """K5 (rescue_permutation) on 2^14 and 2^16 TweedledeeBase states at
    128 security bits: device ms of a launch (CUDA events over launches
    queued behind a sleep, L2 warm) and the sha256 of the output."""
    from plonky_tpu_torch.fields import TWEEDLEDEE_BASE
    from plonky_tpu_torch.hashing import rescue as hr
    rng = np.random.default_rng(55)
    rows = []
    for lg in (14, 16):
        state = [smoke.rand_field(np, torch, rng, (1 << lg,), dev) for _ in range(4)]

        def call(state=state):
            return hr.rescue_permutation(TWEEDLEDEE_BASE, state, 128)
        rows.append({"name": "rescue_permutation", "shape": f"2^{lg}",
                     "sha256": hashlib.sha256(torch.cat(call()).cpu().numpy()
                                              .tobytes()).hexdigest(),
                     "ms": ck.queued_ms(call, 10 if lg == 14 else 4)})
    return rows


def _bls_rows(smoke, ck, np, torch, dev):
    """BLS12-377 at 12 limbs (see the module's comment): per row its
    name, rows or log n, the sha256 of its result as affine points (the
    trees may add in other orders, so projective coordinates may differ:
    the buckets and the window sums are compared by value), and its
    device ms a launch (L2 warm and flushed) or its median seconds."""
    from plonky_tpu_torch.curves import BLS12_377 as C
    from plonky_tpu_torch.curves import msm as cmsm
    from plonky_tpu_torch.curves import ops as cops
    flush = ck.flush.zero_
    rng = np.random.default_rng(3770)
    nl, c = C.base.limbs, smoke.BLS_WINDOW
    n, size = 1 << BLS_LOG, 1 << smoke.BLS_CHUNK_LOG
    _chain, chain_dev = smoke.doubling_chain(C, int(rng.integers(2, 1 << 62)), dev)
    basis = cmsm.precompute_base(C, tuple(t.repeat(1, n // smoke.BLS_CHAIN)
                                          for t in chain_dev))
    scal, _limbs = smoke.bls_scalars(np, torch, rng, C.scalar, n, dev)

    def affine_sha(pt):
        x, y, zero = cops.to_affine(C, tuple(t.reshape(nl, -1) for t in pt))
        both = torch.cat([x, y, zero[None].to(torch.int32)])
        return hashlib.sha256(both.cpu().numpy().tobytes()).hexdigest()

    tp = (cmsm.chunk_for(nl) if hasattr(cmsm, "chunk_for") else cmsm.CHUNK
          ) * cmsm.tile_for(nl)

    def buckets_sha(out, starts):
        """The bucket sums B_j (each bucket plus its carries, as the
        reduce adds them: the trees split runs at other tiles)."""
        buckets, carries = out
        rows, nb, w = buckets.shape
        b = cmsm.unpack_points(C, buckets.reshape(-1, w))
        cr = cmsm.unpack_points(C, carries.reshape(-1, w))
        st = starts.to(torch.int64)
        lo, hi = st[:, :-1].reshape(-1), st[:, 1:].reshape(-1)
        t0 = lo // tp + 1
        extra = torch.where(hi > lo, (hi - 1) // tp - t0 + 1, torch.zeros_like(lo))
        brow = torch.arange(rows, device=dev).repeat_interleave(nb)
        for e in range(int(extra.max().item())):
            sel = (extra > e).nonzero().squeeze(1)
            summed = cops.add(C, tuple(t[:, sel] for t in b), tuple(
                t[:, brow[sel] * carries.shape[1] + t0[sel] + e] for t in cr))
            for t, v in zip(b, summed):
                t[:, sel] = v
        return affine_sha(b)

    def timed(fn, reps):
        return {"ms": ck.queued_ms(fn, reps),
                "cold_ms": (ck.queued_ms(lambda: (flush(), fn()), reps)
                            - ck.queued_ms(flush, reps))}
    rows = []
    one = basis.slice(0, size)
    for signed in (False, True):
        digits, order, starts, signs, _w = cmsm.window_rows(
            C, scal[:, :size], c, signed)

        def acc(digits=digits, order=order, starts=starts, signs=signs):
            return cmsm.bucket_accumulate(C, one, digits, order, starts, signs)
        out = acc()
        rows.append({"name": "accumulate" + (" signed" if signed else ""),
                     "rows": digits.shape[0], "sha256": buckets_sha(out, starts),
                     **timed(acc, 10)})
        if not signed:
            def red(out=out, starts=starts):
                return cmsm.bucket_reduce(C, *out, starts)
            rows.append({"name": "reduce", "rows": digits.shape[0],
                         "sha256": affine_sha(red()), **timed(red, 10)})
        del out
    parts = []
    for lo in range(0, n, size):
        digits, order, starts, _s, _w = cmsm.window_rows(C, scal[:, lo:lo + size], c)
        parts.append((*cmsm.bucket_accumulate(C, basis.slice(lo, lo + size),
                                               digits, order, starts), starts))
    bk, cr, st = (torch.cat(t) for t in zip(*parts))
    del parts

    def wide():
        return cmsm.bucket_reduce(C, bk, cr, st)
    rows.append({"name": "reduce", "rows": st.shape[0], "sha256": affine_sha(wide()),
                 **timed(wide, 5)})
    del bk, cr, st
    for signed in (False, True):
        def call(signed=signed):
            return cmsm.msm_chunked(C, basis, scal, window_bits=c,
                                    chunk_log=smoke.BLS_CHUNK_LOG, signed=signed)
        call()
        med, times, res = smoke.median_s(torch, call)
        rows.append({"name": "msm_chunked" + (" signed" if signed else ""),
                     "rows": f"2^{BLS_LOG}", "sha256": affine_sha(res), "median_s": med,
                     "seconds": times, "points_per_s": n / med})
    return rows


# (label, function, B, lg n, inverse) of the Fq transforms timed; the coset
# pair scales by the field's generator, fft_four_step splits 2^22 as
# 2^11 x 2^11 as the path does.
FQ_TRANSFORMS = (("fft [1, 2^22]", "fft", 1, 22, False),
                 ("ifft [1, 2^22]", "ifft", 1, 22, True),
                 ("fft [9, 2^20]", "fft", 9, 20, False),
                 ("ifft [9, 2^20]", "ifft", 9, 20, True),
                 ("coset_fft [1, 2^20]", "coset_fft", 1, 20, False),
                 ("coset_ifft [1, 2^20]", "coset_ifft", 1, 20, True),
                 ("fft_four_step [1, 2^22]", "fft_four_step", 1, 22, False))


def _fq_rows(smoke, ck, np, torch, dev):
    """The FQ_TRANSFORMS over BLS12-377's base field: device ms of a whole
    call (queued behind a sleep, L2 warm and flushed) and the sha256 of
    its output."""
    from plonky_tpu_torch.fields import BLS12_377_BASE as Fq
    from plonky_tpu_torch.poly import fft as pfft
    rng = np.random.default_rng(3771)
    flush = ck.flush.zero_
    rows = []
    for label, fn_name, batch, lg, inverse in FQ_TRANSFORMS:
        x = smoke.rand_field(np, torch, rng, (batch, 1 << lg), dev, Fq)
        pre = pfft.FftPrecomputation(Fq, 1 << lg)
        if fn_name == "fft_four_step":
            tw = pfft.four_step_twiddles(Fq, 1 << lg, smoke.POLY_FOUR_STEP_N1,
                                         device=dev)

            def call(x=x, tw=tw):
                return pfft.fft_four_step(Fq, x, tw, smoke.POLY_FOUR_STEP_N1)
        elif fn_name.startswith("coset"):
            def call(fn=getattr(pfft, fn_name), pre=pre, x=x):
                return fn(pre, x, Fq.generator)
        else:
            def call(fn=getattr(pfft, fn_name), pre=pre, x=x):
                return fn(pre, x)
        digest = hashlib.sha256(call().cpu().numpy().tobytes()).hexdigest()
        rows.append({"name": fn_name, "shape": label, "sha256": digest,
                     "ms": ck.queued_ms(call, 5),
                     "cold_ms": (ck.queued_ms(lambda call=call: (flush(), call()), 5)
                                 - ck.queued_ms(flush, 5))})
        del x
        torch.cuda.empty_cache()
    return rows


def _probe_rows(smoke, ck, np, torch, dev):
    """The bucket accumulation of the probe's MSM (chip_smoke.phase_probe:
    Tweedledee, 2^18 points of a doubling chain, K = 1) at each window of
    chip_smoke.MSM_PROBE, signed and unsigned: device ms of a launch, L2
    warm and flushed, and the sha256 of its buckets and carries (Montgomery
    form, canonical: equal word for word between trees whose products
    agree)."""
    from plonky_tpu_torch.curves import TWEEDLEDEE as C
    from plonky_tpu_torch.curves import msm as cmsm
    flush = ck.flush.zero_
    rng = np.random.default_rng(1818)
    n = 1 << smoke.MSM_PROBE_LOG
    _chain, chain_dev = smoke.doubling_chain(C, int(rng.integers(2, 1 << 62)), dev)
    basis = cmsm.precompute_base(C, tuple(t.repeat(1, n // smoke.BLS_CHAIN)
                                          for t in chain_dev))
    scal, _limbs = smoke.bls_scalars(np, torch, rng, C.scalar, n, dev)
    rows = []
    for c, signed in smoke.MSM_PROBE:
        digits, order, starts, signs, _w = cmsm.window_rows(C, scal, c, signed)

        def acc(digits=digits, order=order, starts=starts, signs=signs):
            return cmsm.bucket_accumulate(C, basis, digits, order, starts, signs)
        rows.append({"name": "accumulate" + (" signed" if signed else ""),
                     "shape": f"2^{smoke.MSM_PROBE_LOG} c={c}",
                     "sha256": hashlib.sha256(torch.cat([t.reshape(-1) for t in acc()])
                                              .cpu().numpy().tobytes()).hexdigest(),
                     "ms": ck.queued_ms(acc, 10),
                     "cold_ms": (ck.queued_ms(lambda acc=acc: (flush(), acc()), 10)
                                 - ck.queued_ms(flush, 10))})
    return rows


# (field, N) of the exponentiations timed: the 8-limb inversions at N = 1,
# a ragged N and the prove's 8n; the 12-limb one of to_affine's single
# point, a ragged N and 2^16.
EXP_SHAPES = (("TweedledumBase", 1), ("TweedledumBase", (1 << 14) + 3),
              ("TweedledumBase", 1 << 17), ("Bls12377Base", 1),
              ("Bls12377Base", (1 << 16) + 3), ("Bls12377Base", 1 << 16))


def _exp_rows(smoke, ck, np, torch, dev):
    """fops.inverse (x^(p - 2): one field_exp launch where the tree has
    the kernel, else exp_const's chain of field_mul launches) at
    EXP_SHAPES, and the 12-limb field_mul at N = 1 and 2^16: device ms of
    the whole call (queued behind a sleep, L2 warm and flushed), the
    inverse's call ms back to back (host included), and the sha256 of
    its output."""
    from plonky_tpu_torch.fields import BLS12_377_BASE, TWEEDLEDUM_BASE
    from plonky_tpu_torch.fields import ops as fops
    fields = {f.name: f for f in (TWEEDLEDUM_BASE, BLS12_377_BASE)}
    flush = ck.flush.zero_
    rng = np.random.default_rng(1616)
    rows = []
    for name, n in EXP_SHAPES:
        spec = fields[name]
        x = smoke.with_edges(fops, spec, smoke.rand_field(np, torch, rng, (n,), dev, spec))

        def call(spec=spec, x=x):
            return fops.inverse(spec, x)
        # one call a timing: the parent's chain queues ~330-560 launches,
        # and the launch queue takes ~1,000
        rows.append({"name": "inverse", "shape": [spec.limbs, n],
                     "sha256": hashlib.sha256(call().cpu().numpy().tobytes()).hexdigest(),
                     "ms": ck.queued_ms(call, 1),
                     "cold_ms": (ck.queued_ms(lambda call=call: (flush(), call()), 1)
                                 - ck.queued_ms(flush, 1)),
                     "call_ms": ck.time_ms(call, 3)})
    spec = BLS12_377_BASE
    for n in (1, 1 << 16):
        a, b = (smoke.rand_field(np, torch, rng, (n,), dev, spec) for _ in range(2))

        def mul(a=a, b=b):
            return fops.mul(spec, a, b)
        rows.append({"name": "field_mul", "shape": [spec.limbs, n],
                     "sha256": hashlib.sha256(mul().cpu().numpy().tobytes()).hexdigest(),
                     "ms": ck.queued_ms(mul, 50),
                     "cold_ms": (ck.queued_ms(lambda mul=mul: (flush(), mul()), 50)
                                 - ck.queued_ms(flush, 50))})
    return rows


def run_tree(root: str) -> int:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k4_compare: CUDA is not available", file=sys.stderr)
        return 2
    smoke = _smoke()
    from plonky_tpu_torch import _cuda
    from plonky_tpu_torch.curves import TWEEDLEDEE
    from plonky_tpu_torch.curves import msm as cmsm
    from plonky_tpu_torch.curves import ops as cops
    from plonky_tpu_torch.protocol.circuit import (pedersen_bases,
                                                   points_to_device)

    name_power, clock_hz, _sms, int_rate = smoke.card(torch)
    print(name_power, flush=True)
    _cuda.library()
    ck = smoke.Checker(torch, clock_hz, int_rate)
    flush = ck.flush.zero_
    dev = torch.device("cuda")
    g_pts, _h, _u = pedersen_bases(TWEEDLEDEE, 1 << 14)
    basis = cmsm.precompute_base(TWEEDLEDEE, points_to_device(
        TWEEDLEDEE, g_pts, dev))
    rng = np.random.default_rng(2024)
    c = 8
    rows_out = []
    for label, scal in smoke.k4_cases(np, torch, rng, dev):
        sub, digits, order, starts, _rows = smoke.k4_inputs(
            torch, cmsm, TWEEDLEDEE.scalar, basis, scal, c)
        acc, red = _k4_calls(cmsm, TWEEDLEDEE, sub, digits, order, starts)
        k = scal.shape[1]
        ws = tuple(t.reshape(8, k, -1) for t in red())
        horner, horner_reps = _horner_call(cmsm, cops, TWEEDLEDEE, ws, c)
        x, y, zero = cops.to_affine(TWEEDLEDEE, cmsm.msm(TWEEDLEDEE, sub, scal, c))
        affine = torch.cat([x, y, zero[None].to(torch.int32)]).cpu().numpy()
        hx, hy, hzero = cops.to_affine(TWEEDLEDEE, horner())
        row = {"shape": label, "K": k, "N": scal.shape[2],
               "horner_sha256": hashlib.sha256(torch.cat(
                   [hx, hy, hzero[None].to(torch.int32)]).cpu().numpy().tobytes()).hexdigest(),
               "msm_affine_sha256": hashlib.sha256(affine.tobytes()).hexdigest(),
               "horner_ms": ck.queued_ms(horner, horner_reps)}
        for name, fn in (("accumulate", acc), ("reduce", red)):
            warm = ck.queued_ms(fn, 10)
            row[f"{name}_ms"] = warm
            row[f"{name}_cold_ms"] = (ck.queued_ms(lambda fn=fn: (flush(), fn()), 10)
                                      - ck.queued_ms(flush, 10))
        row["msm_call_ms"] = ck.time_ms(
            lambda sub=sub, scal=scal: cmsm.msm(TWEEDLEDEE, sub, scal, c), 3)
        rows_out.append(row)
    smoke.emit({"phase": "k4_compare", "root": root, "nvidia_smi": name_power,
                "shapes": rows_out, "elementwise": _elementwise_rows(
                    smoke, ck, np, torch, cops, TWEEDLEDEE, dev),
                "k1_k3": _k1_k3_rows(smoke, ck, np, torch, dev),
                "product_sum": _product_sum_rows(smoke, ck, np, torch, dev),
                "k5": _k5_rows(smoke, ck, np, torch, dev),
                "bls12_377": _bls_rows(smoke, ck, np, torch, dev),
                "fq": _fq_rows(smoke, ck, np, torch, dev),
                "probe": _probe_rows(smoke, ck, np, torch, dev),
                "exp": _exp_rows(smoke, ck, np, torch, dev)})
    smoke.phase_prove(torch, want_sha256=smoke.PROOF_2E14_SHA256,
                      check_launches=False)
    return 0


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        return run_tree(argv[1])
    rc = 0
    hashes = []
    for root in argv or [HERE]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                              root], stdout=subprocess.PIPE, text=True)
        print(out.stdout, end="", flush=True)
        rc |= out.returncode
        for line in out.stdout.splitlines():
            if line.startswith('{"phase": "k4_compare"'):
                rec = json.loads(line)
                hashes.append({(r["shape"], key): r[key] for r in rec["shapes"]
                               for key in ("horner_sha256", "msm_affine_sha256")})
                hashes[-1].update({(r["name"], r["shape"][1]): r["sha256"]
                                   for r in rec["elementwise"]})
                hashes[-1].update({(r["name"], str(r["shape"])): r["sha256"]
                                   for r in rec["k1_k3"] + rec["product_sum"]
                                   + rec["k5"]})
                hashes[-1].update({("bls12_377", r["name"], str(r["rows"])): r["sha256"]
                                   for r in rec["bls12_377"]})
                hashes[-1].update({("fq", r["shape"]): r["sha256"] for r in rec["fq"]})
                hashes[-1].update({(r["name"], str(r["shape"])): r["sha256"]
                                   for r in rec["probe"] + rec["exp"]})
    equal = len(hashes) == len(argv or [HERE]) and all(h == hashes[0] for h in hashes)
    print(json.dumps({"phase": "k4_compare_trees", "trees": len(hashes),
                      "hashes_equal": equal}), flush=True)
    return rc or (0 if equal else 1)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
