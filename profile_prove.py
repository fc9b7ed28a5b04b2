#!/usr/bin/env python3
"""Diagnostics of plonky_tpu_torch's 2^14 prove on one NVIDIA GPU.

    python3 profile_prove.py

Not part of the chip check (chip_smoke.py); run it when PERF.md's
breakdown needs renewing.  It prints JSON lines:

  timing     per-launch device time of a few kernels four ways: CUDA events
             over launches queued behind a sleep (chip_smoke.py's `ms` and
             `cold_ms`) and torch.profiler's kernel time, each with the L2
             cache warm and flushed before every launch, beside the size of
             each kernel's machine code and its most frequent opcodes;
  profile    one steady 2^14 prove under torch.profiler: device seconds of
             each kernel and of everything else, and the share of the wall
             clock the card was busy;
  k1_shapes  one steady prove with K1's elementwise launches counted by
             batch size N (field_add, field_sub, field_mul), and its
             field_product_sum launches by N, sums, products, singles,
             full-column operands and negative terms;
  host       one steady prove under cProfile: the functions with the most
             own time (cProfile slows Python code: read the shares).
"""

from __future__ import annotations

import collections
import cProfile
import os
import pstats
import re
import subprocess
import sys
import time

from chip_smoke import (KERNELS, PS_KEYS, Checker, buffer_circuit, card,
                        counting_product_sums, emit, product_sum_inputs,
                        product_sum_shapes, rand_field)


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, attr, None)
        if v:
            return float(v)
    return 0.0


def profiled_ms(torch, fn, reps: int, symbol: str, flush=None):
    """Mean profiler device time per launch of the kernel `symbol` over
    `reps` calls (`flush` run before each); None if the trace kept none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if symbol in e.key]
    count = sum(e.count for e in events)
    total_us = sum(_device_us(e) for e in events)
    return total_us / 1e3 / count if count and total_us > 0 else None


def sass_listing(lib_path: str) -> dict:
    """Per kernel and out-of-line device function: its machine code bytes
    (16 per sm_90 instruction) and its most frequent opcodes, from
    cuobjdump's SASS listing; empty where the toolkit has no cuobjdump."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        return {}
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    ops, current = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = m.group(1)
            ops[current] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)", line)
        if current and m:
            ops[current][m.group(2)] += 1
    return {k: {"bytes": 16 * sum(v.values()), "opcodes": v.most_common(8)}
            for k, v in ops.items()}


def phase_timing(ck: Checker, torch, np) -> None:
    from plonky_tpu_torch import _cuda
    from plonky_tpu_torch.curves import TWEEDLEDEE
    from plonky_tpu_torch.curves import msm as cmsm
    from plonky_tpu_torch.curves import ops as cops
    from plonky_tpu_torch.fields import ops as fops
    from plonky_tpu_torch.poly import fft as pfft

    rng = np.random.default_rng(7)
    sf = TWEEDLEDEE.scalar
    dev = torch.device("cuda")
    n1, n2 = 9 << 14, (1 << 14) + 3
    a, b = (rand_field(np, torch, rng, (n1,), dev) for _ in range(2))
    pts = [tuple(rand_field(np, torch, rng, (n,), dev) for _ in range(3))
           for n in (n2, n2, 2, 2)]
    # window sums [8, K, 32] at c = 8, as msm hands them to the Horner
    # (the chain's time does not depend on the values)
    ws = {k: tuple(rand_field(np, torch, rng, (k, 32), dev) for _ in range(3))
          for k in (9, 2)}
    # whole transforms (ntt_pass rows are per launch: a call makes
    # len(pass_plan(lg n)) of them)
    pre17, pre14 = (pfft.FftPrecomputation(sf, 1 << lg) for lg in (17, 14))
    x17 = rand_field(np, torch, rng, (9, 1 << 17), dev)
    x14 = rand_field(np, torch, rng, (1, 1 << 14), dev)
    c1 = rand_field(np, torch, rng, (1,), dev)
    shapes = {label: (scale, named) for label, _site, scale, _l, named
              in product_sum_shapes()}
    sums = [product_sum_inputs(
        shapes[label][1],
        lambda _name, n=shapes[label][0] << 14: rand_field(np, torch, rng, (n,), dev),
        lambda _name: rand_field(np, torch, rng, (1,), dev))[0]
        for label in ("#5 halo_a", "#8 alpha_fold")]
    cases = [
        ("field_mul", [8, n1], lambda: fops.mul(sf, a, b)),
        ("field_mul", [8, 1], lambda: fops.mul(sf, c1, c1)),
        ("field_product_sum", [8, 1 << 14, "#5 halo_a"],
         lambda: fops.product_sum(sf, sums[0])),
        ("field_product_sum", [8, 1 << 17, "#8 alpha_fold"],
         lambda: fops.product_sum(sf, sums[1])),
        ("ntt_pass", [8, 9, 1 << 17, "fft"], lambda: pfft.fft(pre17, x17)),
        ("ntt_pass", [8, 1, 1 << 14, "coset_ifft"],
         lambda: pfft.coset_ifft(pre14, x14, sf.generator)),
        ("curve_add", [8, n2], lambda: cops.add(TWEEDLEDEE, pts[0], pts[1])),
        ("curve_double", [8, n2], lambda: cops.double(TWEEDLEDEE, pts[0])),
        ("curve_add", [8, 2], lambda: cops.add(TWEEDLEDEE, pts[2], pts[3])),
        ("curve_double", [8, 2], lambda: cops.double(TWEEDLEDEE, pts[2])),
        ("curve_horner", [8, 9, 32], lambda: cmsm.horner(TWEEDLEDEE, ws[9], 8)),
        ("curve_horner", [8, 2, 32], lambda: cmsm.horner(TWEEDLEDEE, ws[2], 8)),
        # c = 1 beside c = 8: the chain's time per double and per add
        ("curve_horner", [8, 2, 32, "c=1"],
         lambda: cmsm.horner(TWEEDLEDEE, ws[2], 1)),
    ]
    flush = ck.flush.zero_
    sass = sass_listing(_cuda.build())
    rows = []
    for name, shape, fn in cases:
        symbol = KERNELS[name][2]
        reps = 50
        rows.append({
            "name": name, "shape": shape,
            "events_warm_ms": ck.queued_ms(fn, reps),
            "events_cold_ms": ck.queued_ms(lambda: (flush(), fn()), reps)
            - ck.queued_ms(flush, reps),
            "call_ms": ck.time_ms(fn, reps),
            "profiler_warm_ms": profiled_ms(torch, fn, reps, symbol),
            "profiler_cold_ms": profiled_ms(torch, fn, reps, symbol, flush),
            "sass": {k: v for k, v in sass.items()
                     if symbol.split("<")[0] in k}})
    emit({"phase": "timing", "rows": rows, "sass_all": sass})


def phase_profile(torch) -> None:
    from torch.profiler import ProfilerActivity, profile

    from plonky_tpu_torch.protocol import generate_proof

    circuit, inputs = buffer_circuit(14)
    witness = circuit.generate_witness(inputs)

    def prove():
        generate_proof(circuit, witness, old_proofs=[], blinding=True)

    prove()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prove()
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    ours, other = {}, 0.0
    for evt in prof.key_averages():
        us = _device_us(evt)
        for name, (_src, _rep, symbol) in KERNELS.items():
            if symbol in evt.key:
                ours[name] = ours.get(name, 0.0) + us / 1e6
                break
        else:
            other += us / 1e6
    busy = sum(ours.values()) + other
    emit({"phase": "profile", "wall_s_profiled": wall_s, "kernel_s": ours,
          "other_device_s": other, "device_busy_share": busy / wall_s})

    host = cProfile.Profile()
    host.runcall(prove)
    stats = pstats.Stats(host).stats
    top = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)[:12]
    emit({"phase": "host", "top_own_time": [
        [f"{os.path.basename(f)}:{line}({fn})", calls, tt, ct]
        for (f, line, fn), (_cc, calls, tt, ct, _cl) in top]})


def phase_k1_shapes(torch) -> None:
    """Counts K1's launches of one steady prove: the elementwise ones by
    kernel and batch size N, the product sums by their shape."""
    from plonky_tpu_torch.fields import ops as fops
    from plonky_tpu_torch.protocol import generate_proof

    circuit, inputs = buffer_circuit(14)
    witness = circuit.generate_witness(inputs)
    generate_proof(circuit, witness, old_proofs=[], blinding=True)
    torch.cuda.synchronize()
    counts = collections.Counter()
    launch = fops._launch_binary

    def counted(name, entry, spec, a, b):
        out = launch(name, entry, spec, a, b)
        counts[(name, out[0].numel())] += 1
        return out
    fops._launch_binary = counted
    try:
        with counting_product_sums(fops) as sum_counts:
            generate_proof(circuit, witness, old_proofs=[], blinding=True)
            torch.cuda.synchronize()
    finally:
        fops._launch_binary = launch
    by_kernel = {}
    for (name, n), c in sorted(counts.items()):
        by_kernel.setdefault(name, []).append([n, c])
    emit({"phase": "k1_shapes", "launches_by_n": by_kernel,
          "product_sum_launches": sum(sum_counts.values()),
          "product_sum_by_shape": [{**dict(zip(PS_KEYS, k)), "launches": c}
                                   for k, c in sorted(sum_counts.items())]})


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_prove: CUDA is not available", file=sys.stderr)
        return 2
    name_power, clock_hz, _sms, int_rate = card(torch)
    emit({"phase": "env", "nvidia_smi": name_power})
    ck = Checker(torch, clock_hz, int_rate)
    phase_timing(ck, torch, np)
    phase_profile(torch)
    phase_k1_shapes(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
