#!/usr/bin/env python3
"""Times K4, the MSM bucket kernels, of one or more plonky_tpu_torch trees
on one NVIDIA GPU, at every shape of chip_smoke.k4_cases, and proves the
pinned 2^14 circuit with each tree.

    python3 k4_compare.py [ROOT ...]

Each ROOT (default: this checkout) is a directory holding a
plonky_tpu_torch package, for instance an earlier commit unpacked with
`git archive`.  The trees run one after the other, each in a process of
its own, in the order given: give them in turns (A B B A) to compare two
on one card.  Per tree it prints the card's nvidia-smi line, then one JSON
line: per shape, the device time per launch of each K4 kernel (CUDA events
over launches queued behind a sleep, L2 warm and flushed, as chip_smoke.py
takes them), a whole `msm` call, and the sha256 of the MSM's affine
result (equal across trees when the MSM's value did not change); then
chip_smoke.py's pinned prove line, whose proof_sha256 must also agree.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


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


def run_tree(root: str) -> int:
    sys.path.insert(0, os.path.abspath(root))
    import hashlib

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
        x, y, zero = cops.to_affine(TWEEDLEDEE, cmsm.msm(TWEEDLEDEE, sub, scal, c))
        affine = torch.cat([x, y, zero[None].to(torch.int32)]).cpu().numpy()
        row = {"shape": label, "K": scal.shape[1], "N": scal.shape[2],
               "msm_affine_sha256": hashlib.sha256(affine.tobytes()).hexdigest()}
        for name, fn in (("accumulate", acc), ("reduce", red)):
            warm = ck.queued_ms(fn, 10)
            row[f"{name}_ms"] = warm
            row[f"{name}_cold_ms"] = (ck.queued_ms(lambda fn=fn: (flush(), fn()), 10)
                                      - ck.queued_ms(flush, 10))
        row["msm_call_ms"] = ck.time_ms(
            lambda sub=sub, scal=scal: cmsm.msm(TWEEDLEDEE, sub, scal, c), 3)
        rows_out.append(row)
    smoke.emit({"phase": "k4_compare", "root": root, "nvidia_smi": name_power,
                "shapes": rows_out})
    smoke.phase_prove(torch)
    return 0


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        return run_tree(argv[1])
    rc = 0
    for root in argv or [HERE]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                              root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
