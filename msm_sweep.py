#!/usr/bin/env python3
"""Sweep the build of the 8-limb bucket accumulation (msm_bucket_accumulate
and msm_bucket_accumulate_signed, plonky_tpu_torch/csrc/msm_kernels.cu) on
one NVIDIA GPU.

    python3 msm_sweep.py

For each build of BUILDS (blocks an SM, the trees' add, the loop's add,
the formulas' additions), copies csrc/ into
plonky_tpu_torch/_build/sweep_msm/<build>/ and rewrites there the line
that sets MSM_MIN_BLOCKS (the __launch_bounds__ minimum of blocks an SM,
which caps the registers: 255 at 1 and 2, 168 at 3, 128 at 4), and where
the build says so the trees' inlined add to the out-of-line one
(mpt_add_call), the loop's inlined add to the out-of-line one, and
curve.cuh's carry-chain additions (pt_fadd, pt_fsub, pt_mul_small) to
field.cuh's fe_add / fe_sub (64-bit adds and a branch).  Each copy's
msm_kernels.cu is built at 8 limbs, one nvcc each, all started together.
Then for each build it runs CASES, each through `cmsm.bucket_accumulate`
itself with the build's two C entries in place of the package's: the
probe's signed windows at 2^18 points (c = 8 and 12) and the main path's
unsigned shapes K = 9 and K = 2 at 2^14, random scalars, on a doubling
chain's points over Tweedledee; holds each output equal to the package's and times it:
device ms of a launch, queued behind a sleep, L2 warm (chip_smoke.Checker).
Prints the card's nvidia-smi line, one JSON line per build (ptxas's
registers and spills of both entries, its ms) and last the builds in
order of the signed 2^18 c = 8 time plus the unsigned K = 9 time.  Exits 1
if any output differs.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import importlib.util
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# (blocks an SM, trees call the out-of-line add, the loop calls it, the
# formulas' additions on carry chains); the package's build is (2, 0, 0, 1)
BUILDS = tuple((b, 1, 0, 0) for b in (1, 2, 3, 4)) + ((3, 0, 0, 0), (3, 1, 1, 0),
                                                      (2, 0, 0, 0)) + tuple(
    (b, t, 0, 1) for t in (1, 0) for b in (1, 2, 3, 4))
# (label, K, log2 N, c, signed)
CASES = (("signed 2^18 c=8", 1, 18, 8, True), ("signed 2^18 c=12", 1, 18, 12, True),
         ("unsigned K=9", 9, 14, 8, False), ("unsigned K=2", 2, 14, 8, False))
ENTRIES = ("pt_msm_bucket_accumulate", "pt_msm_bucket_accumulate_signed")
TREE_ADD = ("      mpt_add(a, a, b, c_curve);", "      mpt_add_call(a, a, b);")
LOOP_ADD = ("        mpt_add(acc, acc, pt, c_curve);", "        mpt_add_call(acc, acc, pt);")
FE_ADDS = (("  cc_add_mod(r, a, b, c);", "  fe_add(r, a, b, c);"),
           ("  cc_sub_mod(r, a, b, c);", "  fe_sub(r, a, b, c);"),
           ("    cc_add_mod(x, x, x, c);", "    fe_add(x, x, x, c);"),
           ("cc_add_mod(x, x, a, c);", "fe_add(x, x, a, c);"))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "msm_sweep_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rewrite(path: str, old: str, new: str) -> None:
    with open(path) as f:
        text = f.read()
    count = len(re.findall(old, text, re.M))
    if count != 1:
        raise RuntimeError(f"{path}: {count} lines match {old!r}")
    with open(path, "w") as f:
        f.write(re.sub(old, new, text, flags=re.M))


def build_all(cuda) -> dict:
    """build -> (library path, ptxas lines of the two entries), built in
    parallel from rewritten copies of csrc/."""
    def one(build):
        blocks, tree_call, loop_call, chain = build
        out = os.path.join(cuda.BUILD_DIR, "sweep_msm", "_".join(map(str, build)))
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(cuda.CSRC, out)
        src = os.path.join(out, "msm_kernels.cu")
        _rewrite(src, r"^#define MSM_MIN_BLOCKS \d+ ", f"#define MSM_MIN_BLOCKS {blocks} ")
        if tree_call:
            _rewrite(src, re.escape(TREE_ADD[0]), TREE_ADD[1])
        if loop_call:
            _rewrite(src, re.escape(LOOP_ADD[0]), LOOP_ADD[1])
        if not chain:
            for old, new in FE_ADDS:
                _rewrite(os.path.join(out, "curve.cuh"), re.escape(old), new)
        lib = os.path.join(out, "msm_l8.so")
        proc = subprocess.run(
            [cuda.nvcc_path(), "-gencode", cuda.ARCH, "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", "-shared", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {build}:\n{proc.stdout}")
        lines, entry = [], ""
        for ln in proc.stdout.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                entry = m.group(1)
            if "accumulate" in entry and re.search(r"registers|spill|stack", ln):
                lines.append(ln.strip())
        return build, (lib, lines)
    with concurrent.futures.ThreadPoolExecutor(len(BUILDS)) as pool:
        return dict(pool.map(one, BUILDS))


class _Overlay:
    """The package's kernel library with some C entries taken from another."""

    def __init__(self, base, fns: dict):
        self._base, self._fns = base, fns

    def __getattr__(self, name):
        return self._fns[name] if name in self._fns else getattr(self._base, name)


@contextlib.contextmanager
def variant(cuda, fns: dict):
    lib = cuda.library()
    cuda._LIB[0] = _Overlay(lib, fns)
    try:
        yield
    finally:
        cuda._LIB[0] = lib


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("msm_sweep: CUDA is not available", file=sys.stderr)
        return 2
    smoke = _smoke()
    from plonky_tpu_torch import _cuda
    from plonky_tpu_torch.curves import TWEEDLEDEE as C
    from plonky_tpu_torch.curves import msm as cmsm

    name_power, clock_hz, _sms, int_rate = smoke.card(torch)
    print(name_power, flush=True)
    _cuda.library()
    builds = build_all(_cuda)
    ck = smoke.Checker(torch, clock_hz, int_rate)
    dev = torch.device("cuda")
    rng = np.random.default_rng(1616)
    n = 1 << 18
    _chain, chain_dev = smoke.doubling_chain(C, int(rng.integers(2, 1 << 62)), dev)
    basis = cmsm.precompute_base(C, tuple(t.repeat(1, n // smoke.BLS_CHAIN)
                                          for t in chain_dev))
    cases = []
    for label, k, lg, c, signed in CASES:
        scal = smoke.rand_field(np, torch, rng, (k, 1 << lg), dev)
        sub = basis.slice(0, 1 << lg)
        digits, order, starts, signs, _w = cmsm.window_rows(C, scal, c, signed)

        def call(sub=sub, digits=digits, order=order, starts=starts, signs=signs):
            return cmsm.bucket_accumulate(C, sub, digits, order, starts, signs)
        cases.append((label, call, call(), ck.queued_ms(call, 10)))
    smoke.emit({"phase": "msm_sweep_package", "nvidia_smi": name_power,
                "ms": {label: ms for label, _c, _w, ms in cases}})
    equal, totals = True, {}
    for build, (lib_path, lines) in builds.items():
        lib = ctypes.CDLL(lib_path)
        fns = {}
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = _cuda._SIGNATURES[entry]
            fn.restype = ctypes.c_int
            fns[entry] = fn
        row = {"phase": "msm_sweep", "min_blocks": build[0], "tree_call": build[1],
               "loop_call": build[2], "chain_adds": build[3], "ptxas": lines, "ms": {}}
        with variant(_cuda, fns):
            for label, call, want, _ms in cases:
                same = all(torch.equal(g, w) for g, w in zip(call(), want))
                equal &= same
                if not same:
                    row.setdefault("differs", []).append(label)
                row["ms"][label] = ck.queued_ms(call, 10)
        totals[build] = row["ms"]["signed 2^18 c=8"] + row["ms"]["unsigned K=9"]
        smoke.emit(row)
    smoke.emit({"phase": "msm_sweep_order", "nvidia_smi": name_power,
                "outputs_equal": equal,
                "best": [{"build": list(b), "signed_c8_plus_k9_ms": totals[b]}
                         for b in sorted(totals, key=totals.get)]})
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
