#!/usr/bin/env python3
"""Sweep the block shape of the 12-limb NTT kernel (ntt_pass_l12,
plonky_tpu_torch/csrc/ntt_kernels.cu) on one NVIDIA GPU.

    python3 ntt_sweep.py

For each (threads a block, blocks an SM, REDC wait) of BUILDS, copies
csrc/ into plonky_tpu_torch/_build/sweep/<build>/ and rewrites there the
lines that set the kernel's __launch_bounds__ (NTT_L12_THREADS,
NTT_L12_MIN_BLOCKS; the second caps its registers) and its limits
(NTT_L12_MAX_LAYERS, NTT_L12_BLOCK_ELEMS, raised to the largest shape of
SHAPES), and, for a build with wait 0, the line of field.cuh that makes
the 12-limb REDC's row 0 wait for the product.  Each copy's
ntt_kernels.cu is built at 12 limbs, one nvcc each, all started together.
Then for each build and each (layers a pass, elements a block) of SHAPES
it runs the `bls12_377_poly` path's transforms over BLS12-377's base
field (TRANSFORMS: fft and ifft at [1, 2^22] and [9, 2^20], the coset pair
at [1, 2^20]) through `pfft.ntt` itself, with the build's pt_ntt_pass_l12
in place of the package's and the shape in place of poly/fft.py's
NTT_L12_* (so the plan and groups are pfft.pass_plan's and
pfft.block_groups'), holds each output equal to the package's, and times
it: device ms of the whole transform, queued behind a sleep, L2 warm
(chip_smoke.Checker).  Prints the card's nvidia-smi line, one JSON line
per build (ptxas's registers and spills) and per (build, shape), and last
the shapes in order of the summed ms of the six transforms.  Exits 1 if
any output differs.
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
# (threads a block, blocks an SM, REDC wait): register caps 255 (64 x 4,
# 128 x 2, 256 x 1), 168, 128, 102, 85
BUILDS = tuple((t, b, 1) for t, b in ((64, 4), (128, 2), (256, 1), (128, 3), (384, 1),
                                      (256, 2), (512, 1), (128, 5), (256, 3))) + (
    (64, 4, 0), (128, 2, 0), (128, 5, 0), (256, 2, 0))
# (layers a pass at most, elements a block at most); at 2^22 points 5 layers
# make 5 passes, 6 and 7 four, 8 and 10 three, 11 two
SHAPES = ((5, 256), (5, 512), (5, 1024), (6, 512), (6, 1024), (7, 1024),
          (7, 2048), (8, 1024), (8, 2048), (8, 4096), (10, 2048), (11, 2048))
# (label, B, lg n, inverse, coset)
TRANSFORMS = (("fft [1, 2^22]", 1, 22, False, False),
              ("ifft [1, 2^22]", 1, 22, True, False),
              ("fft [9, 2^20]", 9, 20, False, False),
              ("ifft [9, 2^20]", 9, 20, True, False),
              ("coset_fft [1, 2^20]", 1, 20, False, True),
              ("coset_ifft [1, 2^20]", 1, 20, True, True))
# field.cuh: the condition of the REDC's row-0 wait, and the same without
# the 12-limb dense rows
REDC_WAIT = ("if constexpr (SPARSE || PT_LIMBS == 12) {", "if constexpr (SPARSE) {")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "sweep_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
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
    """(threads, blocks, wait) -> (library path, ptxas lines), built in
    parallel from rewritten copies of csrc/."""
    max_layers = max(ml for ml, _ in SHAPES)
    max_elems = max(e for _, e in SHAPES)

    def one(build):
        threads, blocks, wait = build
        out = os.path.join(cuda.BUILD_DIR, "sweep", f"{threads}_{blocks}_{wait}")
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(cuda.CSRC, out)
        src = os.path.join(out, "ntt_kernels.cu")
        for name, value in (("MAX_LAYERS", max_layers), ("BLOCK_ELEMS", max_elems),
                            ("THREADS", threads), ("MIN_BLOCKS", blocks)):
            _rewrite(src, rf"^#define NTT_L12_{name} \d+$", f"#define NTT_L12_{name} {value}")
        if not wait:
            _rewrite(os.path.join(out, "field.cuh"), re.escape(REDC_WAIT[0]), REDC_WAIT[1])
        lib = os.path.join(out, "ntt_l12.so")
        proc = subprocess.run(
            [cuda.nvcc_path(), "-gencode", cuda.ARCH, "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", "-shared", f"-DPT_LIMBS={cuda.WIDE_LIMBS}",
             "-o", lib, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {build}:\n{proc.stdout}")
        lines, entry = [], ""
        for ln in proc.stdout.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                entry = m.group(1)
            if "ntt_pass" in entry and re.search(r"registers|spill|stack", ln):
                lines.append(ln.strip())
        return build, (lib, lines)
    with concurrent.futures.ThreadPoolExecutor(len(BUILDS)) as pool:
        return dict(pool.map(one, BUILDS))


class _Overlay:
    """The package's kernel library with one C entry taken from another."""

    def __init__(self, base, entry: str, fn):
        self._base, self._entry, self._fn = base, entry, fn

    def __getattr__(self, name):
        return self._fn if name == self._entry else getattr(self._base, name)


@contextlib.contextmanager
def variant(cuda, pfft, fn, max_layers: int, elems: int):
    """pfft.ntt through `fn` as pt_ntt_pass_l12 with the shape's limits."""
    lib, shape = cuda.library(), (pfft.NTT_L12_MAX_LAYERS, pfft.NTT_L12_BLOCK_ELEMS)
    cuda._LIB[0] = _Overlay(lib, "pt_ntt_pass_l12", fn)
    pfft.NTT_L12_MAX_LAYERS, pfft.NTT_L12_BLOCK_ELEMS = max_layers, elems
    try:
        yield
    finally:
        cuda._LIB[0] = lib
        pfft.NTT_L12_MAX_LAYERS, pfft.NTT_L12_BLOCK_ELEMS = shape


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ntt_sweep: CUDA is not available", file=sys.stderr)
        return 2
    smoke = _smoke()
    from plonky_tpu_torch import _cuda
    from plonky_tpu_torch.fields import BLS12_377_BASE as Fq
    from plonky_tpu_torch.fields import ops as fops
    from plonky_tpu_torch.poly import fft as pfft

    name_power, clock_hz, _sms, int_rate = smoke.card(torch)
    print(name_power, flush=True)
    _cuda.library()
    builds = build_all(_cuda)
    ck = smoke.Checker(torch, clock_hz, int_rate)
    dev = torch.device("cuda")
    rng = np.random.default_rng(1515)
    cases = []
    for label, batch, lg, inverse, coset in TRANSFORMS:
        pre = pfft.FftPrecomputation(Fq, 1 << lg)
        x = smoke.with_edges(fops, Fq, smoke.rand_field(np, torch, rng, (batch, 1 << lg),
                                                        dev, Fq))
        shift = Fq.generator if coset else None

        def call(pre=pre, x=x, inverse=inverse, shift=shift):
            return pfft.ntt(pre, x, inverse, shift)
        cases.append((label, call, call(), ck.queued_ms(call, 5)))
    smoke.emit({"phase": "ntt_sweep_package", "nvidia_smi": name_power,
                "shape": list(pfft.ntt_shape(Fq.limbs)),
                "ms": {label: ms for label, _c, _w, ms in cases}})
    equal, totals = True, {}
    for (threads, blocks, wait), (lib_path, lines) in builds.items():
        fn = getattr(ctypes.CDLL(lib_path), "pt_ntt_pass_l12")
        fn.argtypes = _cuda._SIGNATURES["pt_ntt_pass_l12"]
        fn.restype = ctypes.c_int
        build = {"threads": threads, "min_blocks": blocks, "redc_wait": wait}
        smoke.emit({"phase": "ntt_sweep_build", **build, "ptxas": lines})
        for max_layers, elems in SHAPES:
            row = {"phase": "ntt_sweep", **build, "max_layers": max_layers,
                   "block_elems": elems, "ms": {}}
            try:
                with variant(_cuda, pfft, fn, max_layers, elems):
                    for label, call, want, _ms in cases:
                        same = torch.equal(call(), want)
                        equal &= same
                        if not same:
                            row.setdefault("differs", []).append(label)
                        row["ms"][label] = ck.queued_ms(call, 5)
            except RuntimeError as err:
                row["error"] = str(err)
            if "error" not in row:
                row["sum_ms"] = sum(row["ms"].values())
                totals[(threads, blocks, wait, max_layers, elems)] = row["sum_ms"]
            smoke.emit(row)
    order = sorted(totals, key=totals.get)
    smoke.emit({"phase": "ntt_sweep_order", "nvidia_smi": name_power,
                "outputs_equal": equal,
                "best": [{"threads": t, "min_blocks": b, "redc_wait": w, "max_layers": ml,
                          "block_elems": e, "sum_ms": totals[(t, b, w, ml, e)]}
                         for t, b, w, ml, e in order[:12]]})
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
