#!/usr/bin/env python3
"""Sweep the build of the 12-limb product-sum kernel
(field_product_sum_l12, plonky_tpu_torch/csrc/field_kernels.cu) on one
NVIDIA GPU.

    python3 ps_sweep.py

For each (accumulate, operand loads, threads a block, blocks an SM) of
BUILDS, copies csrc/ into plonky_tpu_torch/_build/sweep_ps/<build>/ and
rewrites there: the line that sets the kernel's threads a block
(K1_SUM_THREADS, 128 or 256); its __launch_bounds__, given a minimum of
5 or 6 blocks an SM (a cap of 102 or 85 registers) where the build asks;
for a "rows" build, the reduction on the pair layout (cc_sum_mod_pairs)
becomes the 8-limb kernel's, on the rows of cc_mac_row (cc_sum_mod); for
a "merged" build, the term's lazy pair accumulate
(cc_pairs_product into e, o and the counters) becomes the pair product of
the term alone, merged at once and added to e on one chain (MERGED); for
a "plain" build, the loop that loads the next term's operands while the
current one is accumulated becomes a loop that loads each term's operands
at its start (PLAIN_LOOP).  Each copy's field_kernels.cu is built at 12
limbs, one nvcc each, eight at a time.  Then for each build it runs
the `bls12_377_poly` path's product sums over BLS12-377's base field
(chip_smoke.poly_product_sums: one sum of 2, 9, 30 or 33 terms at
[12, 2^20]) through `fops.product_sums` itself, with the build's
pt_field_product_sum_l12 in place of the package's, and the 9-, 30- and
33-term sums cut to 32 at N = 2^10 + 3 and 2^14 with 1, 2 and 4 threads an
element forced (`fops._product_sums_launch`; `fops._splits` picks 4 at
both); holds each output equal to the package's, and times it: device ms,
queued behind a sleep, L2 warm (chip_smoke.Checker).  Prints the card's
nvidia-smi line, one JSON line per build (ptxas's registers and spills)
and per (build, shape), and last the builds in order of the summed ms of
the four 2^20 sums.  Exits 1 if any output differs.
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
# (accumulate, operand loads, threads a block, blocks an SM, reduction):
# every accumulate and loads at 128 and 256 threads with no register cap
# (128 threads: 4 blocks an SM at 128 registers), then caps of 102 and 85
# registers (5 and 6 blocks of 128), all with the pair-layout reduction;
# then the package's build and the best of those with the reduction on
# the rows of cc_mac_row (cc_sum_mod)
BUILDS = tuple((acc, loads, threads, 1, "pairs") for acc in ("lazy", "merged")
               for loads in ("ahead", "plain") for threads in (128, 256)) + tuple(
    (acc, loads, 128, blocks, "pairs") for acc in ("lazy", "merged")
    for loads in ("ahead", "plain") for blocks in (5, 6)) + (
    ("lazy", "ahead", 128, 1, "rows"), ("merged", "plain", 128, 5, "rows"))
SPLIT_SIZES = ((1 << 10) + 3, 1 << 14)
SPLIT_TERMS = ("9 terms", "30 terms", "33 terms")

THREADS_LINE = r"^#define K1_SUM_THREADS \d+$"
BOUNDS = "__launch_bounds__(K1_SUM_THREADS)"
PAIRS_REDUCE = "  cc_sum_mod_pairs(r, s, c);"
ROWS_REDUCE = "  cc_sum_mod(r, s, c);"
LAZY = "        cc_pairs_product(e, o, cnt, a, b);\n"
MERGED = """        {
          uint32_t pe[PT_PRODUCT_LIMBS], po[PT_PRODUCT_LIMBS], w[PT_PRODUCT_LIMBS];
          cc_product(pe, po, a, b);
          cc_merge(w, pe, po);
          e[0] = cc_add(e[0], w[0]);
#pragma unroll
          for (int k = 1; k < PT_ACC_LIMBS; k++) e[k] = cc_addc(e[k], w[k]);
          cnt[PT_LIMBS] = cc_addc_end(cnt[PT_LIMBS], 0u);
        }
"""
AHEAD_LOOP = """    uint32_t x[PT_LIMBS], y[PT_LIMBS];   // term t's operands, loaded ahead
    fe_set_small(y, 0);
    if (t < end) ps_load(x, y, tab.term[t], n, i);
#pragma unroll 1
    for (; t < end; t += splits) {
      const bool single = tab.term[t].b == nullptr;
      const bool neg = tab.term[t].flags & PS_NEG;
      uint32_t a[PT_LIMBS], b[PT_LIMBS];
      fe_copy(a, x);
      fe_copy(b, y);
      if (t + splits < end) ps_load(x, y, tab.term[t + splits], n, i);
"""
PLAIN_LOOP = """#pragma unroll 1
    for (; t < end; t += splits) {
      const bool single = tab.term[t].b == nullptr;
      const bool neg = tab.term[t].flags & PS_NEG;
      uint32_t a[PT_LIMBS], b[PT_LIMBS];
      ps_load(a, b, tab.term[t], n, i);
"""


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "sweep_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _replace(path: str, old: str, new: str, regex: bool = False) -> None:
    with open(path) as f:
        text = f.read()
    count = len(re.findall(old, text, re.M)) if regex else text.count(old)
    if count != 1:
        raise RuntimeError(f"{path}: {count} matches of {old!r}")
    text = re.sub(old, new, text, flags=re.M) if regex else text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)


def build_all(cuda) -> dict:
    """(accumulate, loads, threads, blocks, reduction) -> (library path,
    ptxas lines), built in parallel from rewritten copies of csrc/."""
    def one(build):
        acc, loads, threads, blocks, reduce = build
        out = os.path.join(cuda.BUILD_DIR, "sweep_ps", "_".join(map(str, build)))
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(cuda.CSRC, out)
        src = os.path.join(out, "field_kernels.cu")
        _replace(src, THREADS_LINE, f"#define K1_SUM_THREADS {threads}", regex=True)
        if blocks > 1:
            _replace(src, BOUNDS, f"__launch_bounds__(K1_SUM_THREADS, {blocks})")
        if acc == "merged":
            _replace(src, LAZY, MERGED)
        if loads == "plain":
            _replace(src, AHEAD_LOOP, PLAIN_LOOP)
        if reduce == "rows":
            _replace(src, PAIRS_REDUCE, ROWS_REDUCE)
        lib = os.path.join(out, "field_l12.so")
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
            if "field_product_sum" in entry and re.search(r"registers|spill|stack", ln):
                lines.append(ln.strip())
        return build, (lib, lines)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return dict(pool.map(one, BUILDS))


class _Overlay:
    """The package's kernel library with one C entry taken from another."""

    def __init__(self, base, entry: str, fn):
        self._base, self._entry, self._fn = base, entry, fn

    def __getattr__(self, name):
        return self._fn if name == self._entry else getattr(self._base, name)


@contextlib.contextmanager
def variant(cuda, fn):
    """The package's launches through `fn` as pt_field_product_sum_l12."""
    lib = cuda.library()
    cuda._LIB[0] = _Overlay(lib, "pt_field_product_sum_l12", fn)
    try:
        yield
    finally:
        cuda._LIB[0] = lib


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ps_sweep: CUDA is not available", file=sys.stderr)
        return 2
    smoke = _smoke()
    from plonky_tpu_torch import _cuda
    from plonky_tpu_torch.fields import BLS12_377_BASE as Fq
    from plonky_tpu_torch.fields import ops as fops

    name_power, clock_hz, _sms, int_rate = smoke.card(torch)
    print(name_power, flush=True)
    _cuda.library()
    builds = build_all(_cuda)
    ck = smoke.Checker(torch, clock_hz, int_rate)
    dev = torch.device("cuda")
    rng = np.random.default_rng(1717)
    named = smoke.poly_product_sums()

    def inputs(label, n):
        return smoke.product_sum_inputs(
            named[label],
            lambda _name: smoke.with_edges(fops, Fq, smoke.rand_field(
                np, torch, rng, (n,), dev, Fq)),
            lambda _name: smoke.rand_field(np, torch, rng, (1,), dev, Fq))
    cases = []     # (label, call); each output held against the package's
    n20 = 1 << smoke.POLY_PS_LG
    for label in named:
        sums = inputs(label, n20)
        cases.append((f"{label} [12, 2^{smoke.POLY_PS_LG}]",
                      lambda sums=sums: fops.product_sums(Fq, sums)))
    for n in SPLIT_SIZES:
        for label in SPLIT_TERMS:
            cut = [s[:32] for s in inputs(label, n)]
            for splits in (1, 2, 4):
                cases.append((f"{label} cut to 32, N = {n}, splits {splits}",
                              lambda cut=cut, n=n, splits=splits:
                              fops._product_sums_launch(Fq, cut, (n,), splits)))
    want = {label: call() for label, call in cases}
    smoke.emit({"phase": "ps_sweep_package", "nvidia_smi": name_power,
                "ms": {label: ck.queued_ms(call, 10) for label, call in cases}})
    equal, totals = True, {}
    for (acc, loads, threads, blocks, reduce), (lib_path, lines) in builds.items():
        fn = getattr(ctypes.CDLL(lib_path), "pt_field_product_sum_l12")
        fn.argtypes = _cuda._SIGNATURES["pt_field_product_sum_l12"]
        fn.restype = ctypes.c_int
        build = {"accumulate": acc, "loads": loads, "threads": threads,
                 "min_blocks": blocks, "reduce": reduce}
        smoke.emit({"phase": "ps_sweep_build", **build, "ptxas": lines})
        row = {"phase": "ps_sweep", **build, "ms": {}}
        with variant(_cuda, fn):
            for label, call in cases:
                same = all(map(torch.equal, call(), want[label]))
                equal &= same
                if not same:
                    row.setdefault("differs", []).append(label)
                row["ms"][label] = ck.queued_ms(call, 10)
        row["sum_2e20_ms"] = sum(row["ms"][label] for label, _c in cases[:len(named)])
        totals[(acc, loads, threads, blocks, reduce)] = row["sum_2e20_ms"]
        smoke.emit(row)
    order = sorted(totals, key=totals.get)
    smoke.emit({"phase": "ps_sweep_order", "nvidia_smi": name_power,
                "outputs_equal": equal,
                "best": [{"accumulate": a, "loads": ld, "threads": t, "min_blocks": b,
                          "reduce": rd, "sum_2e20_ms": totals[(a, ld, t, b, rd)]}
                         for a, ld, t, b, rd in order]})
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
