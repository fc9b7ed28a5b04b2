#!/usr/bin/env python3
"""Sweep the build of K1's elementwise kernel (field_binary_kernel:
field_add, field_sub, field_mul; plonky_tpu_torch/csrc/field_kernels.cu)
on one NVIDIA GPU.

    python3 k1_sweep.py

For each build of BUILDS (elements a thread, threads a block, loads)
copies csrc/ into plonky_tpu_torch/_build/sweep_k1/<build>/ and rewrites
there the line that sets the threads a block (K1_THREADS); for "ldg"
the strided loads (through the read-only path, __ldg), for "strided" the
launcher's choice (every launch through the strided overload), for
"div32" the two-level index's division (in 32 bits); and, for 2 or 4
elements a thread, the kernel and its launcher with MULTI's: a thread's
elements consecutive, each operand's limb row loaded and the output's
stored as one 8- or 16-byte vector where every operand's layout allows it
(inner stride 0, or 1 with its rows on such boundaries: the VEC
instance), else the elements a block's width apart with 4-byte loads.
Each copy's field_kernels.cu is built at 8 and at 12 limbs (one nvcc
each, all at once).  Then for each build it runs `fops.add`, `sub` and
`mul` with the build's C entries in place of the package's at the steady
2^14 prove's sizes and layouts (SHAPES; profile_prove.py k1_shapes counts
them), holds each output equal to the package's, and times it: device ms
a call, queued behind a sleep, L2 warm and flushed (chip_smoke.Checker).
Prints the card's nvidia-smi line, one JSON line per build (ptxas's
registers and spills of field_binary_kernel and its rows), and last the
builds in order of the summed flushed ms over SHAPES weighted by their
launches a prove.  Exits 1 if any output differs.
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
# (elements a thread, threads a block, loads: "plain", or "ldg" through
# the read-only path, __ldg); the package's build is (1, 128, "plain")
BUILDS = ((1, 64, "plain"), (1, 128, "plain"), (1, 256, "plain"), (1, 128, "ldg"),
          (1, 128, "strided"), (1, 128, "div32"), (2, 128, "ldg"), (4, 128, "ldg"))
THREADS_LINE = r"^#define K1_THREADS \d+$"
PLAIN_LOAD = "  fe_load(r, o.base, o.limb, off);\n"
LDG_LOAD = """#pragma unroll
  for (int k = 0; k < PT_LIMBS; k++) r[k] = (uint32_t)__ldg(o.base + off + k * o.limb);
"""
# "strided": every launch through the strided field_binary_kernel,
# contiguous operands too; "div32": the two-level index's division in 32 bits
PICK = "contiguous_operand(args.a, n) && contiguous_operand(args.b, n)"
DIV64 = "    const int64_t q = i / o.inner_n;\n"
DIV32 = "    const int64_t q = (int64_t)((uint32_t)i / (uint32_t)o.inner_n);\n"
KERNEL_START = "// out [L, n] (contiguous) = a OP b, one element a thread, where every"
KERNEL_END = "// The term table of one product-sum launch"
LAUNCH = """  const unsigned int blocks = (unsigned int)((n + K1_THREADS - 1) / K1_THREADS);
  if (contiguous_operand(args.a, n) && contiguous_operand(args.b, n))
    field_binary_kernel<OP><<<blocks, K1_THREADS, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, args.a.base, args.a.inner == 0, args.b.base, args.b.inner == 0, n, c);
  else
    field_binary_kernel<OP><<<blocks, K1_THREADS, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, args, n, c);
"""
# The kernel at K1_ELEMS elements a thread, and its launch (which picks the
# VEC instance where both operands allow it).
MULTI = """#define K1_ELEMS {elems}
struct BinaryWords {{
  uint32_t w[K1_ELEMS];
}};
using BinaryVector = typename std::conditional<
    K1_ELEMS == 4, uint4, typename std::conditional<K1_ELEMS == 2, uint2, uint32_t>::type>::type;

__device__ __forceinline__ int64_t operand_offset(const BinaryOperand& o, int64_t i,
                                                  int64_t n) {{
  if (o.inner_n >= n) return i * o.inner;
  const int64_t q = i / o.inner_n;
  return q * o.outer + (i - q * o.inner_n) * o.inner;
}}

__device__ __forceinline__ void load_run(uint32_t r[K1_ELEMS][PT_LIMBS],
                                         const BinaryOperand& o, int64_t e, int64_t n) {{
  const int32_t* p = o.base + operand_offset(o, e, n);
  if (o.inner == 0) {{
#pragma unroll
    for (int k = 0; k < PT_LIMBS; k++) {{
      const uint32_t v = (uint32_t)__ldg(p + k * o.limb);
#pragma unroll
      for (int j = 0; j < K1_ELEMS; j++) r[j][k] = v;
    }}
  }} else {{
#pragma unroll
    for (int k = 0; k < PT_LIMBS; k++) {{
      const BinaryVector v = __ldg(reinterpret_cast<const BinaryVector*>(p + k * o.limb));
      const BinaryWords words = *reinterpret_cast<const BinaryWords*>(&v);
#pragma unroll
      for (int j = 0; j < K1_ELEMS; j++) r[j][k] = words.w[j];
    }}
  }}
}}

template <int OP>
__device__ __forceinline__ void binary_op(uint32_t x[PT_LIMBS], const uint32_t y[PT_LIMBS],
                                          const MulConsts& c) {{
  uint32_t r[PT_LIMBS];
  if (OP == 0) cc_add_mod(r, x, y, c.f);
  else if (OP == 1) cc_sub_mod(r, x, y, c.f);
  else cc_mul_mod(r, x, y, c);
  fe_copy(x, r);
}}

template <int OP, bool VEC>
__global__ void field_binary_kernel(int32_t* out, const BinaryArgs args, int64_t n,
                                    const MulConsts c) {{
  const int64_t first = (int64_t)blockIdx.x * blockDim.x * K1_ELEMS;
  uint32_t x[K1_ELEMS][PT_LIMBS], y[K1_ELEMS][PT_LIMBS];
  if (VEC) {{
    const int64_t e = first + (int64_t)threadIdx.x * K1_ELEMS;
    if (e >= n) return;
    load_run(x, args.a, e, n);
    load_run(y, args.b, e, n);
#pragma unroll
    for (int j = 0; j < K1_ELEMS; j++) binary_op<OP>(x[j], y[j], c);
#pragma unroll
    for (int k = 0; k < PT_LIMBS; k++) {{
      BinaryWords words;
#pragma unroll
      for (int j = 0; j < K1_ELEMS; j++) words.w[j] = x[j][k];
      *reinterpret_cast<BinaryVector*>(out + k * n + e) =
          *reinterpret_cast<const BinaryVector*>(&words);
    }}
  }} else {{
#pragma unroll
    for (int j = 0; j < K1_ELEMS; j++) {{
      const int64_t e = first + (int64_t)j * blockDim.x + threadIdx.x;
      if (e < n) {{
        load_strided(x[j], args.a, n, e);
        load_strided(y[j], args.b, n, e);
      }}
    }}
#pragma unroll
    for (int j = 0; j < K1_ELEMS; j++) {{
      const int64_t e = first + (int64_t)j * blockDim.x + threadIdx.x;
      if (e < n) {{
        binary_op<OP>(x[j], y[j], c);
        fe_store(out, n, e, x[j]);
      }}
    }}
  }}
}}

static bool vector_operand(const BinaryOperand& o, int64_t n) {{
  if (o.inner_n % K1_ELEMS) return false;
  return o.inner == 0 || (o.inner == 1 && (uintptr_t)o.base % sizeof(BinaryVector) == 0 &&
                          o.limb % K1_ELEMS == 0 &&
                          (o.inner_n >= n || o.outer % K1_ELEMS == 0));
}}

"""
MULTI_LAUNCH = """  const bool vec = n % K1_ELEMS == 0 && vector_operand(args.a, n) &&
                   vector_operand(args.b, n);
  const int64_t runs = (n + K1_ELEMS - 1) / K1_ELEMS;
  const int threads = runs < K1_THREADS ? (int)runs : K1_THREADS;
  const unsigned int blocks = (unsigned int)((runs + threads - 1) / threads);
  auto kernel = vec ? field_binary_kernel<OP, true> : field_binary_kernel<OP, false>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>((int32_t*)out, args, n, c);
"""
KERNELS = ("field_add", "field_sub", "field_mul")
# (label, limbs, kernels, launches a steady 2^14 prove of each kernel, a
# builder of the operands from a [L, 9, N + 3] tensor w, a column and
# N): the prove's most frequent elementwise shapes (profile_prove.py
# k1_shapes) and the kernels table's 9 2^14
SHAPES = (
    ("contiguous 2^17", 8, {"field_add": 63, "field_mul": 96},
     lambda w, col, n: (w[:, 0, :n].contiguous(), w[:, 1, :n].contiguous())),
    ("strided x strided 2^17", 8, {"field_mul": 13, "field_sub": 9},
     lambda w, col, n: (w[:, 2, :n], w[:, 5, :n])),
    ("strided x column 2^17", 8, {"field_sub": 30},
     lambda w, col, n: (w[:, 3, :n], col)),
    ("column x strided 2^17", 8, {"field_mul": 35, "field_sub": 21},
     lambda w, col, n: (col, w[:, 4, :n])),
    ("contiguous x strided 2^17", 8, {"field_mul": 46, "field_sub": 25},
     lambda w, col, n: (w[:, 6, :n].contiguous(), w[:, 7, :n])),
    ("offset 2^17 (scalar)", 8, {"field_add": 0},
     lambda w, col, n: (w.reshape(w.shape[0], -1)[:, 1:1 + n],
                        w.reshape(w.shape[0], -1)[:, 3:3 + n])),
    ("contiguous 2^14", 8, {"field_mul": 82},
     lambda w, col, n: (w[:, 0, :n >> 3].contiguous(), w[:, 1, :n >> 3].contiguous())),
    ("strided halves 2^13", 8, {"field_add": 28},
     lambda w, col, n: (w[:, 0, :n >> 4], w[:, 0, n >> 4:n >> 3])),
    ("strided halves 2^6", 8, {"field_add": 28},
     lambda w, col, n: (w[:, 0, :64], w[:, 0, 64:128])),
    ("columns 1", 8, {"field_mul": 94, "field_add": 28},
     lambda w, col, n: (col, col)),
    ("contiguous 9 2^14", 8, {"field_add": 0},
     lambda w, col, n: (w[:, 0, :9 << 14].contiguous(), w[:, 1, :9 << 14].contiguous())),
    ("contiguous 9 2^14 + 1", 8, {"field_add": 0},
     lambda w, col, n: (w[:, 0, :(9 << 14) + 1].contiguous(),
                        w[:, 1, :(9 << 14) + 1].contiguous())),
    ("contiguous 2^16, 12 limbs", 12, {"field_add": 1, "field_sub": 1, "field_mul": 1},
     lambda w, col, n: (w[:, 0, :n >> 1].contiguous(), w[:, 1, :n >> 1].contiguous())),
)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "sweep_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rewrite(src: str, elems: int, threads: int, loads: str) -> None:
    with open(src) as f:
        text = f.read()
    if (len(re.findall(THREADS_LINE, text, re.M)) != 1
            or any(text.count(x) != 1 for x in (LAUNCH, PLAIN_LOAD, PICK, DIV64))):
        raise RuntimeError(f"{src}: no single K1_THREADS line, launch or load")
    text = re.sub(THREADS_LINE, f"#define K1_THREADS {threads}", text, flags=re.M)
    if loads == "ldg":
        text = text.replace(PLAIN_LOAD, LDG_LOAD)
    elif loads == "strided":
        text = text.replace(PICK, "false")
    elif loads == "div32":
        text = text.replace(DIV64, DIV32)
    if elems > 1:
        start, end = text.index(KERNEL_START), text.index(KERNEL_END)
        text = (text[:start] + MULTI.format(elems=elems) + text[end:]).replace(
            LAUNCH, MULTI_LAUNCH)
        text = text.replace('#include "field.cuh"', '#include <type_traits>\n\n'
                            '#include "field.cuh"')
    with open(src, "w") as f:
        f.write(text)


def build_all(cuda) -> dict:
    """(elems, threads, loads) -> {limbs: (library path, ptxas lines)},
    built in parallel from rewritten copies of csrc/."""
    def one(job):
        build, limbs = job
        out = os.path.join(cuda.BUILD_DIR, "sweep_k1", "_".join(map(str, build)))
        src = os.path.join(out, "field_kernels.cu")
        lib = os.path.join(out, f"field_l{limbs}.so")
        proc = subprocess.run(
            [cuda.nvcc_path(), "-gencode", cuda.ARCH, "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", "-shared", f"-DPT_LIMBS={limbs}", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {build}, {limbs} limbs:\n"
                               f"{proc.stdout}")
        lines, entry = [], ""
        for ln in proc.stdout.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                entry = m.group(1)
            if "field_binary_kernel" in entry and re.search(r"registers|spill", ln):
                lines.append(f"{entry}: {ln.strip()}")
        return job, (lib, lines)
    for build in BUILDS:
        out = os.path.join(cuda.BUILD_DIR, "sweep_k1", "_".join(map(str, build)))
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(cuda.CSRC, out)
        _rewrite(os.path.join(out, "field_kernels.cu"), *build)
    jobs = [(b, limbs) for b in BUILDS for limbs in (8, cuda.WIDE_LIMBS)]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        done = dict(pool.map(one, jobs))
    return {b: {limbs: done[(b, limbs)] for limbs in (8, cuda.WIDE_LIMBS)} for b in BUILDS}


class _Overlay:
    """The package's kernel library with some C entries taken from another."""

    def __init__(self, base, entries: dict):
        self._base, self._entries = base, entries

    def __getattr__(self, name):
        return self._entries[name] if name in self._entries else getattr(self._base, name)


@contextlib.contextmanager
def variant(cuda, libs: dict):
    """The package's elementwise launches through a build's entries."""
    entries = {}
    for limbs, path in libs.items():
        lib = ctypes.CDLL(path)
        for k in KERNELS:
            name = "pt_" + cuda.width_name(k, limbs)
            fn = getattr(lib, name)
            fn.argtypes = cuda._SIGNATURES[name]
            fn.restype = ctypes.c_int
            entries[name] = fn
    base = cuda.library()
    cuda._LIB[0] = _Overlay(base, entries)
    try:
        yield
    finally:
        cuda._LIB[0] = base


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k1_sweep: CUDA is not available", file=sys.stderr)
        return 2
    smoke = _smoke()
    from plonky_tpu_torch import _cuda
    from plonky_tpu_torch.curves import TWEEDLEDEE
    from plonky_tpu_torch.fields import BLS12_377_BASE
    from plonky_tpu_torch.fields import ops as fops

    name_power, clock_hz, _sms, int_rate = smoke.card(torch)
    print(name_power, flush=True)
    _cuda.library()
    builds = build_all(_cuda)
    ck = smoke.Checker(torch, clock_hz, int_rate)
    flush = ck.flush.zero_
    dev = torch.device("cuda")
    rng = np.random.default_rng(1818)
    n = 1 << 17
    fields = {8: TWEEDLEDEE.scalar, 12: BLS12_377_BASE}
    data = {limbs: (smoke.rand_field(np, torch, rng, (9, (9 << 14) + 3), dev, spec),
                    smoke.rand_field(np, torch, rng, (1,), dev, spec))
            for limbs, spec in fields.items()}
    fns = {"field_add": fops.add, "field_sub": fops.sub, "field_mul": fops.mul}
    cases = []          # (label, kernel, launches a prove, call)
    for label, limbs, launches, make in SHAPES:
        a, b = make(*data[limbs], n)
        for k in KERNELS:
            cases.append((label, k, launches.get(k, 0),
                          lambda fn=fns[k], spec=fields[limbs], a=a, b=b: fn(spec, a, b)))
    want = {(label, k): call() for label, k, _l, call in cases}
    equal, totals = True, {}
    for (elems, threads, loads), libs in builds.items():
        smoke.emit({"phase": "k1_sweep_build", "elems": elems, "threads": threads,
                    "loads": loads,
                    "ptxas": {limbs: lines for limbs, (_p, lines) in libs.items()}})
        row = {"phase": "k1_sweep", "elems": elems, "threads": threads, "loads": loads,
               "keys": ["shape", "kernel", "launches", "ms", "cold_ms", "equal"],
               "rows": []}
        weighted = 0.0
        with variant(_cuda, {limbs: p for limbs, (p, _l) in libs.items()}):
            for label, k, launches, call in cases:
                same = torch.equal(call(), want[(label, k)])
                equal &= same
                ms = ck.queued_ms(call, 30)
                cold = (ck.queued_ms(lambda call=call: (flush(), call()), 30)
                        - ck.queued_ms(flush, 30))
                row["rows"].append([label, k, launches, ms, cold, same])
                weighted += launches * cold
        row["prove_weighted_cold_ms"] = weighted
        totals[(elems, threads, loads)] = weighted
        smoke.emit(row)
    order = sorted(totals, key=totals.get)
    smoke.emit({"phase": "k1_sweep_order", "nvidia_smi": name_power,
                "outputs_equal": equal,
                "best": [{"elems": e, "threads": t, "loads": ld,
                          "prove_weighted_cold_ms": totals[(e, t, ld)]}
                         for e, t, ld in order]})
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
