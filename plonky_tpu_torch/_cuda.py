"""Build, load and launch the hand-written CUDA kernels.

The kernels live in ``csrc/*.cu`` with a plain C interface.  At first use
on a CUDA tensor each source is compiled by its own ``nvcc`` process (all
started together; the curve and MSM sources one process a kernel) for
``sm_90a``, the objects are linked into one shared
library under ``_build/``, and the library is loaded with ctypes.  Every
source is compiled twice: for 8-limb fields, and with ``-DPT_LIMBS=12``
for 12-limb ones, whose C entries and launch counts carry the suffix
``_l12`` (`kernel`).  Every C entry
launches one kernel on the stream it is given and returns
``cudaGetLastError()``; `launch` raises when that is not 0 and counts the
launch under the kernel's name and its card.  A launch runs on the card
that holds its tensors, on that card's current stream, with the card made
current for the call (a `__constant__` such as csrc/curve.cuh's `c_curve`
is one copy a card, set on that stream); tensors on two cards raise.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import os
import shutil
import subprocess
import time

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("field_kernels.cu", "curve_kernels.cu", "ntt_kernels.cu",
           "msm_kernels.cu", "rescue_kernels.cu")
KERNELS = ("field_add", "field_sub", "field_mul", "field_product_sum",
           "field_exp", "curve_add", "curve_double", "curve_horner", "ntt_pass",
           "ntt_twiddle_transpose", "msm_bucket_accumulate",
           "msm_bucket_accumulate_signed", "msm_bucket_reduce",
           "rescue_permutation")
# Every source is built a second time for 12-limb fields (-DPT_LIMBS=12).
WIDE_LIMBS = 12
# Sources built one object a kernel (their kernel count): one object of
# either at 12 limbs took nvcc 35-41 s on the H100's machine, the whole
# build's long pole (csrc/field.cuh:PT_ONLY).
SPLIT_SOURCES = {"curve_kernels.cu": 3, "msm_kernels.cu": 3}
HEADERS = ("field.cuh", "curve.cuh")
LIB_NAME = "libplonky_kernels.so"
ARCH = "arch=compute_90a,code=sm_90a"


def width_name(name: str, limbs: int) -> str:
    """A kernel's name at a field width: `name` at 8 limbs, `name_l12` at
    12 (its launch count and, with "pt_" before it, its C entry)."""
    return name if limbs == 8 else f"{name}_l{limbs}"


# Launches per kernel and width, counted by the wrappers (reset with
# reset_launches).
LAUNCHES = {width_name(k, limbs): 0 for limbs in (8, WIDE_LIMBS) for k in KERNELS}

# Launches per card index, counted with LAUNCHES (reset with reset_launches).
DEVICE_LAUNCHES = collections.Counter()

# Seconds the last build took (None: the library was up to date), and
# each object's nvcc seconds in it (the objects compile in parallel).
BUILD_SECONDS = [None]
OBJECT_SECONDS = {}
BUILD_LOG = os.path.join(BUILD_DIR, "build.log")

_LIB = [None]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int

# C entry points and their argument types (pointers and the stream are
# c_void_p: ctypes would pass a plain int as 32 bits and cut it).
_SIGNATURES = {
    "pt_field_add": [_P, _P, _I32, _P, _I32, _I64, _P, _P],
    "pt_field_sub": [_P, _P, _I32, _P, _I32, _I64, _P, _P],
    "pt_field_mul": [_P, _P, _I32, _P, _I32, _I64, _P, _P],
    "pt_field_product_sum": [_P, _P, _P, _P, _P, _I32, _I32, _I64, _P, _P],
    "pt_field_exp": [_P, _P, _I64, _P, _P],
    "pt_curve_add": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P, _P],
    "pt_curve_double": [_P, _P, _P, _P, _P, _P, _I64, _P, _P],
    "pt_curve_horner": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I32, _P, _P],
    "pt_ntt_pass": [_P, _P, _P, _P, _P, _I32, _I64, _I32, _I32, _I32, _I32,
                    _P, _P],
    "pt_ntt_twiddle_transpose": [_P, _P, _P, _I64, _I64, _I64, _P, _P],
    "pt_msm_bucket_accumulate": [_P, _P, _P, _P, _P, _P,
                                 _I64, _I64, _I64, _I64, _I64, _P, _P],
    "pt_msm_bucket_accumulate_signed": [_P, _P, _P, _P, _P, _P,
                                        _I64, _I64, _I64, _I64, _I64, _P, _P],
    "pt_msm_bucket_reduce": [_P, _P, _P, _P, _P, _P,
                             _I64, _I64, _I64, _I64, _I64, _P, _P],
    "pt_rescue_permutation": [_P, _P, _I64, _P, _I32, _P],
}
_SIGNATURES.update({"pt_" + width_name(k, WIDE_LIMBS): _SIGNATURES["pt_" + k]
                    for k in KERNELS})


def kernel(name: str, limbs: int) -> tuple:
    """(launch count name, C entry) of kernel `name` at a field width
    (every kernel has a build at 8 and at 12 limbs); raises at another
    width."""
    if limbs not in (8, WIDE_LIMBS) or name not in KERNELS:
        raise NotImplementedError(f"{name} has no {limbs}-limb build")
    wide = width_name(name, limbs)
    return wide, "pt_" + wide


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _stale(lib_path: str) -> bool:
    if not os.path.exists(lib_path):
        return True
    built = os.path.getmtime(lib_path)
    return any(os.path.getmtime(os.path.join(CSRC, f)) > built
               for f in SOURCES + HEADERS)


def objects():
    """(label, source, extra nvcc flags) of every object of the library:
    each source at 8 limbs, then again at 12 (label `*_l12`); a
    source of SPLIT_SOURCES gives one object a kernel (-DPT_ONLY=k, label
    `*_k`), so that its kernels compile in parallel."""
    objs = []
    for suffix, flags in (("", []),
                          (f"_l{WIDE_LIMBS}", [f"-DPT_LIMBS={WIDE_LIMBS}"])):
        for src in SOURCES:
            label = src.replace(".cu", suffix)
            parts = SPLIT_SOURCES.get(src)
            if parts is None:
                objs.append((label, src, flags))
            else:
                objs += [(f"{label}_{k}", src, flags + [f"-DPT_ONLY={k}"])
                         for k in range(1, parts + 1)]
    return objs


def build() -> str:
    """Compile every object in parallel and link the shared library (only
    when a source is newer than it).  Returns the library path."""
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    if not _stale(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    common = [nvcc, "-gencode", ARCH, "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

    def compile_object(label, src, flags):
        obj = os.path.join(BUILD_DIR, label + ".o")
        t = time.perf_counter()
        proc = subprocess.run(
            common + flags + ["-c", os.path.join(CSRC, src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return label, obj, proc, time.perf_counter() - t
    objs = objects()
    with concurrent.futures.ThreadPoolExecutor(len(objs)) as pool:
        done = list(pool.map(lambda o: compile_object(*o), objs))
    log = []
    failed = []
    OBJECT_SECONDS.clear()
    for label, _obj, proc, seconds in done:
        OBJECT_SECONDS[label] = seconds
        log.append(f"== {label} (rc={proc.returncode}, {seconds:.1f} s)\n{proc.stdout}")
        if proc.returncode != 0:
            failed.append(label)
    if not failed:
        tmp = lib_path + f".tmp{os.getpid()}"
        link = subprocess.run(
            [nvcc, "-gencode", ARCH, "-shared", "-o", tmp]
            + [obj for _l, obj, _p, _s in done],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc={link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
        else:
            os.replace(tmp, lib_path)
    with open(BUILD_LOG, "w") as f:
        f.write("\n".join(log))
    if failed:
        raise RuntimeError(f"kernel build failed ({', '.join(failed)}):\n"
                           + "\n".join(log))
    BUILD_SECONDS[0] = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    if _LIB[0] is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB[0] = lib
    return _LIB[0]


def device_of(name: str, tensors) -> torch.device:
    """The one device of the tensors a launch reads or writes (None entries
    skipped); raises where they lie on more than one."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name}: one launch takes tensors on one device, "
                         f"got {sorted(map(str, devices))}")
    return devices.pop()


def launch(name: str, entry: str, tensors, *args) -> None:
    """Call one C entry, which launches one kernel on the stream passed
    after `args`: the current stream of the card that holds `tensors`
    (every tensor the kernel reads or writes), with that card current for
    the call (switched to and back only where another card is current).
    Raises on tensors on two cards or a CUDA error; counts the launch under
    the kernel's name and its card's index."""
    dev = device_of(name, tensors)
    fn = getattr(library(), entry)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch on {dev}")
    LAUNCHES[name] += 1
    DEVICE_LAUNCHES[dev.index] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    DEVICE_LAUNCHES.clear()


def host_array(values, dtype) -> np.ndarray:
    """A C-contiguous host buffer for an argument that the C entry copies
    into the kernel's parameters (kept alive by the caller for the call)."""
    return np.ascontiguousarray(np.asarray(values, dtype=dtype))


def check(name: str, t: torch.Tensor, rows: int | None = None) -> None:
    """The checks every wrapper makes on a tensor it hands to a kernel."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: expected int32 limbs, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if rows is not None and t.shape[0] != rows:
        raise ValueError(f"{name}: expected {rows} limb rows, got "
                         f"{tuple(t.shape)}")
