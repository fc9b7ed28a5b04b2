"""The trace reader on a trace written by hand, the per-layer readers on
it, and a traced run on the CPU (where nothing runs on a device, every
reader finds nothing and says so)."""

import json
import os
import re

import pytest
import torch

from benchmark import costs, devtrace, harness


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


@pytest.fixture
def trace(tmp_path):
    events = [
        ev("user_annotation", "bench.window", 100.0, 1000.0),
        ev("user_annotation", "protocol.commit_many", 100.0, 600.0),
        ev("cpu_op", "aten::sort", 120.0, 30.0),
        ev("cuda_runtime", "cudaMemcpyAsync", 500.0, 200.0),
        ev("kernel", "msm_bucket_accumulate_kernel(unsigned int*)", 150.0, 300.0, tid=7),
        ev("kernel", "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<long>()", 400.0,
           100.0, tid=7),
        ev("gpu_memcpy", "Memcpy DtoH", 690.0, 10.0, tid=7),
        ev("kernel", "pt_l12::curve_horner_kernel(int*)", 1050.0, 100.0, tid=7),
        ev("gpu_user_annotation", "protocol.commit_many", 100.0, 600.0, tid=7),
        ev("kernel", "outside_kernel", 5000.0, 10.0, tid=7),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return devtrace.Trace(str(path))


def test_window_busy_and_gaps(trace):
    assert trace.window_s == pytest.approx(1e-3)
    assert trace.busy_s == pytest.approx((350 + 10 + 50) * 1e-6)
    assert trace.gaps() == [(100.0, 150.0), (500.0, 690.0), (700.0, 1050.0)]
    gaps = dict(trace.idle_gaps())
    assert gaps["protocol.commit_many/cudaMemcpyAsync"] == pytest.approx(190e-6)
    assert gaps["protocol.commit_many/aten::sort"] == pytest.approx(50e-6)
    assert gaps["bench.window"] == pytest.approx(350e-6)
    ops = dict(trace.device_ops())
    assert ops["msm_bucket_accumulate_kernel(unsigned int*)"] == pytest.approx(300e-6)


def test_torch_kernels_told_by_namespace(trace):
    assert trace.torch_kernel_seconds() == pytest.approx(100e-6)
    assert devtrace.torch_kernel("void at::native::vectorized_gather_kernel<16, long>(char*)")
    assert devtrace.torch_kernel("void cub::DeviceScanKernel<int>()")
    assert not devtrace.torch_kernel("pt_l12::msm_bucket_accumulate_kernel(unsigned int*)")
    assert not devtrace.torch_kernel("mycub::kernel(int*)")


def program_kernels() -> set:
    """The names of every __global__ function in the program's CUDA
    sources (what a kernel that is not torch's has to be)."""
    names = set()
    csrc = os.path.join(harness.ROOT, "plonky_tpu_torch", "csrc")
    for root, _dirs, files in os.walk(csrc):
        for f in files:
            if f.endswith((".cu", ".cuh", ".h")):
                with open(os.path.join(root, f)) as fh:
                    text = fh.read()
                for m in re.finditer(r"__global__([^;{]*)", text):
                    called = [n for n in re.findall(r"(\w+)\s*\(", m.group(1))
                              if not n.startswith("__")]
                    names.update(called[:1])
    return names


def unclassified(names) -> list:
    """Kernel names that are neither torch's (devtrace.TORCH_KERNEL) nor
    a __global__ function of the program's sources."""
    ours = program_kernels()
    return [n for n in names if not devtrace.torch_kernel(n)
            and not any(re.search(r"\b" + k + r"\b", n) for k in ours)]


# Every kernel the three cells' traced runs on the H100 named.
TRACED_KERNELS = [
    "curve_horner_kernel(int*, int*, int*, int const*, int const*, int const*, long, long, int)",
    "msm_bucket_accumulate_kernel(unsigned int*, unsigned int*, unsigned int const*, "
    "int const*, int const*, int const*, long, long, long, long)",
    "msm_bucket_reduce_kernel(int*, int*, int*, unsigned int const*, unsigned int const*, "
    "int const*, long, long, long, long, int, int)",
    "ntt_pass_kernel(int*, int const*, int const*, int const*, int const*, int, long, int, "
    "int, int, int, FieldConsts)",
    "pt_l12::curve_horner_kernel(int*, int*, int*, int const*, int const*, int const*, long, "
    "long, int)",
    "pt_l12::msm_bucket_accumulate_kernel(unsigned int*, unsigned int*, unsigned int const*, "
    "int const*, int const*, int const*, long, long, long, long)",
    "void at::native::(anonymous namespace)::sort_postprocess_kernel<long>(long const*, "
    "long*, long*, int2 const*, int, int)",
    "void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*, int, long, "
    "long, long, long, bool)",
    "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_detail::cub::"
    "DeviceRadixSortPolicy<long, at_cuda_detail::cub::NullType, unsigned long long>>()",
    "void at_cuda_detail::cub::DeviceSegmentedRadixSortKernel<at_cuda_detail::cub::"
    "DeviceRadixSortPolicy<long, long, int>::Policy900, true, false, long, long>()",
]


def test_every_traced_kernel_is_torchs_or_the_programs():
    assert unclassified(TRACED_KERNELS) == []
    assert unclassified(["triton_poi_fused_add_0", "renamed_kernel(int*)"]) == [
        "triton_poi_fused_add_0", "renamed_kernel(int*)"]


def test_readers(trace):
    r = harness.TraceReading(trace, 2, 1e6, 3.35e9)
    assert harness.metric_reader("device_idle_pct.msm").read(r) == pytest.approx(
        100 * (1 - 410 / 1000))
    assert harness.metric_reader("device_idle_pct.ntt").read(r) == pytest.approx(
        100 * (1 - 410 / 1000))
    assert harness.metric_reader("msm_torch_ms").read(r) == pytest.approx(0.05)
    least = 3.35e9 / costs.IMAD_SLOTS_PER_S
    for name in ("msm_roofline.l8", "msm_roofline.l12", "ntt_roofline"):
        assert harness.metric_reader(name).read(r) == pytest.approx(100 * least / 460e-6)
    empty = harness.TraceReading(trace, 2, 0, 0)
    empty.trace.device = []
    for name in ("device_idle_pct.msm", "msm_torch_ms", "msm_roofline.l8", "ntt_roofline"):
        assert harness.metric_reader(name).read(empty) is None


def test_traced_run_on_the_cpu(tiny):
    cell = tiny("tweedledee17.wire_ldes", sample=2)
    r = harness.run_cell(cell.name, 2**31 + 3, 0.0, True, torch.device("cpu"), cell=cell,
                         log=lambda s: None)
    assert r["correct"] and r["attempted"] == 2 and r["metrics"] == {}
    assert r["device"]["busy_s"] == 0 and r["device"]["window_s"] > 0
    assert r["breakdown"]["device_ops"] == [] and r["breakdown"]["idle_gaps"]
    assert list(r)[-1] == "checks"
