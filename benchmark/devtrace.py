"""Reading a torch.profiler trace (its Chrome trace export): the device's
activity inside the benchmark's window span, the idle gaps between it and
what the host was doing in each, and torch's own kernels told from the
rest by torch's namespaces (frozen here, so that nothing the program
names or renames moves the split)."""

from __future__ import annotations

import bisect
import collections
import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.window"
HOST_SCAN = 400          # host events looked back at to name a gap
# The namespaces of torch's own CUDA kernels (ATen's, and the CUB and
# Thrust that it builds in): a kernel whose name holds one is torch's.
TORCH_KERNEL = re.compile(r"(^|[^\w:])(at::native|at::cuda|at_cuda_detail|cub|thrust|c10)::")


def torch_kernel(name: str) -> bool:
    return TORCH_KERNEL.search(name) is not None


class Trace:
    """The events of one exported trace, cut to the window span."""

    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("name") == WINDOW_SPAN and e.get("cat") == "user_annotation"]
        if not spans:
            raise ValueError(f"no {WINDOW_SPAN} span in the trace")
        w = spans[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.window_tid = (w.get("pid"), w.get("tid"))
        self.device = []
        self.host = []
        self.spans = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, dur = float(e["ts"]), float(e["dur"])
            lo, hi = max(ts, self.t0), min(ts + dur, self.t1)
            if hi <= lo and dur > 0:
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.device.append((lo, hi, cat, e.get("name", "")))
            elif cat in HOST_CATS and (e.get("pid"), e.get("tid")) == self.window_tid:
                (self.spans if cat == "user_annotation" else self.host).append(
                    (ts, ts + dur, e.get("name", "")))
        self.device.sort()
        self.host.sort()
        self._host_starts = [h[0] for h in self.host]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device's activity, as merged (start, end) µs."""
        merged = []
        for lo, hi, _cat, _name in self.device:
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals()) / 1e6

    def device_seconds(self) -> float:
        """Summed durations of the device's activity."""
        return sum(hi - lo for lo, hi, _cat, _n in self.device) / 1e6

    def torch_kernel_seconds(self) -> float:
        """Summed seconds of torch's own kernels."""
        return sum(hi - lo for lo, hi, cat, name in self.device
                   if cat == "kernel" and torch_kernel(name)) / 1e6

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        by = collections.Counter()
        for lo, hi, _cat, name in self.device:
            by[name] += (hi - lo) / 1e6
        return [[k, v] for k, v in by.most_common(top)]

    def gaps(self) -> list:
        """(start, end) µs of the window's idle stretches."""
        out, cur = [], self.t0
        for lo, hi in self.busy_intervals():
            if lo > cur:
                out.append((cur, lo))
            cur = max(cur, hi)
        if self.t1 > cur:
            out.append((cur, self.t1))
        return out

    def host_activity(self, t: float) -> str:
        """What the window's host thread was doing at t: the innermost
        benchmark span and the innermost operation or runtime call under
        it, as "span/op"."""
        span = min(((te - ts, name) for ts, te, name in self.spans
                    if ts <= t <= te), default=(0, WINDOW_SPAN))[1]
        i = bisect.bisect_right(self._host_starts, t)
        op = min(((te - ts, name) for ts, te, name in self.host[max(0, i - HOST_SCAN):i]
                  if t <= te), default=(0, ""))[1]
        return f"{span}/{op}" if op else span

    def idle_gaps(self, top: int = 10) -> list:
        """[what the host was doing, idle seconds] summed by that name, the
        largest first."""
        by = collections.Counter()
        for lo, hi in self.gaps():
            by[self.host_activity((lo + hi) / 2)] += (hi - lo) / 1e6
        return [[k, v] for k, v in by.most_common(top)]
