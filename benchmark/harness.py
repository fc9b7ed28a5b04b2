"""The benchmark's general harness: finds a cell's configuration, traffic
mix, entry and per-layer readers by the names in BENCHMARK.json, sets the
entry up, runs its closed loop for the window (or, traced, a stretch of
calls under torch.profiler), checks a sample of the answers against the
reference, and assembles the result line.

A cell's entry is `entries/<traffic["entry"]>.py`, whose `Runner(ctx)`
sets the cell up and offers `rates` ({end-to-end rate metric: work a
call}), `inputs(j)` (the j-th inputs from the seed; set-up makes the
traffic's `input_pool` of them, and the calls cycle through it), `call(inputs)`
(one call, complete when it returns: read back or synchronized; its
calls into the program's layers marked by `ctx.span`),
`check(samples, control)` ({number: [value, limit]} over (j, inputs,
answer) samples; with `control`, the reference computed at a lower
precision takes the program's place) and `least(inputs)` (the call's
least (bytes, IMAD slots), costs.py).  A per-layer metric's reader is
`metrics/<name>.py`, or else `metrics/<name up to its first dot>.py`,
whose `read(t)` takes a TraceReading and returns a number, or None where
it finds nothing to read.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "plonky_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def load_module(path: str):
    """A Python file of the benchmark, loaded by its path (entries and
    metric readers carry dots in their names)."""
    name = "benchmark_" + os.path.relpath(path, BENCH_DIR).replace(
        os.sep, "_").replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A workload with its configuration's and traffic mix's files."""
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def name(self) -> str:
        return self.workload["name"]

    def applies(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])


def find_cell(name: str, spec: dict | None = None) -> Cell:
    spec = spec or benchmark_spec()
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])
    config = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic", work["traffic"] + ".json"))
    return Cell(work, config, traffic, spec["end_to_end"], spec["per_layer"])


def entry_module(cell: Cell):
    return load_module(os.path.join(BENCH_DIR, "entries", cell.traffic["entry"] + ".py"))


def metric_reader(name: str):
    """metrics/<name>.py, or the reader its quantity shares:
    metrics/<name up to its first dot>.py (device_idle_pct.msm)."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    if not os.path.exists(path):
        path = os.path.join(BENCH_DIR, "metrics", name.split(".")[0] + ".py")
    return load_module(path)


@dataclass
class Context:
    """What an entry's Runner is given: the cell's files, the device, the
    seed, and `span(name)`, a context manager marking a call into a layer
    (a profiler range in a traced run, nothing otherwise)."""
    config: dict
    traffic: dict
    device: object
    seed: int
    traced: bool = False

    def span(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)


class Reservoir:
    """A uniform sample of k of the calls offered, drawn from a seed."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            i = self.rng.randrange(self.seen)
            if i < self.k:
                self.items[i] = item


def synchronize(device) -> None:
    import torch
    if getattr(device, "type", "cpu") == "cuda":
        torch.cuda.synchronize(device)


def p95(values: list) -> float:
    """The 95th percentile by nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


class InputPool:
    """The traffic's `input_pool` inputs, made at set-up; call i of the run
    (the warm calls first) takes input i mod the pool's size."""

    def __init__(self, runner, size: int):
        self.items = [runner.inputs(j) for j in range(size)]
        self.next = 0

    def take(self):
        inp = self.items[self.next % len(self.items)]
        self.next += 1
        return inp


def timed_window(runner, pool: InputPool, seconds: float, reservoir: Reservoir) -> dict:
    """Calls back to back until `seconds` have passed; every call started
    is finished and counted, and the window ends with the last one."""
    lat = []
    j = 0
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        inp = pool.take()
        t0 = time.perf_counter()
        out = runner.call(inp)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        reservoir.offer((j, inp, out))
        j += 1
        if t1 >= deadline:
            break
    return {"calls": j, "elapsed_s": t1 - start, "latencies_s": lat}


@dataclass
class TraceReading:
    """What a per-layer reader reads: the traced stretch's trace, its
    call count and the least work of its calls (summed)."""
    trace: object
    calls: int
    least_bytes: float
    least_ops: float

    def roofline_pct(self):
        """The calls' least time (costs.least_seconds) over the device time
        of all their kernels, copies and memsets, in %; None where the
        device ran nothing."""
        from . import costs
        device_s = self.trace.device_seconds()
        if device_s <= 0:
            return None
        return 100.0 * costs.least_seconds((self.least_bytes, self.least_ops))[0] / device_s


def traced_stretch(runner, ctx: Context, pool: InputPool, calls: int,
                   reservoir: Reservoir) -> TraceReading:
    """`calls` calls back to back under torch.profiler (host and device),
    on the pool's inputs as the window takes them; the trace read inside
    the "bench.window" span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import devtrace
    inputs = [pool.take() for _ in range(calls)]
    synchronize(ctx.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(devtrace.WINDOW_SPAN):
            for j, inp in enumerate(inputs):
                with record_function("bench.call"):
                    out = runner.call(inp)
                reservoir.offer((j, inp, out))
        synchronize(ctx.device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        trace = devtrace.Trace(path)
    finally:
        os.remove(path)
    work = [runner.least(inp) for inp in inputs]
    del inputs
    return TraceReading(trace, calls, sum(w[0] for w in work), sum(w[1] for w in work))


def card_line() -> str:
    """nvidia-smi's name, power limit and max SM clock of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             started: float | None = None, cell: Cell | None = None,
             control: bool = False, log=None) -> dict:
    """One run of a cell on `device`: set-up, then the timed window (or
    the traced stretch), then the check.  Returns the result line's
    object; `log` takes the lines meant for standard error.  With
    `control`, the check judges the control in the program's place."""
    import torch

    from . import costs
    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    started = time.perf_counter() if started is None else started
    cell = cell or find_cell(name)
    ctx = Context(cell.config, cell.traffic, device, seed, traced=trace)
    # Set-up makes the inputs and warms every shape with the traffic's
    # `warm_calls`, their answers all held at once, as the window's
    # sample holds them, so the allocator has grown before it opens.
    entered = time.perf_counter()
    runner = entry_module(cell).Runner(ctx)
    pool = InputPool(runner, int(cell.traffic["input_pool"]))
    made = time.perf_counter()
    held = [runner.call(pool.take()) for _ in range(int(cell.traffic["warm_calls"]))]
    synchronize(device)
    del held
    setup_s = time.perf_counter() - started
    log(f"set-up {setup_s:.3f} s: to the entry {entered - started:.3f}, the entry's "
        f"set-up and inputs {made - entered:.3f}, the warm calls {started + setup_s - made:.3f}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reservoir = Reservoir(int(cell.traffic["sample_calls"]),
                          random.Random(f"sample:{seed}"))
    metrics, extra, breakdown = {}, {}, None
    if trace:
        reading = traced_stretch(runner, ctx, pool, int(cell.traffic["trace_calls"]),
                                 reservoir)
        attempted = reading.calls
        for m in cell.per_layer:
            if cell.applies(m):
                value = metric_reader(m["name"]).read(reading)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": reading.trace.busy_s, "window_s": reading.trace.window_s}
        breakdown = {"device_ops": reading.trace.device_ops(),
                     "idle_gaps": reading.trace.idle_gaps()}
        least_s, bound_by = costs.least_seconds(
            (reading.least_bytes / reading.calls, reading.least_ops / reading.calls))
        log(f"traced {reading.calls} calls: window {reading.trace.window_s:.6f} s, "
            f"busy {reading.trace.busy_s:.6f} s; least a call {least_s * 1e3:.6f} ms "
            f"(bound by {bound_by}: {reading.least_bytes / reading.calls:.6e} bytes, "
            f"{reading.least_ops / reading.calls:.6e} IMAD slots)")
    else:
        win = timed_window(runner, pool, seconds, reservoir)
        attempted = win["calls"]
        lat_ms = [v * 1e3 for v in win["latencies_s"]]
        values = {"setup_s": setup_s, "call_p95_ms": p95(lat_ms)}
        values.update({k: w * win["calls"] / win["elapsed_s"]
                       for k, w in runner.rates.items()})
        for m in cell.end_to_end:
            if cell.applies(m):
                # A quantity split by cells (call_p95_ms.msm) takes its
                # base name's value.
                base = m["name"].split(".")[0]
                if base not in values:
                    raise KeyError(f"{cell.name}: nothing computes {m['name']}")
                metrics[m["name"]] = {"value": values[base], "unit": m["unit"]}
        log(f"window {win['elapsed_s']:.6f} s, {win['calls']} calls; call ms median "
            f"{statistics.median(lat_ms):.6f}, p95 {values['call_p95_ms']:.6f}, "
            f"max {max(lat_ms):.6f}")
    synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    samples = reservoir.items
    del reservoir, pool
    runner.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = runner.check(sorted(samples, key=lambda s: s[0]), control)
    log(f"check: {len(samples)} sampled calls in {time.perf_counter() - t_check:.3f} s")
    correct = bool(samples) and all(v <= lim for v, lim in checks.values())
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                         "kind": kind, "count": int(cell.workload.get("chips", 1)),
                         "memory_peak_bytes": int(peak), **extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result
