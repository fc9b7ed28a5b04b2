"""Phase timing (the reference's only observability is `log`-crate phase
lines, e.g. witness-generation wall time at plonk.rs:581).

Enable with PLONKY_TRACE=1 (stderr phase lines), or collect durations with
`record_phases()`.  A phase that is timed synchronizes the card at its end,
so its seconds include the kernels it queued.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch

_TRACE = os.environ.get("PLONKY_TRACE", "") not in ("", "0")
_depth = [0]

# When non-None, phase() accumulates {name: total_seconds} here.
_RECORDER = [None]


@contextlib.contextmanager
def record_phases():
    """Collect phase durations into the yielded dict for this block.
    Durations accumulate by name (a phase entered twice sums)."""
    acc = {}
    prev = _RECORDER[0]
    _RECORDER[0] = acc
    try:
        yield acc
    finally:
        _RECORDER[0] = prev


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def phase(name: str):
    """Time a named phase.  Nesting is indented; no-op unless PLONKY_TRACE
    is set or a record_phases() block is active."""
    if not _TRACE and _RECORDER[0] is None:
        yield
        return
    _sync()
    t0 = time.perf_counter()
    _depth[0] += 1
    try:
        yield
    finally:
        _sync()
        _depth[0] -= 1
        dt = time.perf_counter() - t0
        if _RECORDER[0] is not None:
            _RECORDER[0][name] = _RECORDER[0].get(name, 0.0) + dt
        if _TRACE:
            indent = "  " * _depth[0]
            print(f"[plonky {indent}{name}] {dt:.3f}s",
                  file=sys.stderr, flush=True)
