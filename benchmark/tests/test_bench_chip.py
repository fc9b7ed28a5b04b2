"""On the card (-m chip): each cell run end to end through run.py for a
short window, correct, with the contract's keys; the control in the
program's place refused at the cell's own size; and every kernel of a
traced run either torch's or one of the program's own."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import devtrace, harness

from test_bench_trace import unclassified

CELLS = [w["name"] for w in harness.benchmark_spec()["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(card, name):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name,
                          "--seed", str(2**31 + 17), "--seconds", "2", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900,
                         env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_refused_on_the_card(card, name):
    r = harness.run_cell(name, 2**31 + 23, 2.0, False, card, control=True,
                         log=lambda s: None)
    assert not r["correct"]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_traced_kernels_classified(card, monkeypatch, name):
    seen = set()
    init = devtrace.Trace.__init__

    def recording(self, path):
        init(self, path)
        seen.update(n for _lo, _hi, cat, n in self.device if cat == "kernel")
    monkeypatch.setattr(devtrace.Trace, "__init__", recording)
    r = harness.run_cell(name, 2**31 + 29, 0.0, True, card, log=lambda s: None)
    assert r["correct"] and seen
    assert unclassified(seen) == []
