"""The check at a size a test run holds, on the CPU (the program's plain
paths): sound runs come out correct, the control in the program's place
does not."""

import pytest
import torch

from benchmark import harness

CELLS = [w["name"] for w in harness.benchmark_spec()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_correct_and_control_refused(tiny, name):
    cell = tiny(name)
    cpu = torch.device("cpu")
    good = harness.run_cell(name, 2**31 + 5, 0.05, False, cpu, cell=cell, log=lambda s: None)
    assert good["correct"] and all(c["value"] == 0 for c in good["checks"].values())
    bad = harness.run_cell(name, 2**31 + 6, 0.05, False, cpu, cell=cell, control=True,
                           log=lambda s: None)
    assert not bad["correct"]
    assert any(c["value"] > c["limit"] for c in bad["checks"].values())
