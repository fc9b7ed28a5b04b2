"""Each entry makes the same inputs from the same seed, other inputs for
another call or seed, and every element canonical."""

import pytest
import torch

from benchmark import harness
from benchmark.reference import field as rfield

CELLS = [w["name"] for w in harness.benchmark_spec()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_inputs_from_the_seed(tiny, name):
    cell = tiny(name)
    cpu = torch.device("cpu")

    def runner(seed):
        return harness.entry_module(cell).Runner(
            harness.Context(cell.config, cell.traffic, cpu, seed))
    d1, d2, other = runner(2**31 + 11), runner(2**31 + 11), runner(2**31 + 12)
    x = d1.inputs(3)
    assert torch.equal(x, d2.inputs(3))
    assert not torch.equal(x, d1.inputs(4))
    assert not torch.equal(x, other.inputs(3))
    p = int((cell.config.get("scalar_field") if "wire" in name else cell.config["curve"])
            ["p" if "wire" in name else "r"], 0)
    assert bool(rfield.below(x, p).all())


def test_random_field_top_limb():
    from benchmark import inputs
    r = 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001
    x = inputs.random_field((4096,), 8, r, 99, "cpu")
    assert bool(rfield.below(x, r).all())
    top = x[7].to(torch.int64) & 0xFFFFFFFF
    assert int(top.max()) < r >> 224 and int(top.max()) > (r >> 224) // 2
