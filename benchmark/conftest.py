"""pytest settings of the benchmark's own tests (benchmark/tests; the
repository's tier-1 run does not collect them):

    python -m pytest benchmark/tests -q              # here, on the CPU
    python -m pytest benchmark/tests -q -m chip      # on the card

A test marked `chip` needs a CUDA card; the `card` fixture skips it
where there is none (decided when the test runs, not at import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (runs on the H100)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: run with -m chip on the H100")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny():
    """A cell cut to CPU size: the configuration's degree or points and
    the traffic's sample, pool and warm calls shrunk, every other value
    as committed (the window's first call takes another input than the
    first warm call)."""
    from benchmark import harness

    def make(name: str, sample: int = 1, **config):
        cell = harness.find_cell(name)
        sizes = {"degree_log2": 4, "wires": 2} if "degree_log2" in cell.config \
            else {"log_points": 4, "window_bits": 4, "chunk_log": 3}
        cell.config = dict(cell.config, **{**sizes, **config})
        cell.traffic = dict(cell.traffic, sample_calls=sample, trace_calls=2,
                            input_pool=3, warm_calls=1)
        return cell
    return make
