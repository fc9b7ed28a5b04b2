"""The rest of a run on the CPU, past the look for a card, with the timed
path broken underneath: each fault a cell can have makes `correct` false.
The faults: an answer altered where it is produced; half of the batch
left out and the rest scaled up in its place; a call that hands back its
first answer unchanged (no state moves on).  One card, so no exchange
between cards can be left out."""

import pytest
import torch

from benchmark import harness
from plonky_tpu_torch.curves import msm as cmsm
from plonky_tpu_torch.curves import ops as cops
from plonky_tpu_torch.poly import fft


def doubled_first(curve, pt):
    """The point batch with its first point doubled."""
    two = cops.add(curve, pt, pt)
    out = tuple(t.clone() for t in pt)
    for o, t in zip(out, two):
        o.reshape(o.shape[0], -1)[:, 0] = t.reshape(t.shape[0], -1)[:, 0]
    return out


def msm_fault(orig, kind):
    first = []

    def faulty(curve, basis, scalars, *args, **kw):
        if kind == "altered":
            return doubled_first(curve, orig(curve, basis, scalars, *args, **kw))
        if kind == "half":
            half = scalars.clone()
            half[..., scalars.shape[-1] // 2:] = 0
            pt = orig(curve, basis, half, *args, **kw)
            return cops.add(curve, pt, pt)
        if not first:
            first.append(orig(curve, basis, scalars, *args, **kw))
        return first[0]
    return faulty


def transform_fault(orig, kind):
    first = []

    def faulty(pre, x):
        if kind == "altered":
            out = orig(pre, x).clone()
            out[0, 0, 1] ^= 1
            return out
        if kind == "half":
            out = orig(pre, x)
            k = out.shape[1]
            out[:, k // 2:] = out[:, :k - k // 2][:, :k // 2]
            return out
        if not first:
            first.append(orig(pre, x))
        return first[0]
    return faulty


@pytest.mark.parametrize("kind", ["altered", "half", "unchanged"])
@pytest.mark.parametrize("name", [w["name"] for w in harness.benchmark_spec()["workloads"]])
def test_fault_refused(tiny, monkeypatch, name, kind):
    cell = tiny(name, sample=2)
    if cell.traffic["entry"] == "commit_many":
        monkeypatch.setattr(cmsm, "msm", msm_fault(cmsm.msm, kind))
    elif cell.traffic["entry"] == "msm_chunked":
        monkeypatch.setattr(cmsm, "msm_chunked", msm_fault(cmsm.msm_chunked, kind))
    else:
        target = "lde" if kind != "half" else "ifft"
        monkeypatch.setattr(fft, target, transform_fault(getattr(fft, target), kind))
    r = harness.run_cell(name, 2**31 + 99, 0.05, False, torch.device("cpu"), cell=cell,
                         log=lambda s: None)
    assert not r["correct"], r["checks"]
