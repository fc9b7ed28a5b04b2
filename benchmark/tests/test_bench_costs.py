"""The frozen counters give chip_smoke.py's counts at PERF.md's shapes
(the kernel table's bounds), and the call-level counts add them up."""

import math
import sys

import pytest
import torch

from benchmark import costs
from benchmark.harness import ROOT

sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from plonky_tpu_torch.curves import msm as cmsm  # noqa: E402
from plonky_tpu_torch.fields.instances import (BLS12_377_BASE, BLS12_377_SCALAR,  # noqa: E402
                                               TWEEDLEDEE_BASE, TWEEDLEDUM_BASE)

FIELDS = [TWEEDLEDEE_BASE, TWEEDLEDUM_BASE, BLS12_377_BASE, BLS12_377_SCALAR]


@pytest.mark.parametrize("f", FIELDS, ids=lambda f: f.name)
def test_field_and_point_costs(f):
    assert costs.field_costs(f.p, f.limbs) == chip_smoke.field_costs(f)
    assert costs.point_costs(f.p, f.limbs) == chip_smoke.point_costs(f)


@pytest.mark.parametrize("batch,lg,inverse,coset", [
    (9, 17, False, False), (9, 14, True, False), (1, 17, True, True),
    (1, 14, False, True), (6, 17, False, False), (9, 20, False, False)])
@pytest.mark.parametrize("f", [TWEEDLEDUM_BASE, BLS12_377_BASE], ids=lambda f: f.name)
def test_ntt_work(f, batch, lg, inverse, coset):
    assert costs.ntt_work(batch, lg, inverse, coset, f.p, f.limbs) == \
        chip_smoke.ntt_work(batch, lg, inverse, coset, f)


def test_ntt_bound_of_the_kernel_table():
    """PERF.md's ntt_pass row: FFT [9, 2^17] bounded by ops at 0.0993 ms."""
    f = TWEEDLEDUM_BASE
    seconds, by = costs.least_seconds(costs.ntt_work(9, 17, False, False, f.p, f.limbs))
    assert by == "ops" and math.isclose(seconds * 1e3, 0.0993, rel_tol=2e-3)


@pytest.mark.parametrize("k,w,c", [(9, 32, 8), (2, 32, 8), (64, 32, 8), (1, 33, 8)])
@pytest.mark.parametrize("f", [TWEEDLEDEE_BASE, BLS12_377_BASE], ids=lambda f: f.name)
def test_horner_work(f, k, w, c):
    ws = (torch.zeros((f.limbs, k, w), dtype=torch.int32),) * 3
    assert costs.horner_work(k, w, c, f.p, f.limbs) == chip_smoke.horner_work(ws, c, f)


@pytest.mark.parametrize("k,n,c", [(9, 1 << 10, 8), (2, 1000, 8), (1, 1 << 12, 4)])
def test_k4_and_reduce_work(k, n, c):
    f, sf = TWEEDLEDEE_BASE, TWEEDLEDUM_BASE
    gen = torch.Generator().manual_seed(7)
    scal = torch.randint(0, 1 << 31, (8, k, n), generator=gen, dtype=torch.int64).to(torch.int32)
    scal[:, 0, :5] = 0
    sorted_digits, _order, starts, rows = chip_smoke.k4_rows(torch, cmsm, sf, scal, c)
    acc = (torch.zeros((rows.shape[0], 1 << c, 24), dtype=torch.int32),
           torch.zeros((rows.shape[0], 3, 24), dtype=torch.int32))
    out = 4 * sum(t.numel() for t in acc)
    assert costs.k4_work(rows, starts, out, f.p, f.limbs) == chip_smoke.k4_work(rows, starts, acc, f)
    assert costs.reduce_work(starts, out, f.p, f.limbs) == chip_smoke.reduce_work(starts, acc, f)
    mine = costs.run_starts(costs.window_digits(scal, sf.bits, c).transpose(0, 1)
                            .reshape(-1, n), 1 << c)
    assert torch.equal(mine, starts.to(torch.int64))
    assert torch.equal(costs.window_digits(scal, sf.bits, c),
                       cmsm.scalar_window_digits(sf, scal, c))


def test_msm_work_adds_its_stages():
    """msm_work of two slices: both slices' accumulates and reductions,
    one Horner of 2 K chains and K adds of the slices' points."""
    f, r = TWEEDLEDEE_BASE, TWEEDLEDUM_BASE
    gen = torch.Generator().manual_seed(3)
    scal = torch.randint(0, 1 << 31, (8, 3, 512), generator=gen, dtype=torch.int64).to(torch.int32)
    by, ops = costs.msm_work(scal, r.p.bit_length(), 8, 256, f.p, f.limbs)
    want_b = want_o = 0
    for lo in (0, 256):
        rows = costs.window_digits(scal[..., lo:lo + 256], 255, 8).transpose(0, 1).reshape(-1, 256)
        st = costs.run_starts(rows, 256)
        a_b, a_o, r_b, r_o = costs.k4_work(rows, st, 96 * rows.shape[0] * 256, f.p, 8)
        want_b += a_b + r_b
        want_o += a_o + r_o
    h_b, h_o = costs.horner_work(6, 32, 8, f.p, 8)
    add = costs.point_costs(f.p, 8)[0]
    assert (by, ops) == (want_b + h_b + 3 * 96 * 3, want_o + h_o + 3 * add)


def test_peaks():
    assert costs.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert math.isclose(costs.IMAD_SLOTS_PER_S, 1.67e13, rel_tol=2e-3)
    assert costs.inverse_work(BLS12_377_BASE.p, 12, 1)[1] == 456 * 376
