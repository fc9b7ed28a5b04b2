"""The MSM bucket pipeline's plain versions (plonky_tpu_torch.curves.msm,
on the CPU) at small chunk and tile sizes, so that chunk trees, carries
across tiles and short segments all occur: the chunked accumulation
against direct bucket sums, the segmented reduction against the direct
sum_j j B_j, and the Montgomery conversions.  The kernels hold these plain
versions word for word on the card (chip_smoke.py)."""

import numpy as np
import pytest
import torch

from plonky_tpu_torch.curves import TWEEDLEDEE as CURVE
from plonky_tpu_torch.curves import host as chost
from plonky_tpu_torch.curves import msm as cmsm
from plonky_tpu_torch.curves import ops as cops
from plonky_tpu_torch.fields import ops as fops
from plonky_tpu_torch.protocol.circuit import (device_points_to_host,
                                               points_to_device)

torch.set_num_threads(1)

N = 50                 # not a multiple of any chunk below


@pytest.fixture(scope="module")
def points():
    g = chost.generator(CURVE)
    rng = np.random.default_rng(11)
    pts = [chost.mul(g, int(rng.integers(2, 1 << 62))) for _ in range(N)]
    pts[7] = chost.zero_point(CURVE)
    return pts


def _pipeline_inputs(digit_rows):
    rows = torch.tensor(digit_rows, dtype=torch.int64)
    sorted_digits, order = torch.sort(rows, dim=-1, stable=True)
    return (sorted_digits.to(torch.int32).contiguous(),
            order.to(torch.int32).contiguous())


def _host_bucket_sums(pts, digits, nb):
    sums = [chost.zero_point(CURVE) for _ in range(nb)]
    for pt, d in zip(pts, digits):
        if d:
            sums[d] = chost.add(sums[d], pt)
    return sums


def _digit_rows(c):
    rng = np.random.default_rng(c)
    top = (1 << c) - 1
    return [
        # random digits with a few buckets left empty
        [int(v) if v % 3 else 0 for v in rng.integers(0, top + 1, N)],
        [top // 2 + 1] * N,                   # every point in one bucket
        [0] * N,                              # an all-zero row
        [top] * (N // 2) + [1] * (N - N // 2),  # two long runs
    ]


@pytest.mark.parametrize("chunk,tile", [(3, 4), (2, 2), (7, 1), (64, 128)])
def test_chunked_accumulation_matches_bucket_sums(points, chunk, tile):
    c = 3
    nb = 1 << c
    digit_rows = _digit_rows(c)
    digits, order = _pipeline_inputs(digit_rows)
    starts = cmsm._run_starts(digits.to(torch.int64), nb)
    basis = cmsm.precompute_base(CURVE, points_to_device(CURVE, points, "cpu"))
    buckets, carries = cmsm.bucket_accumulate_plain(
        CURVE, basis, digits, order, starts, chunk=chunk, tile=tile)
    ntiles = -(-(-(-N // chunk)) // tile)
    assert buckets.shape == (4, nb, cmsm.words(CURVE))
    assert carries.shape == (4, ntiles, cmsm.words(CURVE))
    assert not buckets[:, 0].any() and not buckets[2].any()
    tp = chunk * tile
    for r, row in enumerate(digit_rows):
        want = _host_bucket_sums(points, row, nb)
        b = cmsm.unpack_points(CURVE, buckets[r])
        cs = cmsm.unpack_points(CURVE, carries[r])
        for j in range(1, nb):
            lo, hi = int(starts[r, j]), int(starts[r, j + 1])
            if hi == lo:
                assert not buckets[r, j].any()
                continue
            total = tuple(t[:, j:j + 1] for t in b)
            for t in range(lo // tp + 1, (hi - 1) // tp + 1):
                total = cops.add_plain(CURVE, total,
                                       tuple(x[:, t:t + 1] for x in cs))
            assert device_points_to_host(CURVE, total) == [want[j]], (r, j)


@pytest.mark.parametrize("c", range(2, 9))
def test_segmented_reduce_matches_direct_sum(points, c):
    # segments of `seg` buckets over buckets 1 .. 2^c - 1: the last one is
    # always short by one
    seg = 1 << max(1, c - 3)
    nb = 1 << c
    digit_rows = _digit_rows(c)
    digits, order = _pipeline_inputs(digit_rows)
    starts = cmsm._run_starts(digits.to(torch.int64), nb)
    basis = cmsm.precompute_base(CURVE, points_to_device(CURVE, points, "cpu"))
    chunk, tile = 3, 4
    buckets, carries = cmsm.bucket_accumulate_plain(
        CURVE, basis, digits, order, starts, chunk=chunk, tile=tile)
    got = device_points_to_host(CURVE, cmsm.bucket_reduce_plain(
        CURVE, buckets, carries, starts, chunk=chunk, tile=tile, seg=seg))
    for r, row in enumerate(digit_rows):
        want = chost.zero_point(CURVE)
        for j, s in enumerate(_host_bucket_sums(points, row, nb)):
            if j:
                want = chost.add(want, chost.mul(s, j))
        assert got[r] == want, r
    # the all-zero row is the identity (0 : 1 : 0) itself
    ident = cops.identity(CURVE, (1,), "cpu")
    ws = cmsm.bucket_reduce_plain(CURVE, buckets, carries, starts,
                                  chunk=chunk, tile=tile, seg=seg)
    assert all(torch.equal(t[:, 2:3], i) for t, i in zip(ws, ident))


def test_montgomery_round_trip(points):
    f = CURVE.base
    p = f.p
    vals = [0, 1, p - 1, 2, (1 << 254) - 12345, 0x1234567890ABCDEF << 100]
    x = fops.from_ints(f, vals, "cpu")
    m = fops.to_montgomery(f, x)
    r = pow(2, 256, p)
    assert list(fops.to_ints(f, m)) == [v * r % p for v in vals]
    assert list(fops.to_ints(f, fops.from_montgomery(f, m))) == vals
    pts = points_to_device(CURVE, points[:5], "cpu")
    words = cmsm.pack_points(CURVE, pts)
    assert words.shape == (5, cmsm.words(CURVE))
    assert all(torch.equal(a, b) for a, b in
               zip(cmsm.unpack_points(CURVE, words), pts))
    basis = cmsm.precompute_base(CURVE, pts)
    assert torch.equal(basis.mont, words)
