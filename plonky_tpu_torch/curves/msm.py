"""Multi-scalar multiplication (Pippenger) over a typed, precomputed basis.

Pipeline for scalars [LIMBS, *B, N] against an N-point basis:
  1. c-bit window digits of every scalar (torch),
  2. one stable argsort per (scalar, window) row and the start of every
     bucket's run in the sorted order (torch),
  3. bucket sums: one thread per (row, bucket) adds its run of points
     (K4 accumulation kernel),
  4. window sums  sum_j j B_j  by a running sum from the top bucket
     (K4 reduction kernel),
  5. Horner across windows, batched over the B MSMs: c doublings and one
     add per window (K2).

K4 lives in csrc/msm_kernels.cu; `bucket_accumulate_plain` and
`bucket_reduce_plain` are its plain PyTorch versions, taken only for CPU
tensors.  The result is a projective point [LIMBS, *B]; only its affine
value is defined (it matches the reference's MSM, not its coordinates).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import _cuda
from ..fields import ops as fops
from ..fields.spec import LIMBS, FieldSpec
from . import ops as cops
from .spec import CurveSpec


@dataclass(frozen=True, eq=False)
class MsmBasis:
    """A fixed MSM basis: canonical projective coordinates [LIMBS, N] on one
    device.  `msm` takes nothing else, so a commitment can never be made
    against an unchecked array (the reference took any uint8 input as
    canonical)."""
    curve: CurveSpec
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def n(self) -> int:
        return self.x.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.x.device


def precompute_base(curve: CurveSpec, points: cops.Point) -> MsmBasis:
    """Contiguous [LIMBS, N] copies of a point batch as an MsmBasis."""
    x, y, z = (t.reshape(LIMBS, -1).contiguous() for t in points)
    assert x.shape == y.shape == z.shape
    return MsmBasis(curve, x, y, z)


def scalar_window_digits(spec: FieldSpec, scalars: torch.Tensor,
                         c: int) -> torch.Tensor:
    """Canonical scalars [LIMBS, *B, N] -> window digits [W, *B, N] (int64,
    least significant window first), W = ceil(bits / c)."""
    n_windows = -(-spec.bits // c)
    v = scalars.to(torch.int64) & 0xFFFFFFFF
    v = torch.cat([v, torch.zeros_like(v[:1])])          # a zero limb on top
    start = torch.arange(n_windows, device=scalars.device) * c
    limb, shift = start // 32, start % 32
    view = (n_windows,) + (1,) * (scalars.dim() - 1)
    lo = v[limb] >> shift.reshape(view)
    hi = (v[limb + 1] << (32 - shift).reshape(view)) & 0xFFFFFFFF
    return (lo | hi) & ((1 << c) - 1)


def _run_starts(sorted_digits: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """[R, N] sorted digits -> [R, n_buckets + 1] int32 run starts."""
    ids = torch.arange(n_buckets + 1, device=sorted_digits.device)
    ids = ids.expand(sorted_digits.shape[0], -1).contiguous()
    return torch.searchsorted(sorted_digits.contiguous(), ids).to(torch.int32)


def bucket_accumulate_plain(curve: CurveSpec, basis: MsmBasis,
                            order: torch.Tensor, starts: torch.Tensor) -> cops.Point:
    """Bucket sums [LIMBS, R, n_buckets]: bucket j of row r is the sum of
    the points order[r, s], starts[r, j] <= s < starts[r, j + 1], added
    in that order onto the identity; bucket 0 is the identity.  Step s adds
    the s-th point of every bucket that has one."""
    rows, nb = starts.shape[0], starts.shape[1] - 1
    lo = starts[:, :-1].to(torch.int64).reshape(-1)
    lens = (starts[:, 1:] - starts[:, :-1]).to(torch.int64)
    lens[:, 0] = 0                                  # bucket 0 stays empty
    lens = lens.reshape(-1)
    acc = [t.reshape(LIMBS, -1).clone()
           for t in cops.identity(curve, (rows, nb), basis.device)]
    order64 = order.to(torch.int64)
    steps = int(lens.max().item()) if lens.numel() else 0
    for s in range(steps):
        sel = (lens > s).nonzero().squeeze(1)
        idx = order64[sel // nb, lo[sel] + s]
        pt = tuple(t[:, idx] for t in (basis.x, basis.y, basis.z))
        new = cops.add_plain(curve, tuple(t[:, sel] for t in acc), pt)
        for t, v in zip(acc, new):
            t[:, sel] = v
    return tuple(t.reshape(LIMBS, rows, nb) for t in acc)


def bucket_reduce_plain(curve: CurveSpec, buckets: cops.Point) -> cops.Point:
    """[LIMBS, R, n_buckets] -> [LIMBS, R]: sum_j j B_j as the sum over k >= 1
    of the running sums T_k = sum_{j >= k} B_j, from the top bucket down."""
    rows, nb = buckets[0].shape[1], buckets[0].shape[2]
    running = cops.identity(curve, (rows,), buckets[0].device)
    acc = running
    for j in range(nb - 1, 0, -1):
        running = cops.add_plain(curve, running, tuple(t[:, :, j] for t in buckets))
        acc = cops.add_plain(curve, acc, running)
    return acc


def bucket_accumulate(curve: CurveSpec, basis: MsmBasis, order: torch.Tensor,
                      starts: torch.Tensor) -> cops.Point:
    """K4 accumulation on the card (order [R, N], starts [R, B + 1] int32)."""
    if not fops._dispatch(basis.x):
        return bucket_accumulate_plain(curve, basis, order, starts)
    name = "msm_bucket_accumulate"
    for t in (basis.x, basis.y, basis.z):
        _cuda.check(name, t, LIMBS)
    for t in (order, starts):
        _cuda.check(name, t)
    rows, nb = starts.shape[0], starts.shape[1] - 1
    if starts.dim() != 2 or order.shape != (rows, basis.n):
        raise ValueError(f"{name}: order {tuple(order.shape)} vs "
                         f"{rows} rows of {basis.n} points")
    outs = [torch.empty((LIMBS, rows, nb), dtype=torch.int32,
                        device=basis.device) for _ in range(3)]
    if rows * nb == 0:
        return tuple(outs)
    _cuda.launch(name, "pt_msm_bucket_accumulate",
                 *[t.data_ptr() for t in outs],
                 basis.x.data_ptr(), basis.y.data_ptr(), basis.z.data_ptr(),
                 order.data_ptr(), starts.data_ptr(), rows, nb, basis.n,
                 cops._consts_host(curve).ctypes.data, _cuda.stream())
    return tuple(outs)


def bucket_reduce(curve: CurveSpec, buckets: cops.Point) -> cops.Point:
    """K4 reduction on the card: [LIMBS, R, B] bucket sums -> [LIMBS, R]."""
    if not fops._dispatch(buckets[0]):
        return bucket_reduce_plain(curve, buckets)
    name = "msm_bucket_reduce"
    for t in buckets:
        _cuda.check(name, t, LIMBS)
        if t.dim() != 3 or t.shape != buckets[0].shape:
            raise ValueError(f"{name}: bucket coordinates {tuple(t.shape)}")
    rows, nb = buckets[0].shape[1], buckets[0].shape[2]
    outs = [torch.empty((LIMBS, rows), dtype=torch.int32,
                        device=buckets[0].device) for _ in range(3)]
    if rows == 0:
        return tuple(outs)
    _cuda.launch(name, "pt_msm_bucket_reduce", *[t.data_ptr() for t in outs],
                 *[t.data_ptr() for t in buckets], rows, nb,
                 cops._consts_host(curve).ctypes.data, _cuda.stream())
    return tuple(outs)


def msm(curve: CurveSpec, basis: MsmBasis, scalars: torch.Tensor,
        window_bits: int) -> cops.Point:
    """sum_i scalars[..., i] * basis[i] for canonical scalars
    [LIMBS, *B, N]; returns a [LIMBS, *B] projective point (a multi-MSM
    over the shared basis when B is not empty)."""
    if not isinstance(basis, MsmBasis):
        raise TypeError("msm takes an MsmBasis (see precompute_base)")
    if scalars.shape[-1] != basis.n:
        raise ValueError(f"{scalars.shape[-1]} scalars for {basis.n} points")
    c = window_bits
    n_buckets = 1 << c
    lead = tuple(scalars.shape[1:-1])
    digits = scalar_window_digits(curve.scalar, scalars, c)   # [W, *B, N]
    n_windows = digits.shape[0]
    k = 1
    for d in lead:
        k *= d
    rows = digits.reshape(n_windows, k, basis.n).transpose(0, 1).reshape(
        k * n_windows, basis.n)
    sorted_digits, order = torch.sort(rows, dim=-1, stable=True)
    starts = _run_starts(sorted_digits, n_buckets)
    buckets = bucket_accumulate(curve, basis, order.to(torch.int32).contiguous(),
                                starts)
    ws = bucket_reduce(curve, buckets)                     # [LIMBS, K W]
    ws = tuple(t.reshape(LIMBS, k, n_windows) for t in ws)
    acc = tuple(t[..., n_windows - 1].contiguous() for t in ws)
    for w in range(n_windows - 2, -1, -1):
        for _ in range(c):
            acc = cops.double(curve, acc)
        acc = cops.add(curve, acc, tuple(t[..., w] for t in ws))
    return tuple(t.reshape(LIMBS, *lead) for t in acc)
