"""Mesh-sharded MSM (the JAX package's plonky_tpu/parallel/msm.py).

The basis and the scalars are split into one contiguous block of N / m
points a mesh entry; each shard runs the port's `msm` (K4's accumulate
and reduce, K2's `curve_horner`) on its entry's device; the m partial
points are copied to the first entry's device and summed by a halving
tree of K2's `curve_add` (plonky_tpu/curves/msm.py:255 `_tree_reduce`).
"""

from __future__ import annotations

import torch

from ..curves import msm as cmsm
from ..curves import ops as cops
from ..curves.spec import CurveSpec
from .mesh import Mesh


def shard_basis(mesh: Mesh, basis: cmsm.MsmBasis) -> tuple:
    """One MsmBasis a mesh entry, on its device: points [i N / m,
    (i + 1) N / m) of `basis` (views where the entry's device is the
    basis's).  Made once, as a commitment basis is."""
    if not isinstance(basis, cmsm.MsmBasis):
        raise TypeError("shard_basis takes an MsmBasis (see precompute_base)")
    n, m = basis.n, mesh.size
    if n % m:
        raise ValueError(f"shard_basis: {n} points over {m} shards")
    per = n // m
    shards = []
    for i, dev in enumerate(mesh.devices):
        part = basis.slice(i * per, (i + 1) * per)
        shards.append(cmsm.MsmBasis(basis.curve, part.x.to(dev), part.y.to(dev),
                                    part.z.to(dev), part.mont.to(dev)))
    return tuple(shards)


def tree_sum(curve: CurveSpec, pts: cops.Point) -> cops.Point:
    """Points [L, *B, M] summed over the last axis by halving: pairs
    (2i, 2i + 1) added in one `cops.add` a level, an odd last point carried
    up.  Returns [L, *B]."""
    n = pts[0].shape[-1]
    while n > 1:
        half = n // 2
        summed = cops.add(curve, tuple(t[..., 0:2 * half:2] for t in pts),
                          tuple(t[..., 1:2 * half:2] for t in pts))
        if n % 2:
            summed = tuple(torch.cat([s, t[..., -1:]], dim=-1)
                           for s, t in zip(summed, pts))
        pts, n = summed, half + n % 2
    return tuple(t[..., 0] for t in pts)


def msm_sharded(mesh: Mesh, curve: CurveSpec, sharded_basis,
                scalars: torch.Tensor, window_bits: int = 8) -> cops.Point:
    """sum_i scalars[..., i] basis[i] for canonical scalars [Ls, *B, N]
    against `shard_basis(mesh, basis)`, N a multiple of the mesh size;
    returns a [L, *B] projective point on the first entry's device."""
    m = mesh.size
    if len(sharded_basis) != m:
        raise ValueError(f"msm_sharded: {len(sharded_basis)} basis shards "
                         f"for a mesh of {m}")
    n = sum(b.n for b in sharded_basis)
    if scalars.shape[-1] != n or n % m:
        raise ValueError(f"msm_sharded: {scalars.shape[-1]} scalars for {n} "
                         f"points over {m} shards")
    per = n // m
    parts = [cmsm.msm(curve, b, scalars[..., i * per:(i + 1) * per].to(b.device),
                      window_bits)
             for i, b in enumerate(sharded_basis)]
    first = mesh.devices[0]
    return tree_sum(curve, tuple(torch.stack([p[k].to(first) for p in parts], dim=-1)
                                 for k in range(3)))
