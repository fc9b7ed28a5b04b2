"""Inputs made from the run's seed: canonical field elements on the
device, and the MSM basis, a doubling chain of a G spread over N points
on the device (reference/msm.py gives its discrete logs)."""

from __future__ import annotations

import hashlib
import random

import torch

from .reference import msm as rmsm

CHAIN_POINTS = 1 << 10      # host points of the chain; the rest by device adds


def derived_seed(seed: int, *what) -> int:
    """A 63-bit seed for one use of the run's seed (a call's inputs, the
    basis, the check's points), the same on every machine."""
    text = ":".join(str(w) for w in (seed, *what)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(), "little") >> 1


def rng(seed: int, *what) -> random.Random:
    return random.Random(derived_seed(seed, *what))


def random_field(shape: tuple, limbs: int, p: int, seed: int, device) -> torch.Tensor:
    """[limbs, *shape] int32 limbs, uniform but for the top limb, which is
    drawn below p's top limb, so every element is below p."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    v = torch.randint(0, 1 << 32, (limbs, *shape), dtype=torch.int64,
                      generator=gen, device=device)
    v[-1] %= p >> (32 * (limbs - 1))
    return (v - ((v >> 31) << 32)).to(torch.int32)


def chain_basis(curve, ref, n: int, a: int, device):
    """The n-point chain basis of A = a G (reference/msm.py) as the
    program's MsmBasis, affine (Z = 1) as a prover's bases are: the first
    CHAIN_POINTS points of the chain from the host, then L doublings of
    the set on the device, each adding one more chain point, then one
    batch normalisation."""
    from plonky_tpu_torch.curves import msm as cmsm
    from plonky_tpu_torch.curves import ops as cops
    from plonky_tpu_torch.fields import ops as fops

    m, levels = rmsm.chain_shape(n, CHAIN_POINTS)
    chain = rmsm.chain_points(ref, a, m + levels)
    f = curve.base

    def device_points(pts):
        return cops.from_affine(curve, fops.from_ints(f, [q[0] for q in pts], device),
                                fops.from_ints(f, [q[1] for q in pts], device))
    pts = device_points(chain[:m])
    for t in range(levels):
        shifted = cops.add(curve, pts, device_points(chain[m + t:m + t + 1]))
        pts = tuple(torch.cat([u, v], 1) for u, v in zip(pts, shifted))
    x, y, zero = cops.to_affine(curve, pts)
    return cmsm.precompute_base(curve, cops.from_affine(curve, x, y, zero))
