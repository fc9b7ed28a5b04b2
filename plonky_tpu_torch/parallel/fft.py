"""Mesh-sharded FFTs (the JAX package's plonky_tpu/parallel/fft.py).

`fft_sharded_batch` splits the polynomial axis of [8, k, n] into one
contiguous block a mesh entry (JAX's P(None, "dp", None)); each shard runs
the port's `fft` (K3's ntt_pass) on its entry's device.

`fft_sharded_domain` shards one domain of n = n1 n2 points, n1 the mesh
size, by the decimation of plonky_tpu/parallel/fft.py:34-100: with
C[i1, i2] = c[i1 + n1 i2],

    X[k2 + n2 k1] = sum_i1 w_n1^(i1 k1) w_n^(i1 k2) sum_i2 w_n2^(i2 k2) C[i1, i2]:

shard i1 takes row i1 of C, transforms it (n2 points, K3) and multiplies
it by row i1 of `four_step_twiddles(spec, n, lg n1)` (K1), each device
building only its own shards' rows (`row_twiddles`); the all-to-all
exchange hands shard j the j-th block of k2 from every row; shard j
transforms its columns (n1 points, K3); the blocks are gathered in natural
order (n a multiple of n1^2, so that every block is whole).  The
exchange and the gathers are tensor copies between cards,
outside the kernels (`distributed.fft_sharded_domain` runs the same stages
with torch.distributed's all-to-all between processes).
"""

from __future__ import annotations

import functools

import torch

from ..fields import host as fhost
from ..fields import ops as fops
from ..fields.spec import LIMBS, FieldSpec
from ..poly.fft import FftPrecomputation, fft, powers_dyn
from ..utils import is_power_of_two, log2_strict
from .mesh import Mesh


def fft_sharded_batch(mesh: Mesh, pre: FftPrecomputation,
                      coeffs: torch.Tensor) -> torch.Tensor:
    """`fft(pre, coeffs)` of coeffs [8, k, n], k a multiple of the mesh
    size: shard i transforms polynomials [i k / m, (i + 1) k / m) on its
    entry's device; the result is gathered on coeffs' device."""
    if coeffs.dim() != 3 or coeffs.shape[-1] != pre.n:
        raise ValueError(f"fft_sharded_batch: coeffs {tuple(coeffs.shape)} "
                         f"for n = {pre.n}")
    k, m = coeffs.shape[1], mesh.size
    if k % m:
        raise ValueError(f"fft_sharded_batch: {k} polynomials over {m} shards")
    per = k // m
    outs = [fft(pre, coeffs[:, i * per:(i + 1) * per].to(dev))
            for i, dev in enumerate(mesh.devices)]
    return torch.cat([o.to(coeffs.device) for o in outs], dim=1)


def domain_split(n: int, m: int) -> int:
    """lg n1 of the sharded domain's n = n1 n2 with n1 = m, the mesh size:
    a power of two whose square divides n, so that the exchange's blocks
    of n2 / m points are whole."""
    if not is_power_of_two(m) or n % (m * m):
        raise ValueError(f"fft_sharded_domain: a domain of {n} points over "
                         f"{m} shards (a power of two whose square divides n)")
    return m.bit_length() - 1


@functools.lru_cache(maxsize=8)
def row_twiddles(spec: FieldSpec, n: int, lg_n1: int, rows: tuple,
                 device: torch.device) -> torch.Tensor:
    """Rows `rows` of `four_step_twiddles(spec, n, lg_n1)`, w_n^(i1 k2) for
    i1 in rows and k2 < n2, as [8, len(rows), n2] on `device`: the powers
    of the bases w_n^i1 (`powers_dyn`), so that a device builds the rows
    of its own shards and not the [8, n1, n2] table.  The eight latest are
    cached."""
    g = fhost.primitive_root_of_unity(spec, log2_strict(n))
    bases = fops.from_ints(spec, [pow(g, i1, spec.p) for i1 in rows], device)
    return powers_dyn(spec, bases[..., None], n >> lg_n1)


def stage_one(spec: FieldSpec, coeffs: torch.Tensor, lg_n1: int, i1: int,
              tw: torch.Tensor) -> torch.Tensor:
    """Shard i1's row before the exchange, [8, *B, n2] on tw's device: its
    row c[i1 + n1 i2] transformed over i2, times its twiddle row tw
    [8, n2], w_n^(i1 k2)."""
    n1 = 1 << lg_n1
    inner = fft(FftPrecomputation(spec, coeffs.shape[-1] >> lg_n1),
                coeffs[..., i1::n1].to(tw.device))
    return fops.mul(spec, inner, tw)


def stage_two(spec: FieldSpec, blocks) -> torch.Tensor:
    """Shard j's output from its block of k2 of every row i1 (each
    [8, *B, b], on one device): [8, *B, b, n1], at [k2, k1] the value
    X[k2 + n2 k1] for the block's k2."""
    cols = torch.stack(list(blocks), dim=-1)
    return fft(FftPrecomputation(spec, len(blocks)), cols)


def natural_order(outs, device, shape) -> torch.Tensor:
    """The shards' stage_two outputs, in shard order, as one [8, *B, n]
    tensor in natural order (index k1 n2 + k2) on `device`."""
    out = torch.cat([o.to(device) for o in outs], dim=-2)     # [.., n2, n1]
    return out.transpose(-1, -2).reshape(shape)


def fft_sharded_domain(mesh: Mesh, spec: FieldSpec,
                       coeffs: torch.Tensor) -> torch.Tensor:
    """`fft` of coeffs [8, *B, n] with its domain sharded over the mesh
    (n1 = mesh size, n2 = n / n1), gathered in natural order on coeffs'
    device."""
    if coeffs.shape[0] != LIMBS:
        raise ValueError(f"fft_sharded_domain: coeffs {tuple(coeffs.shape)}")
    m = mesh.size
    lg_n1 = domain_split(coeffs.shape[-1], m)
    tw = {}
    for dev in mesh.cards():
        mine = tuple(i for i, d in enumerate(mesh.devices) if d == dev)
        table = row_twiddles(spec, coeffs.shape[-1], lg_n1, mine, dev)
        tw.update({i1: table[:, j] for j, i1 in enumerate(mine)})
    rows = [stage_one(spec, coeffs, lg_n1, i1, tw[i1]) for i1 in range(m)]
    blocks = [r.tensor_split(m, dim=-1) for r in rows]
    outs = [stage_two(spec, [blocks[i][j].to(dev) for i in range(m)])
            for j, dev in enumerate(mesh.devices)]
    return natural_order(outs, coeffs.device, coeffs.shape)
