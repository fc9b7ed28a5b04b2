"""Several processes on torch.distributed (the JAX package's
plonky_tpu/parallel/distributed.py, which brings up jax.distributed).

One process a card under NCCL (gloo for processes on the CPU), joined as
torchrun describes them: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and
LOCAL_RANK.  A process's shards form its local mesh (virtual entries of
its one card, or of the CPU); the global mesh is [processes, local
entries], rank-major, as JAX's hybrid [dcn, ici] mesh.  Every step between
processes is a collective outside the kernels: `psum` an all-reduce,
`msm_sharded` an all-gather of the partial points (their canonical
int32 limbs) summed by K2's tree, and `fft_sharded_domain`
an all-to-all of the four-step's blocks and an all-gather of its output.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..curves import ops as cops
from ..curves.spec import CurveSpec
from ..device import resolve
from ..fields.spec import FieldSpec
from . import fft as pfft
from . import msm as pmsm
from .mesh import Mesh, default_mesh


def initialize(device=None) -> torch.device:
    """Join the process group of torchrun's environment and return this
    process's device: the card cuda:LOCAL_RANK under NCCL, or the CPU
    under gloo when device="cpu" is asked.  Without MASTER_ADDR (one
    process, no launcher) or once joined, it joins nothing."""
    dev = resolve(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dev.index)))
        torch.cuda.set_device(dev)
    if dist.is_initialized() or "MASTER_ADDR" not in os.environ:
        return dev
    dist.init_process_group(
        "gloo" if dev.type == "cpu" else "nccl",
        init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}"),
        world_size=int(os.environ.get("WORLD_SIZE", "1")),
        rank=int(os.environ.get("RANK", "0")))
    return dev


def _world() -> tuple:
    """(processes, this process's rank): (1, 0) outside a process group."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


@dataclass(frozen=True)
class HybridMesh:
    """The [processes, local entries] mesh seen from one process: global
    shard g = rank * local.size + l runs on local.devices[l] of process
    `rank`."""
    processes: int
    rank: int
    local: Mesh

    @property
    def shape(self) -> tuple:
        return (self.processes, self.local.size)

    @property
    def size(self) -> int:
        return self.processes * self.local.size


def hybrid_mesh(n_local: int | None = None, device=None) -> HybridMesh:
    """This process's view of the [processes, local] mesh: its local mesh
    is `default_mesh(n_local, device)`; one process gives [1, n_local]."""
    processes, rank = _world()
    return HybridMesh(processes, rank, default_mesh(n_local, device))


def process_local_slice(n_total: int) -> tuple:
    """[start, stop) of this process's share of an axis of n_total."""
    processes, rank = _world()
    if n_total % processes:
        raise ValueError(f"{n_total} over {processes} processes")
    per = n_total // processes
    return rank * per, (rank + 1) * per


def psum(mesh: HybridMesh, parts) -> torch.Tensor:
    """The sum of every shard's tensor over the whole mesh (JAX's psum
    over both axes): `parts[l]` lies on local.devices[l]; the result is on
    the first local device of every process."""
    first = mesh.local.devices[0]
    total = parts[0].to(first).clone()
    for part in parts[1:]:
        total += part.to(first)
    if dist.is_initialized():
        dist.all_reduce(total)
    return total


def msm_sharded(mesh: HybridMesh, curve: CurveSpec, sharded_basis,
                scalars: torch.Tensor, window_bits: int = 8) -> cops.Point:
    """The MSM of every process's share: this process's `scalars` [Ls, *B,
    N_local] against its `pmsm.shard_basis(mesh.local, basis)`; the partial
    points of all processes gathered and summed.  Returns the [L, *B] sum
    on the first local device of every process."""
    part = pmsm.msm_sharded(mesh.local, curve, sharded_basis, scalars,
                            window_bits)
    if not dist.is_initialized():
        return part
    nl, lead = curve.base.limbs, part[0].shape[1:]
    flat = torch.cat([t.reshape(nl, -1) for t in part])            # [3 L, K]
    gathered = [torch.empty_like(flat) for _ in range(mesh.processes)]
    dist.all_gather(gathered, flat)
    stacked = torch.stack(gathered, dim=-1)                         # [3 L, K, W]
    pts = tuple(stacked[c * nl:(c + 1) * nl] for c in range(3))
    return tuple(t.reshape(nl, *lead)
                 for t in pmsm.tree_sum(curve, pts))


def fft_sharded_domain(mesh: HybridMesh, spec: FieldSpec,
                       coeffs: torch.Tensor) -> torch.Tensor:
    """`pfft.fft_sharded_domain` over the whole mesh: every process passes
    the same coeffs [L, *B, n] and runs the rows of its own shards; the
    blocks cross processes in one all-to-all (the local entries of a
    process share one device), and
    every process receives the whole result in natural order on coeffs'
    device."""
    m, w, nloc = mesh.size, mesh.processes, mesh.local.size
    lg_n1 = pfft.domain_split(coeffs.shape[-1], m)
    if len(mesh.local.cards()) != 1:
        raise ValueError("fft_sharded_domain: a process's entries must share "
                         "one device")
    mine = tuple(range(mesh.rank * nloc, (mesh.rank + 1) * nloc))
    tw = pfft.row_twiddles(spec, coeffs.shape[-1], lg_n1, mine,
                           mesh.local.devices[0])
    rows = [pfft.stage_one(spec, coeffs, lg_n1, i1, tw[:, l])
            for l, i1 in enumerate(mine)]
    # send[r', l, l'] is local row l's block for global shard r' nloc + l'
    send = torch.stack([torch.stack(r.tensor_split(m, dim=-1)) for r in rows])
    send = send.reshape(nloc, w, nloc, *send.shape[2:]).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    if dist.is_initialized():
        dist.all_to_all_single(recv, send)
    else:
        recv.copy_(send)
    # recv[r, l, l'] is the block of global row r nloc + l for local shard l'
    outs = torch.stack([pfft.stage_two(spec, recv[:, :, lp].reshape(m, *recv.shape[3:]))
                        for lp in range(nloc)])
    if dist.is_initialized():
        gathered = [torch.empty_like(outs) for _ in range(w)]
        dist.all_gather(gathered, outs)
        outs = torch.cat(gathered)
    return pfft.natural_order(list(outs), coeffs.device, coeffs.shape)
