"""Device meshes (the JAX package's plonky_tpu/parallel/mesh.py).

A mesh is an ordered tuple of devices, one an entry; a shard of a sharded
function runs on its entry's device.  A device may stand in more than one
entry: such entries are virtual shards, which run one after another on
their card (as the JAX package's tests run 8 virtual CPU devices), so a
mesh of one card measures the sharded path's overhead and not its
scaling.  Cards exchange data by tensor copies outside the kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve


@dataclass(frozen=True)
class Mesh:
    """Entries of a one-axis mesh: `devices[i]` runs shard i."""
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    def cards(self) -> list:
        """The distinct devices of the mesh, in the order they first occur."""
        return list(dict.fromkeys(self.devices))


def default_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """A mesh of `n_devices` entries: over every visible card by default
    (the cards cycled where n_devices is larger; all of them where it is
    None), or over the one device `device` names (entries of "cpu" for the
    tests, or "cuda:0" for virtual shards of one card)."""
    if device is None:
        resolve()
        pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        pool = [resolve(device)]
    n = len(pool) if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"a mesh needs at least one entry, not {n}")
    return Mesh(tuple(pool[i % len(pool)] for i in range(n)))
