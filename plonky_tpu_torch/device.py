"""Device selection.  Every entry point runs on the card unless its caller
passes ``device="cpu"``; without a card the default raises instead of
quietly running on the CPU."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device to run on: the card unless `device` names another; a
    card always with its index (a bare "cuda" is the current card), so
    that a table cached under the device belongs to one card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "plonky_tpu_torch: CUDA is not available; pass device='cpu' to "
            "run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
