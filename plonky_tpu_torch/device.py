"""Device selection.  Every entry point runs on the card unless its caller
passes ``device="cpu"``; without a card the default raises instead of
quietly running on the CPU."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "plonky_tpu_torch: CUDA is not available; pass device='cpu' to "
            "run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
