"""Device selection with no silent fallback."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``.

    Raises when a CUDA device is asked for and none is available: the
    port never answers a request for the card with the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch version")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
