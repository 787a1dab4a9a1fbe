"""Device selection shared by the entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device without a usable card
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch sees no "
                           f"CUDA device")
    return dev
