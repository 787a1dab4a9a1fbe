"""Collision-order key and float32 constants shared by the neighbor passes.

Counterpart of ``collision_okey`` in ``particlesystem_tpu/ops/neighbor.py``.
The dense cell-pair ``neighbor_pass`` of that module is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

IMIN = -(1 << 31)


def as_f32(x: float) -> float:
    """``x`` rounded to float32: comparisons and products against it then
    match the JAX package's float32 constants on every device."""
    return np.float32(x).item()


def collision_okey(tags: torch.Tensor) -> torch.Tensor:
    """Placement-independent collision-order key (int32) from persistent
    uint32 tags (held in int64): the int32 bit pattern of the tag, clamped
    one above INT32_MIN so the kernels' no-collision sentinel stays strictly
    below every real key.  The clamp maps tag 0x80000000 onto INT32_MIN+1;
    particles with equal keys are order-equal and neither kills the other."""
    t = tags & 0xFFFFFFFF
    t = torch.where(t >= (1 << 31), t - (1 << 32), t)
    return torch.clamp(t, min=IMIN + 1).to(torch.int32)
