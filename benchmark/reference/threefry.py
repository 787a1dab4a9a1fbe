"""Counter-based randomness: Threefry-2x32 (20 rounds) as ``jax.random``
computes it with ``jax_threefry_partitionable`` on.

* ``key(seed)`` is ``(seed >> 32, seed & 0xFFFFFFFF)``;
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
* element ``i`` of a draw is ``b1 ^ b2`` of ``threefry2x32(k, (i >> 32,
  i & 0xFFFFFFFF))``;
* a uniform is ``bitcast_f32((bits >> 9) | 0x3F800000) - 1``.

uint32 values live in int64 tensors or Python ints; every operation masks
back to 32 bits.
"""

from __future__ import annotations

import math

import torch

UVEC, FERT, EMIT, FILL = 0, 1, 2, 3
M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def hash2x32(k1, k2, x1, x2):
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = (((x2 << r) | (x2 >> (32 - r))) & M32) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def key(seed: int):
    return ((seed >> 32) & M32, seed & M32)


def fold_in(k, data):
    return hash2x32(k[0], k[1], 0, data & M32)


def frame_key(seed: int, frame: int, purpose: int, *words: int):
    """``fold_in`` of the purpose, the frame, then each word, into
    ``key(seed)``."""
    k = fold_in(fold_in(key(seed), purpose), frame)
    for w in words:
        k = fold_in(k, w)
    return k


def bits(k, shape, device) -> torch.Tensor:
    """uint32 draws of ``shape``; a key of (T,) tensors gives (T, *shape)."""
    count = torch.arange(math.prod(shape), dtype=torch.int64,
                         device=device).reshape(shape)
    k1, k2 = k
    if isinstance(k1, torch.Tensor) and k1.dim():
        k1 = k1.reshape((-1,) + (1,) * len(shape))
        k2 = k2.reshape((-1,) + (1,) * len(shape))
    b1, b2 = hash2x32(k1, k2, count >> 32, count & M32)
    return b1 ^ b2


def unit01(k, shape, device) -> torch.Tensor:
    """float32 uniforms in [0, 1)."""
    b = bits(k, shape, device)
    return (((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
            - 1.0)


def lattice_unit(u: torch.Tensor) -> torch.Tensor:
    """Rows of three uniforms to unit vectors: ``floor(u*100) - 50`` in
    [-50, 49] on each axis, normalised (the root correctly rounded); the
    all-zero draw gives +x."""
    v = (torch.floor(u * 100.0).to(torch.int32) - 50).to(torch.float32)
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    mag = torch.sqrt(sq.to(torch.float64)).to(torch.float32)
    ok = mag > 0
    v = torch.where(ok, v / torch.where(ok, mag, 1.0), 0.0)
    px = torch.tensor([1.0, 0.0, 0.0], device=u.device)
    return torch.where(ok, v, px)


def tag_mix(tag: torch.Tensor, frame: int) -> torch.Tensor:
    """A child's tag: ``tag*2654435761 + frame*2246822519 + 977`` mod
    2^32."""
    t = tag & M32
    hi, lo = 2654435761 >> 16, 2654435761 & 0xFFFF
    prod = ((((t * hi) & 0xFFFF) << 16) + t * lo) & M32
    return (prod + ((frame * 2246822519 + 977) & M32)) & M32
