"""Deterministic counter-based randomness, bit for bit JAX's threefry.

Counterpart of ``particlesystem_tpu/core/rng.py``.  Every draw is threefry2x32
keyed on ``(seed, frame, purpose)`` and, per particle, on its persistent
tag, so trajectories are reproducible and independent of slot placement.
This module reproduces ``jax.random`` as jax 0.9 computes it with
``jax_threefry_partitionable`` on (its default):

* ``key(seed)``        — the raw key ``(seed >> 32, seed & 0xFFFFFFFF)``;
* ``fold_in(k, d)``    — ``threefry2x32(k, (0, d))``;
* ``split(k, num)``    — key ``i`` is ``threefry2x32(k, (0, i))``;
* random bits          — element ``i`` of a draw is ``b1 ^ b2`` of
  ``threefry2x32(k, (i >> 32, i & 0xFFFFFFFF))``;
* ``uniform``          — ``bitcast_f32((bits >> 9) | 0x3F800000) - 1``.

uint32 values live in int64 tensors (or Python ints) and every operation
masks back to 32 bits; no product exceeds 2^63.  Keys are ``(k1, k2)``
pairs of Python ints (computed on the host) or int64 tensors (computed on
the device: per-tag keys, and frame keys of a frame index held on the
device as a 0-dim tensor, JAX's traced ``int32``).  A frame index enters
as a Python int or a 0-dim int64 tensor, and both give the same bits.

:class:`FrameKey` names a key that depends on the frame without the
frame: the purpose key, then the frame, then up to two constant words
folded in.  That is what the threefry kernel (``ops/rng_kernel.py``)
takes, so a CUDA graph that reads the frame from device memory draws each
replay's own randomness.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

# Purpose tags folded into the per-frame key so independent random fields
# never alias.
UVEC = 0
FERT = 1
EMIT = 2
FILL = 3

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pair ``(x1, x2)``
    under key ``(k1, k2)``; operands broadcast, uint32 values in Python ints
    or int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def key(seed: int):
    return ((seed >> 32) & M32, seed & M32)


def fold_in(k, data):
    """``jax.random.fold_in``; ``data`` a Python int or an int64 tensor of
    uint32 values (one derived key per element)."""
    return threefry2x32(k[0], k[1], 0, data & M32)


def split(k, num: int):
    """``jax.random.split`` of a host key into ``num`` host keys."""
    return [threefry2x32(k[0], k[1], 0, i) for i in range(num)]


@functools.lru_cache(maxsize=256)
def _purpose_key(seed: int, purpose: int):
    return fold_in(key(seed), purpose)


def frame_key(seed: int, frame, purpose: int):
    """``fold_in(fold_in(key(seed), purpose), frame)``; the first hash,
    the same every frame, is computed once (a hash of host ints takes
    some 16 microseconds of Python).  ``frame`` a Python int gives a host
    key, a 0-dim tensor a key of 0-dim tensors."""
    return fold_in(_purpose_key(seed, purpose), frame)


#: constant words a :class:`FrameKey` folds in after the frame
MAX_WORDS = 2


@dataclasses.dataclass(frozen=True)
class FrameKey:
    """``fold_in(... fold_in(frame_key(seed, frame, purpose), words[0])
    ..., words[-1])``, given the frame: the spawn draws' ``fold_in(base,
    salt)`` and ``fold_in(.., 1)``, ``init_fill``'s ``split(k, 4)[i]``
    (``split(k)[i]`` is ``fold_in(k, i)``)."""

    seed: int
    purpose: int
    words: tuple = ()

    def __post_init__(self):
        if len(self.words) > MAX_WORDS:
            raise ValueError(f"a frame key folds in at most {MAX_WORDS} "
                             f"words, got {len(self.words)}")

    def fold(self, word: int) -> "FrameKey":
        return FrameKey(self.seed, self.purpose, self.words + (int(word),))

    @property
    def purpose_key(self):
        return _purpose_key(self.seed, self.purpose)

    def at(self, frame):
        """The key at ``frame`` (an int: host ints; a 0-dim tensor:
        0-dim tensors)."""
        k = frame_key(self.seed, frame, self.purpose)
        for w in self.words:
            k = fold_in(k, w)
        return k


def random_bits(k, shape, device) -> torch.Tensor:
    """32-bit draws of ``shape`` (int64 tensor of uint32 values).  A key of
    int64 tensors of shape ``(T,)`` gives one draw of ``shape`` per key,
    stacked to ``(T, *shape)``; a key of 0-dim tensors draws as a host key
    does."""
    count = torch.arange(math.prod(shape), dtype=torch.int64,
                         device=device).reshape(shape)
    k1, k2 = k
    if isinstance(k1, torch.Tensor) and k1.dim():
        expand = (-1,) + (1,) * len(shape)
        k1, k2 = k1.reshape(expand), k2.reshape(expand)
    b1, b2 = threefry2x32(k1, k2, count >> 32, count & M32)
    return b1 ^ b2


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 draws to float32 uniforms in [0, 1): mantissa fill under a
    unit exponent, minus one (``jax.random.uniform``)."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def uniform01(k, shape, device) -> torch.Tensor:
    return bits_to_unit(random_bits(k, shape, device))


def uniform(k, shape, lo, hi, device) -> torch.Tensor:
    """``min + u*(max-min)`` with ``u ~ U[0,1)`` — get_random_number
    (``app.cu:295-299``)."""
    return lo + uniform01(k, shape, device) * (hi - lo)


def tag_mix(tag: torch.Tensor, frame) -> torch.Tensor:
    """Child tag from (parent tag, frame): ``tag*2654435761 +
    frame*2246822519 + 977`` mod 2^32 (Knuth multiplicative mixing), the
    frame a Python int or a 0-dim int64 tensor below 2^31 (JAX's int32).
    The tag product is split at 16 bits of the multiplier so every int64
    product stays below 2^48."""
    m = 2654435761
    t = tag & M32
    prod = ((((t * (m >> 16)) & 0xFFFF) << 16) + t * (m & 0xFFFF)) & M32
    return (prod + ((frame * 2246822519 + 977) & M32)) & M32


def _per_tag_u01(k, tags: torch.Tensor, n_draws: int) -> torch.Tensor:
    """(len(tags), n_draws) uniforms, each row keyed by ``fold_in(k, tag)``."""
    return uniform01(fold_in(k, tags), (n_draws,), tags.device)


def per_tag_uniform(k, tags: torch.Tensor, lo, hi) -> torch.Tensor:
    u = _per_tag_u01(k, tags, 1)[:, 0]
    return lo + u * (hi - lo)


def per_tag_unit_vectors(k, tags: torch.Tensor) -> torch.Tensor:
    """Per-tag random unit vectors (integer-lattice construction,
    ``app.cu:301-316``)."""
    return _lattice_unit(_per_tag_u01(k, tags, 3))


def random_unit_vectors(k, n: int, device) -> torch.Tensor:
    """``(n, 3)`` random unit vectors from one uniform draw under ``k``
    (integer-lattice construction, ``app.cu:301-316``)."""
    return _lattice_unit(uniform01(k, (n, 3), device))


def _lattice_unit(u: torch.Tensor) -> torch.Tensor:
    """Three ints ``floor(u*100) - 50`` in [-50, 49], normalized; the
    all-zero draw (the reference divides by zero) falls back to +x."""
    vec = (torch.floor(u * 100.0).to(torch.int32) - 50).to(torch.float32)
    # the square root is taken in float64 and rounded once to float32: that
    # is the correctly rounded float32 root on every device (torch's CPU
    # float32 sqrt can be one ulp off, which would flip the direction bits)
    sq = torch.sum(vec * vec, dim=1, keepdim=True)
    mag = torch.sqrt(sq.to(torch.float64)).to(torch.float32)
    safe = mag > 0
    vec = torch.where(safe, vec / torch.where(safe, mag, 1.0), 0.0)
    plus_x = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32,
                          device=u.device)
    return torch.where(safe, vec, plus_x)
