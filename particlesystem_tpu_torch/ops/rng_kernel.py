"""Each frame's random fields in one kernel launch: wrapper of
``csrc/threefry.cu``.

Counterpart of XLA's fused draw of the JAX package's random fields
(``particlesystem_tpu/core/rng.py:53``, ``_per_tag_u01`` under ``jit``;
there is no Pallas kernel): the threefry of ``core/rng.py``, bit for bit,
with every hash of a field in one launch instead of some 170 int64 tensor
operations a hash.

Two functions, each a dispatcher (``utils/cuda_build.by_device``): CUDA
tensors (or a CUDA ``device``) launch the kernel, CPU ones take the plain
version, built on ``core/rng.py``; any other device raises.  A third entry
point writes a whole state rather than fields:

* :func:`nbody_fields` — the n-body frame's per-tag fields (what
  ``models/nbody.frame_fields`` returns): the explosion unit vector under
  ``fold_in(frame_key(seed, frame, UVEC), tag)`` and the child fertility
  age ``lo + u*(hi - lo)`` under ``fold_in(frame_key(seed, frame, FERT),
  tag)``, one thread a tag.
* :func:`flat_fields` — up to four flat draws in one launch, each a
  :class:`Draw`: uniforms (:func:`u01`), ``lo + u*(hi - lo)``
  (:func:`uniform`) or lattice unit vectors (:func:`unit_vectors`); the
  emitter's spawn rows take theirs here.
* :func:`nbody_fill_cuda` — ``models/nbody.init_fill`` on a card: a fresh
  state of every slot in one launch, handed its draws' keys and ranges as
  scalars (:class:`Fill`); its plain version is
  ``models/nbody.init_fill_plain``, which the CPU runs.

The frame enters as a 0-dim int64 tensor on the card (a Python int is
put there first): the kernel reads it from device memory and derives the
frame's keys in each block, so a CUDA graph of a frame draws each replay's
own randomness.  What does not change from frame to frame, the purpose
keys and the words folded in after the frame (:class:`~..core.rng.FrameKey`),
travels in the kernel's parameters.  ``lo`` and ``hi - lo`` are rounded to
float32 on the host, as torch rounds a Python scalar before a float32
tensor operation.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import rng
from ..core.state import FIELDS, ParticleState
from ..utils.cuda_build import by_device, launch

UNIT, AFFINE, LATTICE = 0, 1, 2
MAX_DRAWS = 4
#: counters of one draw must fit the low word of the 64-bit counter
MAX_COUNTERS = 1 << 32


@dataclasses.dataclass(frozen=True)
class Draw:
    """One flat draw under ``key`` at the frame of the launch: ``shape``
    floats (``UNIT``, ``AFFINE``) or ``shape[0]`` lattice unit vectors of 3
    floats (``LATTICE``)."""

    key: rng.FrameKey
    shape: tuple
    kind: int = UNIT
    lo: float = 0.0
    hi: float = 1.0

    @property
    def items(self) -> int:
        """Kernel items: one a float, or one a lattice row."""
        return math.prod(self.shape)

    @property
    def counters(self) -> int:
        return self.items * (3 if self.kind == LATTICE else 1)

    @property
    def out_shape(self) -> tuple:
        return (*self.shape, 3) if self.kind == LATTICE else self.shape


def u01(key: rng.FrameKey, shape) -> Draw:
    """``rng.uniform01(key.at(frame), shape)``."""
    return Draw(key, tuple(shape), UNIT)


def uniform(key: rng.FrameKey, shape, lo: float, hi: float) -> Draw:
    """``rng.uniform(key.at(frame), shape, lo, hi)``."""
    return Draw(key, tuple(shape), AFFINE, lo, hi)


def unit_vectors(key: rng.FrameKey, n: int) -> Draw:
    """``rng.random_unit_vectors(key.at(frame), n)``, (n, 3)."""
    return Draw(key, (n,), LATTICE)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def frame_on(frame, device: torch.device) -> torch.Tensor:
    """``frame`` as the kernel reads it: a 0-dim int64 tensor on
    ``device``.  A Python int is filled in there (a fill kernel, no copy
    from the host)."""
    if isinstance(frame, torch.Tensor):
        if (frame.dtype != torch.int64 or frame.dim() != 0
                or frame.device != device):
            raise ValueError(f"the frame must be a 0-dim int64 tensor on "
                             f"{device}, got {frame.dtype} "
                             f"{tuple(frame.shape)} on {frame.device}")
        return frame
    return torch.full((), int(frame), dtype=torch.int64, device=device)


def _check_tags(tags: torch.Tensor):
    if tags.dtype != torch.int64 or tags.dim() != 1:
        raise ValueError(f"tags must be an int64 (T,) tensor, got "
                         f"{tags.dtype} {tuple(tags.shape)}")


def _check_draws(draws):
    if not 1 <= len(draws) <= MAX_DRAWS:
        raise ValueError(f"one launch takes 1 to {MAX_DRAWS} draws, got "
                         f"{len(draws)}")
    for d in draws:
        if d.kind not in (UNIT, AFFINE, LATTICE):
            raise ValueError(f"unknown draw kind {d.kind}")
        if not isinstance(d.key, rng.FrameKey):
            raise ValueError(f"a draw's key is a FrameKey, got {d.key!r}")
        if d.kind == LATTICE and len(d.shape) != 1:
            raise ValueError("a lattice draw takes a shape (n,)")
        if d.counters >= MAX_COUNTERS:
            raise ValueError(f"a draw of {d.counters} elements reaches "
                             f"2^32; the kernel takes fewer")


# --- the n-body frame's per-tag fields ----------------------------------------

def nbody_fields_plain(seed: int, frame, tags: torch.Tensor, lo: float,
                       hi: float):
    """Plain PyTorch version of the kernel: (uvec (T, 3), fert (T,));
    ``frame`` a Python int or a 0-dim int64 tensor, the same bits."""
    _check_tags(tags)
    uvec = rng.per_tag_unit_vectors(rng.frame_key(seed, frame, rng.UVEC),
                                    tags)
    fert = rng.per_tag_uniform(rng.frame_key(seed, frame, rng.FERT), tags,
                               lo, hi)
    return uvec, fert


def nbody_fields_cuda(seed: int, frame, tags: torch.Tensor, lo: float,
                      hi: float):
    """Launch ``ps_nbody_frame_fields`` on the current stream, the frame
    read on the device (:func:`frame_on`)."""
    _check_tags(tags)
    dev = tags.device
    tags = tags.contiguous()
    n = tags.shape[0]
    uvec = torch.empty((n, 3), dtype=torch.float32, device=dev)
    fert = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return uvec, fert
    frame = frame_on(frame, dev)
    launch("ps_nbody_frame_fields", dev, tags.data_ptr(), n,
           uvec.data_ptr(), fert.data_ptr(), frame.data_ptr(),
           *rng._purpose_key(seed, rng.UVEC),
           *rng._purpose_key(seed, rng.FERT),
           float(np.float32(lo)), float(np.float32(hi - lo)))
    return uvec, fert


def nbody_fields(seed: int, frame, tags: torch.Tensor, lo: float,
                 hi: float):
    """The n-body frame's random fields of ``tags``: the kernel for a CUDA
    tensor, the plain version for a CPU one."""
    return by_device(tags, "threefry kernel", nbody_fields_cuda,
                     nbody_fields_plain)(seed, frame, tags, lo, hi)


# --- flat draws -----------------------------------------------------------------

def flat_fields_plain(draws, frame, device) -> list:
    """Plain PyTorch version of the kernel: one tensor a draw; ``frame`` a
    Python int or a 0-dim int64 tensor, the same bits."""
    _check_draws(draws)
    out = []
    for d in draws:
        k = d.key.at(frame)
        if d.kind == LATTICE:
            out.append(rng.random_unit_vectors(k, d.shape[0], device))
        elif d.kind == AFFINE:
            out.append(rng.uniform(k, d.shape, d.lo, d.hi, device))
        else:
            out.append(rng.uniform01(k, d.shape, device))
    return out


def flat_fields_cuda(draws, frame, device) -> list:
    """Launch ``ps_flat_fields`` on the current stream for every draw at
    once, the frame read on the device (:func:`frame_on`); returns one view
    a draw of one float32 buffer."""
    _check_draws(draws)
    dev = _device(device)
    sizes = [math.prod(d.out_shape) for d in draws]
    buf = torch.empty((sum(sizes),), dtype=torch.float32, device=dev)
    if sum(sizes):
        frame = frame_on(frame, dev)
        keys = np.asarray([d.key.purpose_key for d in draws], np.uint32)
        n_words = np.asarray([len(d.key.words) for d in draws], np.int32)
        words = np.asarray([d.key.words + (0,) * (rng.MAX_WORDS
                                                  - len(d.key.words))
                            for d in draws], np.int64) & rng.M32
        words = words.astype(np.uint32)
        items = np.asarray([d.items for d in draws], np.int64)
        kinds = np.asarray([d.kind for d in draws], np.int32)
        affine = np.asarray([(d.lo, d.hi - d.lo) for d in draws], np.float32)
        launch("ps_flat_fields", dev, buf.data_ptr(), len(draws),
               frame.data_ptr(), keys.ctypes.data, n_words.ctypes.data,
               words.ctypes.data, items.ctypes.data, kinds.ctypes.data,
               affine.ctypes.data)
    return [part.view(d.out_shape)
            for part, d in zip(torch.split(buf, sizes), draws)]


def flat_fields(draws, frame, device) -> list:
    """The draws at ``frame`` on ``device``, one tensor a draw: the kernel
    for a CUDA device, the plain version for the CPU."""
    dev = torch.device(device)
    return by_device(dev, "threefry kernel", flat_fields_cuda,
                     flat_fields_plain)(draws, frame, dev)


# --- a fresh n-body state -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Fill:
    """What ``ps_nbody_fill`` is handed for a state of ``slots`` slots, the
    first ``n`` drawn at frame 0 (the kernel's constant): the purpose key,
    the word each of the four draws (r, u_sign, age, life) folds in after
    the frame, and float32 values: the box's half extent, the weight, and
    ``(lo, hi - lo)`` of the age and of the fertility age."""

    key: tuple
    words: tuple
    n: int
    slots: int
    half_extent: float
    weight: float
    age: tuple
    life: tuple


def nbody_fill_cuda(fill: Fill, device) -> ParticleState:
    """Launch ``ps_nbody_fill`` on the current stream into nine tensors
    from ``torch.empty``."""
    dev = _device(device)
    slots, n = fill.slots, fill.n
    if not 0 <= n <= slots:
        raise ValueError(f"{n} particles do not fit {slots} slots")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    st = ParticleState(
        pos=empty(slots, 3), vel=empty(slots, 3), acc=empty(slots, 3),
        w=empty(slots), age=empty(slots), life=empty(slots),
        alive=empty(slots, dtype=torch.bool),
        parent=empty(slots, dtype=torch.bool),
        tag=empty(slots, dtype=torch.int64))
    if slots:
        launch("ps_nbody_fill", dev,
               *(getattr(st, f).data_ptr() for f in FIELDS),
               n, slots, *fill.key, *fill.words, fill.half_extent,
               fill.weight, *fill.age, *fill.life)
    return st
