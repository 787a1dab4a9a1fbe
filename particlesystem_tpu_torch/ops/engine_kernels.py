"""The emitter engine's frame around the physics kernel in three kernels:
wrapper of ``csrc/emitter_frame.cu``.

Counterpart of XLA's fusions of the JAX engine's jitted frame
(``particlesystem_tpu/runtime/engine.py::_frame``; there is no Pallas
kernel): everything the frame computes outside the physics kernel.

* :func:`spawn_window` — the frame's spawn rows, padded to the window the
  physics kernel reads: the threefry draws and ``models/emitter.
  spawn_fields`` in one launch, one thread a row, packed as
  ``fused_step.pack_spawn_rows`` (packed8) or ``pack_spawn_rows_slim``
  (slim) and zero-padded to the spawn width; ``valid``; the emitters'
  next ``accum`` into a scratch (every row reads ``accum`` while the
  kernel runs).
* :func:`ring_write` — the ring allocator's write of the window
  (``fused_step.ring_spawn``): the valid rows ranked by a block scan and
  written at the cursor, the wrap folded onto the head, the cursor
  advanced by the valid count; one block.
* :func:`frame_tail` — the frame's bookkeeping after the physics kernel:
  ``accum`` from the scratch, the strided/select cursor advanced by the
  spawn width, the device frame one on.

Each is a dispatcher (``utils/cuda_build.by_device``): CUDA tensors
launch the kernel (``*_cuda``), CPU tensors take the plain version
(``*_plain``, the torch code the kernel replaces); any other device
raises, and so does a failed launch.  All three write into buffers they
are given: the engine's window, its state's cursor and accum, its frame
(``runtime/engine.PackedEngine``), so a CUDA graph of a frame replays
them with no copy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import rng
from ..core.config import EmitterSceneConfig
from ..models import emitter as em
from ..utils.cuda_build import by_device, launch
from . import fused_step as fs
from .rng_kernel import frame_on


class Window(NamedTuple):
    """A frame's spawn window: ``rows`` (n_fields, W) float32, ``valid``
    (W,) bool, and the emitters' next ``accum`` (max(1, E),) float32."""

    rows: torch.Tensor
    valid: torch.Tensor
    accum: torch.Tensor


def new_window(n_fields: int, width: int, n_accum: int, device) -> Window:
    """Zeroed window buffers on ``device``."""
    return Window(torch.zeros((n_fields, width), device=device),
                  torch.zeros((width,), dtype=torch.bool, device=device),
                  torch.zeros((n_accum,), device=device))


def pad_window(rows, valid: torch.Tensor, width: int):
    """Spawn rows (a sequence of (S,) fields) as one (n_fields, W) tensor
    and valid as (W,), zero-padded to the spawn width ``W``."""
    rows = torch.stack(tuple(rows))
    pad = width - rows.shape[1]
    if pad < 0:
        raise ValueError(f"{rows.shape[1]} spawn rows outgrow the window of "
                         f"{width}")
    if pad:
        rows = torch.cat([rows, rows.new_zeros((rows.shape[0], pad))], 1)
        valid = torch.cat([valid, valid.new_zeros((pad,))])
    return rows, valid


# --- the spawn window -----------------------------------------------------------

def spawn_rows_plain(cfg: EmitterSceneConfig, table: em.SpawnTable,
                     accum: torch.Tensor, frame, salt: int, slim: bool):
    """(rows, valid, next accum) of the frame, unpadded: ``spawn_fields``
    and ``pack_spawn_rows(_slim)``; ``frame`` a Python int or a 0-dim int64
    tensor on ``accum``'s device."""
    spawn, accum = em.spawn_fields(cfg, frame, accum, salt, table=table)
    if slim:
        rows = fs.pack_spawn_rows_slim(spawn, frame, cfg.dt)
    else:
        rows = fs.pack_spawn_rows(spawn)
    return rows, spawn.valid, accum


def spawn_window_plain(cfg: EmitterSceneConfig, table: em.SpawnTable,
                       accum: torch.Tensor, frame, salt: int, n_fields: int,
                       width: int) -> Window:
    """Plain PyTorch version of the spawn kernel: a new :class:`Window`."""
    rows, valid, accum = spawn_rows_plain(cfg, table, accum, frame, salt,
                                          n_fields == 7)
    return Window(*pad_window(rows, valid, width), accum)


def _check_window(cfg, table, accum, out: Window):
    rows, valid, acc = out
    dev = accum.device
    if len(cfg.emitters) != len(table.budgets):
        raise ValueError("the spawn table is another scene's")
    n_accum = max(1, len(cfg.emitters))
    for t, dtype, shape in ((accum, torch.float32, (n_accum,)),
                            (acc, torch.float32, (n_accum,)),
                            (valid, torch.bool, (rows.shape[-1],))):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"spawn window: a contiguous {dtype} {shape} "
                             f"tensor on {dev} expected, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if (rows.device != dev or rows.dtype != torch.float32 or rows.dim() != 2
            or rows.shape[0] not in (7, 8) or not rows.is_contiguous()):
        raise ValueError(f"spawn window rows must be contiguous float32 "
                         f"(7 or 8, W) on {dev}")
    if rows.shape[1] < max(1, table.total):
        raise ValueError(f"{table.total} spawn rows outgrow the window of "
                         f"{rows.shape[1]}")


def spawn_window_cuda(cfg: EmitterSceneConfig, table: em.SpawnTable,
                      accum: torch.Tensor, frame, salt: int,
                      out: Window) -> Window:
    """Launch ``ps_emitter_spawn`` on the current stream into ``out`` (the
    frame read on the device, :func:`~.rng_kernel.frame_on`)."""
    _check_window(cfg, table, accum, out)
    dev = accum.device
    if table.packed.device != dev:
        raise ValueError(f"the spawn table lies on {table.packed.device}, "
                         f"the window on {dev}")
    frame = frame_on(frame, dev)
    rows, valid, acc = out
    slim = rows.shape[0] == 7
    inv_dt = float(np.float32(1.0) / np.float32(cfg.dt))
    launch("ps_emitter_spawn", dev, table.packed.data_ptr(),
           table.row_emitter.data_ptr(), table.total, len(cfg.emitters),
           accum.data_ptr(), acc.data_ptr(), frame.data_ptr(),
           *rng._purpose_key(cfg.seed, rng.EMIT), int(salt) & rng.M32,
           rows.data_ptr(), valid.data_ptr(), rows.shape[1], int(slim),
           inv_dt)
    return out


def _spawn_window_cpu(cfg, table, accum, frame, salt, out: Window) -> Window:
    _check_window(cfg, table, accum, out)
    got = spawn_window_plain(cfg, table, accum, frame, salt,
                             out.rows.shape[0], out.rows.shape[1])
    for dst, src in zip(out, got):
        dst.copy_(src)
    return out


def spawn_window(cfg: EmitterSceneConfig, table: em.SpawnTable,
                 accum: torch.Tensor, frame, salt: int, out: Window) -> Window:
    """The frame's spawn window into ``out``: the kernel for CUDA tensors,
    the plain version (copied in) for CPU ones."""
    return by_device(accum, "emitter spawn kernel", spawn_window_cuda,
                     _spawn_window_cpu)(cfg, table, accum, frame, salt,
                                        out)


# --- the ring allocator's write -----------------------------------------------

def _check_ring(fields, rows, valid, cursor, n_real: int):
    w = valid.shape[0]
    dev = valid.device
    if len(fields) != rows.shape[0] or len(fields) not in (7, 8):
        raise ValueError(f"ring write takes 7 or 8 fields and as many rows, "
                         f"got {len(fields)} and {rows.shape[0]}")
    for f in fields:
        if (f.device != dev or f.dtype != torch.float32 or f.dim() != 1
                or f.shape[0] != n_real + w or not f.is_contiguous()):
            raise ValueError(f"ring fields must be contiguous float32 "
                             f"({n_real} + {w},) tensors on {dev}")
    if (rows.device != dev or rows.dtype != torch.float32
            or tuple(rows.shape[1:]) != (w,) or not rows.is_contiguous()
            or valid.dtype != torch.bool or not valid.is_contiguous()):
        raise ValueError("ring window: contiguous float32 rows (n_fields, W) "
                         "and bool valid (W,) expected")
    if (cursor.device != dev or cursor.dtype != torch.int32
            or cursor.dim() != 0):
        raise ValueError("the ring cursor must be a 0-dim int32 tensor on "
                         "the fields' device")


def ring_write_plain(fields, rows, valid, cursor, n_real: int):
    """Plain PyTorch version of the ring kernel: ``fused_step.ring_spawn``
    into ``fields``, the cursor advanced in place; returns ``fields``."""
    _check_ring(fields, rows, valid, cursor, n_real)
    fields, nxt = fs.ring_spawn(tuple(fields), tuple(rows), valid, cursor,
                                n_real)
    cursor.copy_(nxt)
    return fields


def ring_write_cuda(fields, rows, valid, cursor, n_real: int):
    """Launch ``ps_emitter_ring`` on the current stream."""
    _check_ring(fields, rows, valid, cursor, n_real)
    ptrs = [f.data_ptr() for f in fields] + [None] * (8 - len(fields))
    launch("ps_emitter_ring", valid.device, *ptrs, len(fields), n_real,
           rows.data_ptr(), valid.data_ptr(), valid.shape[0],
           cursor.data_ptr())
    return fields


def ring_write(fields, rows, valid, cursor, n_real: int):
    """The ring allocator's write of the window into ``fields`` (their
    ``n_real`` slots and a shadow of the window's width), the cursor
    advanced in place: the kernel for CUDA tensors, the plain version for
    CPU ones."""
    return by_device(valid, "emitter ring kernel", ring_write_cuda,
                     ring_write_plain)(fields, rows, valid, cursor,
                                       n_real)


# --- the frame's bookkeeping --------------------------------------------------

def _check_tail(accum, accum_next, cursor, frame, advance: int, slots: int):
    dev = accum.device
    for t, dtype, shape in ((accum, torch.float32, tuple(accum.shape)),
                            (accum_next, torch.float32, tuple(accum.shape)),
                            (cursor, torch.int32, ()),
                            (frame, torch.int64, ())):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"frame tail: a contiguous {dtype} {shape} "
                             f"tensor on {dev} expected, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if accum.dim() != 1 or advance < 0 or (advance and slots <= 0):
        raise ValueError(f"frame tail: accum (E,), advance {advance} >= 0 "
                         f"and slots {slots} > 0 expected")


def frame_tail_plain(accum, accum_next, cursor, frame, advance: int,
                     slots: int) -> None:
    """Plain PyTorch version of the tail kernel: the torch lines it
    replaces, in place."""
    _check_tail(accum, accum_next, cursor, frame, advance, slots)
    accum.copy_(accum_next)
    if advance:
        cursor.copy_(torch.remainder(cursor + advance, slots))
    frame.add_(1)


def frame_tail_cuda(accum, accum_next, cursor, frame, advance: int,
                    slots: int) -> None:
    """Launch ``ps_emitter_tail`` on the current stream."""
    _check_tail(accum, accum_next, cursor, frame, advance, slots)
    launch("ps_emitter_tail", accum.device, accum.data_ptr(),
           accum_next.data_ptr(), accum.shape[0], cursor.data_ptr(),
           advance, slots, frame.data_ptr())


def frame_tail(accum, accum_next, cursor, frame, advance: int,
               slots: int) -> None:
    """The frame's bookkeeping, in place: ``accum <- accum_next``; the
    cursor ``<- (cursor + advance) mod slots`` when ``advance`` is not 0;
    ``frame <- frame + 1``.  The kernel for CUDA tensors, the plain
    version for CPU ones."""
    return by_device(accum, "emitter tail kernel", frame_tail_cuda,
                     frame_tail_plain)(accum, accum_next, cursor, frame,
                                       advance, slots)
