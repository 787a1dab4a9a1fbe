"""The emitter physics step as one kernel launch: wrapper of
``csrc/physics_step.cu``.

Counterpart of ``particlesystem_tpu/ops/pallas_step.py``
(``physics_step_pallas``, the TPU kernel): the same contract as
``ops/fused_step.physics_step``, over the engine's per-field tensors.

:func:`physics_step` is the engine's entry: CUDA tensors launch the kernel
(:func:`physics_step_cuda`), CPU tensors take the plain version
(:func:`physics_step_plain`).  Both layouts run through it, ``packed8``
(8 fields) and ``slim`` (7), and so does the strided/select spawn write:
given ``window=(rows, valid, cursor)`` the slots ``[cursor, cursor + W)``
take ``valid[i - cursor] ? rows[:, i - cursor] : physics(i)``, so a frame of
those allocators is one launch, with the cursor read on the device.

On CUDA the kernel updates the fields in place (each slot reads and writes
only its own row) and returns the same tensors; the plain version returns
new ones.  Callers use the returned fields.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import EmitterSceneConfig
from ..utils.cuda_build import by_device, launch
from . import fused_step as fs

MAX_PLANES = 8
MAX_SPHERES = 8


def scene_params(cfg: EmitterSceneConfig) -> np.ndarray:
    """The kernel's scene constants as float32: dt, gravity, wind, drag,
    then 8 per plane (unit normal, point, restitution, 1 - friction) and 6
    per sphere (center, radius, restitution, 1 - friction).  Each value is
    rounded to float32 here, as the plain version rounds it."""
    if len(cfg.planes) > MAX_PLANES or len(cfg.spheres) > MAX_SPHERES:
        raise ValueError(f"the physics kernel takes at most {MAX_PLANES} "
                         f"planes and {MAX_SPHERES} spheres, the scene has "
                         f"{len(cfg.planes)} and {len(cfg.spheres)}")
    vals = [cfg.dt, *cfg.gravity, *cfg.wind, cfg.drag]
    out = [np.asarray(vals, np.float32)]
    for pl in cfg.planes:
        out.append(fs.plane_normal(pl))
        out.append(np.asarray([*pl.point, pl.restitution, 1.0 - pl.friction],
                              np.float32))
    for sp in cfg.spheres:
        out.append(np.asarray([*sp.center, sp.radius, sp.restitution,
                               1.0 - sp.friction], np.float32))
    return np.ascontiguousarray(np.concatenate(out), np.float32)


def _check(fields, window):
    if len(fields) not in (7, 8):
        raise ValueError(f"physics step takes 8 (packed8) or 7 (slim) "
                         f"fields, got {len(fields)}")
    n = fields[0].shape[0]
    dev = fields[0].device
    for f in fields:
        if (f.device != dev or f.dtype != torch.float32 or f.dim() != 1
                or f.shape[0] != n or not f.is_contiguous()):
            raise ValueError("fields must be contiguous float32 (N,) tensors "
                             "of one length on one device")
    if window is None:
        return
    rows, valid, cursor = window
    w = valid.shape[0] if valid.dim() == 1 else -1
    if (rows.device != dev or rows.dtype != torch.float32
            or rows.shape != (len(fields), w) or not rows.is_contiguous()):
        raise ValueError(f"window rows must be contiguous float32 "
                         f"({len(fields)}, W) on the fields' device")
    if (valid.device != dev or valid.dtype != torch.bool
            or not valid.is_contiguous()):
        raise ValueError("window valid must be a contiguous bool (W,) tensor "
                         "on the fields' device")
    if (cursor.device != dev or cursor.dtype != torch.int32
            or cursor.numel() != 1):
        raise ValueError("window cursor must be one int32 on the fields' "
                         "device")
    if not 0 < w <= n or n % w:
        raise ValueError(f"window width {w} must divide the {n} slots")


def physics_step_plain(fields, cfg: EmitterSceneConfig, window=None):
    """Plain PyTorch version of the kernel, same contract (new tensors,
    the cursor not advanced)."""
    _check(fields, window)
    if len(fields) == 7:
        out = fs.physics_step_slim(fields, cfg)
    else:
        out = fs.physics_step(fields, cfg)
    if window is not None:
        rows, valid, cursor = window
        out, _ = fs.strided_spawn(out, tuple(rows), valid, cursor,
                                  fields[0].shape[0])
    return out


def physics_step_cuda(fields, cfg: EmitterSceneConfig, window=None):
    """Launch the CUDA physics kernel on the current stream; updates
    ``fields`` in place and returns them.  ``window`` as in the module
    docstring; its cursor must lie in ``[0, N - W]``."""
    _check(fields, window)
    scene = scene_params(cfg)
    slim = len(fields) == 7
    ptrs = [f.data_ptr() for f in fields] + ([None] if slim else [])
    rows = valid = cursor = None
    w = 0
    if window is not None:
        rows, valid, cursor = (t.data_ptr() for t in window)
        w = window[1].shape[0]
    launch("ps_physics_step", fields[0].device, *ptrs, fields[0].shape[0],
           int(slim), scene.ctypes.data, len(cfg.planes), len(cfg.spheres),
           rows, valid, w, cursor)
    return fields


def physics_step(fields, cfg: EmitterSceneConfig, window=None):
    """One physics frame (and the spawn window, if given) of the engine's
    fields: the kernel for CUDA tensors, the plain version for CPU ones."""
    return by_device(fields[0], "physics kernel", physics_step_cuda,
                     physics_step_plain)(fields, cfg, window)
