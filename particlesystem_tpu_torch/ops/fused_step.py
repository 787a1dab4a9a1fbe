"""The packed emitter frame over per-field tensors, in plain PyTorch.

Counterpart of ``particlesystem_tpu/ops/fused_step.py``.  State is eight
separate contiguous ``(N,)`` float32 fields ``(x, y, z, vx, vy, vz, age,
life)`` (``packed8``) or seven ``(x, y, z, vx, vy, vz, death)`` (``slim``).

:func:`physics_step` and :func:`physics_step_slim` are the plain versions of
the CUDA physics kernel (``csrc/physics_step.cu``, launched through
``ops/physics_kernel.py``): the kernel is held to them bit for bit on the
card.  Every operation here is one float32 operation per element (torch's
eager kernels never contract a multiply and an add), the scene constants
are rounded to float32 first, and the sphere root is the correctly rounded
one, so the kernel's ``__fmul_rn``/``__fadd_rn``/``__fdiv_rn``/
``__fsqrt_rn`` sequence reproduces these results exactly.

Recycling, the counterparts of the reference's per-segment free-id queues
(``source/code/inc/app_common.cu:305-429``), all on the device with no host
synchronisation:

* ``refresh_free_list`` / ``spawn_exact`` — exact dead-slot compaction;
* ``ring_spawn`` — a ring cursor with a shadow region;
* ``strided_spawn`` — a cursor that advances by the whole padded budget.
  The JAX package's ``select_spawn`` is this allocator over ``(slots/W, W)``
  views, bit for bit, so the engine's ``select`` runs it on flat views.

``ring_spawn`` and ``strided_spawn`` write into the field tensors they are
given (O(S) a frame) and return them; ``spawn_exact`` returns new tensors
(its dropped requests land on a scratch row).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.config import EmitterSceneConfig, PlaneCollider
from .compact import rank_table, write_rows
from .forces import EPS_DIST, sqrt_f32
from .neighbor import as_f32

Fields = Tuple[torch.Tensor, ...]  # x, y, z, vx, vy, vz, age, life


def plane_normal(pl: PlaneCollider) -> np.ndarray:
    """The plane's unit normal, normalised in numpy float32."""
    n = np.asarray(pl.normal, np.float32)
    return n / np.linalg.norm(n)


def integrate6(x, y, z, vx, vy, vz, cfg: EmitterSceneConfig):
    """Forces -> semi-implicit Euler -> plane/sphere response on six bare
    coordinate tensors: the maskless physics core of both layouts."""
    dt = as_f32(cfg.dt)
    gx, gy, gz = (as_f32(v) for v in cfg.gravity)
    if cfg.drag:
        k = as_f32(cfg.drag)
        wx, wy, wz = (as_f32(v) for v in cfg.wind)
        ax, ay, az = gx + (wx - vx) * k, gy + (wy - vy) * k, gz + (wz - vz) * k
        vx1, vy1, vz1 = vx + ax * dt, vy + ay * dt, vz + az * dt
    else:
        # the product of two float32 values is exact in float64, so
        # rounding it once gives the float32 product
        vx1, vy1, vz1 = (vx + as_f32(gx * dt), vy + as_f32(gy * dt),
                         vz + as_f32(gz * dt))
    x1, y1, z1 = x + vx1 * dt, y + vy1 * dt, z + vz1 * dt

    for pl_ in cfg.planes:
        nx, ny, nz = (v.item() for v in plane_normal(pl_))
        px, py, pz = (as_f32(v) for v in pl_.point)
        d = (x1 - px) * nx + (y1 - py) * ny + (z1 - pz) * nz
        contact = d < 0
        x1 = torch.where(contact, x1 - nx * d, x1)
        y1 = torch.where(contact, y1 - ny * d, y1)
        z1 = torch.where(contact, z1 - nz * d, z1)
        vn = vx1 * nx + vy1 * ny + vz1 * nz
        inb = contact & (vn < 0)
        e = as_f32(pl_.restitution)
        mu1 = as_f32(1.0 - pl_.friction)
        vx1 = torch.where(inb, (vx1 - nx * vn) * mu1 - nx * vn * e, vx1)
        vy1 = torch.where(inb, (vy1 - ny * vn) * mu1 - ny * vn * e, vy1)
        vz1 = torch.where(inb, (vz1 - nz * vn) * mu1 - nz * vn * e, vz1)

    for sp in cfg.spheres:
        cx, cy, cz = (as_f32(v) for v in sp.center)
        dxx, dyy, dzz = x1 - cx, y1 - cy, z1 - cz
        dist = sqrt_f32(dxx * dxx + dyy * dyy + dzz * dzz)
        safe = torch.clamp(dist, min=EPS_DIST)
        nx, ny, nz = dxx / safe, dyy / safe, dzz / safe
        depth = as_f32(sp.radius) - dist
        contact = depth > 0
        x1 = torch.where(contact, x1 + nx * depth, x1)
        y1 = torch.where(contact, y1 + ny * depth, y1)
        z1 = torch.where(contact, z1 + nz * depth, z1)
        vn = vx1 * nx + vy1 * ny + vz1 * nz
        inb = contact & (vn < 0)
        e = as_f32(sp.restitution)
        mu1 = as_f32(1.0 - sp.friction)
        vx1 = torch.where(inb, (vx1 - nx * vn) * mu1 - nx * vn * e, vx1)
        vy1 = torch.where(inb, (vy1 - ny * vn) * mu1 - ny * vn * e, vy1)
        vz1 = torch.where(inb, (vz1 - nz * vn) * mu1 - nz * vn * e, vz1)

    return x1, y1, z1, vx1, vy1, vz1


def physics_step(fields: Fields, cfg: EmitterSceneConfig) -> Fields:
    """One physics frame; dead rows (age > life or life <= 0) are frozen."""
    x, y, z, vx, vy, vz, age, life = fields
    alive = (age <= life) & (life > 0)
    new = integrate6(x, y, z, vx, vy, vz, cfg)
    return (*(torch.where(alive, n, o)
              for n, o in zip(new, (x, y, z, vx, vy, vz))),
            torch.where(alive, age + as_f32(cfg.dt), age), life)


def physics_step_slim(fields: Fields, cfg: EmitterSceneConfig) -> Fields:
    """Slim-layout physics frame over ``(x, y, z, vx, vy, vz, death)``.

    ``death`` is the absolute frame index at which the slot stops being
    alive (exact below 2^24); liveness is ``frame < death``, derived and
    never rewritten.  Rows never spawned (``death <= 0``) are frozen;
    expired rows keep integrating, garbage until respawn, so consumers mask
    with :func:`alive_mask_slim`."""
    x, y, z, vx, vy, vz, death = fields
    new = integrate6(x, y, z, vx, vy, vz, cfg)
    m = death > 0
    return (*(torch.where(m, n, o)
              for n, o in zip(new, (x, y, z, vx, vy, vz))), death)


def alive_mask_slim(death: torch.Tensor, frame: int) -> torch.Tensor:
    """Slim liveness: alive while the frame index is below ``death``."""
    return float(frame) < death


# ---------------------------------------------------------------------------
# recycling
# ---------------------------------------------------------------------------


def dead_mask(fields: Fields) -> torch.Tensor:
    age, life = fields[6], fields[7]
    return (age > life) | (life <= 0)


def refresh_free_list(fields: Fields, list_size: int):
    """Up to ``list_size`` dead-slot indices, ascending.  Returns (free_list
    int32 padded with N, n_free int32)."""
    dead = dead_mask(fields)
    free_list = rank_table(dead, list_size).to(torch.int32)
    n_free = torch.clamp(dead.sum(), max=list_size).to(torch.int32)
    return free_list, n_free


def spawn_exact(fields: Fields, rows: Fields, valid: torch.Tensor,
                free_list: torch.Tensor, cursor: torch.Tensor,
                n_free: torch.Tensor):
    """Write spawn rows into free-list slots through ``cursor``: exact
    dead-slot-ascending semantics (``models/emitter.step_core``).  Returns
    (new fields, advanced cursor)."""
    n = fields[0].shape[0]
    lsize = free_list.shape[0]
    req_rank = torch.cumsum(valid, dim=0) - 1
    ok = valid & (cursor + req_rank < n_free)
    tgt = free_list[(cursor + req_rank).clamp(0, lsize - 1)].to(torch.int64)
    tgt = torch.where(ok, tgt, n)
    out = tuple(write_rows(f, tgt, r) for f, r in zip(fields, rows))
    return out, cursor + ok.sum(dtype=torch.int32)


def ring_spawn(fields: Fields, rows: Fields, valid: torch.Tensor,
               cursor: torch.Tensor, n_real: int):
    """Ring-buffer spawn, O(S) a frame.  Each field has ``n_real + S``
    entries; the trailing S are a shadow region, so the window at the cursor
    always fits.  Valid rows are compacted to a prefix and written at the
    cursor; rows that crossed the end are folded onto the head and the
    shadow is cleared (a stale copy would keep ghost particles alive).  The
    fold is branch-free: on a frame that does not wrap it selects nothing
    and keeps the shadow.  Slots are reused in spawn order."""
    s = rows[0].shape[0]
    if fields[0].shape[0] != n_real + s:
        raise ValueError(f"ring fields hold {fields[0].shape[0]} slots, "
                         f"expected {n_real} + shadow {s}")
    dev = valid.device
    rank = torch.cumsum(valid, dim=0) - 1
    nv = valid.sum(dtype=torch.int32)
    compact_tgt = torch.where(valid, rank, s)
    col = torch.arange(s, device=dev)
    wrapped = cursor + nv - n_real

    rows8 = torch.stack(rows, dim=1)                     # (S, n_fields)
    rc8 = torch.zeros((s + 1, len(rows)), device=dev)
    rc8[compact_tgt] = rows8                             # row s: dropped
    take = col < nv
    fold = col < wrapped
    idx = cursor + col
    for i, f in enumerate(fields):
        f[idx] = torch.where(take, rc8[:s, i], f[idx])
        shadow = f[n_real:]
        f[:s] = torch.where(fold, shadow, f[:s])
        f[n_real:] = torch.where(wrapped > 0, 0.0, shadow)
    return fields, torch.remainder(cursor + nv, n_real)


def strided_spawn(fields: Fields, rows: Fields, valid: torch.Tensor,
                  cursor: torch.Tensor, n_real: int):
    """Budget-strided ring spawn: the cursor advances by the whole padded
    budget ``S`` every frame and ``n_real % S == 0``, so the write window
    never wraps.  Invalid budget rows keep the window's residents."""
    s = rows[0].shape[0]
    if n_real % s or fields[0].shape[0] != n_real:
        raise ValueError(f"strided spawn needs {fields[0].shape[0]} == "
                         f"{n_real} slots, a multiple of the budget {s}")
    idx = cursor + torch.arange(s, device=valid.device)
    for f, r in zip(fields, rows):
        f[idx] = torch.where(valid, r, f[idx])
    return fields, torch.remainder(cursor + s, n_real)


def pack_spawn_rows(spawn) -> Fields:
    """SpawnRows -> 8 per-field (S,) tensors (w is not carried: emitter
    forces are per unit mass)."""
    return (spawn.pos[:, 0], spawn.pos[:, 1], spawn.pos[:, 2],
            spawn.vel[:, 0], spawn.vel[:, 1], spawn.vel[:, 2],
            torch.zeros_like(spawn.life), spawn.life)


def pack_spawn_rows_slim(spawn, frame, dt: float) -> Fields:
    """SpawnRows -> 7 slim per-field (S,) tensors; the lifetime becomes the
    absolute death frame ``spawn_frame + life/dt`` (exact below 2^24).
    ``frame`` a Python int or a 0-dim int64 tensor (rounded to float32,
    as the JAX package's ``frame.astype(float32)``)."""
    if isinstance(frame, torch.Tensor):
        frame = frame.to(torch.float32)
    else:
        frame = float(frame)
    death = frame + spawn.life / as_f32(dt)
    return (spawn.pos[:, 0], spawn.pos[:, 1], spawn.pos[:, 2],
            spawn.vel[:, 0], spawn.vel[:, 1], spawn.vel[:, 2], death)
