"""Emitter scenes: spawn rows from counter-based keys, and the reference
step.

Counterpart of ``particlesystem_tpu/models/emitter.py``.  Randomness is
factored out of the physics: :func:`spawn_fields` derives every frame's
spawn rows from threefry keyed on ``(seed, frame, salt)`` (bit for bit the
JAX package's draws), and :func:`step_core` is a deterministic function of
(state, spawn rows) over a :class:`~..core.state.ParticleState`: the
reference that the engine's packed frame (``runtime/engine.py``) is held to.

The per-row parameter columns of a scene are built once, on the host, into
a :class:`SpawnTable` on the device; a frame's spawn rows are then device
work only, with no host synchronisation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import rng
from ..core.config import Emitter, EmitterSceneConfig
from ..core.state import ParticleState
from ..ops import compact, rng_kernel
from ..ops.forces import accel, collide, sqrt_f32
from ..ops.neighbor import as_f32

TWO_PI = as_f32(2.0 * math.pi)


@dataclasses.dataclass
class SpawnRows:
    """Per-frame spawn requests, statically sized to the scene's budget."""

    pos: torch.Tensor    # (S, 3)
    vel: torch.Tensor    # (S, 3)
    life: torch.Tensor   # (S,)
    w: torch.Tensor      # (S,)
    valid: torch.Tensor  # (S,) bool


def emitter_budget(e: Emitter, dt: float) -> int:
    return int(math.ceil(e.rate * dt)) + 1


def _basis(direction) -> np.ndarray:
    """Static orthonormal basis (d, e1, e2) for the cone sampler."""
    d = np.asarray(direction, np.float32)
    d = d / np.linalg.norm(d)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    if abs(float(np.dot(d, up))) > 0.9:
        up = np.array([1.0, 0.0, 0.0], np.float32)
    e1 = np.cross(d, up)
    e1 = e1 / np.linalg.norm(e1)
    e2 = np.cross(d, e1)
    return np.stack([d, e1, e2])


def cbrt_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 cube root of ``x >= 0``, taken in float64 and rounded once
    (torch has no ``cbrt``; a float32 ``pow(x, 1/3)`` is off by ulps)."""
    return torch.pow(x.to(torch.float64), 1.0 / 3.0).to(torch.float32)


class SpawnTable:
    """A scene's static per-row spawn parameters, on ``device``: the rows of
    every emitter's budget concatenated, each row carrying its emitter's
    constants (the JAX package builds the same columns at trace time).

    They lie in one float32 tensor, :attr:`packed`, which the spawn kernel
    reads (``ops/engine_kernels.py``): the :data:`COLUMNS` column-major
    (column ``c`` of row ``j`` at ``c * total + j``), then the emitters'
    rates.  The attributes the plain version reads (``pos0``, ``basis``,
    ``rates``, ...) are views of it; ``row_emitter`` is each row's emitter
    (int32)."""

    #: the packed table's columns, in ``csrc/emitter_frame.cu``'s order
    #: (``basis``: b0, b1, b2, three each)
    COLUMNS = ("pos0", 3), ("radius", 1), ("basis", 9), ("cone", 1), \
        ("speed0", 1), ("jitter", 1), ("lmin", 1), ("lspan", 1), \
        ("row_local", 1)

    def __init__(self, cfg: EmitterSceneConfig, device):
        dt = cfg.dt
        self.budgets = [emitter_budget(e, dt) for e in cfg.emitters]
        self.total = t = sum(self.budgets)

        def per_row(getter, width: int) -> np.ndarray:
            """(width, total) float32: each emitter's value over its rows."""
            cols = [np.broadcast_to(
                np.asarray(getter(e, s), np.float32).reshape(width, -1),
                (width, s)) for e, s in zip(cfg.emitters, self.budgets)]
            return (np.concatenate(cols, axis=1) if cols
                    else np.zeros((width, 0), np.float32))

        host = dict(
            pos0=per_row(lambda e, s: e.pos, 3),
            radius=per_row(lambda e, s: e.radius, 1),
            basis=per_row(lambda e, s: _basis(e.direction), 9),
            cone=per_row(lambda e, s: e.cone_angle, 1),
            speed0=per_row(lambda e, s: e.speed, 1),
            jitter=per_row(lambda e, s: e.speed_jitter, 1),
            lmin=per_row(lambda e, s: e.life_min, 1),
            lspan=per_row(lambda e, s: e.life_max - e.life_min, 1),
            row_local=per_row(lambda e, s: np.arange(s), 1))
        rates = np.asarray([e.rate * dt for e in cfg.emitters], np.float32)
        self.packed = torch.tensor(np.concatenate(
            [host[name].reshape(-1) for name, _ in self.COLUMNS] + [rates]),
            device=device)
        cols, start = {}, 0
        for name, width in self.COLUMNS:
            cols[name] = self.packed[start * t:(start + width) * t].view(
                width, t).T
            start += width
        self.pos0 = cols["pos0"]
        self.basis = [cols["basis"][:, 3 * i:3 * i + 3] for i in range(3)]
        (self.radius, self.cone, self.speed0, self.jitter, self.lmin,
         self.lspan, self.row_local) = (
            cols[k][:, 0] for k in ("radius", "cone", "speed0", "jitter",
                                    "lmin", "lspan", "row_local"))
        self.rates = self.packed[start * t:]
        self.row_emitter = torch.tensor(
            np.repeat(np.arange(len(self.budgets), dtype=np.int32),
                      self.budgets), device=device)
        self.weight = torch.tensor(per_row(lambda e, s: e.weight, 1)[0],
                                   device=device)


def spawn_draws(cfg: EmitterSceneConfig, salt: int, total: int) -> list:
    """A frame's two spawn draws over ``total`` rows: a ``(total, 8)``
    uniform draw under ``base = fold_in(frame_key(seed, frame, EMIT),
    salt)`` and ``total`` unit vectors under ``fold_in(base, 1)``, drawn in
    one threefry kernel launch on a card (``ops/rng_kernel.py``, which
    takes the frame)."""
    base = rng.FrameKey(cfg.seed, rng.EMIT).fold(salt)
    return [rng_kernel.u01(base, (total, 8)),
            rng_kernel.unit_vectors(base.fold(1), total)]


def spawn_fields(cfg: EmitterSceneConfig, frame, accum: torch.Tensor,
                 salt: int = 0, table: Optional[SpawnTable] = None
                 ) -> Tuple[SpawnRows, torch.Tensor]:
    """This frame's spawn rows and the updated fractional-rate accumulators
    (one float per emitter), on ``accum``'s device.  ``frame`` is a Python
    int or a 0-dim int64 tensor on that device.  ``salt`` decorrelates
    parallel streams.  One ``(total, 8)`` uniform draw and one unit-vector
    draw cover every emitter's rows (:func:`spawn_draws`).  ``table`` is
    the scene's :class:`SpawnTable` (built here when not given)."""
    dev = accum.device
    if not cfg.emitters:
        z3 = torch.zeros((1, 3), device=dev)
        z1 = torch.zeros((1,), device=dev)
        return (SpawnRows(z3, z3, z1, z1,
                          torch.zeros((1,), dtype=torch.bool, device=dev)),
                accum)
    t = SpawnTable(cfg, dev) if table is None else table

    u, dirs = rng_kernel.flat_fields(spawn_draws(cfg, salt, t.total), frame,
                                     dev)

    # fractional-rate accumulators over the (E,) row, then a gather maps the
    # per-emitter counts onto rows
    want = accum + t.rates
    n_spawn = torch.floor(want)
    new_accum = want - n_spawn
    valid = t.row_local < n_spawn[t.row_emitter]

    # position: uniform in a ball of radius around pos0
    r = t.radius * cbrt_f32(u[:, 0])
    pos = t.pos0 + dirs * r[:, None]
    # velocity: cone around the emitter direction
    theta = t.cone * sqrt_f32(u[:, 1])
    phi = TWO_PI * u[:, 2]
    b0, b1, b2 = t.basis
    dirv = (torch.cos(theta)[:, None] * b0
            + (torch.sin(theta) * torch.cos(phi))[:, None] * b1
            + (torch.sin(theta) * torch.sin(phi))[:, None] * b2)
    speed = t.speed0 * (1.0 + t.jitter * (2.0 * u[:, 3] - 1.0))
    vel = dirv * speed[:, None]
    life = t.lmin + u[:, 4] * t.lspan
    return SpawnRows(pos=pos, vel=vel, life=life, w=t.weight,
                     valid=valid), new_accum


def step_core(state: ParticleState, spawn: SpawnRows,
              cfg: EmitterSceneConfig) -> ParticleState:
    """Deterministic physics step plus spawn into ascending dead slots; the
    reference of the engine's exact allocator."""
    dt = as_f32(cfg.dt)
    alive = state.alive

    a = accel(state.vel, cfg)
    v1 = state.vel + a * dt
    p1 = state.pos + v1 * dt
    p1, v1 = collide(p1, v1, cfg)
    age1 = state.age + dt

    keep = alive[:, None]
    pos = torch.where(keep, p1, state.pos)
    vel = torch.where(keep, v1, state.vel)
    acc = torch.where(keep, a, state.acc)
    age = torch.where(alive, age1, state.age)
    alive1 = alive & (age1 <= state.life)

    # spawn into recycled slots; dropped requests aim one past the end
    target, ok = compact.allocate(alive1, spawn.valid)
    write = compact.write_rows
    return ParticleState(
        pos=write(pos, target, spawn.pos), vel=write(vel, target, spawn.vel),
        acc=write(acc, target, 0.0), w=write(state.w, target, spawn.w),
        age=write(age, target, 0.0), life=write(state.life, target,
                                                spawn.life),
        alive=write(alive1, target, ok),
        parent=write(state.parent, target, False),
        tag=write(state.tag, target, 0))


def step(state: ParticleState, accum: torch.Tensor, frame,
         cfg: EmitterSceneConfig):
    """Full frame: spawn-row generation, then :func:`step_core`."""
    spawn, accum = spawn_fields(cfg, frame, accum)
    return step_core(state, spawn, cfg), accum
