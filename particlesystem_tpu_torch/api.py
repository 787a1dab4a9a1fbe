"""User-facing API.

``ParticleSystem`` is the emitter-scene engine (the scene/state API of the
BASELINE configs: emitters, force list, dt, particle capacity) and
``NBodySimulation`` runs the reference simulation (the equivalent of
``DoParallelProcess``, the reference's
``source/code/src/particleSystem.cpp:1733-1986``) on one device, with
per-phase timing.  Both run on the card unless the caller passes
``device="cpu"``.

``NBodySimulation.run(batch=k)`` queues ``k`` frames with no host
synchronisation in between: the contract guards accumulate on the device
and the host reads them once per batch.  ``run(batch=1)`` reads every
frame's statistics.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from .core.config import (Emitter, EmitterSceneConfig, NBodyConfig,
                          PlaneCollider, SphereCollider)
from .models import nbody
from .runtime.engine import EngineState, PackedEngine
from .utils.device import resolve_device
from .utils.timers import PhaseTimers


def auto_batch(num_iterations: int, cap: int = 16) -> int:
    """Default batching policy for ``run(batch=0)``: the largest divisor of
    ``num_iterations`` that is <= ``cap`` (1 only when there is none in
    [2, cap])."""
    for b in range(min(cap, num_iterations), 0, -1):
        if num_iterations % b == 0:
            return b
    return 1


class ParticleSystem:
    """Scene construction and frame loop for emitter scenes.

    >>> ps = (ParticleSystem(capacity=1_000_000, dt=1/60, gravity=(0,-9.8,0))
    ...       .add_emitter(pos=(0, 1, 0), rate=100_000, speed=9.0)
    ...       .add_plane(restitution=0.5, friction=0.2))
    >>> ps.step(600)
    >>> xyz = ps.positions()

    The first ``step()`` freezes the scene and builds the engine; adding
    emitters or colliders afterwards raises.
    """

    def __init__(self, capacity: int = 1 << 20, dt: float = 1 / 60,
                 gravity=(0.0, -9.8, 0.0), wind=(0.0, 0.0, 0.0),
                 drag: float = 0.0, seed: int = 1, alloc: str = "ring",
                 refresh_interval: int = 1, layout: str = "packed8",
                 device="cuda"):
        self.device = resolve_device(device)
        self._base = dict(capacity=capacity, dt=dt, gravity=tuple(gravity),
                          wind=tuple(wind), drag=drag, seed=seed)
        self._emitters = []
        self._planes = []
        self._spheres = []
        self._alloc = alloc
        self._layout = layout
        self._refresh = refresh_interval
        self._engine: Optional[PackedEngine] = None
        self._es: Optional[EngineState] = None
        self.timers = PhaseTimers()

    # -- scene construction -------------------------------------------------
    def add_emitter(self, **kw) -> "ParticleSystem":
        self._mutable()
        self._emitters.append(Emitter(**kw))
        return self

    def add_plane(self, **kw) -> "ParticleSystem":
        self._mutable()
        self._planes.append(PlaneCollider(**kw))
        return self

    def add_sphere(self, **kw) -> "ParticleSystem":
        self._mutable()
        self._spheres.append(SphereCollider(**kw))
        return self

    def _mutable(self):
        if self._engine is not None:
            raise RuntimeError("scene is frozen after the first step()")

    @property
    def config(self) -> EmitterSceneConfig:
        return EmitterSceneConfig(emitters=tuple(self._emitters),
                                  planes=tuple(self._planes),
                                  spheres=tuple(self._spheres), **self._base)

    def _ensure(self):
        if self._engine is None:
            self._engine = PackedEngine(self.config, alloc=self._alloc,
                                        refresh_interval=self._refresh,
                                        layout=self._layout,
                                        device=self.device)
            self._es = self._engine.init()

    # -- simulation ----------------------------------------------------------
    def step(self, n: int = 1) -> "ParticleSystem":
        """Advance ``n`` frames, queued with no host synchronisation."""
        self._ensure()
        with self.timers.phase("step"):
            self._es = self._engine.step_many(self._es, n)
        return self

    @property
    def frame(self) -> int:
        return 0 if self._es is None else self._es.frame

    # -- state access ----------------------------------------------------------
    def packed(self) -> torch.Tensor:
        """Device (n_fields, capacity) packed state: x, y, z, vx, vy, vz then
        (age, life) on the packed8 layout or (death_frame,) on slim."""
        self._ensure()
        return torch.stack(self._engine.flat_fields(self._es))

    def _host_packed(self) -> np.ndarray:
        return self.packed().cpu().numpy()

    def _mask(self, p: np.ndarray) -> np.ndarray:
        if self._engine.layout == "slim":
            return self._es.frame < p[6]
        return (p[6] <= p[7]) & (p[7] > 0)

    def alive_mask(self) -> np.ndarray:
        return self._mask(self._host_packed())

    def positions(self, alive_only: bool = True) -> np.ndarray:
        p = self._host_packed()
        xyz = p[0:3].T
        return xyz[self._mask(p)] if alive_only else xyz

    def alive_count(self) -> int:
        self._ensure()
        return int(self._engine.alive_count(self._es))

    def fade(self) -> np.ndarray:
        """Per-particle alpha ``1 - age/life`` of the alive rows.  Needs the
        packed8 layout: slim stores only the death frame."""
        self._ensure()
        if self._engine.layout == "slim":
            raise RuntimeError("fade() needs layout='packed8'; the slim "
                               "layout does not carry age/life")
        p = self._host_packed()
        m = self._mask(p)
        return 1.0 - p[6][m] / p[7][m]


class NBodySimulation:
    """Initial uniform fill, then frames of ``models/nbody.step`` on
    ``device``.

    ``active_bucketing`` runs frames on an occupancy-sized slot prefix:
    after a batch whose alive count fits a smaller prefix, alive rows are
    compacted forward (``nbody.compact_state``) and later frames operate on
    ``[0, active)`` only; results are identical to full width, and the
    ``n_tail_alive`` / ``n_spawn_capped`` guards fail loudly if the contract
    breaks."""

    def __init__(self, cfg: NBodyConfig = NBodyConfig(), device="cuda",
                 impl: str = "blocks", active_bucketing: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.impl = impl
        self.active_bucketing = active_bucketing
        self.timers = PhaseTimers()
        with self.timers.phase("fill"):
            self.state = nbody.init_fill(cfg, self.device)
        self.frame = 0
        self.last_stats = None
        self.n_degraded_frames = 0  # frames whose neighbor pass truncated
        self._active = 0  # 0 = full slots

    #: active-prefix granularity; see models/nbody.pick_active
    ACTIVE_QUANTUM = nbody.ACTIVE_QUANTUM

    def _pick_active(self, alive: int) -> int:
        return nbody.pick_active(self.cfg, alive, self.ACTIVE_QUANTUM)

    def _apply_bucketing(self, alive: int) -> None:
        want = self._pick_active(alive)
        want_rows = want or self.cfg.slots
        cur_rows = self._active or self.cfg.slots
        if want_rows < cur_rows:
            # shrink: compact alive rows into the prefix first
            with self.timers.phase("compact"):
                self.state = nbody.compact_state(self.state)
            self._active = want
        elif want_rows > cur_rows:
            # grow: a pure re-slice, containment keeps the prefix invariant
            self._active = want

    def _step(self, frame: int):
        return nbody.step(self.state, frame, self.cfg, self.impl,
                          self._active)

    def _check_guards(self, where: str, spawn_capped: int, tail_alive: int,
                      dropped: int) -> None:
        if tail_alive:
            raise RuntimeError(f"{where}: {tail_alive} alive rows beyond "
                               f"active prefix {self._active}")
        if self._active and spawn_capped:
            raise RuntimeError(f"{where}: active prefix {self._active} "
                               f"saturated — {spawn_capped} spawns capped "
                               f"that full width would grant")
        if dropped:
            self.n_degraded_frames += 1
            warnings.warn(f"{where}: {dropped} neighbor chunks dropped — "
                          f"forces truncated; raise the chunk budget",
                          RuntimeWarning, stacklevel=3)

    def _run_batched(self, num_iterations: int, batch: int, verbose: bool):
        if num_iterations % batch:
            raise ValueError(f"num_iterations {num_iterations} must be a "
                             f"multiple of batch {batch}")
        for _ in range(num_iterations // batch):
            with self.timers.phase("step"):
                mc = mt = nd = None
                for i in range(batch):
                    self.state, stats = self._step(self.frame + i)
                    # guards over EVERY frame: spawn capping and drops are
                    # transient, the last frame alone could miss them
                    if mc is None:
                        mc, mt = stats.n_spawn_capped, stats.n_tail_alive
                        nd = stats.n_listed_dropped
                    else:
                        mc = torch.maximum(mc, stats.n_spawn_capped)
                        mt = torch.maximum(mt, stats.n_tail_alive)
                        nd = nd + stats.n_listed_dropped
                guards = torch.stack([
                    mc, mt, nd, stats.n_alive, stats.max_cell_occupancy,
                    stats.n_spawned]).tolist()  # the batch's one host sync
            self.frame += batch
            self.last_stats = stats
            self._check_guards(f"batch ending at frame {self.frame}",
                               guards[0], guards[1], guards[2])
            if self.active_bucketing:
                self._apply_bucketing(guards[3])
            if verbose:
                print(f"iter {self.frame}: alive={guards[3]} "
                      f"last_spawned={guards[5]} max_cell={guards[4]} "
                      f"active={self._active or self.cfg.slots}")
        return self.last_stats

    def run(self, num_iterations: int = 10, verbose: bool = False,
            batch: int = 0):
        """Advance ``num_iterations`` frames.

        ``batch=0`` auto-batches (:func:`auto_batch`); ``batch=k > 1``
        queues ``k`` frames per host synchronisation, with the guards
        (``n_tail_alive``, ``n_spawn_capped``, ``n_listed_dropped``)
        accumulated on the device and checked at batch boundaries;
        ``batch=1`` reads each frame's statistics and reacts per frame.
        ``num_iterations`` must be a multiple of ``batch``."""
        if batch == 0:
            batch = auto_batch(num_iterations)
        if batch > 1:
            return self._run_batched(num_iterations, batch, verbose)
        for _ in range(num_iterations):
            with self.timers.phase("step"):
                self.state, stats = self._step(self.frame)
                s = {k: int(v) for k, v in vars(stats).items()}
            self.frame += 1
            self.last_stats = stats
            self._check_guards(f"frame {self.frame}", s["n_spawn_capped"],
                               s["n_tail_alive"], s["n_listed_dropped"])
            if self.active_bucketing:
                self._apply_bucketing(s["n_alive"])
            if verbose:
                print(f"iter {self.frame}: alive={s['n_alive']} "
                      f"spawned={s['n_spawned']} "
                      f"max_cell={s['max_cell_occupancy']} "
                      f"active={self._active or self.cfg.slots}")
        return self.last_stats
