"""User-facing API.

``ParticleSystem`` is the emitter-scene engine (the scene/state API of the
BASELINE configs: emitters, force list, dt, particle capacity) and
``NBodySimulation`` runs the reference simulation (the equivalent of
``DoParallelProcess``, the reference's
``source/code/src/particleSystem.cpp:1733-1986``) on one device, with
per-phase timing.  Both run on the card unless the caller passes
``device="cpu"``.

``NBodySimulation.run(batch=k)`` runs ``k`` frames with no host
synchronisation in between: the contract guards accumulate on the device
and the host reads them once per batch (``run(batch=1)``: once a frame).
On a card every frame is one replay of a CUDA graph of the frame
(``utils/frame_graph.FrameGraphs``), the counterpart of the JAX package's
jitted frame and ``fori_loop`` batch: the graph reads the state, the
frame index and the guard accumulators from static buffers and writes
them back.  Graphs are keyed by ``(impl, active prefix, list width)``, as
the JAX package keys its loop programs, and a graph is freed at the first
batch under another key.  On the CPU the same loop runs its frame
function eagerly on the same buffers.  ``ParticleSystem.step`` goes
through ``PackedEngine.step_many``, which replays the engine's frame graph.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch

from .core.config import (Emitter, EmitterSceneConfig, NBodyConfig,
                          PlaneCollider, SphereCollider)
from .core.state import FIELDS
from .models import nbody
from .runtime import checkpoint
from .runtime.engine import EngineState, PackedEngine
from .runtime.readback import AsyncReadback
from .utils.device import resolve_device
from .utils.frame_graph import FrameGraphs
from .utils.timers import PhaseTimers, slope_ms, span

#: the statistics a frame leaves in the loop's static buffer, in order
STAT_FIELDS = nbody.STAT_NAMES


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
        self.timers = PhaseTimers("engine.")
        self._readback: Optional[AsyncReadback] = None

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
        if self._readback is not None:
            with self.timers.phase("readback"):
                self._readback.publish(self.packed())
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

    # -- render-loop readback -------------------------------------------------
    def enable_readback(self, depth: int = 3) -> AsyncReadback:
        """Publish :meth:`packed` after every :meth:`step` into a ring of
        ``depth`` frames that a consumer drains (``.ring.pop``); the step
        never waits for it."""
        self._ensure()
        frame_bytes = self._engine.n_fields * self._engine.cfg.slots * 4
        self._readback = AsyncReadback(frame_bytes, depth)
        return self._readback

    # -- persistence ------------------------------------------------------------
    def save(self, path: str) -> None:
        self._ensure()
        checkpoint.save(path, self._es,
                        meta=checkpoint.config_fingerprint(self.config))

    def load(self, path: str) -> "ParticleSystem":
        self._ensure()
        self._es, _ = checkpoint.load(path, self._es,
                                      expect_config=self.config)
        return self


class NBodySimulation:
    """Initial uniform fill, then frames of ``models/nbody.step`` on
    ``device``.

    ``active_bucketing`` runs frames on an occupancy-sized slot prefix:
    after a batch whose alive count fits a smaller prefix, alive rows are
    compacted forward (``nbody.compact_state``) and later frames operate on
    ``[0, active)`` only; results are identical to full width, and the
    ``n_tail_alive`` / ``n_spawn_capped`` guards fail loudly if the contract
    breaks.

    ``impl="dense"`` runs the cell-pair pass in plain tensor code (the
    reference beside the kernel).  With ``adaptive_width`` its cell lists
    are as wide as the last observed cell occupancy needs
    (:meth:`_pick_width`); a frame or batch that the narrowed lists
    truncated is redone at full width, so no degraded frame is kept.

    The frame loop (:meth:`run`): ``self.state`` is the static state the
    frame graphs read and write, and keeps its tensors from frame to
    frame; a state assigned to it (``load``, the compaction of
    :meth:`_apply_bucketing`, a caller) is copied into those tensors at
    the next batch.  ``graphs`` counts the eager frames, captures and
    replays."""

    BUCKETS = (64, 128, 192, 256, 384, 512, 768, 1024)

    def __init__(self, cfg: NBodyConfig = NBodyConfig(), device="cuda",
                 impl: str = "blocks", active_bucketing: bool = True,
                 adaptive_width: bool = True):
        with span("nbody.init"):  # the fill's span nests inside
            if impl not in ("blocks", "dense"):
                raise ValueError(f"unknown neighbor pass {impl!r}")
            self.cfg = cfg
            self.device = resolve_device(device)
            self.impl = impl
            self.adaptive_width = adaptive_width and impl == "dense"
            self.active_bucketing = active_bucketing
            self.timers = PhaseTimers("nbody.")
            t0 = time.perf_counter()
            self.state = nbody.init_fill(cfg, self.device)  # records its span
            self.timers.add("fill", time.perf_counter() - t0)
            self.frame = 0
            self.last_stats = None
            self.n_degraded_frames = 0  # frames whose neighbor pass truncated
            self._width = 0  # 0 = full cell_capacity (always exact)
            self._active = 0  # 0 = full slots
            # the frame loop's static buffers: the state, the frame on the
            # device, the guards (max spawns capped, max alive rows beyond the
            # prefix, chunks dropped, over a batch) and the last frame's stats
            dev = self.device
            self.graphs = FrameGraphs(dev)
            self._static = self.state
            self._frame_t = torch.zeros((), dtype=torch.int64, device=dev)
            self._guards = torch.zeros((3,), dtype=torch.int64, device=dev)
            self._stats = torch.zeros((len(STAT_FIELDS),), dtype=torch.int64,
                                      device=dev)

    def _pick_width(self, max_occ: int) -> int:
        """Bucketized list width with 25% headroom over the last observed
        max cell occupancy: the reference's per-frame gridmax readback
        (``particleSystem.cpp:1900``) serves the same purpose.  The dense
        pass costs O(width^2), so it tracks real occupancy, not the kill
        cap."""
        want = int(max_occ * 1.25) + 8
        for b in self.BUCKETS:
            if b >= want:
                return min(b, self.cfg.cell_capacity)
        return 0  # full capacity

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
            with self.timers.phase("compact", n=alive):
                self.state = nbody.compact_state(self.state)
            self._active = want
        elif want_rows > cur_rows:
            # grow: a pure re-slice, containment keeps the prefix invariant
            self._active = want

    def _step(self, state, frame):
        return nbody.step(state, frame, self.cfg, self.impl, self._active,
                          self._width)

    def _adapt_width(self, max_occ: int, dropped: int) -> None:
        if self.adaptive_width and not dropped:
            self._width = self._pick_width(max_occ)

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

    def _key(self):
        """What a frame graph bakes in: the pass, the active prefix and the
        list width (the JAX package's ``_loop_jits`` key, less the batch:
        one frame's graph serves every batch)."""
        return (self.impl, self._active, self._width)

    def _loop_frame(self, active: int, width: int) -> None:
        """The frame the graphs capture: the static state to the next in
        place, the guards and stats into their buffers, the device frame
        one on."""
        stats = nbody.step_into(self._static, self._frame_t, self.cfg,
                                self.impl, active, width)
        vals = torch.stack([getattr(stats, f) for f in STAT_FIELDS])
        self._stats.copy_(vals)
        g = self._guards
        # guards over EVERY frame: spawn capping and drops are transient,
        # the last frame alone could miss them
        g.copy_(torch.stack([torch.maximum(g[0], stats.n_spawn_capped),
                             torch.maximum(g[1], stats.n_tail_alive),
                             g[2] + stats.n_listed_dropped]))
        self._frame_t.add_(1)

    def _batch(self, batch: int):
        """``batch`` frames from ``self.state`` through the frame graph of
        the current key (freeing the others), in place; returns (the last
        frame's stats, the six guard values [max spawns capped, max tail
        alive, chunks dropped, alive, max cell occupancy, spawned] read in
        the batch's one host sync)."""
        if self.state is not self._static:
            with span("nbody.handin", n=len(FIELDS)):
                for f in FIELDS:
                    getattr(self._static, f).copy_(getattr(self.state, f))
            self.state = self._static
        with span("nbody.enqueue", n=batch):
            self._frame_t.fill_(self.frame)
            self._guards.zero_()
            key = self._key()
            self.graphs.retain(key)
            fn = lambda: self._loop_frame(self._active, self._width)
            for _ in range(batch):
                self.graphs.step(key, fn)
        with span("nbody.readback", n=1):
            host = torch.cat([self._guards, self._stats]).tolist()
        stats = dict(zip(STAT_FIELDS, host[3:]))
        # a copy: the next batch overwrites the buffer
        last = nbody.NBodyStats(**dict(zip(STAT_FIELDS,
                                           self._stats.clone().unbind())))
        return last, host[:3] + [stats["n_alive"],
                                 stats["max_cell_occupancy"],
                                 stats["n_spawned"]]

    def _width_note(self) -> str:
        if self.impl != "dense":
            return ""
        return f" width={self._width or self.cfg.cell_capacity}"

    def run(self, num_iterations: int = 10, verbose: bool = False,
            batch: int = 0):
        """Advance ``num_iterations`` frames.

        ``batch=0`` auto-batches (:func:`auto_batch`); ``batch=k`` runs
        ``k`` frames per host synchronisation, with the guards
        (``n_tail_alive``, ``n_spawn_capped``, ``n_listed_dropped``)
        accumulated on the device and checked at batch boundaries;
        ``batch=1`` reads each frame's statistics and reacts per frame.
        ``num_iterations`` must be a multiple of ``batch``.  On a card
        every frame is one replay of the current key's frame graph, after
        the key's first frame, which runs eagerly and is then captured."""
        if batch == 0:
            batch = auto_batch(num_iterations)
        if num_iterations % batch:
            raise ValueError(f"num_iterations {num_iterations} must be a "
                             f"multiple of batch {batch}")
        with span("nbody.run", n=num_iterations):
            for _ in range(num_iterations // batch):
                with span("nbody.batch", n=batch):
                    with self.timers.phase("step"):
                        # kept so a truncated batch can be redone at full
                        # width
                        prev = (self.state.map(lambda a: a.clone())
                                if self._width != 0 else None)
                        stats, guards = self._batch(batch)
                        if guards[2] and self._width != 0:
                            # the adaptive width truncated some frame of
                            # the batch: redo the whole batch from the
                            # saved state at full width, which is exact by
                            # construction
                            self._width = 0
                            self.state = prev
                            stats, guards = self._batch(batch)
                    with span("nbody.guards"):
                        self.frame += batch
                        self.last_stats = stats
                        where = (f"frame {self.frame}" if batch == 1
                                 else f"batch ending at frame {self.frame}")
                        self._check_guards(where, guards[0], guards[1],
                                           guards[2])
                        if self.active_bucketing:
                            self._apply_bucketing(guards[3])
                        self._adapt_width(guards[4], guards[2])
                if verbose:
                    spawned = "spawned" if batch == 1 else "last_spawned"
                    print(f"iter {self.frame}: alive={guards[3]} "
                          f"{spawned}={guards[5]} max_cell={guards[4]} "
                          f"active={self._active or self.cfg.slots}"
                          + self._width_note())
        return self.last_stats

    # -- timing ------------------------------------------------------------------
    def _time_ms(self, fn, reps: int):
        """(result, median milliseconds) of ``fn()`` over ``reps`` calls,
        each timed on its own, after one warm-up call: CUDA events on a
        card, the host clock on the CPU.  The median leaves out a call that
        paid for something once (an allocation, a busy host)."""
        out = fn()
        times = []
        if self.device.type == "cuda":
            events = []
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn()
                end.record()
                events.append((start, end))
            torch.cuda.synchronize(self.device)
            times = [start.elapsed_time(end) for start, end in events]
        else:
            for _ in range(reps):
                t0 = time.perf_counter()
                out = fn()
                times.append((time.perf_counter() - t0) * 1e3)
        return out, float(np.median(times))

    def profile_frame(self, k1: int = 2, k2: int = 6, reps: int = 5) -> dict:
        """Stage-by-stage timing of one frame at the current state: the
        structured equivalent of the reference's per-iteration
        ``total / init_iframe / build_grid / calc_forces`` printout
        (``particleSystem.cpp:1927``).  Stages:

        * ``rng_fields``  — per-frame random field generation (the
          threefry kernel on a card)
        * ``cell_ids``    — torus wrap and cell id assignment (``blocks``:
          kernel A of ``models/nbody.blocks_frame``, the sort key and,
          where they pay, the rows' records)
        * ``build_grid``  — sort by cell and the chunk table (``blocks``:
          ``frame_kernels.sort_and_prepare``, the sort and kernels B and
          C), or the cell lists (``dense``); the
          BUILD_GRID analog (``particleSystem.cpp:1468-1537``)
        * ``calc_forces`` — the neighbor pass proper: the cluster-pair
          kernel, or the dense cell-pair pass
          (``particleSystem.cpp:1120-1383`` analog)
        * ``unsort``      — kernel outputs back to slot order (``blocks``):
          kernel D, which reads them through the inverse permutation and,
          in the same pass, applies the lifecycle flags, the integration
          and the explosion
        * ``lifecycle``   — death/survive/integrate/spawn updates; on the
          ``blocks`` frame, whose D has done the rest, the spawn alone
          (kernel E: the tile scan, rank and write)
        * ``full_frame``  — the whole frame as :meth:`run` executes it: the
          median of ``reps`` slopes between ``k1`` and ``k2`` frames of its
          loop (graph replays of the current key on a card, the same loop
          eagerly on the CPU), each from the current state, after a
          warm-up of ``k1`` frames (``utils/timers.slope_ms``, the bench's
          method); the state is put back after each run

        Each other stage runs ``reps`` times in this process on the inputs
        the frame gives it (on the active prefix where one is engaged),
        timed with CUDA events on a card and the host clock on the CPU; a
        stage's time is the median of its runs.  On a card every stage runs
        what the frame runs there, the kernels; the CPU runs their plain
        versions.  D and E write a scratch state.  Results are recorded
        into ``self.timers`` (phases ``frame/<stage>``) and returned as
        {stage: ms}.  Does not advance ``self.state`` or ``self.frame``."""
        if not 0 < k1 < k2:
            raise ValueError(f"need 0 < k1 < k2, got k1={k1} k2={k2}")
        from .ops import frame_kernels as fk
        from .ops import neighbor_blocks as nbk
        from .ops.grid import build_bins, coords_to_cell, wrap_positions

        cfg = self.cfg
        grid = cfg.grid
        # the frame on the device, as the loop's frames take it
        frame = self._frame_t.fill_(self.frame)
        state = self.state
        if self._active and self._active < state.slots:
            state = state.map(lambda a: a[:self._active])
        out = {}

        def stage(name, fn):
            result, out[name] = self._time_ms(fn, reps)
            return result

        uvec, fert = stage("rng_fields", lambda: nbody.frame_fields(
            cfg, frame, state.tag))

        if self.impl == "blocks":
            key, rows = stage("cell_ids", lambda: fk.cells_and_rows(
                state, grid))
            p = stage("build_grid", lambda: fk.sort_and_prepare(
                key, rows, cfg, nbk.C_MAX, nbk.CH, nbk.B, grid=grid))
            acc_s, gmax_s = stage("calc_forces", lambda: nbk.kernel_call(
                cfg, p.snap, p.chunks))
            scratch = state.map(torch.empty_like)
            flags, tiles = stage("unsort", lambda: fk.nbody_lifecycle(
                state, scratch, acc_s, gmax_s, p.overflow_s, p.inv, uvec,
                cfg, p.stats))
            stage("lifecycle", lambda: fk.nbody_spawn(
                scratch, fert, frame, flags, tiles, cfg, p.stats))
        else:
            def cell_ids():
                pos_w, coords = wrap_positions(state.pos, grid)
                return pos_w, coords_to_cell(coords, grid)

            pos_w, cell = stage("cell_ids", cell_ids)
            bins = stage("build_grid", lambda: build_bins(
                cell, state.alive, grid.num_cells, cfg.cell_capacity,
                list_width=self._width))
            acc, kill, touch = stage("calc_forces", lambda: (
                nbody._neighbor_pass(state, bins.cell_list, cfg)))
            stage("lifecycle", lambda: nbody.lifecycle_update(
                state, pos_w, bins.overflow, acc, kill, touch, uvec, fert,
                frame, cfg))
        out["full_frame"] = self._loop_slope_ms(k1, k2, reps)

        for name, ms in out.items():
            self.timers.add(f"frame/{name}", ms / 1e3)
        return out

    def _loop_slope_ms(self, k1: int, k2: int, reps: int) -> float:
        """``profile_frame``'s ``full_frame``: batches of ``k1`` and ``k2``
        frames through :meth:`_batch`, each from the current state, which
        (with the frame, the prefix and the width, which ``_batch`` leaves
        alone) is as it was after."""
        saved = self.state.map(lambda a: a.clone())

        def restore():
            for f in FIELDS:
                getattr(self.state, f).copy_(getattr(saved, f))

        def run_k(k):
            restore()
            self._batch(k)

        run_k(k1)   # the key's eager frame and capture, if it has none yet
        ms = slope_ms(run_k, k1, k2, max(1, reps), self.device)
        restore()
        return ms

    # -- persistence -------------------------------------------------------------
    def save(self, path: str) -> None:
        checkpoint.save(path, self.state,
                        meta=dict(frame=self.frame,
                                  **checkpoint.config_fingerprint(self.cfg)))

    def load(self, path: str) -> None:
        self.state, meta = checkpoint.load(path, self.state,
                                           expect_config=self.cfg)
        self.frame = int(meta.get("frame", 0))
        self._active = 0  # loaded layout unknown; run() re-buckets

    # -- validation --------------------------------------------------------------
    def validate(self, frames: int = 5) -> dict:
        """Run ``frames`` steps of both the device path and the independent
        numpy oracle (``cpu_ref/oracle_nbody.py``) from the current state
        and report the deviation: the working version of the reference's
        serial-vs-parallel comparison, which is stubbed to always pass
        (``DoCompare``, ``particleSystem.cpp:2254-2257``).  Discrete
        lifecycle events must match exactly; float trajectories to
        accumulation-order tolerance.  The device side runs this
        simulation's ``impl`` at full list width; the oracle gets the same
        per-frame random fields.  Does not advance ``self.state``."""
        from .cpu_ref import oracle_nbody
        from .cpu_ref.oracle_emitter import NpState

        dev = self.state
        ora = NpState.from_torch(dev)
        worst = 0.0
        events_match = True
        for f in range(self.frame, self.frame + frames):
            uvec, fert = nbody.frame_fields(self.cfg, f, dev.tag)
            dev, stats = nbody.step(dev, f, self.cfg, self.impl,
                                    self._active)
            ora, ostats = oracle_nbody.step(ora, uvec.cpu().numpy(),
                                            fert.cpu().numpy(), f, self.cfg)
            for k, v in ostats.items():
                if int(getattr(stats, k)) != v:
                    events_match = False
            alive = dev.alive.cpu().numpy()
            if not np.array_equal(alive, ora.alive):
                events_match = False
            if alive.any():
                worst = max(worst, float(np.abs(
                    dev.pos.cpu().numpy()[alive] - ora.pos[alive]).max()))
        return {"events_match": events_match,
                "max_position_deviation": worst, "frames": frames}
