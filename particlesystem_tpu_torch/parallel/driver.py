"""The multi-device n-body driver.

Counterpart of ``particlesystem_tpu/parallel/driver.py``:
``DistributedNBodySimulation`` is ``api.NBodySimulation`` over a
decomposed state, one process a rank (the reference's
``DoParallelProcess``, ``particleSystem.cpp:1733-1986``, under ``mpirun``).
Every rank constructs it with the same arguments and calls the same
methods in the same order: they are collective over the process group.
It takes any of the three decompositions (:class:`.nbody_sharded.SlabSpec`,
:class:`.nbody_pencil.PencilSpec`, :class:`.nbody_brick.BrickSpec`) and
provides:

* ``run``: batched frames with the drop counters summed and the buffer
  high-water marks kept on the device, one host readback a batch (with
  NCCL, or a lone rank, no host synchronisation inside a frame; gloo moves
  each exchange through host memory).  On a mesh of one rank whose
  collectives a CUDA graph can hold (:func:`graph_frames`) each frame is a
  replay of one captured frame (``utils/frame_graph.FrameGraphs``), the
  counterpart of the JAX driver's jitted ``fori_loop`` batch; elsewhere
  the same frame runs eagerly;
* ``gather`` and ``alive_count``;
* ``save`` / ``load``: the sharded checkpoint directory (each process
  writes and, on the same spec, reads back only its own rows); a
  checkpoint of another decomposition, or a single-device ``.npz``, is
  assembled on the host and redistributed;
* ``validate``: the production step against the numpy oracle, shard-local
  (each rank joins its own alive rows to the oracle's by persistent tag);
* ``profile_frame``: the frame's time, the median of slopes between runs
  of ``k1`` and ``k2`` frames (CUDA events on a card);
* ``autosize_buffers``: halo and migration capacities from measured
  high-water marks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import NBodyConfig
from ..core.state import FIELDS, ParticleState, state_from_numpy, zero_state
from ..models import nbody
from ..runtime import checkpoint
from ..utils.frame_graph import FrameGraphs
from ..utils.timers import PhaseTimers, slope_ms
from .mesh import default_mesh, rank_device
from .nbody_brick import BrickSpec
from .nbody_pencil import PencilSpec
from .nbody_sharded import (STATS, SlabSpec, _distribute, local_rows,
                            make_step)

_SPECS = (SlabSpec, PencilSpec, BrickSpec)


def graph_frames(size: int, backend: Optional[str]) -> bool:
    """Whether the driver replays captured frames on a mesh of ``size``
    ranks over a group of ``backend`` (None: no group): on one rank with
    no group, where every collective is the identity, or over NCCL, whose
    one-rank all-reduces a capture holds.  Gloo runs eagerly: it stages
    every collective through host memory, which a capture refuses.  A
    mesh of several NCCL ranks runs eagerly too: its collectives under
    capture across cards are not yet checked."""
    return size == 1 and backend in (None, "nccl")


class DistributedNBodySimulation:
    """Drive the reference simulation over a rank mesh.

    ``group`` is the process group of the ranks (None: a lone process);
    ``mesh`` defaults to :func:`.mesh.default_mesh` of the spec's shape
    over it.  ``device`` is this rank's device (default
    ``cuda:{LOCAL_RANK}``; ranks share one only when the caller passes it).

    The frame loop (:meth:`run`) reads and writes one static state,
    ``self.state`` after a batch, with the frame on the device; a state
    assigned to ``self.state`` (``load``, a caller) is copied into it at
    the next batch.  Where :func:`graph_frames` allows, ``graphs`` (a
    ``FrameGraphs``: eager frames, captures, replays) runs each frame, a
    capture that fails raises; elsewhere ``graphs`` is None and every
    frame runs eagerly.

    >>> sim = DistributedNBodySimulation(cfg, BrickSpec(2, 2, 2), group=g)
    >>> sim.run(10); sim.save("ckpt"); sim.validate()
    """

    _SUM_KEYS = ("halo_dropped", "migration_dropped", "n_listed_dropped")
    _MAX_KEYS = ("halo_used_max", "migration_used_max")

    def __init__(self, cfg: NBodyConfig, spec, group=None, mesh=None,
                 device=None, state: Optional[ParticleState] = None):
        if not isinstance(spec, _SPECS):
            raise TypeError(f"unknown decomposition spec {type(spec)!r}")
        self.cfg = cfg
        self._spec_raw = spec          # user capacities (0 = derive)
        self.spec = spec.derive(cfg)   # concrete capacities in force
        self.mesh = mesh if mesh is not None else default_mesh(
            spec.mesh_shape, spec.mesh_axes, group)
        self.device = rank_device(device)
        self.timers = PhaseTimers("sharded_nbody.")
        self.frame = 0
        self.last_stats = None
        self.n_degraded_frames = 0
        self._step = make_step(cfg, self.spec, self.mesh)
        self._rows = local_rows(cfg, self.mesh)
        with self.timers.phase("fill"):
            if state is None:
                state = nbody.init_fill(cfg, self.device)
            state, self.n_fill_dropped = _distribute(
                state.to(self.device), cfg, self.spec.splits())
            self.state = self._local(state)
        # the frame loop's static buffers: the state, the frame on the
        # device, the last frame's statistics (STATS) and the batch's
        # summed drops and maxed marks
        dev = self.device
        group = self.mesh.group
        backend = None if group is None else dist.get_backend(group)
        self.graphs = (FrameGraphs(dev) if graph_frames(self.mesh.size,
                                                        backend) else None)
        self._static = self.state
        self._frame_t = torch.zeros((), dtype=torch.int64, device=dev)
        self._stats = torch.zeros((len(STATS),), dtype=torch.int64,
                                  device=dev)
        self._marks = torch.zeros((len(self._SUM_KEYS + self._MAX_KEYS),),
                                  dtype=torch.int64, device=dev)

    def _local(self, state: ParticleState) -> ParticleState:
        """This rank's slots of a global state, as its own tensors."""
        return state.map(lambda a: a[self._rows].to(self.device).clone())

    # -- simulation -----------------------------------------------------------
    #: the key of the one frame graph: every batch size replays it
    _KEY = "frame"

    def _loop_frame(self) -> None:
        """The frame the graphs capture: the static state to the next
        (in place, or copied back where the step built it anew), its
        statistics into their buffer, the drops summed and the marks
        maxed into theirs, the device frame one on."""
        st = self._static
        out, stats = self._step(st, self._frame_t)
        for f in FIELDS:
            dst, src = getattr(st, f), getattr(out, f)
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)
        self._stats.copy_(torch.stack([stats[k] for k in STATS]))
        m, n_sum = self._marks, len(self._SUM_KEYS)
        # over EVERY frame: a drop or a mark of one frame is not the last's
        m.copy_(torch.cat([
            m[:n_sum] + torch.stack([stats[k] for k in self._SUM_KEYS]),
            torch.maximum(m[n_sum:], torch.stack(
                [stats[k] for k in self._MAX_KEYS]))]))
        self._frame_t.add_(1)

    def _enter(self) -> None:
        """Make ``self.state`` the static state, copying an assigned
        state into it."""
        if self.state is not self._static:
            for f in FIELDS:
                getattr(self._static, f).copy_(getattr(self.state, f))
            self.state = self._static

    def _batch(self, batch: int) -> dict:
        """``batch`` frames from ``self.state`` in place (graph replays
        where :attr:`graphs` runs them); returns the last frame's
        statistics with the batch's summed drops and maxed marks, read in
        the batch's one host readback."""
        self._enter()
        self._frame_t.fill_(self.frame)
        self._marks.zero_()
        for _ in range(batch):
            if self.graphs is None:
                self._loop_frame()
            else:
                self.graphs.step(self._KEY, self._loop_frame)
        host = torch.cat([self._stats, self._marks]).tolist()
        stats = dict(zip(STATS, host[:len(STATS)]))
        stats.update(zip(self._SUM_KEYS + self._MAX_KEYS, host[len(STATS):]))
        return stats

    def run(self, num_iterations: int = 10, verbose: bool = False,
            batch: int = 0) -> dict:
        """Advance ``num_iterations`` frames.  ``batch=0`` auto-batches
        (the largest divisor of ``num_iterations`` up to 16); ``batch=k``
        queues ``k`` frames with the drop counters summed and the
        high-water marks maximised on the device, and reads them with the
        last frame's statistics in one host readback a batch: the returned
        statistics then carry the whole batch's drops and marks.
        ``batch=1`` reads every frame's statistics.  Where :attr:`graphs`
        runs the loop, each frame after the first is one replay, whatever
        the batch."""
        if batch == 0:
            from ..api import auto_batch
            batch = auto_batch(num_iterations)
        if num_iterations % batch:
            raise ValueError(f"num_iterations {num_iterations} must be a "
                             f"multiple of batch {batch}")
        for _ in range(num_iterations // batch):
            with self.timers.phase("step"):
                stats = self._batch(batch)
            self.frame += batch
            self.last_stats = stats
            drops = {k: stats[k] for k in self._SUM_KEYS if stats[k]}
            if drops:
                self.n_degraded_frames += 1
                warnings.warn(
                    f"frame {self.frame}: buffer overflow drops {drops} — "
                    f"raise the spec capacities (see autosize_buffers)",
                    RuntimeWarning, stacklevel=2)
            if verbose and self.mesh.rank == 0:
                print(f"iter {self.frame}: alive={stats['n_alive']} "
                      f"spawned={stats['n_spawned']} "
                      f"halo_max={stats['halo_used_max']} "
                      f"mig_max={stats['migration_used_max']}")
        return dict(self.last_stats)

    # -- state access ---------------------------------------------------------
    def gather(self) -> ParticleState:
        """The full global state on every rank (the ``pFetchBack`` analog,
        ``particleSystem.cpp:1778-1786``), in the decomposition's slot
        layout: rank at mesh position d holds slots
        ``[d*c_local, (d+1)*c_local)``."""
        order = np.argsort([self.mesh.position(r)
                            for r in range(self.mesh.size)])
        out = {}
        for f in FIELDS:
            parts = self.mesh.all_gather(getattr(self.state, f))
            out[f] = torch.cat([parts[r] for r in order])
        return ParticleState(**out)

    def alive_count(self) -> int:
        if self.last_stats is not None:
            return int(self.last_stats["n_alive"])
        return int(self.mesh.psum(self.state.alive.sum(dtype=torch.int64)))

    # -- persistence ----------------------------------------------------------
    def _spec_fp(self) -> dict:
        """JSON-normalised spec fingerprint (tuples become lists, as they
        read back from a checkpoint's meta.json)."""
        return json.loads(json.dumps(dataclasses.asdict(self.spec)))

    def _meta(self) -> dict:
        return dict(frame=self.frame, spec_type=type(self.spec).__name__,
                    spec=self._spec_fp(),
                    **checkpoint.config_fingerprint(self.cfg))

    def _shards(self):
        return checkpoint.state_shards(self.state, self._rows, self.cfg.slots)

    def save(self, path: str) -> None:
        """Write the sharded checkpoint directory ``path`` (collective):
        each process writes only its own rows and their global ranges,
        stamped with the config and spec fingerprints; no process gathers
        the state."""
        with self.timers.phase("save"):
            checkpoint.save_sharded(path, self._shards(), meta=self._meta(),
                                    group=self.mesh.group)

    def load(self, path: str) -> int:
        """Resume from a checkpoint directory of this driver or the JAX
        package's, or from a single-device ``.npz`` of either package.
        Same spec: each process reads only its own rows.  Another spec or
        a single-device file: the global state is assembled on the host
        in every process and redistributed to this spec.  Returns the
        particles dropped by redistribution (0 on the same-spec path)."""
        n_dropped = 0
        with self.timers.phase("load"):
            if checkpoint.is_sharded(path):
                meta = checkpoint._read_sharded_meta(path, self.cfg)["meta"]
                same = (meta.get("spec_type") == type(self.spec).__name__
                        and meta.get("spec") == self._spec_fp())
                if same:
                    leaves, meta = checkpoint.load_sharded(
                        path, self._shards(), expect_config=self.cfg)
                    self.state = state_from_numpy(dict(zip(FIELDS, leaves)),
                                                  self.device)
                else:
                    state, meta = checkpoint.load_sharded_host(
                        path, zero_state(1, "cpu"), expect_config=self.cfg)
                    n_dropped = self._redistribute(state)
            else:
                state, meta = checkpoint.load(
                    path, zero_state(self.cfg.slots, "cpu"),
                    expect_config=self.cfg)
                n_dropped = self._redistribute(state)
        self.frame = int(meta.get("frame", 0))
        self.last_stats = None
        return n_dropped

    def _redistribute(self, state: ParticleState) -> int:
        if state.slots != self.cfg.slots:
            raise ValueError(f"checkpoint of {state.slots} slots for a "
                             f"config of {self.cfg.slots}")
        state, n_dropped = _distribute(state, self.cfg, self.spec.splits())
        self.state = self._local(state)
        return n_dropped

    # -- validation -----------------------------------------------------------
    def _host_state_no_gather(self, scratch_dir: Optional[str]
                              ) -> ParticleState:
        """Global host copy of the state without gathering it: a lone rank
        holds it all; several write it as a sharded checkpoint on
        ``scratch_dir`` (a filesystem they share) and each assembles the
        others' rows from the files."""
        if self.mesh.size == 1:
            return self.state.to("cpu")
        if scratch_dir is None:
            raise ValueError(
                "multi-process validate() needs scratch_dir on a shared "
                "filesystem: the oracle's start state is assembled from a "
                "sharded checkpoint there (pass the same path on every rank)")
        path = os.path.join(scratch_dir, "pstpu_validate_start")
        checkpoint.save_sharded(path, self._shards(), meta=self._meta(),
                                group=self.mesh.group)
        state, _ = checkpoint.load_sharded_host(path, zero_state(1, "cpu"),
                                                expect_config=self.cfg)
        return state

    def validate(self, frames: int = 7,
                 scratch_dir: Optional[str] = None) -> dict:
        """Run the production step and the independent numpy oracle
        (``cpu_ref/oracle_nbody``) in lockstep from the current state:
        event counts must match exactly, alive rows to float tolerance.
        Shard-local: each rank reads only its own rows and joins them to
        the oracle's alive rows by persistent tag (placement-independent
        identity); a row whose tag the oracle lacks fails the check.  The
        default window, 7 frames, is inside the measured exact-parity
        horizon (tools/parity_horizon.py).  Does not advance the state."""
        from ..cpu_ref import oracle_nbody
        from ..cpu_ref.oracle_emitter import NpState

        dev = self.state.map(lambda a: a.clone())  # the step writes it
        ora = NpState.from_torch(self._host_state_no_gather(scratch_dir))
        events_match = True
        worst = 0.0
        n_local = 0
        for f in range(self.frame, self.frame + frames):
            dev, stats = self._step(dev, f)
            stats = {k: int(v) for k, v in zip(
                stats, torch.stack(list(stats.values())).tolist())}
            uvec, fert = nbody.frame_fields(
                self.cfg, f, torch.from_numpy(ora.tag.astype(np.int64)))
            ora, ostats = oracle_nbody.step(ora, uvec.numpy(), fert.numpy(),
                                            f, self.cfg)
            for k, v in ostats.items():
                if k in stats and stats[k] != v:
                    events_match = False
            o_rows = np.concatenate(
                [ora.pos, ora.vel, ora.age[:, None], ora.life[:, None]],
                axis=1)[ora.alive]
            o_tags = ora.tag[ora.alive]
            o_order = np.argsort(o_tags, kind="stable")
            o_tags, o_rows = o_tags[o_order], o_rows[o_order]
            t_d, rows_d = _alive_rows_by_tag(dev)
            n_local = len(t_d)
            if n_local:
                at = np.searchsorted(o_tags, t_d)
                found = ((at < len(o_tags))
                         & (o_tags[np.minimum(at, len(o_tags) - 1)] == t_d))
                if not found.all():
                    events_match = False
                else:
                    worst = max(worst,
                                float(np.abs(rows_d - o_rows[at]).max()))
            if self.mesh.size == 1 and n_local != stats["n_alive"]:
                events_match = False
        return {"events_match": events_match,
                "max_row_deviation": worst, "frames": frames,
                "local_alive": n_local}

    # -- profiling ------------------------------------------------------------
    def profile_frame(self, k1: int = 2, k2: int = 6, reps: int = 3) -> dict:
        """The frame's milliseconds: the median of ``reps`` slopes between
        batches of ``k1`` and ``k2`` frames of :meth:`run`'s loop (graph
        replays where it replays them), each from the current state, after
        a warm-up batch of ``k1`` (``utils/timers.slope_ms``: CUDA events
        on a card, the host clock on the CPU), so that a run's fixed cost
        cancels.  The sharded step is the unit: its stages are the
        single-device driver's (``api.NBodySimulation.profile_frame``) plus
        the exchanges.  Collective; the state (put back after each batch)
        and the frame are as they were."""
        if not 0 < k1 < k2:
            raise ValueError(f"need 0 < k1 < k2, got k1={k1} k2={k2}")
        self._enter()
        saved = self.state.map(lambda a: a.clone())

        def restore():
            for f in FIELDS:
                getattr(self.state, f).copy_(getattr(saved, f))

        def run_k(k):
            restore()
            self._batch(k)

        run_k(k1)  # the frame's eager run and capture, if it has none yet
        ms = slope_ms(run_k, k1, k2, max(1, reps), self.device)
        restore()
        self.timers.add("frame/full_frame", ms / 1e3)
        return {"full_frame": ms}

    # -- buffer sizing --------------------------------------------------------
    def autosize_buffers(self, frames: int = 10, margin: float = 2.0,
                         floor: int = 64) -> dict:
        """Run ``frames`` steps at the current capacities without advancing
        the state, take the mesh-wide high-water marks
        (``halo_used_max``, ``migration_used_max``) and rebuild the step
        with ``ceil(mark * margin)`` rows (at least ``floor``).  Returns
        the new sizes.  A later frame that still overflows warns in
        ``run``, and every drop is counted."""
        s = self.state.map(lambda a: a.clone())  # the step writes it
        halo_hw = mig_hw = 0
        for i in range(frames):
            s, stats = self._step(s, self.frame + i)
            h, m = torch.stack([stats["halo_used_max"],
                                stats["migration_used_max"]]).tolist()
            halo_hw, mig_hw = max(halo_hw, h), max(mig_hw, m)
        kw = dict(halo_capacity=max(floor, math.ceil(halo_hw * margin)),
                  migration_capacity=max(floor, math.ceil(mig_hw * margin)))
        if isinstance(self.spec, PencilSpec):
            kw["halo1_capacity"] = kw["halo_capacity"]
        self.spec = dataclasses.replace(self._spec_raw, **kw).derive(self.cfg)
        self._step = make_step(self.cfg, self.spec, self.mesh)
        if self.graphs is not None:
            self.graphs.retain()  # captured with the old capacities
        return kw


def decomposition(args):
    """The spec of the CLI's ``--decomp`` over ``--devices`` (the JAX
    CLI's split: pencil d3 = max(2, D/2), brick d3 = 2 and the rest
    halved), with ``--d3`` and ``--impl``."""
    d = args.devices
    if args.decomp in (None, "slab"):
        return SlabSpec(n_devices=d, impl=args.impl)
    if args.decomp == "pencil":
        d3 = args.d3 or max(2, d // 2)
        return PencilSpec(d3=d3, d1=d // d3, impl=args.impl)
    d3 = args.d3 or 2
    rest = d // d3
    d1 = max(2, rest // 2) if rest > 1 else 1
    return BrickSpec(d3=d3, d1=d1, d2=rest // d1, impl=args.impl)


def cli_rank(rank, group, args, cfg):
    """One rank of ``python -m particlesystem_tpu_torch nbody --devices D``
    (``args`` its parsed options)."""
    sim = DistributedNBodySimulation(cfg, decomposition(args), group=group,
                                     device=args.device)
    say = print if rank == 0 else (lambda *a, **k: None)
    if sim.n_fill_dropped:
        say(f"warning: {sim.n_fill_dropped} particles dropped at "
            f"distribution")
    if args.autosize:
        sizes = sim.autosize_buffers()
        say(f"autosized buffers: {sizes}")
    stats = sim.run(args.iterations, verbose=True, batch=args.batch)
    say(f"final: alive={stats['n_alive']} "
        f"degraded_batches={sim.n_degraded_frames}")
    if args.validate:
        parent = (os.path.dirname(os.path.abspath(args.save)) if args.save
                  else None)
        with shared_scratch(group, parent) as scratch:
            out = sim.validate(scratch_dir=scratch)
        say(f"validate (rank 0's rows, scratch {scratch}): {out}")
    if args.save:
        sim.save(args.save)
        say(f"sharded checkpoint written to {args.save}")
    say(sim.timers.report())


@contextlib.contextmanager
def shared_scratch(group, parent: Optional[str] = None):
    """A fresh directory for one collective use, the same on every rank of
    ``group`` (None: a lone process): rank 0 makes it in ``parent`` (the
    temp dir when None) and sends its name to the others.  On exit, once
    every rank is done with it, rank 0 removes it.  Across nodes ``parent``
    must be on a filesystem every rank shares."""
    import shutil
    import tempfile

    import torch.distributed as dist

    rank = 0 if group is None else dist.get_rank(group)
    name = [None]
    if rank == 0:
        if parent:
            os.makedirs(parent, exist_ok=True)
        name[0] = tempfile.mkdtemp(prefix="pstpu_scratch_", dir=parent)
    if group is not None:
        dist.broadcast_object_list(name, src=dist.get_global_rank(group, 0),
                                   group=group)
    try:
        yield name[0]
    finally:
        checkpoint._barrier(group)  # every rank is done with it
        if rank == 0:
            shutil.rmtree(name[0], ignore_errors=True)


def _alive_rows_by_tag(state: ParticleState):
    """(tags, rows) of a rank's alive particles, tag-sorted; ``rows`` packs
    (pos, vel, age, life)."""
    alive = state.alive.cpu().numpy()
    rows = torch.cat([state.pos, state.vel, state.age[:, None],
                      state.life[:, None]], dim=1).cpu().numpy()[alive]
    tags = (state.tag.cpu().numpy() & 0xFFFFFFFF).astype(np.uint32)[alive]
    order = np.argsort(tags, kind="stable")
    return tags[order], rows[order]
