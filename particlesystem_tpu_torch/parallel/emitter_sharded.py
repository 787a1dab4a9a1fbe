"""Data-parallel emitter engine over a rank mesh.

Counterpart of ``particlesystem_tpu/parallel/emitter_sharded.py``.
Emitter scenes have no pairwise interactions, so scaling out is pure data
parallelism: each rank runs an independent :class:`PackedEngine` over
``capacity / D`` slots with ``1/D`` of every emitter's rate and the rank's
index folded into its spawn keys (``salt``), so its stream is its own.
No collective runs inside a frame; global counts reduce with ``psum`` on
demand.  D ranks simulate D times the particles at one rank's frame time.
So every rank runs its frames as its engine's graph replays (the JAX
engine's ``fori_loop`` inside ``shard_map``), over any backend, gloo
ranks that share a card included: the salt is the engine's, baked into
its graphs.

The checkpoint is the JAX engine's global layout: the fields of rank d at
rows ``[d*rows, (d+1)*rows)`` of ``(D*rows, ...)`` arrays, and a leading
rank axis on accum, free_list, cursor, n_free and frame.  :meth:`save`
writes it as a sharded directory (each rank its own rows); :meth:`load`
reads one of those, or the JAX engine's single ``.npz``, taking only this
rank's rows.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..core.config import EmitterSceneConfig
from ..runtime import checkpoint
from ..runtime.engine import (EngineState, PackedEngine,
                              engine_state_from_numpy, engine_state_to_numpy)
from ..utils.timers import PhaseTimers
from .mesh import rank_device


def _local_cfg(cfg: EmitterSceneConfig, d: int) -> EmitterSceneConfig:
    """Per-rank scene: capacity and emitter rates divided by ``d``."""
    emitters = tuple(dataclasses.replace(e, rate=e.rate / d)
                     for e in cfg.emitters)
    return dataclasses.replace(cfg, capacity=cfg.capacity // d,
                               emitters=emitters)


class ShardedEmitterEngine:
    """Data-parallel :class:`PackedEngine` over a 1-D ``mesh``
    (:class:`.mesh.RankMesh`); this rank's engine is ``self.local`` and its
    state an :class:`EngineState` of the local slots.  Collective only in
    :meth:`alive_count`, :meth:`save` and :meth:`load`."""

    def __init__(self, cfg: EmitterSceneConfig, mesh, alloc: str = "ring",
                 refresh_interval: int = 1, layout: str = "packed8",
                 device=None):
        if len(mesh.shape) != 1:
            raise ValueError(f"the emitter engine runs on a 1-D mesh, got "
                             f"shape {mesh.shape}")
        self.mesh = mesh
        self.axis = mesh.axes[0]
        self.d = mesh.size
        self.index = mesh.axis_index(self.axis)
        self.cfg = cfg
        self.timers = PhaseTimers("sharded_emitter.")
        self.local = PackedEngine(_local_cfg(cfg, self.d), alloc=alloc,
                                  refresh_interval=refresh_interval,
                                  layout=layout, device=rank_device(device),
                                  salt=self.index)

    def init(self) -> EngineState:
        return self.local.init()

    def step(self, s: EngineState) -> EngineState:
        """One frame of this rank's engine, salted with its index, as
        ``PackedEngine.step`` runs it (a graph replay on a card); consumes
        ``s`` and returns the engine's static state."""
        return self.step_many(s, 1)

    def step_many(self, s: EngineState, k: int) -> EngineState:
        """``k`` frames queued back to back, ``k`` graph replays on a
        card: bit for bit ``k`` :meth:`step` calls, and the eager frames
        ``local._frame(s, index)``."""
        with self.timers.phase("step"):
            return self.local.step_many(s, k)

    def alive_count(self, s: EngineState) -> int:
        """Alive slots over every rank."""
        n = self.local.alive_count(s).to(torch.int64)
        return int(self.mesh.psum(n))

    # -- persistence ----------------------------------------------------------
    def _meta(self) -> dict:
        return dict(d=self.d, alloc=self.local.alloc,
                    layout=self.local.layout,
                    **checkpoint.config_fingerprint(self.cfg))

    def _shards(self, s: EngineState):
        """This rank's leaves placed in the global layout."""
        leaves = engine_state_to_numpy(s)
        nf, i, d = self.local.n_fields, self.index, self.d
        out = []
        for k, a in enumerate(leaves):
            if k < nf:      # fields: rows [i*r, (i+1)*r) of (d*r, ...)
                r = a.shape[0]
                idx = [[i * r, (i + 1) * r]] + [[0, x] for x in a.shape[1:]]
                out.append(checkpoint.Shard(a, idx, (d * r,) + a.shape[1:]))
            else:           # bookkeeping: row i of (d, ...)
                idx = [[i, i + 1]] + [[0, x] for x in a.shape]
                out.append(checkpoint.Shard(a[None], idx, (d,) + a.shape))
        return out

    def save(self, path: str, s: EngineState) -> None:
        """Write the sharded checkpoint directory ``path`` (collective)."""
        with self.timers.phase("save"):
            checkpoint.save_sharded(path, self._shards(s), meta=self._meta(),
                                    group=self.mesh.group)

    def load(self, path: str, s: EngineState) -> EngineState:
        """Resume this rank from :meth:`save`'s directory or the JAX
        engine's ``.npz``; ``s`` (a state of this engine, e.g. ``init()``)
        gives shapes and device.  A checkpoint of another rank count,
        allocator, layout or scene is refused."""
        want = self._shards(s)
        with self.timers.phase("load"):
            if checkpoint.is_sharded(path):
                leaves, _ = checkpoint.load_sharded(
                    path, want, expect_config=self._meta())
            else:
                with np.load(path) as data:
                    meta = json.loads(
                        bytes(data["__meta__"]).decode())
                    checkpoint._check_config(meta, self._meta())
                    leaves = []
                    for k, w in enumerate(want):
                        a = data[f"leaf_{k}"]
                        if (a.shape != tuple(w.shape)
                                or a.dtype != w.data.dtype):
                            raise ValueError(
                                f"checkpoint leaf {k} {a.dtype}{a.shape} != "
                                f"{w.data.dtype}{tuple(w.shape)}")
                        leaves.append(a[tuple(slice(lo, hi)
                                              for lo, hi in w.index)])
        nf = self.local.n_fields
        leaves = list(leaves[:nf]) + [a[0] for a in leaves[nf:]]
        return engine_state_from_numpy(leaves, self.local)
