"""Packed-state frame engine: the sim loop of emitter scenes.

Counterpart of ``particlesystem_tpu/runtime/engine.py``.  A frame is
spawn-row generation (``models/emitter.spawn_fields``), the physics kernel
(``ops/physics_kernel.physics_step``: CUDA on a card, the plain version on
the CPU), and the allocator's bookkeeping and spawn write, with no host
synchronisation: ``cursor``, ``n_free``, ``free_list`` and ``accum`` stay
device tensors, and the frame index lives on the host (``EngineState.frame``)
and, for the frame's draws, on the device.

The frame the graphs run (:meth:`PackedEngine._static_frame`) is the
kernels of ``ops/engine_kernels.py`` around the physics kernel: the spawn
kernel writes the engine's own window (rows, valid and the next accum,
buffers of the engine and not of the state), the physics kernel reads it
(``strided``, ``select``) or the ring kernel writes it into the fields
(``ring``), and the tail kernel carries accum, the cursor and the device
frame; ``exact`` takes its rows from the window and keeps its plain
free-list refresh and write.  On the CPU the same composition runs the
plain versions.

:meth:`PackedEngine.step` and :meth:`~PackedEngine.step_many` run the frame
as a CUDA graph (``utils/frame_graph.FrameGraphs``), the counterpart of the
JAX engine's jitted frame and its ``fori_loop``: the engine keeps one
static state, whose tensors the graph reads and writes, and the frame
index on the device, which the graph increments; each frame is one
replay.  The first state stepped lends its own tensors to that role; a
state from elsewhere (``init()``, ``checkpoint.load``,
:func:`engine_state_from_numpy`) is copied into them once.  ``alloc="exact"``
refreshes its free list every ``refresh_interval`` frames, a branch taken
on the host: it has two graphs, with and without the refresh, and the host
picks one a frame.  On the CPU the same frame function runs eagerly on the
same static state.  :meth:`PackedEngine._frame` is the frame itself,
eager and functional: the reference the graphs are held to, and the
sharded engine's frame.

State is per-field float32 tensors: ``packed8`` (x, y, z, vx, vy, vz, age,
life; dead rows frozen) or ``slim`` (x, y, z, vx, vy, vz, death_frame;
liveness ``frame < death``, expired rows keep integrating until respawn).

Allocation policies (``alloc=``):

* ``"exact"`` — dead slots ascending, refreshed every ``refresh_interval``
  frames by cumsum compaction; ``refresh_interval=1`` reproduces
  ``models/emitter.step_core``.
* ``"ring"`` — slots reused in spawn order through a ring cursor and a
  shadow region of one padded budget.
* ``"strided"`` — the cursor advances by the whole padded budget ``W`` each
  frame; needs ``slots % W == 0``.  The spawn write rides the physics
  kernel's window, so a frame is one kernel launch.
* ``"select"`` — ``strided`` over ``(slots/W, W)`` views of the same flat
  buffers (the JAX package's 2-D layout, kept so states carry across); the
  kernel sees the flat buffers.

Every (alloc, layout) pair runs through the kernel on the card, except
that ``slim`` needs a ring-type allocator.  :meth:`PackedEngine.step`
consumes its input state (JAX's engine donates it) and returns the
engine's static state, which the next step overwrites.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import EmitterSceneConfig
from ..models import emitter as em
from ..ops import engine_kernels as ek
from ..ops import fused_step as fs
from ..ops.neighbor import as_f32
from ..ops.physics_kernel import physics_step
from ..utils.device import resolve_device
from ..utils.frame_graph import FrameGraphs
from ..utils.timers import span


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class EngineState:
    fields: Tuple[torch.Tensor, ...]  # n_fields x (N [+ shadow],) float32
    accum: torch.Tensor      # (n_emitters,) float32 fractional spawn credit
    free_list: torch.Tensor  # (L,) int32 dead slots, padded with N (exact)
    cursor: torch.Tensor     # 0-dim int32: consumed entries / ring position
    n_free: torch.Tensor     # 0-dim int32: valid free-list entries
    frame: int

    @property
    def n_fields(self) -> int:
        return len(self.fields)

    @property
    def device(self) -> torch.device:
        return self.fields[0].device

    @property
    def packed(self) -> torch.Tensor:
        """(n_fields, ...) stacked copy of the fields, for readback and
        inspection."""
        return torch.stack(self.fields)

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return (*self.fields, self.accum, self.free_list, self.cursor,
                self.n_free)


class PackedEngine:
    """Frame loop over per-field SoA state on ``device`` (default: the
    card; ``device="cpu"`` runs the plain versions).  ``salt`` is folded
    into the spawn keys of every frame :meth:`step` runs (a rank's index
    in ``parallel/emitter_sharded``; 0 for one engine)."""

    def __init__(self, cfg: EmitterSceneConfig, refresh_interval: int = 1,
                 free_list_size: Optional[int] = None, alloc: str = "exact",
                 layout: str = "packed8", device="cuda", salt: int = 0):
        if alloc not in ("exact", "ring", "strided", "select"):
            raise ValueError(f"unknown alloc policy {alloc!r}")
        if layout not in ("packed8", "slim"):
            raise ValueError(f"unknown layout {layout!r}")
        if layout == "slim" and alloc == "exact":
            raise ValueError("layout='slim' requires alloc='ring'/'strided'/"
                             "'select'")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.alloc = alloc
        self.layout = layout
        self.n_fields = 7 if layout == "slim" else 8
        self.refresh_interval = int(refresh_interval)
        self.salt = int(salt)
        budget = cfg.max_spawn_per_step * self.refresh_interval
        self.free_list_size = int(free_list_size or max(1024, 4 * budget))
        # ring mode: shadow region sized to the (padded) spawn budget
        self.spawn_width = _round_up(cfg.max_spawn_per_step, 1024)
        self.shadow = self.spawn_width if alloc == "ring" else 0
        if alloc in ("strided", "select") and cfg.slots % self.spawn_width:
            raise ValueError(
                f"alloc={alloc!r} needs slots ({cfg.slots}) divisible by "
                f"the padded spawn budget ({self.spawn_width}); round the "
                f"capacity or use alloc='ring'")
        self.total = cfg.slots + self.shadow
        self.b_rows = (cfg.slots // self.spawn_width if alloc == "select"
                       else None)
        self.field_shape = ((self.b_rows, self.spawn_width)
                            if alloc == "select" else (self.total,))
        self._table = em.SpawnTable(cfg, self.device)
        # the spawn kernel's window, which the physics or the ring kernel
        # reads, and the next accum, which the tail kernel copies in
        self._window = ek.new_window(self.n_fields, self.spawn_width,
                                     max(1, len(cfg.emitters)), self.device)
        # the frame loop: the static state the graphs read and write, its
        # frame on the device, one graph a refresh branch
        self.graphs = FrameGraphs(self.device)
        self._static: Optional[EngineState] = None
        self._frame_t: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    def init(self, fields: Optional[Sequence] = None) -> EngineState:
        """Initial state from ``fields`` (tensors or arrays, copied to the
        engine's device; all slots dead when None).  ``slim`` accepts
        packed8 fields and converts (age, life) to death frames; ``select``
        accepts flat or ``(slots/W, W)`` fields; ``ring`` pads the shadow."""
        n = self.cfg.slots
        dev = self.device
        if fields is None:
            fields = tuple(torch.zeros((n,), device=dev)
                           for _ in range(self.n_fields))
        fields = tuple(torch.as_tensor(f, dtype=torch.float32, device=dev)
                       for f in fields)
        if self.layout == "slim" and len(fields) == 8:
            # packed8 integrates a row while age <= life, i.e.
            # floor((life-age)/dt) + 1 more frames from here (boundary
            # inclusive: an age == life row is still alive); dead -> 0
            x, y, z, vx, vy, vz, age, life = fields
            alive = (age <= life) & (life > 0)
            steps = torch.floor((life - age) / as_f32(self.cfg.dt)) + 1.0
            fields = (x, y, z, vx, vy, vz, torch.where(alive, steps, 0.0))
        if len(fields) != self.n_fields:
            raise ValueError(f"{len(fields)} fields given, the {self.layout}"
                             f" layout has {self.n_fields}")
        if self.alloc == "select":
            fields = tuple(f.reshape(self.field_shape) for f in fields)
        elif fields[0].shape[0] == n and self.shadow:
            pad = torch.zeros((self.shadow,), device=dev)
            fields = tuple(torch.cat([f, pad]) for f in fields)
        # own contiguous copies: step() updates them in place on a card
        fields = tuple(f.clone(memory_format=torch.contiguous_format)
                       for f in fields)
        if fields[0].shape != self.field_shape:
            raise ValueError(f"fields of shape {tuple(fields[0].shape)}, "
                             f"expected {self.field_shape}")
        if self.layout == "slim" or self.alloc in ("strided", "select"):
            fl = torch.zeros((1,), dtype=torch.int32, device=dev)
            n_free = torch.zeros((), dtype=torch.int32, device=dev)
        else:
            fl, n_free = fs.refresh_free_list(fields, self.free_list_size)
        return EngineState(
            fields=fields,
            accum=torch.zeros((max(1, len(self.cfg.emitters)),), device=dev),
            free_list=fl, n_free=n_free,
            cursor=torch.zeros((), dtype=torch.int32, device=dev), frame=0)

    # ------------------------------------------------------------------
    def _frame(self, s: EngineState, salt: int = 0, frame=None,
               refresh: Optional[bool] = None) -> EngineState:
        """One frame from ``s``, eager; consumes ``s`` (its fields may be
        updated in place).  ``frame`` is ``s.frame`` on the device for the
        draws (a 0-dim int64 tensor; ``s.frame`` itself when None);
        ``refresh`` says whether ``alloc="exact"`` refreshes its free list
        (``s.frame % refresh_interval == 0`` when None)."""
        cfg = self.cfg
        fr = s.frame if frame is None else frame
        rows, valid, accum = ek.spawn_rows_plain(
            cfg, self._table, s.accum, fr, salt, self.layout == "slim")
        free_list, n_free, cursor = s.free_list, s.n_free, s.cursor

        if self.alloc in ("strided", "select"):
            # physics and the spawn window in one launch; the cursor
            # advances here, on the device
            window = (*ek.pad_window(rows, valid, self.spawn_width),
                      cursor)
            flat = physics_step(tuple(f.view(-1) for f in s.fields), cfg,
                                window)
            fields = tuple(f.view(self.field_shape) for f in flat)
            cursor = torch.remainder(cursor + self.spawn_width, cfg.slots)
        elif self.alloc == "ring":
            fields = physics_step(s.fields, cfg)
            prow, pvalid = ek.pad_window(rows, valid, self.spawn_width)
            fields, cursor = fs.ring_spawn(fields, tuple(prow), pvalid,
                                           cursor, cfg.slots)
        else:
            fields = physics_step(s.fields, cfg)
            if refresh is None:
                refresh = s.frame % self.refresh_interval == 0
            if refresh:
                free_list, n_free = fs.refresh_free_list(
                    fields, self.free_list_size)
                cursor = torch.zeros_like(cursor)
            fields, cursor = fs.spawn_exact(fields, rows, valid, free_list,
                                            cursor, n_free)

        return EngineState(fields=tuple(fields), accum=accum,
                           free_list=free_list, cursor=cursor, n_free=n_free,
                           frame=s.frame + 1)

    # ------------------------------------------------------------------
    def _enter(self, s: EngineState) -> EngineState:
        """The static state, holding ``s``: ``s`` itself when it is the
        static state (the engine's own output); the first state's tensors
        become the static ones; any other state is copied in."""
        st = self._static
        if s is st:
            return st
        if st is None:
            self._static = st = dataclasses.replace(s)
            self._frame_t = torch.full((), s.frame, dtype=torch.int64,
                                       device=self.device)
            return st
        pairs = list(zip(st.tensors(), s.tensors(), strict=True))
        for dst, src in pairs:
            if dst.shape != src.shape:
                raise ValueError(f"a state of shape {tuple(src.shape)} "
                                 f"where this engine's has "
                                 f"{tuple(dst.shape)}")
        for dst, src in pairs:
            dst.copy_(src)
        st.frame = s.frame
        self._frame_t.fill_(s.frame)
        return st

    def _static_frame(self, refresh: bool) -> None:
        """The frame the graphs capture: the static state to the next, in
        place, and the device frame one on; the engine's salt is baked
        in.  Spawn kernel, physics kernel (with the window for
        ``strided``/``select``), the ring kernel (``ring``) and the tail
        kernel, or their plain versions on the CPU: bit for bit
        :meth:`_frame`."""
        st, cfg = self._static, self.cfg
        win = ek.spawn_window(cfg, self._table, st.accum, self._frame_t,
                              self.salt, self._window)
        advance = 0
        if self.alloc in ("strided", "select"):
            flat = tuple(f.view(-1) for f in st.fields)
            _put(flat, physics_step(flat, cfg, (win.rows, win.valid,
                                                st.cursor)))
            advance = self.spawn_width
        elif self.alloc == "ring":
            _put(st.fields, physics_step(st.fields, cfg))
            ek.ring_write(st.fields, win.rows, win.valid, st.cursor,
                          cfg.slots)
        else:
            # the window's first rows are spawn_fields' rows; the free
            # list's refresh and write stay plain
            fields = physics_step(st.fields, cfg)
            free_list, n_free, cursor = st.free_list, st.n_free, st.cursor
            if refresh:
                free_list, n_free = fs.refresh_free_list(
                    fields, self.free_list_size)
                cursor = torch.zeros_like(cursor)
            n = max(1, self._table.total)
            fields, cursor = fs.spawn_exact(fields, tuple(win.rows[:, :n]),
                                            win.valid[:n], free_list, cursor,
                                            n_free)
            _put(st.fields, fields)
            _put((st.free_list, st.n_free, st.cursor),
                 (free_list, n_free, cursor))
        ek.frame_tail(st.accum, win.accum, st.cursor, self._frame_t, advance,
                      cfg.slots)

    def _refreshes(self, frame: int) -> bool:
        """Whether ``frame`` refreshes ``alloc="exact"``'s free list: a
        branch taken on the host, so the key of the frame's graph (every
        other allocator has one graph, False)."""
        return (self.alloc == "exact"
                and frame % self.refresh_interval == 0)

    def step(self, s: EngineState) -> EngineState:
        """One frame, one graph replay on a card; consumes ``s`` and
        returns the engine's static state."""
        return self.step_many(s, 1)

    def step_many(self, s: EngineState, k: int) -> EngineState:
        """``k`` frames queued back to back, with no host synchronisation:
        ``k`` graph replays on a card."""
        with span("engine.batch", n=k):
            st = self._enter(s)
            for _ in range(k):
                refresh = self._refreshes(st.frame)
                self.graphs.step(refresh,
                                 lambda: self._static_frame(refresh))
                st.frame += 1
        return st

    def flat_fields(self, s: EngineState) -> Tuple[torch.Tensor, ...]:
        """Per-field ``(slots,)`` views of the live region: drops the ring
        shadow and flattens the select layout (slot ``i`` is element
        ``(i // W, i % W)``, so flattening keeps slot order)."""
        if self.alloc == "select":
            return tuple(f.reshape(-1) for f in s.fields)
        return tuple(f[: self.cfg.slots] for f in s.fields)

    def alive_count(self, s: EngineState) -> torch.Tensor:
        """Alive slots, as a 0-dim device tensor."""
        if self.layout == "slim":
            death = self._live_region(s.fields[6])
            return fs.alive_mask_slim(death, s.frame).sum()
        age = self._live_region(s.fields[6])
        life = self._live_region(s.fields[7])
        return ((age <= life) & (life > 0)).sum()

    def _live_region(self, f: torch.Tensor) -> torch.Tensor:
        """The real slots of one field, in native shape (no flatten)."""
        return f if self.alloc == "select" else f[: self.cfg.slots]


def _put(dst, src) -> None:
    """Copy each tensor of ``src`` into its static counterpart in ``dst``,
    unless it is that tensor (a kernel's in-place result)."""
    for d, t in zip(dst, src, strict=True):
        if t.data_ptr() != d.data_ptr():
            d.copy_(t)


def engine_state_from_numpy(leaves: Sequence, like) -> EngineState:
    """An :class:`EngineState` from the leaves of a JAX-package
    ``EngineState`` taken with ``np.asarray``, in its field order: the
    ``n_fields`` field arrays (native shape), then accum, free_list,
    cursor, n_free, frame.  ``like``, a :class:`PackedEngine` or an
    :class:`EngineState`, gives the device and the number of fields."""
    nf = like.n_fields
    if len(leaves) != nf + 5:
        raise ValueError(f"{len(leaves)} leaves, expected {nf + 5}")
    dev = like.device

    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    accum, free_list, cursor, n_free, frame = leaves[nf:]
    return EngineState(
        fields=tuple(t(a, torch.float32) for a in leaves[:nf]),
        accum=t(accum, torch.float32), free_list=t(free_list, torch.int32),
        cursor=t(cursor, torch.int32).reshape(()),
        n_free=t(n_free, torch.int32).reshape(()), frame=int(frame))


def engine_state_to_numpy(state: EngineState) -> list:
    """Inverse of :func:`engine_state_from_numpy`: the leaves as numpy
    arrays, in the JAX package's order (frame as a 0-dim int32)."""
    arr = lambda x: x.detach().cpu().numpy()
    return ([arr(f) for f in state.fields]
            + [arr(state.accum), arr(state.free_list), arr(state.cursor),
               arr(state.n_free), np.asarray(state.frame, np.int32)])
