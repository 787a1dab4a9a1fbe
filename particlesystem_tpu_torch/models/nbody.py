"""The reference particle simulation in PyTorch.

Counterpart of ``particlesystem_tpu/models/nbody.py``, with the same
per-frame semantics (the reference's ``source/code/src/particleSystem.cpp``):

    BUILD_GRID  (:1468)  -> sort-based binning + cell-overflow kill
    CALC_FORCES (:1120)  -> age death, pairwise collision kill/survive,
                            softened gravity over the 27-cell stencil,
                            clamped Euler integration, torus wrap, aging,
                            explosion reproduction

Collision resolution is an order-free reduction keyed on the persistent
particle tag (``ops/neighbor.collision_okey``); free slots are allocated by
ascending dead slot to ascending exploding parent under a per-frame budget;
neighbor reads use the previous frame's state.  A frame never waits for the
host: no ``nonzero``, no boolean-mask indexing, no ``.item()`` — the
statistics stay on the device as 0-dim tensors.  The frame index is a
Python int or a 0-dim int64 tensor on the state's device (JAX's traced
``int32``): the draws, the child tags and everything else give the same
bits either way, and a frame that takes it from the device can be
captured in a CUDA graph and replayed frame after frame
(``api.NBodySimulation``, :func:`step_into`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core import rng
from ..core.config import NBodyConfig
from ..core.state import FIELDS, ParticleState, zero_state
from ..ops import frame_kernels as fk
from ..ops import neighbor_blocks as nbk
from ..ops import rng_kernel
from ..ops.grid import (build_bins, chunk_occupancy, coords_to_cell,
                        wrap_positions)
from ..ops.neighbor import collision_okey, neighbor_pass
from ..utils.cuda_build import by_device
from ..utils.timers import span


@dataclasses.dataclass
class NBodyStats:
    """Per-frame statistics, 0-dim integer tensors on the state's device."""

    n_alive: torch.Tensor
    n_age_deaths: torch.Tensor
    n_collision_kills: torch.Tensor
    n_overflow_kills: torch.Tensor
    n_survivals: torch.Tensor
    n_spawned: torch.Tensor
    # children dropped because the operated width ran out of free slots
    # (full width: genuine saturation; active prefix: contract violation)
    n_spawn_capped: torch.Tensor
    n_listed_dropped: torch.Tensor
    max_cell_occupancy: torch.Tensor
    max_chunk_occupancy: torch.Tensor
    # alive rows beyond the active prefix (step(active=...) misuse guard;
    # always 0 on full-width steps)
    n_tail_alive: torch.Tensor


def fill_draws(cfg: NBodyConfig, n: int) -> list:
    """:func:`init_fill`'s four draws of ``n`` particles (positions,
    signs, ages, fertility ages) at frame 0: ``split(frame_key(seed, 0,
    FILL), 4)``, whose key ``i`` is ``fold_in(.., i)``."""
    fill = rng.FrameKey(cfg.seed, rng.FILL)
    kr, ks, ka, kf = (fill.fold(i) for i in range(4))
    return [rng_kernel.u01(kr, (n, 3)), rng_kernel.u01(ks, (n, 3)),
            rng_kernel.uniform(ka, (n,), cfg.min_adult_age,
                               cfg.max_adult_age),
            rng_kernel.uniform(kf, (n,), cfg.min_fertility_age,
                               cfg.max_fertility_age)]


def _f32(x: float) -> float:
    return float(np.float32(x))


def fill_args(cfg: NBodyConfig, n: int) -> rng_kernel.Fill:
    """The fill kernel's scalars for :func:`init_fill` of ``n`` particles:
    :func:`fill_draws`' purpose key and split indices, without building
    the draws, and the ranges rounded to float32 as torch rounds a Python
    scalar."""
    lo_a, lo_f = cfg.min_adult_age, cfg.min_fertility_age
    return rng_kernel.Fill(
        key=rng.FrameKey(cfg.seed, rng.FILL).purpose_key, words=(0, 1, 2, 3),
        n=n, slots=cfg.slots, half_extent=_f32(cfg.grid.half_extent),
        weight=_f32(cfg.weight),
        age=(_f32(lo_a), _f32(cfg.max_adult_age - lo_a)),
        life=(_f32(lo_f), _f32(cfg.max_fertility_age - lo_f)))


def init_fill_plain(cfg: NBodyConfig, device, n: int) -> ParticleState:
    """The fill kernel's plain version: the draws, then the state written
    field by field (some 20 launches on a card)."""
    r, u_sign, age, life = rng_kernel.flat_fields(fill_draws(cfg, n), 0,
                                                  device)
    sign = torch.where(u_sign >= 0.5, 1.0, -1.0)
    s = zero_state(cfg.slots, device)
    s.pos[:n] = sign * r * cfg.grid.half_extent
    s.age[:n] = age
    s.life[:n] = life
    s.w[:n] = cfg.weight
    s.alive[:n] = True
    s.tag = torch.arange(cfg.slots, dtype=torch.int64, device=device)
    return s


def init_fill(cfg: NBodyConfig, device, n: int | None = None
              ) -> ParticleState:
    """Uniform initial fill — FILL_PARTICLES
    (``particleSystem.cpp:962-1048``): each coordinate is ``sign * r * range``
    with ``r ~ U[0,1)`` and a fair sign; age uniform adult, fertility age
    uniform.  Slots 0..n-1 are used in draw order.  Bit for bit the JAX
    package's ``init_fill``.  On a card one launch of the fill kernel
    (``ops/rng_kernel.nbody_fill_cuda``), on the CPU its plain version."""
    n = cfg.n_fill if n is None else n
    if n > cfg.slots:
        raise ValueError(f"n_fill={n} exceeds capacity {cfg.slots}")
    dev = torch.device(device)
    fill = by_device(dev, "fill", _fill_cuda, init_fill_plain)
    with span("nbody.fill", n=n):
        return fill(cfg, dev, n)


def _fill_cuda(cfg: NBodyConfig, device, n: int) -> ParticleState:
    return rng_kernel.nbody_fill_cuda(fill_args(cfg, n), device)


def frame_fields(cfg: NBodyConfig, frame, tags: torch.Tensor):
    """Per-slot random fields keyed by each slot's particle tag: explosion
    unit velocity (N, 3) and child fertility age (N,); one threefry kernel
    launch for CUDA tags (``ops/rng_kernel.py``), the frame read on the
    device."""
    return rng_kernel.nbody_fields(cfg.seed, frame, tags,
                                   cfg.min_fertility_age,
                                   cfg.max_fertility_age)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int64)


#: the statistics' names, in :class:`NBodyStats`' order
STAT_NAMES = tuple(f.name for f in dataclasses.fields(NBodyStats))


def _neighbor_pass(state: ParticleState, cell_list: torch.Tensor,
                   cfg: NBodyConfig, batch_cells: int = 0):
    """Collision flags and gravity over the 27-cell stencil by the dense
    pass: self-exclusion ids are slot indices, collision ordering keys on
    the persistent tags."""
    g = cfg.grid.grid_dim
    ids = torch.arange(state.slots, dtype=torch.int32, device=state.device)
    return neighbor_pass(state.pos, state.age, state.w, ids, cell_list,
                         (g, g, g), cfg, batch_cells=batch_cells,
                         okeys=collision_okey(state.tag))


def lifecycle_update(state: ParticleState, pos_w: torch.Tensor,
                     overflow: torch.Tensor, acc: torch.Tensor,
                     kill: torch.Tensor, touch: torch.Tensor,
                     uvec: torch.Tensor, fert: torch.Tensor, frame,
                     cfg: NBodyConfig):
    """Lifecycle flags + clamped integration + explosion reproduction,
    given the neighbor-pass results in slot order
    (``frame_kernels.lifecycle_flags``, then ``spawn_children``): the
    dense pass's and the decomposed step's lifecycle, and the plain
    version of the blocks frame's kernels D and E.  Returns (new_state,
    counts dict)."""
    nxt, explode, counts = fk.lifecycle_flags(state, pos_w, overflow, acc,
                                              kill, touch, uvec, cfg)
    out, k, n_child = fk.spawn_children(nxt, explode, fert, frame, cfg)
    e = min(cfg.max_spawns_per_frame, state.slots)
    return out, dict(
        n_alive=_count(out.alive),
        **counts,
        n_spawned=k,
        # children dropped for lack of free slots in the operated width
        # (budget drops are excluded by the min with e); under
        # step(active=...) a nonzero value breaks the bit-exactness
        # contract and the driver fails loudly (api.NBodySimulation)
        n_spawn_capped=torch.clamp(n_child, max=e) - k,
    )


def blocks_frame(state: ParticleState, out: ParticleState,
                 uvec: torch.Tensor, fert: torch.Tensor, frame,
                 cfg: NBodyConfig) -> NBodyStats:
    """The blocks frame from ``state`` into ``out`` (``state`` itself for a
    frame in place, as :func:`step_into` runs it), given the per-frame
    random fields; returns the stats, views of one buffer.

    A (cells, and the rows' records where they pay) -> the stable sort of
    the int32 keys, B (cell starts) and C (snapshot from the records or the
    state's arrays, chunk table, ``inv``, the counts) in
    ``frame_kernels.sort_and_prepare`` -> the pair kernel
    -> D (lifecycle, reading the pair outputs through ``inv``; the largest
    chunk) -> E (spawn): the CUDA kernels for CUDA tensors, their plain
    versions for CPU ones.  In place is safe: D reads a slot's fields
    before it writes them and touches no other slot, and E reads exploding
    parents and writes free slots, which are disjoint."""
    grid = cfg.grid
    key, rows = fk.cells_and_rows(state, grid)
    p = fk.sort_and_prepare(key, rows, cfg, nbk.C_MAX, nbk.CH, nbk.B,
                            grid=grid)
    acc_s, gmax_s = nbk.kernel_call(cfg, p.snap, p.chunks)
    flags, tiles = fk.nbody_lifecycle(state, out, acc_s, gmax_s,
                                      p.overflow_s, p.inv, uvec, cfg, p.stats)
    fk.nbody_spawn(out, fert, frame, flags, tiles, cfg, p.stats)
    return NBodyStats(**{f: p.stats[fk.STAT[f]] for f in STAT_NAMES})


def step_fields(state: ParticleState, uvec: torch.Tensor, fert: torch.Tensor,
                frame, cfg: NBodyConfig, impl: str = "blocks",
                list_width: int = 0, out: ParticleState | None = None
                ) -> Tuple[ParticleState, NBodyStats]:
    """Deterministic step given the per-frame random fields ``uvec`` (N, 3)
    and ``fert`` (N,) (see :func:`frame_fields`); ``frame`` enters only
    through child tags.  ``impl`` and ``list_width`` as in :func:`step`.
    The next state is written into ``out`` where given (``state`` itself
    for a frame in place), else into fresh tensors; returns it and the
    stats."""
    if impl not in ("blocks", "dense"):
        raise ValueError(f"unknown neighbor pass {impl!r}")
    if impl == "blocks":
        out = state.map(torch.empty_like) if out is None else out
        return out, blocks_frame(state, out, uvec, fert, frame, cfg)
    grid = cfg.grid
    pos_w, coords = wrap_positions(state.pos, grid)
    cell = coords_to_cell(coords, grid)
    bins = build_bins(cell, state.alive, grid.num_cells,
                      cfg.cell_capacity, list_width=list_width)
    acc, kill, touch = _neighbor_pass(state, bins.cell_list, cfg)
    nxt, counts = lifecycle_update(state, pos_w, bins.overflow, acc, kill,
                                   touch, uvec, fert, frame, cfg)
    max_chunk = chunk_occupancy(bins.cell_of, state.alive & ~bins.overflow,
                                grid).max()
    stats = NBodyStats(
        n_listed_dropped=bins.n_listed_dropped.to(torch.int64),
        max_cell_occupancy=bins.max_cell_occupancy.to(torch.int64),
        max_chunk_occupancy=max_chunk,
        n_tail_alive=torch.zeros((), dtype=torch.int64, device=state.device),
        **counts,
    )
    if out is None:
        return nxt, stats
    for f in FIELDS:
        getattr(out, f).copy_(getattr(nxt, f))
    return out, stats


#: active-prefix granularity (rows): coarse enough to bound the number of
#: distinct frame shapes, fine enough not to round up to a power of two
ACTIVE_QUANTUM = 1 << 18


def pick_active(cfg: NBodyConfig, alive: int,
                quantum: int = ACTIVE_QUANTUM) -> int:
    """Smallest quantized active prefix holding ``alive`` rows plus two full
    spawn-burst headrooms (prefix free slots never fall below one burst
    between re-checks, so the prefix never caps a spawn the full-width run
    would grant) and a 10% drift margin.  0 means full width."""
    need = int(alive * 1.1) + 2 * cfg.max_spawns_per_frame
    b = max(quantum, ((need + quantum - 1) // quantum) * quantum)
    return 0 if b >= cfg.slots else b


def compact_state(state: ParticleState) -> ParticleState:
    """Stable-partition alive rows to the slot prefix, slot order kept
    within each class.  Collision order keys on tags, which move with their
    rows, so renumbering slots does not change the physics."""
    n = state.slots
    iot = torch.arange(n, device=state.device)
    order = torch.argsort(torch.where(state.alive, iot, iot + n))
    return state.map(lambda a: a[order])


def _step_head(state: ParticleState, frame, cfg: NBodyConfig, impl: str,
               active: int, list_width: int, in_place: bool):
    """(the rows the frame operates on, their next state, stats): the whole
    state, or the prefix ``[0, active)`` with the alive rows beyond it
    counted in ``n_tail_alive``; the next state written over those rows
    ``in_place``, else into fresh tensors."""
    head = state
    if active and active < state.slots:
        head = state.map(lambda a: a[:active])
    uvec, fert = frame_fields(cfg, frame, head.tag)
    out, stats = step_fields(head, uvec, fert, frame, cfg, impl, list_width,
                             out=head if in_place else None)
    if head is not state:
        stats.n_tail_alive = _count(state.alive[active:])
    return head, out, stats


def step(state: ParticleState, frame, cfg: NBodyConfig,
         impl: str = "blocks", active: int = 0, list_width: int = 0
         ) -> Tuple[ParticleState, NBodyStats]:
    """Full frame: per-frame random fields + physics.

    ``impl="blocks"`` is the cluster-pair pass (on a card, the frame runs
    as the CUDA kernels of :func:`blocks_frame`; work scales with live
    particles).  ``impl="dense"`` is the cell-pair
    pass in plain tensor code, the reference beside the kernel; its
    ``list_width`` narrows the padded cell lists (cost grows with the
    square of the width), so size it from the previous frame's
    ``max_cell_occupancy`` (see ``api.NBodySimulation``) and keep
    ``stats.n_listed_dropped == 0``.

    ``active`` runs the whole frame on the slot prefix ``[0, active)``.
    Caller contract (see :func:`compact_state`): every alive row and enough
    dead headroom for a full spawn burst lie inside the prefix; then results
    are bit-identical to ``active=0``.  ``stats.n_tail_alive`` counts alive
    rows beyond the prefix, which were frozen this frame.  Returns fresh
    tensors, bit for bit what :func:`step_into` leaves."""
    head, out, stats = _step_head(state, frame, cfg, impl, active,
                                  list_width, in_place=False)
    if head is not state:
        tail = state.map(lambda a: a[active:])
        out = ParticleState(**{
            f: torch.cat([getattr(out, f), getattr(tail, f)])
            for f in FIELDS})
    return out, stats


def step_into(state: ParticleState, frame, cfg: NBodyConfig,
              impl: str = "blocks", active: int = 0, list_width: int = 0
              ) -> NBodyStats:
    """:func:`step` with the next state written into ``state``'s own
    tensors (the prefix's rows; the frozen tail stays where it is), bit for
    bit what :func:`step` returns: the frame a CUDA graph captures, reading
    and writing the same buffers every replay.  The blocks frame writes
    the state in place as it goes (kernels D and E of
    :func:`blocks_frame`), with no copy back; the dense frame copies its
    result back.  Returns the stats."""
    return _step_head(state, frame, cfg, impl, active, list_width,
                      in_place=True)[2]
