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

import torch

from ..core import rng
from ..core.config import NBodyConfig
from ..core.state import FIELDS, ParticleState, zero_state
from ..ops import rng_kernel
from ..ops.compact import rank_table, write_rows
from ..ops.grid import (build_bins, chunk_occupancy, coords_to_cell,
                        wrap_positions)
from ..ops.neighbor import as_f32, collision_okey, neighbor_pass
from ..ops.neighbor_blocks import neighbor_pass_blocks


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
    FILL), 4)``, whose key ``i`` is ``fold_in(.., i)``; drawn in one
    threefry kernel launch on a card (``ops/rng_kernel.py``)."""
    fill = rng.FrameKey(cfg.seed, rng.FILL)
    kr, ks, ka, kf = (fill.fold(i) for i in range(4))
    return [rng_kernel.u01(kr, (n, 3)), rng_kernel.u01(ks, (n, 3)),
            rng_kernel.uniform(ka, (n,), cfg.min_adult_age,
                               cfg.max_adult_age),
            rng_kernel.uniform(kf, (n,), cfg.min_fertility_age,
                               cfg.max_fertility_age)]


def init_fill(cfg: NBodyConfig, device, n: int | None = None
              ) -> ParticleState:
    """Uniform initial fill — FILL_PARTICLES
    (``particleSystem.cpp:962-1048``): each coordinate is ``sign * r * range``
    with ``r ~ U[0,1)`` and a fair sign; age uniform adult, fertility age
    uniform.  Slots 0..n-1 are used in draw order.  Bit for bit the JAX
    package's ``init_fill``."""
    n = cfg.n_fill if n is None else n
    if n > cfg.slots:
        raise ValueError(f"n_fill={n} exceeds capacity {cfg.slots}")
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
    given the neighbor-pass results.  Returns (new_state, counts dict)."""
    dt = as_f32(cfg.dt)
    n = state.slots
    alive1 = state.alive & ~overflow
    age0 = state.age
    die_age = alive1 & (age0 > as_f32(cfg.particle_life))
    die_coll = alive1 & ~die_age & kill
    dead_now = die_age | die_coll | overflow
    survive = alive1 & ~die_age & ~die_coll & touch
    normal = alive1 & ~die_age & ~die_coll & ~survive

    # --- integrate (clamped Euler + torus wrap, particleSystem.cpp:1267-1302)
    dx = state.vel * dt + 0.5 * acc * dt * dt
    dx = torch.clamp(dx, -cfg.max_dx, cfg.max_dx)
    newpos, _ = wrap_positions(state.pos + dx, cfg.grid)
    v1 = torch.clamp(state.vel + acc * dt, -cfg.max_v, cfg.max_v)
    age1 = age0 + dt

    nm = normal[:, None]
    dm = dead_now[:, None]
    sm = survive[:, None]
    pos = torch.where(nm, newpos, torch.where(dm, 0.0, pos_w))
    vel = torch.where(nm, v1, torch.where(dm | sm, 0.0, state.vel))
    accf = torch.where(nm, acc, 0.0)
    age = torch.where(normal, age1,
                      torch.where(dead_now | survive, 0.0, age0))
    w = torch.where(dead_now, 0.0, state.w)
    lifef = torch.where(dead_now, 0.0, state.life)
    parent = torch.where(dead_now | survive, False, state.parent)
    alive2 = alive1 & ~dead_now

    # --- explosion reproduction (particleSystem.cpp:1307-1333) -----------
    explode = normal & (age1 >= state.life) & ~state.parent
    parent = parent | explode
    evel = uvec * as_f32(cfg.explosion_speed)
    vel = torch.where(explode[:, None], evel, vel)

    # children: the i-th exploding parent (ascending slot) fills the i-th
    # free slot (ascending), for i < k = min(n_child, n_free, budget);
    # children past the budget are dropped (mirrored by the oracle)
    e = min(cfg.max_spawns_per_frame, n)
    free = ~alive2
    n_child = _count(explode)
    k = torch.minimum(n_child, _count(free)).clamp(max=e)
    ok = torch.arange(e, device=n_child.device) < k
    src = rank_table(explode, e).clamp(max=n - 1)
    tgt = torch.where(ok, rank_table(free, e), n)

    child_tag = rng.tag_mix(state.tag[src], frame)
    pos = write_rows(pos, tgt, pos[src])
    vel = write_rows(vel, tgt, -evel[src])
    accf = write_rows(accf, tgt, 0.0)
    w = write_rows(w, tgt, as_f32(cfg.weight))
    age = write_rows(age, tgt, 0.0)
    lifef = write_rows(lifef, tgt, fert[src])
    alive_out = write_rows(alive2, tgt, True)
    parent = write_rows(parent, tgt, False)
    tag = write_rows(state.tag, tgt, child_tag)

    out = ParticleState(pos=pos, vel=vel, acc=accf, w=w, age=age,
                        life=lifef, alive=alive_out, parent=parent, tag=tag)
    counts = dict(
        n_alive=_count(alive_out),
        n_age_deaths=_count(die_age),
        n_collision_kills=_count(die_coll),
        n_overflow_kills=_count(overflow),
        n_survivals=_count(survive),
        n_spawned=k,
        # children dropped for lack of free slots in the operated width
        # (budget drops are excluded by the min with e); under
        # step(active=...) a nonzero value breaks the bit-exactness
        # contract and the driver fails loudly (api.NBodySimulation)
        n_spawn_capped=torch.clamp(n_child, max=e) - k,
    )
    return out, counts


def step_fields(state: ParticleState, uvec: torch.Tensor, fert: torch.Tensor,
                frame, cfg: NBodyConfig, impl: str = "blocks",
                list_width: int = 0) -> Tuple[ParticleState, NBodyStats]:
    """Deterministic step given the per-frame random fields ``uvec`` (N, 3)
    and ``fert`` (N,) (see :func:`frame_fields`); ``frame`` enters only
    through child tags.  ``impl`` and ``list_width`` as in :func:`step`."""
    if impl not in ("blocks", "dense"):
        raise ValueError(f"unknown neighbor pass {impl!r}")
    grid = cfg.grid
    pos_w, coords = wrap_positions(state.pos, grid)
    cell = coords_to_cell(coords, grid)
    if impl == "blocks":
        acc, kill, touch, overflow, max_occ, cell_counts, dropped = \
            neighbor_pass_blocks(state.pos, state.age, state.w, cell,
                                 state.alive, cfg, state.tag)
    else:
        bins = build_bins(cell, state.alive, grid.num_cells,
                          cfg.cell_capacity, list_width=list_width)
        acc, kill, touch = _neighbor_pass(state, bins.cell_list, cfg)
        overflow = bins.overflow
        max_occ = bins.max_cell_occupancy.to(torch.int64)
        dropped = bins.n_listed_dropped.to(torch.int64)
    out, counts = lifecycle_update(state, pos_w, overflow, acc, kill, touch,
                                   uvec, fert, frame, cfg)
    if impl == "blocks":
        # chunk occupancy is a reshape-sum over the per-cell counts
        cd, cf = grid.chunk_dim, grid.chunk_factor
        per_cell = cell_counts[:grid.num_cells].reshape(cf, cd, cf, cd, cf,
                                                        cd)
        max_chunk = per_cell.sum(dim=(1, 3, 5)).max()
    else:
        max_chunk = chunk_occupancy(bins.cell_of, state.alive & ~overflow,
                                    grid).max()
    stats = NBodyStats(
        n_listed_dropped=dropped,
        max_cell_occupancy=max_occ,
        max_chunk_occupancy=max_chunk,
        n_tail_alive=torch.zeros((), dtype=torch.int64, device=state.device),
        **counts,
    )
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
               active: int, list_width: int):
    """(the rows the frame operates on, their next state, stats): the whole
    state, or the prefix ``[0, active)`` with the alive rows beyond it
    counted in ``n_tail_alive``."""
    head = state
    if active and active < state.slots:
        head = state.map(lambda a: a[:active])
    uvec, fert = frame_fields(cfg, frame, head.tag)
    out, stats = step_fields(head, uvec, fert, frame, cfg, impl, list_width)
    if head is not state:
        stats.n_tail_alive = _count(state.alive[active:])
    return head, out, stats


def step(state: ParticleState, frame, cfg: NBodyConfig,
         impl: str = "blocks", active: int = 0, list_width: int = 0
         ) -> Tuple[ParticleState, NBodyStats]:
    """Full frame: per-frame random fields + physics.

    ``impl="blocks"`` is the cluster-pair pass (the CUDA kernel on a card;
    work scales with live particles).  ``impl="dense"`` is the cell-pair
    pass in plain tensor code, the reference beside the kernel; its
    ``list_width`` narrows the padded cell lists (cost grows with the
    square of the width), so size it from the previous frame's
    ``max_cell_occupancy`` (see ``api.NBodySimulation``) and keep
    ``stats.n_listed_dropped == 0``.

    ``active`` runs the whole frame on the slot prefix ``[0, active)``.
    Caller contract (see :func:`compact_state`): every alive row and enough
    dead headroom for a full spawn burst lie inside the prefix; then results
    are bit-identical to ``active=0``.  ``stats.n_tail_alive`` counts alive
    rows beyond the prefix, which were frozen this frame."""
    head, out, stats = _step_head(state, frame, cfg, impl, active,
                                  list_width)
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
    and writing the same buffers every replay.  Returns the stats."""
    head, out, stats = _step_head(state, frame, cfg, impl, active,
                                  list_width)
    for f in FIELDS:
        getattr(head, f).copy_(getattr(out, f))
    return stats
