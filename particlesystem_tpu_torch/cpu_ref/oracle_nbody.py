"""Numpy oracle for the n-body (reference-parity) scene.

Loop-level re-implementation of ``models/nbody.step_fields``, structured like
the reference host kernel (``particleSystem_calc_forces_host``,
the reference's ``source/code/src/particleSystem.cpp:1120-1383``, plus
``build_grid_host`` :1468-1537): per-particle scans over 27-cell neighbor
lists, explicit free-slot bookkeeping.  All float math in float32.

Discrete outcomes (alive masks, collision flags, kill/survive/spawn decisions,
slot allocation) must match the device path exactly; float trajectories match to
accumulation-order tolerance.
"""

from __future__ import annotations


import numpy as np

from ..core.config import NBodyConfig
from .oracle_emitter import NpState


def okey_np(tags: np.ndarray) -> np.ndarray:
    """Numpy mirror of ``ops.neighbor.collision_okey``: int32 bitcast of the
    persistent tag, clamped one above INT32_MIN (the no-collision
    sentinel).  Placement-independent collision-order key."""
    t = tags.astype(np.uint32).view(np.int32)
    return np.maximum(t, np.int32(np.iinfo(np.int32).min + 1))


def wrap_positions_np(pos: np.ndarray, grid):
    g = grid.grid_dim
    half = g // 2
    cs = np.float32(grid.cell_size)
    inv = np.float32(1.0) / cs
    i1 = np.floor(-pos[:, 1] * inv).astype(np.int32) + half
    i2 = np.floor(pos[:, 0] * inv).astype(np.int32) + half
    i3 = np.floor(-pos[:, 2] * inv).astype(np.int32) + half
    c = np.stack([i1, i2, i3], axis=-1)
    cw = np.mod(c, g)
    d = (cw - c).astype(np.float32)
    shift = np.stack([d[:, 1], -d[:, 0], -d[:, 2]], axis=-1) * cs
    return (pos + shift).astype(np.float32), cw


def step(s: NpState, uvec: np.ndarray, fert: np.ndarray, frame: int,
         cfg: NBodyConfig):
    f32 = np.float32
    grid = cfg.grid
    g = grid.grid_dim
    num_cells = grid.num_cells
    cap = cfg.cell_capacity
    n = len(s.age)
    dt = f32(cfg.dt)
    kid = f32(cfg.kid_age)
    lifec = f32(cfg.particle_life)
    r2 = f32(cfg.collision_radius) ** 2
    eps2 = f32(cfg.eps2)

    # --- BUILD_GRID ------------------------------------------------------
    pos_w, coords = wrap_positions_np(s.pos, grid)
    cell = coords[:, 2] * g * g + coords[:, 0] * g + coords[:, 1]

    cell_lists = [[] for _ in range(num_cells)]
    overflow = np.zeros(n, bool)
    for i in range(n):
        if s.alive[i]:
            c = int(cell[i])
            if len(cell_lists[c]) < cap:
                cell_lists[c].append(i)
            else:
                overflow[i] = True  # killed at grid build (cpp:1517-1531)
    alive1 = s.alive & ~overflow

    # snapshot (TDATA) = pre-step state
    pos0, age0, w0 = s.pos, s.age, s.w
    okey = okey_np(s.tag)  # tag-keyed collision order (see models/nbody.py)

    # --- neighbor pass ----------------------------------------------------
    acc = np.zeros((n, 3), f32)
    kill = np.zeros(n, bool)
    touch = np.zeros(n, bool)
    for i in range(n):
        if not alive1[i]:
            continue
        c1, c2, c3 = coords[i]
        neibs = []
        for d3 in (-1, 0, 1):
            for d1 in (-1, 0, 1):
                for d2 in (-1, 0, 1):
                    a1, a2, a3 = c1 + d1, c2 + d2, c3 + d3
                    if 0 <= a1 < g and 0 <= a2 < g and 0 <= a3 < g:
                        neibs.extend(cell_lists[a3 * g * g + a1 * g + a2])
        nj = np.array([j for j in neibs if j != i], np.int32)
        if nj.size == 0:
            continue
        diff = (pos0[nj] - pos0[i]).astype(f32)
        d2s = np.sum(diff * diff, axis=1, dtype=f32)
        adult = (age0[i] >= kid) & (age0[nj] >= kid)
        collide = (adult & (d2s <= r2) & (age0[i] <= lifec)
                   & (age0[nj] <= lifec))
        touch[i] = bool(collide.any())
        kill[i] = bool((collide & (okey[nj] > okey[i])).any())
        dd = (d2s + eps2).astype(f32)
        sfac = np.where(adult, w0[nj] / np.sqrt((dd * dd * dd).astype(f32)),
                        f32(0.0)).astype(f32)
        acc[i] = np.sum(diff * sfac[:, None], axis=0, dtype=f32)

    # --- lifecycle flags --------------------------------------------------
    die_age = alive1 & (age0 > lifec)
    die_coll = alive1 & ~die_age & kill
    dead_now = die_age | die_coll | overflow
    survive = alive1 & ~die_age & ~die_coll & touch
    normal = alive1 & ~die_age & ~die_coll & ~survive

    # --- integrate --------------------------------------------------------
    dx = (s.vel * dt + f32(0.5) * acc * dt * dt).astype(f32)
    dx = np.clip(dx, -f32(cfg.max_dx), f32(cfg.max_dx))
    newpos, _ = wrap_positions_np((s.pos + dx).astype(f32), grid)
    v1 = np.clip((s.vel + acc * dt).astype(f32), -f32(cfg.max_v), f32(cfg.max_v))
    age1 = (age0 + dt).astype(f32)

    nm, dm, sm = normal[:, None], dead_now[:, None], survive[:, None]
    pos = np.where(nm, newpos, np.where(dm, 0.0, pos_w)).astype(f32)
    vel = np.where(nm, v1, np.where(dm | sm, 0.0, s.vel)).astype(f32)
    accf = np.where(nm, acc, 0.0).astype(f32)
    age = np.where(normal, age1, np.where(dead_now | survive, 0.0, age0)).astype(f32)
    w = np.where(dead_now, 0.0, s.w).astype(f32)
    lifef = np.where(dead_now, 0.0, s.life).astype(f32)
    parent = np.where(dead_now | survive, False, s.parent)
    alive2 = alive1 & ~dead_now

    # --- explosion --------------------------------------------------------
    explode = normal & (age1 >= s.life) & ~s.parent
    parent = np.where(explode, True, parent)
    evel = (uvec * f32(cfg.explosion_speed)).astype(f32)
    vel = np.where(explode[:, None], evel, vel)

    free = np.flatnonzero(~alive2)
    parents = np.flatnonzero(explode)
    nfit = min(len(free), len(parents), cfg.max_spawns_per_frame)
    tgt, src = free[:nfit], parents[:nfit]
    pos[tgt] = pos[src]
    vel[tgt] = -evel[src]
    accf[tgt] = 0.0
    age[tgt] = 0.0
    lifef[tgt] = fert[src]
    w[tgt] = f32(cfg.weight)
    parent[tgt] = False
    tag = s.tag.copy()
    # child tag: Knuth multiplicative mix of (parent tag, frame) — rng.tag_mix
    mixed = (s.tag.astype(np.uint64) * 2654435761
             + np.uint64(frame) * 2246822519 + 977).astype(np.uint32)
    tag[tgt] = mixed[src]
    alive_out = alive2.copy()
    alive_out[tgt] = True

    stats = dict(
        n_alive=int(alive_out.sum()),
        n_age_deaths=int(die_age.sum()),
        n_collision_kills=int(die_coll.sum()),
        n_overflow_kills=int(overflow.sum()),
        n_survivals=int(survive.sum()),
        n_spawned=int(nfit),
        n_spawn_capped=int(min(len(parents), cfg.max_spawns_per_frame)
                           - nfit),
    )
    out = NpState(pos=pos, vel=vel, acc=accf, w=w, age=age, life=lifef,
                  alive=alive_out, parent=parent, tag=tag)
    return out, stats
