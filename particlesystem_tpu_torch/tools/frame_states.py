"""States that drive every branch of the n-body frame's kernels
(``ops/frame_kernels.py``, ``csrc/nbody_frame.cu``), and the checks that
hold each kernel to its plain version on them.

* :func:`edge_states` — small states made with numpy from a seed: a spawn
  burst over the per-frame budget, a container with no free slot, the
  tags 0x80000000 and 0xFFFFFFFF among colliding and exploding particles,
  cell-cap overflow rows beside all-dead blocks, a 2-chunk budget
  that drops chunks, and where E's ranking tiles end: k on a tile's
  boundary, and a slot count that is not a multiple of the tile with
  every parent in the last tile and every free slot in the first;
  :func:`dims_case` the decomposed step's inputs to
  ``prepare``: a non-cubic grid, explicit ids and -1-id padding rows;
  :func:`slab_case` one rank's halo-extended rows of a slab (its own
  slots, its neighbours' boundary planes, -1-id padding), on which D
  reads a pass of more rows than it has slots.
* :func:`hold_kernels` — on a card, A-E each against its plain version on
  the inputs one frame of a state gives it, bit for bit (every field,
  record, mask, tag, flag, tile count and statistic; A and C with records
  and without), D and E both into a fresh state and in place, E again
  after a call on other inputs, and D + E under two replays of one
  captured graph;
  :func:`hold_prepare` B and C on ``prepare``'s inputs; :func:`hold_slab`
  D and E on a :func:`slab_case`; :func:`hold_frames`
  whole frames of ``nbody.step`` against :func:`plain_frame`, the frame
  composed of the plain versions.

``chip_smoke.py`` (phase 15) runs the checks at full width and on these
states; ``tests/test_torch_frame_kernels.py`` holds the plain versions to
the JAX package on the same states.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.config import GridSpec, NBodyConfig
from ..core.state import FIELDS, ParticleState, zero_state
from ..models import nbody
from ..ops import frame_kernels as fk
from ..ops import neighbor_blocks as nbk
from ..utils.cuda_build import recording

#: the tags at the edges of the collision key and the child-tag mix
EDGE_TAGS = (0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000001, 0)


class EdgeState(NamedTuple):
    name: str
    cfg: NBodyConfig
    state: ParticleState
    frame: object          # a Python int or a 0-dim int64 on the device
    c_max: int | None      # the chunk budget (None: the module's)


def _cfg(**kw) -> NBodyConfig:
    return NBodyConfig(grid=GridSpec(grid_dim=4, cell_size=5.0,
                                     chunk_factor=2), **kw)


def _state(n: int, slots: int, pos, age, life, tags, device,
           parent=None, vel=None, where=None) -> ParticleState:
    """``n`` alive particles in slots 0..n-1 of ``slots``, or in the
    slots ``where``."""
    s = zero_state(slots, "cpu")
    at = (slice(0, n) if where is None
          else torch.from_numpy(np.asarray(where, np.int64)))
    s.pos[at] = torch.from_numpy(np.asarray(pos, np.float32))
    s.age[at] = torch.from_numpy(np.asarray(age, np.float32))
    s.life[at] = torch.from_numpy(np.asarray(life, np.float32))
    s.w[at] = 60.0
    s.alive[at] = True
    if vel is not None:
        s.vel[at] = torch.from_numpy(np.asarray(vel, np.float32))
    if parent is not None:
        s.parent[at] = torch.from_numpy(np.asarray(parent))
    s.tag = torch.from_numpy(np.asarray(tags, np.int64))
    return s.to(device)


def _lattice(n: int, rng, half: float = 10.0) -> np.ndarray:
    """``n`` points of a jittered lattice over the box, more than twice
    the contact radius apart."""
    side = int(np.ceil(n ** (1 / 3)))
    step = 2 * half / side
    ijk = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)[:n]
    return -half + (ijk + 0.5) * step + rng.uniform(-0.2, 0.2, (n, 3))


def edge_states(device, seed: int = 5) -> list:
    """The edge states of the frame kernels, each on ``device``."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    frame_t = torch.tensor(7, dtype=torch.int64, device=dev)
    out = []

    # every alive particle explodes, far past the spawn budget; the upper
    # half of the slots is dead, so the last sorted blocks are all dead
    cfg = _cfg(n_fill=2048, capacity=4096, spawn_budget=64)
    n = 2048
    tags = rng.integers(0, 2 ** 32, 4096)
    tags[:len(EDGE_TAGS)] = EDGE_TAGS          # edge tags among the parents
    out.append(EdgeState("burst", cfg, _state(
        n, 4096, _lattice(n, rng), np.full(n, 3.0), np.full(n, 1.0), tags,
        dev, vel=rng.uniform(-1, 1, (n, 3))), frame_t, None))

    # the same, every slot alive: no free slot for a child
    cfg = _cfg(n_fill=2048, capacity=2048, spawn_budget=64)
    out.append(EdgeState("full", cfg, _state(
        n, 2048, _lattice(n, rng), np.full(n, 3.0), np.full(n, 1.0),
        rng.integers(0, 2 ** 32, 2048), dev), 3, None))

    # a crowded box: collisions between the edge tags (0x80000000 and
    # 0x80000001 share a key), parents, kids and the too old; and a
    # 2-chunk budget on the same state
    cfg = _cfg(n_fill=3000, capacity=4096, max_per_cell=48, seed=3)
    n = 3000
    pos = rng.uniform(-10.0, 10.0, (n, 3))
    for k, t in enumerate(EDGE_TAGS):          # pairs in contact
        pos[2 * k + 1] = pos[2 * k] + 0.1
    tags = rng.integers(0, 2 ** 32, 4096)
    tags[0:2 * len(EDGE_TAGS):2] = EDGE_TAGS
    tags[1:2 * len(EDGE_TAGS):2] = EDGE_TAGS[::-1]
    age = rng.uniform(0.0, 16.0, n)            # kids, adults, the too old
    life = rng.uniform(1.0, 30.0, n)
    parent = rng.random(n) < 0.3
    state = _state(n, 4096, pos, age, life, tags, dev, parent=parent,
                   vel=rng.uniform(-12, 12, (n, 3)))
    out.append(EdgeState("tags", cfg, state, frame_t, None))
    out.append(EdgeState("cmax2", cfg, state, 11, 2))

    # a cap of 8 a cell over particles crowded into a corner: overflow
    # rows, and the grid's other cells empty
    cfg = _cfg(n_fill=1000, capacity=2048, max_per_cell=8, seed=9)
    n = 1000
    out.append(EdgeState("overflow", cfg, _state(
        n, 2048, rng.uniform(-10.0, -1.0, (n, 3)), rng.uniform(1.0, 14.0, n),
        rng.uniform(1.0, 30.0, n), rng.integers(0, 2 ** 32, 2048), dev),
        frame_t, None))

    # where E's ranking tiles end.  k on a tile's boundary: the first tile
    # holds e = 2048 exploding parents (its even slots) and e free slots
    # (its odd ones), so both kinds reach k = e exactly where the second
    # tile starts; that tile's 200 parents rank past e
    t = fk.SPAWN_TILE
    later = t + np.sort(rng.choice(t, 200, replace=False))
    where = np.concatenate([np.arange(0, t, 2), later])
    n = len(where)
    cfg = _cfg(n_fill=n, capacity=2 * t, spawn_budget=t // 2)
    out.append(EdgeState("kedge", cfg, _state(
        n, 2 * t, _lattice(n, rng), np.full(n, 3.0), np.full(n, 1.0),
        rng.integers(0, 2 ** 32, 2 * t), dev, vel=rng.uniform(-1, 1, (n, 3)),
        where=where), frame_t, None))

    # a slot count that is not a multiple of the tile (a multiple of the
    # sorted block, as every frame's): the first tile all free, the last
    # (512 slots) all alive, 400 of them exploding parents and the rest
    # kids
    n, slots = nbk.B, t + nbk.B
    explode = rng.permutation(n) < 400
    cfg = _cfg(n_fill=n, capacity=slots)
    out.append(EdgeState("lasttile", cfg, _state(
        n, slots, _lattice(n, rng), np.where(explode, 3.0, 0.5),
        np.where(explode, 1.0, 30.0), rng.integers(0, 2 ** 32, slots), dev,
        vel=rng.uniform(-1, 1, (n, 3)), where=np.arange(t, slots)), 5, None))
    return out


class SlabCase(NamedTuple):
    """A rank's frame inputs in a slab: its own slots (``state``), its
    halo-extended rows (``rows``, :class:`~..ops.frame_kernels.Fields` with
    the global ids: its slots, then what its neighbours send), their cells
    on the extended grid ``dims``, which rows take part, and the frame."""
    cfg: NBodyConfig
    state: ParticleState
    rows: fk.Fields
    cell: torch.Tensor
    valid: torch.Tensor
    dims: tuple
    frame: object


def slab_case(cfg: NBodyConfig, state: ParticleState, ranks: int,
              rank: int, halo: int, frame) -> SlabCase:
    """Rank ``rank`` of a slab of ``ranks`` over the global ``state``,
    which is distributed as the driver distributes a fill
    (``parallel/nbody_sharded.distribute``): its slots, then the alive rows
    of the planes next to its slab as its neighbours pack them, ``halo``
    rows a side (zeros past the count; none below the first rank or above
    the last, the non-cyclic halo), binned on the extended grid as
    ``nbody_sharded.make_step`` bins them.  A ``halo`` that leaves the row
    count off the pair kernel's block pads the pass with -1-id rows."""
    from ..ops.grid import cell_coords, wrap_positions
    from ..parallel import nbody_sharded as ns
    spec = ns.SlabSpec(ranks, halo_capacity=halo)
    glob, dropped = ns.distribute(state, cfg, spec)
    if dropped:
        raise ValueError(f"{dropped} particles do not fit their rank")
    g, c = cfg.grid, cfg.slots // ranks
    p = g.grid_dim // ranks

    def rank_rows(d):
        st = glob.map(lambda a: a[d * c:(d + 1) * c].clone())
        pos_w, coords = wrap_positions(st.pos, g)
        ids = torch.arange(d * c, (d + 1) * c, dtype=torch.int32,
                           device=st.device)
        return st, [pos_w, st.age, st.w, ids, st.tag], coords

    own, parts, coords = rank_rows(rank)
    valid = [own.alive]
    # from below: the top plane of rank - 1; from above: rank + 1's bottom
    for d, plane in ((rank - 1, rank * p - 1), (rank + 1, (rank + 1) * p)):
        st, rows, cc = rank_rows(min(max(d, 0), ranks - 1))
        send = st.alive & (cc[:, 2] == plane) & (0 <= d < ranks)
        packed = ns._pack_rows(send, halo, *rows)
        parts = [torch.cat([a, b]) for a, b in zip(parts, packed[:5])]
        valid.append(packed[5])
        coords = torch.cat([coords, cell_coords(packed[0], g)])
    dims = (g.grid_dim, g.grid_dim, p + 2)
    cell = ns.extended_cell(coords, {2: rank * p}, {2: p}, dims)
    pos, age, w, ids, tags = parts
    return SlabCase(cfg, own, fk.Fields(pos, age, w, tags, ids), cell,
                    torch.cat(valid), dims, frame)


def dims_case(device, seed: int = 6):
    """``prepare``'s inputs as the decomposed step gives them: a grid of
    (d1, d2, d3) = (3, 5, 4) cells, explicit ids, and -1-id padding rows
    (dead).  Returns (cfg, (pos, age, w, cell, alive, tags), dims, ids)."""
    rng = np.random.default_rng(seed)
    cfg = _cfg(n_fill=1500, capacity=2048, max_per_cell=48)
    dims = (3, 5, 4)
    n, pad = 2048, 300
    t = lambda a, dt: torch.from_numpy(np.asarray(a, dt)).to(device)
    alive = rng.random(n) < 0.8
    alive[-pad:] = False
    ids = rng.permutation(n).astype(np.int32)
    ids[-pad:] = -1
    args = (t(rng.uniform(-7.5, 7.5, (n, 3)), np.float32),
            t(rng.uniform(0.0, 16.0, n), np.float32),
            t(np.full(n, 60.0), np.float32),
            t(rng.integers(0, int(np.prod(dims)), n), np.int64),
            t(alive, np.bool_), t(rng.integers(0, 2 ** 32, n), np.int64))
    return cfg, args, dims, t(ids, np.int32)


# --- the checks (a card) ------------------------------------------------------------

def _same(got, want, what: str) -> None:
    got, want = got.cpu(), want.cpu()
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{what}: the kernel and its plain version "
                             f"differ")


def _same_state(a: ParticleState, b: ParticleState, what: str) -> None:
    for f in FIELDS:
        _same(getattr(a, f), getattr(b, f), f"{what}: {f}")


def stats_dict(stats: torch.Tensor) -> dict:
    return dict(zip(fk.STATS, stats[:len(fk.STATS)].tolist()))


def _same_prepare(got, want, what: str) -> None:
    """C's outputs (snap, chunks, inv, overflow_s) bit for bit."""
    for name, a, b in zip(("snap.f", "snap.i", "chunks", "inv",
                           "overflow_s"),
                          (got[0].f, got[0].i) + tuple(got[1:]),
                          (want[0].f, want[0].i) + tuple(want[1:])):
        _same(a, b, f"{what} {name}")


def _hold_c(cfg, rec, fields, skey, order, starts, c_max, num_chunks,
            dims=None, grid=None):
    """C on the records and its plain version, then C on the state's
    arrays ``fields``, all on the same inputs; returns (C's outputs, its
    statistics, the plain version's statistics)."""
    dev = skey.device
    sk, sp, sv = (fk.new_stats(dev, num_chunks) for _ in range(3))
    args = (skey, order, starts, cfg)
    tail = (c_max, nbk.CH, nbk.B)
    ck = fk.block_prepare_cuda(rec, *args, sk, *tail, dims=dims, grid=grid)
    cp = fk.block_prepare_plain(rec, *args, sp, *tail, dims=dims, grid=grid)
    _same_prepare(ck, cp, "C")
    _same(sk, sp, "C stats")
    cv = fk.block_prepare_cuda(fields, *args, sv, *tail, dims=dims,
                               grid=grid)
    _same_prepare(cv, ck, "C without records:")
    _same(sv, sk, "C without records: stats")
    return ck, sk, sp


def hold_kernels(cfg: NBodyConfig, state: ParticleState, frame,
                 c_max: int | None = None) -> dict:
    """A-E against their plain versions, each on the same inputs, at one
    frame of ``state`` (CUDA tensors): bit for bit, A and C with records
    and without; the pair kernel runs once, on C's outputs.  Returns the
    frame's statistics."""
    grid = cfg.grid
    c_max = nbk.C_MAX if c_max is None else c_max
    uvec, fert = nbody.frame_fields(cfg, frame, state.tag)
    a_args = (state.pos, state.alive, state.age, state.w, state.tag, grid)
    key, rec = fk.nbody_cells_cuda(*a_args)
    key_p, rec_p = fk.nbody_cells_plain(*a_args)
    _same(key, key_p, "A key")
    _same(rec, rec_p, "A records")
    _same(fk.nbody_cells_cuda(*a_args, records=False)[0], key_p,
          "A key without records")
    skey, order = torch.sort(key, stable=True)
    starts = fk.cell_starts_cuda(skey, grid.num_cells)
    _same(starts, fk.cell_starts_plain(skey, grid.num_cells), "B starts")
    fields = fk.Fields(state.pos, state.age, state.w, state.tag)
    ck, sk, sp = _hold_c(cfg, rec, fields, skey, order, starts, c_max,
                         grid.num_chunks, grid=grid)
    acc_s, gmax_s = nbk.kernel_call(cfg, ck[0], ck[1])
    d_args = (acc_s, gmax_s, ck[3], ck[2], uvec, cfg)
    s_c = sk.clone()
    outs = []
    for lifecycle, spawn, stats in (
            (fk.nbody_lifecycle_cuda, fk.nbody_spawn_cuda, sk),
            (fk.nbody_lifecycle_plain, fk.nbody_spawn_plain, sp)):
        out = state.map(torch.empty_like)
        flags, tiles = lifecycle(state, out, *d_args, stats)
        d_out, d_stats = out.map(lambda a: a.clone()), stats.clone()
        spawn(out, fert, frame, flags, tiles, cfg, stats)
        outs.append((d_out, flags, tiles, d_stats, out))
    (d_k, fl_k, ti_k, st_k, dk), (_, fl_p, ti_p, st_p, dp) = outs
    _same(fl_k, fl_p, "D flags")
    _same(ti_k, ti_p, "D tiles")
    _same(st_k, st_p, "D stats")
    _same_state(dk, dp, "D and E")
    _same(sk, sp, "E stats")
    _hold_spawn_again(cfg, d_k, st_k, fert, frame, fl_k, ti_k, dk, sk)
    # D and E in place, as step_into runs them
    inplace = state.map(lambda a: a.clone())
    si = fk.new_stats(state.device, grid.num_chunks)
    flags, tiles = fk.nbody_lifecycle_cuda(inplace, inplace, *d_args, si)
    fk.nbody_spawn_cuda(inplace, fert, frame, flags, tiles, cfg, si)
    _same_state(inplace, dk, "D and E in place")
    _hold_graph(cfg, state, d_args, s_c, fert, frame, dk, sk)
    return stats_dict(sk)


def _hold_spawn_again(cfg, d_out, d_stats, fert, frame, flags, tiles, want,
                      want_stats) -> None:
    """E on D's outputs again, after a call on other inputs (the flags
    reversed) that leaves its status words in the scratch the allocator
    hands the next call of the same size: ``want`` bit for bit, so no
    word of an earlier call is read."""
    other = flags.flip(0)
    junk = d_out.map(lambda a: a.clone())
    fk.nbody_spawn_cuda(junk, fert, frame, other,
                        fk.tile_counts((other & 1).bool(), other >= 2), cfg,
                        d_stats.clone())
    again = d_out.map(lambda a: a.clone())
    stats = d_stats.clone()
    fk.nbody_spawn_cuda(again, fert, frame, flags, tiles, cfg, stats)
    _same_state(again, want, "E again after other inputs")
    _same(stats, want_stats, "E again after other inputs: stats")


def _hold_graph(cfg, state, d_args, s_c, fert, frame, want,
                want_stats) -> None:
    """D and E captured once in a CUDA graph (the statistics put back to
    C's first), then replayed twice: each replay ``want`` bit for bit, so
    the memset the graph captured resets E's status words."""
    out = state.map(torch.empty_like)
    stats = torch.empty_like(s_c)

    def d_and_e():
        stats.copy_(s_c)
        flags, tiles = fk.nbody_lifecycle_cuda(state, out, *d_args, stats)
        fk.nbody_spawn_cuda(out, fert, frame, flags, tiles, cfg, stats)

    graph = torch.cuda.CUDAGraph()
    with recording(), torch.cuda.graph(graph):
        d_and_e()
    for replay in (1, 2):
        graph.replay()
        _same_state(out, want, f"D and E, graph replay {replay}")
        _same(stats, want_stats, f"D and E, graph replay {replay}: stats")


def hold_prepare(cfg: NBodyConfig, args, dims=None, ids=None,
                 c_max: int | None = None) -> dict:
    """B and C against their plain versions on ``prepare``'s inputs
    ``args`` = (pos, age, w, cell, alive, tags) (CUDA tensors), with
    ``dims`` and ``ids`` as the decomposed step passes them, C on the
    arrays (as ``prepare`` runs it) and on records.  Returns the
    statistics."""
    pos, age, w, cell, alive, tags = args
    g = cfg.grid.grid_dim
    d1, d2, d3 = dims or (g, g, g)
    num_cells = d1 * d2 * d3
    c_max = nbk.C_MAX if c_max is None else c_max
    key = torch.where(alive, cell.to(torch.int32), num_cells)
    skey, order = torch.sort(key, stable=True)
    starts = fk.cell_starts_cuda(skey, num_cells)
    _same(starts, fk.cell_starts_plain(skey, num_cells), "B starts")
    rec = fk.pack_records(pos, age, w, tags, ids)
    _, sk, _ = _hold_c(cfg, rec, fk.Fields(pos, age, w, tags, ids), skey,
                       order, starts, c_max, 0, dims=dims)
    return stats_dict(sk)


def hold_slab(case: SlabCase) -> dict:
    """D and E on a rank's halo-extended pass (:func:`slab_case`: more
    rows than slots) against their plain versions on the same inputs, bit
    for bit, D into a fresh state and both in place; the sort, B, C and the
    pair kernel run once (``parallel/nbody_sharded.extended_pass``), and
    ``nbody_sharded.blocks_lifecycle`` gives the in-place result too.
    Returns (the pass's rows, the rank's slots, the statistics)."""
    from ..parallel import nbody_sharded as ns
    cfg, st = case.cfg, case.state
    uvec, fert = nbody.frame_fields(cfg, case.frame, st.tag)
    p, acc_s, gmax_s = ns.extended_pass(case.rows, case.cell, case.valid,
                                        case.dims, cfg)
    if not acc_s.shape[1] > st.slots:
        raise ValueError("the pass has no more rows than the rank's slots")
    d_args = (acc_s, gmax_s, p.overflow_s, p.inv, uvec, cfg)
    outs = []
    for lifecycle, spawn in ((fk.nbody_lifecycle_cuda, fk.nbody_spawn_cuda),
                             (fk.nbody_lifecycle_plain, fk.nbody_spawn_plain)):
        stats = p.stats.clone()
        out = st.map(torch.empty_like)
        flags, tiles = lifecycle(st, out, *d_args, stats)
        d_out, d_stats = out.map(lambda a: a.clone()), stats.clone()
        spawn(out, fert, case.frame, flags, tiles, cfg, stats)
        outs.append((d_out, d_stats, flags, tiles, out, stats))
    (dk, sdk, fl_k, ti_k, ek, sek), (dp, sdp, fl_p, ti_p, ep, sep) = outs
    _same_state(dk, dp, "D on a slab pass")
    _same(sdk, sdp, "D on a slab pass: stats")
    _same(fl_k, fl_p, "D on a slab pass: flags")
    _same(ti_k, ti_p, "D on a slab pass: tiles")
    _same_state(ek, ep, "D and E on a slab pass")
    _same(sek, sep, "D and E on a slab pass: stats")
    inplace = st.map(lambda a: a.clone())
    stats = ns.blocks_lifecycle(inplace, case.rows, case.cell, case.valid,
                                case.dims, uvec, fert, case.frame, cfg)
    _same_state(inplace, ek, "blocks_lifecycle in place")
    _same(stats, sek, "blocks_lifecycle in place: stats")
    return dict(rows=acc_s.shape[1], slots=st.slots, **stats_dict(sek))


def plain_frame(state: ParticleState, out: ParticleState, uvec, fert,
                frame, cfg: NBodyConfig,
                c_max: int | None = None) -> torch.Tensor:
    """The blocks frame composed of the plain versions of A-E around the
    pair kernel, on any device: what ``nbody.blocks_frame`` is held to
    (which takes the module's chunk budget, the default of ``c_max``).
    Writes the next state into ``out`` and returns the statistics
    buffer."""
    grid = cfg.grid
    c_max = nbk.C_MAX if c_max is None else c_max
    key, rec = fk.nbody_cells_plain(state.pos, state.alive, state.age,
                                    state.w, state.tag, grid)
    skey, order = torch.sort(key, stable=True)
    stats = fk.new_stats(state.device, grid.num_chunks)
    starts = fk.cell_starts_plain(skey, grid.num_cells)
    snap, chunks, inv, overflow_s = fk.block_prepare_plain(
        rec, skey, order, starts, cfg, stats, c_max, nbk.CH, nbk.B,
        grid=grid)
    acc_s, gmax_s = nbk.kernel_call(cfg, snap, chunks)
    flags, tiles = fk.nbody_lifecycle_plain(state, out, acc_s, gmax_s,
                                            overflow_s, inv, uvec, cfg, stats)
    fk.nbody_spawn_plain(out, fert, frame, flags, tiles, cfg, stats)
    return stats


def hold_frames(cfg: NBodyConfig, frames: int, device,
                state: ParticleState | None = None) -> list:
    """``frames`` frames of ``nbody.step`` (the kernels on a card; the
    frame a Python int) against as many of :func:`plain_frame` (the frame
    a 0-dim int64 on the device), from ``init_fill`` or ``state``: every
    field and statistic bit for bit after every frame.  The two share the
    pair kernel, whose inputs C and its plain version make equal.  Returns
    the frames' statistics."""
    dev = torch.device(device)
    a = nbody.init_fill(cfg, dev) if state is None else state
    b = a.map(lambda t: t.clone())
    out = []
    for f in range(frames):
        a, stats = nbody.step(a, f, cfg)
        frame_t = torch.tensor(f, dtype=torch.int64, device=dev)
        uvec, fert = nbody.frame_fields(cfg, frame_t, b.tag)
        nxt = b.map(torch.empty_like)
        plain = plain_frame(b, nxt, uvec, fert, frame_t, cfg)
        b = nxt
        _same_state(a, b, f"frame {f}")
        for name in nbody.STAT_NAMES:
            want = int(plain[fk.STAT[name]])
            if int(getattr(stats, name)) != want:
                raise AssertionError(f"frame {f}: {name} "
                                     f"{int(getattr(stats, name))} != {want}")
        out.append({k: int(v) for k, v in vars(stats).items()})
    return out
