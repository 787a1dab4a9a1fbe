"""Multi-device n-body: spatial slab decomposition with halo exchange.

Counterpart of ``particlesystem_tpu/parallel/nbody_sharded.py``, one
process a rank (the reference ships co-owned boundary segments between MPI
ranks, ``set_pkg_segments``, ``app_common.cu:150-232``):

* rank ``d`` of a 1-D mesh owns grid planes ``[d*P, (d+1)*P)`` along the
  slowest axis (i3) and ``slots/D`` local slots; every alive local particle
  lies in the local slab, and its global slot is ``d*c_local + i``;
* **halo exchange** (non-cyclic: the stencil never wraps, ``fill_cells``
  clipping, ``app.cu:352-409``): each rank packs its two boundary planes'
  rows (pos, age, w, global id, tag) into fixed buffers and sends them to
  its neighbours; edge ranks receive zeros, i.e. invalid rows;
* the neighbor pass runs on the slab extended by one halo plane a side
  (``dims = (G, G, P+2)``), with the global slot ids as the pair
  self-exclusion identity (unique across ranks) and the persistent tags as
  the collision order, so kill/survive decisions are a single device's;
  with ``impl="blocks"`` it is the single-device frame's kernels on the
  extended rows (:func:`blocks_lifecycle`: the sort, B and C, the pair
  kernel, then D and E on the rank's own slots, in place);
* **migration** (cyclic: the torus wrap crosses the ring seam): particles
  that left the slab (one plane a frame at most, ``MAX_DX <= CELL_SIZE``)
  are packed, sent, and merged into the destination's free slots in
  ascending order (``ops/compact.allocate``).

One rank owns every plane at D = 1: the halo and the migration ring are
statically skipped there.  The ring would be the identity and would mark
every alive particle as both staying and leaving, duplicating it; the skip
is part of the semantics, not an optimisation.  Buffer overflow drops are
counted in the statistics, never silent.

:func:`make_step` is the per-rank frame shared by the slab, the pencil
(``nbody_pencil``) and the brick (``nbody_brick``): each decomposition is a
list of split grid axes, exchanged and migrated axis by axis in order (a
later phase forwards the earlier phases' halo rows, which delivers the
edge and corner cells).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.config import NBodyConfig
from ..core.state import FIELDS, ParticleState
from ..models.nbody import frame_fields, lifecycle_update
from ..ops import compact
from ..ops import frame_kernels as fk
from ..ops import neighbor_blocks as nbk
from ..ops.frame_kernels import Fields, sort_and_prepare
from ..ops.grid import build_bins, cell_coords, wrap_positions
from ..ops.neighbor import collision_okey, neighbor_pass

#: the lifecycle's counts, summed over the mesh
COUNTS = ("n_age_deaths", "n_collision_kills", "n_overflow_kills",
          "n_survivals", "n_spawned", "n_spawn_capped")
#: the step's statistics: the sums over the mesh, then the maxima
SUM_STATS = COUNTS + ("n_alive", "halo_dropped", "n_listed_dropped",
                      "migration_dropped")
MAX_STATS = ("halo_used_max", "migration_used_max", "max_cell_occupancy")
STATS = SUM_STATS + MAX_STATS


@dataclasses.dataclass(frozen=True)
class SlabSpec:
    """Slab decomposition parameters.

    ``impl``: per-rank neighbor pass, "blocks" (the cluster-pair kernel
    over the halo-extended slab) or "dense" (the cell-pair pass)."""

    n_devices: int
    axis: str = "x"
    halo_capacity: int = 0       # rows per halo buffer; 0 -> derived
    migration_capacity: int = 0  # rows per direction;   0 -> derived
    impl: str = "dense"

    @property
    def mesh_shape(self) -> Tuple[int, ...]:
        return (self.n_devices,)

    @property
    def mesh_axes(self) -> Tuple[str, ...]:
        return (self.axis,)

    def derive(self, cfg: NBodyConfig) -> "SlabSpec":
        g = cfg.grid
        if g.grid_dim % self.n_devices:
            raise ValueError(
                f"grid_dim {g.grid_dim} % devices {self.n_devices}")
        if cfg.slots % self.n_devices:
            raise ValueError(f"slots {cfg.slots} % devices {self.n_devices}")
        plane_cap = cfg.cell_capacity * g.grid_dim * g.grid_dim
        halo = self.halo_capacity or plane_cap
        mig = self.migration_capacity or plane_cap
        return dataclasses.replace(self, halo_capacity=halo,
                                   migration_capacity=mig)

    def splits(self) -> Tuple["Split", ...]:
        return (Split(2, self.axis, self.n_devices, self.halo_capacity),)


class Split(NamedTuple):
    """One decomposed grid axis: coordinate column (2 = i3, 0 = i1,
    1 = i2), mesh axis, ranks along it, rows a halo buffer."""

    col: int
    axis: str
    count: int
    halo: int


def _pack_rows(mask: torch.Tensor, cap: int, *fields):
    """Compact the masked rows (ascending) into fixed ``(cap, ...)``
    buffers, zeros past the count.  Returns (packed fields..., valid
    (cap,), dropped) with ``dropped`` the rows that did not fit."""
    n = mask.shape[0]
    table = compact.rank_table(mask, cap)           # n past the count
    count = mask.sum(dtype=torch.int64)
    valid = table < n
    src = table.clamp(max=n - 1)
    out = []
    for f in fields:
        g = f[src]
        keep = valid.view((cap,) + (1,) * (f.dim() - 1))
        out.append(torch.where(keep, g, torch.zeros((), dtype=f.dtype,
                                                    device=f.device)))
    return (*out, valid, (count - cap).clamp(min=0))


def _owner_np(pos: np.ndarray, cfg: NBodyConfig, splits) -> np.ndarray:
    """Owning linear rank per row (host numpy): the decomposition's
    invariant, ``ravel((i_col // P) for each split)``."""
    g = cfg.grid
    half = g.grid_dim // 2
    cs = np.float32(g.cell_size)
    coord = {0: np.floor(-pos[:, 1] / cs).astype(np.int64) + half,
             1: np.floor(pos[:, 0] / cs).astype(np.int64) + half,
             2: np.floor(-pos[:, 2] / cs).astype(np.int64) + half}
    lin = np.zeros(pos.shape[0], dtype=np.int64)
    for s in splits:
        p = g.grid_dim // s.count
        lin = lin * s.count + np.clip(coord[s.col] // p, 0, s.count - 1)
    return lin


def _distribute(state: ParticleState, cfg: NBodyConfig, splits
                ) -> Tuple[ParticleState, int]:
    n_dev = int(np.prod([s.count for s in splits]))
    c_local = cfg.slots // n_dev
    alive = state.alive.cpu().numpy()
    dest = _owner_np(state.pos.cpu().numpy(), cfg, splits)
    out = {f: torch.zeros_like(getattr(state, f)) for f in FIELDS}
    dropped = 0
    dev = state.device
    for d in range(n_dev):
        idx = np.flatnonzero(alive & (dest == d))
        if len(idx) > c_local:
            dropped += len(idx) - c_local
            idx = idx[:c_local]
        rows = torch.as_tensor(d * c_local + np.arange(len(idx)), device=dev)
        src = torch.as_tensor(idx, device=dev)
        for f in FIELDS:
            out[f][rows] = getattr(state, f)[src]
    return ParticleState(**out), dropped


def dest_np(pos, cfg: NBodyConfig, spec: SlabSpec) -> np.ndarray:
    """Owning rank per row (host-side numpy): the slab invariant."""
    return _owner_np(np.asarray(pos), cfg, spec.derive(cfg).splits())


def distribute(state: ParticleState, cfg: NBodyConfig, spec: SlabSpec
               ) -> Tuple[ParticleState, int]:
    """Reorder a global state so that rank d's slots hold exactly the
    particles of slab d (the invariant the step requires), on the host
    side, for a fresh fill or a loaded checkpoint.  Returns (reordered
    state, n_dropped): particles past a rank's local capacity are dropped."""
    return _distribute(state, cfg, spec.derive(cfg).splits())


def _migrate_axis(st: ParticleState, mesh, s: Split, cfg: NBodyConfig,
                  m: int):
    """Route alive local particles whose owner along ``s`` changed one hop
    along its ring and merge the arrivals into ascending free slots.
    Returns (state, dropped, used)."""
    g = cfg.grid
    p = g.grid_dim // s.count
    me, d = mesh.axis_index(s.axis), s.count
    _, coords_n = wrap_positions(st.pos, g)
    dest = coords_n[:, s.col] // p
    stay = ~st.alive | (dest == me)
    go_f = st.alive & (dest == (me + 1) % d)
    go_b = st.alive & (dest == (me - 1) % d) & ~go_f

    def pack(mask):
        return _pack_rows(mask, m, st.pos, st.vel, st.w, st.age, st.life,
                          st.parent, st.tag)

    ef, eb = pack(go_f), pack(go_b)
    dropped = ef[-1] + eb[-1]
    used = torch.maximum(go_f.sum(dtype=torch.int64),
                         go_b.sum(dtype=torch.int64))
    ring_f = [(i, (i + 1) % d) for i in range(d)]
    ring_b = [(i, (i - 1) % d) for i in range(d)]
    im_b, im_f = mesh.exchange(s.axis, [(list(ef[:-1]), ring_f),
                                        (list(eb[:-1]), ring_b)])

    leaving = st.alive & ~stay
    z3 = lambda a: torch.where(leaving[:, None], 0.0, a)
    z1 = lambda a: torch.where(leaving, 0.0, a)
    alive2 = st.alive & stay
    imm = [torch.cat([x, y]) for x, y in zip(im_b, im_f)]
    target, ok = compact.allocate(alive2, imm[7])
    tgt = torch.where(ok, target, st.slots)
    put = lambda base, rows: compact.write_rows(base, tgt, rows)
    st3 = ParticleState(
        pos=put(z3(st.pos), imm[0]), vel=put(z3(st.vel), imm[1]),
        acc=put(z3(st.acc), 0.0), w=put(z1(st.w), imm[2]),
        age=put(z1(st.age), imm[3]), life=put(z1(st.life), imm[4]),
        alive=put(alive2, ok), parent=put(st.parent & ~leaving, imm[5]),
        tag=put(st.tag, imm[6]))
    return st3, dropped, used


def extended_cell(coords, base: dict, p: dict, ext) -> torch.Tensor:
    """Cell ids on a rank's extended grid (``ext`` cells along i1, i2, i3)
    of rows at the global cell ``coords`` (N, 3): a split axis (a column
    of ``base``, the rank's first cell, and ``p``, its cells) shifted by
    the rank's first cell less one and clamped into its halo layers, the
    other axes as they are."""
    lp = {}
    for col in (0, 1, 2):
        c = coords[:, col]
        lp[col] = (torch.clamp(c - (base[col] - 1), 0, p[col] + 1)
                   if col in p else c)
    return lp[2] * (ext[0] * ext[1]) + lp[0] * ext[1] + lp[1]


def pad_rows(rows: Fields, cell, valid):
    """The pass's rows padded to a multiple of the pair kernel's block with
    invalid rows of id -1: (rows, cell, valid)."""
    pad = (-rows.pos.shape[0]) % nbk.B
    if not pad:
        return rows, cell, valid

    def padf(a, v):
        return torch.cat([a, torch.full((pad,) + a.shape[1:], v,
                                        dtype=a.dtype, device=a.device)])
    return (Fields(padf(rows.pos, 0.0), padf(rows.age, 0.0),
                   padf(rows.w, 0.0), padf(rows.tags, 0), padf(rows.ids, -1)),
            padf(cell, 0), padf(valid, False))


def extended_pass(rows: Fields, cell, valid, dims, cfg: NBodyConfig):
    """The blocks pass over a rank's halo-extended rows ``rows``
    (:class:`~..ops.frame_kernels.Fields` with the global ids), binned at
    ``cell`` on the extended grid ``dims``, ``valid`` where a row takes
    part: :func:`pad_rows`, then the single-device frame's kernels
    (``models/nbody.blocks_frame``) less A, whose cells are the cubic
    grid's: the stable sort, B and C (``frame_kernels.sort_and_prepare``,
    with no chunk counters) and the pair kernel.  Returns (the
    ``Prepared`` inputs, acc_s, gmax_s), in sorted order."""
    rows, cell, valid = pad_rows(rows, cell, valid)
    num_cells = dims[0] * dims[1] * dims[2]
    key = torch.where(valid, cell.to(torch.int32), num_cells)
    p = sort_and_prepare(key, rows, cfg, nbk.C_MAX, nbk.CH, nbk.B, dims=dims)
    acc_s, gmax_s = nbk.kernel_call(cfg, p.snap, p.chunks)
    return p, acc_s, gmax_s


def blocks_lifecycle(state: ParticleState, rows: Fields, cell, valid, dims,
                     uvec, fert, frame, cfg: NBodyConfig) -> torch.Tensor:
    """A rank's blocks frame on its halo-extended rows, whose first
    ``state.slots`` are the rank's own slots in slot order (the halo rows
    follow): :func:`extended_pass`, then D on the rank's slots (the
    pass's outputs read through the first ``state.slots`` entries of
    ``inv``) and E under the rank's budget ``min(max_spawns_per_frame,
    state.slots)``, both writing ``state`` in place.  Returns the
    statistics buffer (``frame_kernels.STATS``): D's and E's counts, C's
    largest cell and dropped chunks; ``max_chunk_occupancy`` stays 0."""
    p, acc_s, gmax_s = extended_pass(rows, cell, valid, dims, cfg)
    flags, tiles = fk.nbody_lifecycle(state, state, acc_s, gmax_s,
                                      p.overflow_s, p.inv, uvec, cfg, p.stats)
    fk.nbody_spawn(state, fert, frame, flags, tiles, cfg, p.stats)
    return p.stats


def make_step(cfg: NBodyConfig, spec, mesh):
    """The per-rank frame of a decomposition ``spec`` (derived) over
    ``mesh`` (:class:`..mesh.RankMesh` of ``spec.mesh_shape``): returns
    ``step(state, frame) -> (state, stats)`` on this rank's local slots.
    ``stats`` ({name: 0-dim int64 tensor on the state's device}, the names
    of :data:`STATS`) are summed or maximised over the whole mesh.
    ``frame`` is a Python int or a 0-dim int64 tensor on the state's
    device.  The blocks frame writes ``state`` in place
    (:func:`blocks_lifecycle`) and returns it, unless particles migrate
    (a split axis of several ranks), which builds the next state anew; the
    dense frame always does."""
    splits = spec.splits()
    if mesh.shape != tuple(s.count for s in splits):
        raise ValueError(f"mesh of shape {mesh.shape} for a decomposition "
                         f"of {tuple(s.count for s in splits)}")
    if spec.impl not in ("blocks", "dense"):
        raise ValueError(f"unknown neighbor pass {spec.impl!r}")
    g = cfg.grid
    gd = g.grid_dim
    c_local = cfg.slots // mesh.size
    first = local_rows(cfg, mesh).start  # this rank's first global slot
    m = spec.migration_capacity
    base = {s.col: mesh.axis_index(s.axis) * (gd // s.count) for s in splits}
    p = {s.col: gd // s.count for s in splits}
    # extended-grid layout: a split axis spans its P cells and a halo
    # layer a side (P+2, also where it has one rank); the others span G
    ext = {col: p[col] + 2 if col in p else gd for col in (0, 1, 2)}
    dims = (ext[0], ext[1], ext[2])
    num_ext = ext[0] * ext[1] * ext[2]
    migrates = any(s.count > 1 for s in splits)

    def step(state: ParticleState, frame: int):
        dev = state.device
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        uvec, fert = frame_fields(cfg, frame, state.tag)
        pos_w, coords = wrap_positions(state.pos, g)
        gids = first + torch.arange(c_local, dtype=torch.int32, device=dev)

        # ---- halo: axis by axis, later phases forward earlier halos ----
        ext_rows = [pos_w, state.age, state.w, gids, state.tag, state.alive]
        ext_coords = coords
        halo_drop, halo_used = zero, zero
        for s in splits:
            if s.count == 1:
                continue
            ce = ext_coords[:, s.col]
            valid = ext_rows[5]
            lo_mask = valid & (ce == base[s.col])
            hi_mask = valid & (ce == base[s.col] + p[s.col] - 1)
            lo_pack = _pack_rows(lo_mask, s.halo, *ext_rows[:5])
            hi_pack = _pack_rows(hi_mask, s.halo, *ext_rows[:5])
            fwd = [(i, i + 1) for i in range(s.count - 1)]
            bwd = [(i, i - 1) for i in range(1, s.count)]
            from_lo, from_hi = mesh.exchange(
                s.axis, [(list(hi_pack[:-1]), fwd),
                         (list(lo_pack[:-1]), bwd)])
            halo_drop = halo_drop + lo_pack[-1] + hi_pack[-1]
            halo_used = torch.maximum(halo_used, torch.maximum(
                lo_mask.sum(dtype=torch.int64),
                hi_mask.sum(dtype=torch.int64)))
            ext_rows = [torch.cat([e, lo, hi])
                        for e, lo, hi in zip(ext_rows, from_lo, from_hi)]
            ext_coords = torch.cat([ext_coords, cell_coords(from_lo[0], g),
                                    cell_coords(from_hi[0], g)])
        pos0, age0, w0, ids0, tags0, valid0 = ext_rows

        # ---- extended-grid binning -------------------------------------
        ext_cell = extended_cell(ext_coords, base, p, dims)

        if spec.impl == "blocks":
            st = blocks_lifecycle(state, Fields(pos0, age0, w0, tags0, ids0),
                                  ext_cell, valid0, dims, uvec, fert, frame,
                                  cfg)
            out = state
            counts = {k: st[fk.STAT[k]] for k in COUNTS + ("n_alive",)}
            max_cell = st[fk.STAT["max_cell_occupancy"]]
            listed_dropped = st[fk.STAT["n_listed_dropped"]]
        else:
            bins = build_bins(ext_cell, valid0, num_ext, cfg.cell_capacity)
            acc, kill, touch = neighbor_pass(pos0, age0, w0, ids0,
                                             bins.cell_list, dims, cfg,
                                             okeys=collision_okey(tags0))
            max_cell = bins.max_cell_occupancy
            listed_dropped = bins.n_listed_dropped
            out, counts = lifecycle_update(
                state, pos_w, bins.overflow[:c_local], acc[:c_local],
                kill[:c_local], touch[:c_local], uvec, fert, frame, cfg)

        # ---- migration: axis by axis, cyclic (the torus wrap) ----------
        mig_drop, mig_used = zero, zero
        for s in splits:
            if s.count == 1:
                continue
            out, dropped, used = _migrate_axis(out, mesh, s, cfg, m)
            mig_drop = mig_drop + dropped
            mig_used = torch.maximum(mig_used, used)

        # ---- statistics over the whole mesh: one sum, one max ----------
        # (n_alive counts the migrated state where particles migrate)
        n_alive = (out.alive.sum(dtype=torch.int64) if migrates
                   else counts["n_alive"])
        sums = mesh.psum(torch.stack(
            [counts[k] for k in COUNTS]
            + [n_alive, halo_drop, listed_dropped.to(torch.int64),
               mig_drop]))
        maxes = mesh.pmax(torch.stack(
            [halo_used, mig_used, max_cell.to(torch.int64)]))
        stats = dict(zip(SUM_STATS, sums.unbind()))
        stats.update(zip(MAX_STATS, maxes.unbind()))
        return out, stats

    return step


def local_rows(cfg: NBodyConfig, mesh) -> slice:
    """This rank's global slot range: ``[d*c_local, (d+1)*c_local)``, d
    the rank's row-major position on the mesh."""
    c_local = cfg.slots // mesh.size
    d = mesh.position(mesh.rank)
    return slice(d * c_local, (d + 1) * c_local)


def _shard_fn(cfg: NBodyConfig, mesh):
    rows = local_rows(cfg, mesh)

    def shard_state(state: ParticleState, device=None) -> ParticleState:
        """This rank's slots of a global state, on ``device``, as tensors
        of their own: the blocks step writes them in place."""
        return state.map(lambda a: a[rows].to(device or a.device, copy=True))
    return shard_state


def make_sharded_step(cfg: NBodyConfig, spec: SlabSpec, mesh):
    """(step_fn, shard_state_fn) of the slab over a 1-D ``mesh``.
    ``step_fn(state, frame) -> (state, stats)`` runs on this rank's local
    slots; ``shard_state_fn(global_state)`` cuts this rank's slots out of
    a global state that satisfies the slab invariant (see
    :func:`distribute`)."""
    return make_step(cfg, spec.derive(cfg), mesh), _shard_fn(cfg, mesh)
