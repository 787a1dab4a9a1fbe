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
from ..ops.grid import build_bins, cell_coords, wrap_positions
from ..ops.neighbor import collision_okey, neighbor_pass
from ..ops.neighbor_blocks import B as NB_B
from ..ops.neighbor_blocks import neighbor_pass_blocks


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


def make_step(cfg: NBodyConfig, spec, mesh):
    """The per-rank frame of a decomposition ``spec`` (derived) over
    ``mesh`` (:class:`..mesh.RankMesh` of ``spec.mesh_shape``): returns
    ``step(state, frame) -> (state, stats)`` on this rank's local slots.
    ``stats`` are 0-dim int64 tensors on the state's device, summed or
    maximised over the whole mesh."""
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
        lp = {}
        for col in (0, 1, 2):
            c = ext_coords[:, col]
            lp[col] = (torch.clamp(c - (base[col] - 1), 0, p[col] + 1)
                       if col in p else c)
        ext_cell = lp[2] * (ext[0] * ext[1]) + lp[0] * ext[1] + lp[1]

        if spec.impl == "blocks":
            pad = (-pos0.shape[0]) % NB_B
            if pad:
                padf = lambda a, v: torch.cat(
                    [a, torch.full((pad,) + a.shape[1:], v, dtype=a.dtype,
                                   device=dev)])
                pos0, age0, w0 = padf(pos0, 0.0), padf(age0, 0.0), \
                    padf(w0, 0.0)
                ids0, tags0 = padf(ids0, -1), padf(tags0, 0)
                ext_cell, valid0 = padf(ext_cell, 0), padf(valid0, False)
            acc, kill, touch, ovf, max_cell, _, listed_dropped = \
                neighbor_pass_blocks(pos0, age0, w0, ext_cell, valid0, cfg,
                                     tags0, dims=dims, ids=ids0)
            overflow_local = ovf[:c_local]
        else:
            bins = build_bins(ext_cell, valid0, num_ext, cfg.cell_capacity)
            acc, kill, touch = neighbor_pass(pos0, age0, w0, ids0,
                                             bins.cell_list, dims, cfg,
                                             okeys=collision_okey(tags0))
            overflow_local = bins.overflow[:c_local]
            max_cell = bins.max_cell_occupancy
            listed_dropped = bins.n_listed_dropped

        out, counts = lifecycle_update(
            state, pos_w, overflow_local, acc[:c_local], kill[:c_local],
            touch[:c_local], uvec, fert, frame, cfg)

        # ---- migration: axis by axis, cyclic (the torus wrap) ----------
        mig_drop, mig_used = zero, zero
        for s in splits:
            if s.count == 1:
                continue
            out, dropped, used = _migrate_axis(out, mesh, s, cfg, m)
            mig_drop = mig_drop + dropped
            mig_used = torch.maximum(mig_used, used)

        # ---- statistics over the whole mesh: one sum, one max ----------
        sum_keys = [k for k in counts if k != "n_alive"]
        sums = mesh.psum(torch.stack(
            [counts[k] for k in sum_keys]
            + [out.alive.sum(dtype=torch.int64), halo_drop,
               listed_dropped.to(torch.int64), mig_drop]))
        maxes = mesh.pmax(torch.stack(
            [halo_used, mig_used, max_cell.to(torch.int64)]))
        stats = dict(zip(sum_keys + ["n_alive", "halo_dropped",
                                     "n_listed_dropped", "migration_dropped"],
                         sums.unbind()))
        stats.update(zip(["halo_used_max", "migration_used_max",
                          "max_cell_occupancy"], maxes.unbind()))
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
        """This rank's slots of a global state, on ``device``."""
        return state.map(lambda a: a[rows].to(device or a.device))
    return shard_state


def make_sharded_step(cfg: NBodyConfig, spec: SlabSpec, mesh):
    """(step_fn, shard_state_fn) of the slab over a 1-D ``mesh``.
    ``step_fn(state, frame) -> (state, stats)`` runs on this rank's local
    slots; ``shard_state_fn(global_state)`` cuts this rank's slots out of
    a global state that satisfies the slab invariant (see
    :func:`distribute`)."""
    return make_step(cfg, spec.derive(cfg), mesh), _shard_fn(cfg, mesh)
