"""The n-body frame's per-row work around the pair kernel in five kernels:
wrapper of ``csrc/nbody_frame.cu``.

Counterpart of XLA's fusions of the JAX package's jitted frame
(``particlesystem_tpu/models/nbody.py::step_fields``, :271-331, with
``impl="blocks"``; there is no Pallas kernel): everything the frame
computes outside the pair kernel, the threefry draw and the sort.

* A :func:`nbody_cells` — torus wrap, cell id and sort key ``alive ? cell
  : num_cells`` (int32) of every slot (``ops/grid.wrap_positions``,
  ``coords_to_cell``) and, where they pay (:func:`records_pay`), every
  slot's record (:func:`pack_records`).
* B :func:`cell_starts` — ``starts = searchsorted(skey,
  arange(num_cells + 2))`` of the sorted keys (``prepare``'s
  ``starts``/``counts``).
* C :func:`block_prepare` — the rest of ``ops/neighbor_blocks.prepare``,
  from one record a sorted row or the state's arrays (:class:`Fields`):
  the snapshot, the overflow rows, the chunk table, the inverse
  permutation ``inv[order[r]] = r``, the largest cell and, on the cubic
  grid, each chunk's count.
* D :func:`nbody_lifecycle` — ``unsort_outputs`` read through ``inv``, the
  mine-side collision window and the first part of ``lifecycle_update``
  (flags, clamped Euler, wrap, aging, explosion), writing the next state;
  explode/free flags and their counts a tile of :data:`TILE` slots; the
  largest chunk, from C's counts where the pass has them.  The pass may
  have more rows than D has slots: a rank's halo-extended rows
  (``parallel/nbody_sharded.blocks_lifecycle``), its own slots first.
* E :func:`nbody_spawn` — the spawn part of ``lifecycle_update``: the
  i-th exploding parent (ascending slot) meets the i-th free slot for
  ``i < k = min(n_child, n_free, e)``: on the card a memset of its
  status words and two kernels, one pass over tiles of
  :data:`SPAWN_TILE` slots that ranks both kinds against the budget
  ``e`` by a decoupled look-back, then the children (scratch:
  :func:`spawn_scratch_words`).

Each is a dispatcher (``utils/cuda_build.by_device``): CUDA tensors launch
the kernel (``*_cuda``), CPU tensors take the plain version (``*_plain``);
any other device raises.
:func:`sort_and_prepare` runs the sort, B and C in the frame's order for
every caller (``models/nbody.blocks_frame`` and
``api.NBodySimulation.profile_frame`` through :func:`cells_and_rows`,
``neighbor_blocks.prepare`` on the state's arrays, the decomposed frame's
``parallel/nbody_sharded.extended_pass`` on a rank's extended rows).

The statistics of a frame go into one int64 buffer (:func:`new_stats`,
zeros): :data:`STATS` names its entries, those of
``models/nbody.NBodyStats`` in order; the chunk counters that C adds to
and D reduces follow.
D may write the state it reads (``out is state``), and E writes the state
in place; see ``csrc/nbody_frame.cu`` for why that is safe.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core import rng
from ..core.config import GridSpec, NBodyConfig
from ..core.state import FIELDS, ParticleState
from ..utils.cuda_build import by_device, launch
from .compact import rank_table, write_rows
from .grid import coords_to_cell, wrap_positions
from .neighbor import IMIN, as_f32, collision_okey
from .rng_kernel import frame_on

#: the statistics buffer's entries, in ``csrc/nbody_frame.cu``'s order
STATS = ("n_alive", "n_age_deaths", "n_collision_kills", "n_overflow_kills",
         "n_survivals", "n_spawned", "n_spawn_capped", "n_listed_dropped",
         "max_cell_occupancy", "max_chunk_occupancy", "n_tail_alive")
STAT = {name: i for i, name in enumerate(STATS)}
#: slots a tile of D's explode and free counts (D's block)
TILE = 256
#: slots a ranking tile of E (a block of 256 threads, 16 flags each)
SPAWN_TILE = 4096
#: the most slots E ranks: its status words count each kind in 31 bits
SPAWN_MAX_SLOTS = 2 ** 31 - 1
#: chunk starts align to this many sorted rows
ALIGN = 128
#: int32 words of a row's record: x, y, z, w, age (float bits), the
#: collision key of the tag, the id, 0
RECORD = 8
#: C's sorted rows a thread: its block size must be a multiple of it
C_ROWS = 4
#: bytes C gathers a row from the state's arrays: pos, age, w, tag
GATHERED = 28
_BIG = 1 << 30


class Snapshot(NamedTuple):
    """Cell-sorted neighbor snapshot: ``f`` float32 (7, N) rows x, y, z,
    i1, i2, i3, w; ``i`` int32 (2, N) rows gid, cgid."""

    f: torch.Tensor
    i: torch.Tensor


def new_stats(device, num_chunks: int = 0) -> torch.Tensor:
    """A zeroed statistics buffer, with ``num_chunks`` chunk counters for
    the largest chunk (:func:`block_prepare` adds, :func:`nbody_lifecycle`
    reduces)."""
    return torch.zeros((len(STATS) + num_chunks,), dtype=torch.int64,
                       device=device)


def stencil_offsets(row_stride: int, plane_stride: int) -> list:
    """The 9 cell-id offsets of a row's (i1, i3) stencil neighbours,
    ascending."""
    return sorted(o3 * plane_stride + o1 * row_stride
                  for o3 in (-1, 0, 1) for o1 in (-1, 0, 1))


def _add(stats, name: str, value) -> None:
    stats[STAT[name]] += value


def _set(stats, name: str, value) -> None:
    stats[STAT[name]] = value


def _chunk_counters(stats, num_chunks: int) -> torch.Tensor:
    return stats[len(STATS):len(STATS) + num_chunks]


def stats_chunks(stats, grid: GridSpec) -> int:
    """The chunk counters a statistics buffer carries: the cubic
    ``grid``'s, or none (a pass over another grid).  Raises for any other
    length."""
    n = stats.shape[0] - len(STATS)
    if n not in (0, grid.num_chunks):
        raise ValueError(f"stats must be new_stats(device) or new_stats("
                         f"device, {grid.num_chunks}), got {n} chunk "
                         f"counters")
    return n


# --- checks ---------------------------------------------------------------------

def _check(dev, t: torch.Tensor, dtype, shape, what: str,
           align: int = 1) -> None:
    if (t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.data_ptr() % align):
        raise ValueError(f"{what} must be a contiguous {dtype} "
                         f"{tuple(shape)} on {dev}"
                         + (f", {align}-byte aligned" if align > 1 else "")
                         + f", got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_stats(dev, stats, num_chunks: int = 0) -> None:
    if (stats.device != dev or stats.dtype != torch.int64 or stats.dim() != 1
            or stats.shape[0] < len(STATS) + num_chunks
            or not stats.is_contiguous()):
        raise ValueError(f"stats must be new_stats(device, {num_chunks}), "
                         f"got {stats.dtype} {tuple(stats.shape)}")


def _check_state(dev, st: ParticleState, n: int, what: str) -> None:
    for f in FIELDS:
        t = getattr(st, f)
        shape = (n, 3) if f in ("pos", "vel", "acc") else (n,)
        dtype = (torch.bool if f in ("alive", "parent") else
                 torch.int64 if f == "tag" else torch.float32)
        _check(dev, t, dtype, shape, f"{what}.{f}")


_KERNEL = "n-body frame kernel"


# --- A: cells ---------------------------------------------------------------------

def pack_records(pos, age, w, tags, ids=None) -> torch.Tensor:
    """Each row's record (N, :data:`RECORD`) int32: the bits of x, y, z, w
    and age, ``collision_okey`` of the tag, the id (``ids``, int32, or the
    row) and 0; plain tensor code on any device."""
    n = pos.shape[0]
    ids = (torch.arange(n, dtype=torch.int32, device=pos.device)
           if ids is None else ids.to(torch.int32))
    bits = lambda t: t.view(torch.int32)
    return torch.cat([bits(pos), bits(w)[:, None], bits(age)[:, None],
                      collision_okey(tags)[:, None], ids[:, None],
                      torch.zeros_like(ids)[:, None]], dim=1)


@functools.lru_cache(maxsize=None)
def _l2_bytes(index: int) -> int:
    return torch.cuda.get_device_properties(index).L2_cache_size


def records_pay(n: int, device) -> bool:
    """Whether a frame of ``n`` rows has A write records for C: where the
    arrays C would gather from (:data:`GATHERED` bytes a row) outgrow the
    card's L2 cache, so that each gather moves a sector of device memory;
    below that the gathers hit the L2 and the record costs A more than it
    saves C (``PERF.md`` §6).  Never on the CPU, where both routes are the
    same plain code."""
    device = torch.device(device)
    return device.type == "cuda" and n * GATHERED > _l2_bytes(
        device.index if device.index is not None
        else torch.cuda.current_device())


def nbody_cells_plain(pos: torch.Tensor, alive: torch.Tensor, age, w, tags,
                      grid: GridSpec, records: bool = True):
    """Plain version of A: (the sort key (N,) int32, the records
    :func:`pack_records`, or None without ``records``) of every slot."""
    cell = coords_to_cell(wrap_positions(pos, grid)[1], grid)
    key = torch.where(alive, cell, grid.num_cells).to(torch.int32)
    return key, pack_records(pos, age, w, tags) if records else None


def nbody_cells_cuda(pos: torch.Tensor, alive: torch.Tensor, age, w, tags,
                     grid: GridSpec, records: bool = True):
    """Launch ``ps_nbody_cells``; same contract as the plain version."""
    dev = pos.device
    n = pos.shape[0]
    _check(dev, pos, torch.float32, (n, 3), "pos")
    _check(dev, alive, torch.bool, (n,), "alive")
    key = torch.empty((n,), dtype=torch.int32, device=dev)
    rec = None
    if records:
        _check(dev, age, torch.float32, (n,), "age")
        _check(dev, w, torch.float32, (n,), "w")
        _check(dev, tags, torch.int64, (n,), "tags")
        rec = torch.empty((n, RECORD), dtype=torch.int32, device=dev)
    ptr = lambda t: None if rec is None else t.data_ptr()
    launch("ps_nbody_cells", dev, pos.data_ptr(), alive.data_ptr(),
           ptr(age), ptr(w), ptr(tags), n, grid.grid_dim,
           as_f32(1.0 / grid.cell_size), as_f32(grid.cell_size),
           key.data_ptr(), ptr(rec))
    return key, rec


def nbody_cells(pos, alive, age, w, tags, grid: GridSpec,
                records: bool = True):
    return by_device(pos, _KERNEL, nbody_cells_cuda, nbody_cells_plain)(
        pos, alive, age, w, tags, grid, records)


# --- B: cell starts ---------------------------------------------------------------

def cell_starts_plain(skey: torch.Tensor, num_cells: int) -> torch.Tensor:
    """Plain version of B: ``starts`` (num_cells + 2,) int32 of the sorted
    keys."""
    return torch.searchsorted(
        skey, torch.arange(num_cells + 2, dtype=torch.int32,
                           device=skey.device), out_int32=True)


def cell_starts_cuda(skey: torch.Tensor, num_cells: int) -> torch.Tensor:
    """Launch ``ps_cell_starts``, one thread a sorted row; same contract as
    the plain version."""
    dev = skey.device
    n = skey.shape[0]
    _check(dev, skey, torch.int32, (n,), "skey")
    starts = torch.empty((num_cells + 2,), dtype=torch.int32, device=dev)
    launch("ps_cell_starts", dev, skey.data_ptr(), n, num_cells,
           starts.data_ptr())
    return starts


def cell_starts(skey, num_cells: int):
    return by_device(skey, _KERNEL, cell_starts_cuda, cell_starts_plain)(
        skey, num_cells)


# --- C: block prepare -------------------------------------------------------------

def _layout(cfg: NBodyConfig, n: int, b: int, dims):
    if n % b:
        raise ValueError(f"{n} rows is not a multiple of the block size {b}")
    g = cfg.grid.grid_dim
    d1, d2, d3 = dims or (g, g, g)
    return d1 * d2 * d3, d2, d1 * d2


class Fields(NamedTuple):
    """A state's rows as C reads them without records: pos (N, 3) float32,
    age, w (N,) float32, tags (N,) int64, ids (N,) int32 or None (the
    row)."""

    pos: torch.Tensor
    age: torch.Tensor
    w: torch.Tensor
    tags: torch.Tensor
    ids: torch.Tensor | None = None


def block_prepare_plain(rows, skey, order, starts, cfg: NBodyConfig, stats,
                        c_max: int, ch: int, b: int, dims=None,
                        grid: GridSpec | None = None):
    """Plain version of C: (snap :class:`Snapshot`, chunks (NB, c_max, 4)
    int32 — columns (aligned_start, lo, hi, n_active) —, inv (N,) int32,
    overflow_s (N,) bool) of the rows sorted by ``skey`` through
    ``order``, their fields from ``rows``: the records
    (:func:`pack_records`) or :class:`Fields`; ``stats``' dropped chunks
    and largest cell, and, given the cubic ``grid``, each chunk's count
    added to its counter.  ``dims`` as in
    ``ops/neighbor_blocks.prepare``."""
    rec = pack_records(*rows) if isinstance(rows, Fields) else rows
    n = skey.shape[0]
    num_cells, row_stride, plane_stride = _layout(cfg, n, b, dims)
    dev = skey.device
    f32 = torch.float32
    skey = skey.to(torch.int64)
    starts = starts.to(torch.int64)

    iot = torch.arange(n, dtype=torch.int64, device=dev)
    srec = rec[order]
    col = lambda k: srec[:, k].view(f32)
    sage = col(4)
    # in-cell rank: distance to the first sorted row of the row's key
    # (``starts`` holds it for every key, and no key exceeds num_cells)
    rank = iot - starts[skey]

    in_grid = skey < num_cells
    valid_s = in_grid & (rank < cfg.cell_capacity)
    overflow_s = in_grid & (rank >= cfg.cell_capacity)

    # out-of-band bands for invalid and kid rows (see neighbor_blocks)
    coord_ok = valid_s & (sage >= as_f32(cfg.kid_age))
    base = torch.where(valid_s, -10.0, -4194304.0).to(f32)
    bad_a = base - (2 * (iot % (1 << 19))).to(f32)
    bad_b = base - (2 * (iot % ((1 << 19) - 1))).to(f32)
    i3q = skey // plane_stride
    remq = skey % plane_stride
    i1s = torch.where(coord_ok, (remq // row_stride).to(f32), bad_a)
    i2s = torch.where(coord_ok, (remq % row_stride).to(f32), bad_b)
    i3s = torch.where(coord_ok, i3q.to(f32), bad_a)
    # neighbor-side collision window's upper edge (age <= life); the
    # kid/dead/overflow gates ride the out-of-band coordinates
    cgid = torch.where(sage <= as_f32(cfg.particle_life), srec[:, 5], IMIN)
    snap = Snapshot(f=torch.stack([col(0), col(1), col(2), i1s, i2s, i3s,
                                   col(3)]),
                    i=torch.stack([srec[:, 6], cgid.to(torch.int32)]))

    # the counts: the largest cell, each chunk's rows
    counts = starts[1:num_cells + 1] - starts[:num_cells]
    k = STAT["max_cell_occupancy"]
    stats[k] = torch.maximum(stats[k], counts.max())
    if grid is not None:
        cd, cf = grid.chunk_dim, grid.chunk_factor
        _chunk_counters(stats, grid.num_chunks).add_(
            counts.reshape(cf, cd, cf, cd, cf, cd).sum(dim=(1, 3, 5))
            .reshape(-1))

    # ---- per-block neighbor ranges --------------------------------------
    # A block's valid sorted cells are the contiguous [cmin, cmax].  For
    # each of the 9 stencil offsets (d1, d3) the needed cells are the
    # linear range [cmin-1, cmax+1] + d3*G^2 + d1*G; row-edge spill is
    # rejected by the per-pair stencil test.  Offsets ascend, so clipping
    # each range's start past the previous range's end keeps the ranges
    # disjoint (wide blocks on sparse grids would overlap them and count
    # neighbors twice) while keeping their union.
    nb = n // b
    cmin = torch.where(valid_s, skey, _BIG).view(nb, b).amin(dim=1)
    cmax = torch.where(valid_s, skey, -_BIG).view(nb, b).amax(dim=1)
    empty = cmax < cmin

    offs = stencil_offsets(row_stride, plane_stride)
    prev_hi = torch.full_like(cmin, -_BIG)
    lo_cols, hi_cols = [], []
    for off in offs:                                     # sequential dedup
        lo_cols.append(torch.maximum(cmin - 1 + off, prev_hi + 1))
        hi_cols.append(cmax + 1 + off)
        prev_hi = torch.maximum(prev_hi, hi_cols[-1])
    lo = torch.stack(lo_cols, dim=1)                     # (NB, 9)
    hi = torch.stack(hi_cols, dim=1)

    r_start = starts[lo.clamp(0, num_cells)]
    r_end = starts[(hi + 1).clamp(0, num_cells)]
    count = torch.where((~empty)[:, None] & (r_end > r_start),
                        r_end - r_start, 0)

    # ---- flatten ranges into a per-block chunk table -------------------
    astart = (r_start // ALIGN) * ALIGN
    lead = r_start - astart
    tot = lead + count                                   # (NB, 9)
    nch = torch.where(count > 0, (tot + ch - 1) // ch, 0)
    cum = torch.cumsum(nch, dim=1)                       # inclusive
    total = cum[:, -1]
    _add(stats, "n_listed_dropped", (total - c_max).clamp(min=0).sum())

    last = len(offs) - 1
    j = torch.arange(c_max, device=dev).expand(nb, c_max).contiguous()
    r_of = torch.searchsorted(cum, j, right=True)        # range of chunk j
    take = lambda a: torch.gather(a, 1, r_of.clamp(max=last))
    first_chunk = torch.where(
        r_of > 0, torch.gather(cum, 1, (r_of - 1).clamp(0, last)), 0)
    c_in = j - first_chunk                               # chunk within range
    nact = total.clamp(max=c_max)
    valid_j = j < nact[:, None]
    astart_j = torch.where(valid_j, take(astart) + c_in * ch, 0)
    lo_j = torch.where(valid_j, (take(lead) - c_in * ch).clamp(0, ch), 0)
    hi_j = torch.where(valid_j, (take(tot) - c_in * ch).clamp(0, ch), 0)
    chunks = torch.stack([astart_j, lo_j, hi_j,
                          nact[:, None].expand(nb, c_max)],
                         dim=-1).to(torch.int32).contiguous()

    inv = torch.empty((n,), dtype=torch.int32, device=dev)
    inv[order] = iot.to(torch.int32)
    return snap, chunks, inv, overflow_s


def block_prepare_cuda(rows, skey, order, starts, cfg: NBodyConfig, stats,
                       c_max: int, ch: int, b: int, dims=None,
                       grid: GridSpec | None = None):
    """Launch ``ps_block_prepare``, one CTA a block of ``b`` sorted rows
    (``b`` a multiple of :data:`C_ROWS`), on the records or the state's
    arrays; same contract as the plain version."""
    dev = skey.device
    n = skey.shape[0]
    num_cells, row_stride, plane_stride = _layout(cfg, n, b, dims)
    if c_max <= 0 or ch <= 0 or b % C_ROWS:
        raise ValueError(f"unsupported chunk budget c_max={c_max} ch={ch} "
                         f"or block size {b}")
    if isinstance(rows, Fields):
        _check(dev, rows.pos, torch.float32, (n, 3), "pos")
        _check(dev, rows.age, torch.float32, (n,), "age")
        _check(dev, rows.w, torch.float32, (n,), "w")
        _check(dev, rows.tags, torch.int64, (n,), "tags")
        ids = rows.ids
        if ids is not None:
            ids = ids.to(torch.int32).contiguous()
            _check(dev, ids, torch.int32, (n,), "ids")
        ptrs = (None, rows.pos.data_ptr(), rows.age.data_ptr(),
                rows.w.data_ptr(), rows.tags.data_ptr(),
                None if ids is None else ids.data_ptr())
    else:
        _check(dev, rows, torch.int32, (n, RECORD), "records", align=32)
        ptrs = (rows.data_ptr(), None, None, None, None, None)
    _check(dev, skey, torch.int32, (n,), "skey", align=16)
    _check(dev, order, torch.int64, (n,), "order", align=16)
    _check(dev, starts, torch.int32, (num_cells + 2,), "starts")
    if grid is not None and grid.num_cells != num_cells:
        raise ValueError(f"{num_cells} cells is not the grid's "
                         f"{grid.num_cells}")
    _check_stats(dev, stats, 0 if grid is None else grid.num_chunks)
    f = torch.empty((7, n), dtype=torch.float32, device=dev)
    i = torch.empty((2, n), dtype=torch.int32, device=dev)
    chunks = torch.empty((n // b, c_max, 4), dtype=torch.int32, device=dev)
    inv = torch.empty((n,), dtype=torch.int32, device=dev)
    overflow_s = torch.empty((n,), dtype=torch.bool, device=dev)
    offs = np.asarray(stencil_offsets(row_stride, plane_stride), np.int32)
    g, cd, cf = ((0, 0, 0) if grid is None else
                 (grid.grid_dim, grid.chunk_dim, grid.chunk_factor))
    launch("ps_block_prepare", dev, *ptrs, skey.data_ptr(),
           order.data_ptr(), starts.data_ptr(), n, b, num_cells,
           row_stride, plane_stride, offs.ctypes.data, cfg.cell_capacity,
           as_f32(cfg.kid_age), as_f32(cfg.particle_life), c_max, ch, g, cd,
           cf, f.data_ptr(), i.data_ptr(), chunks.data_ptr(), inv.data_ptr(),
           overflow_s.data_ptr(), stats.data_ptr())
    return Snapshot(f, i), chunks, inv, overflow_s


def block_prepare(rows, skey, order, starts, cfg: NBodyConfig, stats,
                  c_max: int, ch: int, b: int, dims=None,
                  grid: GridSpec | None = None):
    return by_device(skey, _KERNEL, block_prepare_cuda,
                     block_prepare_plain)(
        rows, skey, order, starts, cfg, stats, c_max, ch, b, dims=dims,
        grid=grid)


class Prepared(NamedTuple):
    """The pair kernel's inputs and what D reads beside them, as
    :func:`sort_and_prepare` returns them."""

    snap: Snapshot
    chunks: torch.Tensor       # (NB, c_max, 4) int32
    inv: torch.Tensor          # (N,) int32, slot -> sorted row
    overflow_s: torch.Tensor   # (N,) bool, sorted rows
    order: torch.Tensor        # (N,) int64, sorted row -> slot
    starts: torch.Tensor       # (num_cells + 2,) int32
    stats: torch.Tensor        # the frame's statistics buffer


def cells_and_rows(state: ParticleState, grid: GridSpec):
    """A on ``state``, with records where they pay (:func:`records_pay`):
    (the sort keys, the rows C reads: the records or the state's
    :class:`Fields`)."""
    records = records_pay(state.slots, state.device)
    key, rec = nbody_cells(state.pos, state.alive, state.age, state.w,
                           state.tag, grid, records)
    return key, rec if records else Fields(state.pos, state.age, state.w,
                                           state.tag)


def sort_and_prepare(key, rows, cfg: NBodyConfig, c_max: int, ch: int,
                     b: int, grid: GridSpec | None = None,
                     dims=None) -> Prepared:
    """The stable sort of the int32 sort keys ``key`` (A's, or ``alive ?
    cell : num_cells`` of the caller's cells), then B and C on ``rows``
    (A's records, or :class:`Fields`): the pair kernel's inputs.  The
    statistics buffer is made here, zeroed, with the chunk counters C adds
    the cubic ``grid``'s chunks into (none without it); D reduces them and
    adds to it, and so does E.  ``dims`` as in
    ``ops/neighbor_blocks.prepare``."""
    num_cells = _layout(cfg, key.shape[0], b, dims)[0]
    # int32 keys: the same stable order as int64 ones in half the passes
    skey, order = torch.sort(key, stable=True)
    stats = new_stats(key.device, 0 if grid is None else grid.num_chunks)
    starts = cell_starts(skey, num_cells)
    snap, chunks, inv, overflow_s = block_prepare(
        rows, skey, order, starts, cfg, stats, c_max, ch, b, dims=dims,
        grid=grid)
    return Prepared(snap, chunks, inv, overflow_s, order, starts, stats)


# --- D: lifecycle -----------------------------------------------------------------

def lifecycle_flags(state: ParticleState, pos_w, overflow, acc, kill, touch,
                    uvec, cfg: NBodyConfig):
    """The lifecycle flags, clamped integration and explosion of every
    slot, given the neighbor pass's slot-order results (the first part of
    ``models/nbody.lifecycle_update``).  Returns (the next state before
    the spawn, explode, {n_age_deaths, n_collision_kills,
    n_overflow_kills, n_survivals})."""
    dt = as_f32(cfg.dt)
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

    count = lambda m: m.sum(dtype=torch.int64)
    nxt = ParticleState(pos=pos, vel=vel, acc=accf, w=w, age=age, life=lifef,
                        alive=alive2, parent=parent, tag=state.tag)
    return nxt, explode, dict(n_age_deaths=count(die_age),
                              n_collision_kills=count(die_coll),
                              n_overflow_kills=count(overflow),
                              n_survivals=count(survive))


def _pass_rows(acc_s, n: int) -> int:
    """The rows of the pass D reads, at least its ``n`` slots."""
    m = acc_s.shape[-1]
    if m < n:
        raise ValueError(f"a pass of {m} rows for {n} slots")
    return m


def tile_counts(explode, free) -> torch.Tensor:
    """(ceil(N / :data:`TILE`), 2) int32: the explode and free slots of
    each tile (D's ``tiles``)."""
    n = explode.shape[0]
    both = torch.stack([explode, free], dim=1).to(torch.int32)
    pad = (-n) % TILE
    both = torch.cat([both, both.new_zeros((pad, 2))])
    return both.view(-1, TILE, 2).sum(dim=1, dtype=torch.int32)


def _copy_into(out: ParticleState, st: ParticleState) -> None:
    for f in FIELDS:
        dst, src = getattr(out, f), getattr(st, f)
        if dst is not src:
            dst.copy_(src)


def nbody_lifecycle_plain(state: ParticleState, out: ParticleState, acc_s,
                          gmax_s, overflow_s, inv, uvec, cfg: NBodyConfig,
                          stats):
    """Plain version of D on the N slots of ``state``: the pair kernel's
    sorted outputs of a pass over M >= N rows (acc_s (3, M), gmax_s,
    overflow_s (M,)) read through the first N entries of ``inv`` (slot ->
    sorted row), the mine-side collision age window,
    :func:`lifecycle_flags`; the next state (before the spawn) written into
    ``out`` (which may be ``state``), ``stats``' counts and, where it
    carries the chunk counters of ``cfg.grid`` (:func:`stats_chunks`),
    its largest chunk from them, which are left zero.  Returns (flags (N,)
    uint8, 1 explode and 2 free; tiles (ceil(N/TILE), 2) int32, the
    explode and free counts of each tile)."""
    num_chunks = stats_chunks(stats, cfg.grid)
    _pass_rows(acc_s, state.slots)
    rows = inv[:state.slots].to(torch.int64)
    acc = acc_s.T[rows]
    gmax = gmax_s[rows]
    overflow = overflow_s[rows]
    age0 = state.age
    win = (age0 >= as_f32(cfg.kid_age)) & (age0 <= as_f32(cfg.particle_life))
    kill = (gmax > collision_okey(state.tag)) & win
    touch = (gmax > IMIN) & win
    pos_w, _ = wrap_positions(state.pos, cfg.grid)
    nxt, explode, counts = lifecycle_flags(state, pos_w, overflow, acc, kill,
                                           touch, uvec, cfg)
    _copy_into(out, nxt)
    for name, v in counts.items():
        _add(stats, name, v)
    _add(stats, "n_alive", nxt.alive.sum(dtype=torch.int64))
    if num_chunks:
        counters = _chunk_counters(stats, num_chunks)
        _set(stats, "max_chunk_occupancy", counters.max())
        counters.zero_()
    free = ~nxt.alive
    flags = explode.to(torch.uint8) | (free.to(torch.uint8) << 1)
    return flags, tile_counts(explode, free)


def nbody_lifecycle_cuda(state: ParticleState, out: ParticleState, acc_s,
                         gmax_s, overflow_s, inv, uvec, cfg: NBodyConfig,
                         stats):
    """Launch ``ps_nbody_lifecycle``, one thread a slot (its block 0 also
    reduces the chunk counters); same contract as the plain version."""
    dev = state.pos.device
    n = state.slots
    m = _pass_rows(acc_s, n)
    _check_state(dev, state, n, "state")
    _check_state(dev, out, n, "out")
    _check(dev, acc_s, torch.float32, (3, m), "acc_s")
    _check(dev, gmax_s, torch.int32, (m,), "gmax_s")
    _check(dev, overflow_s, torch.bool, (m,), "overflow_s")
    if inv.dim() != 1 or inv.shape[0] < n:
        raise ValueError(f"inv must map the {n} slots, got "
                         f"{tuple(inv.shape)}")
    _check(dev, inv, torch.int32, inv.shape, "inv")
    _check(dev, uvec, torch.float32, (n, 3), "uvec")
    g = cfg.grid
    num_chunks = stats_chunks(stats, g)
    _check_stats(dev, stats, num_chunks)
    flags = torch.empty((n,), dtype=torch.uint8, device=dev)
    tiles = torch.empty((-(-n // TILE), 2), dtype=torch.int32, device=dev)
    consts = np.asarray([cfg.dt, cfg.particle_life, cfg.kid_age, cfg.max_dx,
                         cfg.max_v, cfg.explosion_speed, 1.0 / g.cell_size,
                         g.cell_size], np.float32)
    fields = (ctypes.c_void_p * 11)(*(t.data_ptr() for t in (
        state.pos, state.vel, state.w, state.age, state.life, out.pos,
        out.vel, out.acc, out.w, out.age, out.life)))
    bools = (ctypes.c_void_p * 4)(*(t.data_ptr() for t in (
        state.alive, state.parent, out.alive, out.parent)))
    tags = (ctypes.c_void_p * 2)(state.tag.data_ptr(), out.tag.data_ptr())
    launch("ps_nbody_lifecycle", dev, ctypes.addressof(fields),
           ctypes.addressof(bools), ctypes.addressof(tags), acc_s.data_ptr(),
           m, gmax_s.data_ptr(), overflow_s.data_ptr(), inv.data_ptr(),
           uvec.data_ptr(), n, consts.ctypes.data, g.grid_dim, num_chunks,
           flags.data_ptr(), tiles.data_ptr(), stats.data_ptr())
    return flags, tiles


def nbody_lifecycle(state, out, acc_s, gmax_s, overflow_s, inv, uvec,
                    cfg: NBodyConfig, stats):
    return by_device(state.pos, _KERNEL, nbody_lifecycle_cuda,
                     nbody_lifecycle_plain)(
        state, out, acc_s, gmax_s, overflow_s, inv, uvec, cfg, stats)


# --- E: spawn ---------------------------------------------------------------------

def spawn_children(st: ParticleState, explode, fert, frame,
                   cfg: NBodyConfig):
    """The spawn part of ``models/nbody.lifecycle_update`` on the state
    :func:`lifecycle_flags` returns, whose exploding parents hold their
    explosion velocity: the i-th exploding parent (ascending slot) fills
    the i-th free slot (ascending), for i < k = min(n_child, n_free,
    budget); children past the budget are dropped (mirrored by the
    oracle).  Returns (the next state, k, n_child)."""
    n = st.slots
    e = min(cfg.max_spawns_per_frame, n)
    free = ~st.alive
    n_child = explode.sum(dtype=torch.int64)
    k = torch.minimum(n_child, free.sum(dtype=torch.int64)).clamp(max=e)
    ok = torch.arange(e, device=n_child.device) < k
    src = rank_table(explode, e).clamp(max=n - 1)
    tgt = torch.where(ok, rank_table(free, e), n)

    child_tag = rng.tag_mix(st.tag[src], frame)
    out = ParticleState(
        pos=write_rows(st.pos, tgt, st.pos[src]),
        vel=write_rows(st.vel, tgt, -st.vel[src]),
        acc=write_rows(st.acc, tgt, 0.0),
        w=write_rows(st.w, tgt, as_f32(cfg.weight)),
        age=write_rows(st.age, tgt, 0.0),
        life=write_rows(st.life, tgt, fert[src]),
        alive=write_rows(st.alive, tgt, True),
        parent=write_rows(st.parent, tgt, False),
        tag=write_rows(st.tag, tgt, child_tag))
    return out, k, n_child


def nbody_spawn_plain(out: ParticleState, fert, frame, flags, tiles,
                      cfg: NBodyConfig, stats) -> None:
    """Plain version of E: :func:`spawn_children` of the exploding slots
    of ``flags`` (D's), written into ``out`` in place; ``stats``' spawned,
    capped and alive counts.  ``tiles`` is what the kernel sums its
    tiles' counts from."""
    explode = (flags & 1).bool()
    nxt, k, n_child = spawn_children(out, explode, fert, frame, cfg)
    _copy_into(out, nxt)
    e = min(cfg.max_spawns_per_frame, out.slots)
    _set(stats, "n_spawned", k)
    # children dropped for lack of free slots in the operated width
    # (budget drops are excluded by the min with e)
    _set(stats, "n_spawn_capped", torch.clamp(n_child, max=e) - k)
    _add(stats, "n_alive", k)


def spawn_scratch_words(n: int, e: int) -> int:
    """The 64-bit words of E's scratch for ``n`` slots and the budget
    ``e``: a status word a ranking tile, then the tables of the exploding
    and the free slots of rank below ``e`` (int32 each).  Raises for an
    ``n`` the status words cannot count."""
    if not 0 < n <= SPAWN_MAX_SLOTS or not 0 < e <= n:
        raise ValueError(f"E ranks 1 to {SPAWN_MAX_SLOTS} slots with a "
                         f"budget of 1 to n, got n={n}, e={e}")
    return -(-n // SPAWN_TILE) + e


def nbody_spawn_cuda(out: ParticleState, fert, frame, flags, tiles,
                     cfg: NBodyConfig, stats) -> None:
    """Launch ``ps_nbody_spawn``: a memset of its status words, then two
    kernels (the ranks against the budget by a decoupled look-back; the
    children, k read on the device), the frame read on the device
    (``rng_kernel.frame_on``); same contract as the plain version."""
    dev = out.pos.device
    n = out.slots
    _check_state(dev, out, n, "out")
    _check(dev, fert, torch.float32, (n,), "fert")
    _check(dev, flags, torch.uint8, (n,), "flags")
    _check(dev, tiles, torch.int32, (-(-n // TILE), 2), "tiles")
    _check_stats(dev, stats)
    if n == 0:
        return
    e = min(cfg.max_spawns_per_frame, n)
    scratch = torch.empty((spawn_scratch_words(n, e),), dtype=torch.int64,
                          device=dev)
    frame = frame_on(frame, dev)
    fields = (ctypes.c_void_p * 6)(*(t.data_ptr() for t in (
        out.pos, out.vel, out.acc, out.w, out.age, out.life)))
    bools = (ctypes.c_void_p * 2)(out.alive.data_ptr(),
                                  out.parent.data_ptr())
    launch("ps_nbody_spawn", dev, ctypes.addressof(fields),
           ctypes.addressof(bools), out.tag.data_ptr(), fert.data_ptr(),
           frame.data_ptr(), flags.data_ptr(), tiles.data_ptr(), n, e,
           as_f32(cfg.weight), scratch.data_ptr(), stats.data_ptr())


def nbody_spawn(out, fert, frame, flags, tiles, cfg: NBodyConfig,
                stats) -> None:
    return by_device(out.pos, _KERNEL, nbody_spawn_cuda, nbody_spawn_plain)(
        out, fert, frame, flags, tiles, cfg, stats)
