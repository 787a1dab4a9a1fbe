"""Cluster-pair neighbor pass: sorted particle blocks against listed chunks
of cell-sorted neighbor columns.

Counterpart of ``particlesystem_tpu/ops/neighbor_blocks.py``; the
semantics are the same, the TPU layout workarounds are gone:

* particles are sorted by cell id (dead last); a *block* is ``B``
  consecutive sorted rows, so work scales with live particles, not cells;
* :func:`prepare` lists, per block, up to ``C_MAX`` 128-aligned chunks of at
  most ``CH`` sorted columns covering the block's 27-cell stencil: cells with
  consecutive i2 are adjacent in sorted order, so each (i1 row, i3 plane)
  offset of the stencil is one contiguous range of sorted rows;
* the kernel (``csrc/neighbor_blocks.cu``, or :func:`cluster_pair_plain`
  for CPU tensors) walks each block's chunks and applies the per-pair tests:
  the 3x3x3 cell stencil (at most one cell apart on every axis, which for
  integer deltas IS ``cd2 <= 3.5``; ``fill_cells``, ``app.cu:352-409``), gid
  inequality and the chunk's valid column range; then Plummer gravity
  (``bodyBodyInteraction``, ``app_common.cu:236-267``) and the collision key
  max (``bodyBodyCollision``, ``app_common.cu:269-301``, larger key survives).

The snapshot is two tensors: float32 rows (x, y, z, i1, i2, i3, w) and int32
rows (gid, cgid).  Ids stay integers: the CUDA kernel moves gid through
shared memory beside the cell coordinates, as bits, and computes on it only
as an integer.

All gating is folded into the snapshot so the kernel's only per-pair tests
are the stencil, the id inequality and the contact radius (and a row or
column with ``i1 < 0`` can be dropped before any pair is formed, which the
CUDA kernel does):

* rows that are dead, past the per-cell cap, or younger than ``kid_age``
  (kids neither exert nor receive gravity) get out-of-band cell coordinates
  that fail the stencil test against every other row.  Values are spaced 2
  apart within a band; the kid band [-10 - 2^20, -10] and the dead band
  [-2^22 - 2^20, -2^22] are disjoint; all stay below 2^23 so float32
  differences are exact integers.  Axes i1/i3 and i2 use the coprime row
  moduli 2^19 and 2^19-1, so two distinct rows share all three coordinates
  only if their index difference is a multiple of 2^19*(2^19-1).  The
  coordinates stay float32: an int32 square of a dead-band delta overflows.
* the collision age window's upper edge rides the cgid row (ineligible rows
  carry INT32_MIN and never win the max); the mine-side window is applied
  after the unsort.

Collision results leave the kernel as one reduction, ``gmax`` = the largest
order key over colliding neighbors (INT32_MIN if none); ``kill = gmax >
my_okey`` and ``touch = gmax > INT32_MIN`` are derived per slot.

Capacity escapes are reported, never silent: blocks whose stencil needs
more than ``c_max`` chunks drop the excess, and the count comes back as
``n_chunks_dropped`` (surfaced as ``NBodyStats.n_listed_dropped``).

A block whose few in-band rows would leave most of its CTA's warps idle
(a run's plateau) is walked by groups of warps, each over its own share of
every piece of the listed columns, their partial sums added in group
order; so a row's sum is fixed by the state alone.  :func:`walk_counts`
reads how many blocks the kernel walked so.
"""

from __future__ import annotations

from typing import Tuple

import ctypes

import numpy as np
import torch

from ..core.config import NBodyConfig
from ..utils import cuda_build
from ..utils.cuda_build import by_device, launch
from . import frame_kernels as fk
from .frame_kernels import Snapshot
from .neighbor import IMIN, as_f32, collision_okey

B = 512        # block rows per kernel CTA
CH = 1024      # columns per listed chunk
C_MAX = 48     # chunk slots per block
PLAIN_PAIRS = 1 << 24  # pair elements per step of the plain version
#: the kernel's walk counters, in ``walk_counts()``' order
WALK_COUNTS = ("passes", "sparse_blocks")


def prepare(pos0, age0, w0, cell, alive, cfg: NBodyConfig, tags,
            c_max: int | None = None, ch: int | None = None,
            b: int | None = None, dims=None, ids=None):
    """Sort by cell and build the kernel inputs: the sort key ``alive ?
    cell : num_cells`` (int32) through
    :func:`~.frame_kernels.sort_and_prepare` (the stable sort, then B and
    C, which gathers the rows' fields from the arrays given: the CUDA
    kernels for CUDA tensors and their plain versions for CPU ones).

    ``tags`` are the persistent particle tags whose :func:`collision_okey`
    orders kill/survive.  ``dims = (d1, d2, d3)`` generalises the cubic
    grid (cell id ``i3*(d1*d2) + i1*d2 + i2``), e.g. a rank's sub-grid
    extended by halo layers; ``ids`` (int32) are the rows' pair
    self-exclusion identities, slot indices when not given.  They must be
    unique among the rows with in-band cell coordinates: the kernel
    compares them only where ``eps2`` is below ``MIN_NORMAL_EPS2`` and
    otherwise relies on the self pair alone having equal ids.  ``c_max``,
    ``ch`` and ``b`` override the module's chunk budget, chunk width and
    block rows.

    Returns (snap :class:`Snapshot`, chunks (NB, c_max, 4) int32 — columns
    (aligned_start, lo, hi, n_active) — order (sorted row -> slot),
    overflow_s (sorted-side per-cell-cap overflow), max_cell_occupancy,
    per-cell counts (num_cells + 1,), n_chunks_dropped).
    """
    c_max = C_MAX if c_max is None else c_max
    ch = CH if ch is None else ch
    b = B if b is None else b
    g = cfg.grid.grid_dim
    d1, d2, d3 = dims or (g, g, g)
    num_cells = d1 * d2 * d3
    key = torch.where(alive, cell.to(torch.int32), num_cells)
    p = fk.sort_and_prepare(key, fk.Fields(pos0, age0, w0, tags, ids), cfg,
                            c_max, ch, b, dims=dims)
    counts = (p.starts[1:] - p.starts[:-1]).to(torch.int64)
    return (p.snap, p.chunks, p.order, p.overflow_s,
            p.stats[fk.STAT["max_cell_occupancy"]], counts,
            p.stats[fk.STAT["n_listed_dropped"]])


# ---------------------------------------------------------------------------
# the kernel and its plain version
# ---------------------------------------------------------------------------


def _pair_constants(cfg: NBodyConfig):
    eps2 = as_f32(cfg.eps2)
    r2 = (np.float32(cfg.collision_radius) ** 2).item()
    return eps2, r2


def _block_ids(chunks, blocks):
    if blocks is None:
        return torch.arange(chunks.shape[0], device=chunks.device)
    return blocks.to(torch.int64)


def cluster_pair_plain(cfg: NBodyConfig, snap: Snapshot, chunks, b: int,
                       ch: int, blocks=None):
    """Plain PyTorch version of the cluster-pair kernel, same inputs and
    outputs: returns (acc (3, M) float32, gmax (M,) int32) for the rows of
    the listed ``blocks`` (all blocks when ``None``) in that order,
    M = len(blocks) * b.

    Loops over chunk slots, vectorised over a batch of blocks, each step
    bounded to about ``PLAIN_PAIRS`` pair elements.  The stencil test is the
    kernel's (one cell at most on every axis, which for these coordinates is
    ``cd2 <= 3.5``) and ``d2`` is plain float32 multiplies and adds in the
    kernel's order, so the pair and contact tests agree with the kernel
    exactly."""
    eps2, r2 = _pair_constants(cfg)
    dev = snap.f.device
    blk = _block_ids(chunks, blocks)
    nsel = blk.numel()
    rows = (blk[:, None] * b + torch.arange(b, device=dev)).reshape(-1)
    mine = snap.f[:, rows].view(7, nsel, b, 1)
    mine_gid = snap.i[0, rows].view(nsel, b, 1)
    acc = torch.zeros((3, nsel, b), dtype=torch.float32, device=dev)
    gmax = torch.full((nsel, b), IMIN, dtype=torch.int32, device=dev)
    per = max(1, PLAIN_PAIRS // (b * ch))
    for s0 in range(0, nsel, per):
        sl = slice(s0, s0 + per)
        ct = chunks[blk[sl]].to(torch.int64)            # (nbb, c_max, 4)
        mx, my, mz, m1, m2, m3, _ = mine[:, sl]
        for j in range(int(ct[:, 0, 3].max())):
            lo, hi = ct[:, j, 1:2], ct[:, j, 2:3]
            # no column at or past the batch's largest hi is in range
            col = torch.arange(int(hi.max()), device=dev)
            in_rng = (col >= lo) & (col < hi)           # (nbb, width)
            cidx = torch.where(in_rng, ct[:, j, 0:1] + col, 0)
            nx, ny, nz, n1, n2, n3, nw = snap.f[:, cidx].unsqueeze(2)
            ngid, ncg = snap.i[:, cidx].unsqueeze(2)
            dx, dy, dz = nx - mx, ny - my, nz - mz      # (nbb, b, width)
            d2 = dx * dx + dy * dy + dz * dz
            inside = (((n1 - m1).abs() <= 1.0) & ((n2 - m2).abs() <= 1.0)
                      & ((n3 - m3).abs() <= 1.0))
            pg = inside & (ngid != mine_gid[sl]) & in_rng[:, None, :]
            rs = torch.rsqrt(d2 + eps2)
            sw = torch.where(pg, rs * rs * rs, 0.0) * nw
            gsel = torch.where(pg & (d2 <= r2), ncg, IMIN)
            gmax[sl] = torch.maximum(gmax[sl], gsel.amax(dim=2))
            acc[0, sl] += (dx * sw).sum(dim=2)
            acc[1, sl] += (dy * sw).sum(dim=2)
            acc[2, sl] += (dz * sw).sum(dim=2)
    return acc.view(3, nsel * b), gmax.view(nsel * b)


def walk_counts(device=None) -> dict:
    """The kernel's walk counters on a CUDA device (the current one when
    ``None``), after the work queued on its current stream: pair passes
    (``passes``) and blocks walked by groups of warps (``sparse_blocks``).
    Both only grow; take differences.  Syncs: never call it inside a run
    loop."""
    dev = torch.device("cuda" if device is None else device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    out = (ctypes.c_longlong * len(WALK_COUNTS))()
    cuda_build.read("ps_cluster_pair_counts", dev, ctypes.addressof(out))
    return dict(zip(WALK_COUNTS, out))


def cluster_pair_cuda(cfg: NBodyConfig, snap: Snapshot, chunks, b: int,
                      ch: int, blocks=None):
    """Launch the CUDA cluster-pair kernel (``csrc/neighbor_blocks.cu``:
    the dense and the sparse walks); same contract as
    :func:`cluster_pair_plain` (``gmax`` exact, ``acc`` within 1e-5 of
    ``max(1, max|acc|)``; a row's sum in the order the kernel's source
    sets out, fixed by the state).  ``ch`` is only validated:
    the kernel reads each chunk's valid columns from the chunk table and
    cuts them into pieces of its own width."""
    f, i = snap
    n = f.shape[1]
    dev = f.device
    if f.dtype != torch.float32 or f.shape != (7, n) or not f.is_contiguous():
        raise ValueError(f"snap.f must be contiguous float32 (7, N), got "
                         f"{f.dtype} {tuple(f.shape)}")
    if i.dtype != torch.int32 or i.shape != (2, n) or not i.is_contiguous():
        raise ValueError(f"snap.i must be contiguous int32 (2, N), got "
                         f"{i.dtype} {tuple(i.shape)}")
    if (chunks.dtype != torch.int32 or chunks.dim() != 3
            or chunks.shape[2] != 4 or not chunks.is_contiguous()):
        raise ValueError("chunks must be a contiguous int32 (NB, c_max, 4)")
    if chunks.shape[0] * b != n:
        raise ValueError(f"{chunks.shape[0]} blocks of {b} rows != N={n}")
    if ch <= 0 or not 0 < b <= 1024:
        raise ValueError(f"unsupported tile b={b} ch={ch}")
    for t in (i, chunks) + (() if blocks is None else (blocks,)):
        if t.device != dev:
            raise ValueError("all kernel inputs must be on one device")
    # the kernel fetches four columns (16 bytes) a copy
    if n % 4 or any(t.data_ptr() % 16 for t in (f, i, chunks)):
        raise ValueError(f"the snapshot and the chunk table must be 16-byte "
                         f"aligned and N={n} a multiple of 4")
    if blocks is not None:
        if blocks.dtype != torch.int32 or blocks.dim() != 1:
            raise ValueError("blocks must be a 1-D int32 tensor")
        if blocks.numel():
            low, high = torch.stack(torch.aminmax(blocks)).tolist()  # one sync
            if not 0 <= low <= high < chunks.shape[0]:
                raise ValueError("blocks must index the chunk table's blocks")
        blocks = blocks.contiguous()
    nsel = chunks.shape[0] if blocks is None else blocks.numel()
    eps2, r2 = _pair_constants(cfg)
    m = nsel * b
    acc = torch.empty((3, m), dtype=torch.float32, device=dev)
    gmax = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return acc, gmax
    launch("ps_cluster_pair", dev, f.data_ptr(), i.data_ptr(), n,
           chunks.data_ptr(), None if blocks is None else blocks.data_ptr(),
           nsel, b, chunks.shape[1], eps2, r2, acc.data_ptr(), m,
           gmax.data_ptr())
    return acc, gmax


def kernel_call(cfg: NBodyConfig, snap: Snapshot, chunks,
                ch: int | None = None, b: int | None = None):
    """Run the cluster-pair kernel on prepared inputs; returns the
    sorted-order (acc (3, N), gmax (N,) int32).  CUDA tensors launch the
    CUDA kernel; CPU tensors take :func:`cluster_pair_plain`."""
    ch = CH if ch is None else ch
    b = B if b is None else b
    return by_device(snap.f, "cluster-pair kernel", cluster_pair_cuda,
                     cluster_pair_plain)(cfg, snap, chunks, b, ch)


def unsort_outputs(acc_s, gmax_s, order, overflow_s, okeys):
    """Scatter the sorted-order kernel outputs back to slot order; returns
    (acc (N, 3), kill, touch, overflow).  ``okeys`` is the mine-side
    collision order key (:func:`collision_okey` of the tags): collisions
    are ordered by the tags' okey, not by slot or by ``ids``, which is what
    keeps a decomposed run's kill/survive decisions those of one device."""
    acc = torch.empty((order.shape[0], 3), dtype=acc_s.dtype,
                      device=acc_s.device)
    acc[order] = acc_s.T
    gmax = torch.empty_like(gmax_s)
    gmax[order] = gmax_s
    overflow = torch.empty_like(overflow_s)
    overflow[order] = overflow_s
    return acc, gmax > okeys, gmax > IMIN, overflow


def neighbor_pass_blocks(pos0, age0, w0, cell, alive, cfg: NBodyConfig,
                         tags, c_max: int | None = None,
                         ch: int | None = None, b: int | None = None,
                         dims=None, ids=None) -> Tuple[torch.Tensor, ...]:
    """Full pass: returns per-slot (acc (N, 3), kill, touch, overflow,
    max_cell_occupancy, per-cell counts, n_chunks_dropped), as the JAX
    package's ``neighbor_pass_blocks``; ``dims`` and ``ids`` as in
    :func:`prepare`.  A nonzero ``n_chunks_dropped``
    means some blocks' stencils exceeded the chunk budget and interactions
    were lost; callers surface it (``NBodyStats.n_listed_dropped``)."""
    ch = CH if ch is None else ch
    b = B if b is None else b
    snap, chunks, order, overflow_s, max_occ, counts, n_dropped = prepare(
        pos0, age0, w0, cell, alive, cfg, tags, c_max=c_max, ch=ch, b=b,
        dims=dims, ids=ids)
    acc_s, gmax_s = kernel_call(cfg, snap, chunks, ch=ch, b=b)
    acc, kill, touch, overflow = unsort_outputs(
        acc_s, gmax_s, order, overflow_s, collision_okey(tags))
    # mine-side collision age window (the neighbor side rides cgid)
    win = (age0 >= as_f32(cfg.kid_age)) & (age0 <= as_f32(cfg.particle_life))
    return (acc, kill & win, touch & win, overflow, max_occ, counts,
            n_dropped)
