"""Uniform-grid cell mapping and torus wrap.

Counterpart of the cell helpers of ``particlesystem_tpu/ops/grid.py``
(``set_pos_t``, the reference's ``source/code/inc/app.cu:117-158``).  Axis
convention, kept bit for bit from the reference:

    i1 = floor(-y / cell) + G/2      (row    index)
    i2 = floor( x / cell) + G/2      (column index)
    i3 = floor(-z / cell) + G/2      (plane  index)
    cell_id = i3*G^2 + i1*G + i2

``build_bins`` is the dense pass's grid build (cell lists, occupancy
maxima, overflow kill: ``particleSystem_build_grid_host``,
``particleSystem.cpp:1468-1537``) as one stable sort and prefix sums; the
cluster-pair pass does its own binning in ``ops/neighbor_blocks.prepare``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.config import GridSpec


def cell_coords(pos: torch.Tensor, grid: GridSpec) -> torch.Tensor:
    """Unwrapped integer cell coordinates ``(..., 3) -> (i1, i2, i3)``."""
    half = grid.grid_dim // 2
    inv = 1.0 / grid.cell_size
    i1 = torch.floor(-pos[..., 1] * inv).to(torch.int32) + half
    i2 = torch.floor(pos[..., 0] * inv).to(torch.int32) + half
    i3 = torch.floor(-pos[..., 2] * inv).to(torch.int32) + half
    return torch.stack([i1, i2, i3], dim=-1)


def coords_to_cell(coords: torch.Tensor, grid: GridSpec) -> torch.Tensor:
    g = grid.grid_dim
    return coords[..., 2] * g * g + coords[..., 0] * g + coords[..., 1]


def wrap_positions(pos: torch.Tensor, grid: GridSpec):
    """Torus-wrap positions into the box; returns (wrapped_pos, coords).

    The coordinate is shifted by whole cell widths so the fractional position
    within its cell is preserved exactly (``app.cu:117-158``).  The cell
    index is reduced with ``torch.remainder`` (floor semantics, as
    ``jnp.mod``): ``fmod`` would leave negative cells negative.
    """
    g = grid.grid_dim
    c = cell_coords(pos, grid)
    cw = torch.remainder(c, g)
    d = (cw - c).to(pos.dtype)
    # x += (i2w - i2)*cs ; y -= (i1w - i1)*cs ; z -= (i3w - i3)*cs
    shift = torch.stack([d[..., 1], -d[..., 0], -d[..., 2]], dim=-1) \
        * grid.cell_size
    return pos + shift, cw


class GridBins(NamedTuple):
    """Result of binning ``slots`` particles into ``num_cells`` cells.

    * ``cell_list`` — ``(num_cells, width)`` int32 slot indices, ``-1`` pad;
      within a cell, slots appear in ascending slot order (stable sort),
      the serial insertion order of the reference's host path
      (``particleSystem.cpp:1488-1516``).
    * ``counts`` — per-cell live count, capped at ``width`` (int32).
    * ``overflow`` — particles that did not fit their cell; the reference
      kills these (``particleSystem.cpp:1517-1531``).
    * ``cell_of`` — per-slot cell id, ``num_cells`` if dead (int32).
    * ``max_cell_occupancy`` — the pre-cap count maximum (int32).
    * ``n_listed_dropped`` — rows inside the cell capacity that the
      narrowed lists left out this frame (int32).
    """

    cell_list: torch.Tensor
    counts: torch.Tensor
    overflow: torch.Tensor
    cell_of: torch.Tensor
    max_cell_occupancy: torch.Tensor
    n_listed_dropped: torch.Tensor


def count_keys(key: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(key, minlength=n)`` for keys in ``[0, n)``, as
    int64: a scatter-add, which a CUDA graph can capture (``bincount`` on a
    card reads the largest key back to the host to size its output)."""
    out = torch.zeros((n,), dtype=torch.int64, device=key.device)
    return out.index_add_(0, key, torch.ones_like(key, dtype=torch.int64))


def build_bins(cell_of: torch.Tensor, alive: torch.Tensor, num_cells: int,
               cell_capacity: int, list_width: int = 0) -> GridBins:
    """Sort-based grid build.  ``cell_of`` must already be in
    ``[0, num_cells)``.

    ``list_width`` (default ``cell_capacity``) narrows the padded cell
    lists for the neighbor pass, whose cost grows with the square of the
    width.  Kill semantics are unchanged (``overflow`` is still rank >=
    ``cell_capacity``); rows with rank in ``[list_width, cell_capacity)``
    are dropped from the lists for this frame and counted in
    ``n_listed_dropped``: callers keep that zero by sizing ``list_width``
    from the previous frame's ``max_cell_occupancy`` with a margin.
    """
    width = min(list_width or cell_capacity, cell_capacity)
    n = cell_of.shape[0]
    dev = cell_of.device
    slot = torch.arange(n, dtype=torch.int64, device=dev)
    key = torch.where(alive, cell_of.to(torch.int64), num_cells)

    # stable: rows of one cell keep ascending slot order
    sorted_key, order = torch.sort(key, stable=True)
    counts_all = count_keys(key, num_cells + 1)
    start = torch.cumsum(counts_all, dim=0) - counts_all
    rank_sorted = slot - start[sorted_key]

    in_grid = sorted_key < num_cells
    in_list = (rank_sorted < width) & in_grid
    # rows outside the lists land on one scratch element past the end
    flat = torch.where(in_list, sorted_key * width + rank_sorted,
                       num_cells * width)
    cell_list = torch.full((num_cells * width + 1,), -1, dtype=torch.int32,
                           device=dev)
    cell_list[flat] = order.to(torch.int32)
    cell_list = cell_list[:-1].view(num_cells, width)

    overflow = torch.zeros((n,), dtype=torch.bool, device=dev)
    overflow[order] = (rank_sorted >= cell_capacity) & in_grid

    live_counts = counts_all[:num_cells]
    dropped = (rank_sorted >= width) & (rank_sorted < cell_capacity) & in_grid
    return GridBins(
        cell_list=cell_list,
        counts=live_counts.clamp(max=width).to(torch.int32),
        overflow=overflow,
        cell_of=key.to(torch.int32),
        max_cell_occupancy=live_counts.max().to(torch.int32),
        n_listed_dropped=dropped.sum(dtype=torch.int32),
    )


def chunk_occupancy(cell_of: torch.Tensor, alive: torch.Tensor,
                    grid: GridSpec) -> torch.Tensor:
    """Per-chunk live counts: the ``chunkgrid`` occupancy statistic
    (``particleSystem.cpp:1502-1508``); stays on the device."""
    g, cd, cf = grid.grid_dim, grid.chunk_dim, grid.chunk_factor
    cell_of = cell_of.to(torch.int64)
    i3 = cell_of // (g * g)
    rem = cell_of % (g * g)
    i1 = rem // g
    i2 = rem % g
    chunk = (i3 // cd) * cf * cf + (i1 // cd) * cf + (i2 // cd)
    chunk = torch.where(alive, chunk, cf ** 3)
    return count_keys(chunk, cf ** 3 + 1)[: cf ** 3]


# 27-cell stencil offsets in (i1, i2, i3).  The reference enumerates the same
# neighbourhood by linear-id arithmetic and rejects out-of-box candidates
# with an integer distance test (``fill_cells``, ``app.cu:352-409``): a
# per-axis bounds check, with no periodic wrap even though positions wrap
# (boundary cells have truncated stencils).
STENCIL = np.array(
    [(d1, d2, d3) for d3 in (-1, 0, 1) for d1 in (-1, 0, 1)
     for d2 in (-1, 0, 1)], dtype=np.int32)


def stencil_cells(coords: torch.Tensor, grid: GridSpec):
    """For cell coords ``(3,)`` return the (27,) neighbour cell ids (0 where
    out of the box) and their validity mask."""
    g = grid.grid_dim
    nc = coords[None, :] + torch.as_tensor(STENCIL, device=coords.device)
    valid = ((nc >= 0) & (nc < g)).all(dim=1)
    ids = nc[:, 2] * g * g + nc[:, 0] * g + nc[:, 1]
    return torch.where(valid, ids, 0), valid
