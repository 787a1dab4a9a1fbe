"""Uniform-grid cell mapping and torus wrap.

Counterpart of the cell helpers of ``particlesystem_tpu/ops/grid.py``
(``set_pos_t``, the reference's ``source/code/inc/app.cu:117-158``).  Axis
convention, kept bit for bit from the reference:

    i1 = floor(-y / cell) + G/2      (row    index)
    i2 = floor( x / cell) + G/2      (column index)
    i3 = floor(-z / cell) + G/2      (plane  index)
    cell_id = i3*G^2 + i1*G + i2

The dense pass's binning (``build_bins``, ``chunk_occupancy``,
``stencil_cells``) is not ported yet; the cluster-pair pass does its own
binning in ``ops/neighbor_blocks.prepare``.
"""

from __future__ import annotations

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
