"""Multi-device n-body: 3-D brick decomposition over a (d3, d1, d2) mesh.

Counterpart of ``particlesystem_tpu/parallel/nbody_brick.py``, the full
analog of the reference's 4x4x4 chunk ownership (``set_pkg_segments``,
``app_common.cu:150-232``).  Rank (a, b, c) of mesh axes ("x", "y", "z")
owns the brick

    i3 in [a*P3, (a+1)*P3) x i1 in [b*P1, (b+1)*P1) x i2 in [c*P2, (c+1)*P2).

Face, edge and corner co-ownership is one mechanism: the halo runs axis by
axis (i3, i1, i2), each later phase exchanging the faces of the set the
earlier ones extended, and migration runs the three rings in the same
order (a corner-crossing particle takes up to three hops in one frame).
Every axis is extended by a halo layer a side in the binning, also where
it has one rank; axes with one rank exchange and migrate nothing.  The
per-rank frame is :func:`.nbody_sharded.make_step`; its statistics reduce
over the whole group.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..core.config import NBodyConfig
from ..core.state import ParticleState
from .nbody_sharded import Split, _distribute, _owner_np, _shard_fn, make_step


@dataclasses.dataclass(frozen=True)
class BrickSpec:
    """(d3, d1, d2) brick decomposition parameters: ``d3`` ranks along
    grid axis i3 (mesh axis "x"), ``d1`` along i1 ("y"), ``d2`` along i2
    ("z").  ``impl``: per-rank neighbor pass, "blocks" or "dense"."""

    d3: int
    d1: int = 1
    d2: int = 1
    axes: Tuple[str, str, str] = ("x", "y", "z")
    halo_capacity: int = 0       # rows per face buffer;  0 -> derived
    migration_capacity: int = 0  # rows per direction;    0 -> derived
    impl: str = "dense"

    @property
    def n_devices(self) -> int:
        return self.d3 * self.d1 * self.d2

    @property
    def mesh_shape(self) -> Tuple[int, ...]:
        return (self.d3, self.d1, self.d2)

    @property
    def mesh_axes(self) -> Tuple[str, ...]:
        return tuple(self.axes)

    def derive(self, cfg: NBodyConfig) -> "BrickSpec":
        g = cfg.grid
        for d, nm in ((self.d3, "d3"), (self.d1, "d1"), (self.d2, "d2")):
            if g.grid_dim % d:
                raise ValueError(f"grid_dim {g.grid_dim} % {nm}={d}")
        if cfg.slots % self.n_devices:
            raise ValueError(f"slots {cfg.slots} % devices {self.n_devices}")
        p3 = g.grid_dim // self.d3
        p1 = g.grid_dim // self.d1
        p2 = g.grid_dim // self.d2
        # worst-case occupancy of the three (extended-set) faces
        faces = (cfg.cell_capacity * p1 * p2,
                 cfg.cell_capacity * (p3 + 2) * p2,
                 cfg.cell_capacity * (p3 + 2) * (p1 + 2))
        return dataclasses.replace(
            self, halo_capacity=self.halo_capacity or max(faces),
            migration_capacity=self.migration_capacity or max(faces))

    def splits(self) -> Tuple[Split, ...]:
        ax3, ax1, ax2 = self.axes
        h = self.halo_capacity
        return (Split(2, ax3, self.d3, h), Split(0, ax1, self.d1, h),
                Split(1, ax2, self.d2, h))


def make_brick_step(cfg: NBodyConfig, spec: BrickSpec, mesh):
    """(step_fn, shard_state_fn) over a (d3, d1, d2) ``mesh``; rank
    (a, b, c) holds global slots ``[((a*d1 + b)*d2 + c)*c_local, ...)``."""
    return make_step(cfg, spec.derive(cfg), mesh), _shard_fn(cfg, mesh)


def dest_np(pos, cfg: NBodyConfig, spec: BrickSpec):
    """Owning linear rank ``(a*d1 + b)*d2 + c`` per row (host numpy)."""
    import numpy as np
    return _owner_np(np.asarray(pos), cfg, spec.derive(cfg).splits())


def distribute(state: ParticleState, cfg: NBodyConfig, spec: BrickSpec
               ) -> Tuple[ParticleState, int]:
    """Reorder a global state so that rank (a, b, c) holds exactly its
    brick's particles; returns (state, n_dropped)."""
    return _distribute(state, cfg, spec.derive(cfg).splits())
