"""Multi-device n-body: 2-D pencil decomposition over a (d3, d1) rank mesh.

Counterpart of ``particlesystem_tpu/parallel/nbody_pencil.py``.  Rank
(a, b) of mesh axes ("x", "y") owns the pencil

    i3 in [a*P3, (a+1)*P3)   x   i1 in [b*P1, (b+1)*P1)   x   all i2,

so halo traffic shrinks from whole planes to pencil faces.  Corner cells
need no special case: the halo runs axis by axis (i3 faces along "x", then
the i1 faces of the set extended by the first phase along "y", whose
forwarded rows are the corner cells), and migration takes one hop a ring
(a particle crossing a corner takes two in one frame).  The per-rank frame
is :func:`.nbody_sharded.make_step`; axes with one rank are statically
skipped, since their ring would duplicate every particle.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..core.config import NBodyConfig
from ..core.state import ParticleState
from .nbody_sharded import Split, _distribute, _owner_np, _shard_fn, make_step


@dataclasses.dataclass(frozen=True)
class PencilSpec:
    """(d3, d1) pencil decomposition parameters: ``d3`` ranks along grid
    axis i3 (mesh axis "x"), ``d1`` along i1 ("y"); ``d1 = 1`` is the
    slab.  ``impl``: per-rank neighbor pass, "blocks" or "dense"."""

    d3: int
    d1: int
    axes: Tuple[str, str] = ("x", "y")
    halo_capacity: int = 0       # rows per i3-face buffer; 0 -> derived
    halo1_capacity: int = 0      # rows per i1-face buffer; 0 -> derived
    migration_capacity: int = 0  # rows per direction;      0 -> derived
    impl: str = "dense"

    @property
    def n_devices(self) -> int:
        return self.d3 * self.d1

    @property
    def mesh_shape(self) -> Tuple[int, ...]:
        return (self.d3, self.d1)

    @property
    def mesh_axes(self) -> Tuple[str, ...]:
        return tuple(self.axes)

    def derive(self, cfg: NBodyConfig) -> "PencilSpec":
        g = cfg.grid
        for d, nm in ((self.d3, "d3"), (self.d1, "d1")):
            if g.grid_dim % d:
                raise ValueError(f"grid_dim {g.grid_dim} % {nm}={d}")
        if cfg.slots % self.n_devices:
            raise ValueError(f"slots {cfg.slots} % devices {self.n_devices}")
        p3 = g.grid_dim // self.d3
        p1 = g.grid_dim // self.d1
        # worst-case face occupancy; size from the reported high-water
        # marks instead (DistributedNBodySimulation.autosize_buffers)
        face3 = cfg.cell_capacity * g.grid_dim * p1
        face1 = cfg.cell_capacity * g.grid_dim * (p3 + 2)
        return dataclasses.replace(
            self, halo_capacity=self.halo_capacity or face3,
            halo1_capacity=self.halo1_capacity or face1,
            migration_capacity=self.migration_capacity or max(face3, face1))

    def splits(self) -> Tuple[Split, ...]:
        ax3, ax1 = self.axes
        return (Split(2, ax3, self.d3, self.halo_capacity),
                Split(0, ax1, self.d1, self.halo1_capacity))


def make_pencil_step(cfg: NBodyConfig, spec: PencilSpec, mesh):
    """(step_fn, shard_state_fn) over a (d3, d1) ``mesh``; rank (a, b)
    holds global slots ``[(a*d1 + b)*c_local, ...)``."""
    return make_step(cfg, spec.derive(cfg), mesh), _shard_fn(cfg, mesh)


def dest_np(pos, cfg: NBodyConfig, spec: PencilSpec):
    """Owning linear rank ``a*d1 + b`` per row (host-side numpy)."""
    import numpy as np
    return _owner_np(np.asarray(pos), cfg, spec.derive(cfg).splits())


def distribute(state: ParticleState, cfg: NBodyConfig, spec: PencilSpec
               ) -> Tuple[ParticleState, int]:
    """Reorder a global state so that rank (a, b) holds exactly its
    pencil's particles; returns (state, n_dropped)."""
    return _distribute(state, cfg, spec.derive(cfg).splits())
