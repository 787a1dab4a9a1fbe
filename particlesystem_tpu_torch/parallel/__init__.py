"""Multi-device decompositions and the distributed driver, one process a
rank over ``torch.distributed``.

* ``mesh`` — rank meshes (1-D/2-D/3-D, node-aware), the collectives,
  process-group setup and :func:`~.mesh.spawn`
* ``nbody_sharded`` / ``nbody_pencil`` / ``nbody_brick`` — slab / pencil /
  brick spatial decompositions of the n-body scene
* ``emitter_sharded`` — data-parallel emitter engine
* ``driver`` — :class:`DistributedNBodySimulation`
"""

from .driver import DistributedNBodySimulation
from .emitter_sharded import ShardedEmitterEngine
from .mesh import (RankMesh, default_mesh, hybrid_mesh, maybe_init_distributed,
                   mesh_1d, mesh_2d, mesh_3d, spawn)
from .nbody_brick import BrickSpec
from .nbody_pencil import PencilSpec
from .nbody_sharded import SlabSpec

__all__ = [
    "BrickSpec", "DistributedNBodySimulation", "PencilSpec", "RankMesh",
    "ShardedEmitterEngine", "SlabSpec", "default_mesh", "hybrid_mesh",
    "maybe_init_distributed", "mesh_1d", "mesh_2d", "mesh_3d", "spawn",
]
