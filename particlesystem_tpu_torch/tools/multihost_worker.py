"""One rank of a multi-node n-body run started by a launcher.

    PSTPU_COORDINATOR=host:port PSTPU_NUM_PROCESSES=8 PSTPU_PROCESS_ID=r \\
    LOCAL_WORLD_SIZE=4 \\
    python -m particlesystem_tpu_torch.tools.multihost_worker [--device cpu]

Counterpart of the JAX package's ``tools/multihost_worker.py``.  The rank
joins the run through ``parallel.mesh.maybe_init_distributed``, driven by
the ``PSTPU_*`` variables alone (the mpirun hostfile's role); the group's
backend comes from ``--device`` (``parallel.mesh.device_backend``).  Eight
ranks, one process each, make two nodes of ``LOCAL_WORLD_SIZE=4``, and each
decomposition's mesh comes from ``parallel.mesh.hybrid_mesh``, so the node
seam falls on the "x" axis and every other migration ring stays inside a
node: slab 8 as ``hybrid_mesh((4,), (2,))``, pencil (4, 2) as
``hybrid_mesh((2, 2), (2, 1))``, brick (2, 2, 2) as
``hybrid_mesh((1, 2, 2), (2, 1, 1))``.  The decompositions run in turn, and
for each the rank prints three lines:

* ``STATS <decomp> [...]``: the global statistics of 3 frames;
* ``DRIVER <decomp> {...}``: after 2 frames of a fresh run, a digest of the
  gathered state, ``validate(1)`` against the numpy oracle (shard-local,
  with no gather of the state) and a save;
* ``SHARDCKPT <decomp> {...}``: a sharded checkpoint, of which this rank
  wrote only its own rows, resumed slot for slot after 2 more frames, with
  no gather on the save or load path.

Scratch and checkpoint files go in one directory that rank 0 makes in the
temp dir and shares with the others; across nodes, point ``TMPDIR`` at a
filesystem every rank shares.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import GridSpec, NBodyConfig
from ..core.state import FIELDS
from ..parallel import (BrickSpec, DistributedNBodySimulation, PencilSpec,
                        SlabSpec)
from ..parallel.driver import shared_scratch
from ..parallel.mesh import (device_backend, hybrid_mesh,
                             maybe_init_distributed)

#: ``tools/multihost_worker.py:44-48`` of the JAX package
CFG = NBodyConfig(
    n_fill=2000, capacity=8192,
    grid=GridSpec(grid_dim=16, cell_size=5.0, chunk_factor=4),
    particle_life=3.0, seed=11)

#: decomposition -> (spec, hybrid mesh (ici_shape, dcn_shape, axes)) over
#: 2 nodes of 4 ranks
DECOMPS = {
    "slab": (SlabSpec(n_devices=8), ((4,), (2,), ("x",))),
    "pencil": (PencilSpec(d3=4, d1=2), ((2, 2), (2, 1), ("x", "y"))),
    "brick": (BrickSpec(d3=2, d1=2, d2=2),
              ((1, 2, 2), (2, 1, 1), ("x", "y", "z"))),
}

N_RANKS = 8
LOCAL_WORLD_SIZE = 4


def _count_gathers(sim) -> dict:
    """Count the state gathers of ``sim``'s mesh from here on."""
    seen = {"n": 0}
    inner = sim.mesh.all_gather

    def counting(x):
        seen["n"] += 1
        return inner(x)

    sim.mesh.all_gather = counting
    return seen


def _local_numpy(sim) -> list:
    """A copy of this rank's state: the driver's loop writes it in
    place."""
    return [getattr(sim.state, f).cpu().numpy().copy() for f in FIELDS]


def run_decomp(name: str, group, device, scratch: str) -> None:
    spec, (ici, dcn, axes) = DECOMPS[name]
    mesh = hybrid_mesh(ici, dcn, axes, group)
    rank = dist.get_rank(group)

    sim = DistributedNBodySimulation(CFG, spec, group=group, mesh=mesh,
                                     device=device)
    if sim.n_fill_dropped:
        raise RuntimeError(f"{sim.n_fill_dropped} dropped at distribution")
    stats = [sim.run(1, batch=1) for _ in range(3)]
    print(f"STATS {name} " + json.dumps(stats), flush=True)

    sim = DistributedNBodySimulation(CFG, spec, group=group, mesh=mesh,
                                     device=device)
    sim.run(2)
    g = sim.gather()
    digest = float(g.pos.double().sum()) + float(g.age.double().sum())
    gathers = _count_gathers(sim)
    v = sim.validate(1, scratch_dir=os.path.join(scratch, f"{name}_v"))
    sim.save(os.path.join(scratch, f"{name}_save"))
    if gathers["n"]:
        raise RuntimeError("validate() or save() gathered the state")
    print(f"DRIVER {name} " + json.dumps({
        "alive": sim.alive_count(), "digest": digest,
        "events_match": bool(v["events_match"]),
        "max_dev": float(v["max_row_deviation"])}), flush=True)

    ck = os.path.join(scratch, f"{name}_ckpt")
    frame_at_save = sim.frame
    sim.save(ck)
    local_bytes = sum(getattr(sim.state, f).numel()
                      * getattr(sim.state, f).element_size() for f in FIELDS)
    shard = os.path.join(ck, f"shard_p{rank:05d}.npz")
    with np.load(shard) as z:
        rows = z["l0s0_idx"][0].tolist()  # pos: [[start, stop], [0, 3]]
    n_files = sum(fn.startswith("shard_p") for fn in os.listdir(ck))
    before = _local_numpy(sim)
    sim.run(2)
    dropped = sim.load(ck)
    if dropped or sim.frame != frame_at_save:
        raise RuntimeError(f"resume: {dropped} dropped, frame {sim.frame}")
    for a, b in zip(before, _local_numpy(sim)):
        np.testing.assert_array_equal(a, b)
    if gathers["n"]:
        raise RuntimeError("save() or load() gathered the state")
    sim.run(1)
    print(f"SHARDCKPT {name} " + json.dumps({
        "ok": True, "my_bytes": os.path.getsize(shard),
        "global_bytes": local_bytes * mesh.size, "rows": rows,
        "n_shard_files": n_files, "alive": sim.alive_count()}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="multihost_worker")
    ap.add_argument("--device", default="cuda",
                    help="cuda: a card a rank (NCCL); cuda:N or cpu: one "
                         "device every rank shares (gloo)")
    args = ap.parse_args(argv)

    group = maybe_init_distributed(backend=device_backend(args.device))
    if group is None:
        raise SystemExit("PSTPU_COORDINATOR, PSTPU_NUM_PROCESSES and "
                         "PSTPU_PROCESS_ID are not set")
    try:
        if (dist.get_world_size(group) != N_RANKS
                or int(os.environ.get("LOCAL_WORLD_SIZE", 0))
                != LOCAL_WORLD_SIZE):
            raise SystemExit(f"the layouts want {N_RANKS} ranks in nodes of "
                             f"LOCAL_WORLD_SIZE={LOCAL_WORLD_SIZE}")
        with shared_scratch(group) as scratch:
            for name in DECOMPS:
                run_decomp(name, group, args.device, scratch)
    finally:
        dist.destroy_process_group()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


if __name__ == "__main__":
    main()
