"""CLI launcher — the analog of the reference's ``make run``
(``makefile:3-4``):

    python -m particlesystem_tpu_torch nbody --particles 1048576 \
        --grid-dim 16 --iterations 10 --device cuda \
        [--impl dense] [--validate] [--save run.npz]
    python -m particlesystem_tpu_torch nbody --devices 2 --decomp slab \
        [--d3 N] [--autosize] [--device cuda:0]
    python -m particlesystem_tpu_torch demo --capacity 1000000 --frames 600

``--devices D`` (or an explicit ``--decomp``) runs the decomposed
simulation (``parallel.driver.DistributedNBodySimulation``) on D ranks, one
process each.  Under a launcher (``PSTPU_COORDINATOR``,
``PSTPU_NUM_PROCESSES`` and ``PSTPU_PROCESS_ID`` set, see
``parallel/mesh.py``) this process is one rank; otherwise it spawns the D
ranks itself over localhost.  ``--device cuda`` gives each rank its own card,
``cuda:{local rank}`` (rank r of a local spawn: ``cuda:r``; under a launcher
``LOCAL_RANK``, else ``PSTPU_PROCESS_ID % LOCAL_WORLD_SIZE``), over NCCL; a
device with an index (``cuda:0``) or ``cpu`` is shared by every rank, over
gloo.  ``--validate`` on several ranks writes its scratch files next to
``--save`` (else in the temp dir): a run across nodes needs a ``--save``
directory on a filesystem every rank shares.

    python -m particlesystem_tpu_torch bench

runs the benchmark stages on the card and prints one JSON line
(``particlesystem_tpu_torch/bench.py``).
"""

from __future__ import annotations

import argparse
import math


def _cmd_nbody(args):
    from .api import NBodySimulation
    from .core.config import GridSpec, NBodyConfig

    cfg = NBodyConfig(n_fill=args.particles,
                      grid=GridSpec(grid_dim=args.grid_dim))
    if args.devices > 1 or args.decomp:
        _run_nbody_sharded(args, cfg)
        return
    sim = NBodySimulation(cfg, device=args.device, impl=args.impl)
    sim.run(args.iterations, verbose=True, batch=args.batch)
    if args.validate:
        print(f"validate: {sim.validate()}")
    if args.save:
        sim.save(args.save)
        print(f"checkpoint written to {args.save}")
    print(sim.timers.report())


def _run_nbody_sharded(args, cfg):
    """The decomposed simulation: this process as one rank under a
    launcher, or the ranks spawned here."""
    import torch.distributed as dist

    from .parallel import mesh as meshmod
    from .parallel.driver import cli_rank

    backend = meshmod.device_backend(args.device)
    group = meshmod.maybe_init_distributed(backend=backend)
    if group is not None or args.devices == 1:
        cli_rank(0 if group is None else dist.get_rank(group), group, args,
                 cfg)
        return
    options = argparse.Namespace(**{k: v for k, v in vars(args).items()
                                    if k != "fn"})  # what pickles
    meshmod.spawn(cli_rank, args.devices, (options, cfg), backend=backend,
                  timeout=math.inf)


def _cmd_demo(args):
    from .api import ParticleSystem

    ps = (ParticleSystem(capacity=args.capacity, dt=1 / 60,
                         gravity=(0, -9.8, 0), drag=0.2, wind=(2.0, 0, 0),
                         alloc=args.alloc, layout=args.layout,
                         device=args.device)
          .add_emitter(pos=(0.0, 1.0, 0.0), rate=args.capacity * 0.5,
                       speed=9.0, life_min=1.0, life_max=2.0)
          .add_plane(restitution=0.5, friction=0.2))
    chunk = 60
    for _ in range(args.frames // chunk):
        ps.step(chunk)
        print(f"frame {ps.frame}: alive {ps.alive_count()}")
    print(ps.timers.report())


def _cmd_bench(args):
    from . import bench

    bench.main()


def main(argv=None):
    parser = argparse.ArgumentParser(prog="particlesystem_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("nbody", help="run the reference n-body simulation")
    p.add_argument("--particles", type=int, default=1 << 20)
    p.add_argument("--grid-dim", type=int, default=16)
    p.add_argument("--iterations", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda needs a card; cpu runs the "
                        "kernels' plain versions)")
    p.add_argument("--devices", type=int, default=1,
                   help="ranks of the decomposed run (the mpirun -n analog)")
    p.add_argument("--decomp", choices=("slab", "pencil", "brick"),
                   default=None, help="spatial decomposition (default slab "
                                      "when --devices > 1)")
    p.add_argument("--d3", type=int, default=0,
                   help="ranks along i3 for pencil/brick (0 = auto)")
    p.add_argument("--autosize", action="store_true",
                   help="measure-then-shrink halo/migration buffers before "
                        "the run (decomposed runs only)")
    p.add_argument("--impl", choices=("blocks", "dense"), default="blocks",
                   help="neighbor pass: the cluster-pair kernel, or the "
                        "dense cell-pair pass in plain tensor code")
    p.add_argument("--batch", type=int, default=0,
                   help="frames per host synchronisation (iterations must "
                        "divide by it). 0 = auto: largest divisor of "
                        "--iterations <= 16. 1 = per-frame readbacks")
    p.add_argument("--save", default="",
                   help="write a checkpoint here after the run")
    p.add_argument("--validate", action="store_true",
                   help="compare the step against the numpy oracle after "
                        "the run; on several ranks its scratch files go "
                        "next to --save (else the temp dir), so a run "
                        "across nodes needs a --save directory on a "
                        "filesystem every rank shares")
    p.set_defaults(fn=_cmd_nbody)

    p = sub.add_parser("demo", help="run an emitter demo scene")
    p.add_argument("--capacity", type=int, default=1 << 20)
    p.add_argument("--frames", type=int, default=600)
    p.add_argument("--alloc", choices=("exact", "ring", "strided", "select"),
                   default="ring", help="slot recycling policy")
    p.add_argument("--layout", choices=("packed8", "slim"),
                   default="packed8",
                   help="state layout (slim: derived liveness, 7 fields)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda needs a card; cpu runs the "
                        "kernels' plain versions)")
    p.set_defaults(fn=_cmd_demo)

    p = sub.add_parser("bench", help="run the benchmark stages (cap_10m, "
                                     "cap_1m, nbody_1m, nbody_sharded_d1, "
                                     "nbody_10m) on the card and print one "
                                     "JSON line")
    p.set_defaults(fn=_cmd_bench)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
