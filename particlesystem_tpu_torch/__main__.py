"""CLI launcher — the analog of the reference's ``make run``
(``makefile:3-4``):

    python -m particlesystem_tpu_torch nbody --particles 1048576 \
        --grid-dim 16 --iterations 10 --device cuda
"""

from __future__ import annotations

import argparse


def _cmd_nbody(args):
    from .api import NBodySimulation
    from .core.config import GridSpec, NBodyConfig

    cfg = NBodyConfig(n_fill=args.particles,
                      grid=GridSpec(grid_dim=args.grid_dim))
    sim = NBodySimulation(cfg, device=args.device)
    sim.run(args.iterations, verbose=True, batch=args.batch)
    print(sim.timers.report())


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
    p.add_argument("--batch", type=int, default=0,
                   help="frames per host synchronisation (iterations must "
                        "divide by it). 0 = auto: largest divisor of "
                        "--iterations <= 16. 1 = per-frame readbacks")
    p.set_defaults(fn=_cmd_nbody)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
