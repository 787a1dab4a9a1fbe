"""Run the reference simulation end to end and dump the final state.

    python -m particlesystem_tpu_torch.examples.nbody_demo \\
        [n_fill=100000] [iters=10] [--device cpu]

Counterpart of the JAX package's ``examples/nbody_demo.py``: a uniform
fill of ``n_fill`` particles in the 16^3-cell box, then ``iters`` frames of
the step (age death, collision kill/survive, 27-cell softened gravity,
clamped Euler, torus wrap, aging, explosion reproduction).  It prints the
per-iteration statistics (the reference's phase-timing printf,
``particleSystem.cpp:1927``), the phase timers, and a summary of the final
state with the 4x4x4 chunk occupancy (the reference's commented-out debug
dump, ``:1933-1983``).
"""

from __future__ import annotations

import argparse

import numpy as np

from ..api import NBodySimulation
from ..core.config import GridSpec, NBodyConfig


def dump_state(sim: NBodySimulation) -> None:
    """Final-state summary: the reference's debug dump, aggregated."""
    s = sim.state
    alive = s.alive.cpu().numpy()
    pos = s.pos.cpu().numpy()[alive]
    age = s.age.cpu().numpy()[alive]
    w = s.w.cpu().numpy()[alive]
    g = sim.cfg.grid
    print(f"\n-- final state (frame {sim.frame}) --")
    print(f"alive {alive.sum()} / {alive.size} slots "
          f"(fill was {sim.cfg.n_fill})")
    print(f"pos   x [{pos[:, 0].min():+7.2f}, {pos[:, 0].max():+7.2f}]  "
          f"y [{pos[:, 1].min():+7.2f}, {pos[:, 1].max():+7.2f}]  "
          f"z [{pos[:, 2].min():+7.2f}, {pos[:, 2].max():+7.2f}]  "
          f"(box +-{g.half_extent})")
    print(f"age   [{age.min():6.2f}, {age.max():6.2f}]  "
          f"(kid<{sim.cfg.kid_age}, life={sim.cfg.particle_life})")
    print(f"w     [{w.min():.1f}, {w.max():.1f}]")
    st = sim.last_stats
    print(f"stats n_alive={int(st.n_alive)} n_spawned={int(st.n_spawned)} "
          f"max_cell_occupancy={int(st.max_cell_occupancy)} "
          f"(cell kill cap {sim.cfg.cell_capacity})")
    # per-chunk occupancy: the reference's chunkgrid dump, 4x4x4 totals
    cf = g.chunk_factor
    cw = g.grid_dim // cf * g.cell_size
    idx = np.clip(((pos + g.half_extent) // cw).astype(int), 0, cf - 1)
    occ = np.zeros((cf, cf, cf), int)
    np.add.at(occ, (idx[:, 0], idx[:, 1], idx[:, 2]), 1)
    print(f"chunk occupancy ({cf}^3): min {occ.min()}  "
          f"median {int(np.median(occ))}  max {occ.max()}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="nbody_demo")
    ap.add_argument("n_fill", nargs="?", type=int, default=100_000)
    ap.add_argument("iters", nargs="?", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = NBodyConfig(n_fill=args.n_fill, grid=GridSpec(grid_dim=16))
    print(f"n_fill={args.n_fill} slots={cfg.slots} "
          f"grid={cfg.grid.grid_dim}^3 dt={cfg.dt} iters={args.iters}")

    sim = NBodySimulation(cfg, device=args.device)
    sim.run(args.iters, verbose=True)
    for name, rec in sim.timers.summary().items():
        print(f"phase {name:8s} total {rec['total_s'] * 1e3:8.1f} ms "
              f"({rec['count']} calls, mean {rec['mean_ms']:.1f} ms)")
    dump_state(sim)


if __name__ == "__main__":
    main()
