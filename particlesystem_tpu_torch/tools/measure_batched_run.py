"""The production batched loop against the bench's frame time, on the
card.

    python -m particlesystem_tpu_torch.tools.measure_batched_run \\
        [--particles 1048576] [--grid-dim 16] [--device cuda]

Counterpart of the JAX package's ``tools/measure_batched_run.py``, in one
process: ``NBodySimulation.run(16, batch=16)``, what ``python -m
particlesystem_tpu_torch nbody`` runs by default, must run at the bench's
frame time plus its one host synchronisation a batch.

1. the bench's ``nbody_1m`` stage (``bench.bench_nbody``): the slope
   between a short and a long batch, CUDA events, frames 3-27;
2. a fresh run of ``bench.WARM_FRAMES`` frames saved as a plateau
   checkpoint;
3. ``REPS`` times: the checkpoint loaded into a new simulation, whose
   active prefix is picked at once as ``run`` would pick it, one batch of
   16 frames run (which captures the prefix's frame graph) and the
   checkpoint loaded again, then ``run(16, batch=16)`` on the host clock
   (``run`` ends in a host read of the batch's statistics).
   Every timed batch is frames 3-18, inside the plateau window (frames
   below ~35 at 1M), and the tool fails if ``run`` re-picked the prefix at
   the batch's end, as the bench stage does.

Prints one JSON line: the slope, the per-frame times of ``run``, their
median less the slope, and the active prefix.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from .. import bench
from ..api import NBodySimulation
from ..core.config import GridSpec, NBodyConfig
from ..utils.device import resolve_device

BATCH = 16
REPS = 3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="measure_batched_run")
    ap.add_argument("--particles", type=int, default=1 << 20)
    ap.add_argument("--grid-dim", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    slope = bench.bench_nbody(args.particles, args.grid_dim, device=dev)
    cfg = NBodyConfig(n_fill=args.particles,
                      grid=GridSpec(grid_dim=args.grid_dim))
    sim = NBodySimulation(cfg, device=dev, impl="blocks")
    sim.run(bench.WARM_FRAMES, batch=1)
    per_frame = []
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "plateau.npz")
        sim.save(path)
        for _ in range(REPS):
            sim = NBodySimulation(cfg, device=dev, impl="blocks")
            # load() leaves the prefix to the first batch's end; pick it
            # now.  A warm batch, thrown away, captures the prefix's frame
            # graph, which the same key finds again after the second load
            sim.load(path)
            sim._apply_bucketing(int(sim.state.alive.sum()))
            sim._batch(BATCH)
            sim.load(path)
            sim._apply_bucketing(int(sim.state.alive.sum()))
            active = sim._active or cfg.slots
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            sim.run(BATCH, batch=BATCH)
            per_frame.append((time.perf_counter() - t0) / BATCH * 1e3)
            moved = sim._active or cfg.slots
            if moved != active:
                raise RuntimeError(
                    f"the batched run's prefix moved from {active} to "
                    f"{moved} at frame {sim.frame}")
    out = {"device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "bench_slope_ms": slope["ms"],
           "driver_run_batch16_ms": per_frame,
           "driver_minus_slope_ms": float(np.median(per_frame))
           - slope["ms"],
           "active_rows": active, "frames": sim.frame,
           "alive": int(sim.last_stats.n_alive)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
