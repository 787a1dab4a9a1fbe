"""The exact-parity horizon of the decomposed n-body: how many frames an
8-rank run (slab, pencil, brick) follows the single-device run exactly,
over several seeds.

    python -m particlesystem_tpu_torch.tools.parity_horizon \\
        [--frames 40] [--seeds 11 23 37] [--decomps slab pencil brick] \\
        [--impl blocks|dense] [--device cuda|cuda:N|cpu]

Counterpart of the JAX package's ``tools/parity_horizon.py``, on 8 ranks
spawned once for every run, sharing ``--device`` over gloo (``cuda``, the
default, is the current card; ``cpu`` runs the kernels' plain versions).
The default pass is ``blocks``, the pair kernel on a card: what the CLI
runs and ``validate`` checks.  Collisions are ordered by the persistent
tags, so slot placement does not part the runs; what does is the order in
which gravity is summed (each rank lists its rows in another order),
single-ulp noise that the chaotic system amplifies until a collision or a
threshold decision flips.  For each (decomposition, seed) the tool prints
the first frame whose alive-tag multiset differs from the single-device
run on the same slot arrangement and device, and the first frame whose
event counters differ (or "none" within ``--frames``), then the smallest
over the seeds: ``DistributedNBodySimulation.validate``'s default window
(7 frames) must lie inside it.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..core.config import GridSpec, NBodyConfig
from ..models import nbody
from ..parallel import (BrickSpec, DistributedNBodySimulation, PencilSpec,
                        SlabSpec, spawn)
from ..utils.device import resolve_device

BASE_CFG = NBodyConfig(
    n_fill=3000, capacity=8192,
    grid=GridSpec(grid_dim=16, cell_size=5.0, chunk_factor=4),
    particle_life=3.0,   # fast lifecycle: deaths and births within frames
    seed=11)

DECOMPS = {
    "slab": lambda impl: SlabSpec(n_devices=8, impl=impl),
    "pencil": lambda impl: PencilSpec(d3=4, d1=2, impl=impl),
    "brick": lambda impl: BrickSpec(d3=2, d1=2, d2=2, impl=impl),
}

EVENTS = ("n_age_deaths", "n_collision_kills", "n_survivals", "n_alive")


def _alive_tags(state) -> np.ndarray:
    return np.sort(state.tag[state.alive].cpu().numpy())


def horizon(rank, group, name, seed, frames, impl, device):
    """(first tag-multiset mismatch, first event mismatch) of one run, each
    None when the runs agree through ``frames``; collective."""
    cfg = dataclasses.replace(BASE_CFG, seed=seed)
    sim = DistributedNBodySimulation(cfg, DECOMPS[name](impl), group=group,
                                     device=device)
    if sim.n_fill_dropped:
        raise RuntimeError(f"{sim.n_fill_dropped} dropped at distribution")
    single = sim.gather()  # the same slot arrangement on one device
    first_tag = first_event = None
    for frame in range(frames):
        stats = sim.run(1, batch=1)
        tags = _alive_tags(sim.gather())
        if rank == 0:
            single, sstats = nbody.step(single, frame, cfg, impl)
            if first_event is None and any(
                    stats[k] != int(getattr(sstats, k)) for k in EVENTS):
                first_event = frame
            if first_tag is None and not np.array_equal(
                    tags, _alive_tags(single)):
                first_tag = frame
        done = torch.tensor(int(first_tag is not None
                                and first_event is not None))
        if int(sim.mesh.pmax(done)):  # every rank stops together
            break
    return first_tag, first_event


def _rank(rank, group, runs, frames, impl, device):
    torch.set_num_threads(1)
    return {run: horizon(rank, group, *run, frames, impl, device)
            for run in runs}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="parity_horizon")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--seeds", type=int, nargs="+", default=[11, 23, 37])
    ap.add_argument("--decomps", nargs="+", default=list(DECOMPS),
                    choices=list(DECOMPS))
    ap.add_argument("--impl", choices=("dense", "blocks"), default="blocks",
                    help="each rank's neighbour pass")
    ap.add_argument("--device", default="cuda",
                    help="the device every rank shares over gloo")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    runs = [(name, seed) for name in args.decomps for seed in args.seeds]
    results = spawn(_rank, 8, (runs, args.frames, args.impl, str(dev)),
                    backend="gloo", timeout=3600.0)[0]
    for (name, seed), (ft, fe) in results.items():
        print(f"{name:7s} {args.impl} {dev} seed {seed:3d}: first tag-multiset "
              f"mismatch {'none' if ft is None else ft} / first event "
              f"mismatch {'none' if fe is None else fe} (horizon "
              f"{args.frames})", flush=True)
    print("\nsummary (min over seeds = safe exact-parity window):")
    for name in args.decomps:
        fts = [results[(name, s)][0] for s in args.seeds]
        fts = [args.frames if x is None else x for x in fts]
        print(f"  {name:7s}: exact through frame {min(fts) - 1} "
              f"(per-seed first mismatch: {fts})")
    return results


if __name__ == "__main__":
    main()
