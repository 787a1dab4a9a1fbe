"""The benchmark: the emitter engine's particle-steps/s and the n-body
simulation's ms a frame, on the card.

    python -m particlesystem_tpu_torch bench

Counterpart of the JAX package's ``bench.py``, with its stages and their
sizes, in one process:

* ``cap_10m`` / ``cap_1m``: the bench scene (BASELINE config 5: two
  emitters, gravity, wind and drag, a ground plane and a sphere) through
  ``PackedEngine(alloc="select", layout="packed8")`` at 10,485,760 and
  1,048,576 slots, from a state with every slot alive and long-lived, so
  that the metric counts real particle updates.  A frame's time is the
  slope between a short and a long ``step_many`` batch, which cancels the
  fixed cost of starting and ending a measurement; particle-steps/s is
  slots over it.
* ``nbody_1m`` / ``nbody_10m``: ``NBodySimulation(impl="blocks")`` at
  1,048,576 particles in a 16^3 grid and 10,485,760 in 32^3.  Three frames
  of ``run(3, batch=1)`` compact the state and pick the active prefix, as
  for any user; then the slope between a short and a long batched
  ``run(k, batch=k)`` gives the frame's time, inside the initial cohort's
  plateau (frames below ~35 at 1M, past which the population collapses in
  expiry waves).  The prefix must not move in the timed window, and
  ``run``'s guards must hold over every frame: no row alive past the
  prefix, no spawn capped, no neighbour chunk dropped.
* ``nbody_sharded_d1``: ``DistributedNBodySimulation`` with
  ``SlabSpec(n_devices=1, impl="blocks")`` over a one-rank group (NCCL on
  a card, where its frames replay one captured graph, the all-reduces in
  it) at 1M, full width (the sharded driver picks no prefix), timed the
  same way; its three drop counters must stay 0.

Times are CUDA events on a card (the host clock on the CPU, where the
tests run every stage tiny).  Each stage also reports its peak device
memory (``torch.cuda.max_memory_allocated``, reset at the stage's start;
None on the CPU).  The output is one JSON line, printed again after every
stage; a stage that raises ends the run with a non-zero exit after the
line so far.  ``backend`` names the card and its power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them.
"""

from __future__ import annotations

import datetime
import json
import subprocess
import sys
import time
from typing import Callable, Dict

import torch

from .api import NBodySimulation
from .core.config import (Emitter, EmitterSceneConfig, GridSpec,
                          NBodyConfig, PlaneCollider, SphereCollider)
from .runtime.engine import PackedEngine
from .utils.device import resolve_device
from .utils.timers import slope_ms

#: frames of ``run(WARM_FRAMES, batch=1)`` before an n-body measurement
WARM_FRAMES = 3

#: stage -> {field of the stage's result: key of the JSON line}; every
#: stage also gives ``peak_bytes_<stage>``
KEYS = {
    "cap_10m": {"rate": "value", "ms": "p50_frame_ms_10M",
                "alive": "alive_10M"},
    "cap_1m": {"rate": "particle_steps_per_sec_at_1M",
               "ms": "p50_frame_ms_1M", "alive": "alive_1M"},
    "nbody_1m": {"ms": "nbody_1M_ms_per_frame", "alive": "nbody_1M_alive",
                 "active": "nbody_1M_active_rows"},
    "nbody_sharded_d1": {"ms": "nbody_1M_sharded_d1_ms",
                         "alive": "nbody_1M_sharded_d1_alive"},
    "nbody_10m": {"ms": "nbody_10M_ms_per_frame",
                  "alive": "nbody_10M_alive",
                  "active": "nbody_10M_active_rows"},
}


def scene(capacity: int) -> EmitterSceneConfig:
    """The bench scene (``bench.py:44-62`` of the JAX package)."""
    return EmitterSceneConfig(
        capacity=capacity, dt=1.0 / 60.0, gravity=(0.0, -9.8, 0.0),
        wind=(2.0, 0.0, -0.5), drag=0.2,
        emitters=(
            Emitter(pos=(0.0, 1.0, 0.0), direction=(0.0, 1.0, 0.0),
                    speed=10.0, rate=60_000.0, life_min=20.0, life_max=40.0),
            Emitter(pos=(5.0, 1.0, 0.0), direction=(-0.2, 1.0, 0.1),
                    speed=8.0, rate=40_000.0, life_min=20.0, life_max=40.0),
        ),
        planes=(PlaneCollider(point=(0, 0, 0), normal=(0, 1, 0),
                              restitution=0.5, friction=0.2),),
        spheres=(SphereCollider(center=(2.0, 3.0, 0.0), radius=1.5,
                                restitution=0.4, friction=0.1),),
        seed=1)


def full_packed(n: int, device, seed: int = 0):
    """Every slot alive with a long lifetime (``bench.py:65-73``): the
    eight packed8 fields, drawn on ``device`` from a generator seeded with
    ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=g, device=device)
        return lo + (hi - lo) * u

    pos = uniform((3, n), -20.0, 20.0)
    vel = uniform((3, n), -5.0, 5.0)
    life = uniform((n,), 30.0, 60.0)
    return (*pos.unbind(), *vel.unbind(), life * 0.1, life)


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device: torch.device):
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def _positive(ms: float) -> float:
    """``ms``, checked after the stage's guards: a frame time that is not
    positive is a broken measurement."""
    if not ms > 0:
        raise RuntimeError(f"non-positive frame time {ms} ms from the slope")
    return ms


def bench_capacity(capacity: int, k_short: int = 16, k_long: int = 112,
                   reps: int = 5, soak: int = 0, device="cuda") -> dict:
    """The emitter stage at ``capacity`` slots: {"rate": particle-steps/s,
    "ms": the median slope's ms a frame, "alive", "peak_bytes"}.
    ``soak`` long batches run before the measurement, to hold the card at
    its sustained-load clock."""
    dev = resolve_device(device)
    _reset_peak(dev)
    cfg = scene(capacity)
    eng = PackedEngine(cfg, alloc="select", layout="packed8", device=dev)
    box = [eng.init(full_packed(cfg.slots, dev))]

    def run_k(k):
        box[0] = eng.step_many(box[0], k)

    run_k(k_short)
    run_k(k_long)
    for _ in range(soak):
        run_k(k_long)
    ms = _positive(slope_ms(run_k, k_short, k_long, reps, dev))
    return {"rate": cfg.slots / (ms * 1e-3), "ms": ms,
            "alive": int(eng.alive_count(box[0])), "peak_bytes": _peak(dev)}


def bench_nbody(n_fill: int = 1 << 20, grid_dim: int = 16, k_short: int = 2,
                k_long: int = 6, reps: int = 3, device="cuda") -> dict:
    """The n-body stage: {"ms": the median slope's ms a frame, "alive",
    "active": rows of the active prefix, "peak_bytes"}.  Raises when a
    guard trips in any frame or the prefix moves inside the timed
    window."""
    dev = resolve_device(device)
    _reset_peak(dev)
    cfg = NBodyConfig(n_fill=n_fill, grid=GridSpec(grid_dim=grid_dim))
    sim = NBodySimulation(cfg, device=dev, impl="blocks")
    sim.run(WARM_FRAMES, batch=1)
    active = sim._active or cfg.slots
    print(f"n-body {cfg.n_fill}: active prefix {active}/{cfg.slots} from "
          f"frame {sim.frame}", file=sys.stderr)
    ms = slope_ms(lambda k: sim.run(k, batch=k), k_short, k_long, reps, dev)
    moved = sim._active or cfg.slots
    print(f"n-body {cfg.n_fill}: active prefix {moved}/{cfg.slots} at "
          f"frame {sim.frame}", file=sys.stderr)
    if moved != active:
        raise RuntimeError(f"active prefix moved from {active} to {moved} "
                           f"inside the timed window (frames {WARM_FRAMES}-"
                           f"{sim.frame})")
    if sim.n_degraded_frames:
        raise RuntimeError(f"{sim.n_degraded_frames} batches dropped "
                           f"neighbour chunks")
    return {"ms": _positive(ms), "alive": int(sim.last_stats.n_alive),
            "active": active,
            "peak_bytes": _peak(dev)}


def bench_nbody_sharded_d1(n_fill: int = 1 << 20, grid_dim: int = 16,
                           k_short: int = 2, k_long: int = 6, reps: int = 3,
                           device="cuda") -> dict:
    """The sharded stage: the slab at one rank over a one-rank group of
    this process (NCCL on a card, gloo on the CPU): {"ms", "alive",
    "peak_bytes"}.  Raises when any drop counter is not 0."""
    import torch.distributed as dist

    from .parallel.driver import DistributedNBodySimulation
    from .parallel.mesh import device_backend, free_port
    from .parallel.nbody_sharded import SlabSpec

    dev = resolve_device(device)
    _reset_peak(dev)
    cfg = NBodyConfig(n_fill=n_fill, grid=GridSpec(grid_dim=grid_dim))
    dist.init_process_group(
        device_backend(dev.type), init_method=f"tcp://127.0.0.1:"
        f"{free_port()}", world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=600))
    try:
        sim = DistributedNBodySimulation(
            cfg, SlabSpec(n_devices=1, impl="blocks"),
            group=dist.group.WORLD, device=dev)
        sim.run(k_short, batch=k_short)
        ms = slope_ms(lambda k: sim.run(k, batch=k), k_short, k_long, reps,
                       dev)
        if sim.n_degraded_frames:
            raise RuntimeError(f"{sim.n_degraded_frames} batches dropped "
                               f"particles (last: {sim.last_stats})")
        return {"ms": _positive(ms), "alive": sim.alive_count(),
                "peak_bytes": _peak(dev)}
    finally:
        dist.destroy_process_group()


def stages(device="cuda") -> Dict[str, Callable[[], dict]]:
    """The stages at the JAX bench's sizes and counts
    (``bench.py:287-300``), in the order they run."""
    return {
        "cap_10m": lambda: bench_capacity(10 << 20, device=device),
        "cap_1m": lambda: bench_capacity(1 << 20, k_short=64, k_long=1024,
                                         reps=7, soak=4, device=device),
        "nbody_1m": lambda: bench_nbody(1 << 20, 16, device=device),
        "nbody_sharded_d1": lambda: bench_nbody_sharded_d1(device=device),
        # frames 3-15 (the JAX bench's 3-17): the 10M prefix is re-picked
        # in quanta of 1/19 of it, so a longer window leaves its bucket
        "nbody_10m": lambda: bench_nbody(10 << 20, 32, k_long=4, reps=2,
                                         device=device),
    }


def empty_line(backend: str) -> dict:
    """The JSON line before any stage has run: every value None."""
    res = {"metric": "particle_steps_per_sec_at_10M", "value": None,
           "unit": "particle-steps/s"}
    for name, keys in KEYS.items():
        res.update({k: None for k in keys.values()})
        res[f"peak_bytes_{name}"] = None
    res["backend"] = backend
    return res


def run(stage_fns: Dict[str, Callable[[], dict]], backend: str,
        out=None) -> dict:
    """Run ``stage_fns`` ({name: stage}, names from :data:`KEYS`) in
    order, printing the JSON line to ``out`` (stdout) before the first and
    after each; returns it.  A stage that raises prints the line so far
    and raises on."""
    out = out or sys.stdout
    res = empty_line(backend)

    def emit():
        print(json.dumps(res), file=out, flush=True)

    emit()
    for name, fn in stage_fns.items():
        t0 = time.perf_counter()
        try:
            r = fn()
        except BaseException:
            emit()
            raise
        for field, key in KEYS[name].items():
            res[key] = r[field]
        res[f"peak_bytes_{name}"] = r["peak_bytes"]
        print(f"{name}: {r} ({time.perf_counter() - t0:.1f} s)",
              file=sys.stderr, flush=True)
        emit()
    return res


def card_line() -> str:
    """The card's name and power limit, from ``nvidia-smi``."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> dict:
    """The ``bench`` command: every stage on the card."""
    resolve_device("cuda")
    return run(stages("cuda"), card_line())
