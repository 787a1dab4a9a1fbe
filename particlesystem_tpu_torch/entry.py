"""Entry points: one frame of the emitter engine, and a dry run of the
multi-device n-body.

Counterparts of the JAX package's ``__graft_entry__.py``:

* :func:`entry` returns ``(fn, example_args)`` for one
  ``PackedEngine.step`` of the flagship emitter scene (BASELINE config-5
  shape: two emitters, the full force stack, a plane and a sphere,
  ``alloc="select"``, the bench's path) at 1<<16 slots: the engine's
  frame graph, what the JAX caller's ``jax.jit`` of the frame is; on a
  card each call after the first is one replay, which launches the
  physics kernel.
* :func:`dryrun_multichip` runs one frame of each spatial decomposition
  the rank count allows (slab; pencil ``(n/2, 2)`` when n is even and at
  least 4; brick ``(n/4, 2, 2)`` when n is a multiple of 8) on ``n`` ranks
  over gloo, all in one spawn, at a tiny config, and returns each one's
  frame statistics.

Both run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from .core.config import (Emitter, EmitterSceneConfig, GridSpec,
                          NBodyConfig, PlaneCollider, SphereCollider)
from .runtime.engine import PackedEngine
from .utils.device import resolve_device

#: seconds the dry run's ranks may take, spawn included
DRYRUN_TIMEOUT = 600.0


def entry_scene() -> EmitterSceneConfig:
    """``__graft_entry__.py:20-36``: the bench scene's shape with short
    lives and half the rates, at 1<<16 slots."""
    return EmitterSceneConfig(
        capacity=1 << 16, dt=1.0 / 60.0, gravity=(0.0, -9.8, 0.0),
        wind=(2.0, 0.0, -0.5), drag=0.2,
        emitters=(
            Emitter(pos=(0.0, 1.0, 0.0), speed=10.0, rate=30_000.0,
                    life_min=1.0, life_max=2.0),
            Emitter(pos=(5.0, 1.0, 0.0), direction=(-0.2, 1.0, 0.1),
                    speed=8.0, rate=20_000.0, life_min=1.0, life_max=2.0),
        ),
        planes=(PlaneCollider(restitution=0.5, friction=0.2),),
        spheres=(SphereCollider(center=(2.0, 3.0, 0.0), radius=1.5,
                                restitution=0.4, friction=0.1),))


def entry(device="cuda"):
    """(fn, example_args): one frame of the emitter engine on ``device``,
    ``fn(*example_args)`` the state after it (the engine's static state,
    which the next call overwrites)."""
    eng = PackedEngine(entry_scene(), alloc="select", device=device)
    return eng.step, (eng.init(),)


def dryrun_config(n_devices: int, chunk_factor: int) -> NBodyConfig:
    """``__graft_entry__.py:80-87``: 64 particles and 1024 slots a rank on
    a grid of 2n cells a side."""
    return NBodyConfig(
        n_fill=64 * n_devices, capacity=1024 * n_devices,
        grid=GridSpec(grid_dim=2 * n_devices, cell_size=5.0,
                      chunk_factor=chunk_factor),
        max_per_cell=16, seed=7)


def dryrun_specs(n_devices: int) -> dict:
    """{decomposition: (config, spec)} of the dry run on ``n_devices``
    ranks, each with the cluster-pair pass (the pair kernel on a card)."""
    from .parallel import BrickSpec, PencilSpec, SlabSpec

    n = n_devices
    out = {"slab": (dryrun_config(n, n), SlabSpec(n_devices=n,
                                                  impl="blocks"))}
    if n % 2 == 0 and n >= 4:
        out["pencil"] = (dryrun_config(n, 2),
                         PencilSpec(d3=n // 2, d1=2, impl="blocks"))
    if n % 8 == 0:
        out["brick"] = (dryrun_config(n, 2),
                        BrickSpec(d3=n // 4, d1=2, d2=2, impl="blocks"))
    return out


def _dryrun_rank(rank, group, n_devices, device):
    """One rank of :func:`dryrun_multichip`: the decompositions in turn,
    one frame each; returns {decomposition: statistics}, with
    ``pair_launches`` the rank's launches of the pair kernel in the frame."""
    from .parallel import DistributedNBodySimulation
    from .utils.cuda_build import launches

    out = {}
    for name, (cfg, spec) in dryrun_specs(n_devices).items():
        sim = DistributedNBodySimulation(cfg, spec, group=group,
                                         device=device)
        before = launches().get("ps_cluster_pair", 0)
        stats = sim.run(1, batch=1)
        if stats["n_alive"] <= 0:
            raise RuntimeError(f"{name} dry run produced an empty world")
        out[name] = dict(stats, pair_launches=launches().get(
            "ps_cluster_pair", 0) - before)
    return out


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One frame of slab, pencil and brick (as ``n_devices`` allows) on
    ``n_devices`` ranks, spawned once, sharing ``device`` (``cuda`` is the
    current card) over gloo.  Returns {decomposition: the frame's
    statistics and ``pair_launches``, each rank's launches of the pair
    kernel in it (0 on the CPU)}, the same on every rank."""
    from .parallel import spawn

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    per_rank = spawn(_dryrun_rank, n_devices, (n_devices, str(dev)),
                     backend="gloo", timeout=DRYRUN_TIMEOUT)
    if any(r != per_rank[0] for r in per_rank):
        raise RuntimeError(f"ranks disagree on the statistics: {per_rank}")
    return per_rank[0]
