"""Rank bodies for tests/test_torch_parallel.py.

They run in processes spawned by ``particlesystem_tpu_torch.parallel.spawn``
and import torch and the port only, never JAX: the JAX references are
computed in the test process.  :func:`world` runs every job of one world
size in one spawn and returns numpy results (rank 0's, unless a job
returns every rank's).
"""

from __future__ import annotations

import numpy as np
import torch

from particlesystem_tpu_torch.core.state import state_to_numpy
from particlesystem_tpu_torch.models import nbody
from particlesystem_tpu_torch.parallel import mesh as meshmod
from particlesystem_tpu_torch.parallel import nbody_sharded
from particlesystem_tpu_torch.parallel.nbody_brick import BrickSpec
from particlesystem_tpu_torch.parallel.driver import DistributedNBodySimulation
from particlesystem_tpu_torch.parallel.emitter_sharded import (
    ShardedEmitterEngine)
from particlesystem_tpu_torch.runtime.engine import engine_state_to_numpy


def world(rank, group, jobs):
    """Run ``jobs`` ([(name, kwargs)], the same on every rank) in order;
    returns {name: result}."""
    torch.set_num_threads(1)
    return {name: JOBS[name.split(":")[0]](rank, group, **kw)
            for name, kw in jobs}


def ppermute_job(rank, group):
    """A non-cyclic shift (rank 0 receives from no one) and a ring, each
    of a float and a bool tensor in one message."""
    n = group.size()
    x = [torch.full((3,), float(rank + 1)),
         torch.tensor([True, rank % 2 == 0])]
    shift = meshmod.ppermute(x, [(i, i + 1) for i in range(n - 1)], group)
    ring = meshmod.ppermute(x, [(i, (i + 1) % n) for i in range(n)], group)
    return [t.numpy() for t in shift + ring]


def _check_ids(c_local_of):
    """Wrap the slab module's sort and prepare (the blocks pass's first
    step) so that each call checks that the pass's ids are unique among
    the valid rows (those whose sort key is a cell) and that no halo row
    carries a local row's id (the kernel compares ids only without
    softening and otherwise relies on the self pair alone sharing one)."""
    inner = nbody_sharded.sort_and_prepare
    seen = {"calls": 0, "padded": 0}

    def checked(key, rows, cfg, c_max, ch, b, grid=None, dims=None):
        c_local = c_local_of()
        valid = (key < dims[0] * dims[1] * dims[2]).numpy()
        gid = rows.ids.numpy()
        assert len(np.unique(gid[valid])) == valid.sum(), "duplicate ids"
        local = set(gid[:c_local].tolist())
        halo = gid[c_local:][valid[c_local:]]
        assert not local.intersection(halo.tolist()), "halo id == local id"
        assert not valid[gid == -1].any(), "a padding row is valid"
        seen["calls"] += 1
        seen["padded"] += int((gid == -1).sum())
        return inner(key, rows, cfg, c_max, ch, b, grid=grid, dims=dims)

    nbody_sharded.sort_and_prepare = checked
    return seen, inner


def nbody_job(rank, group, cfg, spec, frames, full_state=False,
              check_ids=False):
    """Frames of the decomposed run, one ``run(1, batch=1)`` each: per
    frame the statistics and the gathered global state (whole, or the
    alive rows and tags); beside them, whether the driver ran its frames
    through frame graphs."""
    sim = None
    if check_ids:
        seen, inner = _check_ids(lambda: sim.cfg.slots // sim.mesh.size)
    try:
        sim = DistributedNBodySimulation(cfg, spec, group=group,
                                         device="cpu")
        out = []
        for _ in range(frames):
            stats = sim.run(1, batch=1)
            st = state_to_numpy(sim.gather())
            if not full_state:
                a = st["alive"]
                rows = np.concatenate([st["pos"], st["vel"],
                                       st["age"][:, None],
                                       st["life"][:, None]], axis=1)[a]
                st = dict(rows=rows, tags=st["tag"][a])
            out.append((stats, st))
    finally:
        if check_ids:
            nbody_sharded.sort_and_prepare = inner
    extra = dict(seen if check_ids else {}, graphed=sim.graphs is not None)
    return (out, extra) if rank == 0 else None


def one_rank_job(rank, group, cfg, kind, impl, frames, on):
    """On rank ``on`` alone, a decomposition of one rank with no group
    (every collective the identity) beside the port's single-device step
    from the same arrangement: per frame (stats, state) of each, numpy.
    ``kind`` "slab" drives ``make_sharded_step``, "brick" the driver."""
    if rank != on:
        return None
    init, dropped = nbody_sharded.distribute(
        nbody.init_fill(cfg, "cpu"), cfg, nbody_sharded.SlabSpec(1))
    if kind == "slab":
        step, shard = nbody_sharded.make_sharded_step(
            cfg, nbody_sharded.SlabSpec(1, impl=impl), meshmod.mesh_1d(1))
        ms = shard(init)
    else:
        sim = DistributedNBodySimulation(cfg, BrickSpec(1, 1, 1, impl=impl),
                                         device="cpu")
    ss, out = init, []
    for frame in range(frames):
        if kind == "slab":
            ms, stats = step(ms, frame)
            stats = {k: int(v) for k, v in stats.items()}
        else:
            stats, ms = sim.run(1), sim.state
        ss, sstats = nbody.step(ss, frame, cfg, impl)
        out.append((stats, state_to_numpy(ms),
                    {k: int(v) for k, v in vars(sstats).items()},
                    state_to_numpy(ss)))
    return dict(dropped=dropped, frames=out)


def checkpoint_job(rank, group, cfg, spec, jax_path, out_path):
    """Load a JAX-package checkpoint (another decomposition) and
    redistribute; save it in this spec; resume that save in a fresh driver
    (the same-spec path, each rank reading its own rows) and run two
    frames on both drivers."""
    sim = DistributedNBodySimulation(cfg, spec, group=group, device="cpu")
    dropped = sim.load(jax_path)
    loaded = state_to_numpy(sim.gather())
    frame = sim.frame
    sim.save(out_path)
    again = DistributedNBodySimulation(cfg, spec, group=group, device="cpu")
    assert again.load(out_path) == 0
    same = all(torch.equal(getattr(sim.state, f), getattr(again.state, f))
               for f in ("pos", "vel", "acc", "w", "age", "life", "alive",
                         "parent", "tag"))
    a, b = sim.run(2), again.run(2)
    resumed = same and a == b and all(
        torch.equal(getattr(sim.state, f), getattr(again.state, f))
        for f in ("pos", "vel", "alive", "tag"))
    if rank:
        return None
    return dict(dropped=dropped, frame=frame, loaded=loaded,
                resumed=resumed)


def emitter_job(rank, group, cfg, alloc, layout, frames, jax_npz, out_dir):
    """The data-parallel emitter engine: every rank's leaves after
    ``frames`` frames, the leaves it loads from the JAX engine's ``.npz``,
    and a sharded save of its state under ``out_dir``."""
    mesh = meshmod.mesh_1d(group.size(), "x", group)
    eng = ShardedEmitterEngine(cfg, mesh, alloc=alloc, layout=layout,
                               device="cpu")
    es = eng.step_many(eng.init(), frames)
    alive = eng.alive_count(es)
    leaves = engine_state_to_numpy(es)
    from_jax = engine_state_to_numpy(eng.load(jax_npz, eng.init()))
    eng.save(out_dir, es)
    resumed = engine_state_to_numpy(eng.load(out_dir, eng.init()))
    same = all(np.array_equal(x, y) for x, y in zip(leaves, resumed))
    return dict(leaves=leaves, from_jax=from_jax, alive=alive,
                resumed=same)


def emitter_steps_job(rank, group, cfg, alloc, layout, frames):
    """The sharded emitter's ``step_many(frames)`` beside ``frames`` calls
    of ``step()`` (another engine) and the eager frames ``_frame(s,
    index)`` of this rank: whether each is bit for bit the first, the
    engine's salt, and the leaves of ``step_many``."""
    mesh = meshmod.mesh_1d(group.size(), "x", group)

    def engine():
        return ShardedEmitterEngine(cfg, mesh, alloc=alloc, layout=layout,
                                    device="cpu")

    a, b = engine(), engine()
    many = engine_state_to_numpy(a.step_many(a.init(), frames))
    s = b.init()
    for _ in range(frames):
        s = b.step(s)
    one = engine_state_to_numpy(s)
    s = b.init()
    for _ in range(frames):
        s = b.local._frame(s, b.index)
    eager = engine_state_to_numpy(s)

    def same(x, y):
        return all(np.array_equal(p, q) for p, q in zip(x, y, strict=True))

    return dict(steps=same(many, one), eager=same(many, eager),
                salt=a.local.salt, leaves=many)


JOBS = dict(ppermute=ppermute_job, nbody=nbody_job, one_rank=one_rank_job,
            checkpoint=checkpoint_job, emitter=emitter_job,
            emitter_steps=emitter_steps_job)
