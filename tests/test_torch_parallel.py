"""The port's multi-device layer against the JAX package, on the CPU.

The port runs one process a rank over gloo process groups of 2 and 8
ranks, spawned once per world size for the whole file
(``tests/_torch_parallel_workers.py``, which imports no JAX); the JAX
references run here, on the 8 virtual CPU devices of tests/conftest.py,
with Pallas in interpret mode.  Rules, each with its source:

* the neighbor pass over extended sub-grids with global ids: ``prepare``
  exact, ``acc`` within 1e-5 of max(1, max|acc|) against the JAX kernel's
  direct sum (``fast_accum=False``; tests/test_neighbor_blocks.py:79);
* the slab over 8 ranks, dense and blocks, slot for slot against the JAX
  slab over 8 devices (``make_sharded_step``, dense): every statistic, the
  alive, parent and tag
  columns exact, floats by the chaotic-trajectory rule of
  tests/test_nbody_parity.py;
* slab, pencil and brick against the single-device JAX step on the same
  arrangement, inside the measured exact-parity windows (8 frames slab, 7
  pencil and brick; tests/test_sharded_nbody.py, test_pencil_nbody.py,
  test_brick_nbody.py): event counts and tag multisets exact, tag-aligned
  rows within 1e-3, no halo or migration drop;
* the sharded emitter against the JAX ``ShardedEmitterEngine`` on 2
  devices: bookkeeping and alive masks exact, fields within 1e-4
  (tests/test_torch_emitter.py); its ``step_many`` (the engine's frame
  loop) bit for bit ``step()`` and the eager frames on both ranks.
"""

import concurrent.futures
import dataclasses
import functools
import io
import os
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_workers as workers
import particlesystem_tpu.ops.neighbor_blocks as jnbk
import particlesystem_tpu.parallel.nbody_sharded as jslab
import particlesystem_tpu_torch.ops.neighbor_blocks as tnbk
import particlesystem_tpu_torch.parallel.nbody_sharded as tslab
from particlesystem_tpu import Emitter as JEmitter
from particlesystem_tpu import EmitterSceneConfig as JEmitterSceneConfig
from particlesystem_tpu import GridSpec, NBodyConfig
from particlesystem_tpu import PlaneCollider as JPlaneCollider
from particlesystem_tpu.core.state import ParticleState as JParticleState
from particlesystem_tpu.core.state import zero_state as jzero_state
from particlesystem_tpu.models import nbody as jnbody
from particlesystem_tpu.parallel import nbody_brick as jbrick
from particlesystem_tpu.parallel import nbody_pencil as jpencil
from particlesystem_tpu.parallel.driver import (
    DistributedNBodySimulation as JDistributed)
from particlesystem_tpu.parallel.emitter_sharded import (
    ShardedEmitterEngine as JShardedEmitter)
from particlesystem_tpu.parallel.mesh import mesh_1d as jmesh_1d
from particlesystem_tpu.runtime import checkpoint as jckpt
from particlesystem_tpu_torch import GridSpec as TGridSpec
from particlesystem_tpu_torch import NBodyConfig as TNBodyConfig
from particlesystem_tpu_torch.__main__ import main as cli_main
from particlesystem_tpu_torch.core import config as tconfig
from particlesystem_tpu_torch.core.state import FIELDS, state_to_numpy
from particlesystem_tpu_torch.models import nbody as tnbody
from particlesystem_tpu_torch.parallel import (BrickSpec, PencilSpec,
                                               SlabSpec, spawn)
from particlesystem_tpu_torch.parallel import nbody_brick as tbrick
from particlesystem_tpu_torch.parallel import nbody_pencil as tpencil
from particlesystem_tpu_torch.parallel.driver import (
    DistributedNBodySimulation)

torch.set_num_threads(1)

# tests/test_sharded_nbody.py:17-22
JCFG = NBodyConfig(
    n_fill=3000, capacity=8192,
    grid=GridSpec(grid_dim=16, cell_size=5.0, chunk_factor=4),
    particle_life=3.0, seed=11)
SLAB8_FRAMES = 4
SPAWN_TIMEOUT = 240.0


def port_cfg(cfg):
    d = dataclasses.asdict(cfg)
    return TNBodyConfig(**{**d, "grid": TGridSpec(**d["grid"])})


TCFG = port_cfg(JCFG)

# (world size, port spec, JAX spec, frames): the parity windows
RUNS = {
    # halo buffers of 700 rows (~200 used): the blocks pass pads its rows
    # to a multiple of 512 with id -1, which derived capacities never need
    "slab2": (2, SlabSpec(2, halo_capacity=700, impl="blocks"),
              jslab.SlabSpec(2), 8),
    "pencil42": (8, PencilSpec(4, 2, impl="blocks"),
                 jpencil.PencilSpec(4, 2), 7),
    "brick222": (8, BrickSpec(2, 2, 2, impl="dense"),
                 jbrick.BrickSpec(2, 2, 2), 7),
}
# the runs of one rank, each on a rank of its own of world 8 at the end of
# its jobs (no group: they run side by side): {run: (rank, job name)}
ONE_RANK_FRAMES = 6
ONE_RANK_JOBS = {run: (on, f"one_rank:{run}") for on, run in
                 enumerate(("slab-dense", "slab-blocks", "brick-blocks"), 1)}
EMITTER_RUNS = (("ring", "packed8"), ("select", "slim"))
EMITTER_FRAMES = 25
EMITTER_STEP_FRAMES = 12


def emitter_scene(m):
    """tests/test_parallel_extras.py's scene at two ranks of 2048 slots."""
    return m.EmitterSceneConfig(
        capacity=2 * 2048, dt=1 / 60, gravity=(0.0, -9.8, 0.0), drag=0.4,
        wind=(2.0, 0.0, 0.0),
        emitters=(m.Emitter(pos=(0, 1, 0), rate=80_000.0, speed=8.0,
                            life_min=0.5, life_max=1.5),),
        planes=(m.PlaneCollider(restitution=0.5, friction=0.2),), seed=9)


class _JaxConfigs:
    EmitterSceneConfig = JEmitterSceneConfig
    Emitter = JEmitter
    PlaneCollider = JPlaneCollider


def assert_close_chaotic(a, b, msg):
    """tests/test_nbody_parity.py:69-78."""
    err = np.abs(a - b)
    tol = 1e-3 + 1e-2 * np.abs(b)
    frac_bad = float(np.mean(err > tol))
    assert frac_bad <= 0.005, f"{msg}: {frac_bad:.2%} out of tolerance"
    assert float(err.max()) < 0.25, f"{msg}: max abs err {err.max()}"


def jax_numpy(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


def alive_rows(st: dict):
    a = st["alive"]
    rows = np.concatenate([st["pos"], st["vel"], st["age"][:, None],
                           st["life"][:, None]], axis=1)[a]
    return rows, st["tag"][a]


# --- the JAX references ---------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_slab8():
    """[(stats, global state)] of the JAX slab over 8 devices (the dense
    pass: the JAX blocks pass gives the same statistics and masks in these
    frames and differs only in float summation order, which the chaotic
    rule covers)."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()), ("x",))
    spec = jslab.SlabSpec(8, impl="dense")
    init, dropped = jslab.distribute(jnbody.init_fill(JCFG), JCFG, spec)
    assert dropped == 0
    step, shard = jslab.make_sharded_step(JCFG, spec, mesh)
    ms = shard(init)
    out = []
    for frame in range(SLAB8_FRAMES):
        ms, stats = step(ms, jnp.int32(frame))
        out.append(({k: int(v) for k, v in stats.items()}, jax_numpy(ms)))
    return out


@functools.lru_cache(maxsize=None)
def jax_single(name):
    """[(stats, state)] of the single-device JAX step from the
    arrangement ``RUNS[name]``'s decomposition gives the fill."""
    _, _, jspec, frames = RUNS[name]
    dist = {jslab.SlabSpec: jslab.distribute,
            jpencil.PencilSpec: jpencil.distribute,
            jbrick.BrickSpec: jbrick.distribute}[type(jspec)]
    state, _ = dist(jnbody.init_fill(JCFG), JCFG, jspec)
    out = []
    for frame in range(frames):
        state, stats = _jax_step(state, jnp.int32(frame))
        out.append((stats, jax_numpy(state)))
    return out


@functools.lru_cache(maxsize=None)
def _jax_step_fn():
    return jax.jit(lambda s, f: jnbody.step(s, f, JCFG, impl="dense"))


def _jax_step(state, frame):
    return _jax_step_fn()(state, frame)


@functools.lru_cache(maxsize=None)
def jax_emitter(alloc, layout):
    eng = JShardedEmitter(emitter_scene(_JaxConfigs), jmesh_1d(2),
                          alloc=alloc, layout=layout)
    es = eng.init()
    for _ in range(EMITTER_FRAMES):
        es = eng.step(es)
    return eng, es


# --- the spawned worlds ------------------------------------------------------


def world8_jobs():
    jobs = [("ppermute", {})]
    for impl in ("dense", "blocks"):
        jobs.append((f"nbody:slab8-{impl}", dict(
            cfg=TCFG, spec=SlabSpec(8, impl=impl), frames=SLAB8_FRAMES,
            full_state=True, check_ids=impl == "blocks")))
    for name, (ws, spec, _, frames) in RUNS.items():
        if ws == 8:
            jobs.append((f"nbody:{name}", dict(
                cfg=TCFG, spec=spec, frames=frames,
                check_ids=spec.impl == "blocks")))
    for key, (on, name) in ONE_RANK_JOBS.items():
        kind, impl = key.split("-")
        jobs.append((name, dict(
            cfg=TCFG, kind=kind, impl=impl, on=on,
            frames=ONE_RANK_FRAMES if kind == "slab" else 4)))
    return jobs


def write_jax_checkpoints(d):
    """A JAX-package sharded checkpoint of ``SlabSpec(8)`` at frame 4 (the
    JAX slab's state after 4 frames), and a JAX emitter ``.npz`` per run,
    under ``d``."""
    state = {f: jnp.asarray(a) for f, a in jax_slab8()[-1][1].items()}
    sim = JDistributed(JCFG, jslab.SlabSpec(8), state=JParticleState(**state))
    sim.frame = SLAB8_FRAMES
    sim.save(str(d / "jax_slab8"))
    for alloc, layout in EMITTER_RUNS:
        eng, es = jax_emitter(alloc, layout)
        eng.save(str(d / f"jax_emitter_{alloc}_{layout}.npz"), es)


def world2_jobs(d):
    jobs = [("ppermute", {})]
    _, spec, _, frames = RUNS["slab2"]
    jobs.append(("nbody:slab2", dict(cfg=TCFG, spec=spec, frames=frames,
                                     check_ids=spec.impl == "blocks")))
    jobs.append(("checkpoint", dict(
        cfg=TCFG, spec=PencilSpec(2, 1), jax_path=str(d / "jax_slab8"),
        out_path=str(d / "port_pencil21"))))
    for alloc, layout in EMITTER_RUNS:
        jobs.append((f"emitter:{alloc}-{layout}", dict(
            cfg=emitter_scene(tconfig), alloc=alloc, layout=layout,
            frames=EMITTER_FRAMES,
            jax_npz=str(d / f"jax_emitter_{alloc}_{layout}.npz"),
            out_dir=str(d / f"port_emitter_{alloc}_{layout}"))))
        jobs.append((f"emitter_steps:{alloc}-{layout}", dict(
            cfg=emitter_scene(tconfig), alloc=alloc, layout=layout,
            frames=EMITTER_STEP_FRAMES)))
    return jobs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(world 8's results, world 2's, the checkpoint directory).  Each
    world is one spawn, waited on in a thread while this process computes
    the JAX references: world 8 beside the JAX slab and emitters, whose
    checkpoints world 2 loads, and world 2 beside the single-device JAX
    runs."""
    d = tmp_path_factory.mktemp("ckpt")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        w8 = pool.submit(spawn, workers.world, 8, (world8_jobs(),),
                         timeout=SPAWN_TIMEOUT)
        write_jax_checkpoints(d)
        w2 = pool.submit(spawn, workers.world, 2, (world2_jobs(d),),
                         timeout=SPAWN_TIMEOUT)
        for name in RUNS:
            jax_single(name)
        return w8.result(), w2.result(), d


@pytest.fixture(scope="module")
def world8(worlds):
    return worlds[0]


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[1]


@pytest.fixture(scope="module")
def ckpt_dir(worlds):
    return worlds[2]


# --- the neighbor pass over extended sub-grids -------------------------------

# (split coordinate column: (base cell, cells)) of one rank; i3 = col 2,
# i1 = col 0, i2 = col 1
LAYOUTS = {
    "slab": {2: (4, 2)},                          # dims (16, 16, 4)
    "pencil": {2: (4, 4), 0: (8, 4)},             # dims (6, 16, 6)
    "brick": {2: (4, 4), 0: (8, 4), 1: (0, 4)},   # dims (6, 6, 6)
}
PLANES = NBodyConfig(n_fill=20_000, capacity=32768,
                     grid=GridSpec(grid_dim=16), seed=3)


@functools.lru_cache(maxsize=None)
def extended_inputs(layout):
    """A rank's halo-extended rows of a frame-2 state at grid 16: the rows
    within one cell of the rank's sub-grid, binned on the extended grid,
    with unique global ids far from slot order, padded to a multiple of B
    with invalid rows.  Returns numpy (pos, age, w, cell, alive, tags, ids)
    and dims."""
    cfg = port_cfg(PLANES)
    s = tnbody.init_fill(cfg, "cpu")
    for f in range(2):  # kids, dead slots and children in the state
        s, _ = tnbody.step(s, f, cfg, impl="dense")
    st = state_to_numpy(s)
    g = cfg.grid.grid_dim
    coords = tslab.wrap_positions(torch.from_numpy(st["pos"]),
                                  cfg.grid)[1].numpy()
    splits = LAYOUTS[layout]
    keep = st["alive"].copy()
    lp, ext = {}, {}
    for col in (0, 1, 2):
        c = coords[:, col]
        if col in splits:
            base, p = splits[col]
            keep &= (c >= base - 1) & (c <= base + p)
            lp[col], ext[col] = np.clip(c - (base - 1), 0, p + 1), p + 2
        else:
            lp[col], ext[col] = c, g
    cell = lp[2] * (ext[0] * ext[1]) + lp[0] * ext[1] + lp[1]
    idx = np.flatnonzero(keep)
    n = -(-len(idx) // tnbk.B) * tnbk.B
    rng = np.random.default_rng(5)
    ids = (rng.integers(1 << 20, 1 << 29)
           + 7 * rng.permutation(n)).astype(np.int32)
    out = [np.zeros((n, 3), np.float32), np.zeros(n, np.float32),
           np.zeros(n, np.float32), np.zeros(n, np.int32),
           np.zeros(n, bool), np.zeros(n, np.uint32), ids]
    for o, a in zip(out, (st["pos"], st["age"], st["w"], cell, keep,
                          st["tag"])):
        o[:len(idx)] = a[idx]
    return out, (ext[0], ext[1], ext[2])


@functools.lru_cache(maxsize=None)
def jax_extended(layout):
    """(JAX ``prepare``, JAX ``neighbor_pass_blocks``) on
    ``extended_inputs(layout)``, numpy, under one compile."""
    (pos, age, w, cell, alive, tags, ids), dims = extended_inputs(layout)

    def both(*args, tags, ids):
        return (jnbk.prepare(*args, cfg=PLANES, dims=dims, ids=ids,
                             tags=tags),
                jnbk.neighbor_pass_blocks(*args, cfg=PLANES, dims=dims,
                                          acc_mxu=False, ids=ids, tags=tags))

    out = jax.jit(both)(*(jnp.asarray(a) for a in (pos, age, w, cell,
                                                    alive)),
                        tags=jnp.asarray(tags), ids=jnp.asarray(ids))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_prepare_with_dims_and_ids_matches_jax(layout):
    (pos, age, w, cell, alive, tags, ids), dims = extended_inputs(layout)
    assert alive.sum() > 500
    snap, chunks, order, ovf, max_occ, counts, dropped = \
        jax_extended(layout)[0]
    t = tnbk.prepare(torch.from_numpy(pos), torch.from_numpy(age),
                     torch.from_numpy(w), torch.from_numpy(cell),
                     torch.from_numpy(alive), port_cfg(PLANES),
                     torch.from_numpy(tags.astype(np.int64)), dims=dims,
                     ids=torch.from_numpy(ids))
    t_snap, t_chunks, t_order, t_ovf, t_occ, t_counts, t_dropped = t
    n = order.shape[0]
    snap = np.asarray(snap)[:, :n]
    np.testing.assert_array_equal(np.asarray(order), t_order.numpy())
    np.testing.assert_array_equal(
        snap[[0, 1, 2, 4, 5, 6, 10]].view(np.uint32),
        t_snap.f.numpy().view(np.uint32))
    np.testing.assert_array_equal(snap[[8, 14]].view(np.int32),
                                  t_snap.i.numpy())
    np.testing.assert_array_equal(np.asarray(chunks), t_chunks.numpy())
    np.testing.assert_array_equal(np.asarray(ovf), t_ovf.numpy())
    np.testing.assert_array_equal(np.asarray(counts), t_counts.numpy())
    assert counts.shape[0] == dims[0] * dims[1] * dims[2] + 1
    assert int(max_occ) == int(t_occ) and int(dropped) == int(t_dropped) == 0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_neighbor_pass_blocks_with_dims_and_ids_matches_jax(layout):
    (pos, age, w, cell, alive, tags, ids), dims = extended_inputs(layout)
    jout = jax_extended(layout)[1]
    tout = tnbk.neighbor_pass_blocks(
        torch.from_numpy(pos), torch.from_numpy(age), torch.from_numpy(w),
        torch.from_numpy(cell), torch.from_numpy(alive), port_cfg(PLANES),
        torch.from_numpy(tags.astype(np.int64)), dims=dims,
        ids=torch.from_numpy(ids))
    for k, a, b in zip(("kill", "touch", "overflow", "max_occ", "counts",
                        "dropped"), jout[1:], tout[1:]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=k)
    ref = np.asarray(jout[0])
    err = np.abs(tout[0].numpy() - ref).max() / max(1.0, np.abs(ref).max())
    assert err < 1e-5
    assert tout[1].any() and tout[2].any()


def test_cubic_path_unchanged():
    """The defaults are the cubic grid with slot ids, bit for bit."""
    (pos, age, w, cell, alive, tags, _), _ = extended_inputs("slab")
    cfg = port_cfg(PLANES)
    g = cfg.grid.grid_dim
    cube = np.minimum(cell, g ** 3 - 1)
    args = [torch.from_numpy(a) for a in (pos, age, w, cube, alive)]
    args += [cfg, torch.from_numpy(tags.astype(np.int64))]
    a = tnbk.neighbor_pass_blocks(*args)
    b = tnbk.neighbor_pass_blocks(*args, dims=(g, g, g),
                                  ids=torch.arange(len(pos),
                                                   dtype=torch.int32))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    sa = tnbk.prepare(*args)
    assert torch.equal(sa[0].i[0], sa[2].to(torch.int32))


def test_pack_rows_matches_jax():
    rng = np.random.default_rng(3)
    n = 1000
    mask = rng.random(n) < 0.3
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    gid = rng.integers(0, 1 << 30, n).astype(np.int32)
    tag = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    flag = rng.random(n) < 0.5
    for cap in (64, 400):
        j = jslab._pack_rows(jnp.asarray(mask), cap, jnp.asarray(pos),
                             jnp.asarray(gid), jnp.asarray(tag),
                             jnp.asarray(flag))
        t = tslab._pack_rows(torch.from_numpy(mask), cap,
                             torch.from_numpy(pos), torch.from_numpy(gid),
                             torch.from_numpy(tag.astype(np.int64)),
                             torch.from_numpy(flag))
        for k, (a, b) in enumerate(zip(j, t)):
            b = b.numpy()
            if k == 2:
                b = b.astype(np.uint32)
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(k))


# --- decompositions on the host ----------------------------------------------


@pytest.mark.parametrize("name", ["slab8", "pencil42", "brick222"])
def test_distribute_matches_jax(name):
    jspec, tspec, jmod, tmod = {
        "slab8": (jslab.SlabSpec(8), SlabSpec(8), jslab, tslab),
        "pencil42": (jpencil.PencilSpec(4, 2), PencilSpec(4, 2), jpencil,
                     tpencil),
        "brick222": (jbrick.BrickSpec(2, 2, 2), BrickSpec(2, 2, 2), jbrick,
                     tbrick)}[name]
    assert dataclasses.asdict(jspec.derive(JCFG)) == dataclasses.asdict(
        tspec.derive(TCFG))
    jstate, jdrop = jmod.distribute(jnbody.init_fill(JCFG), JCFG, jspec)
    tstate, tdrop = tmod.distribute(tnbody.init_fill(TCFG, "cpu"), TCFG,
                                    tspec)
    assert jdrop == tdrop == 0
    want, got = jax_numpy(jstate), state_to_numpy(tstate)
    for f in FIELDS:
        np.testing.assert_array_equal(want[f], got[f], err_msg=f)
    pos = want["pos"]
    np.testing.assert_array_equal(jmod.dest_np(pos, JCFG, jspec),
                                  tmod.dest_np(pos, TCFG, tspec))


@pytest.mark.parametrize("impl", ["dense", "blocks"])
def test_one_rank_slab_is_the_single_device_step(impl, world8):
    """D = 1 statically skips the halo and the migration ring (the ring
    would be the identity and duplicate every particle): the slab is then
    the single-device step bit for bit."""
    on, name = ONE_RANK_JOBS[f"slab-{impl}"]
    r = world8[on][name]
    assert r["dropped"] == 0 and len(r["frames"]) == ONE_RANK_FRAMES
    for frame, (stats, st, sstats, sst) in enumerate(r["frames"]):
        for f in FIELDS:
            assert np.array_equal(st[f], sst[f]), (frame, f)
        assert stats["migration_dropped"] == stats["halo_dropped"] == 0
        assert stats["migration_used_max"] == 0
        for k in ("n_alive", "n_age_deaths", "n_collision_kills",
                  "n_survivals", "n_spawned", "n_overflow_kills"):
            assert stats[k] == sstats[k], (frame, k)
        assert stats["n_alive"] <= TCFG.n_fill + 400


def test_one_rank_brick_does_not_duplicate(world8):
    """A brick of one rank extends every axis by an empty halo layer and
    migrates nothing: the single-device step's particles, no copies."""
    on, name = ONE_RANK_JOBS["brick-blocks"]
    r = world8[on][name]
    assert r["dropped"] == 0 and len(r["frames"]) == 4
    for frame, (stats, st, sstats, sst) in enumerate(r["frames"]):
        for k in ("n_alive", "n_collision_kills", "n_spawned"):
            assert stats[k] == sstats[k], (frame, k)
        got = alive_rows(st)
        want = alive_rows(sst)
        assert len(np.unique(got[1])) == len(got[1])
        np.testing.assert_array_equal(np.sort(got[1]), np.sort(want[1]))
        d = got[0][np.argsort(got[1])] - want[0][np.argsort(want[1])]
        assert np.abs(d).max() < 1e-4, frame


# --- the multi-rank runs -----------------------------------------------------


@pytest.mark.parametrize("ws", [2, 8])
def test_ppermute_fills_zeros_where_no_one_sends(ws, world2, world8):
    res = (world2 if ws == 2 else world8)
    for rank, r in enumerate(res):
        shift_x, shift_b, ring_x, ring_b = r["ppermute"]
        if rank == 0:
            assert not shift_x.any() and not shift_b.any()
        else:
            assert (shift_x == rank).all()
            np.testing.assert_array_equal(shift_b, [True, (rank - 1) % 2 == 0])
        src = (rank - 1) % ws
        assert (ring_x == src + 1).all()
        np.testing.assert_array_equal(ring_b, [True, src % 2 == 0])


@pytest.mark.parametrize("impl", ["dense", "blocks"])
def test_slab8_slot_for_slot_against_jax(impl, world8):
    frames, extra = world8[0][f"nbody:slab8-{impl}"]
    ref = jax_slab8()
    for frame, ((stats, st), (jstats, jst)) in enumerate(zip(frames, ref)):
        assert stats == jstats, frame
        for f in ("alive", "parent", "tag"):
            np.testing.assert_array_equal(st[f], jst[f],
                                          err_msg=f"frame {frame} {f}")
        for f in ("pos", "vel", "acc", "w", "age", "life"):
            assert_close_chaotic(st[f], jst[f], f"frame {frame} {f}")
    assert sum(s["migration_used_max"] for s, _ in frames) > 0
    if impl == "blocks":
        assert extra["calls"] == SLAB8_FRAMES  # rank 0 checked every pass


@pytest.mark.parametrize("name", sorted(RUNS))
def test_decomposition_matches_single_device_jax(name, world2, world8):
    ws, spec, _, nframes = RUNS[name]
    frames, extra = (world2 if ws == 2 else world8)[0][f"nbody:{name}"]
    ref = jax_single(name)
    assert len(frames) == nframes
    kills = spawns = migrated = 0
    for frame, ((stats, st), (jstats, jst)) in enumerate(zip(frames, ref)):
        assert stats["halo_dropped"] == stats["migration_dropped"] == 0
        for k in ("n_alive", "n_age_deaths", "n_collision_kills",
                  "n_survivals", "n_spawned", "n_overflow_kills"):
            assert stats[k] == int(getattr(jstats, k)), (frame, k)
        b, tb = alive_rows(jst)
        assert len(np.unique(st["tags"])) == len(st["tags"])
        np.testing.assert_array_equal(np.sort(st["tags"]), np.sort(tb),
                                      err_msg=f"frame {frame} tag multiset")
        d = np.abs(st["rows"][np.argsort(st["tags"])] - b[np.argsort(tb)])
        assert d.max() < 1e-3, f"frame {frame}: {d.max()}"
        kills += stats["n_collision_kills"]
        spawns += stats["n_spawned"]
        migrated += stats["migration_used_max"]
    assert kills > 10 and spawns > 10 and migrated > 0
    if spec.impl == "blocks":
        assert extra["calls"] == nframes
    if name == "slab2":  # its 700-row halo buffers leave a block short
        assert extra["padded"] > 0


def test_gloo_ranks_run_eagerly(world2, world8):
    """Gloo stages its collectives through host memory, which a CUDA
    graph cannot hold: the driver over gloo ranks takes no frame graphs."""
    runs = [world8[0][f"nbody:slab8-{impl}"] for impl in ("dense", "blocks")]
    runs += [(world2 if ws == 2 else world8)[0][f"nbody:{name}"]
             for name, (ws, *_) in RUNS.items()]
    assert all(extra["graphed"] is False for _, extra in runs)


# --- sharded checkpoints both ways -------------------------------------------


def test_jax_slab8_checkpoint_loads_as_port_pencil(world2):
    r = world2[0]["checkpoint"]
    assert r["dropped"] == 0 and r["frame"] == SLAB8_FRAMES
    want = alive_rows(jax_slab8()[-1][1])
    got = alive_rows(r["loaded"])
    np.testing.assert_array_equal(np.sort(got[1]), np.sort(want[1]))
    np.testing.assert_array_equal(got[0][np.argsort(got[1])],
                                  want[0][np.argsort(want[1])])
    assert r["resumed"], "same-spec resume not bit-identical"


def test_port_pencil_checkpoint_loads_in_jax(world2, ckpt_dir):
    r = world2[0]["checkpoint"]
    treedef = jax.tree.structure(jzero_state(8))
    host, meta = jckpt.load_sharded_host(str(ckpt_dir / "port_pencil21"),
                                         treedef, expect_config=JCFG)
    assert meta["frame"] == SLAB8_FRAMES and meta["spec_type"] == "PencilSpec"
    got = jax_numpy(host)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], r["loaded"][f], err_msg=f)
    # and the JAX driver of that spec takes it on its same-spec path
    sim = JDistributed(JCFG, jpencil.PencilSpec(2, 1))
    assert sim.load(str(ckpt_dir / "port_pencil21")) == 0
    assert int(np.asarray(sim.gather().alive).sum()) == int(
        r["loaded"]["alive"].sum())


# --- the data-parallel emitter -----------------------------------------------


def _emitter_alive(layout, fields, frame):
    if layout == "slim":
        return frame < fields[6]
    return (fields[6] <= fields[7]) & (fields[7] > 0)


@pytest.mark.parametrize("alloc,layout", EMITTER_RUNS)
def test_sharded_emitter_matches_jax(alloc, layout, world2, ckpt_dir):
    eng, es = jax_emitter(alloc, layout)
    jl = [np.asarray(a) for a in jax.tree_util.tree_leaves(es)]
    nf = eng.local.n_fields
    total = 0
    for rank in range(2):
        r = world2[rank][f"emitter:{alloc}-{layout}"]
        tl = r["leaves"]
        blk = tl[0].shape[0]
        mine = [a[rank * blk:(rank + 1) * blk] for a in jl[:nf]] + [
            a[rank] for a in jl[nf:]]
        for name, a, b in zip(("accum", "free_list", "cursor", "n_free",
                               "frame"), tl[nf:], mine[nf:]):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {rank} {name}")
        flat = lambda fs: [f.reshape(-1) for f in fs]
        a_t = _emitter_alive(layout, flat(tl[:nf]), int(tl[-1]))
        a_j = _emitter_alive(layout, flat(mine[:nf]), int(mine[-1]))
        np.testing.assert_array_equal(a_t, a_j, err_msg=f"rank {rank} alive")
        total += int(a_t.sum())
        for i, (a, b) in enumerate(zip(tl[:nf], mine[:nf])):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                       err_msg=f"rank {rank} field {i}")
        # the JAX engine's .npz, loaded by this rank
        for a, b in zip(r["from_jax"], mine):
            np.testing.assert_array_equal(a, b)
        assert r["resumed"]
    assert world2[0][f"emitter:{alloc}-{layout}"]["alive"] == total
    assert total == eng.alive_count(es) > 100
    # the port's sharded directory, read by the JAX package
    leaves, _ = jckpt.load_sharded_host(
        str(ckpt_dir / f"port_emitter_{alloc}_{layout}"))
    for k, a in enumerate(leaves):
        parts = [world2[r][f"emitter:{alloc}-{layout}"]["leaves"][k]
                 for r in range(2)]
        want = (np.concatenate(parts) if k < nf else np.stack(parts))
        np.testing.assert_array_equal(a, want)


# --- the CLI -----------------------------------------------------------------


def test_cli_nbody_slab_one_device_on_cpu(tmp_path):
    out = io.StringIO()
    path = os.path.join(tmp_path, "ck")
    with contextlib.redirect_stdout(out):
        cli_main(["nbody", "--particles", "3000", "--grid-dim", "16",
                  "--iterations", "2", "--decomp", "slab", "--devices", "1",
                  "--device", "cpu", "--save", path])
    text = out.getvalue()
    assert "iter 2: alive=" in text and "final: alive=" in text, text
    sim = DistributedNBodySimulation(
        TNBodyConfig(n_fill=3000, grid=TGridSpec(grid_dim=16)),
        SlabSpec(1, impl="blocks"), device="cpu")
    assert sim.load(path) == 0 and sim.frame == 2


@pytest.mark.parametrize("alloc,layout", EMITTER_RUNS)
def test_sharded_emitter_step_many_is_step(alloc, layout, world2):
    """``step_many(k)`` (the engine's frame loop, graph replays on a card)
    is bit for bit ``k`` calls of ``step()`` and the eager frames salted
    with the rank's index, on both ranks; the salts differ, and so do the
    ranks' streams."""
    rs = [world2[rank][f"emitter_steps:{alloc}-{layout}"]
          for rank in range(2)]
    for rank, r in enumerate(rs):
        assert r["salt"] == rank
        assert r["steps"] and r["eager"], (rank, r["steps"], r["eager"])
    assert not all(np.array_equal(a, b) for a, b in
                   zip(rs[0]["leaves"], rs[1]["leaves"]))
