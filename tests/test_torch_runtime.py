"""The port's runtime against the JAX package, on the CPU: the numpy
oracles, checkpoints, validate, profile_frame and the readback ring.

* ``cpu_ref``: the port's copies run the same numpy code, so their results
  equal the JAX package's exactly on the same inputs (the native emitter
  step within ``rtol=1e-5, atol=1e-6``: the port builds the library without
  FMA contraction, the JAX package loads a prebuilt one).
* checkpoints cross between the packages in both directions: the file's
  leaves are compared exactly (values and dtypes), and the run that resumes
  from it follows the rule of tests/test_nbody_parity.py (events and masks
  exact, floats by ``assert_close_chaotic``) for the n-body state, and the
  emitter trajectory rule (``rtol = atol = 1e-4``, bookkeeping and alive
  masks exact) for the engine state.
* ``FrameRing`` / ``AsyncReadback`` keep order, drop when full and flush,
  with the native ring and with the deque.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import particlesystem_tpu.core.config as jconfig
import particlesystem_tpu_torch.core.config as tconfig
from particlesystem_tpu import GridSpec, NBodyConfig
from particlesystem_tpu.cpu_ref import native_emitter as jnative_emitter
from particlesystem_tpu.cpu_ref import oracle_emitter as joracle_emitter
from particlesystem_tpu.cpu_ref import oracle_nbody as joracle_nbody
from particlesystem_tpu.models import nbody as jnbody
from particlesystem_tpu.runtime import checkpoint as jcheckpoint
from particlesystem_tpu.runtime.engine import PackedEngine as JEngine
from particlesystem_tpu_torch.__main__ import main as cli_main
from particlesystem_tpu_torch.api import NBodySimulation, ParticleSystem
from particlesystem_tpu_torch.core.state import (FIELDS, state_from_numpy,
                                                 state_to_numpy)
from particlesystem_tpu_torch.cpu_ref import native_emitter, oracle_emitter
from particlesystem_tpu_torch.cpu_ref import oracle_nbody
from particlesystem_tpu_torch.models import nbody as tnbody
from particlesystem_tpu_torch.parallel import (DistributedNBodySimulation,
                                               SlabSpec)
from particlesystem_tpu_torch.runtime import checkpoint
from particlesystem_tpu_torch.runtime.engine import (
    PackedEngine as TEngine, engine_state_to_numpy)
from particlesystem_tpu_torch.runtime.readback import AsyncReadback, FrameRing
from particlesystem_tpu_torch.utils import native

torch.set_num_threads(1)

# tests/test_nbody_parity.py:27-31
LIFECYCLE = NBodyConfig(
    n_fill=500, capacity=2048, grid=GridSpec(grid_dim=8, cell_size=5.0,
                                             chunk_factor=2),
    particle_life=2.0, seed=5,
)
# tests/test_nbody_parity.py:22-26
DENSE = NBodyConfig(
    n_fill=2000, capacity=4096, grid=GridSpec(grid_dim=4, cell_size=5.0,
                                              chunk_factor=2),
    max_per_cell=48, seed=3,
)
EVENTS = ("n_collision_kills", "n_age_deaths", "n_survivals", "n_spawned",
          "n_overflow_kills")
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_pallas_step.py:94


def port_cfg(cfg):
    """The port's copy of a JAX-package n-body config (same fields)."""
    d = dataclasses.asdict(cfg)
    return tconfig.NBodyConfig(**{**d, "grid": tconfig.GridSpec(**d["grid"])})


def scene(m, capacity=2048):
    """tests/test_slim_engine.py's scene: two emitters, a plane, a sphere."""
    return m.EmitterSceneConfig(
        capacity=capacity, dt=1 / 60, gravity=(0.0, -9.8, 0.0), drag=0.4,
        wind=(2.0, 0.0, -0.5),
        emitters=(
            m.Emitter(pos=(0.0, 1.0, 0.0), direction=(0.0, 1.0, 0.0),
                      speed=8.0, rate=4000.0, life_min=0.4, life_max=1.2),
            m.Emitter(pos=(2.0, 0.5, 0.0), direction=(-0.3, 1.0, 0.2),
                      speed=5.0, rate=2500.0, cone_angle=0.6)),
        planes=(m.PlaneCollider(point=(0, 0, 0), normal=(0, 1, 0),
                                restitution=0.6, friction=0.3),),
        spheres=(m.SphereCollider(center=(0.5, 2.0, 0.0), radius=0.7,
                                  restitution=0.4, friction=0.1),),
        seed=11)


def assert_close_chaotic(a, b, msg):
    """tests/test_nbody_parity.py:69-78."""
    err = np.abs(a - b)
    tol = 1e-3 + 1e-2 * np.abs(b)
    frac_bad = float(np.mean(err > tol))
    assert frac_bad <= 0.005, f"{msg}: {frac_bad:.2%} elements out of tolerance"
    assert float(err.max()) < 0.25, f"{msg}: max abs err {err.max()}"


def jax_leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def file_leaves(path):
    with np.load(path) as data:
        n = len([k for k in data.files if k.startswith("leaf_")])
        return ([data[f"leaf_{i}"] for i in range(n)],
                json.loads(bytes(data["__meta__"]).decode()))


# --- 1. the numpy oracles -----------------------------------------------------

def test_oracle_nbody_copy_equals_jax_packages():
    """20 frames of LIFECYCLE through both copies of ``oracle_nbody.step``
    on the same fields: every array and stat equal."""
    cfg, tcfg = LIFECYCLE, port_cfg(LIFECYCLE)
    ts = tnbody.init_fill(tcfg, "cpu")
    a = oracle_emitter.NpState.from_torch(ts)
    b = joracle_emitter.NpState(**state_to_numpy(ts))
    assert a.tag.dtype == np.uint32 and a.alive.dtype == np.bool_
    spawned = 0
    for frame in range(20):
        uvec, fert = tnbody.frame_fields(tcfg, frame, torch.tensor(
            a.tag.astype(np.int64)))
        a, sa = oracle_nbody.step(a, uvec.numpy(), fert.numpy(), frame, tcfg)
        b, sb = joracle_nbody.step(b, uvec.numpy(), fert.numpy(), frame, cfg)
        assert sa == sb, f"frame {frame}"
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"frame {frame} {f}")
        spawned += sa["n_spawned"]
    assert spawned > 0
    tags = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    np.testing.assert_array_equal(oracle_nbody.okey_np(tags),
                                  joracle_nbody.okey_np(tags))


def _emitter_inputs(n=1024, seed=3):
    rng = np.random.default_rng(seed)
    life = rng.uniform(0.5, 2.0, n).astype(np.float32)
    life[rng.uniform(size=n) < 0.3] = 0.0
    fields = dict(
        pos=rng.uniform(-3.0, 5.0, (n, 3)).astype(np.float32),
        vel=rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32),
        acc=np.zeros((n, 3), np.float32), w=np.ones(n, np.float32),
        age=(life * np.float32(0.4)).astype(np.float32), life=life,
        alive=life > 0, parent=np.zeros(n, bool), tag=np.zeros(n, np.uint32))
    spawn = (rng.uniform(-1, 1, (64, 3)).astype(np.float32),
             rng.uniform(-2, 2, (64, 3)).astype(np.float32),
             np.full((64,), 1.5, np.float32), np.ones((64,), np.float32),
             np.arange(64) < 20)
    return fields, spawn


def test_oracle_emitter_copies_equal_jax_packages():
    fields, spawn = _emitter_inputs()
    a = oracle_emitter.NpState(**fields)
    b = joracle_emitter.NpState(**fields)
    c = oracle_emitter.NpState(**fields)
    d = joracle_emitter.NpState(**fields)
    assert native.has_native()
    for frame in range(10):
        a = oracle_emitter.step(a, *spawn, scene(tconfig))
        b = joracle_emitter.step(b, *spawn, scene(jconfig))
        c = native_emitter.step(c, *spawn, scene(tconfig))
        d = jnative_emitter.step(d, *spawn, scene(jconfig))
        np.testing.assert_array_equal(a.alive, c.alive, f"frame {frame}")
        np.testing.assert_array_equal(c.alive, d.alive, f"frame {frame}")
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"frame {frame} {f}")
        for f in ("pos", "vel", "age", "life", "acc"):
            # tests/test_parallel_extras.py:205-208
            for x in (a, d):
                np.testing.assert_allclose(
                    getattr(c, f), getattr(x, f), rtol=1e-5, atol=1e-6,
                    err_msg=f"frame {frame} {f}")
    assert 0 < int(a.alive.sum()) < len(a.alive)


def test_oracle_step_slim_copy_equals_jax_packages():
    fields, spawn = _emitter_inputs(seed=4)
    pos, vel = fields["pos"], fields["vel"]
    death = np.floor(fields["life"] * 60.0).astype(np.float32)
    a = b = (pos, vel, death, 1000)
    for frame in range(8):
        a = oracle_emitter.step_slim(*a, frame, spawn[0], spawn[1], spawn[2],
                                     spawn[4], scene(tconfig))
        b = joracle_emitter.step_slim(*b, frame, spawn[0], spawn[1],
                                      spawn[2], spawn[4], scene(jconfig))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, f"frame {frame}")
    assert a[3] == (1000 + 8 * 20) % 1024


# --- 2. checkpoints: ParticleState -------------------------------------------

def test_fingerprints_agree_between_packages():
    for jc, tc in ((LIFECYCLE, port_cfg(LIFECYCLE)),
                   (NBodyConfig(), tconfig.NBodyConfig()),
                   (scene(jconfig), scene(tconfig))):
        want = jcheckpoint.config_fingerprint(jc)
        assert checkpoint.config_fingerprint(tc) == want
        assert json.loads(json.dumps(want)) == want


def _jax_frames(js, cfg, frames):
    stats = None
    for f in frames:
        js, stats = jnbody.step(js, jnp.int32(f), cfg, 0, "blocks")
    return js, stats


def check_against_jax(sim, js, jst, msg):
    for k in EVENTS + ("n_alive", "max_cell_occupancy"):
        assert int(getattr(sim.last_stats, k)) == int(getattr(jst, k)), \
            f"{msg}: {k}"
    port = state_to_numpy(sim.state)
    for f in ("alive", "parent", "tag"):
        np.testing.assert_array_equal(port[f], np.asarray(getattr(js, f)),
                                      err_msg=f"{msg} {f}")
    for f in ("pos", "vel", "age", "life", "w"):
        assert_close_chaotic(port[f], np.asarray(getattr(js, f)),
                             f"{msg} {f}")


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX writes the LIFECYCLE state at frame 6; the port loads it and
    runs 6 more frames, as JAX does."""
    cfg, tcfg = LIFECYCLE, port_cfg(LIFECYCLE)
    path = str(tmp_path / "jax.npz")
    js, _ = _jax_frames(jnbody.init_fill(cfg), cfg, range(6))
    jcheckpoint.save(path, js, meta=dict(
        frame=6, **jcheckpoint.config_fingerprint(cfg)))
    sim = NBodySimulation(tcfg, device="cpu", active_bucketing=False)
    sim._active = 1024
    sim.load(path)
    assert sim.frame == 6 and sim._active == 0
    port = state_to_numpy(sim.state)
    for f, want in zip(FIELDS, jax_leaves(js)):
        assert port[f].dtype == want.dtype, f
        np.testing.assert_array_equal(port[f], want, err_msg=f)
    sim.run(6, batch=1)
    js, jst = _jax_frames(js, cfg, range(6, 12))
    assert sim.frame == 12
    check_against_jax(sim, js, jst, "resumed in the port")
    assert int(jst.n_alive) > cfg.n_fill     # spawns happened on the way


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """The port writes at frame 6; ``particlesystem_tpu``'s ``load`` reads
    it under its own template and config check, and runs on."""
    cfg, tcfg = LIFECYCLE, port_cfg(LIFECYCLE)
    path = str(tmp_path / "port.npz")
    sim = NBodySimulation(tcfg, device="cpu", active_bucketing=False)
    sim.run(6, batch=1)
    sim.save(path)
    leaves, meta = file_leaves(path)
    assert [a.dtype for a in leaves] == [a.dtype for a in jax_leaves(
        jnbody.init_fill(cfg))]
    assert meta["frame"] == 6
    js, jmeta = jcheckpoint.load(path, jnbody.init_fill(cfg),
                                 expect_config=cfg)
    assert jmeta == meta
    for f, got in zip(FIELDS, jax_leaves(js)):
        np.testing.assert_array_equal(got, state_to_numpy(sim.state)[f], f)
    js, jst = _jax_frames(js, cfg, range(6, 12))
    sim.run(6, batch=1)
    check_against_jax(sim, js, jst, "resumed in jax")


def test_tags_cross_the_file_as_uint32(tmp_path):
    """Tags live in int64 tensors; the file holds uint32, also past 2^31."""
    tcfg = port_cfg(LIFECYCLE)
    st = tnbody.init_fill(tcfg, "cpu")
    st.tag[:4] = torch.tensor([0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF])
    path = str(tmp_path / "tags.npz")
    checkpoint.save(path, st, meta={"frame": 3})
    leaves, meta = file_leaves(path)
    assert meta == {"frame": 3}
    assert leaves[8].dtype == np.uint32 and leaves[6].dtype == np.bool_
    assert leaves[8][:4].tolist() == [0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    back, _ = checkpoint.load(path, tnbody.init_fill(tcfg, "cpu"))
    assert back.tag.dtype == torch.int64
    for f in FIELDS:
        assert torch.equal(getattr(back, f), getattr(st, f)), f


def test_mismatched_config_is_rejected(tmp_path):
    cfg, tcfg = LIFECYCLE, port_cfg(LIFECYCLE)
    path = str(tmp_path / "c.npz")
    jcheckpoint.save(path, jnbody.init_fill(cfg), meta=dict(
        frame=0, **jcheckpoint.config_fingerprint(cfg)))
    other = dataclasses.replace(tcfg, dt=tcfg.dt * 2)
    with pytest.raises(ValueError, match="config mismatch.*dt"):
        NBodySimulation(other, device="cpu").load(path)
    # a fingerprint that agrees but a template of another size
    small = dataclasses.replace(tcfg, capacity=1024)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load(path, tnbody.init_fill(small, "cpu"))
    with pytest.raises(ValueError, match="config mismatch"):
        checkpoint.load(path, tnbody.init_fill(small, "cpu"),
                        expect_config=small)
    with pytest.raises(TypeError, match="cannot checkpoint"):
        checkpoint.save(path, {"x": torch.zeros(3)})
    # the same rejection as the JAX package's
    with pytest.raises(ValueError, match="config mismatch"):
        jcheckpoint.load(path, jnbody.init_fill(cfg),
                         expect_config=dataclasses.replace(cfg, dt=cfg.dt * 2))


def test_saved_run_continues_bit_identically(tmp_path):
    """save, load into a fresh simulation, run both on: same bits, with
    the active prefix re-bucketed after the load."""
    tcfg = port_cfg(LIFECYCLE)
    path = str(tmp_path / "run.npz")
    a = NBodySimulation(tcfg, device="cpu")
    a.ACTIVE_QUANTUM = 1024
    a.run(4)
    a.save(path)
    b = NBodySimulation(tcfg, device="cpu")
    b.ACTIVE_QUANTUM = 1024
    b.load(path)
    a.run(4)
    b.run(4)
    assert a.frame == b.frame == 8
    for k, v in vars(a.last_stats).items():
        assert int(v) == int(getattr(b.last_stats, k)), k
    x = state_to_numpy(tnbody.compact_state(a.state))
    y = state_to_numpy(tnbody.compact_state(b.state))
    for f in FIELDS:
        np.testing.assert_array_equal(x[f], y[f], f)


# --- 3. checkpoints: EngineState ---------------------------------------------

def _alive(eng, fields, frame):
    if eng.layout == "slim":
        return frame < fields[6]
    return (fields[6] <= fields[7]) & (fields[7] > 0)


def assert_engines_agree(jeng, jes, teng, tes, what):
    """Bookkeeping and alive masks exact, fields by the trajectory rule."""
    jl, tl = jax_leaves(jes), engine_state_to_numpy(tes)
    nf = teng.n_fields
    for name, a, b in zip(("accum", "free_list", "cursor", "n_free",
                           "frame"), tl[nf:], jl[nf:]):
        assert a.dtype == b.dtype, f"{what} {name}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")
    jflat = [np.asarray(f) for f in jeng.flat_fields(jes)]
    tflat = [f.numpy() for f in teng.flat_fields(tes)]
    np.testing.assert_array_equal(_alive(teng, tflat, tes.frame),
                                  _alive(jeng, jflat, int(jes.frame)),
                                  err_msg=f"{what} alive")
    for i, (a, b) in enumerate(zip(tl[:nf], jl[:nf])):
        np.testing.assert_allclose(a, b, **TRAJ_TOL,
                                   err_msg=f"{what} field {i}")


ENGINE_CASES = [("select", "packed8", 1), ("ring", "slim", 1),
                ("exact", "packed8", 4)]


def _engines(alloc, layout, refresh):
    kw = dict(alloc=alloc, layout=layout, refresh_interval=refresh)
    return (JEngine(scene(jconfig), **kw),
            TEngine(scene(tconfig), device="cpu", **kw))


@pytest.mark.parametrize("alloc,layout,refresh", ENGINE_CASES)
def test_jax_engine_checkpoint_resumes_in_the_port(tmp_path, alloc, layout,
                                                   refresh):
    jeng, teng = _engines(alloc, layout, refresh)
    path = str(tmp_path / "engine.npz")
    jes = jeng.step_many(jeng.init(), 10)
    jcheckpoint.save(path, jes,
                     meta=jcheckpoint.config_fingerprint(jeng.cfg))
    tes, meta = checkpoint.load(path, teng.init(), expect_config=teng.cfg)
    assert meta == checkpoint.config_fingerprint(teng.cfg)
    assert tes.frame == 10 and isinstance(tes.frame, int)
    assert tes.fields[0].shape == teng.field_shape
    for a, b in zip(engine_state_to_numpy(tes), jax_leaves(jes)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for frame in range(10, 20):
        jes, tes = jeng.step(jes), teng.step(tes)
        assert_engines_agree(jeng, jes, teng, tes, f"frame {frame}")
    assert int(teng.alive_count(tes)) > 100
    with pytest.raises(ValueError, match="config mismatch"):
        checkpoint.load(path, teng.init(), expect_config=dataclasses.replace(
            teng.cfg, drag=0.1))


@pytest.mark.parametrize("alloc,layout,refresh", ENGINE_CASES)
def test_port_engine_checkpoint_resumes_in_jax(tmp_path, alloc, layout,
                                               refresh):
    jeng, teng = _engines(alloc, layout, refresh)
    path = str(tmp_path / "engine.npz")
    tes = teng.step_many(teng.init(), 10)
    checkpoint.save(path, tes, meta=checkpoint.config_fingerprint(teng.cfg))
    leaves, _ = file_leaves(path)
    assert [(a.dtype, a.shape) for a in leaves] == \
        [(a.dtype, a.shape) for a in jax_leaves(jeng.init())]
    jes, _ = jcheckpoint.load(path, jeng.init(), expect_config=jeng.cfg)
    assert int(jes.frame) == 10
    for frame in range(10, 20):
        jes, tes = jeng.step(jes), teng.step(tes)
        assert_engines_agree(jeng, jes, teng, tes, f"frame {frame}")


def _system(**kw):
    return (ParticleSystem(capacity=4096, dt=1 / 60, device="cpu", seed=2,
                           **kw)
            .add_emitter(rate=5000.0, life_min=0.3, life_max=0.8)
            .add_plane())


@pytest.mark.parametrize("alloc,layout", [("select", "packed8"),
                                          ("strided", "slim")])
def test_particle_system_save_load_round_trip(tmp_path, alloc, layout):
    path = str(tmp_path / "ps.npz")
    a = _system(alloc=alloc, layout=layout).step(12)
    a.save(path)
    b = _system(alloc=alloc, layout=layout).load(path)
    assert b.frame == 12
    a.step(7), b.step(7)
    assert a.frame == b.frame == 19
    assert torch.equal(a.packed(), b.packed())
    assert a.alive_count() == b.alive_count() > 0
    with pytest.raises(ValueError, match="config mismatch"):
        _system(alloc=alloc, layout=layout, drag=0.3).load(path)


# --- 4. the sharded directory written by JAX ----------------------------------

def test_sharded_directory_written_by_jax_is_read_on_the_host(tmp_path):
    """``save_sharded`` on the 8 virtual CPU devices: each leaf split in
    eight row blocks; the port assembles the whole state."""
    cfg, tcfg = LIFECYCLE, port_cfg(LIFECYCLE)
    path = str(tmp_path / "sharded")
    devices = jax.devices()
    assert len(devices) == 8
    js, _ = _jax_frames(jnbody.init_fill(cfg), cfg, range(2))
    rows = NamedSharding(Mesh(np.array(devices), ("d",)), PartitionSpec("d"))
    sharded = jax.tree.map(lambda a: jax.device_put(a, rows), js)
    meta = dict(frame=2, **jcheckpoint.config_fingerprint(cfg))
    jcheckpoint.save_sharded(path, sharded, meta=meta)
    assert checkpoint.is_sharded(path)
    assert not checkpoint.is_sharded(str(tmp_path))
    with np.load(os.path.join(path, "shard_p00000.npz")) as z:
        assert len([k for k in z.files if k.startswith("l0s")
                    and k.endswith("_idx")]) == 8

    leaves, got_meta = checkpoint.load_sharded_host(path)
    assert got_meta == meta
    for got, want in zip(leaves, jax_leaves(js)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    st, _ = checkpoint.load_sharded_host(
        path, template=tnbody.init_fill(tcfg, "cpu"), expect_config=tcfg)
    want = state_from_numpy(dict(zip(FIELDS, jax_leaves(js))), "cpu")
    for f in FIELDS:
        assert torch.equal(getattr(st, f), getattr(want, f)), f

    with pytest.raises(ValueError, match="config mismatch"):
        checkpoint.load_sharded_host(
            path, expect_config=dataclasses.replace(tcfg, seed=6))
    # a chunk that is missing leaves its rows uncovered
    with np.load(os.path.join(path, "shard_p00000.npz")) as z:
        kept = {k: z[k] for k in z.files if not k.startswith("l0s3")}
    np.savez(os.path.join(path, "shard_p00000.npz"), **kept)
    with pytest.raises(ValueError, match="do not cover"):
        checkpoint.load_sharded_host(path)
    os.unlink(os.path.join(path, "shard_p00000.npz"))
    with pytest.raises(FileNotFoundError, match="shard_p00000"):
        checkpoint.load_sharded_host(path)


# --- 5. validate and profile_frame --------------------------------------------

@pytest.mark.parametrize("impl", ["blocks", "dense"])
def test_validate_agrees_with_the_oracle_and_keeps_the_state(impl):
    sim = NBodySimulation(port_cfg(DENSE), device="cpu", impl=impl,
                          active_bucketing=False)
    sim.run(3, batch=1)
    before = state_to_numpy(sim.state)
    width = sim._width
    out = sim.validate(frames=3)
    assert out["events_match"] is True and out["frames"] == 3
    assert 0.0 <= out["max_position_deviation"] < 1e-2
    assert sim.frame == 3 and sim._width == width
    after = state_to_numpy(sim.state)
    for f in FIELDS:
        np.testing.assert_array_equal(before[f], after[f], f)


STAGES = ("rng_fields", "cell_ids", "build_grid", "calc_forces", "unsort",
          "lifecycle", "full_frame")


@pytest.mark.parametrize("impl,active", [("blocks", 0), ("blocks", 1024),
                                         ("dense", 0)])
def test_profile_frame_times_the_stages_and_keeps_the_state(impl, active):
    sim = NBodySimulation(port_cfg(LIFECYCLE), device="cpu", impl=impl,
                          active_bucketing=False)
    sim.run(2, batch=1)
    if active:
        sim.state = tnbody.compact_state(sim.state)
        sim._active = active
    before = state_to_numpy(sim.state)
    out = sim.profile_frame(reps=1)
    # the dense pass returns rows in slot order: it has no unsort stage
    want = [s for s in STAGES if impl == "blocks" or s != "unsort"]
    assert list(out) == want
    assert all(ms > 0 for ms in out.values())
    assert sim.frame == 2
    after = state_to_numpy(sim.state)
    for f in FIELDS:
        np.testing.assert_array_equal(before[f], after[f], f)
    for stage, ms in out.items():
        assert sim.timers.counts[f"frame/{stage}"] == 1
        assert sim.timers.totals[f"frame/{stage}"] == pytest.approx(ms / 1e3)
    sim.profile_frame(reps=1)
    assert sim.timers.counts["frame/full_frame"] == 2


def _profiled_sim(active):
    sim = NBodySimulation(port_cfg(LIFECYCLE), device="cpu", impl="blocks",
                          active_bucketing=False)
    sim.run(2)
    if active:
        sim.state = tnbody.compact_state(sim.state)
        sim._active = active
    return sim


@pytest.mark.parametrize("active", [0, 1024])
def test_profile_frame_takes_the_references_arguments(active):
    """``profile_frame(k1=1, k2=2)`` as tests/test_runtime.py:121-136 calls
    the JAX package's: the seven stages land in the timers; the state, the
    frame and the prefix stay as they were, so that the run goes on as if
    it had not been profiled (``full_frame`` runs batches of the loop that
    ``run`` executes and puts the state back)."""
    sim, twin = _profiled_sim(active), _profiled_sim(active)
    before = state_to_numpy(sim.state)
    out = sim.profile_frame(k1=1, k2=2)
    assert set(out) == set(STAGES)
    assert sim.frame == 2 and sim._active == active
    after = state_to_numpy(sim.state)
    for f in FIELDS:
        np.testing.assert_array_equal(before[f], after[f], f)
    rep = sim.timers.report()
    assert "frame/calc_forces" in rep and "frame/build_grid" in rep
    with pytest.raises(ValueError, match="k1 < k2"):
        sim.profile_frame(k1=2, k2=2)
    sim.run(2)
    twin.run(2)
    want = state_to_numpy(twin.state)
    for f in FIELDS:
        np.testing.assert_array_equal(state_to_numpy(sim.state)[f], want[f],
                                      f)
    assert vars(sim.last_stats).keys() == vars(twin.last_stats).keys()
    for k, v in vars(twin.last_stats).items():
        assert int(getattr(sim.last_stats, k)) == int(v), k


def test_distributed_profile_frame_takes_the_references_arguments():
    """``DistributedNBodySimulation.profile_frame(k1=1, k2=2, reps=1)``, as
    the JAX package's is called, on one CPU rank: the frame's time, state
    and frame as they were."""
    sim = DistributedNBodySimulation(port_cfg(LIFECYCLE),
                                     SlabSpec(n_devices=1), device="cpu")
    sim.run(1, batch=1)
    before = state_to_numpy(sim.state)
    out = sim.profile_frame(k1=1, k2=2, reps=1)
    assert list(out) == ["full_frame"]
    assert sim.frame == 1
    after = state_to_numpy(sim.state)
    for f in FIELDS:
        np.testing.assert_array_equal(before[f], after[f], f)
    assert sim.timers.counts["frame/full_frame"] == 1
    assert sim.timers.totals["frame/full_frame"] == pytest.approx(
        out["full_frame"] / 1e3)


@pytest.mark.cuda
def test_cuda_profile_frame_times_the_replays():
    """On a card ``full_frame`` is the slope of graph replays of the
    current key, after the key's capture; the state is put back."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    sim = NBodySimulation(port_cfg(LIFECYCLE), device="cuda")
    sim.run(2)
    before = state_to_numpy(sim.state)
    replays = sim.graphs.replays
    out = sim.profile_frame(k1=1, k2=2)
    assert list(out) == list(STAGES) and out["full_frame"] > 0
    assert sim.frame == 2 and sim.graphs.replays > replays
    after = state_to_numpy(sim.state)
    for f in FIELDS:
        np.testing.assert_array_equal(before[f], after[f], f)


def test_cli_nbody_dense_validate_save(tmp_path, capsys):
    path = str(tmp_path / "cli.npz")
    cli_main(["nbody", "--particles", "1500", "--grid-dim", "4",
              "--iterations", "2", "--device", "cpu", "--impl", "dense",
              "--validate", "--save", path])
    out = capsys.readouterr().out
    assert "iter 2: alive=" in out and "width=" in out
    assert "'events_match': True" in out
    assert f"checkpoint written to {path}" in out
    leaves, meta = file_leaves(path)
    assert meta["frame"] == 2 and meta["n_fill"] == 1500
    assert len(leaves) == len(FIELDS)


# --- 6. the frame ring and the readback ---------------------------------------

@pytest.mark.parametrize("use_native", [True, False])
def test_frame_ring_keeps_order_and_drops_when_full(use_native):
    assert native.has_native()
    ring = FrameRing(frame_bytes=4 * 6, depth=3, native=use_native)
    assert (ring._lib is not None) == use_native
    frames = [np.full((2, 3), i, np.float32) + np.arange(3, dtype=np.float32)
              for i in range(5)]
    assert ring.pop((2, 3)) is None and ring.fill() == 0
    assert [ring.push(f) for f in frames] == [True, True, True, False, False]
    assert ring.fill() == 3
    np.testing.assert_array_equal(ring.pop((2, 3)), frames[0])
    assert ring.push(frames[3]) and not ring.push(frames[4])
    for i in (1, 2, 3):
        np.testing.assert_array_equal(ring.pop((2, 3)), frames[i])
    assert ring.pop((2, 3)) is None
    # a smaller frame fits; a larger one is refused
    assert ring.push(np.arange(4, dtype=np.float32))
    np.testing.assert_array_equal(ring.pop((4,)), np.arange(4))
    with pytest.raises(ValueError, match="ring"):
        ring.push(np.zeros(7, np.float32))


@pytest.mark.parametrize("use_native", [True, False])
def test_async_readback_publishes_drops_and_flushes(use_native):
    rb = AsyncReadback(frame_bytes=4 * 8, depth=2, native=use_native)
    frames = [torch.arange(8, dtype=torch.float32) + 10 * i for i in range(6)]
    rb.publish(frames[0])
    assert (rb.published, rb.dropped, rb.ring.fill()) == (0, 0, 0)
    src = frames[1].clone()
    rb.publish(src)
    src.zero_()             # the copy was taken at publish time
    rb.publish(frames[2])
    assert (rb.published, rb.dropped, rb.ring.fill()) == (2, 0, 2)
    rb.publish(frames[3])   # ring full: frame 2 is dropped, nothing waits
    assert (rb.published, rb.dropped) == (2, 1)
    np.testing.assert_array_equal(rb.ring.pop((8,)), frames[0].numpy())
    np.testing.assert_array_equal(rb.ring.pop((8,)), frames[1].numpy())
    rb.publish(frames[4])
    assert (rb.published, rb.dropped) == (3, 1)
    rb.flush()
    rb.flush()              # nothing pending: no effect
    assert (rb.published, rb.dropped) == (4, 1)
    np.testing.assert_array_equal(rb.ring.pop((8,)), frames[3].numpy())
    np.testing.assert_array_equal(rb.ring.pop((8,)), frames[4].numpy())
    assert rb.ring.pop((8,)) is None
    with pytest.raises(ValueError, match="ring"):
        rb.publish(torch.zeros(9))


def test_particle_system_readback_delivers_every_frame_to_a_consumer():
    ps = _system(alloc="select")
    rb = ps.enable_readback(depth=3)
    assert rb.ring.frame_bytes == 8 * 4096 * 4
    want, got = [], []
    for _ in range(10):
        ps.step()
        want.append(ps.packed().numpy().copy())
        frame = rb.ring.pop((8, 4096))
        if frame is not None:
            got.append(frame)
    assert rb.published + rb.dropped == 9 and rb.dropped == 0
    rb.flush()
    got.append(rb.ring.pop((8, 4096)))
    assert len(got) == 10 and rb.published == 10
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, f"frame {i}")
    assert ps.timers.counts["readback"] == 10
    # without a consumer the ring fills and later frames are dropped
    ps2 = _system(alloc="select")
    rb2 = ps2.enable_readback(depth=2)
    for _ in range(6):
        ps2.step()
    assert (rb2.published, rb2.dropped) == (2, 3)
