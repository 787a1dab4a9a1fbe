"""The frame loops of the port (``utils/frame_graph.FrameGraphs``) on the
CPU, against the eager frames and the JAX package.

On a card each frame of ``NBodySimulation.run`` and of
``PackedEngine.step``/``step_many`` is one replay of a CUDA graph that
reads the frame index from the device; on the CPU the same loop object
runs the same frame function eagerly on the same static buffers, which is
what these tests drive.  Tolerances, each with its reason:

* the frame index as a 0-dim tensor against a Python int, and the loop
  against the eager frames: bit for bit (the same operations on the same
  inputs);
* random draws against ``jax.random``: bit for bit (discrete functions of
  the hash's bits; JAX op by op, as ``tests/test_torch_rng_kernel.py``
  runs it);
* the loop against JAX's ``NBodySimulation.run``: statistics and the
  alive and parent masks exact, floats by the chaotic-trajectory rule of
  ``tests/test_nbody_parity.py``;
* the engine's loop against JAX's ``step_many``: bookkeeping and alive
  masks exact, fields to ``rtol = atol = 1e-4``
  (``tests/test_pallas_step.py:94``).

The ``cuda``-marked test captures and replays on a card and skips here;
``chip_smoke.py`` phase 14 holds the captured loops to the eager ones at
full width.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particlesystem_tpu.core.config as jconfig
import particlesystem_tpu_torch.core.config as tconfig
from particlesystem_tpu import GridSpec, NBodyConfig
from particlesystem_tpu.api import NBodySimulation as JNBodySimulation
from particlesystem_tpu.core import rng as jrng
from particlesystem_tpu.models import nbody as jnbody
from particlesystem_tpu.runtime.engine import PackedEngine as JEngine
from particlesystem_tpu_torch import GridSpec as TGridSpec
from particlesystem_tpu_torch import NBodyConfig as TNBodyConfig
from particlesystem_tpu_torch.api import NBodySimulation
from particlesystem_tpu_torch.core import rng as trng
from particlesystem_tpu_torch.core.state import FIELDS, state_to_numpy
from particlesystem_tpu_torch.models import emitter as tem
from particlesystem_tpu_torch.models import nbody as tnbody
from particlesystem_tpu_torch.ops import fused_step as tfs
from particlesystem_tpu_torch.ops import rng_kernel as rk
from particlesystem_tpu_torch.runtime.engine import (PackedEngine as TEngine,
                                                     engine_state_to_numpy)
from particlesystem_tpu_torch.utils import cuda_build, frame_graph

torch.set_num_threads(1)

#: 4,096 slots on a 4^3 grid (tests/test_nbody_parity.py's DENSE shape)
CFG = NBodyConfig(n_fill=1024, capacity=4096,
                  grid=GridSpec(grid_dim=4, cell_size=5.0, chunk_factor=2),
                  particle_life=2.0, seed=5)
FRAMES = (0, 1, 20, 2 ** 31 - 1)
EDGE_TAGS = np.array([0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
TAGS = np.concatenate([
    EDGE_TAGS, np.random.default_rng(3).integers(0, 2 ** 32, 300, np.uint32)])
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)


def port_cfg(cfg):
    d = dataclasses.asdict(cfg)
    return TNBodyConfig(**{**d, "grid": TGridSpec(**d["grid"])})


def bits(a):
    return np.asarray(a).view(np.uint32)


def frame_t(frame):
    return torch.tensor(frame, dtype=torch.int64)


def assert_close_chaotic(a, b, msg):
    """tests/test_nbody_parity.py:69-78."""
    err = np.abs(a - b)
    tol = 1e-3 + 1e-2 * np.abs(b)
    assert float(np.mean(err > tol)) <= 0.005, msg
    assert float(err.max()) < 0.25, f"{msg}: max abs err {err.max()}"


# --- 1. the frame index on the device -----------------------------------------

@pytest.mark.parametrize("frame", FRAMES)
def test_nbody_draws_of_a_device_frame(frame):
    cfg = port_cfg(CFG)
    tags = torch.from_numpy(TAGS.astype(np.int64))
    lo, hi = cfg.min_fertility_age, cfg.max_fertility_age
    host = rk.nbody_fields(cfg.seed, frame, tags, lo, hi)
    dev = rk.nbody_fields(cfg.seed, frame_t(frame), tags, lo, hi)
    juvec, jfert = jnbody.frame_fields(CFG, jnp.int32(frame),
                                       jnp.asarray(TAGS))
    for a, b, j in zip(dev, host, (juvec, jfert)):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b.numpy()))
        np.testing.assert_array_equal(bits(a.numpy()), bits(j))
    # the child tags take the frame as it is
    jmix = jrng.tag_mix(jnp.asarray(TAGS), jnp.int32(frame))
    for fr in (frame, frame_t(frame)):
        np.testing.assert_array_equal(
            trng.tag_mix(tags, fr).numpy().astype(np.uint32),
            np.asarray(jmix))


@pytest.mark.parametrize("salt", [0, 3])
def test_spawn_draws_of_a_device_frame(salt):
    seed, total = 7, 68
    draws = tem.spawn_draws(tconfig.EmitterSceneConfig(seed=seed), salt,
                            total)
    for frame in FRAMES:
        host = rk.flat_fields(draws, frame, "cpu")
        dev = rk.flat_fields(draws, frame_t(frame), "cpu")
        jbase = jax.random.fold_in(jrng.frame_key(seed, jnp.int32(frame),
                                                  jrng.EMIT), salt)
        want = (jax.random.uniform(jbase, (total, 8), jnp.float32),
                jrng.random_unit_vectors(jax.random.fold_in(jbase, 1),
                                         total))
        for a, b, j in zip(dev, host, want):
            np.testing.assert_array_equal(bits(a.numpy()), bits(b.numpy()))
            np.testing.assert_array_equal(bits(a.numpy()), bits(j))


def test_init_fill_draws_of_a_device_frame():
    cfg = port_cfg(CFG)
    draws = tnbody.fill_draws(cfg, cfg.n_fill)
    host = rk.flat_fields(draws, 0, "cpu")
    dev = rk.flat_fields(draws, frame_t(0), "cpu")
    kr, ks, ka, kf = jax.random.split(
        jrng.frame_key(CFG.seed, jnp.int32(0), jrng.FILL), 4)
    n = cfg.n_fill
    want = (jax.random.uniform(kr, (n, 3), jnp.float32),
            jax.random.uniform(ks, (n, 3), jnp.float32),
            jrng.uniform(ka, (n,), CFG.min_adult_age, CFG.max_adult_age),
            jrng.uniform(kf, (n,), CFG.min_fertility_age,
                         CFG.max_fertility_age))
    for a, b, j in zip(dev, host, want):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b.numpy()))
        np.testing.assert_array_equal(bits(a.numpy()), bits(j))


def test_slim_death_frame_of_a_device_frame():
    spawn = tem.SpawnRows(*(torch.zeros((4, 3)),) * 2,
                          torch.tensor([0.5, 1.0, 2.0, 3.25]),
                          torch.ones(4), torch.ones(4, dtype=torch.bool))
    for frame in FRAMES[:3]:
        a = tfs.pack_spawn_rows_slim(spawn, frame, 1 / 60)[6]
        b = tfs.pack_spawn_rows_slim(spawn, frame_t(frame), 1 / 60)[6]
        assert torch.equal(a, b)


# --- 2. the n-body loop -----------------------------------------------------------

@pytest.fixture(scope="module")
def nbody_runs(tmp_path_factory):
    """The loop's run(8, batch=4) on the CPU, saved at frame 4, the eight
    eager frames, and JAX's run(8, batch=4), all at full width."""
    cfg = port_cfg(CFG)
    sim = NBodySimulation(cfg, device="cpu", active_bucketing=False)
    stats = [sim.run(4, batch=4)]
    sim.checkpoint = str(tmp_path_factory.mktemp("loop") / "f4.npz")
    sim.save(sim.checkpoint)
    stats.append(sim.run(4, batch=4))
    ref = tnbody.init_fill(cfg, "cpu")
    ref_stats = []
    for f in range(8):
        ref, st = tnbody.step(ref, f, cfg)
        ref_stats.append(st)
    jsim = JNBodySimulation(CFG, active_bucketing=False)
    jstats = jsim.run(8, batch=4)
    return sim, stats, ref, ref_stats, jsim, jstats


def test_run_equals_the_eager_frames(nbody_runs):
    sim, stats, ref, ref_stats, _, _ = nbody_runs
    assert sim.frame == 8 and sim.graphs.eager_frames == 8
    assert sim.graphs.keys == [("blocks", 0, 0)]
    a, b = state_to_numpy(sim.state), state_to_numpy(ref)
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], b[f], f)
    for got, want in zip(stats, (ref_stats[3], ref_stats[7])):
        assert {k: int(v) for k, v in vars(got).items()} == \
            {k: int(v) for k, v in vars(want).items()}


def test_run_equals_jax(nbody_runs):
    sim, stats, _, _, jsim, jstats = nbody_runs
    for k, v in vars(stats[1]).items():
        assert int(v) == int(getattr(jstats, k)), k
    a = state_to_numpy(sim.state)
    j = {f: np.asarray(getattr(jsim.state, f)) for f in FIELDS}
    for f in ("alive", "parent", "tag"):
        np.testing.assert_array_equal(a[f], j[f], f)
    for f in ("pos", "vel", "age", "life", "w"):
        assert_close_chaotic(a[f], j[f], f)


def test_last_stats_outlive_the_next_batch(nbody_runs):
    _, stats, _, ref_stats, _, _ = nbody_runs
    # stats[0] was read after frames 0-3; frames 4-7 ran since, and left
    # other stats in the loop's buffer
    as_ints = lambda st: {k: int(v) for k, v in vars(st).items()}
    assert as_ints(ref_stats[3]) != as_ints(ref_stats[7])
    assert as_ints(stats[0]) == as_ints(ref_stats[3])


def test_a_new_prefix_makes_a_new_key_and_frees_the_old(monkeypatch):
    monkeypatch.setattr(NBodySimulation, "ACTIVE_QUANTUM", 1024)
    cfg = port_cfg(dataclasses.replace(CFG, n_fill=500))
    sim = NBodySimulation(cfg, device="cpu")
    static = sim.state
    sim.run(2, batch=2)
    assert sim.graphs.keys == [("blocks", 0, 0)]
    assert 0 < sim._active < cfg.slots
    assert sim.state is not static      # the compaction, not yet copied in
    sim.run(2, batch=2)
    assert sim.graphs.keys == [("blocks", sim._active, 0)]
    assert sim.state is static          # copied into the static buffers
    # the same frames, compacted where the loop compacted
    ref = tnbody.init_fill(cfg, "cpu")
    for f in range(4):
        if f == 2:
            ref = tnbody.compact_state(ref)
        ref, st = tnbody.step(ref, f, cfg)
    a, b = state_to_numpy(sim.state), state_to_numpy(ref)
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], b[f], f)


def test_save_load_resumes_the_run(nbody_runs):
    a = nbody_runs[0]        # saved at frame 4, then run(4)
    b = NBodySimulation(a.cfg, device="cpu", active_bucketing=False)
    b.load(a.checkpoint)     # the static buffers hold the fill: copied in
    b.run(4, batch=4)
    assert a.frame == b.frame == 8 and b.state is b._static
    x, y = state_to_numpy(a.state), state_to_numpy(b.state)
    for f in FIELDS:
        np.testing.assert_array_equal(x[f], y[f], f)
    for k, v in vars(a.last_stats).items():
        assert int(v) == int(getattr(b.last_stats, k)), k


# --- 3. the engine loop -----------------------------------------------------------

def scene(m, capacity=4096):
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
                                  restitution=0.4, friction=0.1),))


def alive(eng, fields, frame):
    if eng.layout == "slim":
        return frame < fields[6]
    return (fields[6] <= fields[7]) & (fields[7] > 0)


@pytest.mark.parametrize("alloc,layout,refresh", [
    ("select", "packed8", 1), ("ring", "slim", 1), ("exact", "packed8", 3)])
def test_engine_loop_equals_eager_and_jax(alloc, layout, refresh):
    kw = dict(alloc=alloc, layout=layout, refresh_interval=refresh)
    teng = TEngine(scene(tconfig), device="cpu", **kw)
    jeng = JEngine(scene(jconfig), **kw)
    # from frame 1: the exact allocator's first graph is the one without
    # the refresh, its second (frame 3) the one with it.  JAX starts from
    # the port's frame 1 (the engines' frames agree: test_torch_emitter)
    tes = teng._frame(teng.init())
    jes = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jeng.init()),
        [jnp.array(a, copy=True) for a in engine_state_to_numpy(tes)])
    ref = teng._frame(teng.init())
    for k in (4, 6):
        tes = teng.step_many(tes, k)
        for _ in range(k):
            ref = teng._frame(ref)
        assert tes.frame == ref.frame
        for i, (a, b) in enumerate(zip(tes.tensors(), ref.tensors(),
                                       strict=True)):
            assert torch.equal(a, b), f"frame {tes.frame}: tensor {i}"
    jes = jeng.step_many(jes, 10)
    tl = engine_state_to_numpy(tes)
    jl = [np.asarray(a) for a in jax.tree_util.tree_leaves(jes)]
    nf = teng.n_fields
    for name, a, b in zip(("accum", "free_list", "cursor", "n_free",
                           "frame"), tl[nf:], jl[nf:]):
        np.testing.assert_array_equal(a, b, err_msg=name)
    tflat = [f.numpy() for f in teng.flat_fields(tes)]
    jflat = [np.asarray(f) for f in jeng.flat_fields(jes)]
    np.testing.assert_array_equal(alive(teng, tflat, tes.frame),
                                  alive(jeng, jflat, int(jes.frame)))
    for i, (a, b) in enumerate(zip(tl[:nf], jl[:nf])):
        np.testing.assert_allclose(a, b, **TRAJ_TOL, err_msg=f"field {i}")
    assert teng.graphs.eager_frames == 10
    assert sorted(teng.graphs.keys) == ([False, True] if alloc == "exact"
                                        else [False])
    assert int(teng.alive_count(tes)) > 100


def test_engine_copies_a_foreign_state_in_once():
    eng = TEngine(scene(tconfig), alloc="select", device="cpu")
    first = eng.step_many(eng.init(), 3)
    static = first.fields[0]
    ref = eng.init()
    for _ in range(3):
        ref = eng._frame(ref)
    other = eng.step(dataclasses.replace(ref))   # copied into the buffers
    assert other is first and other.fields[0] is static
    ref = eng._frame(ref)
    for a, b in zip(other.tensors(), ref.tensors()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        eng.step(dataclasses.replace(ref, accum=torch.zeros(5)))


# --- 4. the loop object -------------------------------------------------------------

def test_frame_graphs_keep_and_free_keys_on_the_cpu():
    graphs = frame_graph.FrameGraphs(torch.device("cpu"))
    ran = []
    for key in ("a", "a", "b"):
        graphs.step(key, lambda: ran.append(key))
    assert ran == ["a", "a", "b"] and graphs.eager_frames == 3
    assert graphs.captures == graphs.replays == 0
    assert graphs.keys == ["a", "b"] and graphs.recorded("a") == {}
    graphs.retain("b")
    assert graphs.keys == ["b"]


def test_launches_in_a_capture_are_recorded_not_counted(monkeypatch):
    """``cuda_build.launch`` counts by entry point; inside a capture it
    records instead, and each replay counts the record again, also after
    the record is freed with its graph (a fake entry point: no card)."""
    monkeypatch.setattr(cuda_build, "_call", lambda name, device, args: None)
    name, dev = "ps_fake_recorded", torch.device("cuda", 0)
    launched = lambda: cuda_build.launches().get(name, 0)
    before = launched()
    cuda_build.launch(name, dev)
    with cuda_build.recording() as rec:
        cuda_build.launch(name, dev)
        cuda_build.launch(name, dev)
    cuda_build.launch(name, dev)
    assert launched() == before + 2 and rec.counts == {name: 2}
    rec.replays += 3
    assert launched() == before + 8
    del rec
    assert launched() == before + 8


@pytest.mark.cuda
def test_cuda_loops_capture_and_replay():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py phase 14 holds the "
                    "captured loops to the eager ones at full width)")
    cfg = port_cfg(CFG)
    sim = NBodySimulation(cfg, device="cuda", active_bucketing=False)
    sim.run(6, batch=3)
    assert (sim.graphs.eager_frames, sim.graphs.captures,
            sim.graphs.replays) == (1, 1, 5)
    ref = tnbody.init_fill(cfg, "cuda")
    for f in range(6):
        ref, _ = tnbody.step(ref, f, cfg)
    for f in FIELDS:
        assert torch.equal(getattr(sim.state, f), getattr(ref, f)), f
    eng = TEngine(scene(tconfig), alloc="exact", refresh_interval=3,
                  device="cuda")
    es, ref = eng.step_many(eng.init(), 7), eng.init()
    for _ in range(7):
        ref = eng._frame(ref)
    for a, b in zip(es.tensors(), ref.tensors()):
        assert torch.equal(a, b)
    assert eng.graphs.captures == 2 and eng.graphs.replays == 5
    # a frame that reads back to the host cannot be captured: it raises
    graphs = frame_graph.FrameGraphs(torch.device("cuda"))
    x = torch.zeros((), device="cuda")
    with pytest.raises(RuntimeError):
        graphs.step("sync", lambda: x.add_(1).item())
