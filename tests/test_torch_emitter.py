"""The port's emitter slice against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
Pallas kernel (``ops/pallas_step.py``) runs in interpret mode, as
``tests/test_pallas_step.py`` runs it.  Tolerances, each with its reason:

* spawn ``valid``, ``accum``, alive masks, cursors, ``n_free``, free lists
  and slot targets: exact (integer or exactly rounded float32 work);
* spawn ``pos``/``vel``/``life``: ``rtol = atol = 1e-6`` (the cube root is
  taken in float64 and rounded once, and libm's ``sin``/``cos`` may differ
  from XLA's by an ulp);
* physics fields after one step: ``rtol = atol = 1e-5``
  (``tests/test_pallas_step.py:73``);
* trajectories over 25 frames: ``rtol = atol = 1e-4``
  (``tests/test_pallas_step.py:94``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particlesystem_tpu.core.config as jconfig
import particlesystem_tpu_torch.core.config as tconfig
from particlesystem_tpu.api import ParticleSystem as JParticleSystem
from particlesystem_tpu.core import rng as jrng
from particlesystem_tpu.core import state as jstate
from particlesystem_tpu.models import emitter as jem
from particlesystem_tpu.ops import compact as jcompact
from particlesystem_tpu.ops import fused_step as jfs
from particlesystem_tpu.ops import pallas_step as jps
from particlesystem_tpu.runtime.engine import PackedEngine as JEngine
from particlesystem_tpu_torch.__main__ import main as cli_main
from particlesystem_tpu_torch.api import ParticleSystem as TParticleSystem
from particlesystem_tpu_torch.core import rng as trng
from particlesystem_tpu_torch.core import state as tstate
from particlesystem_tpu_torch.models import emitter as tem
from particlesystem_tpu_torch.ops import compact as tcompact
from particlesystem_tpu_torch.ops import fused_step as tfs
from particlesystem_tpu_torch.ops import physics_kernel as tpk
from particlesystem_tpu_torch.runtime.engine import (
    PackedEngine as TEngine, engine_state_from_numpy, engine_state_to_numpy)
from particlesystem_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

SPAWN_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)


# --- scenes, built from either package's config module -----------------------

def pallas_scene(m, capacity=2048):
    """tests/test_pallas_step.py's CFG: one emitter, a plane, a sphere."""
    return m.EmitterSceneConfig(
        capacity=capacity, dt=1 / 60, gravity=(0.0, -9.8, 0.0),
        drag=0.5, wind=(2.0, 0.0, -1.0),
        emitters=(m.Emitter(pos=(0.0, 1.0, 0.0), speed=7.0, rate=4000.0,
                            life_min=0.5, life_max=1.2),),
        planes=(m.PlaneCollider(restitution=0.6, friction=0.25),),
        spheres=(m.SphereCollider(center=(0.3, 1.5, 0.0), radius=0.5,
                                  restitution=0.4, friction=0.1),))


def two_emitter_scene(m, capacity=2048):
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


def bench_scene(m, capacity=16384):
    """bench.py:44-62: two emitters (budgets 1001 + 668 rows)."""
    return m.EmitterSceneConfig(
        capacity=capacity, dt=1.0 / 60.0, gravity=(0.0, -9.8, 0.0),
        wind=(2.0, 0.0, -0.5), drag=0.2,
        emitters=(
            m.Emitter(pos=(0.0, 1.0, 0.0), direction=(0.0, 1.0, 0.0),
                      speed=10.0, rate=60_000.0, life_min=20.0,
                      life_max=40.0),
            m.Emitter(pos=(5.0, 1.0, 0.0), direction=(-0.2, 1.0, 0.1),
                      speed=8.0, rate=40_000.0, life_min=20.0,
                      life_max=40.0)),
        planes=(m.PlaneCollider(point=(0, 0, 0), normal=(0, 1, 0),
                                restitution=0.5, friction=0.2),),
        spheres=(m.SphereCollider(center=(2.0, 3.0, 0.0), radius=1.5,
                                  restitution=0.4, friction=0.1),),
        seed=1)


def undamped_scene(m, capacity=2048):
    """No drag, two tilted planes and two spheres."""
    return m.EmitterSceneConfig(
        capacity=capacity, dt=1 / 50, gravity=(0.5, -9.8, 0.25),
        emitters=(m.Emitter(rate=3000.0),),
        planes=(m.PlaneCollider(point=(0, 0, 0), normal=(0.1, 1, 0.05),
                                restitution=0.7, friction=0.1),
                m.PlaneCollider(point=(4.0, 0, 0), normal=(-1, 0.2, 0),
                                restitution=0.3, friction=0.45)),
        spheres=(m.SphereCollider(center=(0.3, 1.5, 0.0), radius=0.9,
                                  restitution=0.4, friction=0.1),
                 m.SphereCollider(center=(2.0, 0.5, 1.0), radius=1.2,
                                  restitution=0.8, friction=0.0)),
        seed=5)


SCENES = {"pallas": pallas_scene, "two_emitter": two_emitter_scene,
          "bench": bench_scene, "undamped": undamped_scene}


def random_fields(n, seed):
    """Eight float32 (n,) fields: 30% never-spawned rows (life 0), some
    expired rows (age > life), positions that start below the ground plane
    and inside the spheres."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-3.0, 5.0, (3, n)).astype(np.float32)
    vel = rng.uniform(-6.0, 6.0, (3, n)).astype(np.float32)
    life = rng.uniform(0.0, 2.0, n).astype(np.float32)
    life[rng.uniform(size=n) < 0.3] = 0.0
    age = (life * rng.uniform(0.0, 1.1, n)).astype(np.float32)
    return (*pos, *vel, age, life)


def np_of(t):
    return t.detach().cpu().numpy()


def assert_fields(got, want, tol, what):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol,
                                   err_msg=f"{what} field {i}")


# --- 1. random draws ----------------------------------------------------------

@pytest.mark.parametrize("seed,frame,salt,total", [
    (1, 0, 0, 1669), (7, 1000, 3, 68)])
def test_emit_draws_match_jax(seed, frame, salt, total):
    jbase = jax.random.fold_in(jrng.frame_key(seed, jnp.int32(frame),
                                              jrng.EMIT), salt)
    tbase = trng.fold_in(trng.frame_key(seed, frame, trng.EMIT), salt)
    ju = np.asarray(jax.random.uniform(jbase, (total, 8), jnp.float32))
    tu = np_of(trng.uniform01(tbase, (total, 8), "cpu"))
    np.testing.assert_array_equal(tu.view(np.uint32), ju.view(np.uint32))
    jd = np.asarray(jrng.random_unit_vectors(jax.random.fold_in(jbase, 1),
                                             total))
    td = np_of(trng.random_unit_vectors(trng.fold_in(tbase, 1), total, "cpu"))
    np.testing.assert_array_equal(td.view(np.uint32), jd.view(np.uint32))


# --- 2. spawn rows ------------------------------------------------------------

@pytest.mark.parametrize("scene", ["pallas", "bench"])
def test_spawn_fields_match_jax(scene):
    jcfg, tcfg = SCENES[scene](jconfig), SCENES[scene](tconfig)
    table = tem.SpawnTable(tcfg, "cpu")
    n_em = len(jcfg.emitters)
    jacc = jnp.zeros((n_em,), jnp.float32)
    tacc = torch.zeros((n_em,))
    gen = jax.jit(lambda a, f: jem.spawn_fields(jcfg, f, a))
    for frame in range(10):
        jrows, jacc = gen(jacc, jnp.int32(frame))
        trows, tacc = tem.spawn_fields(tcfg, frame, tacc, table=table)
        np.testing.assert_array_equal(np_of(tacc), np.asarray(jacc))
        np.testing.assert_array_equal(np_of(trows.valid),
                                      np.asarray(jrows.valid))
        np.testing.assert_array_equal(np_of(trows.w), np.asarray(jrows.w))
        for f in ("pos", "vel", "life"):
            np.testing.assert_allclose(np_of(getattr(trows, f)),
                                       np.asarray(getattr(jrows, f)),
                                       **SPAWN_TOL,
                                       err_msg=f"frame {frame} {f}")
    assert int(trows.valid.sum()) > 0


# --- 3. the physics step: plain version against XLA and Pallas ---------------

@pytest.mark.parametrize("scene", ["pallas", "undamped"])
def test_physics_step_matches_jax_xla_and_pallas(scene):
    n = jps.BLOCK                                    # 32768 rows
    jcfg, tcfg = SCENES[scene](jconfig), SCENES[scene](tconfig)
    fields = random_fields(n, seed=0)
    tin = tuple(torch.tensor(f) for f in fields)
    got = tpk.physics_step(tin, tcfg)
    jin = tuple(jnp.asarray(f) for f in fields)
    xla = jfs.physics_step(jin, jcfg)
    pallas = jps.physics_step_pallas(jin, jcfg)
    assert_fields(got, xla, STEP_TOL, f"{scene} vs xla")
    assert_fields(got, pallas, STEP_TOL, f"{scene} vs pallas")
    np.testing.assert_array_equal(np_of(~tfs.dead_mask(got)),
                                  np.asarray(~jfs.dead_mask(xla)))
    # the scene really exercised contacts and frozen rows
    y0, y1 = fields[1], np_of(got[1])
    assert (y0 < 0).any() and ((y1 != y0) & (fields[7] == 0)).sum() == 0
    assert cuda_build.launches().get("ps_physics_step", 0) == 0


def test_physics_step_slim_matches_jax():
    n = 1 << 14
    jcfg, tcfg = undamped_scene(jconfig), undamped_scene(tconfig)
    f8 = random_fields(n, seed=1)
    death = np.where(f8[7] > 0, np.floor(f8[7] * 60.0), 0.0).astype(
        np.float32)
    fields = (*f8[:6], death)
    got = tpk.physics_step(tuple(torch.tensor(f) for f in fields), tcfg)
    want = jfs.physics_step_slim(tuple(jnp.asarray(f) for f in fields), jcfg)
    assert_fields(got, want, STEP_TOL, "slim")
    np.testing.assert_array_equal(np_of(got[6]), death)


def test_physics_window_matches_jax_strided_spawn():
    """The window variant is physics then ``strided_spawn`` at the cursor."""
    n, w = 8192, 1024
    jcfg, tcfg = pallas_scene(jconfig), pallas_scene(tconfig)
    fields = random_fields(n, seed=2)
    rng = np.random.default_rng(3)
    rows = rng.uniform(-1.0, 1.0, (8, w)).astype(np.float32)
    valid = rng.uniform(size=w) < 0.7
    for cur in (0, 3 * w, n - w):
        got = tpk.physics_step(
            tuple(torch.tensor(f) for f in fields), tcfg,
            (torch.tensor(rows), torch.tensor(valid),
             torch.tensor(cur, dtype=torch.int32)))
        jout = jfs.physics_step(tuple(jnp.asarray(f) for f in fields), jcfg)
        want, _ = jfs.strided_spawn(jout, tuple(jnp.asarray(rows)),
                                    jnp.asarray(valid), jnp.int32(cur), n)
        assert_fields(got, want, STEP_TOL, f"cursor {cur}")
        np.testing.assert_array_equal(np_of(got[7])[cur:cur + w][valid],
                                      rows[7][valid])


def test_pack_unpack_state_match_jax():
    n = 512
    f = random_fields(n, seed=4)
    jst = jstate.unpack_state(tuple(jnp.asarray(a) for a in f))
    tst = tstate.unpack_state(tuple(torch.tensor(a) for a in f))
    for name in ("pos", "vel", "age", "life", "alive", "acc", "w", "tag"):
        np.testing.assert_array_equal(np_of(getattr(tst, name)),
                                      np.asarray(getattr(jst, name)))
    for a, b in zip(tstate.pack_state(tst), jstate.pack_state(jst)):
        np.testing.assert_array_equal(np_of(a), np.asarray(b))


# --- 4. step_core and the allocator -------------------------------------------

def test_allocate_matches_jax():
    rng = np.random.default_rng(5)
    for n, s, p_alive, p_req in ((1024, 300, 0.5, 0.6), (1024, 300, 0.9, 0.9),
                                 (64, 100, 0.0, 1.0)):
        alive = rng.uniform(size=n) < p_alive
        req = rng.uniform(size=s) < p_req
        jt, jok = jcompact.allocate(jnp.asarray(alive), jnp.asarray(req))
        tt, tok = tcompact.allocate(torch.tensor(alive), torch.tensor(req))
        np.testing.assert_array_equal(np_of(tok), np.asarray(jok))
        np.testing.assert_array_equal(np_of(tt), np.asarray(jt))


def test_step_core_matches_jax():
    jcfg, tcfg = pallas_scene(jconfig), pallas_scene(tconfig)
    f = random_fields(jcfg.slots, seed=6)
    jst = jstate.unpack_state(tuple(jnp.asarray(a) for a in f))
    tst = tstate.unpack_state(tuple(torch.tensor(a) for a in f))
    jacc, tacc = jnp.zeros((1,), jnp.float32), torch.zeros((1,))
    step = jax.jit(lambda s, a, fr: jem.step(s, a, fr, jcfg))
    for frame in range(25):
        jst, jacc = step(jst, jacc, jnp.int32(frame))
        tst, tacc = tem.step(tst, tacc, frame, tcfg)
        np.testing.assert_array_equal(np_of(tst.alive), np.asarray(jst.alive),
                                      err_msg=f"frame {frame} alive")
        for name in ("pos", "vel", "acc", "age", "life", "w"):
            np.testing.assert_allclose(np_of(getattr(tst, name)),
                                       np.asarray(getattr(jst, name)),
                                       **TRAJ_TOL,
                                       err_msg=f"frame {frame} {name}")
    assert int(tst.alive.sum()) == jcfg.slots    # saturated: spawns dropped


# --- 5. the engine, every (alloc, layout) pair --------------------------------

ENGINES = [("exact", "packed8", 1), ("exact", "packed8", 4),
           ("ring", "packed8", 1), ("strided", "packed8", 1),
           ("select", "packed8", 1), ("ring", "slim", 1),
           ("strided", "slim", 1), ("select", "slim", 1)]


def _engines(alloc, layout, refresh, capacity=2048):
    kw = dict(alloc=alloc, layout=layout, refresh_interval=refresh)
    return (JEngine(two_emitter_scene(jconfig, capacity), **kw),
            TEngine(two_emitter_scene(tconfig, capacity), device="cpu", **kw))


def _alive(eng, fields, frame):
    if eng.layout == "slim":
        return frame < fields[6]
    return (fields[6] <= fields[7]) & (fields[7] > 0)


def assert_engines_agree(jeng, jes, teng, tes, what):
    """Bookkeeping and alive masks exact, fields by the trajectory rule."""
    jl = [np.asarray(a) for a in jax.tree_util.tree_leaves(jes)]
    tl = engine_state_to_numpy(tes)
    nf = teng.n_fields
    for name, a, b in zip(("accum", "free_list", "cursor", "n_free",
                           "frame"), tl[nf:], jl[nf:]):
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")
    jflat = [np.asarray(f) for f in jeng.flat_fields(jes)]
    tflat = [np_of(f) for f in teng.flat_fields(tes)]
    np.testing.assert_array_equal(_alive(teng, tflat, tes.frame),
                                  _alive(jeng, jflat, int(jes.frame)),
                                  err_msg=f"{what} alive")
    assert_fields(tl[:nf], jl[:nf], TRAJ_TOL, what)


@pytest.mark.parametrize("alloc,layout,refresh", ENGINES)
def test_engine_matches_jax(alloc, layout, refresh):
    jeng, teng = _engines(alloc, layout, refresh)
    init = random_fields(jeng.cfg.slots, seed=7)
    jes = jeng.init(tuple(jnp.asarray(f) for f in init))
    tes = teng.init(init)
    for frame in range(25):
        jes, tes = jeng.step(jes), teng.step(tes)
        assert_engines_agree(jeng, jes, teng, tes, f"frame {frame}")
    assert int(teng.alive_count(tes)) == int(jeng.alive_count(jes)) > 100


def test_ring_engine_wraps_and_clears_shadow():
    """Spawns cross the ring's end: the fold leaves the shadow zero."""
    jeng, teng = _engines("ring", "packed8", 1, capacity=1024)
    jes, tes = jeng.init(), teng.init()
    wrapped = False
    for frame in range(20):
        before = int(tes.cursor)
        jes, tes = jeng.step(jes), teng.step(tes)
        wrapped |= int(tes.cursor) < before
        assert_engines_agree(jeng, jes, teng, tes, f"frame {frame}")
    assert wrapped
    assert not tes.fields[7][teng.cfg.slots:].any()


def test_select_matches_strided_bitwise():
    """``select`` is ``strided`` over (slots/W, W) views: same cursor every
    frame and the same flattened state, bit for bit (test_slim_engine.py:
    144-165)."""
    cfg = two_emitter_scene(tconfig, capacity=1 << 14)
    for layout in ("packed8", "slim"):
        es_ = TEngine(cfg, alloc="strided", layout=layout, device="cpu")
        ec = TEngine(cfg, alloc="select", layout=layout, device="cpu")
        ss, sc = es_.init(), ec.init()
        assert sc.fields[0].shape == (ec.b_rows, ec.spawn_width)
        for _ in range(40):
            ss, sc = es_.step(ss), ec.step(sc)
            assert int(ss.cursor) == int(sc.cursor)
        for a, b in zip(es_.flat_fields(ss), ec.flat_fields(sc)):
            assert torch.equal(a, b), layout
        assert int(es_.alive_count(ss)) == int(ec.alive_count(sc)) > 100


def test_engine_rejects_what_jax_rejects():
    # padded budget 2048 (test_slim_engine.py:181-189)
    cfg = two_emitter_scene(tconfig, capacity=3000)
    cfg = dataclasses.replace(cfg, emitters=(tconfig.Emitter(rate=80_000.0),))
    with pytest.raises(ValueError, match="divisible"):
        TEngine(cfg, alloc="strided", device="cpu")
    with pytest.raises(ValueError, match="slim"):
        TEngine(cfg, alloc="exact", layout="slim", device="cpu")
    with pytest.raises(ValueError, match="at most 8 planes"):
        tpk.scene_params(dataclasses.replace(
            cfg, planes=(tconfig.PlaneCollider(),) * 9))
    fields = tuple(torch.zeros(1024) for _ in range(8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpk.physics_step_cuda(fields, cfg)
    with pytest.raises(ValueError, match="one length"):
        tpk.physics_step(fields[:7] + (torch.zeros(512),), cfg)
    assert cuda_build.launches().get("ps_physics_step", 0) == 0


# --- 6. state carried across ------------------------------------------------

@pytest.mark.parametrize("alloc,layout,refresh", [
    ("exact", "packed8", 4), ("select", "slim", 1)])
def test_engine_state_carries_across(alloc, layout, refresh):
    jeng, teng = _engines(alloc, layout, refresh)
    init = random_fields(jeng.cfg.slots, seed=8)
    jes = jeng.init(tuple(jnp.asarray(f) for f in init))
    jes = jeng.step_many(jes, 10)
    tes = engine_state_from_numpy(
        [np.asarray(a) for a in jax.tree_util.tree_leaves(jes)], teng)
    assert tes.frame == 10
    assert_engines_agree(jeng, jes, teng, tes, "carried")
    for frame in range(10, 25):
        jes, tes = jeng.step(jes), teng.step(tes)
        assert_engines_agree(jeng, jes, teng, tes, f"frame {frame}")


# --- 7. ParticleSystem on BASELINE configs 2-4 ------------------------------

def config2(cls, **kw):
    return (cls(capacity=20_480, dt=1 / 60, gravity=(0, -9.8, 0), drag=0.8,
                wind=(4.0, 0.0, 0.0), **kw)
            .add_emitter(pos=(0, 2, 0), rate=40_000.0, speed=6.0,
                         life_min=0.3, life_max=0.9)), 40


def config3(cls, **kw):
    return (cls(capacity=8_192, dt=1 / 60, gravity=(0, -9.8, 0), **kw)
            .add_emitter(pos=(0, 3, 0), direction=(0.3, -1, 0),
                         rate=20_000.0, speed=5.0, life_min=2.0,
                         life_max=3.0)
            .add_plane(point=(0, 0, 0), normal=(0, 1, 0), restitution=0.6,
                       friction=0.2)
            .add_sphere(center=(0.5, 1.0, 0.0), radius=0.5,
                        restitution=0.5, friction=0.1)), 90


def config4(cls, **kw):
    return (cls(capacity=4_096, dt=1 / 60, alloc="exact",
                refresh_interval=2, **kw)
            .add_emitter(rate=100_000.0, life_min=0.1, life_max=0.2)), 60


@pytest.mark.parametrize("make", [config2, config3, config4],
                         ids=["config2", "config3", "config4"])
def test_particle_system_matches_jax(make):
    jps_, frames = make(JParticleSystem)
    tps, _ = make(TParticleSystem, device="cpu")
    for _ in range(frames):          # one compiled JAX frame, not a loop
        jps_.step()
    tps.step(frames)
    assert tps.frame == jps_.frame == frames
    assert tps.alive_count() == jps_.alive_count() > 100
    np.testing.assert_array_equal(tps.alive_mask(), jps_.alive_mask())
    np.testing.assert_allclose(tps.positions(), jps_.positions(), **TRAJ_TOL)
    np.testing.assert_allclose(tps.fade(), jps_.fade(), **TRAJ_TOL)


def test_particle_system_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TParticleSystem(capacity=4096)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(pallas_scene(tconfig))


def test_cli_demo_runs_on_cpu(capsys):
    cli_main(["demo", "--capacity", "4096", "--frames", "60",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "frame 60: alive" in out and "step:" in out


# --- 8. the kernel on the card --------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed8", "slim"])
@pytest.mark.parametrize("windowed", [False, True])
def test_cuda_physics_kernel_matches_plain(layout, windowed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py phase 5 checks the "
                    "same on the card)")
    n, w = 1 << 16, 2048
    cfg = bench_scene(tconfig, capacity=n)
    f = random_fields(n, seed=9)
    if layout == "slim":
        f = (*f[:6], np.floor(f[7] * 60.0).astype(np.float32))
    fields = tuple(torch.tensor(a, device="cuda") for a in f)
    window = None
    if windowed:
        rng = np.random.default_rng(10)
        window = (torch.tensor(rng.uniform(-1, 1, (len(f), w)),
                               dtype=torch.float32, device="cuda"),
                  torch.tensor(rng.uniform(size=w) < 0.8, device="cuda"),
                  torch.tensor(n - w, dtype=torch.int32, device="cuda"))
    want = tpk.physics_step_plain(fields, cfg, window)
    got = tpk.physics_step_cuda(tuple(a.clone() for a in fields), cfg,
                                window)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
