"""The emitter frame's kernels (``ops/engine_kernels.py``) against the JAX
package, through their plain versions, which CPU tensors take.

* The spawn window (``spawn_window_plain``: ``spawn_fields``,
  ``pack_spawn_rows(_slim)`` and the padding) against JAX's
  ``spawn_fields`` + ``pack_spawn_rows(_slim)`` + ``jnp.pad``, on the bench
  scene, the entry scene, three emitters whose 338 rows are no multiple of
  a warp, and no emitter; packed8 and slim; frames 0, 1 and 4099; salts 0
  and 3.  ``valid`` and the next ``accum`` exact; the rows within
  ``SPAWN_TOL`` (``tests/test_torch_emitter.py``: the cube root is taken
  in float64 and rounded once, libm's ``sin``/``cos`` may differ from
  XLA's by an ulp).
* The ring write (``ring_write_plain``) against JAX's ``ring_spawn``: a
  cursor at 0, one in the middle and one where the write wraps, with
  none, some or all rows valid; fields and cursor exact (a permutation of
  exact values).
* The bookkeeping: 25 frames of the engine's static frame (the
  composition the card's graphs run: spawn, physics, ring, tail) against
  25 of its eager ``_frame``, bit for bit, on the CPU.
* The dispatch: another device raises; the CPU path never loads the CUDA
  library.

The ``cuda``-marked test holds each kernel to its plain version on the
card (it skips here); ``chip_smoke.py`` phase 16 does so at full width.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particlesystem_tpu.core.config as jconfig
import particlesystem_tpu_torch.core.config as tconfig
from particlesystem_tpu.models import emitter as jem
from particlesystem_tpu.ops import fused_step as jfs
from particlesystem_tpu_torch.entry import entry_scene
from particlesystem_tpu_torch.models import emitter as tem
from particlesystem_tpu_torch.ops import engine_kernels as ek
from particlesystem_tpu_torch.runtime.engine import (PackedEngine,
                                                     engine_state_to_numpy)
from particlesystem_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

SPAWN_TOL = dict(rtol=1e-6, atol=1e-6)
FRAMES = (0, 1, 4099)
SALTS = (0, 3)


# --- scenes, built with the port's config and carried to the JAX package's --

def bench_scene(capacity=16384):
    """bench.py:44-62: two emitters (budgets 1001 + 668 rows)."""
    m = tconfig
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


def three_emitter_scene(capacity=4096):
    """chip_smoke.py's three emitters: budgets 168 + 118 + 52 = 338 rows,
    unequal cones, jitters and radii."""
    m = tconfig
    return m.EmitterSceneConfig(
        capacity=capacity, dt=1.0 / 60.0, gravity=(0.0, -9.8, 0.0),
        emitters=(
            m.Emitter(pos=(0.0, 1.0, 0.0), speed=6.0, rate=10_000.0,
                      cone_angle=1.1, speed_jitter=0.4, radius=0.2),
            m.Emitter(pos=(2.0, 0.5, -1.0), direction=(1.0, 0.2, 0.0),
                      speed=3.0, rate=7_000.0, cone_angle=0.05,
                      speed_jitter=0.0, radius=1.5, life_min=0.5,
                      life_max=0.75),
            m.Emitter(pos=(-1.0, 2.0, 3.0), direction=(0.0, -1.0, 0.3),
                      speed=12.0, rate=3_001.0, cone_angle=2.5,
                      speed_jitter=0.9, radius=0.0)),
        planes=(m.PlaneCollider(),), seed=7)


SCENES = {"bench": bench_scene, "entry": entry_scene,
          "three": three_emitter_scene,
          "none": lambda: tconfig.EmitterSceneConfig(capacity=4096, seed=3)}


def to_jax(cfg):
    """The JAX package's copy of a port scene (the same fields)."""
    d = dataclasses.asdict(cfg)
    return jconfig.EmitterSceneConfig(**{
        **d,
        "emitters": tuple(jconfig.Emitter(**e) for e in d["emitters"]),
        "planes": tuple(jconfig.PlaneCollider(**p) for p in d["planes"]),
        "spheres": tuple(jconfig.SphereCollider(**s) for s in d["spheres"])})


def accum_of(cfg, seed):
    """The emitters' fractional credit in [0, 1), 0 and the float just
    below 1 among it."""
    n = max(1, len(cfg.emitters))
    a = np.random.default_rng(seed).uniform(0.0, 1.0, n).astype(np.float32)
    a[0] = 0.0
    a[-1] = np.nextafter(np.float32(1.0), np.float32(0.0))
    return a


@functools.lru_cache(maxsize=None)
def jax_spawn(scene: str):
    """JAX's spawn_fields of ``scene``, jitted once (salt traced)."""
    cfg = to_jax(SCENES[scene]())
    return cfg, jax.jit(lambda a, f, s: jem.spawn_fields(cfg, f, a, s))


def jax_window(scene, salt, accum, frame, slim, width):
    """JAX's spawn_fields + pack_spawn_rows(_slim) + jnp.pad."""
    cfg, gen = jax_spawn(scene)
    f = jnp.int32(frame)
    rows, acc = gen(jnp.asarray(accum), f, jnp.int32(salt))
    packed = (jfs.pack_spawn_rows_slim(rows, f, cfg.dt) if slim
              else jfs.pack_spawn_rows(rows))
    pad = width - rows.valid.shape[0]
    return ([np.asarray(jnp.pad(r, (0, pad))) for r in packed],
            np.asarray(jnp.pad(rows.valid, (0, pad))), np.asarray(acc))


# --- 1. the spawn window ------------------------------------------------------

@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("layout", ["packed8", "slim"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_spawn_window_matches_jax(scene, layout, frame, salt):
    cfg = SCENES[scene]()
    slim = layout == "slim"
    nf = 7 if slim else 8
    table = tem.SpawnTable(cfg, "cpu")
    w = PackedEngine(cfg, alloc="ring", device="cpu").spawn_width
    accum = accum_of(cfg, 10 * frame + salt)
    # the frame as the engine holds it: a 0-dim int64 tensor
    frame_t = torch.tensor(frame, dtype=torch.int64)
    out = ek.spawn_window(cfg, table, torch.tensor(accum), frame_t, salt,
                          ek.new_window(nf, w, len(accum), "cpu"))
    jrows, jvalid, jacc = jax_window(scene, salt, accum, frame, slim, w)
    np.testing.assert_array_equal(out.valid.numpy(), jvalid)
    np.testing.assert_array_equal(out.accum.numpy(), jacc)
    assert out.rows.shape == (nf, w)
    for i, (a, b) in enumerate(zip(out.rows.numpy(), jrows, strict=True)):
        np.testing.assert_allclose(a, b, **SPAWN_TOL, err_msg=f"field {i}")
    assert not out.valid[max(1, table.total):].any()
    assert not out.rows[:, max(1, table.total):].any()
    if cfg.emitters:
        assert out.valid.any()


# --- 2. the ring write --------------------------------------------------------

RING_SLOTS, RING_WIDTH = 4096, 1024
RING_CASES = [(c, nv) for c in (0, RING_SLOTS // 2, RING_SLOTS - 400)
              for nv in (0, 819, RING_WIDTH)]


@pytest.mark.parametrize("cursor,n_valid", RING_CASES)
def test_ring_write_matches_jax(cursor, n_valid):
    rng = np.random.default_rng(cursor + n_valid)
    fields = [rng.uniform(-1.0, 1.0, RING_SLOTS + RING_WIDTH).astype(
        np.float32) for _ in range(8)]
    rows = rng.uniform(-4.0, 4.0, (8, RING_WIDTH)).astype(np.float32)
    valid = np.zeros(RING_WIDTH, bool)
    valid[rng.permutation(RING_WIDTH)[:n_valid]] = True
    tf = [torch.tensor(f) for f in fields]
    tc = torch.tensor(cursor, dtype=torch.int32)
    got = ek.ring_write(tf, torch.tensor(rows), torch.tensor(valid), tc,
                        RING_SLOTS)
    want, jc = jfs.ring_spawn(tuple(jnp.asarray(f) for f in fields),
                              tuple(jnp.asarray(r) for r in rows),
                              jnp.asarray(valid), jnp.int32(cursor),
                              RING_SLOTS)
    assert int(tc) == int(jc) == (cursor + n_valid) % RING_SLOTS
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"field {i}")
    if cursor + n_valid > RING_SLOTS:
        assert not any(f[RING_SLOTS:].any() for f in got)


# --- 3. the frame's bookkeeping -----------------------------------------------

@pytest.mark.parametrize("alloc,layout,refresh", [
    ("select", "packed8", 1), ("select", "slim", 1),
    ("strided", "packed8", 1), ("strided", "slim", 1),
    ("ring", "packed8", 1), ("ring", "slim", 1),
    ("exact", "packed8", 1), ("exact", "packed8", 4)])
def test_static_frame_equals_the_eager_frames(alloc, layout, refresh):
    """25 frames of ``step_many`` (the static frame: spawn window, physics,
    ring write, tail) against 25 ``_frame`` calls, every tensor bit for
    bit; the ring wraps (some 330 rows a frame into 4,096 slots)."""
    cfg = three_emitter_scene()
    rng = np.random.default_rng(5)
    n = cfg.slots
    life = rng.uniform(0.0, 1.0, n).astype(np.float32)
    init = (*rng.uniform(-2.0, 2.0, (6, n)).astype(np.float32),
            (life * rng.uniform(0.0, 1.2, n)).astype(np.float32), life)
    kw = dict(alloc=alloc, layout=layout, refresh_interval=refresh,
              device="cpu")
    eng, ref = PackedEngine(cfg, **kw), PackedEngine(cfg, **kw)
    got = eng.step_many(eng.init(init), 25)
    want = ref.init(init)
    for _ in range(25):
        want = ref._frame(want)
    assert got.frame == want.frame == 25 == int(eng._frame_t)
    for i, (a, b) in enumerate(zip(engine_state_to_numpy(got),
                                   engine_state_to_numpy(want),
                                   strict=True)):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
    assert eng.graphs.eager_frames == 25


# --- 4. the dispatch ----------------------------------------------------------

def test_cpu_takes_the_plain_versions_and_other_devices_raise(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path loaded the CUDA library")

    monkeypatch.setattr(cuda_build, "load_library", refuse)
    monkeypatch.setattr(cuda_build, "_entry", refuse)
    entries = ("ps_emitter_spawn", "ps_emitter_ring", "ps_emitter_tail")
    before = cuda_build.launches()
    cfg = three_emitter_scene()
    for alloc in ("select", "ring"):
        eng = PackedEngine(cfg, alloc=alloc, device="cpu")
        eng.step_many(eng.init(), 3)
    after = cuda_build.launches()
    assert all(after.get(k, 0) == before.get(k, 0) for k in entries)

    table = tem.SpawnTable(cfg, "cpu")
    meta = torch.device("meta")
    acc = torch.zeros(3, device=meta)
    with pytest.raises(ValueError, match="no emitter spawn kernel"):
        ek.spawn_window(cfg, table, acc, 0, 0,
                        ek.new_window(8, 1024, 3, meta))
    fields = [torch.zeros(2048, device=meta) for _ in range(8)]
    with pytest.raises(ValueError, match="no emitter ring kernel"):
        ek.ring_write(fields, torch.zeros((8, 1024), device=meta),
                      torch.zeros(1024, dtype=torch.bool, device=meta),
                      torch.zeros((), dtype=torch.int32, device=meta), 1024)
    with pytest.raises(ValueError, match="no emitter tail kernel"):
        ek.frame_tail(acc, acc.clone(),
                      torch.zeros((), dtype=torch.int32, device=meta),
                      torch.zeros((), dtype=torch.int64, device=meta), 0, 1)
    # the kernels' wrappers take CUDA tensors only; shapes are checked
    win = ek.new_window(8, 1024, 3, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ek.spawn_window_cuda(cfg, table, torch.zeros(3), 0, 0, win)
    with pytest.raises(ValueError, match="outgrow"):
        ek.spawn_window(cfg, table, torch.zeros(3), 0, 0,
                        ek.new_window(8, 256, 3, "cpu"))
    with pytest.raises(ValueError, match="ring fields"):
        ek.ring_write([torch.zeros(100)] * 8, win.rows, win.valid,
                      torch.zeros((), dtype=torch.int32), 1024)
    with pytest.raises(ValueError, match="CUDA"):
        ek.frame_tail_cuda(win.accum, win.accum.clone(),
                           torch.zeros((), dtype=torch.int32),
                           torch.zeros((), dtype=torch.int64), 0, 1)


# --- 5. on the card -----------------------------------------------------------

@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py phase 16 checks the "
                    "same on the card at full width)")
    dev = torch.device("cuda", 0)
    for name, make in SCENES.items():
        cfg = make()
        table = tem.SpawnTable(cfg, dev)
        w = PackedEngine(cfg, alloc="ring", device=dev).spawn_width
        accum = torch.tensor(accum_of(cfg, 1), device=dev)
        for nf in (8, 7):
            out = ek.new_window(nf, w, accum.numel(), dev)
            for frame in (0, 2 ** 31 - 1):
                f = torch.tensor(frame, dtype=torch.int64, device=dev)
                want = ek.spawn_window_plain(cfg, table, accum, f, 3, nf, w)
                got = ek.spawn_window_cuda(cfg, table, accum, f, 3, out)
                for a, b in zip(got, want):
                    assert torch.equal(a.cpu(), b.cpu()), (name, nf, frame)
    for cursor, n_valid in RING_CASES:
        g = torch.Generator().manual_seed(cursor + n_valid)
        fields = [torch.rand(RING_SLOTS + RING_WIDTH, generator=g).to(dev)
                  for _ in range(8)]
        rows = torch.rand((8, RING_WIDTH), generator=g).to(dev)
        valid = (torch.randperm(RING_WIDTH, generator=g) < n_valid).to(dev)
        c = torch.tensor(cursor, dtype=torch.int32, device=dev)
        want_f, want_c = [f.clone() for f in fields], c.clone()
        ek.ring_write_plain(want_f, rows, valid, want_c, RING_SLOTS)
        ek.ring_write_cuda(fields, rows, valid, c, RING_SLOTS)
        assert torch.equal(c, want_c)
        assert all(torch.equal(a, b) for a, b in zip(fields, want_f))
    acc, nxt = torch.rand(3, device=dev), torch.rand(3, device=dev)
    c = torch.tensor(RING_SLOTS - 1024, dtype=torch.int32, device=dev)
    f = torch.tensor(7, dtype=torch.int64, device=dev)
    want = [t.clone() for t in (acc, nxt, c, f)]
    ek.frame_tail_plain(*want, 1024, RING_SLOTS)
    ek.frame_tail_cuda(acc, nxt, c, f, 1024, RING_SLOTS)
    assert all(torch.equal(a, b) for a, b in zip((acc, nxt, c, f), want))
