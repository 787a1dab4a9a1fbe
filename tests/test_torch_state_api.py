"""Two small accessors of the port against their JAX counterparts:
``EngineState.packed`` (``particlesystem_tpu/runtime/engine.py:85``) and
``ParticleState.num_alive`` (``particlesystem_tpu/core/state.py:71``), on
the same state carried across as numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import particlesystem_tpu.core.config as jconfig
import particlesystem_tpu_torch.core.config as tconfig
from particlesystem_tpu.core.state import ParticleState as JParticleState
from particlesystem_tpu.models import nbody as jnbody
from particlesystem_tpu.runtime.engine import PackedEngine as JEngine
from particlesystem_tpu_torch.core.state import FIELDS, state_from_numpy
from particlesystem_tpu_torch.runtime.engine import (PackedEngine as TEngine,
                                                     engine_state_from_numpy)

torch.set_num_threads(1)


def scene(m):
    return m.EmitterSceneConfig(
        capacity=4096, emitters=(m.Emitter(rate=600.0),),
        planes=(m.PlaneCollider(),))


def test_engine_state_packed_matches_jax():
    rng = np.random.default_rng(3)
    fields = tuple(rng.uniform(-2.0, 2.0, 4096).astype(np.float32)
                   for _ in range(8))
    jes = JEngine(scene(jconfig), alloc="ring").init(fields)
    jes = JEngine(scene(jconfig), alloc="ring").step(jes)
    tes = engine_state_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(jes)],
        TEngine(scene(tconfig), alloc="ring", device="cpu"))
    got = tes.packed
    assert tuple(got.shape) == (8, 4096 + 1024)  # the ring's shadow rows
    np.testing.assert_array_equal(got.numpy(), np.asarray(jes.packed))


def test_particle_state_num_alive_matches_jax():
    js = jnbody.init_fill(jconfig.NBodyConfig(
        n_fill=3000, grid=jconfig.GridSpec(grid_dim=8)))
    alive = np.asarray(js.alive).copy()
    alive[::7] = False  # dead rows among the live ones
    js = JParticleState(**{f: getattr(js, f) for f in FIELDS
                           if f != "alive"}, alive=jnp.asarray(alive))
    ts = state_from_numpy({f: np.asarray(getattr(js, f)) for f in FIELDS},
                          "cpu")
    got = ts.num_alive
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(js.num_alive) == int(alive.sum())
