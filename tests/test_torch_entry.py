"""The port's entry functions (``particlesystem_tpu_torch/entry.py``)
against the JAX package's ``__graft_entry__.py``, on the CPU.

* ``entry(device="cpu")``: two frames, each from the JAX frame's input
  state carried across as numpy; bookkeeping and alive masks exact, fields
  within ``rtol = atol = 1e-5``, the one-step tolerance of
  ``tests/test_torch_emitter.py`` (``tests/test_pallas_step.py:73``).
* ``dryrun_multichip(8, device="cpu")``: slab, pencil and brick on 8 gloo
  ranks in one spawn; each one's frame-0 events equal the JAX
  single-device frame 0 on the same config, with no spawn capped and no
  cell over its cap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from particlesystem_tpu.core.config import GridSpec as JGridSpec
from particlesystem_tpu.core.config import NBodyConfig as JNBodyConfig
from particlesystem_tpu.models import nbody as jnbody
from particlesystem_tpu_torch import entry as tentry
from particlesystem_tpu_torch.runtime.engine import (
    engine_state_from_numpy, engine_state_to_numpy)

torch.set_num_threads(1)

STEP_TOL = dict(rtol=1e-5, atol=1e-5)
EVENTS = ("n_alive", "n_age_deaths", "n_collision_kills", "n_survivals",
          "n_spawned")


def _alive(fields):
    age, life = fields[6], fields[7]
    return (age <= life) & (life > 0)


def test_entry_frame_matches_jax():
    jfn, (jes,) = jentry.entry()
    jfn = jax.jit(jfn)
    fn, (es,) = tentry.entry(device="cpu")
    assert es.fields[0].device.type == "cpu"
    nf = es.n_fields
    for frame in range(2):
        leaves = [np.asarray(x) for x in jax.tree.leaves(jes)]
        if frame:  # the port's frame from the JAX frame's input state
            es = engine_state_from_numpy(leaves, es)
        else:  # both engines start from the same empty state
            got0 = engine_state_to_numpy(es)
            for a, b in zip(got0, leaves):
                np.testing.assert_array_equal(a, b)
        jes = jfn(jes)
        es = fn(es)
        want = [np.asarray(x) for x in jax.tree.leaves(jes)]
        got = engine_state_to_numpy(es)
        np.testing.assert_array_equal(_alive(got[:nf]), _alive(want[:nf]))
        for a, b in zip(got[nf:], want[nf:]):  # accum, free list, cursor...
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got[:nf], want[:nf]):
            np.testing.assert_allclose(a, b, **STEP_TOL)
    assert _alive(got[:nf]).sum() > 0


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.dryrun_multichip(8)


def _jax_events(cfg):
    jcfg = JNBodyConfig(
        n_fill=cfg.n_fill, capacity=cfg.capacity,
        grid=JGridSpec(grid_dim=cfg.grid.grid_dim,
                       cell_size=cfg.grid.cell_size,
                       chunk_factor=cfg.grid.chunk_factor),
        max_per_cell=cfg.max_per_cell, seed=cfg.seed)
    s = jnbody.init_fill(jcfg)
    step = jax.jit(lambda s, f: jnbody.step(s, f, jcfg))
    _, st = step(s, jnp.int32(0))
    return {k: int(getattr(st, k)) for k in EVENTS}, jcfg.cell_capacity


@pytest.fixture(scope="module")
def dryrun():
    return tentry.dryrun_multichip(8, device="cpu")


@pytest.mark.parametrize("name", ["slab", "pencil", "brick"])
def test_dryrun_frame0_matches_jax_single_device(name, dryrun):
    cfg, _ = tentry.dryrun_specs(8)[name]
    stats = dryrun[name]
    want, cap = _jax_events(cfg)
    assert {k: stats[k] for k in EVENTS} == want
    assert stats["n_alive"] > 0
    assert stats["n_spawn_capped"] == 0
    assert stats["max_cell_occupancy"] <= cap
    assert stats["halo_dropped"] == stats["migration_dropped"] == 0
    assert stats["pair_launches"] == 0  # the plain version on the CPU


def test_dryrun_covers_what_the_rank_count_allows():
    assert list(tentry.dryrun_specs(8)) == ["slab", "pencil", "brick"]
    assert list(tentry.dryrun_specs(6)) == ["slab", "pencil"]
    assert list(tentry.dryrun_specs(2)) == ["slab"]
