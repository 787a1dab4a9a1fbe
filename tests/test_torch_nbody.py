"""The port's n-body frame against the JAX package and the numpy oracle.

Discrete lifecycle outcomes (every ``NBodyStats`` event count, the alive
and parent masks) must match exactly; float trajectories follow the
``assert_close_chaotic`` rule of tests/test_nbody_parity.py.  The port runs
on the CPU, where its cluster-pair kernel takes the plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesystem_tpu import GridSpec, NBodyConfig
from particlesystem_tpu.cpu_ref import oracle_nbody
from particlesystem_tpu.cpu_ref.oracle_emitter import NpState
from particlesystem_tpu.models import nbody as jnbody
from particlesystem_tpu_torch import GridSpec as TGridSpec
from particlesystem_tpu_torch import NBodyConfig as TNBodyConfig
from particlesystem_tpu_torch.api import NBodySimulation
from particlesystem_tpu_torch.core.state import FIELDS, state_to_numpy
from particlesystem_tpu_torch.models import nbody as tnbody

torch.set_num_threads(1)

# tests/test_nbody_parity.py:22-31
DENSE = NBodyConfig(
    n_fill=2000, capacity=4096, grid=GridSpec(grid_dim=4, cell_size=5.0,
                                              chunk_factor=2),
    max_per_cell=48, seed=3,
)
LIFECYCLE = NBodyConfig(
    n_fill=500, capacity=2048, grid=GridSpec(grid_dim=8, cell_size=5.0,
                                             chunk_factor=2),
    particle_life=2.0, seed=5,
)
# tests/test_active_prefix.py:19-21
PREFIX = NBodyConfig(n_fill=3000, capacity=8192,
                     grid=GridSpec(grid_dim=8, chunk_factor=2),
                     particle_life=2.0, spawn_budget=1024, seed=5)
EVENTS = ("n_collision_kills", "n_age_deaths", "n_survivals", "n_spawned",
          "n_overflow_kills")


def port_cfg(cfg):
    """The port's copy of a JAX-package config (same fields)."""
    d = dataclasses.asdict(cfg)
    return TNBodyConfig(**{**d, "grid": TGridSpec(**d["grid"])})


def assert_close_chaotic(a, b, msg):
    """tests/test_nbody_parity.py:69-78: 99.5% of elements within tight
    tolerance and all within a loose absolute bound."""
    err = np.abs(a - b)
    tol = 1e-3 + 1e-2 * np.abs(b)
    frac_bad = float(np.mean(err > tol))
    assert frac_bad <= 0.005, f"{msg}: {frac_bad:.2%} elements out of tolerance"
    assert float(err.max()) < 0.25, f"{msg}: max abs err {err.max()}"


def check_frame(port, ref, stats, ref_stats, msg):
    for k, v in ref_stats.items():
        assert int(getattr(stats, k)) == int(v), f"{msg}: {k}"
    for f in ("alive", "parent"):
        np.testing.assert_array_equal(port[f], np.asarray(ref[f]),
                                      err_msg=f"{msg} {f}")
    for f in ("pos", "vel", "age", "life", "w"):
        assert_close_chaotic(port[f], np.asarray(ref[f]), f"{msg} {f}")


@pytest.mark.parametrize("n", [0, 1, 1001])
def test_init_fill_matches_jax_at_the_edge_counts(n):
    """The CPU fill (the fill kernel's plain version) at no particle, one,
    and every slot of a capacity that is no multiple of four."""
    cfg = NBodyConfig(n_fill=700, capacity=1001, seed=11,
                      grid=GridSpec(grid_dim=4, cell_size=5.0,
                                    chunk_factor=2))
    js = jnbody.init_fill(cfg, n)
    ts = state_to_numpy(tnbody.init_fill(port_cfg(cfg), "cpu", n))
    for f in FIELDS:
        want = np.asarray(getattr(js, f))
        assert ts[f].dtype == want.dtype, f
        np.testing.assert_array_equal(ts[f], want, err_msg=f)


def test_step_matches_jax_blocks_step():
    """12 frames of DENSE against the JAX ``nbody.step(impl="blocks")``,
    every stat of ``NBodyStats`` compared."""
    cfg, tcfg = DENSE, port_cfg(DENSE)
    js = jnbody.init_fill(cfg)
    ts = tnbody.init_fill(tcfg, "cpu")
    events = dict.fromkeys(EVENTS, 0)
    for frame in range(12):
        js, jst = jnbody.step(js, jnp.int32(frame), cfg, 0, "blocks")
        ts, tst = tnbody.step(ts, frame, tcfg)
        ref_stats = {f.name: getattr(jst, f.name)
                     for f in dataclasses.fields(jst)}
        check_frame(state_to_numpy(ts), vars(js), tst, ref_stats,
                    f"frame {frame}")
        for k in EVENTS:
            events[k] += int(getattr(tst, k))
    assert events["n_collision_kills"] > 0 and events["n_survivals"] > 0


def test_step_matches_numpy_oracle():
    """50 frames of LIFECYCLE against ``cpu_ref/oracle_nbody.step``, fed
    the port's per-tag random fields."""
    cfg, tcfg = LIFECYCLE, port_cfg(LIFECYCLE)
    ts = tnbody.init_fill(tcfg, "cpu")
    ora = NpState(**state_to_numpy(ts))
    events = dict.fromkeys(EVENTS, 0)
    for frame in range(50):
        uvec, fert = tnbody.frame_fields(tcfg, frame, ts.tag)
        ts, tst = tnbody.step(ts, frame, tcfg)
        ora, ostats = oracle_nbody.step(ora, uvec.numpy(), fert.numpy(),
                                        frame, cfg)
        check_frame(state_to_numpy(ts), vars(ora), tst, ostats,
                    f"frame {frame}")
        for k in EVENTS:
            events[k] += int(getattr(tst, k))
    assert events["n_age_deaths"] > 0 and events["n_spawned"] > 0


def warmed(frames=4):
    tcfg = port_cfg(PREFIX)
    st = tnbody.init_fill(tcfg, "cpu")
    for f in range(frames):
        st, _ = tnbody.step(st, f, tcfg)
    return st, frames


def test_compact_state_is_stable_partition():
    st, _ = warmed()
    cs = state_to_numpy(tnbody.compact_state(st))
    ref = state_to_numpy(st)
    alive = ref["alive"]
    na = alive.sum()
    assert cs["alive"][:na].all() and not cs["alive"][na:].any()
    order = np.concatenate([np.flatnonzero(alive), np.flatnonzero(~alive)])
    for f in FIELDS:
        np.testing.assert_array_equal(cs[f], ref[f][order], f)


def test_active_prefix_bit_identical_to_full_width():
    """tests/test_active_prefix.py:62: after ``compact_state``,
    ``step(active=...)`` gives the full-width frames bit for bit."""
    tcfg = port_cfg(PREFIX)
    st, f0 = warmed()
    st = tnbody.compact_state(st)
    active = 4096
    assert int(st.alive.sum()) + tcfg.max_spawns_per_frame < active
    full = buck = st
    for f in range(f0, f0 + 4):
        full, fs = tnbody.step(full, f, tcfg)
        buck, bs = tnbody.step(buck, f, tcfg, active=active)
        assert int(bs.n_tail_alive) == 0
        for k, v in vars(fs).items():
            assert int(v) == int(getattr(bs, k)), (f, k)
        a, b = state_to_numpy(full), state_to_numpy(buck)
        for fld in FIELDS:
            np.testing.assert_array_equal(a[fld], b[fld], f"frame {f} {fld}")


def reference_run(cfg, frames, compact_after=None):
    """``frames`` full-width steps, compacting after frame ``compact_after``
    (full width after compaction is bit-identical to the active prefix,
    see test_active_prefix_bit_identical_to_full_width)."""
    st = tnbody.init_fill(cfg, "cpu")
    for f in range(frames):
        if f == compact_after:
            st = tnbody.compact_state(st)
        st, stats = tnbody.step(st, f, cfg)
    return st, stats


def assert_run_matches(sim, ref, ref_stats):
    # the driver may compact again after its last batch; compaction is
    # idempotent, so compare both sides compacted
    s = state_to_numpy(tnbody.compact_state(sim.state))
    ref = state_to_numpy(tnbody.compact_state(ref))
    for f in FIELDS:
        np.testing.assert_array_equal(s[f], ref[f], f)
    for k, v in vars(ref_stats).items():
        assert int(v) == int(getattr(sim.last_stats, k)), k
    assert sim.n_degraded_frames == 0


def test_simulation_run_batched_with_bucketing(monkeypatch):
    """``run()`` auto-batches (batch=0): 4 frames at full width, then the
    batch-end bucketing compacts alive rows forward and the next 4 frames
    run on the active prefix."""
    monkeypatch.setattr(NBodySimulation, "ACTIVE_QUANTUM", 1024)
    cfg = port_cfg(PREFIX)
    sim = NBodySimulation(cfg, device="cpu")
    sim.run(4)
    assert 0 < sim._active < cfg.slots
    sim.run(4)
    assert sim.frame == 8
    assert_run_matches(sim, *reference_run(cfg, 8, compact_after=4))


def test_simulation_run_per_frame():
    """``run(batch=1)`` reads each frame's stats; same frames as the step
    loop."""
    cfg = port_cfg(PREFIX)
    sim = NBodySimulation(cfg, device="cpu", active_bucketing=False)
    sim.run(6, batch=1)
    assert sim.frame == 6
    assert_run_matches(sim, *reference_run(cfg, 6))
