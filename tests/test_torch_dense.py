"""The port's dense cell-pair pass against the JAX package, on the CPU.

``build_bins``, ``chunk_occupancy`` and ``stencil_cells`` must equal the
JAX package's exactly (values and integer dtypes); the dense
``neighbor_pass`` must give the same kill and touch flags exactly and
``acc`` within 1e-5 of max(1, max|acc|) (sums run in another order);
``step(impl="dense")`` follows the rule of tests/test_nbody_parity.py:
every event count and mask exact, floats by ``assert_close_chaotic``.
Inputs are JAX-package states after two frames, or numpy arrays from a
seed, handed to both packages.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesystem_tpu import GridSpec, NBodyConfig
from particlesystem_tpu.api import NBodySimulation as JNBodySimulation
from particlesystem_tpu.cpu_ref import oracle_nbody
from particlesystem_tpu.core.state import ParticleState as JParticleState
from particlesystem_tpu.cpu_ref.oracle_emitter import NpState
from particlesystem_tpu.models import nbody as jnbody
from particlesystem_tpu.ops import grid as jgrid
from particlesystem_tpu.ops import neighbor as jneighbor
from particlesystem_tpu_torch import GridSpec as TGridSpec
from particlesystem_tpu_torch import NBodyConfig as TNBodyConfig
from particlesystem_tpu_torch.api import NBodySimulation
from particlesystem_tpu_torch.core.state import state_to_numpy
from particlesystem_tpu_torch.models import nbody as tnbody
from particlesystem_tpu_torch.ops import grid as tgrid
from particlesystem_tpu_torch.ops import neighbor as tneighbor
from particlesystem_tpu_torch.ops import neighbor_blocks as tnbk

torch.set_num_threads(1)

# tests/test_neighbor_blocks.py:22-32
CONFIGS = {
    "dense-g4": NBodyConfig(n_fill=1500, capacity=2048,
                            grid=GridSpec(grid_dim=4, chunk_factor=2),
                            max_per_cell=48, seed=3),
    "sparse-g16": NBodyConfig(n_fill=800, capacity=1024,
                              grid=GridSpec(grid_dim=16),
                              particle_life=2.0, seed=7),
    "mid-g8": NBodyConfig(n_fill=6000, capacity=8192,
                          grid=GridSpec(grid_dim=8, chunk_factor=2),
                          seed=13),
}
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
EVENTS = ("n_collision_kills", "n_age_deaths", "n_survivals", "n_spawned",
          "n_overflow_kills")
ACC_TOL = 1e-5


def port_cfg(cfg):
    """The port's copy of a JAX-package config (same fields)."""
    d = dataclasses.asdict(cfg)
    return TNBodyConfig(**{**d, "grid": TGridSpec(**d["grid"])})


_FRAMES = {}


def frame_of(name):
    """(the state after two frames as a JAX-package state, its cell ids,
    the same state in the port, its cell ids) for a config of CONFIGS.  The
    two frames run in the port (tests/test_torch_nbody.py holds its step to
    the JAX package's)."""
    if name not in _FRAMES:
        cfg, tcfg = CONFIGS[name], port_cfg(CONFIGS[name])
        ts = tnbody.init_fill(tcfg, "cpu")
        for f in range(2):
            ts, _ = tnbody.step(ts, f, tcfg)
        js = JParticleState(**{k: jnp.asarray(v)
                               for k, v in state_to_numpy(ts).items()})
        jcell = jgrid.coords_to_cell(
            jgrid.wrap_positions(js.pos, cfg.grid)[1], cfg.grid)
        tcell = tgrid.coords_to_cell(
            tgrid.wrap_positions(ts.pos, tcfg.grid)[1], tcfg.grid)
        np.testing.assert_array_equal(tcell.numpy(), np.asarray(jcell))
        _FRAMES[name] = (js, jcell, ts, tcell)
    return _FRAMES[name]


def assert_same_array(got: torch.Tensor, want, what):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    np.testing.assert_array_equal(got, want, err_msg=what)


def assert_bins_equal(tb, jb, what):
    for field in jb._fields:
        assert_same_array(getattr(tb, field), getattr(jb, field),
                          f"{what} {field}")


# --- 1. binning ---------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_build_bins_matches_jax(name):
    cfg = CONFIGS[name]
    js, jcell, ts, tcell = frame_of(name)
    jb = jgrid.build_bins(jcell, js.alive, cfg.grid.num_cells,
                          cfg.cell_capacity)
    tb = tgrid.build_bins(tcell, ts.alive, cfg.grid.num_cells,
                          cfg.cell_capacity)
    assert_bins_equal(tb, jb, name)
    assert int(tb.n_listed_dropped) == 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_build_bins_narrow_lists_count_their_drops(name):
    """A ``list_width`` below the occupancy: rows past it are dropped from
    the lists and counted; who overflows does not change."""
    cfg = CONFIGS[name]
    js, jcell, ts, tcell = frame_of(name)
    occ = int(jgrid.build_bins(jcell, js.alive, cfg.grid.num_cells,
                               cfg.cell_capacity).max_cell_occupancy)
    width = max(1, occ // 2)
    jb = jgrid.build_bins(jcell, js.alive, cfg.grid.num_cells,
                          cfg.cell_capacity, list_width=width)
    tb = tgrid.build_bins(tcell, ts.alive, cfg.grid.num_cells,
                          cfg.cell_capacity, list_width=width)
    assert_bins_equal(tb, jb, name)
    assert tb.cell_list.shape == (cfg.grid.num_cells, width)
    assert int(tb.n_listed_dropped) > 0
    assert torch.equal(tb.overflow, tgrid.build_bins(
        tcell, ts.alive, cfg.grid.num_cells, cfg.cell_capacity).overflow)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_build_bins_cell_over_capacity_overflows(name):
    """A capacity below the occupancy: the rows of rank >= capacity
    overflow (the reference kills them)."""
    cfg = CONFIGS[name]
    js, jcell, ts, tcell = frame_of(name)
    occ = int(jgrid.build_bins(jcell, js.alive, cfg.grid.num_cells,
                               cfg.cell_capacity).max_cell_occupancy)
    cap = max(1, occ - 1)
    for width in (0, max(1, cap // 2)):
        jb = jgrid.build_bins(jcell, js.alive, cfg.grid.num_cells, cap,
                              list_width=width)
        tb = tgrid.build_bins(tcell, ts.alive, cfg.grid.num_cells, cap,
                              list_width=width)
        assert_bins_equal(tb, jb, f"{name} width {width}")
        assert int(tb.overflow.sum()) > 0
        assert int(tb.max_cell_occupancy) == occ


def test_build_bins_keeps_slot_order_within_a_cell():
    """20,000 rows in three cells: an unstable sort of the cell keys would
    scramble the lists; each must hold its cell's slots ascending."""
    rng = np.random.default_rng(11)
    n, num_cells, cap = 20_000, 5, 8192
    cell = rng.choice([0, 2, 4], size=n).astype(np.int32)
    alive = rng.random(n) < 0.9
    tb = tgrid.build_bins(torch.tensor(cell), torch.tensor(alive), num_cells,
                          cap)
    jb = jgrid.build_bins(jnp.asarray(cell), jnp.asarray(alive), num_cells,
                          cap)
    assert_bins_equal(tb, jb, "three cells")
    lists = tb.cell_list.numpy()
    for c in range(num_cells):
        want = np.flatnonzero(alive & (cell == c))
        assert int(tb.counts[c]) == len(want)
        np.testing.assert_array_equal(lists[c, :len(want)], want)
        assert (lists[c, len(want):] == -1).all()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_chunk_occupancy_matches_jax(name):
    cfg = CONFIGS[name]
    js, jcell, ts, tcell = frame_of(name)
    jkey = jnp.where(js.alive, jcell, cfg.grid.num_cells).astype(jnp.int32)
    tkey = torch.where(ts.alive, tcell, cfg.grid.num_cells).to(torch.int32)
    got = tgrid.chunk_occupancy(tkey, ts.alive, port_cfg(cfg).grid)
    want = np.asarray(jgrid.chunk_occupancy(jkey, js.alive, cfg.grid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (cfg.grid.chunk_factor ** 3,)
    assert int(got.sum()) == int(ts.alive.sum())


@pytest.mark.parametrize("coords", [(0, 0, 0), (3, 3, 3), (1, 2, 0),
                                    (0, 3, 2), (2, 1, 1)])
def test_stencil_cells_match_jax(coords):
    grid = GridSpec(grid_dim=4, chunk_factor=2)
    ids, valid = tgrid.stencil_cells(torch.tensor(coords, dtype=torch.int32),
                                     TGridSpec(grid_dim=4, chunk_factor=2))
    jids, jvalid = jgrid.stencil_cells(jnp.asarray(coords, jnp.int32), grid)
    assert_same_array(ids, jids, "ids")
    assert_same_array(valid, jvalid, "valid")
    np.testing.assert_array_equal(tgrid.STENCIL, jgrid.STENCIL)


# --- 2. the dense pass ----------------------------------------------------------

def assert_pass_equal(got, want, what):
    acc, kill, touch = (t.numpy() for t in got)
    jacc, jkill, jtouch = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(kill, jkill, err_msg=f"{what} kill")
    np.testing.assert_array_equal(touch, jtouch, err_msg=f"{what} touch")
    scale = max(1.0, float(np.abs(jacc).max()))
    err = float(np.abs(acc - jacc).max()) / scale
    assert err < ACC_TOL, f"{what}: acc error {err}"
    return int(jkill.sum()), int(jtouch.sum())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_neighbor_pass_matches_jax(name):
    cfg, tcfg = CONFIGS[name], port_cfg(CONFIGS[name])
    js, jcell, ts, tcell = frame_of(name)
    g = cfg.grid.grid_dim
    jb = jgrid.build_bins(jcell, js.alive, cfg.grid.num_cells,
                          cfg.cell_capacity)
    tb = tgrid.build_bins(tcell, ts.alive, cfg.grid.num_cells,
                          cfg.cell_capacity)
    want = jneighbor.neighbor_pass(
        js.pos, js.age, js.w, jnp.arange(js.slots, dtype=jnp.int32),
        jb.cell_list, (g, g, g), cfg,
        okeys=jneighbor.collision_okey(js.tag))
    ids = torch.arange(ts.slots, dtype=torch.int32)
    okeys = tneighbor.collision_okey(ts.tag)
    got = tneighbor.neighbor_pass(ts.pos, ts.age, ts.w, ids, tb.cell_list,
                                  (g, g, g), tcfg, okeys=okeys)
    _, touched = assert_pass_equal(got, want, name)
    if name != "sparse-g16":
        assert touched > 0
    # an explicit batch of 7 cells gives the same flags as the automatic one
    batched = tneighbor.neighbor_pass(ts.pos, ts.age, ts.w, ids,
                                      tb.cell_list, (g, g, g), tcfg,
                                      batch_cells=7, okeys=okeys)
    assert torch.equal(batched[1], got[1]) and torch.equal(batched[2], got[2])
    torch.testing.assert_close(batched[0], got[0], rtol=0, atol=0)


def test_neighbor_pass_non_cubic_dims_and_default_okeys():
    """dims (4, 2, 3), random rows; ``okeys`` left to default to ``ids``."""
    rng = np.random.default_rng(5)
    cfg = NBodyConfig(n_fill=10, capacity=1024)
    dims, n, cap = (4, 2, 3), 600, 64
    num_cells = dims[0] * dims[1] * dims[2]
    pos = rng.uniform(0.0, 4.0, (n, 3)).astype(np.float32)
    # ages straddle kid_age and particle_life; a few exact ties
    age = rng.uniform(0.0, 1.5 * cfg.particle_life, n).astype(np.float32)
    age[:20] = np.float32(cfg.kid_age)
    age[20:40] = np.float32(cfg.particle_life)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    cell = rng.integers(0, num_cells, n).astype(np.int32)
    alive = rng.random(n) < 0.9
    ids = rng.permutation(n).astype(np.int32)
    jb = jgrid.build_bins(jnp.asarray(cell), jnp.asarray(alive), num_cells,
                          cap)
    tb = tgrid.build_bins(torch.tensor(cell), torch.tensor(alive), num_cells,
                          cap)
    assert_bins_equal(tb, jb, "non-cubic")
    want = jneighbor.neighbor_pass(
        jnp.asarray(pos), jnp.asarray(age), jnp.asarray(w), jnp.asarray(ids),
        jb.cell_list, dims, cfg, batch_cells=5)
    got = tneighbor.neighbor_pass(
        torch.tensor(pos), torch.tensor(age), torch.tensor(w),
        torch.tensor(ids), tb.cell_list, dims, port_cfg(cfg), batch_cells=5)
    killed, touched = assert_pass_equal(got, want, "non-cubic")
    assert 0 < killed < touched
    with pytest.raises(ValueError, match="cells"):
        tneighbor.neighbor_pass(
            torch.tensor(pos), torch.tensor(age), torch.tensor(w),
            torch.tensor(ids), tb.cell_list, (4, 2, 2), port_cfg(cfg))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dense_pass_matches_blocks_pass(name):
    """The port's two passes on one frame: flags exact, acc to 1e-5."""
    tcfg = port_cfg(CONFIGS[name])
    _, _, ts, tcell = frame_of(name)
    tb = tgrid.build_bins(tcell, ts.alive, tcfg.grid.num_cells,
                          tcfg.cell_capacity)
    dense = tnbody._neighbor_pass(ts, tb.cell_list, tcfg)
    acc, kill, touch, overflow, max_occ, _, dropped = \
        tnbk.neighbor_pass_blocks(ts.pos, ts.age, ts.w, tcell, ts.alive,
                                  tcfg, ts.tag)
    assert int(dropped) == 0
    assert torch.equal(overflow, tb.overflow)
    assert int(max_occ) == int(tb.max_cell_occupancy)
    assert_pass_equal((acc, kill, touch), [t.numpy() for t in dense], name)


# --- 3. the frame ----------------------------------------------------------------

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


def test_dense_step_matches_jax_dense_step(list_width=64):
    """12 frames of DENSE against the JAX ``nbody.step(impl="dense")`` at
    the static ``list_width`` 64 (above the cell capacity's 48 rows, so
    nothing is dropped), every stat of ``NBodyStats`` compared."""
    cfg, tcfg = DENSE, port_cfg(DENSE)
    js = jnbody.init_fill(cfg)
    ts = tnbody.init_fill(tcfg, "cpu")
    events = dict.fromkeys(EVENTS, 0)
    for frame in range(12):
        js, jst = jnbody.step(js, jnp.int32(frame), cfg, list_width, "dense")
        ts, tst = tnbody.step(ts, frame, tcfg, impl="dense",
                              list_width=list_width)
        ref_stats = {f.name: getattr(jst, f.name)
                     for f in dataclasses.fields(jst)}
        check_frame(state_to_numpy(ts), vars(js), tst, ref_stats,
                    f"frame {frame}")
        for k in EVENTS:
            events[k] += int(getattr(tst, k))
    assert events["n_collision_kills"] > 0 and events["n_survivals"] > 0


def test_dense_step_matches_numpy_oracle():
    """30 frames of LIFECYCLE against ``cpu_ref/oracle_nbody.step``, fed
    the port's per-tag random fields."""
    cfg, tcfg = LIFECYCLE, port_cfg(LIFECYCLE)
    ts = tnbody.init_fill(tcfg, "cpu")
    ora = NpState(**state_to_numpy(ts))
    events = dict.fromkeys(EVENTS, 0)
    for frame in range(30):
        uvec, fert = tnbody.frame_fields(tcfg, frame, ts.tag)
        ts, tst = tnbody.step(ts, frame, tcfg, impl="dense")
        ora, ostats = oracle_nbody.step(ora, uvec.numpy(), fert.numpy(),
                                        frame, cfg)
        check_frame(state_to_numpy(ts), vars(ora), tst, ostats,
                    f"frame {frame}")
        for k in EVENTS:
            events[k] += int(getattr(tst, k))
    assert events["n_age_deaths"] > 0 and events["n_spawned"] > 0


def test_dense_step_on_active_prefix_and_unknown_impl():
    tcfg = port_cfg(LIFECYCLE)
    st = tnbody.compact_state(tnbody.init_fill(tcfg, "cpu"))
    full, fs = tnbody.step(st, 0, tcfg, impl="dense")
    head, hs = tnbody.step(st, 0, tcfg, impl="dense", active=1024)
    for k, v in vars(fs).items():
        assert int(v) == int(getattr(hs, k)), k
    a, b = state_to_numpy(full), state_to_numpy(head)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], f)
    with pytest.raises(ValueError, match="unknown neighbor pass"):
        tnbody.step(st, 0, tcfg, impl="sparse")
    with pytest.raises(ValueError, match="unknown neighbor pass"):
        NBodySimulation(tcfg, device="cpu", impl="sparse")


@pytest.mark.parametrize("occ", [0, 5, 44, 45, 100, 146, 200, 400, 500, 813,
                                 900])
def test_pick_width_matches_jax(occ):
    for cfg in (NBodyConfig(), DENSE):
        want = JNBodySimulation._pick_width(
            types.SimpleNamespace(BUCKETS=JNBodySimulation.BUCKETS, cfg=cfg),
            occ)
        got = NBodySimulation._pick_width(
            types.SimpleNamespace(BUCKETS=NBodySimulation.BUCKETS,
                                  cfg=port_cfg(cfg)), occ)
        assert got == want


@pytest.mark.parametrize("batch", [1, 4])
def test_simulation_dense_adapts_its_width_and_matches_blocks(batch):
    """``NBodySimulation(impl="dense")`` narrows its lists after the first
    frames and still gives the blocks run's events and masks."""
    tcfg = port_cfg(DENSE)
    dense = NBodySimulation(tcfg, device="cpu", impl="dense",
                            active_bucketing=False)
    blocks = NBodySimulation(tcfg, device="cpu", active_bucketing=False)
    assert dense.adaptive_width and not blocks.adaptive_width
    assert dense._width == 0
    dense.run(8, batch=batch)
    blocks.run(8, batch=batch)
    assert dense._width == dense._pick_width(
        int(dense.last_stats.max_cell_occupancy)) != 0
    assert dense.n_degraded_frames == 0
    for k in EVENTS + ("n_alive", "n_listed_dropped", "max_cell_occupancy"):
        assert int(getattr(dense.last_stats, k)) == \
            int(getattr(blocks.last_stats, k)), k
    a, b = state_to_numpy(dense.state), state_to_numpy(blocks.state)
    for f in ("alive", "parent", "tag"):
        np.testing.assert_array_equal(a[f], b[f], f)
    assert_close_chaotic(a["pos"], b["pos"], "pos")


def test_simulation_dense_redoes_a_truncated_frame_at_full_width():
    """A width forced below the occupancy drops rows: the simulation redoes
    the frame (and the batch) at full width and keeps no degraded frame."""
    tcfg = port_cfg(DENSE)
    ref = NBodySimulation(tcfg, device="cpu", impl="dense",
                          adaptive_width=False, active_bucketing=False)
    ref.run(2, batch=1)
    for batch in (1, 2):
        sim = NBodySimulation(tcfg, device="cpu", impl="dense",
                              active_bucketing=False)
        sim._width = 8
        sim.run(2, batch=batch)
        assert sim.n_degraded_frames == 0
        a, b = state_to_numpy(sim.state), state_to_numpy(ref.state)
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], f"batch {batch} {f}")
