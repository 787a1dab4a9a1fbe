"""The decomposed n-body frame on the frame kernels D and E
(``parallel/nbody_sharded.blocks_lifecycle``) and the distributed driver's
frame loop (``parallel/driver.DistributedNBodySimulation``), on the CPU,
where every kernel takes its plain version.  Rules, each with its source:

* a rank's blocks frame on its halo-extended rows (its slots, its
  neighbours' boundary planes, -1-id padding; ``tools/frame_states.
  slab_case``) against the JAX package's ``neighbor_pass_blocks`` over the
  same rows (``dims``, ``ids``; jitted with the direct sum
  ``acc_mxu=False``, as tests/test_torch_parallel.py runs it) and its
  ``lifecycle_update`` on the rank's slots, op by op: masks, tags and
  counts exact; ``acc`` within 1e-5 of max(1, max|acc|)
  (tests/test_neighbor_blocks.py:79), ``vel`` and ``pos`` within what that
  error moves them in one step (dt and dt^2/2 of it) and one ulp of the
  value; and bit for bit the port's earlier composition of the same frame
  (``neighbor_blocks.neighbor_pass_blocks`` + ``models/nbody.
  lifecycle_update``);
* D over a pass of as many rows as slots is what it was: on the edge
  states of ``tools/frame_states.py``, D over the pass with junk rows
  appended (read through the same ``inv``) gives the same bits, and D
  without chunk counters gives the same counts and leaves
  ``max_chunk_occupancy`` alone;
* the driver on a mesh of one rank: ``run(k, batch=k)`` bit for bit ``k``
  calls of ``run(1, batch=1)`` and the single-device step (state,
  statistics, frame counter), drops summed and marks maxed over every
  frame of a batch; ``profile_frame`` leaves the state as it found it;
  which meshes take frame graphs is pinned.

The ``cuda``-marked test holds D over a slab pass to its plain version on
the card (it skips here).
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import particlesystem_tpu.ops.neighbor_blocks as jnbk
from particlesystem_tpu import GridSpec, NBodyConfig
from particlesystem_tpu.core.state import ParticleState as JState
from particlesystem_tpu.models import nbody as jnbody
from particlesystem_tpu.ops import grid as jgrid
from particlesystem_tpu_torch import GridSpec as TGridSpec
from particlesystem_tpu_torch import NBodyConfig as TNBodyConfig
from particlesystem_tpu_torch.core.state import FIELDS, state_to_numpy
from particlesystem_tpu_torch.models import nbody as tnbody
from particlesystem_tpu_torch.ops import frame_kernels as fk
from particlesystem_tpu_torch.ops import grid as tgrid
from particlesystem_tpu_torch.ops import neighbor_blocks as tnbk
from particlesystem_tpu_torch.parallel import SlabSpec, driver
from particlesystem_tpu_torch.parallel import nbody_sharded as ns
from particlesystem_tpu_torch.parallel.driver import (
    DistributedNBodySimulation, graph_frames)
from particlesystem_tpu_torch.parallel.mesh import free_port
from particlesystem_tpu_torch.tools import frame_states as fs

torch.set_num_threads(1)

# tests/test_torch_parallel.py's PLANES: 20,000 particles on 16^3
SLAB = NBodyConfig(n_fill=20_000, capacity=32768,
                   grid=GridSpec(grid_dim=16), seed=3)
RANKS, HALO, FRAME = 4, 1500, 2
# tests/test_sharded_nbody.py:17-22 at half its particles and slots
SMALL = NBodyConfig(n_fill=1500, capacity=4096,
                    grid=GridSpec(grid_dim=16, cell_size=5.0,
                                  chunk_factor=4),
                    particle_life=3.0, seed=11)
ACC_TOL = 1e-5


def port_cfg(cfg):
    d = dataclasses.asdict(cfg)
    return TNBodyConfig(**{**d, "grid": TGridSpec(**d["grid"])})


@functools.lru_cache(maxsize=None)
def slab_state():
    """The global state of SLAB after two frames (kids, dead slots and
    children in it)."""
    cfg = port_cfg(SLAB)
    s = tnbody.init_fill(cfg, "cpu")
    for f in range(FRAME):
        s, _ = tnbody.step(s, f, cfg, impl="dense")
    return s


def slab_case(rank):
    return fs.slab_case(port_cfg(SLAB), slab_state(), RANKS, rank, HALO,
                        FRAME)


@functools.lru_cache(maxsize=None)
def jax_pass(rank):
    """The JAX package's ``neighbor_pass_blocks`` over the rank's padded
    rows, numpy."""
    case = slab_case(rank)
    rows, cell, valid = ns.pad_rows(case.rows, case.cell, case.valid)
    fn = jax.jit(functools.partial(jnbk.neighbor_pass_blocks, cfg=SLAB,
                                   dims=case.dims, acc_mxu=False))
    out = fn(*(jnp.asarray(a.numpy()) for a in (rows.pos, rows.age, rows.w,
                                                 cell, valid)),
             ids=jnp.asarray(rows.ids.numpy()),
             tags=jnp.asarray(rows.tags.numpy().astype(np.uint32)))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("rank", [0, 1])
def test_slab_pass_matches_jax_and_the_earlier_composition(rank):
    """Rank 0 has no halo below it (the edge), rank 1 one on each side;
    both passes carry -1-id padding rows."""
    case = slab_case(rank)
    cfg, st = case.cfg, case.state
    n = st.slots
    rows, cell, valid = ns.pad_rows(case.rows, case.cell, case.valid)
    assert rows.pos.shape[0] > n + 2 * HALO and (rows.ids == -1).any()
    assert valid[n:].sum() > 500 and (rank == 0) == (
        not valid[n:n + HALO].any())
    uvec, fert = tnbody.frame_fields(cfg, FRAME, st.tag)

    got = st.map(lambda a: a.clone())
    stats = fs.stats_dict(ns.blocks_lifecycle(
        got, case.rows, case.cell, case.valid, case.dims, uvec, fert, FRAME,
        cfg))
    assert stats["max_chunk_occupancy"] == 0

    # the port's earlier composition, bit for bit
    acc, kill, touch, ovf, max_occ, _, dropped = tnbk.neighbor_pass_blocks(
        rows.pos, rows.age, rows.w, cell, valid, cfg, rows.tags,
        dims=case.dims, ids=rows.ids)
    pos_w, _ = tgrid.wrap_positions(st.pos, cfg.grid)
    before, counts = tnbody.lifecycle_update(
        st, pos_w, ovf[:n], acc[:n], kill[:n], touch[:n], uvec, fert, FRAME,
        cfg)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(before, f)), f
    for k, v in counts.items():
        assert stats[k] == int(v), k
    assert stats["max_cell_occupancy"] == int(max_occ)
    assert stats["n_listed_dropped"] == int(dropped) == 0
    assert min(stats["n_collision_kills"], stats["n_survivals"],
               stats["n_spawned"]) > 0, stats

    # the JAX package: its pass over the same rows, its lifecycle on the
    # rank's slots
    jacc, jkill, jtouch, jovf, jmax, _, jdrop = jax_pass(rank)
    a = acc.numpy()
    err = np.abs(a - jacc).max() / max(1.0, np.abs(jacc).max())
    assert err < ACC_TOL
    for k, x, y in (("kill", kill, jkill), ("touch", touch, jtouch),
                    ("overflow", ovf, jovf)):
        np.testing.assert_array_equal(x.numpy(), y, err_msg=k)
    assert int(jmax) == int(max_occ) and int(jdrop) == 0
    host = state_to_numpy(st)
    js = JState(**{k: jnp.asarray(v) for k, v in host.items()})
    jcfg = SLAB
    with jax.disable_jit():
        jpos_w, _ = jgrid.wrap_positions(js.pos, jcfg.grid)
        jout, jcounts = jnbody.lifecycle_update(
            js, jpos_w, jnp.asarray(jovf[:n]), jnp.asarray(jacc[:n]),
            jnp.asarray(jkill[:n]), jnp.asarray(jtouch[:n]),
            jnp.asarray(uvec.numpy()), jnp.asarray(fert.numpy()),
            jnp.int32(FRAME), jcfg)
    mine = state_to_numpy(got)
    for k, v in jcounts.items():
        assert stats[k] == int(v), k
    for f in ("alive", "parent", "tag", "w", "life", "age"):
        np.testing.assert_array_equal(mine[f], np.asarray(getattr(jout, f)),
                                      err_msg=f)
    scale = ACC_TOL * max(1.0, float(np.abs(jacc).max()))
    dt = np.float32(cfg.dt)
    for f, moved in (("acc", scale), ("vel", dt * scale),
                     ("pos", 0.5 * dt * dt * scale)):
        want = np.asarray(getattr(jout, f))
        tol = moved + np.spacing(np.abs(want))
        assert (np.abs(mine[f] - want) <= tol).all(), f


STATES = {c.name: c for c in fs.edge_states("cpu")}


@pytest.mark.parametrize("name", sorted(STATES))
def test_lifecycle_over_as_many_rows_as_slots_is_unchanged(name):
    case = STATES[name]
    cfg, st = case.cfg, case.state
    key, rec = fk.nbody_cells(st.pos, st.alive, st.age, st.w, st.tag,
                              cfg.grid)
    p = fk.sort_and_prepare(key, rec, cfg, case.c_max or tnbk.C_MAX,
                            tnbk.CH, tnbk.B, grid=cfg.grid)
    acc_s, gmax_s = tnbk.kernel_call(cfg, p.snap, p.chunks)
    uvec, _ = tnbody.frame_fields(cfg, case.frame, st.tag)
    junk = 1000
    rng = np.random.default_rng(1)
    longer = (torch.cat([acc_s, torch.from_numpy(rng.normal(
                  size=(3, junk)).astype(np.float32))], dim=1),
              torch.cat([gmax_s, torch.from_numpy(rng.integers(
                  -2 ** 31, 2 ** 31, junk).astype(np.int32))]),
              torch.cat([p.overflow_s, torch.ones(junk, dtype=torch.bool)]),
              torch.cat([p.inv, torch.arange(junk, dtype=torch.int32)]))
    runs = []
    for args, stats in (((acc_s, gmax_s, p.overflow_s, p.inv),
                         p.stats.clone()),
                        (longer, p.stats.clone()),
                        ((acc_s, gmax_s, p.overflow_s, p.inv),
                         fk.new_stats("cpu"))):
        if stats.shape[0] == len(fk.STATS):
            stats += p.stats[:len(fk.STATS)]
        out = st.map(torch.empty_like)
        flags, tiles = fk.nbody_lifecycle(st, out, *args[:3], args[3], uvec,
                                          cfg, stats)
        runs.append((out, flags, tiles, stats))
    (a, fa, ta, sa), (b, fb, tb, sb), (c, fc, tc, sc) = runs
    for f in FIELDS:
        for other in (b, c):
            assert torch.equal(getattr(a, f).view(torch.uint8),
                               getattr(other, f).view(torch.uint8)), f
    for x, y in ((fa, fb), (ta, tb), (fa, fc), (ta, tc), (sa, sb)):
        assert torch.equal(x, y)
    chunk = fk.STAT["max_chunk_occupancy"]
    assert int(sc[chunk]) == 0 < int(sa[chunk])
    keep = [i for i in range(len(fk.STATS)) if i != chunk]
    assert torch.equal(sc[keep], sa[keep])


def test_lifecycle_refuses_a_short_pass_and_odd_counters():
    case = STATES["tags"]
    cfg, st = case.cfg, case.state
    n = st.slots
    with pytest.raises(ValueError, match="chunk counters"):
        fk.stats_chunks(fk.new_stats("cpu", 3), cfg.grid)
    assert fk.stats_chunks(fk.new_stats("cpu"), cfg.grid) == 0
    assert fk.stats_chunks(fk.new_stats("cpu", cfg.grid.num_chunks),
                           cfg.grid) == cfg.grid.num_chunks
    with pytest.raises(ValueError, match=f"{n - 1} rows for {n} slots"):
        fk.nbody_lifecycle(
            st, st.map(torch.empty_like), torch.zeros(3, n - 1),
            torch.zeros(n - 1, dtype=torch.int32),
            torch.zeros(n - 1, dtype=torch.bool),
            torch.zeros(n, dtype=torch.int32), torch.zeros(n, 3), cfg,
            fk.new_stats("cpu"))


# --- the driver's frame loop ------------------------------------------------


def _drops_by_frame(monkeypatch):
    """Make the driver's step report drops and marks that change with the
    frame (so a batch's sums and maxima differ from its last frame's)."""
    inner = driver.make_step

    def make_step(*a, **k):
        step = inner(*a, **k)

        def stepping(state, frame):
            out, stats = step(state, frame)
            f = torch.as_tensor(frame, dtype=torch.int64)
            return out, dict(stats, halo_dropped=f % 2,
                             n_listed_dropped=f % 3,
                             halo_used_max=(7 * f) % 5,
                             migration_used_max=(3 * f) % 4)
        return stepping

    monkeypatch.setattr(driver, "make_step", make_step)


def _sim(cfg, **kw):
    return DistributedNBodySimulation(cfg, SlabSpec(1, impl="blocks"),
                                      device="cpu", **kw)


def test_batch_is_its_frames_and_the_single_device_step(monkeypatch):
    _drops_by_frame(monkeypatch)
    cfg, k = port_cfg(SMALL), 4
    a, b = _sim(cfg), _sim(cfg)
    start = a.state.map(lambda t: t.clone())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        whole = a.run(k, batch=k)
        frames = [b.run(1, batch=1) for _ in range(k)]
    assert a.frame == b.frame == k
    for f in FIELDS:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    sums = ("halo_dropped", "n_listed_dropped", "migration_dropped")
    marks = ("halo_used_max", "migration_used_max")
    for key in whole:
        if key in sums:
            want = sum(s[key] for s in frames)
        elif key in marks:
            want = max(s[key] for s in frames)
        else:
            want = frames[-1][key]
        assert whole[key] == want, key
    assert whole["halo_dropped"] == 2 and whole["halo_used_max"] == 4
    assert a.n_degraded_frames == 1 and b.n_degraded_frames == 3
    # the loop is one key's eager frames on the CPU
    assert a.graphs.keys == b.graphs.keys == ["frame"]
    assert a.graphs.eager_frames == b.graphs.eager_frames == k
    assert a.graphs.replays == a.graphs.captures == 0
    # and the single-device step from the same arrangement
    ref = start
    for frame in range(k):
        ref, stats = tnbody.step(ref, frame, cfg)
    for f in FIELDS:
        assert torch.equal(getattr(a.state, f), getattr(ref, f)), f
    for key in ns.COUNTS + ("n_alive", "max_cell_occupancy"):
        assert whole[key] == int(getattr(stats, key)), key


def test_profile_frame_and_an_assigned_state():
    """``profile_frame`` times the loop and puts the state back; a state
    assigned to ``state`` (as ``load`` does) is copied into the loop's
    at the next batch."""
    cfg = port_cfg(SMALL)
    sim, twin = _sim(cfg), _sim(cfg)
    sim.run(2, batch=2)
    twin.run(2, batch=2)
    before = sim.state
    kept = state_to_numpy(sim.state)
    out = sim.profile_frame(k1=1, k2=2, reps=1)
    assert list(out) == ["full_frame"] and sim.frame == 2
    assert sim.state is before
    for f in FIELDS:
        np.testing.assert_array_equal(state_to_numpy(sim.state)[f], kept[f])
    sim.state = sim.state.map(lambda t: t.clone())
    assert sim.run(2, batch=1) == twin.run(2, batch=1)
    assert sim.state is before
    for f in FIELDS:
        assert torch.equal(getattr(sim.state, f), getattr(twin.state, f)), f


def test_which_meshes_take_frame_graphs():
    """One rank with no group or over NCCL: graphs.  Gloo, and several
    ranks: eager."""
    assert graph_frames(1, None) and graph_frames(1, "nccl")
    assert not graph_frames(1, "gloo")
    assert not graph_frames(2, "nccl") and not graph_frames(8, "gloo")
    cfg = port_cfg(SMALL)
    lone = _sim(cfg)
    assert lone.graphs is not None
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        gloo = _sim(cfg, group=dist.group.WORLD)
        assert gloo.graphs is None
        assert gloo.run(2, batch=2) == lone.run(2, batch=2)
    finally:
        dist.destroy_process_group()
    for f in FIELDS:
        assert torch.equal(getattr(gloo.state, f), getattr(lone.state, f)), f


@pytest.mark.cuda
def test_cuda_lifecycle_over_a_slab_pass_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for rank in (0, 1):
        case = fs.slab_case(port_cfg(SLAB), slab_state().to("cuda"), RANKS,
                            rank, HALO, FRAME)
        fs.hold_slab(case)
