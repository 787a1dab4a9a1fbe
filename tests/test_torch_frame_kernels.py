"""The n-body frame's kernels A-E (``ops/frame_kernels.py``) against the
JAX package, through their plain versions, which CPU tensors take.

Each plain contract is held to the JAX functions it stands for, on the
edge states of ``tools/frame_states.py`` (made with numpy from a seed): a
spawn burst past the budget, no free slot, the tags 0x80000000 and
0xFFFFFFFF in contact and exploding, cell-cap overflow rows beside
all-dead blocks, a 2-chunk budget that drops chunks, k on a boundary of
E's ranking tiles, a slot count that is not a multiple of that tile with
every parent in the last tile and every free slot in the first, a
non-cubic grid with ids and -1 padding, the frame as a 0-dim tensor.

* A against ``grid.wrap_positions`` + ``coords_to_cell``: exact; its
  records' fields (the state's bits, ``neighbor_blocks.collision_okey`` of
  the tag, the slot) exact.
* B + C against ``neighbor_blocks.prepare`` (jitted): the order, snapshot,
  chunk table, overflow, counts, the largest cell, each chunk's count and
  the dropped chunks exact; ``inv`` the inverse of the order; the largest
  chunk after D, and the frame's three counts, exact.
* D + E against ``neighbor_blocks.unsort_outputs``, the mine-side window
  and ``models/nbody.lifecycle_update``, run op by op, given the same
  sorted pair outputs: the port's plain pair, and on one state the JAX
  kernel's (``pl.pallas_call`` in interpret mode, as
  tests/test_neighbor_blocks.py runs it).  Masks, tags and statistics
  exact; floats bit for bit too, since neither side contracts into an FMA
  op by op.
The ``cuda``-marked test holds each kernel to its plain version on the
card (it skips here).
"""

import dataclasses
import functools
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particlesystem_tpu.ops.neighbor_blocks as jnbk
from particlesystem_tpu import GridSpec, NBodyConfig
from particlesystem_tpu.core.state import ParticleState as JState
from particlesystem_tpu.models import nbody as jnbody
from particlesystem_tpu.ops import grid as jgrid
from particlesystem_tpu_torch.core.state import FIELDS, state_to_numpy
from particlesystem_tpu_torch.models import nbody as tnbody
from particlesystem_tpu_torch.ops import frame_kernels as fk
from particlesystem_tpu_torch.ops import neighbor_blocks as tnbk
from particlesystem_tpu_torch.tools import frame_states as fs
from particlesystem_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

STATES = {c.name: c for c in fs.edge_states("cpu")}


def jax_cfg(cfg):
    """The JAX package's copy of a port config (same fields)."""
    d = dataclasses.asdict(cfg)
    return NBodyConfig(**{**d, "grid": GridSpec(**d["grid"])})


def jax_state(st):
    return JState(**{k: jnp.asarray(v)
                     for k, v in state_to_numpy(st).items()})


def sorted_inputs(case):
    """The port's A, then the sort, B and C (``sort_and_prepare``) on
    ``case``: the plain versions, on the CPU."""
    cfg, st = case.cfg, case.state
    key, rec = fk.nbody_cells(st.pos, st.alive, st.age, st.w, st.tag,
                              cfg.grid)
    p = fk.sort_and_prepare(key, rec, cfg, case.c_max or tnbk.C_MAX,
                            tnbk.CH, tnbk.B, grid=cfg.grid)
    return (key, p.order, p.starts, p.snap, p.chunks, p.inv, p.overflow_s,
            p.stats)


@pytest.mark.parametrize("name", sorted(STATES))
def test_cells_match_jax(name):
    case = STATES[name]
    g = case.cfg.grid
    pos = case.state.pos.numpy()
    # far outside the box too: negative cells, several wraps
    far = np.random.default_rng(1).uniform(-70, 70, pos.shape)
    pos = np.where(np.arange(len(pos))[:, None] % 3 == 0, far, pos)
    pos = pos.astype(np.float32)
    alive = case.state.alive.numpy()
    cell = jgrid.coords_to_cell(jgrid.wrap_positions(jnp.asarray(pos), g)[1],
                                g)
    want = np.where(alive, np.asarray(cell), g.num_cells)
    st = case.state
    got, _ = fk.nbody_cells(torch.from_numpy(pos), st.alive, st.age, st.w,
                            st.tag, g)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@lru_cache(maxsize=None)
def jax_prepared(name):
    """The JAX package's ``prepare`` (jitted) on edge state ``name``."""
    case = STATES[name]
    jcfg = jax_cfg(case.cfg)
    js = jax_state(case.state)
    cell = jgrid.coords_to_cell(jgrid.wrap_positions(js.pos, jcfg.grid)[1],
                                jcfg.grid)
    out = jax.jit(functools.partial(jnbk.prepare, cfg=jcfg,
                                    c_max=case.c_max))(
        js.pos, js.age, js.w, cell, js.alive, tags=js.tag)
    return jax.tree.map(np.asarray, out)


def jax_chunk_counts(case, counts):
    """Each chunk's rows, from the JAX package's per-cell counts."""
    cd, cf = case.cfg.grid.chunk_dim, case.cfg.grid.chunk_factor
    per_cell = counts[:case.cfg.grid.num_cells]
    return per_cell.reshape(cf, cd, cf, cd, cf, cd).sum(axis=(1, 3, 5))


@pytest.mark.parametrize("name", sorted(STATES))
def test_records_match_jax(name):
    """A's records (plain version): each slot's x, y, z, w and age bits,
    the JAX package's collision key of its tag, the slot and 0; the same
    packed by ``pack_records`` with ids."""
    case = STATES[name]
    st = case.state
    _, rec = fk.nbody_cells(st.pos, st.alive, st.age, st.w, st.tag,
                            case.cfg.grid)
    assert rec.dtype == torch.int32 and rec.shape == (st.slots, fk.RECORD)
    rec = rec.numpy()
    n = st.slots
    bits = lambda t: t.numpy().view(np.int32)
    np.testing.assert_array_equal(rec[:, 0:3], bits(st.pos))
    np.testing.assert_array_equal(rec[:, 3], bits(st.w))
    np.testing.assert_array_equal(rec[:, 4], bits(st.age))
    okey = np.asarray(jnbk.collision_okey(jax_state(st).tag))
    np.testing.assert_array_equal(rec[:, 5], okey)
    np.testing.assert_array_equal(rec[:, 6], np.arange(n))
    assert not rec[:, 7].any()
    ids = torch.from_numpy(np.random.default_rng(2).permutation(n)
                           .astype(np.int32))
    packed = fk.pack_records(st.pos, st.age, st.w, st.tag, ids).numpy()
    np.testing.assert_array_equal(packed[:, 6], ids.numpy())
    np.testing.assert_array_equal(np.delete(packed, 6, 1),
                                  np.delete(rec, 6, 1))
    # without records A gives the keys alone, and the CPU never asks
    key, none = fk.nbody_cells(st.pos, st.alive, st.age, st.w, st.tag,
                               case.cfg.grid, records=False)
    assert none is None and torch.equal(key, fk.nbody_cells(
        st.pos, st.alive, st.age, st.w, st.tag, case.cfg.grid)[0])
    assert not fk.records_pay(st.slots, "cpu")


@pytest.mark.parametrize("name", ["tags", "overflow"])
def test_prepare_on_records_equals_prepare_on_the_arrays(name):
    """C (plain) on A's records and on the state's arrays: the same
    snapshot, chunk table, inverse, overflow and statistics."""
    case = STATES[name]
    st, grid = case.state, case.cfg.grid
    key, rec = fk.nbody_cells(st.pos, st.alive, st.age, st.w, st.tag, grid)
    outs = [fk.sort_and_prepare(key, rows, case.cfg, tnbk.C_MAX, tnbk.CH,
                                tnbk.B, grid=grid)
            for rows in (rec, fk.Fields(st.pos, st.age, st.w, st.tag))]
    bits = lambda t: t.view(torch.int32) if t.is_floating_point() else t
    (sa, *ra), (sb, *rb) = outs
    for x, y in zip((sa.f, sa.i, *ra), (sb.f, sb.i, *rb)):
        assert torch.equal(bits(x), bits(y))


@pytest.mark.parametrize("name", sorted(STATES))
def test_frame_counts_match_jax(name):
    """The counts that moved from B into C and D, after a whole frame
    (plain versions): the largest cell, the largest chunk and the dropped
    chunks equal those of the JAX package's ``prepare`` on the same state,
    and the chunk counters are left zero."""
    case = STATES[name]
    j_occ, j_counts, j_dropped = (jax_prepared(name)[k] for k in (4, 5, 6))
    st = case.state.map(lambda a: a.clone())
    uvec, fert = tnbody.frame_fields(case.cfg, case.frame, st.tag)
    stats = fs.plain_frame(st, st, uvec, fert, case.frame, case.cfg,
                           c_max=case.c_max)
    named = fs.stats_dict(stats)
    assert named["max_cell_occupancy"] == int(j_occ)
    assert named["max_chunk_occupancy"] == int(
        jax_chunk_counts(case, j_counts).max())
    assert named["n_listed_dropped"] == int(j_dropped)
    assert not stats[len(fk.STATS):].any()
    if case.c_max:
        assert named["n_listed_dropped"] > 0


@pytest.mark.parametrize("name", sorted(STATES))
def test_starts_and_prepare_match_jax(name):
    case = STATES[name]
    cfg, st = case.cfg, case.state
    key, order, starts, snap, chunks, inv, ovf, stats = sorted_inputs(case)
    (j_snap, j_chunks, j_order, j_ovf, j_occ, j_counts,
     j_dropped) = jax_prepared(name)
    n = st.slots
    np.testing.assert_array_equal(np.asarray(j_order), order.numpy())
    j_snap = np.asarray(j_snap)[:, :n]
    np.testing.assert_array_equal(
        j_snap[[0, 1, 2, 4, 5, 6, 10]].view(np.uint32),
        snap.f.numpy().view(np.uint32))
    np.testing.assert_array_equal(j_snap[[8, 14]].view(np.int32),
                                  snap.i.numpy())
    np.testing.assert_array_equal(np.asarray(j_chunks), chunks.numpy())
    np.testing.assert_array_equal(np.asarray(j_ovf), ovf.numpy())
    np.testing.assert_array_equal(np.asarray(j_counts),
                                  np.diff(starts.numpy()))
    # inv is the inverse permutation of the order
    np.testing.assert_array_equal(inv.numpy()[order.numpy()], np.arange(n))
    named = fs.stats_dict(stats)
    assert named["max_cell_occupancy"] == int(j_occ)
    assert named["n_listed_dropped"] == int(j_dropped)
    # C adds each chunk's rows to its counter; D takes their largest
    np.testing.assert_array_equal(stats[len(fk.STATS):].numpy(),
                                  jax_chunk_counts(case, j_counts).ravel())
    if case.c_max:
        assert named["n_listed_dropped"] > 0
    if name == "overflow":
        assert ovf.any() and not snap.f[3, -tnbk.B:].ge(-2 ** 21).any()


def test_prepare_dims_ids_padding_matches_jax():
    """B + C under the decomposed step's inputs: a (3, 5, 4) grid, ids, and
    padding rows of id -1."""
    cfg, args, dims, ids = fs.dims_case("cpu")
    pos, age, w, cell, alive, tags = args
    t = tnbk.prepare(pos, age, w, cell, alive, cfg, tags, dims=dims, ids=ids)
    j = jax.jit(functools.partial(jnbk.prepare, cfg=jax_cfg(cfg), dims=dims))(
        *(jnp.asarray(a.numpy()) for a in (pos, age, w, cell, alive)),
        ids=jnp.asarray(ids.numpy()),
        tags=jnp.asarray(tags.numpy().astype(np.uint32)))
    n = pos.shape[0]
    np.testing.assert_array_equal(np.asarray(j[2]), t[2].numpy())
    snap = np.asarray(j[0])[:, :n]
    np.testing.assert_array_equal(snap[[0, 1, 2, 4, 5, 6, 10]].view(np.uint32),
                                  t[0].f.numpy().view(np.uint32))
    np.testing.assert_array_equal(snap[[8, 14]].view(np.int32),
                                  t[0].i.numpy())
    assert (t[0].i[0] == -1).sum() == 300
    for k in (1, 3, 5):
        np.testing.assert_array_equal(np.asarray(j[k]), t[k].numpy())
    assert int(j[4]) == int(t[4]) and int(j[6]) == int(t[6])


def jax_lifecycle(case, acc_s, gmax_s, order, ovf, uvec, fert):
    """The JAX package's unsort, mine-side window and lifecycle on the
    sorted pair outputs, op by op."""
    cfg, jcfg = case.cfg, jax_cfg(case.cfg)
    js = jax_state(case.state)
    out = jnp.asarray(np.concatenate(
        [acc_s, gmax_s.view(np.float32)[None]]))
    acc, kill, touch, overflow = jnbk.unsort_outputs(
        out, jnp.asarray(order), jnp.asarray(ovf),
        okeys=jnbk.collision_okey(js.tag))
    win = (js.age >= jnp.float32(cfg.kid_age)) \
        & (js.age <= jnp.float32(cfg.particle_life))
    pos_w, _ = jgrid.wrap_positions(js.pos, jcfg.grid)
    frame = case.frame
    frame = jnp.int32(int(frame))
    return jnbody.lifecycle_update(js, pos_w, overflow, acc, kill & win,
                                   touch & win, jnp.asarray(uvec),
                                   jnp.asarray(fert), frame, jcfg)


def check_lifecycle(case, acc_s, gmax_s):
    """D + E (plain) against the JAX lifecycle on the same pair outputs;
    returns the port's statistics."""
    cfg, st = case.cfg, case.state
    _, order, _, snap, chunks, inv, ovf, stats = sorted_inputs(case)
    uvec, fert = tnbody.frame_fields(cfg, case.frame, st.tag)
    out = st.map(torch.empty_like)
    flags, tiles = fk.nbody_lifecycle(st, out, acc_s, gmax_s, ovf, inv, uvec,
                                      cfg, stats)
    fk.nbody_spawn(out, fert, case.frame, flags, tiles, cfg, stats)
    with jax.disable_jit():
        jout, jcounts = jax_lifecycle(case, acc_s.numpy(), gmax_s.numpy(),
                                      order.numpy(), ovf.numpy(),
                                      uvec.numpy(), fert.numpy())
    got = state_to_numpy(out)
    for f in FIELDS:
        a, b = got[f], np.asarray(getattr(jout, f))
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(a, b, err_msg=f)
    named = fs.stats_dict(stats)
    for k, v in jcounts.items():
        assert named[k] == int(v), k
    # the tile counts are the flags' per-tile sums
    fl = flags.numpy()
    pad = (-len(fl)) % fk.TILE
    per = np.concatenate([fl, np.zeros(pad, np.uint8)]).reshape(-1, fk.TILE)
    np.testing.assert_array_equal(
        tiles.numpy(), np.stack([(per & 1).sum(1), (per >> 1).sum(1)], 1))
    return named


@pytest.mark.parametrize("name", sorted(STATES))
def test_lifecycle_and_spawn_match_jax(name):
    case = STATES[name]
    _, _, _, snap, chunks, *_ = sorted_inputs(case)
    acc_s, gmax_s = tnbk.cluster_pair_plain(case.cfg, snap, chunks, tnbk.B,
                                            tnbk.CH)
    named = check_lifecycle(case, acc_s, gmax_s)
    want = dict(burst=("n_spawned", 64), full=("n_spawn_capped", 64),
                tags=("n_collision_kills", 1), cmax2=("n_survivals", 1),
                overflow=("n_overflow_kills", 1), kedge=("n_spawned", 2048),
                lasttile=("n_spawned", 400))[name]
    assert named[want[0]] >= want[1], (name, named)
    if name == "burst":
        # the budget, not the free slots, capped the burst
        assert named["n_spawn_capped"] == 0
    if name in ("kedge", "lasttile"):
        check_spawn_tiles(case, named["n_spawned"])


def check_spawn_tiles(case, k):
    """Where the edge states put E's ranks: k on the boundary of the first
    ranking tile for both kinds (kedge), or every parent in the last tile
    and every free slot in the first, whose slot count is not a multiple
    of the tile (lasttile)."""
    st = case.state
    out, stats = tnbody.step(st, case.frame, case.cfg)
    assert int(stats.n_alive) == int(st.alive.sum()) + k   # no deaths
    explode = (out.parent & ~st.parent).numpy()
    free = (~st.alive).numpy()
    t = fk.SPAWN_TILE
    if case.name == "kedge":
        assert k == case.cfg.max_spawns_per_frame
        assert explode[:t].sum() == free[:t].sum() == k
        assert explode[t:].sum() > 0 and free[t:].sum() > 0
    else:
        assert st.slots % t and k == explode.sum() == explode[t:].sum()
        assert free.sum() == free[:t].sum()


def test_lifecycle_on_the_jax_kernels_outputs():
    """D + E fed the JAX cluster-pair kernel's sorted outputs (Pallas in
    interpret mode), on the state with the edge tags in contact."""
    case = STATES["tags"]
    jcfg = jax_cfg(case.cfg)
    js = jax_state(case.state)
    cell = jgrid.coords_to_cell(jgrid.wrap_positions(js.pos, jcfg.grid)[1],
                                jcfg.grid)
    n = case.state.slots

    def kernel(pos, age, w, cell, alive, tags):
        snap, chunks, *_ = jnbk.prepare(pos, age, w, cell, alive, jcfg,
                                        tags=tags)
        return jnbk.kernel_call(jcfg, snap, chunks, n)
    out = np.asarray(jax.jit(kernel)(js.pos, js.age, js.w, cell, js.alive,
                                     js.tag))
    acc_s = torch.from_numpy(np.array(out[:3]))
    gmax_s = torch.from_numpy(np.array(out[3]).view(np.int32))
    named = check_lifecycle(case, acc_s, gmax_s)
    assert named["n_collision_kills"] > 0 and named["n_survivals"] > 0


def test_frame_as_a_device_tensor_gives_the_same_bits():
    case = STATES["burst"]
    outs = []
    for frame in (7, torch.tensor(7, dtype=torch.int64)):
        st = case.state.map(lambda a: a.clone())
        uvec, fert = tnbody.frame_fields(case.cfg, frame, st.tag)
        stats = tnbody.blocks_frame(st, st, uvec, fert, frame, case.cfg)
        outs.append((state_to_numpy(st), {k: int(v) for k, v in
                                          vars(stats).items()}))
    for f in FIELDS:
        np.testing.assert_array_equal(outs[0][0][f], outs[1][0][f])
    assert outs[0][1] == outs[1][1] and outs[0][1]["n_spawned"] == 64


def test_step_and_step_into_agree_through_the_plain_frame():
    """The frame in place (step_into) leaves what step returns, and so
    does the frame composed of the plain versions (the dispatchers take
    them on the CPU)."""
    case = STATES["tags"]
    a = case.state.map(lambda t: t.clone())
    b, sb = tnbody.step(case.state, 4, case.cfg)
    sa = tnbody.step_into(a, 4, case.cfg)
    c = case.state.map(torch.empty_like)
    uvec, fert = tnbody.frame_fields(case.cfg, 4, case.state.tag)
    sc = fs.plain_frame(case.state, c, uvec, fert, 4, case.cfg)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(getattr(c, f), getattr(b, f)), f
    assert vars(sa).keys() == vars(sb).keys()
    for k in vars(sa):
        assert int(getattr(sa, k)) == int(getattr(sb, k)) == int(
            sc[fk.STAT[k]]), k


def test_cpu_takes_the_plain_version_and_wrappers_refuse():
    entries = ("ps_nbody_cells", "ps_cell_starts", "ps_block_prepare",
               "ps_nbody_lifecycle", "ps_nbody_spawn")
    before = cuda_build.launches()
    case = STATES["tags"]
    tnbody.step(case.state, 1, case.cfg)
    after = cuda_build.launches()
    assert all(after.get(k, 0) == before.get(k, 0) for k in entries)
    st = case.state
    a_args = (st.pos, st.alive, st.age, st.w, st.tag)
    with pytest.raises(ValueError, match="CUDA"):
        fk.nbody_cells_cuda(*a_args, case.cfg.grid)
    with pytest.raises(ValueError, match="device"):
        fk.nbody_cells(*(t.to("meta") for t in a_args), case.cfg.grid)
    with pytest.raises(ValueError, match="multiple of the block size"):
        fk.block_prepare_plain(fk.pack_records(st.pos[:100], st.age[:100],
                                               st.w[:100], st.tag[:100]),
                               torch.zeros(100, dtype=torch.int32),
                               torch.arange(100), torch.zeros(
                                   case.cfg.grid.num_cells + 2,
                                   dtype=torch.int32), case.cfg,
                               fk.new_stats("cpu"), 48, 1024, 512)


def test_spawn_scratch_refuses_what_its_words_cannot_count():
    assert fk.spawn_scratch_words(4608, 1024) == 2 + 1024
    assert fk.spawn_scratch_words(fk.SPAWN_MAX_SLOTS, 1) == (
        1 + -(-fk.SPAWN_MAX_SLOTS // fk.SPAWN_TILE))
    for n, e in ((fk.SPAWN_MAX_SLOTS + 1, 1024), (0, 1), (100, 101),
                 (100, 0)):
        with pytest.raises(ValueError, match="E ranks"):
            fk.spawn_scratch_words(n, e)


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for case in fs.edge_states("cuda"):
        fs.hold_kernels(case.cfg, case.state, case.frame, case.c_max)
    cfg, args, dims, ids = fs.dims_case("cuda")
    fs.hold_prepare(cfg, args, dims, ids)
    fs.hold_frames(STATES["tags"].cfg, 4, "cuda")
