"""The port's cluster-pair neighbor pass against the JAX package's.

Both sides get the same state: the port's ``init_fill`` (bit for bit the
JAX package's, see test_torch_rng.py) stepped two frames by the port, and
carried to the JAX side as numpy arrays.  The JAX functions run jitted, and
the JAX kernel as the JAX suite runs it on the CPU (Pallas interpret mode); the port runs ``cluster_pair_plain``, the plain version of its CUDA
kernel, which CPU tensors take.

Exact: the sort order, the snapshot coordinates and ids, the chunk table,
per-cell counts, max occupancy, dropped chunks, ``gmax`` and the
kill/touch/overflow flags.  ``acc`` within 1e-5 of ``max(1, max|acc|)``
against the JAX kernel's direct sum (``fast_accum=False``) and within 5e-4
against its default matrix-unit sum (``fast_accum=True``), the tolerances
of tests/test_neighbor_blocks.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particlesystem_tpu.ops.neighbor_blocks as jnbk
import particlesystem_tpu_torch.ops.neighbor_blocks as tnbk
from particlesystem_tpu import GridSpec, NBodyConfig
from particlesystem_tpu.ops import grid as jgrid
from particlesystem_tpu.ops.neighbor import collision_okey as j_okey
from particlesystem_tpu_torch import GridSpec as TGridSpec
from particlesystem_tpu_torch import NBodyConfig as TNBodyConfig
from particlesystem_tpu_torch.core.state import (state_from_numpy,
                                                 state_to_numpy)
from particlesystem_tpu_torch.models import nbody as tnbody
from particlesystem_tpu_torch.ops import grid as tgrid
from particlesystem_tpu_torch.ops.neighbor import collision_okey as t_okey

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
# small tiles: multi-chunk ranges, row- and plane-crossing blocks
PLANES = NBodyConfig(n_fill=20_000, capacity=32768,
                     grid=GridSpec(grid_dim=16), seed=3)


def port_cfg(cfg):
    """The port's copy of a JAX-package config (same fields)."""
    d = dataclasses.asdict(cfg)
    return TNBodyConfig(**{**d, "grid": TGridSpec(**d["grid"])})


@functools.lru_cache(maxsize=None)
def frame2_state(name):
    cfg = PLANES if name == "planes" else CONFIGS[name]
    s = tnbody.init_fill(port_cfg(cfg), "cpu")
    for f in range(2):
        s, _ = tnbody.step(s, f, port_cfg(cfg))
    return state_to_numpy(s)


def pass_inputs(name):
    """(jax inputs, port inputs, cfg) of the neighbor pass at ``name``."""
    cfg = PLANES if name == "planes" else CONFIGS[name]
    st = frame2_state(name)
    pos = jnp.asarray(st["pos"])
    cell = jgrid.coords_to_cell(jgrid.wrap_positions(pos, cfg.grid)[1],
                                cfg.grid)
    jin = (pos, jnp.asarray(st["age"]), jnp.asarray(st["w"]), cell,
           jnp.asarray(st["alive"]), jnp.asarray(st["tag"]))
    ts = state_from_numpy(st, "cpu")
    tcell = tgrid.coords_to_cell(tgrid.wrap_positions(ts.pos, cfg.grid)[1],
                                 cfg.grid)
    tin = (ts.pos, ts.age, ts.w, tcell, ts.alive, ts.tag)
    return jin, tin, cfg


def acc_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(1.0, float(np.abs(b).max()))


def test_grid_wrap_and_cells_negative_coords():
    g = GridSpec(grid_dim=8, cell_size=5.0, chunk_factor=2)
    pos = np.random.default_rng(0).uniform(-70, 70, (4000, 3))
    pos = np.concatenate([pos, [[-20.0, 20.0, 20.0], [-20.000002, 0, 0],
                                [19.99999, -35.0, -60.0]]]).astype(np.float32)
    cj = np.asarray(jgrid.cell_coords(jnp.asarray(pos), g))
    assert (cj < 0).any()                       # negative cells exercised
    ct = tgrid.cell_coords(torch.from_numpy(pos), g).numpy()
    np.testing.assert_array_equal(cj, ct)
    pj, wj = jgrid.wrap_positions(jnp.asarray(pos), g)
    pt, wt = tgrid.wrap_positions(torch.from_numpy(pos), g)
    np.testing.assert_array_equal(np.asarray(pj).view(np.uint32),
                                  pt.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(wj), wt.numpy())
    assert wt.min() >= 0 and wt.max() < 8
    np.testing.assert_array_equal(np.asarray(jgrid.coords_to_cell(wj, g)),
                                  tgrid.coords_to_cell(wt, g).numpy())


def test_collision_okey_clamp():
    tags = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFF]
                    + list(np.random.default_rng(1).integers(
                        0, 2 ** 32, 1000)), np.uint32)
    kt = t_okey(torch.from_numpy(tags.astype(np.int64)))
    assert kt.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(j_okey(jnp.asarray(tags))),
                                  kt.numpy())
    assert kt[3] == -(2 ** 31) + 1 and kt[4] == -(2 ** 31) + 1


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prepare_matches_jax(name):
    jin, tin, cfg = pass_inputs(name)
    *jargs, jtags = jin
    *targs, ttags = tin
    snap, chunks, order, ovf, max_occ, counts, dropped = jax.jit(
        functools.partial(jnbk.prepare, cfg=cfg))(*jargs, tags=jtags)
    t_snap, t_chunks, t_order, t_ovf, t_occ, t_counts, t_dropped = \
        tnbk.prepare(*targs, port_cfg(cfg), ttags)
    n = order.shape[0]
    snap = np.asarray(snap)[:, :n]
    np.testing.assert_array_equal(np.asarray(order), t_order.numpy())
    # float rows x, y, z, i1, i2, i3, w sit at rows 0-2, 4-6, 10 of the
    # JAX snapshot; gid and cgid are int32 bit patterns at rows 8 and 14
    np.testing.assert_array_equal(snap[[0, 1, 2, 4, 5, 6, 10]].view(np.uint32),
                                  t_snap.f.numpy().view(np.uint32))
    np.testing.assert_array_equal(snap[[8, 14]].view(np.int32),
                                  t_snap.i.numpy())
    np.testing.assert_array_equal(np.asarray(chunks), t_chunks.numpy())
    np.testing.assert_array_equal(np.asarray(ovf), t_ovf.numpy())
    np.testing.assert_array_equal(np.asarray(counts), t_counts.numpy())
    assert int(max_occ) == int(t_occ)
    assert int(dropped) == int(t_dropped) == 0


@pytest.mark.parametrize("fast_accum,tol", [(False, 1e-5), (True, 5e-4)])
def test_cluster_pair_plain_matches_jax_kernel(fast_accum, tol):
    jin, tin, cfg = pass_inputs("mid-g8")
    *jargs, jtags = jin
    *targs, ttags = tin
    n = jargs[0].shape[0]

    def jax_kernel(*args):
        snap, chunks, *_ = jnbk.prepare(*args[:5], cfg, tags=args[5])
        return jnbk.kernel_call(cfg, snap, chunks, n, acc_mxu=fast_accum)
    out = np.asarray(jax.jit(jax_kernel)(*jargs, jtags))
    t_snap, t_chunks, *_ = tnbk.prepare(*targs, port_cfg(cfg), ttags)
    acc, gmax = tnbk.cluster_pair_plain(port_cfg(cfg), t_snap, t_chunks,
                                        tnbk.B, tnbk.CH)
    np.testing.assert_array_equal(out[3].view(np.int32), gmax.numpy())
    assert (gmax.numpy() > -(2 ** 31)).any()       # collisions exercised
    assert acc_err(acc.numpy(), out[:3]) < tol
    # a block subset returns those blocks' rows, in the order given
    sub = torch.tensor([5, 2, 9], dtype=torch.int32)
    acc_s, gmax_s = tnbk.cluster_pair_plain(port_cfg(cfg), t_snap, t_chunks,
                                            tnbk.B, tnbk.CH, blocks=sub)
    rows = (sub.long()[:, None] * tnbk.B + torch.arange(tnbk.B)).reshape(-1)
    np.testing.assert_array_equal(gmax_s.numpy(), gmax[rows].numpy())
    # (the plain sum's width follows its batch of blocks, so the rounding
    # of a subset's sums may differ)
    assert acc_err(acc_s.numpy(), acc[:, rows].numpy()) < 1e-6


def compare_pass(name, c_max=None):
    jin, tin, cfg = pass_inputs(name)
    *jargs, jtags = jin
    *targs, ttags = tin
    jout = jax.jit(functools.partial(jnbk.neighbor_pass_blocks, cfg=cfg,
                                     c_max=c_max))(*jargs, tags=jtags)
    tout = tnbk.neighbor_pass_blocks(*targs, port_cfg(cfg), ttags,
                                     c_max=c_max)
    acc, kill, touch, ovf, max_occ, counts, dropped = tout
    for k, a, b in zip(("kill", "touch", "overflow", "max_occ", "counts",
                        "dropped"), jout[1:], tout[1:]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=k)
    assert acc_err(acc.numpy(), jout[0]) < 1e-5
    assert kill.any() and touch.any()
    return int(dropped)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_neighbor_pass_blocks_matches_jax(name):
    assert compare_pass(name) == 0


def test_neighbor_pass_blocks_plane_crossings(monkeypatch):
    """B=32, CH=128 (module parameters on both sides)."""
    for mod in (jnbk, tnbk):
        monkeypatch.setattr(mod, "B", 32)
        monkeypatch.setattr(mod, "CH", 128)
    assert compare_pass("planes") == 0


def test_chunk_budget_drop_matches_jax():
    """A tiny chunk budget drops the same chunks, and reports the same
    nonzero count, on both sides."""
    assert compare_pass("mid-g8", c_max=2) > 0


def test_out_of_band_coords_unique_past_wrap():
    """Out-of-band stencil coordinates stay unique past 2^19 rows
    (tests/test_neighbor_blocks.py:114-137): the coprime per-axis moduli
    make the wrap 2^19*(2^19-1)."""
    b = 512
    n = (1 << 19) + 4 * b
    cfg = TNBodyConfig(n_fill=16, capacity=n // 2,
                       grid=TGridSpec(grid_dim=4, chunk_factor=2), seed=0)
    pos = torch.zeros((n, 3))
    age = torch.zeros((n,))                        # all kids
    w = torch.full((n,), 60.0)
    cell = torch.zeros((n,), dtype=torch.int32)
    alive = torch.arange(n) % 2 == 0               # half kid, half dead band
    snap, *_ = tnbk.prepare(pos, age, w, cell, alive, cfg,
                            torch.arange(n), b=b)
    coords = snap.f[3:6].numpy()
    assert coords.max() < 0
    assert len(np.unique(coords.T, axis=0)) == n
