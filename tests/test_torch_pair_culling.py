"""What the CUDA cluster-pair kernel drops, shown on the CPU to change
nothing.

The kernel (``particlesystem_tpu_torch/csrc/neighbor_blocks.cu``) never
forms a pair with an out-of-band column or row, skips whole groups of
columns by their cell, and tests the stencil axis by axis.  It
cannot run here, so its walk is modelled in numpy (:func:`walk_model`): the
same pieces, warp segments, ordered compaction, one-cell groups of at most 32
columns, row lists and boxes, and a float32 sum in ascending column order.
The model runs with and without the cullings on frames prepared by the port;
both must agree bit for bit, with ``cluster_pair_plain`` (``gmax`` exact,
``acc`` within 1e-5 of max(1, max|acc|): the plain version sums in another
order) and with the JAX kernel in interpret mode (``fast_accum=False``, same
tolerance).
"""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

import particlesystem_tpu.ops.neighbor_blocks as jnbk
import particlesystem_tpu_torch.ops.neighbor_blocks as tnbk
from particlesystem_tpu_torch.tools import sweep_pair_kernel as sweep
from particlesystem_tpu_torch.tools.sweep_pair_kernel import (
    SOURCE, source_constants, synthetic_frame)
from test_torch_neighbor_blocks import acc_err, pass_inputs, port_cfg

torch.set_num_threads(1)

IMIN = -(1 << 31)
# raw columns a piece; rows a thread, from 32 * WIDE rows a block up; the
# most warps a CTA: read from the kernel's source
TW, WIDE, MAX_WARPS = (source_constants()[k]
                       for k in ("TW", "WIDE", "MAX_WARPS"))
SMALL = dict(b=32, ch=128)


def geometry(b):
    """(rows a thread, threads a CTA) as ``ps_cluster_pair`` picks them."""
    rows = WIDE if b >= 32 * WIDE else 1
    threads = 32
    while threads * rows < b:
        threads *= 2
    return rows, threads


def walk_model(f, i, chunks, b, eps2, r2, cull):
    """Sequential model of the kernel's walk over prepared inputs (numpy:
    ``f`` (7, N) float32, ``i`` (2, N) int32, ``chunks`` (NB, c_max, 4)).

    ``cull=False`` walks every valid column of every listed chunk for every
    row with the ``cd2 <= 3.5`` test.  ``cull=True`` does what the kernel
    does: in-band rows only, handed to threads in order; pieces of ``TW``
    raw columns from a 4-aligned start, each warp's segment compacted in
    order to its in-range, in-band columns and cut into groups, runs of at
    most 32 columns of one cell; a group skipped by a warp whose rows' box of
    cells is more than one cell away; the stencil tested axis by axis, a
    group's cell against a row's.  Returns (acc (3, N), gmax (N,),
    counts of what was culled)."""
    f32 = np.float32
    n = f.shape[1]
    acc = np.zeros((3, n), f32)
    gmax = np.full(n, IMIN, np.int32)
    stats = dict(blocks_left_early=0, empty_tiles=0, groups=0,
                 groups_skipped=0, columns_dropped=0, rows_dropped=0)
    rows_a_thread, threads = geometry(b)
    nw = threads // 32
    seg = TW // nw
    cells = np.rint(f[3:6]).astype(np.int64)
    for blk in range(chunks.shape[0]):
        row0 = blk * b
        block_rows = np.arange(row0, row0 + b)
        ct = chunks[blk].astype(np.int64)
        ranges = [(a + lo, a + hi) for a, lo, hi, _ in ct[:ct[0, 3]]
                  if hi > lo]
        if not cull:
            groups = [np.arange(first, last) for first, last in ranges]
            warps = [block_rows]
        else:
            kept_rows = block_rows[f[3, block_rows] >= 0]
            stats["rows_dropped"] += b - len(kept_rows)
            if not len(kept_rows):
                stats["blocks_left_early"] += 1
                continue
            rpt = -(-len(kept_rows) // threads)
            assert rpt <= rows_a_thread
            warps = [kept_rows[k:k + 32 * rpt]
                     for k in range(0, len(kept_rows), 32 * rpt)]
            groups = []
            for first, last in ranges:
                for start in range(first & ~3, last, TW):
                    tile = 0
                    for w in range(nw):
                        cols = np.arange(start + w * seg,
                                         start + (w + 1) * seg)
                        cols = cols[(cols >= first) & (cols < last)]
                        kept = cols[f[3, cols] >= 0]
                        stats["columns_dropped"] += len(cols) - len(kept)
                        tile += len(kept)
                        for g in range(0, len(kept), 32):
                            run = kept[g:g + 32]
                            cuts = np.flatnonzero(
                                (cells[:, run[1:]] != cells[:, run[:-1]])
                                .any(axis=0)) + 1
                            groups += np.split(run, cuts)
                    stats["empty_tiles"] += tile == 0
        for rows in warps:
            if cull:
                lo = cells[:, rows].min(axis=1) - 1
                hi = cells[:, rows].max(axis=1) + 1
                near = [g for g in groups
                        if not ((cells[:, g].min(axis=1) > hi).any()
                                or (cells[:, g].max(axis=1) < lo).any())]
                stats["groups"] += len(groups)
                stats["groups_skipped"] += len(groups) - len(near)
            else:
                near = groups
            if not near:
                continue
            cols = np.concatenate(near)
            e = f[3:6, cols][:, None, :] - f[3:6, rows][:, :, None]
            if cull:
                for g in near:
                    assert (cells[:, g] == cells[:, g[:1]]).all()
                inside = (np.abs(e) <= f32(1.0)).all(axis=0)
            else:
                inside = (e[0] * e[0] + e[1] * e[1]) + e[2] * e[2] <= f32(3.5)
            ok = inside & (i[0, cols][None, :] != i[0, rows][:, None])
            d = f[0:3, cols][:, None, :] - f[0:3, rows][:, :, None]
            d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
            rs = f32(1.0) / np.sqrt(d2 + f32(eps2))
            terms = np.where(ok, d * (rs * rs * rs * f[6, cols][None, :]),
                             f32(0.0))
            assert terms.dtype == f32
            # each row's float32 sum, one column after another (a pair that
            # fails adds +0.0, which changes no bit of a sum begun at +0.0)
            acc[:, rows] = np.add.accumulate(terms, axis=2)[:, :, -1]
            hit = np.where(ok & (d2 <= f32(r2)), i[1, cols][None, :], IMIN)
            gmax[rows] = hit.max(axis=1)
    return acc, gmax, stats


def prepared(name, **tiles):
    """The port's prepared frame of config ``name``: (cfg, snap, chunks)."""
    _, tin, cfg = pass_inputs(name)
    *targs, ttags = tin
    snap, chunks, *_, dropped = tnbk.prepare(*targs, port_cfg(cfg), ttags,
                                             **tiles)
    assert int(dropped) == 0
    return port_cfg(cfg), snap, chunks


def run_model(cfg, snap, chunks, b, cull):
    eps2, r2 = tnbk._pair_constants(cfg)
    return walk_model(snap.f.numpy(), snap.i.numpy(), chunks.numpy(), b,
                      eps2, r2, cull)


def band_values(rng, count):
    """Cell coordinates as ``prepare`` makes them: in-band cells of a 16^3
    grid, kid-band and dead-band values of rows up to 2^19 apart."""
    rows = np.concatenate([rng.integers(0, 1 << 21, count),
                           [0, 1, (1 << 19) - 2, (1 << 19) - 1, 1 << 19,
                            (1 << 19) + 1, 1 << 20]])
    a = -2.0 * (rows % (1 << 19))
    b = -2.0 * (rows % ((1 << 19) - 1))
    kid = np.stack([-10.0 + a, -10.0 + b, -10.0 + a])
    dead = np.stack([-4194304.0 + a, -4194304.0 + b, -4194304.0 + a])
    cell = rng.integers(0, 16, (3, count)).astype(np.float64)
    edge = np.array([[0, 0, 0], [15, 15, 15], [0, 15, 7], [1, 0, 14]]).T
    return np.concatenate([cell, edge, kid, dead], axis=1).astype(np.float32)


def test_per_axis_predicate_equals_cd2():
    """``|e1| <= 1 and |e2| <= 1 and |e3| <= 1`` is ``cd2 <= 3.5`` on every
    pair of in-band, kid-band and dead-band coordinates."""
    v = band_values(np.random.default_rng(0), 600)
    assert (np.abs(v) < 2 ** 23).all() and (v == np.rint(v)).all()
    e = v[:, None, :] - v[:, :, None]                      # float32, exact
    assert e.dtype == np.float32
    cd2 = (e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]
    per_axis = (np.abs(e) <= np.float32(1.0)).all(axis=0)
    np.testing.assert_array_equal(per_axis, cd2 <= np.float32(3.5))
    in_band = v[0] >= 0
    # the stencil is exercised, and no out-of-band value is inside it with
    # anything but itself
    assert per_axis[np.ix_(in_band, in_band)].sum() > in_band.sum()
    off_diagonal = per_axis & ~np.eye(v.shape[1], dtype=bool)
    same = (e == 0).all(axis=0)                  # the edge rows drawn twice
    assert not (off_diagonal & ~same)[~in_band].any()
    assert not (off_diagonal & ~same)[:, ~in_band].any()
    # the same on torch tensors, as the plain version computes it
    t = torch.from_numpy(e)
    tp = ((t[0].abs() <= 1.0) & (t[1].abs() <= 1.0) & (t[2].abs() <= 1.0))
    np.testing.assert_array_equal(tp.numpy(), per_axis)


@pytest.mark.parametrize("name,tiles", [
    ("mid-g8", SMALL), ("dense-g4", SMALL), ("mid-g8", {})])
def test_culled_walk_is_the_full_walk(name, tiles):
    cfg, snap, chunks = prepared(name, **tiles)
    b = tiles.get("b", tnbk.B)
    full_acc, full_gmax, _ = run_model(cfg, snap, chunks, b, cull=False)
    acc, gmax, stats = run_model(cfg, snap, chunks, b, cull=True)
    # every culling did something, and changed no bit
    assert stats["rows_dropped"] and stats["columns_dropped"]
    assert 0 < stats["groups_skipped"] < stats["groups"]
    np.testing.assert_array_equal(acc.view(np.int32), full_acc.view(np.int32))
    np.testing.assert_array_equal(gmax, full_gmax)
    assert (gmax > IMIN).any() and np.abs(acc).max() > 0
    # the plain version: same pairs, another order of summation
    p_acc, p_gmax = tnbk.cluster_pair_plain(cfg, snap, chunks, b,
                                            tiles.get("ch", tnbk.CH))
    np.testing.assert_array_equal(gmax, p_gmax.numpy())
    assert acc_err(acc, p_acc.numpy()) < 1e-5


def test_culled_walk_matches_jax_kernel():
    """The model against the JAX kernel (Pallas interpret mode, direct
    float32 sum) at the 32-row, 128-column tile."""
    jin, _, jcfg = pass_inputs("mid-g8")
    *jargs, jtags = jin
    n = jargs[0].shape[0]

    def jax_kernel(*args):
        snap, chunks, *_ = jnbk.prepare(*args[:5], jcfg, tags=args[5],
                                        **SMALL)
        return jnbk.kernel_call(jcfg, snap, chunks, n, acc_mxu=False, **SMALL)
    out = np.asarray(jax.jit(jax_kernel)(*jargs, jtags))
    cfg, snap, chunks = prepared("mid-g8", **SMALL)
    acc, gmax, _ = run_model(cfg, snap, chunks, SMALL["b"], cull=True)
    np.testing.assert_array_equal(out[3].view(np.int32), gmax)
    assert acc_err(acc, out[:3]) < 1e-5


@pytest.mark.parametrize("name,tiles", [
    ("dense-g4", {}), ("sparse-g16", {}), ("mid-g8", {}), ("mid-g8", SMALL)])
def test_plain_out_of_band_rows_are_zero(name, tiles):
    """A kid, dead or overflow row leaves the plain version with acc = 0 and
    gmax = INT32_MIN: what the kernel writes for it without a walk."""
    cfg, snap, chunks = prepared(name, **tiles)
    acc, gmax = tnbk.cluster_pair_plain(cfg, snap, chunks,
                                        tiles.get("b", tnbk.B),
                                        tiles.get("ch", tnbk.CH))
    out = snap.f[3] < 0
    assert out.any() and (~out).any()
    assert not acc[:, out].any()
    assert (gmax[out] == IMIN).all()
    assert acc[:, ~out].any()


@pytest.mark.parametrize("eps2", [0.0, 1e-30])
def test_self_pair_stays_out_without_softening(eps2):
    """With no softening the row's own ``rsqrt`` is infinite, and with a
    tiny one ``rs^3 * w`` overflows: the pair is kept out by its id, and the
    kernel drops the id compare only from a softening up that keeps every
    term finite."""
    cfg, snap, chunks = prepared("dense-g4", **SMALL)
    cfg = dataclasses.replace(cfg, eps2=eps2)
    p_acc, p_gmax = tnbk.cluster_pair_plain(cfg, snap, chunks, 32, 128)
    assert torch.isfinite(p_acc).all() and p_acc.any()
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        acc, gmax, _ = run_model(cfg, snap, chunks, 32, cull=True)
    assert np.isfinite(acc).all()
    np.testing.assert_array_equal(gmax, p_gmax.numpy())
    assert acc_err(acc, p_acc.numpy()) < 1e-5
    # the kernel's threshold: rsqrt(eps2)^3 * w is finite from it up
    floor = np.float32(re.search(r"MIN_NORMAL_EPS2 = ([0-9.e+-]+)f;",
                                 SOURCE.read_text()).group(1))
    assert np.float32(eps2) < floor
    rs = np.float32(1.0) / np.sqrt(floor)
    assert np.isfinite(rs * rs * rs * np.float32(3e8))
    assert snap.f[6].max() < 3e8


def test_chunk_of_kids_only_and_block_of_kids_only():
    cfg, args, tags = synthetic_frame("cpu")
    snap, chunks, *_, dropped = tnbk.prepare(*args, cfg, tags, **SMALL)
    assert int(dropped) == 0
    band = (snap.f[3] >= 0).view(-1, 32)
    # block 0: kids only, yet it lists chunks; block 1: adults of cell 1,
    # whose second and third chunks (a leading gap of 122 columns, then a
    # width of 34) hold the kids of cell 5 only; the last two blocks are
    # dead and list nothing
    assert not band[0].any() and chunks[0, 0, 3] == 3
    assert band[1].all() and chunks[1, 0, 3] == 3
    assert chunks[1, 1].tolist() == [0, 122, 128, 3]
    assert chunks[1, 2].tolist() == [128, 0, 34, 3]
    for j in (1, 2):
        a, lo, hi, _ = chunks[1, j].tolist()
        assert (snap.f[3, a + lo:a + hi] < 0).all()
    assert (chunks[-2:, :, 3] == 0).all() and not band[-2:].any()

    full_acc, full_gmax, _ = run_model(cfg, snap, chunks, 32, cull=False)
    acc, gmax, stats = run_model(cfg, snap, chunks, 32, cull=True)
    assert stats["blocks_left_early"] >= 3 and stats["empty_tiles"] >= 2
    np.testing.assert_array_equal(acc.view(np.int32), full_acc.view(np.int32))
    np.testing.assert_array_equal(gmax, full_gmax)
    p_acc, p_gmax = tnbk.cluster_pair_plain(cfg, snap, chunks, 32, 128)
    np.testing.assert_array_equal(gmax, p_gmax.numpy())
    assert acc_err(acc, p_acc.numpy()) < 1e-5
    out = (snap.f[3] < 0).numpy()
    assert not p_acc.numpy()[:, out].any() and (gmax[out] == IMIN).all()
    assert (gmax[~out] > IMIN).any() and np.abs(acc[:, ~out]).min() > 0


@pytest.mark.parametrize("b,want", [(32, (1, 32)), (48, (1, 64)),
                                    (64, (2, 32)), (512, (2, 256)),
                                    (1024, (2, 512))])
def test_geometry_covers_the_block(b, want):
    # the model's geometry is the launcher's, line for line
    text = SOURCE.read_text()
    assert "const int rows = b >= 32 * WIDE ? WIDE : 1;" in text
    assert "while (threads * rows < b) threads <<= 1;" in text
    assert "const int seg = TW / nw;" in text
    rows, threads = geometry(b)
    assert (rows, threads) == want
    assert threads <= 32 * MAX_WARPS
    assert rows * threads >= b and TW % (threads // 32) == 0
    assert (TW // (threads // 32)) % 4 == 0     # 16-byte fetches


def test_sweep_variants_change_one_constant_each():
    """Every variant of the sweep tool is the source with its constants
    changed and nothing else; without a card the tool says so and fails."""
    tree = SOURCE.read_text()
    for name, edits in sweep.VARIANTS:
        text = sweep._variant_source(edits)
        assert source_constants(text) == {**source_constants(), **edits}
        changed = [(a, b) for a, b in zip(tree.splitlines(),
                                          text.splitlines()) if a != b]
        assert len(changed) == len(edits), name
        # a piece still splits into 16-byte fetches among the warps
        c = source_constants(text)
        assert c["TW"] % (4 * c["MAX_WARPS"]) == 0
    with pytest.raises(ValueError):
        sweep._variant_source({"NO_SUCH": 1})
    if not torch.cuda.is_available():
        assert sweep.main([]) == 1
