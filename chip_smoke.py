#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``particlesystem_tpu_torch/csrc`` and
drives its main paths: the n-body simulation,
``NBodySimulation(NBodyConfig(), device="cuda").run()`` at the reference's
size (1,048,576 particles, 16^3 grid, 2,097,152 slots), the emitter
engine, ``ParticleSystem(capacity=10_485_760, alloc="select")`` with the
bench scene (BASELINE config 5, ``bench.py:44-62``), and the tools
(``python -m particlesystem_tpu_torch.tools.probe_alu_ops`` and
``...probe_two_shapes``), and the multi-device layer
(``parallel.DistributedNBodySimulation`` and ``ShardedEmitterEngine``, one
process a rank), and the bench, entry functions, launcher and measuring
tools built on them.  Before each, it checks the path's kernel against
its plain PyTorch version and the port on the card against the port on the
CPU.  Then it holds the dense neighbor pass against the kernel's on a
full-width frame and drives validate, checkpoint, profile_frame and the
readback ring.  Imports nothing of JAX: the machine with the card need not
have it.

Phases (any failure raises and exits non-zero):

0. the card: ``nvidia-smi`` name and power limit, torch's device name;
1. build the kernels (one nvcc per source, sm_90a) and print the build
   seconds and ptxas's registers, stack and spills;
2. kernel vs plain version on the card, on the prepared frame after two
   port frames of eight small configs (three tile shapes, a 32-row/128-column
   tile, a 48-row/96-column tile that fills neither a warp nor a fetch, a
   2-chunk budget that drops chunks, no softening and a softening of 1e-30,
   which take the kernel's variant that compares ids in the loop): ``gmax``
   exact, ``acc`` within
   1e-5 of max(1, max|acc|), two launches bit-identical, a subset of blocks
   in another order equal to the whole pass's rows; ``prepare`` on the card
   equals ``prepare`` on the CPU; then a synthetic frame with a chunk of
   kids only, a block of kids only and blocks of dead rows; then, after
   phase 4, the same on phase 4's plateau state (frame 20 on the prefix,
   a few in-band rows a live block, walked by warp groups) and at frame 0
   (every block full, walked as before), each whole-frame pass timed
   through the wrapper and in a CUDA graph beside the kernel's walk
   counters;
3. 12 frames of the port on the card against the port on the CPU (plain
   version): every stat and the alive/parent masks exact, floats by the
   chaotic-trajectory rule of tests/test_nbody_parity.py;
4. the n-body main path: ``run(10)`` twice at full size (the second call
   runs on the compacted active prefix), the kernel's launch count from
   those 20 frames, ms/frame of the second call (CUDA events), peak device
   memory, one more frame under ``torch.profiler`` (device time and the
   largest kernels); then, in two states, the plateau (this frame-20
   state, nearly every live particle a kid) and the adult-heavy one (frame
   0 of the same config, every particle an adult), kernel vs plain version
   timed on 64 evenly spaced live blocks and the kernel alone on the whole
   frame, with the pairs inside the stencil and the bound they and the
   live rows set (``benchmark/work.py``'s ``pair_pass`` at
   ``benchmark/peaks.py``'s peaks, as every bound here);
5. the physics-step kernel vs its plain version on the card, bit for bit:
   packed8 and slim, without and with the spawn window (cursor at the first
   and the last window), at 10,485,760 slots (bench scene) and at 32,768
   (no drag, two planes, two spheres);
6. 25 frames of the emitter engine on the card against the CPU for every
   (alloc, layout) pair at 16,384 slots: bookkeeping and alive masks exact,
   fields within 1e-4, the emitter frame's kernels launched once a frame;
7. the emitter main path: ``ParticleSystem`` at 10,485,760 slots for
   ``step(60)`` twice, then ``PackedEngine`` from an all-alive state at
   1,048,576 and 10,485,760 slots (select/packed8, ring/packed8,
   select/slim): ms/frame over ``step_many(64)`` and ``step_many(512)``,
   particle-steps/s, launches (the spawn, physics and tail kernels once a
   frame, the ring kernel on ring), peak memory, kernels and copies/sets
   a frame from ``torch.profiler``; then each physics-kernel variant vs
   the plain version timed at both sizes (plain, kernel, kernel, plain)
   beside its bound;
8. the probe kernels vs their plain versions on the card: every variant of
   ``probe_alu_ops`` at ``k = 8`` on the (512, 1024) tile (bit for bit;
   ``rsqrt`` within 2e-6 relative) and ``probe_affine`` at widths 512, 768,
   1024 and 770 (bit for bit); then the tools path, both tools' ``main()``: the
   per-variant table at ``k = 64`` and ``192``, the SASS opcodes that
   survived in the built kernels (``cuobjdump -sass``), and ``SAFE``; from
   the table, what the pair kernel's cell-delta test costs on the card;
   then each kernel's time beside its plain version, its bound and, for
   ``probe_affine``, the one PyTorch call that computes it and the parts
   of the wrapper's host time;
9. the dense pass on the card: from the state after phase 4's 20 frames,
   one full-width frame through ``impl="dense"`` and through
   ``impl="blocks"``: every stat and the alive, parent and tag columns
   equal, ``acc`` within 1e-5 of max(1, max|acc|); the dense frame's time,
   list width and peak memory;
10. validate, checkpoint, profile_frame, readback:
    ``NBodySimulation.validate(frames=2)`` at 16,384 particles in a 4^3 grid
    (the full config's 256 particles a cell; the numpy oracle walks every
    particle in Python); ``save`` after frame 10 of a full-width run,
    ``load`` into a fresh simulation, 5 more frames on both, bit-identical;
    ``profile_frame(k1=2, k2=6)`` at full width, its ``full_frame`` (the
    slope of the loop ``run`` executes) beside the bench's slope on the
    same simulation; ``ParticleSystem`` at 10,485,760
    slots with ``enable_readback(depth=3)``: 60 frames with every popped
    frame compared with ``packed()`` of its frame, then 60 frames timed
    without readback and 60 with a consumer thread draining the ring;
11. the multi-device path, the decomposed frame on the threefry kernel,
    B, C, the pair kernel, D and E (A is the cubic grid's): (a)
    ``DistributedNBodySimulation(NBodyConfig(), SlabSpec(n_devices=1,
    impl="blocks"))`` over a one-rank NCCL group at full width, ``run(10)``
    twice as one eager frame, one capture and 19 replays of its frame
    graph (the NCCL all-reduces captured in it), each kernel launched once
    a frame, bit-identical (state and statistics) to the single-device
    full-width step and to the single-device loop on the same
    arrangement, ms/frame of the second call beside the single-device
    loop's, peak memory, a trace of replays (kernels, copies and sets a
    replay, busy share), and the sharded checkpoint saved after frame 10
    and resumed bit-identically; (b) slab D=2, pencil (2, 2) and brick
    (2, 2, 2), ranks spawned on the one card over gloo, so eager (the
    tests' config shape at 32,768 particles; the slab's halo buffers 8,000
    rows, so its passes carry padding rows), each against the
    single-device run inside the parity windows (8, 7, 7 frames), every
    rank's kernels counted once a frame, with ms/frame and the bytes
    staged through the host.  In (a) and (b) the pair kernel is also held
    against its plain version on the inputs the decomposed step gives it
    (the rank's halo-extended grid, halo rows from other ranks, global
    ids, -1-id padding): the first pass of (a) on 64 evenly spaced live
    blocks, the first and the last pass of the window on every rank of
    (b), whole; (c) the data-parallel emitter, its ``step_many`` as graph
    replays: one rank at 10,485,760 slots bit for bit ``PackedEngine`` and
    its eager frames, two ranks at 1,048,576 slots sharing the card bit
    for bit the eager frames of two local engines salted 0 and 1.  Every
    spawn has a time limit;
12. the bench, the entry functions, the launcher and the measuring tools:
    (a) every stage of ``particlesystem_tpu_torch.bench`` at cut counts
    (``BENCH_CUT``) through ``bench.run``, the launches counted across it
    (both kernels launched, the pair kernel once a pass),
    the printed JSON line held to its keys with no value null; the first
    and the last pass run in Python of each n-body stage (10,485,760
    particles on 32^3 among them; the sharded stage's one eager frame)
    held against the plain version on 256 evenly spaced live
    blocks, and on the single-device passes the chunk table checked to
    list every stencil partner of those blocks' rows once, against a
    histogram of the cells; (b) ``entry()``'s frame on the card against
    the same frame on the CPU, two frames (bookkeeping and alive masks
    exact, fields within 1e-4, as phase 6), then ``dryrun_multichip(8)``
    on the card's ranks over gloo, one pair-kernel launch a rank for each
    decomposition; (c) the CLI, ``nbody --devices 2 --validate --save``,
    as two processes under the ``PSTPU_*`` launcher variables with
    ``--device cuda:0`` (each rank's pair-kernel launches read) and then
    ``--device cpu``; (d) ``tools.measure_ckpt_10m`` and
    ``tools.measure_batched_run`` once each;
13. the threefry kernel (``csrc/threefry.cu``) against its plain version
    (``core/rng.py``) bit for bit at full width: the n-body fields of all
    2,097,152 tags of ``NBodyConfig()``, the 20,971,520 of the 10M stage
    and phase 4's plateau prefix, each with the edge tags 0, 0x7FFFFFFF,
    0x80000000 and 0xFFFFFFFF, at frames 0 and 20; the emitter's spawn
    draws at the bench scene's ``SpawnTable.total``, salts 0 and 3;
    ``init_fill``'s four draws at 1M, the frame read from device memory;
    the fill kernel (``ps_nbody_fill``, ``init_fill`` on a card) against
    ``init_fill`` on the CPU at ``NBodyConfig()`` and at a small capacity,
    each at 0, 1, 4,097, ``n_fill`` and every slot; then each timed beside
    its bound (the instruction rate: 72 instructions a hash, and the keys
    each block derives; the fill's bytes), and its SASS counted; the fill
    also beside the composition it replaced, and traced: one device
    kernel in each ``nbody.fill`` span;
14. the frame loops as CUDA graphs against the eager frames: the n-body
    at ``NBodyConfig()`` full width, ``run`` in batches of 10, 2 and 8
    frames (the full-width key, then the prefix's) against 20 frames of
    ``models/nbody.step`` on the same prefixes, and ``PackedEngine``
    select/packed8, select/slim and ring/packed8 at 10,485,760 slots,
    ``step_many(64)`` and ``(56)`` (the emitter frame's kernels) against
    120 frames of its eager ``_frame`` (the plain versions around the
    physics kernel): every field, mask and stat bit-identical; the dense pass's loop (its keys changing with the
    list width) against the same loop on the CPU at phase 3's config;
    eager frames + replays = frames, each kernel
    recorded once a graph; ms a frame of both loops, the host's
    microseconds a replay, the graph's nodes, kernels a frame and the
    device's busy share from a trace of replays; then the same 8 frames
    from the same state traced replayed and eagerly, each kernel's sums
    side by side (each trace after one frame it leaves out, and taken
    again unless it holds each hand-written kernel once a frame);
15. the n-body frame's kernels A-E (``csrc/nbody_frame.cu``, through
    ``ops/frame_kernels.py``): each against its plain version on the same
    inputs, bit for bit (every field, record, mask, tag, flag, tile count
    and statistic; A and C with records and without; D and E into a fresh
    state and in place; E again after a call on other inputs, and D + E
    under two replays of one captured graph), at full width (2,097,152
    slots), on phase 4's plateau prefix, on the 10M stage's 20,971,520
    rows on 32^3 (a look-back over 5,120 of E's tiles) and on the edge
    states of ``tools/frame_states.py``, B and C also on a non-cubic
    grid with ids and -1 padding, D and E also on a slab rank's
    halo-extended pass at full width (more rows than slots, ``inv`` read
    for the rank's slots only); 20 frames of ``nbody.step`` against 20
    frames composed of the plain versions at full width, bit for bit;
    each kernel (A and C with records and without) timed through its
    wrapper, in a CUDA graph and in a graph with the L2 cleared before
    each launch, beside its bound (bytes; A's and E's counted on the run's
    data) and, for B, ``torch.searchsorted``, E beside one empty kernel in
    a graph, then A + C of each route against their summed bound; E at
    10M split by launch from a trace; a trace of the 10M stage's replayed
    frames, its largest kernels;
16. the emitter frame's kernels (``csrc/emitter_frame.cu``, through
    ``ops/engine_kernels.py``) against their plain versions on the card,
    bit for bit: the spawn window (rows, valid, the next accum; slim's
    death frame) on the bench scene at 1M and 10M slots, the entry scene,
    three emitters and none, packed8 and slim, frames 0, 1 and 2^31 - 1,
    salts 0 and 3; the ring write at three cursors (one wrapping) with
    none, some and all rows valid; the tail; then 120 frames of graph
    replays of select/packed8, select/slim, strided/packed8 and
    ring/packed8 at 1M slots and ring/packed8 at 65,536 (wrapping)
    against 120 eager plain frames, bit for bit; each kernel timed through
    its wrapper, in a CUDA graph and with the L2 cleared, beside its plain
    version, its bound and one empty kernel in a graph.
17. fresh simulations in a loop, the reference's own deployment: 1,000
    times ``NBodySimulation(NBodyConfig(seed=s)).run(10)`` at full size in
    this one process, each dropped before the next: the card's reserved
    memory read every 100 runs ends within 64 MB of its reading at run
    100, and every frame graph of the process shared one pool.

The frame loops (``NBodySimulation.run``,
``PackedEngine.step``/``step_many``, and ``ParticleSystem``, ``bench`` and
``entry()`` through them; ``DistributedNBodySimulation.run`` on a mesh of
one rank; ``ShardedEmitterEngine.step``/``step_many`` on every rank)
replay one CUDA graph a frame after a key's eager first frame.  The
n-body paths draw their random fields through the threefry kernel (once
a frame) and fill through the fill kernel (once an ``init_fill``), the
emitter engine's frame through its
spawn kernel, which hashes what each row uses itself; the launches are
read beside the other kernels' in phases 4, 6, 7, 9, 10, 11, 12 and 14
(a replay counts the launches its graph recorded), and phase 6 also
holds the threefry kernel's spawn draws on the card against those on the
CPU.  Every single-device n-body frame on the card runs A-E once (phases
4, 9, 12 and 14 read their launches), every decomposed blocks frame B-E
(phases 11 and 12); ``prepare`` runs B and C, C on the arrays it is
given.

The last lines are one JSON object describing the kernels, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time

from benchmark.peaks import FP32_FLOPS, bound_s
from benchmark.work import emitter_physics, pair_pass

SUBSET_BLOCKS = 64
MAIN_ITERS = 10

EMIT_SLOTS = 10 * 2 ** 20          # bench.py's 10M scene (BASELINE config 5)
ENGINE_SLOTS = (1 << 20, EMIT_SLOTS)
ENGINE_RUNS = (("select", "packed8"), ("ring", "packed8"), ("select", "slim"))
ENGINE_PAIRS = (("exact", "packed8", 1), ("exact", "packed8", 4),
                ("ring", "packed8", 1), ("strided", "packed8", 1),
                ("select", "packed8", 1), ("ring", "slim", 1),
                ("strided", "slim", 1), ("select", "slim", 1))
STEP_MANY = (64, 512)
TRAJ_TOL = 1e-4                    # tests/test_pallas_step.py:94
#: the n-body frame's kernels A-E (csrc/nbody_frame.cu), in frame order
FRAME_KERNELS = ("nbody_cells", "cell_starts", "block_prepare",
                 "nbody_lifecycle", "nbody_spawn")
#: their C entry points, under which ``cuda_build.launches()`` counts them
FRAME_ENTRIES = tuple(f"ps_{k}" for k in FRAME_KERNELS)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    from particlesystem_tpu_torch.bench import card_line as line
    return line()


def assert_close_chaotic(a, b, msg):
    """tests/test_nbody_parity.py:69-78: single-ulp differences amplify
    through close encounters, so 99.5% of elements within tight tolerance
    and all within a loose absolute bound."""
    import numpy as np
    err = np.abs(a - b)
    tol = 1e-3 + 1e-2 * np.abs(b)
    frac_bad = float(np.mean(err > tol))
    assert frac_bad <= 0.005, f"{msg}: {frac_bad:.2%} elements out of tolerance"
    assert float(err.max()) < 0.25, f"{msg}: max abs err {err.max()}"


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, CUDA events,
    after one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, n_bytes: float):
    """(least milliseconds, what bounds it) of ``flops`` float32 operations
    and ``n_bytes`` device-memory bytes: ``benchmark.peaks.bound_s``."""
    by = "bytes" if bound_s(0, n_bytes) >= bound_s(flops, 0) else "operations"
    return bound_s(flops, n_bytes) * 1e3, by


def nbody_frames(frames: int, **others) -> dict:
    """The launches of ``frames`` single-device blocks frames, by C entry
    point: the pair kernel, the threefry kernel and A-E once a frame;
    ``others`` added."""
    out = dict(ps_cluster_pair=frames, ps_nbody_frame_fields=frames,
               **{k: frames for k in FRAME_ENTRIES})
    for k, v in others.items():
        out[k] = out.get(k, 0) + v
    return out


def engine_frames(alloc: str, frames: int) -> dict:
    """The launches of ``frames`` frames of ``PackedEngine.step`` (graph
    replays and each key's eager first frame), by C entry point: the
    spawn, physics and tail kernels once a frame, and the ring kernel for
    ``alloc="ring"``."""
    out = dict(ps_emitter_spawn=frames, ps_physics_step=frames,
               ps_emitter_tail=frames)
    if alloc == "ring":
        out["ps_emitter_ring"] = frames
    return out


def launched(since: dict | None = None, expected: dict | None = None):
    """{C entry point: launches} since ``since``, an earlier reading of
    this function (the process's whole when None), the entry points that
    launched nothing left out: ``cuda_build.launches()``, where a replay
    counts the kernels its graph recorded.  Given ``expected`` ({entry
    point: launches}, 0 for one not named), asserts them."""
    from particlesystem_tpu_torch.utils import cuda_build
    since = since or {}
    counts = {k: n - since.get(k, 0)
              for k, n in cuda_build.launches().items()
              if n != since.get(k, 0)}
    if expected is not None:
        want = {k: n for k, n in expected.items() if n}
        assert counts == want, f"kernel launches {counts}, expected {want}"
    return counts


def same_bits(got, want, what) -> float:
    """Kernel outputs ``got`` equal to the plain version's ``want`` bit for
    bit (float32 tensors, compared as int32 on the CPU); returns the
    largest absolute difference, 0."""
    import torch
    err = 0.0
    for a, b in zip(got, want, strict=True):
        a, b = a.cpu(), b.cpu()
        assert a.shape == b.shape and torch.equal(
            a.view(torch.int32), b.view(torch.int32)), \
            f"{what}: kernel and plain version differ"
        if a.numel():
            err = max(err, float((a - b).abs().max()))
    return err


def compare_kernel(cfg, snap, chunks, b, ch, blocks=None):
    """Kernel vs plain version on the same card inputs, two launches of the
    kernel bit for bit, out-of-band rows zero; returns the largest absolute
    acc difference."""
    import torch
    from particlesystem_tpu_torch.ops import neighbor_blocks as nbk
    acc, gmax = nbk.cluster_pair_cuda(cfg, snap, chunks, b, ch, blocks)
    again = nbk.cluster_pair_cuda(cfg, snap, chunks, b, ch, blocks)
    ref_acc, ref_gmax = nbk.cluster_pair_plain(cfg, snap, chunks, b, ch,
                                               blocks)
    torch.cuda.synchronize()
    assert torch.isfinite(acc).all(), "kernel acc not finite"
    assert (torch.equal(acc.view(torch.int32), again[0].view(torch.int32))
            and torch.equal(gmax, again[1])), \
        "two launches on the same inputs differ"
    out_of_band = snap.f[3] < 0
    if blocks is not None:
        out_of_band = out_of_band.view(-1, b)[blocks.long()].reshape(-1)
    assert not acc[:, out_of_band].any() and (
        gmax[out_of_band] == nbk.IMIN).all(), "an out-of-band row has a sum"
    assert torch.equal(gmax, ref_gmax), \
        f"gmax differs in {int((gmax != ref_gmax).sum())} rows"
    err = (acc - ref_acc).abs().max().item()
    scale = max(1.0, ref_acc.abs().max().item())
    assert err / scale <= 1e-5, \
        f"acc error {err} exceeds 1e-5 of max(1, max|acc|) = {scale}"
    return err


def stencil_pairs(cfg, snap, b, blocks=None) -> int:
    """Ordered pairs of distinct in-band rows (live adults) inside each
    other's 3x3x3 stencil, of the rows of the listed blocks (all when
    None): the pairs ``benchmark.work.pair_pass`` counts.  Rows are counted
    per cell from the snapshot, and a row's stencil partners are the
    27-cell box sum less itself: with no chunk dropped, the chunk table
    lists every one of them."""
    import torch
    import torch.nn.functional as F
    g = cfg.grid.grid_dim
    dev = snap.f.device
    n_blocks = snap.f.shape[1] // b
    blk = (torch.arange(n_blocks, device=dev) if blocks is None
           else blocks.to(torch.int64))
    ok = snap.f[3] >= 0                       # in-band cell coordinates
    i1, i2, i3 = (snap.f[k].round().to(torch.int64).clamp(0, g - 1)
                  for k in (3, 4, 5))
    cnt = torch.zeros((g, g, g), dtype=torch.int64, device=dev)
    cnt.index_put_((i3[ok], i1[ok], i2[ok]),
                   torch.ones_like(i1[ok]), accumulate=True)
    pad = F.pad(cnt, (1, 1, 1, 1, 1, 1))
    box = sum(pad[a:a + g, c:c + g, e:e + g]
              for a in range(3) for c in range(3) for e in range(3))
    partners = torch.where(ok, box[i3, i1, i2] - 1, 0)
    rows = (blk[:, None] * b + torch.arange(b, device=dev)).reshape(-1)
    return int(partners[rows].sum())


def pair_bound(cfg, snap, b, n_alive: int, blocks=None):
    """(stencil pairs, live rows, least milliseconds, what bounds it) of
    one pair pass over the listed blocks (all when None) of a frame of
    ``n_alive`` live rows, which sort first: the benchmark's work
    (``work.pair_pass``) at its peaks."""
    import torch
    pairs = stencil_pairs(cfg, snap, b, blocks)
    if blocks is None:
        rows = n_alive
    else:
        first = blocks.to(torch.int64) * b
        rows = int((n_alive - first).clamp(0, b).sum())
    return (pairs, rows, *bound_ms(*pair_pass(pairs, rows)))


def phase_kernel_vs_plain(dev):
    import dataclasses
    import torch
    from particlesystem_tpu_torch import GridSpec, NBodyConfig
    from particlesystem_tpu_torch.models import nbody
    from particlesystem_tpu_torch.ops import neighbor_blocks as nbk
    from particlesystem_tpu_torch.tools.sweep_pair_kernel import (
        frame_inputs, synthetic_frame)

    configs = [  # tests/test_neighbor_blocks.py:22-32 and :82-89
        ("dense-g4", NBodyConfig(n_fill=1500, capacity=2048, max_per_cell=48,
                                 grid=GridSpec(grid_dim=4, chunk_factor=2),
                                 seed=3), {}),
        ("sparse-g16", NBodyConfig(n_fill=800, capacity=1024, seed=7,
                                   particle_life=2.0,
                                   grid=GridSpec(grid_dim=16)), {}),
        ("mid-g8", NBodyConfig(n_fill=6000, capacity=8192, seed=13,
                               grid=GridSpec(grid_dim=8, chunk_factor=2)),
         {}),
        ("planes-b32-ch128", NBodyConfig(n_fill=20_000, capacity=32768,
                                         grid=GridSpec(grid_dim=16), seed=3),
         dict(b=32, ch=128)),
        ("odd-b48-ch96", NBodyConfig(n_fill=2200, capacity=3072, seed=11,
                                     grid=GridSpec(grid_dim=8,
                                                   chunk_factor=2)),
         dict(b=48, ch=96)),
        ("mid-g8-cmax2", NBodyConfig(n_fill=6000, capacity=8192, seed=13,
                                     grid=GridSpec(grid_dim=8,
                                                   chunk_factor=2)),
         dict(c_max=2)),
        # no softening, and one too small to keep rsqrt(eps2)^3 * w finite:
        # the kernel's variant that compares the ids of every pair
        ("dense-g4-eps0", NBodyConfig(n_fill=1500, capacity=2048,
                                      max_per_cell=48, eps2=0.0, seed=3,
                                      grid=GridSpec(grid_dim=4,
                                                    chunk_factor=2)), {}),
        ("planes-b32-eps1e-30", NBodyConfig(n_fill=20_000, capacity=32768,
                                            eps2=1e-30, seed=3,
                                            grid=GridSpec(grid_dim=16)),
         dict(b=32, ch=128)),
    ]
    worst = 0.0
    for name, cfg, tiles in configs:
        # the frames are stepped with the default softening, so that the
        # state is an ordinary one whatever softening the kernel is given
        soft = dataclasses.replace(cfg, eps2=NBodyConfig.eps2)
        st = nbody.init_fill(soft, dev)
        for f in range(2):
            st, _ = nbody.step(st, f, soft)
        card = frame_inputs(cfg, st, **tiles)
        host = frame_inputs(cfg, st.to("cpu"), **tiles)
        (snap, chunks, order, ovf, occ, counts, dropped) = card
        for what, a, b in zip(
                ("snap.f", "snap.i", "chunks", "order", "overflow", "occ",
                 "counts", "dropped"),
                (snap.f, snap.i, chunks, order, ovf, occ, counts, dropped),
                (host[0].f, host[0].i) + tuple(host[1:])):
            assert torch.equal(a.cpu(), b), f"{name}: prepare {what} differs"
        if "c_max" in tiles:
            assert int(dropped) > 0, f"{name}: no chunk dropped"
        else:
            assert int(dropped) == 0, f"{name}: {int(dropped)} dropped"
        b, ch = tiles.get("b", nbk.B), tiles.get("ch", nbk.CH)
        err = compare_kernel(cfg, snap, chunks, b, ch)
        # a subset in another order lands on output rows k * b, bit for bit
        nb = chunks.shape[0]
        sub = torch.tensor([nb - 1, 0, nb // 2, 1][:nb], dtype=torch.int32,
                           device=dev)
        err = max(err, compare_kernel(cfg, snap, chunks, b, ch, sub))
        # without softening the sums are some orders of magnitude larger,
        # and their absolute error says nothing beside the others'
        if cfg.eps2 == NBodyConfig.eps2:
            worst = max(worst, err)
        acc, gmax = nbk.cluster_pair_cuda(cfg, snap, chunks, b, ch)
        acc_s, gmax_s = nbk.cluster_pair_cuda(cfg, snap, chunks, b, ch, sub)
        rows = (sub.long()[:, None] * b
                + torch.arange(b, device=dev)).reshape(-1)
        assert torch.equal(acc_s, acc[:, rows]) and torch.equal(
            gmax_s, gmax[rows]), f"{name}: a block subset differs"
        in_band = int((snap.f[3] >= 0).sum())
        print(f"phase 2 {name}: prepare card == cpu, gmax exact, acc max "
              f"abs err {err:.3e} (limit 1e-5 of max(1, max|acc|), max|acc| "
              f"{acc.abs().max().item():.3e}), two "
              f"launches bit-identical, subset {sub.tolist()} == whole pass, "
              f"{in_band} of {snap.f.shape[1]} rows in band, dropped "
              f"{int(dropped)}")

    # a chunk of kids only, a block of kids only, blocks of dead rows
    cfg, args, tags = synthetic_frame(dev)
    snap, chunks, *_ = nbk.prepare(*args, cfg, tags, b=32, ch=128)
    band = (snap.f[3] >= 0).view(-1, 32)
    ct = chunks.cpu()
    kids_only = [
        (k, j) for k in range(ct.shape[0]) for j in range(int(ct[k, 0, 3]))
        if not (snap.f[3, ct[k, j, 0] + ct[k, j, 1]:
                       ct[k, j, 0] + ct[k, j, 2]] >= 0).any()]
    assert band[1].all() and kids_only and any(k == 1 for k, _ in kids_only), \
        "no chunk of kids only beside a block of adults"
    assert not band[0].any() and int(ct[0, 0, 3]) > 0, \
        "no listed block of kids only"
    assert (ct[-2:, 0, 3] == 0).all(), "no block without a chunk"
    err = compare_kernel(cfg, snap, chunks, 32, 128)
    _, gmax = nbk.cluster_pair_cuda(cfg, snap, chunks, 32, 128)
    assert (gmax > nbk.IMIN).any(), "synthetic frame: nothing touches"
    worst = max(worst, err)
    print(f"phase 2 synthetic: {len(kids_only)} listed chunks hold kids only, "
          f"block 0 is kids only, the last {int((ct[:, 0, 3] == 0).sum())} "
          f"blocks list nothing: gmax exact, acc max abs err {err:.3e}, two "
          f"launches bit-identical")
    return worst


def phase_pair_frames(dev, plateau_state, plateau_frame: int) -> float:
    """Phase 2 on phase 4's states: the kernel against its plain version
    (:func:`compare_kernel`) on the plateau state (frame
    ``plateau_frame`` on the prefix: a few in-band rows a live block, so
    the kernel walks them by warp groups) and on frame 0 (every particle an
    adult: every block walked as before), the walk counters read around
    each, and the whole-frame pass timed through the wrapper and in a CUDA
    graph.  Returns the largest ``acc`` difference."""
    from particlesystem_tpu_torch import NBodyConfig
    from particlesystem_tpu_torch.models import nbody
    from particlesystem_tpu_torch.ops import neighbor_blocks as nbk
    from particlesystem_tpu_torch.tools.sweep_pair_kernel import frame_inputs

    cfg = NBodyConfig()
    states = ((f"plateau (frame {plateau_frame}, {plateau_state.slots} "
               f"rows)", plateau_state),
              (f"adult-heavy (frame 0, {cfg.slots} rows)",
               nbody.init_fill(cfg, dev)))
    worst = 0.0
    for name, st in states:
        snap, chunks = frame_inputs(cfg, st)[:2]
        live = int((snap.f[3].view(-1, nbk.B) >= 0).any(dim=1).sum())
        before = nbk.walk_counts(dev)
        err = compare_kernel(cfg, snap, chunks, nbk.B, nbk.CH)
        after = nbk.walk_counts(dev)
        whole = lambda: nbk.cluster_pair_cuda(cfg, snap, chunks, nbk.B,
                                              nbk.CH)
        wrapper_ms, in_graph_ms = cuda_ms(whole, 10), graph_ms(whole, 10)
        assert after["passes"] - before["passes"] == 2, (before, after)
        sparse = (after["sparse_blocks"] - before["sparse_blocks"]) // 2
        assert 0 <= sparse <= live
        assert sparse > 0 or st is not plateau_state, \
            "no block of the plateau was walked by warp groups"
        worst = max(worst, err)
        print(f"phase 2: {name}: {live} live blocks of {chunks.shape[0]}, "
              f"{sparse} of them sparse (walked by warp groups): gmax "
              f"exact, acc max abs err {err:.3e}, two launches "
              f"bit-identical; whole frame {wrapper_ms:.4f} ms through the "
              f"wrapper, {in_graph_ms:.4f} in a CUDA graph")
        del snap, chunks
    return worst


def phase_card_vs_cpu(dev):
    import numpy as np
    from particlesystem_tpu_torch import GridSpec, NBodyConfig
    from particlesystem_tpu_torch.core.state import state_to_numpy
    from particlesystem_tpu_torch.models import nbody

    cfg = NBodyConfig(n_fill=2000, capacity=4096, max_per_cell=48, seed=3,
                      grid=GridSpec(grid_dim=4, cell_size=5.0,
                                    chunk_factor=2))  # DENSE
    card = nbody.init_fill(cfg, dev)
    host = nbody.init_fill(cfg, "cpu")
    kills = 0
    for frame in range(12):
        card, cst = nbody.step(card, frame, cfg)
        host, hst = nbody.step(host, frame, cfg)
        for k, v in vars(hst).items():
            assert int(getattr(cst, k)) == int(v), f"frame {frame}: {k}"
        a, b = state_to_numpy(card), state_to_numpy(host)
        for f in ("alive", "parent"):
            assert np.array_equal(a[f], b[f]), f"frame {frame}: {f}"
        for f in ("pos", "vel", "age", "life", "w"):
            assert_close_chaotic(a[f], b[f], f"frame {frame} {f}")
        kills += int(hst.n_collision_kills)
    assert kills > 0, "no collision kill exercised"
    print(f"phase 3: 12 frames card == cpu (events exact, "
          f"{kills} collision kills)")


def phase_main_path(dev):
    import torch
    from particlesystem_tpu_torch import NBodyConfig
    from particlesystem_tpu_torch.api import NBodySimulation
    from particlesystem_tpu_torch.models import nbody
    from particlesystem_tpu_torch.tools.sweep_pair_kernel import frame_inputs

    cfg = NBodyConfig()
    torch.cuda.reset_peak_memory_stats()
    base = launched()
    sim = NBodySimulation(cfg, device=dev)
    t0 = time.perf_counter()
    sim.run(MAIN_ITERS, verbose=True)
    first_s = time.perf_counter() - t0
    active_second = sim._active
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sim.run(MAIN_ITERS, verbose=True)
    end.record()
    torch.cuda.synchronize()
    # the pair kernel, the threefry kernel and A-E: once a frame; the fill
    # kernel once, for init_fill
    counts = launched(base, nbody_frames(2 * MAIN_ITERS, ps_nbody_fill=1))
    n_launch = counts["ps_cluster_pair"]
    ms_frame = start.elapsed_time(end) / MAIN_ITERS
    peak = torch.cuda.max_memory_allocated()

    st = sim.state
    alive = st.alive
    n_alive = int(alive.sum())
    assert sim.n_degraded_frames == 0 and int(
        sim.last_stats.n_listed_dropped) == 0, "chunks dropped"
    assert n_alive > 0, "nothing alive"
    for f in ("pos", "vel", "acc", "age", "life", "w"):
        assert torch.isfinite(getattr(st, f)).all(), f"non-finite {f}"
    bound = cfg.grid.half_extent + cfg.grid.cell_size
    assert (st.pos[alive].abs() <= bound).all(), "alive particle out of box"
    print(f"phase 4: frames 1-{MAIN_ITERS} {first_s:.3f} s (first call, "
          f"full width, includes warm-up); frames {MAIN_ITERS + 1}-"
          f"{2 * MAIN_ITERS} {ms_frame:.3f} ms/frame (with the prefix "
          f"graph's warm-up frame and capture) on active prefix "
          f"{active_second or cfg.slots} of {cfg.slots} slots; alive "
          f"{n_alive}; kernel launches {n_launch} (pair), "
          f"{counts['ps_nbody_frame_fields']} (threefry), "
          f"{counts['ps_nbody_fill']} (fill), "
          + ", ".join(f"{counts[k]} ({k})" for k in FRAME_ENTRIES)
          + f"; peak memory {peak} bytes ({peak / 2**30:.3f} GiB)")

    eager_kernels = profile_nbody_frame(sim)

    # the plateau state: this frame, on the active prefix
    rows = sim._active or cfg.slots
    head = st.map(lambda a: a[:rows])
    snap, chunks, *_ = frame_inputs(cfg, head)
    plateau = time_pair_state(f"plateau (frame {sim.frame})", cfg, snap,
                              chunks, n_alive, dev)
    del snap, chunks, head
    # the adult-heavy state: frame 0, every particle an adult, full width
    fresh = nbody.init_fill(cfg, dev)
    snap, chunks, *_ = frame_inputs(cfg, fresh)
    adult = time_pair_state("adult-heavy (frame 0)", cfg, snap, chunks,
                            int(fresh.alive.sum()), dev)
    return sim, dict(launches=n_launch, plateau=plateau, adult=adult,
                     eager_kernels=eager_kernels,
                     err=max(plateau["err"], adult["err"]),
                     rng_launches=counts["ps_nbody_frame_fields"],
                     fill_launches=counts["ps_nbody_fill"],
                     frame_launches={k: counts[f"ps_{k}"]
                                     for k in FRAME_KERNELS},
                     plateau_tags=st.tag[:rows].clone(),
                     plateau_state=st.map(lambda a: a[:rows].clone()),
                     plateau_frame=sim.frame)


def profile_nbody_frame(sim, top: int = 4):
    """One frame from ``sim``'s state (not kept) under torch.profiler: the
    device's time beside the frame's, and the kernels that take most of it
    (a trace that holds each of the frame's own kernels once)."""
    from particlesystem_tpu_torch.models import nbody

    step = lambda: nbody.step(sim.state, sim.frame, sim.cfg, "blocks",
                              sim._active)
    trace = trace_frames(step, 1, expect=NBODY_FRAME_FUNCTIONS)
    by_name, wall_ms = trace["sums"], trace["wall_ms"]
    device_ms = trace["device_ms"]
    largest = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    print(f"phase 4: frame {sim.frame} under torch.profiler: {wall_ms:.3f} ms "
          f"on the host's clock, {device_ms:.3f} ms of device time "
          f"({device_ms / wall_ms:.1%}) in "
          f"{sum(n for n, _ in by_name.values())} kernels and copies; "
          f"largest: " + "; ".join(
              f"{name[:48]} x{n} {us / 1e3:.3f} ms"
              for name, (n, us) in largest))
    frame_kernels = frame_kernel_times(by_name, 1)
    print("phase 4: the frame kernels in that trace: " + "; ".join(
        f"{k} x{n} {us / 1e3:.4f} ms" for k, (n, us) in frame_kernels.items()))
    pair = [us for name, (_, us) in by_name.items() if "cluster_pair" in name]
    assert pair, "the trace holds no cluster-pair kernel"
    rng = [(n, us) for name, (n, us) in by_name.items()
           if "nbody_frame_fields" in name]
    assert rng, "the trace holds no threefry kernel"
    assert not any("cummax" in name for name in by_name), \
        "prepare still runs cummax"
    print(f"phase 4: the threefry kernel in that trace: "
          f"x{sum(n for n, _ in rng)} {sum(us for _, us in rng) / 1e3:.4f} "
          f"ms; no cummax")
    print(f"phase 4: the cluster-pair kernel in that trace: "
          f"{sum(pair) / 1e3:.4f} ms")
    return sum(n for n, _ in by_name.values())


def kernel_sums(events) -> dict:
    """{name: (count, microseconds)} of a trace's device events."""
    by_name = {}
    for e in events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return by_name


#: the kernel functions of csrc/nbody_frame.cu, as a trace names them
FRAME_KERNEL_FUNCTIONS = ("nbody_cells", "cell_starts", "block_prepare",
                          "nbody_lifecycle", "spawn_rank", "spawn_write")
#: the hand-written kernels an n-body frame launches once each
NBODY_FRAME_FUNCTIONS = FRAME_KERNEL_FUNCTIONS + ("cluster_pair_kernel",
                                                  "cluster_pair_kernel_sparse",
                                                  "nbody_frame_fields")


def _launches_of(by_name, k: str) -> list:
    """(count, microseconds) of each name of a kernel function ``k`` (a
    template's instances included) in a trace's sums."""
    pattern = re.compile(rf"(^|\W){k}([(<]|$)")
    return [(n, us) for name, (n, us) in by_name.items()
            if pattern.search(name)]


def frame_kernel_times(by_name, frames: int) -> dict:
    """{kernel function of csrc/nbody_frame.cu: (launches, microseconds)}
    in the sums of a trace of ``frames`` frames, each launched once a
    frame."""
    out = {}
    for k in FRAME_KERNEL_FUNCTIONS:
        hits = _launches_of(by_name, k)
        n = sum(h[0] for h in hits)
        assert n == frames, \
            f"the trace holds {n} launches of {k}, expected {frames}"
        out[k] = (n, sum(h[1] for h in hits))
    return out


def time_pair_state(name, cfg, snap, chunks, n_alive, dev):
    """Kernel vs plain version on 64 evenly spaced live blocks of one
    prepared frame, timed (plain, kernel, kernel, plain), and the kernel
    alone on the whole frame, each beside its work and bound."""
    import torch
    from particlesystem_tpu_torch.ops import neighbor_blocks as nbk

    live_blocks = max(1, -(-n_alive // nbk.B))
    blocks = torch.linspace(0, live_blocks - 1, SUBSET_BLOCKS,
                            device=dev).round().to(torch.int32)
    err = compare_kernel(cfg, snap, chunks, nbk.B, nbk.CH, blocks)
    kern = lambda: nbk.cluster_pair_cuda(cfg, snap, chunks, nbk.B, nbk.CH,
                                         blocks)
    plain = lambda: nbk.cluster_pair_plain(cfg, snap, chunks, nbk.B, nbk.CH,
                                           blocks)
    whole = lambda: nbk.cluster_pair_cuda(cfg, snap, chunks, nbk.B, nbk.CH)
    plain_ms = cuda_ms(plain, 3)
    kern_ms = cuda_ms(kern, 20)
    kern_ms2 = cuda_ms(kern, 20)
    plain_ms2 = cuda_ms(plain, 3)
    first, second = whole(), whole()
    assert (torch.equal(first[0].view(torch.int32),
                        second[0].view(torch.int32))
            and torch.equal(first[1], second[1])), \
        f"{name}: two whole-frame launches differ"
    del first, second
    full_ms = min(cuda_ms(whole, 5), cuda_ms(whole, 5))
    in_band = int((snap.f[3] >= 0).sum())
    print(f"phase 4: {name}: {n_alive} alive, {in_band} rows in band of "
          f"{snap.f.shape[1]}; {SUBSET_BLOCKS}-block subset of "
          f"{chunks.shape[0]} blocks: kernel {kern_ms:.4f} / {kern_ms2:.4f} "
          f"ms, plain {plain_ms:.3f} / {plain_ms2:.3f} ms (plain, kernel, "
          f"kernel, plain); acc max abs err {err:.3e}, two launches "
          f"bit-identical; whole-frame kernel {full_ms:.4f} ms")
    out = dict(err=err, ms=min(kern_ms, kern_ms2),
               plain_ms=min(plain_ms, plain_ms2), frame_ms=full_ms)
    for what, sel, t in (("subset", blocks, out["ms"]),
                         ("whole frame", None, full_ms)):
        pairs, rows, bound, by = pair_bound(cfg, snap, nbk.B, n_alive, sel)
        print(f"phase 4: {name}, {what}: {pairs} pairs inside the stencil, "
              f"{rows} live rows (benchmark/work.py's pair_pass): bound "
              f"{bound:.4f} ms ({by}), {bound / t:.1%} of it")
        if sel is not None:
            out.update(bound_ms=bound, bound_by=by)
    return out


# ---------------------------------------------------------------------------
# the emitter engine
# ---------------------------------------------------------------------------


def bench_scene(capacity: int):
    """bench.py:44-62: two emitters (spawn budgets 1001 + 668 rows, padded
    to 2048), a ground plane and a sphere, drag toward a wind."""
    from particlesystem_tpu_torch import (Emitter, EmitterSceneConfig,
                                          PlaneCollider, SphereCollider)
    return EmitterSceneConfig(
        capacity=capacity, dt=1.0 / 60.0, gravity=(0.0, -9.8, 0.0),
        wind=(2.0, 0.0, -0.5), drag=0.2,
        emitters=(
            Emitter(pos=(0.0, 1.0, 0.0), direction=(0.0, 1.0, 0.0),
                    speed=10.0, rate=60_000.0, life_min=20.0, life_max=40.0),
            Emitter(pos=(5.0, 1.0, 0.0), direction=(-0.2, 1.0, 0.1),
                    speed=8.0, rate=40_000.0, life_min=20.0, life_max=40.0)),
        planes=(PlaneCollider(point=(0, 0, 0), normal=(0, 1, 0),
                              restitution=0.5, friction=0.2),),
        spheres=(SphereCollider(center=(2.0, 3.0, 0.0), radius=1.5,
                                restitution=0.4, friction=0.1),),
        seed=1)


def bench_system(dev):
    """The bench scene through ``ParticleSystem`` at 10,485,760 slots."""
    from particlesystem_tpu_torch.api import ParticleSystem
    return (ParticleSystem(capacity=EMIT_SLOTS, dt=1.0 / 60.0,
                           gravity=(0.0, -9.8, 0.0), wind=(2.0, 0.0, -0.5),
                           drag=0.2, seed=1, alloc="select", device=dev)
            .add_emitter(pos=(0.0, 1.0, 0.0), direction=(0.0, 1.0, 0.0),
                         speed=10.0, rate=60_000.0, life_min=20.0,
                         life_max=40.0)
            .add_emitter(pos=(5.0, 1.0, 0.0), direction=(-0.2, 1.0, 0.1),
                         speed=8.0, rate=40_000.0, life_min=20.0,
                         life_max=40.0)
            .add_plane(point=(0, 0, 0), normal=(0, 1, 0), restitution=0.5,
                       friction=0.2)
            .add_sphere(center=(2.0, 3.0, 0.0), radius=1.5, restitution=0.4,
                        friction=0.1))


def undamped_scene(capacity: int):
    """No drag, two tilted planes, two spheres."""
    from particlesystem_tpu_torch import (Emitter, EmitterSceneConfig,
                                          PlaneCollider, SphereCollider)
    return EmitterSceneConfig(
        capacity=capacity, dt=1 / 50, gravity=(0.5, -9.8, 0.25),
        emitters=(Emitter(rate=3000.0),),
        planes=(PlaneCollider(point=(0, 0, 0), normal=(0.1, 1, 0.05),
                              restitution=0.7, friction=0.1),
                PlaneCollider(point=(4.0, 0, 0), normal=(-1, 0.2, 0),
                              restitution=0.3, friction=0.45)),
        spheres=(SphereCollider(center=(0.3, 1.5, 0.0), radius=0.9,
                                restitution=0.4, friction=0.1),
                 SphereCollider(center=(2.0, 0.5, 1.0), radius=1.2,
                                restitution=0.8, friction=0.0)),
        seed=5)


def random_fields(n: int, seed: int, slim: bool = False):
    """numpy float32 fields: 30% never-spawned rows, some expired rows,
    positions below the ground plane and inside the spheres.  ``slim``
    turns (age, life) into a death frame (0 for never-spawned rows)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-3.0, 5.0, (3, n)).astype(np.float32)
    vel = rng.uniform(-6.0, 6.0, (3, n)).astype(np.float32)
    life = rng.uniform(0.0, 2.0, n).astype(np.float32)
    life[rng.uniform(size=n) < 0.3] = 0.0
    age = (life * rng.uniform(0.0, 1.1, n)).astype(np.float32)
    if slim:
        return (*pos, *vel, np.floor(life * 60.0).astype(np.float32))
    return (*pos, *vel, age, life)


def full_packed(n: int, seed: int):
    """bench.py:65-73: every slot alive with a long lifetime."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-20.0, 20.0, (3, n)).astype(np.float32)
    vel = rng.uniform(-5.0, 5.0, (3, n)).astype(np.float32)
    life = rng.uniform(30.0, 60.0, n).astype(np.float32)
    return (*pos, *vel, (life * np.float32(0.1)).astype(np.float32), life)


def spawn_window(n_fields: int, w: int, n_valid: int, cursor: int, dev,
                 seed: int):
    """Random padded spawn rows with the first ``n_valid`` of ``w`` valid,
    and the cursor as a device int32."""
    import torch
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rows = torch.rand((n_fields, w), generator=gen) * 4.0 - 1.0
    valid = torch.arange(w) < n_valid
    return (rows.to(dev), valid.to(dev),
            torch.tensor(cursor, dtype=torch.int32, device=dev))


def physics_bytes(fields, window) -> int:
    """Bytes of one physics-step call on these inputs, as the benchmark
    counts them (``work.emitter_physics``): the live rows the kernel steps
    (those no valid window row replaces) and the window's valid rows."""
    import torch
    live = (fields[6] > 0 if len(fields) == 7
            else (fields[6] <= fields[7]) & (fields[7] > 0))
    spawned = torch.zeros_like(live)
    w = 0
    if window is not None:
        _, valid, cursor = window
        w = valid.shape[0]
        c = int(cursor)
        spawned[c:c + w] = valid
    return emitter_physics(fields[0].shape[0], int((live & ~spawned).sum()),
                           int(spawned.sum()), w, len(fields))


def compare_physics(cfg, host_fields, window, dev):
    """Kernel vs plain version on the same card inputs, bit for bit;
    returns the largest absolute difference (0.0 when bitwise)."""
    import torch
    from particlesystem_tpu_torch.ops import physics_kernel as pk
    fields = tuple(torch.tensor(a, device=dev) for a in host_fields)
    want = pk.physics_step_plain(fields, cfg, window)
    got = pk.physics_step_cuda(tuple(f.clone() for f in fields), cfg, window)
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), \
            f"field {i}: {int((g != w).sum())} rows differ, max {err}"
    return err


def phase_physics_vs_plain(dev):
    from particlesystem_tpu_torch.runtime.engine import PackedEngine
    worst = 0.0
    for cfg, seed in ((bench_scene(EMIT_SLOTS), 21),
                      (undamped_scene(32768), 22)):
        n = cfg.slots
        w = PackedEngine(cfg, alloc="strided", device=dev).spawn_width
        for layout in ("packed8", "slim"):
            host = random_fields(n, seed, slim=layout == "slim")
            nf = len(host)
            for cursor in (None, 0, n - w):
                window = None if cursor is None else spawn_window(
                    nf, w, w * 4 // 5, cursor, dev, seed)
                err = compare_physics(cfg, host, window, dev)
                worst = max(worst, err)
                where = ("no window" if cursor is None
                         else f"window at cursor {cursor}")
                print(f"phase 5: {n} slots, {len(cfg.planes)} planes, "
                      f"{len(cfg.spheres)} spheres, drag {cfg.drag}, "
                      f"{layout}, {where}: kernel == plain bit for bit")
    return worst


def engine_alive(eng, fields, frame):
    if eng.layout == "slim":
        return frame < fields[6]
    return (fields[6] <= fields[7]) & (fields[7] > 0)


def phase_engine_card_vs_cpu(dev):
    import numpy as np
    import torch
    from particlesystem_tpu_torch.models import emitter as em
    from particlesystem_tpu_torch.models.emitter import SpawnTable
    from particlesystem_tpu_torch.ops import rng_kernel as rk
    from particlesystem_tpu_torch.runtime.engine import (
        PackedEngine, engine_state_to_numpy)
    cfg = bench_scene(16384)
    init = random_fields(cfg.slots, 23)
    worst = 0.0
    for alloc, layout, refresh in ENGINE_PAIRS:
        kw = dict(alloc=alloc, layout=layout, refresh_interval=refresh)
        card = PackedEngine(cfg, device=dev, **kw)
        host = PackedEngine(cfg, device="cpu", **kw)
        sc, sh = card.init(init), host.init(init)
        base = launched()
        nf = card.n_fields
        for frame in range(25):
            sc, sh = card.step(sc), host.step(sh)
            a, b = engine_state_to_numpy(sc), engine_state_to_numpy(sh)
            for name, x, y in zip(("accum", "free_list", "cursor", "n_free"),
                                  a[nf:], b[nf:]):
                assert np.array_equal(x, y), f"{alloc}/{layout}: {name}"
            fa = [f.cpu().numpy() for f in card.flat_fields(sc)]
            fb = [f.cpu().numpy() for f in host.flat_fields(sh)]
            assert np.array_equal(engine_alive(card, fa, sc.frame),
                                  engine_alive(host, fb, sh.frame)), \
                f"{alloc}/{layout} frame {frame}: alive masks differ"
            for i, (x, y) in enumerate(zip(a[:nf], b[:nf])):
                err = np.abs(x - y)
                assert (err <= TRAJ_TOL + TRAJ_TOL * np.abs(y)).all(), \
                    f"{alloc}/{layout} frame {frame} field {i}: {err.max()}"
                worst = max(worst, float(err.max()))
        counts = launched(base, engine_frames(alloc, 25))
        n_alive = int(card.alive_count(sc))
        assert n_alive == int(host.alive_count(sh)) > 0
        print(f"phase 6: {alloc}/{layout} refresh {refresh}: 25 frames card "
              f"== cpu (bookkeeping and alive exact, {n_alive} alive, 25 "
              f"launches of each kernel: {', '.join(counts)})")
    print(f"phase 6: largest field difference {worst:.3e} (limit "
          f"{TRAJ_TOL} + {TRAJ_TOL} * |cpu|)")
    # the spawn rows' random draws: the kernel on the card, the plain
    # version on the CPU
    total = SpawnTable(cfg, "cpu").total
    draws = em.spawn_draws(cfg, 0, total)
    for frame in range(25):
        frame_t = torch.tensor(frame, dtype=torch.int64, device=dev)
        same_bits(rk.flat_fields(draws, frame_t, dev),
                  rk.flat_fields(draws, frame, "cpu"),
                  f"spawn draws of frame {frame}")
    print(f"phase 6: spawn draws u ({total}, 8) and dirs ({total}, 3) of "
          f"frames 0-24: card == cpu bit for bit")


def check_emitter_state(eng, es, what):
    """No NaN; alive rows above the ground plane; age <= life (packed8)."""
    import torch
    f = eng.flat_fields(es)
    for i, t in enumerate(f):
        assert torch.isfinite(t).all(), f"{what}: field {i} not finite"
    alive = engine_alive(eng, f, es.frame)
    assert (f[1][alive] >= 0).all(), f"{what}: alive row below the plane"
    if eng.layout == "packed8":
        assert (f[6][alive] <= f[7][alive]).all(), f"{what}: age > life"
    return int(alive.sum())


def profile_frames(eng, es, k):
    """(state, kernels per frame, copies and sets per frame, device busy
    share) over ``k`` frames, from torch.profiler's device events (the
    tracer can miss some, so both are lower bounds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        es = eng.step_many(es, k)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    moves = [e for e in events if e.name.startswith(("Memcpy", "Memset"))]
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    return (es, (len(events) - len(moves)) / k, len(moves) / k,
            busy_us / wall_us)


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Mean milliseconds of ``fn``'s device work with the host's time
    between launches left out: ``reps`` calls captured once in a CUDA
    graph, one replay to warm up, then the quickest of ``replays`` replays
    by CUDA events (a replay is short enough for one hiccup of the card's
    clocks to double it)."""
    import torch
    from particlesystem_tpu_torch.utils.cuda_build import recording
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # a capture launches nothing: its launches are not counted
    with recording(), torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    best = float("inf")
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best / reps


def phase_emitter_main_path(dev):
    import torch
    from particlesystem_tpu_torch.ops import physics_kernel as pk
    from particlesystem_tpu_torch.runtime.engine import PackedEngine

    # the main path: the scene built through ParticleSystem, full width
    torch.cuda.reset_peak_memory_stats()
    base = launched()
    ps = bench_system(dev)
    assert ps.config == bench_scene(EMIT_SLOTS)
    t0 = time.perf_counter()
    ps.step(60)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ps.step(60)
    end.record()
    torch.cuda.synchronize()
    main_counts = counts = launched(base, engine_frames("select", 120))
    n_alive = check_emitter_state(ps._engine, ps._es, "ParticleSystem")
    assert n_alive == ps.alive_count() > 0
    print(f"phase 7: ParticleSystem {EMIT_SLOTS} slots, select/packed8: "
          f"frames 1-60 {first_s:.3f} s (first call); frames 61-120 "
          f"{start.elapsed_time(end) / 60:.4f} ms/frame; alive {n_alive}; "
          f"kernel launches {counts['ps_emitter_spawn']} (spawn), "
          f"{counts['ps_physics_step']} (physics), "
          f"{counts['ps_emitter_tail']} (tail), "
          f"{counts.get('ps_flat_fields', 0)} (threefry); peak memory "
          f"{torch.cuda.max_memory_allocated()} bytes")

    # bench.py:80-119: the engine from an all-alive state; the ring
    # kernel's path is ring's runs
    ring_launches = 0
    for n in ENGINE_SLOTS:
        cfg = bench_scene(n)
        init = full_packed(n, 24)
        for alloc, layout in ENGINE_RUNS:
            torch.cuda.reset_peak_memory_stats()
            base = launched()
            eng = PackedEngine(cfg, alloc=alloc, layout=layout, device=dev)
            es = eng.init(init)
            es = eng.step_many(es, 8)                    # warm-up
            frames = 8
            ms = {}
            for k in STEP_MANY:
                start.record()
                es = eng.step_many(es, k)
                end.record()
                torch.cuda.synchronize()
                ms[k] = start.elapsed_time(end) / k
                frames += k
            counts = launched(base, engine_frames(alloc, frames))
            ring_launches += counts.get("ps_emitter_ring", 0)
            n_alive = check_emitter_state(eng, es, f"{n} {alloc}/{layout}")
            assert n_alive == int(eng.alive_count(es)) > 0
            short, long_ = STEP_MANY
            line = (f"phase 7: engine {n} slots {alloc}/{layout}: "
                    f"{ms[short]:.4f} ms/frame over {short} frames, "
                    f"{ms[long_]:.4f} over {long_}; "
                    f"{n / ms[long_] * 1e3:.4e} particle-steps/s; "
                    f"launches {counts['ps_emitter_spawn']} (spawn), "
                    f"{counts['ps_physics_step']} (physics), "
                    f"{counts.get('ps_emitter_ring', 0)} (ring), "
                    f"{counts['ps_emitter_tail']} (tail) "
                    f"for {frames} frames; alive {n_alive}; peak memory "
                    f"{torch.cuda.max_memory_allocated()} bytes")
            es, kernels, moves, busy = profile_frames(eng, es, 8)
            line += (f"; profiler: {kernels:.1f} kernels and {moves:.1f} "
                     f"copies/sets a frame, device busy {busy:.1%}")
            print(line)
            del es, eng

    # each kernel variant alone vs its plain version (plain, kernel,
    # kernel, plain), on all-alive fields
    timings = {}
    for n in ENGINE_SLOTS:
        cfg = bench_scene(n)
        w = PackedEngine(cfg, alloc="strided", device=dev).spawn_width
        packed = full_packed(n, 25)
        for layout in ("packed8", "slim"):
            host = packed
            if layout == "slim":
                host = (*packed[:6], packed[7] * 60.0)       # death > 0
            fields = tuple(torch.tensor(a, device=dev) for a in host)
            for windowed in (False, True):
                window = (spawn_window(len(host), w, 1669, n - w, dev, 26)
                          if windowed else None)
                n_bytes = physics_bytes(fields, window)
                t_bound, by = bound_ms(0, n_bytes)
                plain = lambda: pk.physics_step_plain(fields, cfg, window)
                kern = lambda: pk.physics_step_cuda(fields, cfg, window)
                p1 = cuda_ms(plain, 3)
                k1 = cuda_ms(kern, 50)
                k2 = cuda_ms(kern, 50)
                p2 = cuda_ms(plain, 3)
                dev_ms = graph_ms(kern, 50)
                name = f"{layout}{' + window' if windowed else ''}"
                timings[(n, name)] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                                          bound_ms=t_bound, bound_by=by)
                print(f"phase 7: physics kernel {n} slots {name}: kernel "
                      f"{k1:.4f} / {k2:.4f} ms, plain {p1:.3f} / {p2:.3f} ms "
                      f"(plain, kernel, kernel, plain), kernel {dev_ms:.4f} "
                      f"ms in a CUDA graph; {n_bytes} bytes "
                      f"(benchmark/work.py's emitter_physics): "
                      f"bound {t_bound:.4f} ms ({by}), "
                      f"{t_bound / min(k1, k2):.1%} of it by launches, "
                      f"{t_bound / dev_ms:.1%} in the graph")
    main = timings[(EMIT_SLOTS, "packed8 + window")]
    return dict(launches=120,
                rng_launches=main_counts.get("ps_flat_fields", 0),
                emitter_launches=dict(
                    emitter_spawn=main_counts["ps_emitter_spawn"],
                    emitter_tail=main_counts["ps_emitter_tail"],
                    emitter_ring=ring_launches), **main)


# ---------------------------------------------------------------------------
# the tools: the probe kernels
# ---------------------------------------------------------------------------

AFFINE_WIDTHS = (512, 768, 1024, 770)   # 770: not a multiple of 4
PROBE_K = 8
RSQRT_RTOL = 2e-6                  # MUFU.RSQ: 2 ulp


def pair_test_cost(table: str) -> None:
    """What testing one candidate pair costs the card, from the op costs
    ``probe_alu_ops`` just measured (``table``, its printed lines): the cost
    that the cluster-pair kernel avoids by dropping out-of-band rows and
    columns and culling by tile.

    One slot is the time in which the card issues one FP32 instruction for
    every lane at its published peak (an FFMA a lane, two float32
    operations, ``benchmark.peaks``).  ``chain16`` issues 16 FFMA + 1 FADD
    + 2/8 a lane and layer, which gives the slots an FFMA, FADD or FMUL
    really takes; ``chainmix16`` issues 8 FSETP + 4 FFMA + 1 FADD + 2/8
    (the SASS printed above), which gives a compare's.  The cell-delta
    test ``cd2 <= 3.5`` of a candidate is 3 FADD, 3 FMUL, 2 FADD and 1
    FSETP (the integer ``ng != mg`` goes down another pipe and is not
    counted)."""
    import re

    from particlesystem_tpu_torch.tools import probe_alu_ops as pa
    ns = {m[1]: float(m[2]) for m in re.finditer(
        r"^(\w+)\s+([\d.]+) ns/layer", table, flags=re.M)}
    slot_ns = bound_s(2 * pa.B * pa.CH, 0) * 1e9
    arith = ns["chain16"] / slot_ns / 17.25
    compare = (ns["chainmix16"] / slot_ns - 5.25 * arith) / 8
    slots = 8 * arith + compare
    print(f"phase 8: one FP32 operation for every lane of the tile takes "
          f"{slot_ns:.3f} ns at the published peak; measured: an FFMA, FADD "
          f"or FMUL {arith:.3f} slots, an FSETP {compare:.3f} slots; the "
          f"cell-delta test (8 arithmetic operations and a compare) "
          f"{slots:.2f} slots a candidate, against the 4 that 8 flops at "
          f"67 TFLOP/s allow")


def phase_probes(dev):
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch
    from particlesystem_tpu_torch.tools import probe_alu_ops as pa
    from particlesystem_tpu_torch.tools import probe_two_shapes as pt

    # every variant against the plain version, on the tools' own tile
    x = pa.tile(dev)
    worst_alu = 0.0
    for v in pa.VARIANTS:
        got = pa.probe_layers_cuda(v, PROBE_K, x)
        want = pa.probe_layers_plain(v, PROBE_K, x)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), f"{v}: kernel result not finite"
        err = (got - want).abs().max().item()
        if v == "rsqrt":
            rel = ((got - want).abs() / want.abs()).max().item()
            assert rel <= RSQRT_RTOL, f"rsqrt: relative error {rel}"
            how = f"max relative err {rel:.3e} (limit {RSQRT_RTOL})"
        else:
            assert torch.equal(got, want), \
                f"{v}: {int((got != want).sum())} lanes differ, max {err}"
            how = "kernel == plain bit for bit"
        worst_alu = max(worst_alu, err)
        print(f"phase 8: probe_alu_ops {v} k={PROBE_K} on ({pa.B}, {pa.CH}) "
              f"x {pa.REPS} repeats: {how}")
    for w in AFFINE_WIDTHS:
        xa = torch.tensor(np.random.default_rng(w).uniform(
            -4.0, 4.0, (pt.ROWS, w)).astype(np.float32), device=dev)
        got = pt.probe_affine_cuda(xa)
        torch.cuda.synchronize()
        assert torch.equal(got, pt.probe_affine_plain(xa)), \
            f"probe_affine width {w} differs from the plain version"
        print(f"phase 8: probe_affine ({pt.ROWS}, {w}): kernel == plain bit "
              f"for bit")

    # the tools path: both main()s, launches counted from here
    base = launched()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = pa.main([])
    table = text.getvalue()
    print("".join(f"phase 8: {line}\n" for line in table.splitlines()),
          end="")
    assert rc == 0 and "chainmix16" in table, "probe_alu_ops.main failed"
    rc = pt.main([])
    assert rc == 0, "probe_two_shapes.main failed"
    counts = launched(base, dict(ps_probe_alu_ops=counts_alu_main(pa),
                                 ps_probe_affine=2 * pt.FRAMES))
    if shutil.which("cuobjdump") or shutil.which("nvcc"):
        for v, ops in pa.sass_counts().items():
            top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
            print(f"phase 8: sass {v:10s} "
                  + " ".join(f"{op}:{n}" for op, n in top))
    else:
        print("phase 8: sass not read: no cuobjdump on this machine")
    pair_test_cost(table)

    # probe_alu_ops: fma at k = K2, beside the plain version doing the same
    # work (the tile repeated REPS times) and on one tile
    kern = lambda: pa.probe_layers_cuda("fma", pa.K2, x)
    xr = x.repeat(pa.REPS, 1)
    p1 = cuda_ms(lambda: pa.probe_layers_plain("fma", pa.K2, xr), 1)
    k1 = cuda_ms(kern, 20)
    k2 = cuda_ms(kern, 20)
    p2 = cuda_ms(lambda: pa.probe_layers_plain("fma", pa.K2, xr), 1)
    p_tile = cuda_ms(lambda: pa.probe_layers_plain("fma", pa.K2, x), 2)
    del xr
    # the kernel's contract has every layer add t = acc + j * 1e-30 before
    # the variant's operation: an FADD and an FFMA a lane and layer, two
    # issue slots, each the slot of an FFMA's two float32 operations at the
    # peak (three flops, were only the FFMA counted as two)
    lanes = pa.B * pa.CH * pa.REPS * pa.K2
    alu_bound, alu_by = bound_ms(2 * 2 * lanes, 8 * pa.B * pa.CH)
    print(f"phase 8: probe_alu_ops fma k={pa.K2}: kernel {k1:.4f} / {k2:.4f} "
          f"ms, plain on {pa.REPS} repeats {p1:.2f} / {p2:.2f} ms (plain, "
          f"kernel, kernel, plain), plain on one tile {p_tile:.3f} ms; "
          f"{lanes} lane-layers x 2 issue slots (FFMA + FADD) at the FP32 "
          f"issue rate: bound {alu_bound:.4f} ms "
          f"({alu_by}), {alu_bound / min(k1, k2):.1%} of it; by flops "
          f"(3 a lane-layer at {FP32_FLOPS / 1e12:g} TFLOP/s) "
          f"{bound_s(3 * lanes, 0) * 1e3:.4f} ms")
    alu = dict(launches=counts["ps_probe_alu_ops"], err=worst_alu,
               ms=min(k1, k2), plain_ms=min(p1, p2), bound_ms=alu_bound,
               bound_by=alu_by)

    # probe_affine at (16, CAP): a launch's latency, not its bytes, is
    # what it takes
    xa = torch.ones((pt.ROWS, pt.CAP), dtype=torch.float32, device=dev)
    one = torch.ones_like(xa)
    kern = lambda: pt.probe_affine_cuda(xa)
    plain = lambda: pt.probe_affine_plain(xa)
    lib = lambda: torch.add(one, xa, alpha=2)
    assert torch.equal(lib(), kern())
    p1, l1 = cuda_ms(plain, 200), cuda_ms(lib, 200)
    k1 = cuda_ms(kern, 200)
    k2 = cuda_ms(kern, 200)
    p2, l2 = cuda_ms(plain, 200), cuda_ms(lib, 200)
    g_kern, g_lib = graph_ms(kern, 50), graph_ms(lib, 50)
    aff_bound, aff_by = bound_ms(2 * xa.numel(), 8 * xa.numel())
    print(f"phase 8: probe_affine ({pt.ROWS}, {pt.CAP}): kernel {k1:.5f} / "
          f"{k2:.5f} ms, plain {p1:.5f} / {p2:.5f} ms, torch.add(one, x, "
          f"alpha=2) {l1:.5f} / {l2:.5f} ms; in a CUDA graph kernel "
          f"{g_kern:.5f} ms, torch.add {g_lib:.5f} ms; {8 * xa.numel()} "
          f"bytes: bound {aff_bound:.6f} ms ({aff_by})")
    print("phase 8: probe_affine, the host's microseconds a call: "
          + ", ".join(f"{k} {v:.3f}" for k, v in
                      wrapper_host_us(xa, kern, lib).items()))
    affine = dict(launches=counts["ps_probe_affine"], err=0.0,
                  ms=min(k1, k2),
                  plain_ms=min(p1, p2), bound_ms=aff_bound, bound_by=aff_by,
                  library_ms=min(l1, l2))
    return alu, affine


def wrapper_host_us(x, kern, lib, reps: int = 2000) -> dict:
    """The host's microseconds for one call of the affine wrapper and for
    its parts, each over ``reps`` calls with the card drained before and
    after: the C entry point doing nothing (n = 0: what ctypes costs), the
    C entry point launching, the stream lookup, the output's allocation,
    the wrapper's checks; and the same for ``torch.add`` and
    ``torch.empty_like`` + an in-place ``torch.add``."""
    import torch
    from particlesystem_tpu_torch.tools import probe_two_shapes as pt
    from particlesystem_tpu_torch.utils import cuda_build as cb

    def host_us(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        return us

    out = torch.empty_like(x)
    fn = cb._entry("ps_probe_affine")
    px, po, n, dev = x.data_ptr(), out.data_ptr(), x.numel(), x.device
    stream = cb.current_stream_handle(dev.index)

    def checks():
        return (x.device.type != "cuda" or x.dtype != torch.float32
                or x.dim() != 2 or x.shape[0] != pt.ROWS
                or not x.is_contiguous())

    return {
        "wrapper": host_us(kern),
        "torch.add": host_us(lib),
        "empty C call": host_us(lambda: fn(px, po, 0, stream)),
        "C call that launches": host_us(lambda: fn(px, po, n, stream)),
        "launch() with its stream and device lookup": host_us(
            lambda: cb.launch("ps_probe_affine", dev, px, po, n)),
        "stream lookup": host_us(
            lambda: cb.current_stream_handle(dev.index)),
        "current_device": host_us(torch.cuda.current_device),
        "two data_ptr and numel": host_us(
            lambda: (x.data_ptr(), out.data_ptr(), x.numel())),
        "empty_like": host_us(lambda: torch.empty_like(x)),
        "checks": host_us(checks),
        "torch.add into out=": host_us(
            lambda: torch.add(out, x, alpha=2, out=out)),
    }


def counts_alu_main(pa, launches_per_timing: int = 10, rounds: int = 5):
    """Launches ``probe_alu_ops.main`` makes: each variant at two depths,
    one warm-up and ``rounds`` x ``launches_per_timing`` timed calls."""
    return len(pa.VARIANTS) * 2 * (1 + rounds * launches_per_timing)


# ---------------------------------------------------------------------------
# the dense pass, validate, checkpoint, profile_frame, readback
# ---------------------------------------------------------------------------


def phase_dense_vs_blocks(sim):
    """One frame from ``sim``'s state (after phase 4) through both passes."""
    import torch
    from particlesystem_tpu_torch.models import nbody

    cfg, frame, active = sim.cfg, sim.frame, sim._active
    width = sim._pick_width(int(sim.last_stats.max_cell_occupancy))
    base = launched()
    blocks, bst = nbody.step(sim.state, frame, cfg, "blocks", active)
    launched(base, nbody_frames(1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dense_step = lambda: nbody.step(sim.state, frame, cfg, "dense", active,
                                    width)
    dense, dst = dense_step()
    # the dense pass launches no pair kernel and none of A-E
    launched(base, nbody_frames(1, ps_nbody_frame_fields=1))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    # as in the JAX package, the blocks pass counts a chunk's rows before
    # the overflow kill and the dense pass after it: equal without overflow
    assert int(bst.n_overflow_kills) == 0, "overflow at the reference size"
    for k, v in vars(bst).items():
        assert int(getattr(dst, k)) == int(v), \
            f"dense vs blocks: {k} {int(getattr(dst, k))} != {int(v)}"
    assert int(dst.n_listed_dropped) == 0, "the dense lists dropped rows"
    for f in ("alive", "parent", "tag"):
        assert torch.equal(getattr(dense, f), getattr(blocks, f)), \
            f"dense vs blocks: {f} differs"
    scale = max(1.0, blocks.acc.abs().max().item())
    err = (dense.acc - blocks.acc).abs().max().item()
    assert err / scale <= 1e-5, \
        f"dense vs blocks: acc error {err} exceeds 1e-5 of {scale}"
    dense_ms = cuda_ms(dense_step, 2)
    blocks_ms = cuda_ms(lambda: nbody.step(sim.state, frame, cfg, "blocks",
                                           active), 5)
    print(f"phase 9: frame {frame} at {cfg.n_fill} particles, active prefix "
          f"{active or cfg.slots}: dense == blocks in every stat "
          f"(alive {int(dst.n_alive)}, collision kills "
          f"{int(dst.n_collision_kills)}, survivals {int(dst.n_survivals)}, "
          f"spawned {int(dst.n_spawned)}, max cell "
          f"{int(dst.max_cell_occupancy)}) and in alive, parent and tag; acc "
          f"max abs err {err:.3e} (limit 1e-5 of {scale:.3f}); dense frame "
          f"{dense_ms:.1f} ms at list_width {width or cfg.cell_capacity}, "
          f"blocks frame {blocks_ms:.3f} ms; dense peak memory {peak} bytes")


VALIDATE_FILL, VALIDATE_GRID = 16384, 4
READBACK_FRAMES = 60


def phase_validate_checkpoint_profile(sim, dev):
    import os
    import tempfile

    import torch
    from particlesystem_tpu_torch import GridSpec, NBodyConfig
    from particlesystem_tpu_torch.api import NBodySimulation
    from particlesystem_tpu_torch.core.state import FIELDS
    from particlesystem_tpu_torch.models import nbody
    from particlesystem_tpu_torch.utils.timers import slope_ms

    # validate: the card against the numpy oracle, events exact
    small = NBodySimulation(NBodyConfig(
        n_fill=VALIDATE_FILL, grid=GridSpec(grid_dim=VALIDATE_GRID)),
        device=dev)
    t0 = time.perf_counter()
    out = small.validate(frames=2)
    val_s = time.perf_counter() - t0
    assert out["events_match"] is True, f"validate: {out}"
    assert out["max_position_deviation"] < 1e-2, f"validate: {out}"
    assert small.frame == 0
    print(f"phase 10: validate(frames=2) at {VALIDATE_FILL} particles, "
          f"{VALIDATE_GRID}^3 grid: {out}, {val_s:.1f} s")

    # checkpoint: save at frame 10, resume in a fresh simulation
    cfg = sim.cfg
    a = NBodySimulation(cfg, device=dev)
    a.run(MAIN_ITERS)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frame10.npz")
        t0 = time.perf_counter()
        a.save(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        b = NBodySimulation(cfg, device=dev)
        t0 = time.perf_counter()
        b.load(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    assert b.frame == MAIN_ITERS and b._active == 0
    a.run(5)
    b.run(5)
    assert a.frame == b.frame == MAIN_ITERS + 5
    for k, v in vars(a.last_stats).items():
        assert int(v) == int(getattr(b.last_stats, k)), f"resumed run: {k}"
    # the resumed run re-buckets after its first batch: compare the rows
    # in one order (alive rows first, slot order kept)
    sa, sb = nbody.compact_state(a.state), nbody.compact_state(b.state)
    for f in FIELDS:
        assert torch.equal(getattr(sa, f), getattr(sb, f)), \
            f"resumed run: {f} differs"
    print(f"phase 10: checkpoint of {cfg.slots} slots at frame "
          f"{MAIN_ITERS}: {size} bytes, save {save_s:.3f} s, load "
          f"{load_s:.3f} s; 5 more frames on both: state and stats bit "
          f"identical (alive {int(a.last_stats.n_alive)})")
    del a, b, sa, sb

    # profile_frame on the main path's simulation (active prefix engaged),
    # as the JAX package's is called
    before = {f: getattr(sim.state, f).clone() for f in FIELDS}
    frame = sim.frame
    stages = sim.profile_frame(k1=2, k2=6)
    assert sim.frame == frame
    for f in FIELDS:
        assert torch.equal(getattr(sim.state, f), before[f]), \
            f"profile_frame changed {f}"
    assert list(stages) == ["rng_fields", "cell_ids", "build_grid",
                            "calc_forces", "unsort", "lifecycle",
                            "full_frame"], list(stages)
    parts = sum(ms for k, ms in stages.items() if k != "full_frame")
    active = sim._active or cfg.slots
    # the bench's slope on the same simulation and prefix (it advances
    # the state; the prefix held where it is)
    sim.active_bucketing = False
    bench_ms = slope_ms(lambda k: sim.run(k, batch=k), 2, 6, 3, dev)
    sim.active_bucketing = True
    print(f"phase 10: profile_frame(k1=2, k2=6) at frame {frame}, active "
          f"prefix {active}: "
          + ", ".join(f"{k} {ms:.3f}" for k, ms in stages.items())
          + f" ms; stages sum {parts:.3f} ms beside full_frame "
          f"{stages['full_frame']:.5f} ms (replays of the loop run "
          f"executes); the bench's slope on the same simulation and "
          f"prefix, frames {frame}-{sim.frame}: {bench_ms:.5f} ms a frame")


def phase_readback(dev):
    import threading

    import torch
    from particlesystem_tpu_torch.utils.native import has_native

    assert has_native(), "the native ring was not built"
    shape = (8, EMIT_SLOTS)
    frame_bytes = 4 * shape[0] * shape[1]
    n = READBACK_FRAMES

    # every frame delivered and equal to packed() of its frame: the
    # consumer pops after each step, so nothing is dropped
    ps = bench_system(dev)
    rb = ps.enable_readback(depth=3)
    assert rb.ring.frame_bytes == frame_bytes
    assert rb.ring._lib is not None, "the ring fell back to the deque"
    base = launched()
    kept, checked = {}, 0
    for i in range(n):
        ps.step()
        kept[i] = ps.packed().clone()
        got = rb.ring.pop(shape)
        if i == 0:
            assert got is None          # frame 0 is still pending
            continue
        assert got is not None, f"frame {i - 1} was not in the ring"
        assert torch.equal(torch.from_numpy(got).to(dev), kept.pop(i - 1)), \
            f"popped frame {i - 1} differs from packed()"
        checked += 1
    launched(base, engine_frames("select", n))
    assert (rb.published, rb.dropped) == (n - 1, 0), \
        (rb.published, rb.dropped)
    rb.flush()
    got = rb.ring.pop(shape)
    assert torch.equal(torch.from_numpy(got).to(dev), kept.pop(n - 1))
    assert rb.published == n and rb.ring.pop(shape) is None
    print(f"phase 10: readback at {EMIT_SLOTS} slots, {frame_bytes} bytes a "
          f"frame: {checked + 1} of {n} frames popped, each equal to "
          f"packed() of its frame; native ring")
    del ps, rb, kept, got

    def timed(readback: bool):
        ps = bench_system(dev)
        ps.step(8)
        rb = ps.enable_readback(depth=3) if readback else None
        stop = threading.Event()
        popped = [0]

        def consume():
            while not stop.is_set():
                if rb.ring.pop(shape) is None:
                    time.sleep(0.0005)
                else:
                    popped[0] += 1

        worker = threading.Thread(target=consume) if readback else None
        if worker:
            worker.start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            ps.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        if worker:
            stop.set()
            worker.join()
        return ms, rb, popped[0]

    plain_ms, _, _ = timed(False)
    with_ms, rb, popped = timed(True)
    assert rb.published + rb.dropped == n - 1, (rb.published, rb.dropped)
    rb.flush()
    assert rb.published + rb.dropped == n
    print(f"phase 10: {n} frames of step(): {plain_ms:.3f} ms/frame without "
          f"readback, {with_ms:.3f} ms/frame with readback (depth 3) and a "
          f"consumer thread: published {rb.published}, dropped "
          f"{rb.dropped}, popped by the consumer {popped}; "
          f"{frame_bytes / with_ms / 1e6:.2f} GB/s of frames published or "
          f"dropped")


# ---------------------------------------------------------------------------
# phase 11: the multi-device path
# ---------------------------------------------------------------------------

SHARDED_ITERS = 10
SHARDED_RESUME = 5
# the reduced multi-rank runs: the tests' config shape (particle life 3.0,
# 16^3 cells of 5.0) at tens of thousands of particles.  As in the tests, no
# frame reaches the spawn budget or the cell cap: both decisions depend on
# where particles are stored, as in the JAX package (the budget is per
# rank, and a full cell kills its last rows in slot order, while children
# and migrants land in per-rank free slots), so a capped frame would differ
# from one device's by design
MULTI_FILL, MULTI_SLOTS, MULTI_SEED = 32768, 65536, 11
MULTI_SPAWN_BUDGET, MULTI_CELL_CAP = MULTI_SLOTS // 4, 64
MULTI_TIMED = 8
# rows a halo buffer of the slab run: no multiple of the pair kernel's
# 512-row blocks, so the pass pads its rows with id -1 (the derived
# capacity, a cell cap of planes, never does); ~1,100 are used
MULTI_SLAB_HALO = 8000
SPAWN_TIMEOUT = 300.0
DP_SLOTS, DP_FRAMES = 1 << 20, 60


def card_processes() -> str:
    """The compute processes ``nvidia-smi`` sees on the card (pid, memory):
    after a spawn, only this process should hold it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True)
    return "; ".join(out.stdout.split("\n")).strip("; ") or "none listed"


def multi_cfg():
    from particlesystem_tpu_torch import GridSpec, NBodyConfig
    return NBodyConfig(n_fill=MULTI_FILL, capacity=MULTI_SLOTS,
                       grid=GridSpec(grid_dim=16, cell_size=5.0,
                                     chunk_factor=4),
                       particle_life=3.0, seed=MULTI_SEED,
                       spawn_budget=MULTI_SPAWN_BUDGET,
                       max_per_cell=MULTI_CELL_CAP)


def multi_runs():
    """(name, world size, spec, parity window in frames)."""
    from particlesystem_tpu_torch.parallel import (BrickSpec, PencilSpec,
                                                   SlabSpec)
    return (("slab D=2", 2, SlabSpec(2, halo_capacity=MULTI_SLAB_HALO,
                                     impl="blocks"), 8),
            ("pencil (2, 2)", 4, PencilSpec(2, 2, impl="blocks"), 7),
            ("brick (2, 2, 2)", 8, BrickSpec(2, 2, 2, impl="blocks"), 7))


def _alive_rows(state):
    """(tags, rows) of the alive particles of a host state dict, tag
    order; rows are (pos, vel, age, life)."""
    import numpy as np
    a = state["alive"]
    rows = np.concatenate([state["pos"], state["vel"], state["age"][:, None],
                           state["life"][:, None]], axis=1)[a]
    tags = state["tag"][a]
    order = np.argsort(tags, kind="stable")
    return tags[order], rows[order]


def listed_partners(snap, chunks, b, blocks):
    """Pairs of in-band rows of ``blocks`` with an in-band column of their
    chunk table's listed chunks inside the 3x3x3 stencil, the self pair
    left out: with every chunk listed once, the stencil partners that
    :func:`stencil_pairs` counts from a histogram of the cells."""
    import torch
    dev = snap.f.device
    ok = snap.f[3] >= 0
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for k in blocks.tolist():
        listed = chunks[k].cpu().to(torch.int64)
        listed = listed[:int(listed[0, 3])].tolist()
        if not listed:
            continue
        cols = torch.cat([a + torch.arange(lo, hi)
                          for a, lo, hi, _ in listed]).to(dev)
        rows = torch.arange(k * b, (k + 1) * b, device=dev)
        m, n = snap.f[3:6, rows, None], snap.f[3:6, None, cols]
        inside = ((n - m).abs() <= 1.0).all(dim=0)
        total += (inside & ok[rows, None] & ok[None, cols]
                  & (snap.i[0, rows, None] != snap.i[0, None, cols])).sum()
    return int(total)


@contextlib.contextmanager
def pair_checks(module, at, c_local=None, subset=None):
    """Hold the pair kernel against its plain version on the inputs a
    path gives it: the ``at``-th calls (0 the first; ``LAST`` the last) of
    a pass in this process.  ``module`` names the path:
    ``parallel.nbody_sharded`` for the decomposed step, which the slab,
    the pencil and the brick all call, over a halo-extended grid with the
    halo rows from other ranks, global ids and -1-id padding rows (its
    ``sort_and_prepare`` is wrapped, and the check takes the snapshot and
    chunk table that B and C built for the pass's pair kernel);
    ``ops.neighbor_blocks`` for the single-device frame (its
    ``kernel_call`` is wrapped, which ``models/nbody.blocks_frame`` calls
    on the snapshot and chunk table that B and C built: the check takes
    those very inputs).  Only calls that run a pass count: a call made
    while a frame graph is captured is not a pass (the graph's replays
    are, and run no Python), so the passes seen here on a loop that
    replays graphs (the single-device loop, the decomposed loop on one
    rank) are each key's first, eager frame; ``LAST`` keeps a copy of the
    latest pass's inputs and checks it when the block ends.  Checks the
    ids unique among the valid rows (the kernel's precondition) and runs
    :func:`compare_kernel` on the whole pass, or on ``subset`` evenly
    spaced live blocks (the first and the last among them); on the
    single-device pass it also checks that the chunk table lists every
    stencil partner of those blocks' rows once (:func:`listed_partners`
    against :func:`stencil_pairs`' histogram).  The launches of the check
    are taken off the counts.  On the CPU, where there is no kernel, only
    the inputs are recorded.  ``c_local`` is the rank's own rows (the rest
    are halo).  Yields the list of records."""
    import torch
    from particlesystem_tpu_torch.ops import neighbor_blocks as nbk
    from particlesystem_tpu_torch.utils import cuda_build
    single = module is nbk
    hook = "kernel_call" if single else "sort_and_prepare"
    inner = getattr(module, hook)
    calls, records, latest = [0], [], []

    def compare(call, cfg, snap, chunks, dims, n_valid, halo, pad):
        rec = dict(call=call, dims=tuple(dims or (cfg.grid.grid_dim,) * 3),
                   rows=snap.f.shape[1], halo=halo, pad=pad,
                   in_band=int((snap.f[3] >= 0).sum()), err=None,
                   partners=None)
        if snap.f.device.type == "cuda":
            blocks = None
            if subset:
                live = max(1, -(-n_valid // nbk.B))
                blocks = torch.linspace(
                    0, live - 1, subset,
                    device=snap.f.device).round().to(torch.int32)
            # the check's launches are not the path's
            with cuda_build.recording():
                rec["err"] = compare_kernel(cfg, snap, chunks, nbk.B, nbk.CH,
                                            blocks)
            if dims is None and blocks is not None:
                got = listed_partners(snap, chunks, nbk.B, blocks)
                want = stencil_pairs(cfg, snap, nbk.B, blocks)
                assert got == want, \
                    f"pass {call}: the chunk table lists {got} " \
                    f"stencil pairs of {subset} blocks, the cells hold " \
                    f"{want}"
                rec["partners"] = got
        records.append(rec)

    def check(call, *args):
        if single:
            cfg, snap, chunks = args
            # valid rows: in band or in the kid band (overflow and dead
            # rows lie in the dead band, below -2^22)
            valid = snap.f[3] > -(1 << 21)
            assert torch.unique(snap.i[0][valid]).numel() == \
                int(valid.sum()), "the frame's ids are not unique"
            compare(call, cfg, snap, chunks, None, int(valid.sum()), 0, 0)
            return
        cfg, snap, chunks, dims, key, ids = args
        valid = key < dims[0] * dims[1] * dims[2]
        assert torch.unique(ids[valid]).numel() == int(valid.sum()), \
            "the pass's ids are not unique among its valid rows"
        local = key.shape[0] if c_local is None else c_local
        compare(call, cfg, snap, chunks, dims, int(valid.sum()),
                int(valid[local:].sum()), int((ids == -1).sum()))

    def record(args, cuda):
        if not (cuda and torch.cuda.is_current_stream_capturing()):
            if calls[0] in at:
                check(calls[0], *args)
            elif LAST in at:
                latest[:] = [calls[0], *(
                    nbk.Snapshot(a.f.clone(), a.i.clone())
                    if isinstance(a, nbk.Snapshot) else a.clone()
                    if torch.is_tensor(a) else a for a in args)]
            calls[0] += 1

    def checked_pass(key, rows, cfg, c_max, ch, b, grid=None, dims=None):
        p = inner(key, rows, cfg, c_max, ch, b, grid=grid, dims=dims)
        record((cfg, p.snap, p.chunks, dims, key, rows.ids), key.is_cuda)
        return p

    def checked_kernel(cfg, snap, chunks, ch=None, b=None):
        record((cfg, snap, chunks), snap.f.is_cuda)
        return inner(cfg, snap, chunks, ch=ch, b=b)

    setattr(module, hook, checked_kernel if single else checked_pass)
    try:
        yield records
    finally:
        setattr(module, hook, inner)
    if latest:
        check(*latest)

#: ``pair_checks``' name for the last pass
LAST = "last"


def pair_check_text(records) -> str:
    return "; ".join(
        f"pass {r['call']} dims {r['dims']}: {r['rows']} rows ({r['halo']} "
        f"valid halo rows, {r['pad']} padding rows of id -1, {r['in_band']} "
        f"in band), " + ("no kernel on the CPU" if r["err"] is None else
                         f"gmax exact, acc max abs err {r['err']:.3e}")
        + ("" if r["partners"] is None else
           f", the chunk table lists all {r['partners']} stencil pairs")
        for r in records)


def rank_nbody(rank, group, cfg, spec, frames, timed, device):
    """One rank of a phase-11 multi-rank run: ``frames`` frames read one by
    one (statistics and the gathered alive rows), the pair kernel held
    against its plain version on the first and the last of those frames'
    passes, then ``timed`` frames in one batch.  Every rank returns its
    launches of each kernel in those frames (the checks' taken off) and
    whether its driver took frame graphs; rank 0 also the frames,
    ms/frame, bytes staged through the host a frame and its kernel
    checks."""
    import torch
    from particlesystem_tpu_torch.core.state import state_to_numpy
    from particlesystem_tpu_torch.parallel import nbody_sharded
    from particlesystem_tpu_torch.parallel.driver import (
        DistributedNBodySimulation)
    dev = torch.device(device)
    base = launched()
    sim = DistributedNBodySimulation(cfg, spec, group=group, device=dev)
    out = []
    with pair_checks(nbody_sharded, (0, frames - 1),
                     cfg.slots // group.size()) as checks:
        for _ in range(frames):
            stats = sim.run(1, batch=1)
            out.append((stats, _alive_rows(state_to_numpy(sim.gather()))))
    assert [r["call"] for r in checks] == [0, frames - 1], checks
    assert all(r["halo"] > 0 and r["in_band"] > 0 for r in checks), checks
    counted = launched(base)
    graphed = sim.graphs is not None
    staged = sim.mesh.staged_bytes
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    sim.run(timed, batch=timed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / timed
    per_frame = (sim.mesh.staged_bytes - staged) / timed
    if rank:
        return None, None, None, counted, None, graphed
    return out, ms, per_frame, counted, checks, graphed


def rank_emitter(rank, group, cfg, frames, device):
    """One rank of the data-parallel emitter: its leaves after ``frames``
    frames of ``step_many`` (graph replays on a card), its engine's
    physics and spawn-kernel launches, the psum'd alive count and its
    engine's (eager frames, captures, replays)."""
    import torch
    from particlesystem_tpu_torch.parallel import ShardedEmitterEngine, mesh
    from particlesystem_tpu_torch.runtime.engine import engine_state_to_numpy
    base = launched()
    eng = ShardedEmitterEngine(cfg, mesh.mesh_1d(group.size(), "x", group),
                               alloc="select", layout="packed8",
                               device=torch.device(device))
    es = eng.step_many(eng.init(), frames)
    counts = launched(base)
    g = eng.local.graphs
    return (engine_state_to_numpy(es),
            tuple(counts.get(k, 0) for k in ("ps_physics_step",
                                             "ps_emitter_spawn")),
            eng.alive_count(es), (g.eager_frames, g.captures, g.replays))


def single_device_frames(cfg, spec, frames, dev):
    """The port's single-device step on the arrangement ``spec`` gives the
    fill: [(stats, (tags, rows))] a frame."""
    from particlesystem_tpu_torch.core.state import state_to_numpy
    from particlesystem_tpu_torch.models import nbody
    from particlesystem_tpu_torch.parallel.nbody_sharded import _distribute
    state, _ = _distribute(nbody.init_fill(cfg, dev), cfg,
                           spec.derive(cfg).splits())
    out = []
    for frame in range(frames):
        state, stats = nbody.step(state, frame, cfg)
        out.append(({k: int(v) for k, v in vars(stats).items()},
                    _alive_rows(state_to_numpy(state))))
    return out


def elapsed_ms(fn, dev) -> float:
    """Milliseconds of ``fn()``: CUDA events on a card, the host clock on
    the CPU (where phase 11 is rehearsed at a small size)."""
    import torch
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


#: the kernel functions a sharded frame launches once each (a trace's
#: names): the single-device frame's less A
SHARDED_FRAME_FUNCTIONS = tuple(f for f in NBODY_FRAME_FUNCTIONS
                                if f != "nbody_cells")


def phase_sharded_one_rank(dev, cfg=None):
    """11a: the slab at d=1 over a one-rank NCCL group at full width
    (``NBodyConfig()``), its frames replayed from one captured graph
    (the NCCL all-reduces in it), against the single-device step and the
    single-device loop on the same arrangement, bit for bit: 20 frames,
    then a resume from its checkpoint; each frame launches the threefry
    kernel, B, C, the pair kernel, D and E once.  Prints ms a frame beside
    the single-device loop's and a trace of replays."""
    import datetime
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    from particlesystem_tpu_torch import NBodyConfig
    from particlesystem_tpu_torch.api import NBodySimulation
    from particlesystem_tpu_torch.core.state import FIELDS
    from particlesystem_tpu_torch.models import nbody
    from particlesystem_tpu_torch.parallel import (DistributedNBodySimulation,
                                                   SlabSpec, nbody_sharded)
    from particlesystem_tpu_torch.parallel.mesh import free_port

    cfg = cfg or NBodyConfig()
    spec = SlabSpec(n_devices=1, impl="blocks")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT))
    try:
        group = dist.group.WORLD
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        sim = DistributedNBodySimulation(cfg, spec, group=group, device=dev)
        on_card = dev.type == "cuda"
        # NCCL on a card captures; gloo (the CPU rehearsal) runs eagerly
        assert (sim.graphs is not None) == on_card, sim.graphs
        start = sim.state.map(lambda a: a.clone())
        base = launched()
        with pair_checks(nbody_sharded, (0,), cfg.slots,
                         SUBSET_BLOCKS) as checks:
            first = sim.run(SHARDED_ITERS)
        assert [r["call"] for r in checks] == [0], checks
        first_counts = launched(base)
        at10 = sim.state.map(lambda a: a.clone())
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "slab_d1")
            t0 = time.perf_counter()
            sim.save(path)
            save_s = time.perf_counter() - t0
            size = sum(os.path.getsize(os.path.join(path, f))
                       for f in os.listdir(path))
            base = launched()
            runs = []
            ms_sharded = elapsed_ms(
                lambda: runs.append(sim.run(SHARDED_ITERS)), dev
            ) / SHARDED_ITERS
            second = runs[0]
            second_counts = launched(base)
            counts = {k: first_counts.get(k, 0) + second_counts.get(k, 0)
                      for k in {**first_counts, **second_counts}}
            n_launch, n_rng = (counts.get(k, 0) for k in (
                "ps_cluster_pair", "ps_nbody_frame_fields"))
            peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                    else 0)
            # once a frame each, A none (none on the CPU, where the phase
            # is rehearsed small)
            kernels = (("ps_nbody_frame_fields", "ps_cluster_pair")
                       + FRAME_ENTRIES[1:])
            per = 2 * SHARDED_ITERS if on_card else 0
            assert counts == {k: per for k in kernels if per}, \
                f"launches in {2 * SHARDED_ITERS} frames: {counts}"
            if on_card:
                g = sim.graphs
                assert (g.eager_frames, g.captures, g.replays) == (
                    1, 1, 2 * SHARDED_ITERS - 1), \
                    (g.eager_frames, g.captures, g.replays)
                rec = g.recorded(sim._KEY)
                assert rec == {k: 1 for k in kernels}, rec
                replays = (f"{g.eager_frames} eager frame, {g.captures} "
                           f"capture, {g.replays} replays")
            else:
                replays = "eager frames over gloo"
            resumed = DistributedNBodySimulation(cfg, spec, group=group,
                                                 device=dev)
            t0 = time.perf_counter()
            assert resumed.load(path) == 0 and resumed.frame == SHARDED_ITERS
            load_s = time.perf_counter() - t0
            for f in FIELDS:
                assert torch.equal(getattr(resumed.state, f),
                                   getattr(at10, f)), f"resume: {f} differs"
            resumed_stats = resumed.run(SHARDED_RESUME)
            assert not on_card or resumed.graphs.replays == \
                SHARDED_RESUME - 1, resumed.graphs.replays
            del at10

        # the single-device step at full width from the same arrangement
        ref = start
        keys = ("n_alive", "n_age_deaths", "n_collision_kills",
                "n_overflow_kills", "n_survivals", "n_spawned",
                "n_spawn_capped", "n_listed_dropped", "max_cell_occupancy")
        ms_ref = []
        for frame in range(2 * SHARDED_ITERS):
            step = []
            ms_ref.append(elapsed_ms(lambda: step.append(
                nbody.step(ref, frame, cfg, "blocks")), dev))
            ref, stats = step[0]
            want = {k: int(getattr(stats, k)) for k in keys}
            if frame + 1 == SHARDED_ITERS + SHARDED_RESUME:
                for f in FIELDS:
                    assert torch.equal(getattr(resumed.state, f),
                                       getattr(ref, f)), \
                        f"resumed frame {frame}: {f} differs"
                assert all(resumed_stats[k] == want[k] for k in keys), \
                    (resumed_stats, want)
            for got, at in ((first, SHARDED_ITERS),
                            (second, 2 * SHARDED_ITERS)):
                if frame + 1 == at:
                    assert all(got[k] == want[k] for k in keys), (got, want)
                    assert got["halo_dropped"] == got["migration_dropped"] \
                        == got["halo_used_max"] == 0
        for f in FIELDS:
            assert torch.equal(getattr(sim.state, f), getattr(ref, f)), \
                f"frame {2 * SHARDED_ITERS}: {f} differs"
        # the single-device loop, from frame graphs on a card, from the
        # same arrangement at full width, its second batch timed as the
        # sharded one
        single = NBodySimulation(cfg, device=dev, active_bucketing=False)
        single.state = start
        single.run(SHARDED_ITERS, batch=SHARDED_ITERS)
        ms_loop = elapsed_ms(lambda: single.run(
            SHARDED_ITERS, batch=SHARDED_ITERS), dev) / SHARDED_ITERS
        for f in FIELDS:
            assert torch.equal(getattr(single.state, f), getattr(ref, f)), \
                f"the single-device loop at frame {2 * SHARDED_ITERS}: {f}"
        del single
        ms_single = sum(ms_ref[SHARDED_ITERS:]) / SHARDED_ITERS
        traced = ("not traced on the CPU" if not on_card else
                  sharded_trace(sim))
        print(f"phase 11a: slab d=1, {cfg.n_fill} particles, {cfg.slots} "
              f"slots, impl=blocks over a one-rank {backend} group "
              f"({replays}): "
              f"{2 * SHARDED_ITERS} frames bit-identical to the "
              f"single-device full-width step (state and stats) and to "
              f"the single-device loop's frame graphs (state), alive "
              f"{second['n_alive']}; launches in those frames "
              f"{ {k: v for k, v in counts.items() if v} }; frames "
              f"{SHARDED_ITERS + 1}-{2 * SHARDED_ITERS} {ms_sharded:.4f} "
              f"ms/frame sharded (CUDA events around run({SHARDED_ITERS})) "
              f"beside {ms_loop:.4f} ms/frame of the single-device loop "
              f"at full width (the same, its frames 11-20) and "
              f"{ms_single:.4f} ms/frame of eager single-device steps "
              f"(CUDA events a frame); "
              f"peak memory {peak} bytes ({peak / 2**30:.3f} GiB)")
        print(f"phase 11a: {traced}")
        print(f"phase 11a: the pair kernel vs its plain version on the "
              f"sharded pass's own inputs, {SUBSET_BLOCKS} evenly spaced "
              f"live blocks: {pair_check_text(checks)}")
        print(f"phase 11a: sharded checkpoint at frame {SHARDED_ITERS}: "
              f"{size} bytes, save {save_s:.3f} s, load {load_s:.3f} s; "
              f"{SHARDED_RESUME} more frames bit-identical to the "
              f"uninterrupted run")
        del sim, resumed, ref, start
    finally:
        dist.destroy_process_group()
        if dev.type == "cuda":
            torch.cuda.synchronize()
    return dict(ms=ms_sharded, single_ms=ms_single, loop_ms=ms_loop,
                launches=n_launch, err=checks[0]["err"] or 0.0)


def sharded_trace(sim) -> str:
    """A trace of :data:`GRAPH_TRACE_FRAMES` replays of the sharded loop's
    frame (after the frames it checks): kernels, copies and sets a replay,
    device and wall time, busy share, and the largest kernels."""
    trace = trace_frames(lambda: sim.graphs.step(sim._KEY, sim._loop_frame),
                         GRAPH_TRACE_FRAMES, SHARDED_FRAME_FUNCTIONS)
    largest = sorted(trace["sums"].items(), key=lambda kv: -kv[1][1])[:8]
    return (f"a trace of {GRAPH_TRACE_FRAMES} replays of the sharded frame "
            f"(taken {trace['attempts']} times): {trace['kernels']:.1f} "
            f"kernels and {trace['moves']:.1f} copies/sets a replay, "
            f"{trace['device_ms']:.4f} ms of device time in "
            f"{trace['wall_ms']:.4f} ms a frame, device busy "
            f"{trace['busy']:.1%}; microseconds a frame: " + "; ".join(
                f"{name[:40]} x{n / GRAPH_TRACE_FRAMES:g} "
                f"{us / GRAPH_TRACE_FRAMES:.2f}"
                for name, (n, us) in largest))


def phase_sharded_ranks(dev):
    """11b: slab, pencil and brick on several ranks sharing ``dev`` over
    gloo, against the single-device step on the same arrangement."""
    import os

    import numpy as np
    from particlesystem_tpu_torch.parallel import spawn

    cfg = multi_cfg()
    out = {}
    # each rank's frames: the threefry kernel, B, C, the pair kernel, D
    # and E once each (A is the cubic grid's: not on this path)
    kernels = (("ps_nbody_frame_fields", "ps_cluster_pair")
               + FRAME_ENTRIES[1:])
    for name, ws, spec, frames in multi_runs():
        t0 = time.perf_counter()
        ranks = spawn(
            rank_nbody, ws, (cfg, spec, frames, MULTI_TIMED, str(dev)),
            backend="gloo", timeout=SPAWN_TIMEOUT)
        got, ms, staged, _, checks, _ = ranks[0]
        wall = time.perf_counter() - t0
        per = frames if dev.type == "cuda" else 0
        # and the rank's fill (none on the CPU)
        want = ({k: per for k in kernels} | {"ps_nbody_fill": 1}
                if per else {})
        for rank, (*_, counted, _, graphed) in enumerate(ranks):
            assert counted == want, (name, rank, counted, want)
            assert not graphed, f"{name}: gloo rank {rank} took graphs"
        n_launch, n_rng = (ranks[0][3].get(k, 0) for k in (
            "ps_cluster_pair", "ps_nbody_frame_fields"))
        ref = single_device_frames(cfg, spec, frames, dev)
        migrated = 0
        for frame, ((stats, (tags, rows)), (rstats, (rtags, rrows))) in \
                enumerate(zip(got, ref)):
            assert stats["halo_dropped"] == stats["migration_dropped"] == 0, \
                (name, frame, stats)
            for k in ("n_alive", "n_age_deaths", "n_collision_kills",
                      "n_overflow_kills", "n_survivals", "n_spawned",
                      "n_spawn_capped"):
                assert stats[k] == rstats[k], (name, frame, k)
            assert stats["n_spawn_capped"] == stats["n_overflow_kills"] \
                == 0, (name, frame)
            assert np.array_equal(tags, rtags), f"{name} frame {frame} tags"
            assert_close_chaotic(rows, rrows, f"{name} frame {frame}")
            migrated += stats["migration_used_max"]
        assert migrated > 0, f"{name}: no particle migrated"
        if spec.splits()[0].halo == MULTI_SLAB_HALO:
            assert all(r["pad"] > 0 for r in checks), (name, checks)
        print(f"phase 11b: {name} on {ws} ranks sharing {dev} over gloo "
              f"(eager frames: no rank took graphs), "
              f"{cfg.n_fill} particles, {cfg.slots} slots: {frames} frames "
              f"equal to the single-device run (stats, tag multisets; "
              f"floats by the chaotic rule), no halo or migration drop, "
              f"{migrated} migrants at the busiest rank summed over the "
              f"frames; every rank launched the pair kernel {n_launch} "
              f"times, the threefry kernel {n_rng} and B, C, D and E "
              f"{per} each ({', '.join(kernels)}; A none); "
              f"{MULTI_TIMED} more frames {ms:.3f} ms/frame with "
              f"{staged:.0f} bytes staged through the host a frame at rank "
              f"0; {wall:.1f} s with the spawn")
        print(f"phase 11b: {name}: the pair kernel vs its plain version on "
              f"each rank's own pass inputs, rank 0: "
              f"{pair_check_text(checks)}")
        out[name] = dict(ms=ms, staged=staged,
                         err=max(r["err"] or 0.0 for r in checks))
    if dev.type == "cuda":
        print(f"phase 11b: compute processes on the card after the spawns "
              f"(this one is {os.getpid()}): {card_processes()}")
    return out


def phase_sharded_emitter(dev, slots=EMIT_SLOTS, dp_slots=DP_SLOTS):
    """11c: the data-parallel emitter, ``step_many`` as graph replays on a
    card: one rank at 10,485,760 slots bit for bit ``PackedEngine`` and
    the eager frames; two ranks sharing ``dev`` over gloo each bit for bit
    the eager frames of a local engine salted 0 and 1."""
    import numpy as np
    from particlesystem_tpu_torch.parallel import (ShardedEmitterEngine,
                                                   mesh_1d, spawn)
    from particlesystem_tpu_torch.parallel.emitter_sharded import _local_cfg
    from particlesystem_tpu_torch.runtime.engine import (PackedEngine,
                                                         engine_state_to_numpy)

    cfg = bench_scene(slots)
    base = launched()
    sharded = ShardedEmitterEngine(cfg, mesh_1d(1), alloc="select",
                                   layout="packed8", device=dev)
    es = sharded.step_many(sharded.init(), DP_FRAMES)
    on_card = dev.type == "cuda"
    counts = launched(base, engine_frames("select",
                                          DP_FRAMES if on_card else 0))
    n_launch, n_rng = (counts.get(k, 0) for k in ("ps_physics_step",
                                                  "ps_emitter_spawn"))
    g = sharded.local.graphs
    runs = (g.eager_frames, g.captures, g.replays)
    assert runs == ((1, 1, DP_FRAMES - 1) if on_card
                    else (DP_FRAMES, 0, 0)), runs
    plain = PackedEngine(cfg, alloc="select", layout="packed8", device=dev)
    ps = plain.step_many(plain.init(), DP_FRAMES)
    a, b = engine_state_to_numpy(es), engine_state_to_numpy(ps)
    assert all(np.array_equal(x, y) for x, y in zip(a, b)), \
        "one-rank emitter differs from PackedEngine"
    del ps
    ps = plain.init()
    for _ in range(DP_FRAMES):
        ps = plain._frame(ps, 0)
    b = engine_state_to_numpy(ps)
    assert all(np.array_equal(x, y) for x, y in zip(a, b)), \
        "one-rank emitter differs from the eager frames"
    assert n_launch == n_rng == (DP_FRAMES if on_card else 0), \
        (n_launch, n_rng)
    alive = sharded.alive_count(es)
    print(f"phase 11c: emitter on one rank, {cfg.slots} slots, "
          f"select/packed8, step_many({DP_FRAMES}) as {runs[0]} eager "
          f"frame(s), {runs[1]} capture(s) and {runs[2]} replays: bit for "
          f"bit PackedEngine and its eager frames (fields and "
          f"bookkeeping), alive {alive}, physics launches {n_launch}, "
          f"spawn and tail launches {n_rng}")
    del sharded, es, plain, ps, a, b

    cfg = bench_scene(dp_slots)
    t0 = time.perf_counter()
    ranks = spawn(rank_emitter, 2, (cfg, DP_FRAMES, str(dev)),
                  backend="gloo", timeout=SPAWN_TIMEOUT)
    wall = time.perf_counter() - t0
    local = PackedEngine(_local_cfg(cfg, 2), alloc="select",
                         layout="packed8", device=dev)
    total = 0
    for salt, (leaves, n, alive, runs) in enumerate(ranks):
        s = local.init()
        for _ in range(DP_FRAMES):
            s = local._frame(s, salt)
        want = engine_state_to_numpy(s)
        assert all(np.array_equal(x, y) for x, y in zip(leaves, want)), \
            f"rank {salt} differs from the local engine salted {salt}"
        assert n == ((DP_FRAMES,) * 2 if on_card else (0, 0)), n
        assert runs == ((1, 1, DP_FRAMES - 1) if on_card
                        else (DP_FRAMES, 0, 0)), (salt, runs)
        total += int(local.alive_count(s))
        assert alive == ranks[0][2]
    assert ranks[0][2] == total > 0
    if dev.type == "cuda":
        print(f"phase 11c: compute processes on the card after the spawn: "
              f"{card_processes()}")
    print(f"phase 11c: emitter on 2 ranks sharing {dev} over gloo, "
          f"{cfg.slots} slots: step_many({DP_FRAMES}) on each rank "
          f"(eager frames, captures, replays {ranks[0][3]}) bit for bit "
          f"the eager frames of a local engine salted with its index, "
          f"alive {total} (psum), "
          f"{ranks[0][1]} physics and spawn launches a rank; "
          f"{wall:.1f} s with the "
          f"spawn")


# ---------------------------------------------------------------------------
# phase 12: the bench, the entry functions, the launcher, the tools
# ---------------------------------------------------------------------------

# the bench's stages at cut counts: {stage: keyword arguments}
BENCH_CUT = {
    "cap_10m": dict(capacity=EMIT_SLOTS, k_short=16, k_long=64, reps=2),
    "cap_1m": dict(capacity=1 << 20, k_short=64, k_long=256, reps=2),
    "nbody_1m": dict(n_fill=1 << 20, grid_dim=16, k_short=2, k_long=6,
                     reps=2),
    "nbody_sharded_d1": dict(n_fill=1 << 20, grid_dim=16, k_short=2,
                             k_long=6, reps=1),
    "nbody_10m": dict(n_fill=10 << 20, grid_dim=32, k_short=2, k_long=6,
                      reps=1),
}
#: live blocks of a bench pass held against the plain version
BENCH_CHECK_BLOCKS = 256
CLI_ITERS = 3
CLI_ARGS = ("nbody", "--devices", "2", "--particles", "2000", "--grid-dim",
            "16", "--iterations", str(CLI_ITERS), "--validate")
#: the CLI's own ``main``, then this rank's pair-kernel launches
CLI_MAIN = ("import sys\n"
            "from particlesystem_tpu_torch.__main__ import main\n"
            "from particlesystem_tpu_torch.utils import cuda_build\n"
            "main(sys.argv[1:])\n"
            "print('pair launches', cuda_build.launches()"
            ".get('ps_cluster_pair', 0))\n")


def bench_passes(name: str, kw: dict) -> int:
    """Neighbour passes of an n-body bench stage at the counts ``kw``: the
    warm-up, then ``reps`` short and long batches."""
    from particlesystem_tpu_torch import bench
    warm = kw["k_short"] if name == "nbody_sharded_d1" else bench.WARM_FRAMES
    return warm + kw["reps"] * (kw["k_short"] + kw["k_long"])


def emitter_frames(kw: dict) -> int:
    """Frames of an emitter bench stage at the counts ``kw``: a short and a
    long batch to warm up, ``soak`` long ones, then ``reps`` of each."""
    short, long_ = kw["k_short"], kw["k_long"]
    return (1 + kw["reps"]) * (short + long_) + kw.get("soak", 0) * long_


def bench_stage_fns(dev, cut=None, checks=None):
    """{stage: thunk} of the bench at the counts of ``cut``.  With
    ``checks`` (a dict), each n-body stage runs under :func:`pair_checks`
    on its first and last pass run in Python (the sharded loop's one
    eager frame; the single-device loop's first and last key's), on
    :data:`BENCH_CHECK_BLOCKS` live blocks, and leaves its records in
    ``checks[stage]``."""
    from particlesystem_tpu_torch import bench
    from particlesystem_tpu_torch.core.config import GridSpec, NBodyConfig
    from particlesystem_tpu_torch.ops import neighbor_blocks as nbk
    from particlesystem_tpu_torch.parallel import nbody_sharded
    fns = {"cap_10m": bench.bench_capacity, "cap_1m": bench.bench_capacity,
           "nbody_1m": bench.bench_nbody,
           "nbody_sharded_d1": bench.bench_nbody_sharded_d1,
           "nbody_10m": bench.bench_nbody}
    cut = cut or BENCH_CUT

    def stage(name, kw):
        if checks is None or not name.startswith("nbody"):
            return fns[name](device=dev, **kw)
        sharded = name == "nbody_sharded_d1"
        slots = NBodyConfig(n_fill=kw["n_fill"],
                            grid=GridSpec(grid_dim=kw["grid_dim"])).slots
        # a loop runs only each key's first frame in Python, its other
        # frames replayed: the sharded loop has one key, the single-device
        # loop one a prefix
        at = (0,) if sharded else (0, LAST)
        with pair_checks(nbody_sharded if sharded else nbk, at,
                         slots if sharded else None,
                         BENCH_CHECK_BLOCKS) as recs:
            out = fns[name](device=dev, **kw)
        calls = [r["call"] for r in recs]
        assert calls[0] == 0 and len(calls) == len(at), (name, recs)
        checks[name] = recs
        return out

    return {name: (lambda name=name, kw=kw: stage(name, kw))
            for name, kw in cut.items()}


def phase_bench(dev, cut=None):
    """12a: every bench stage at cut counts, through ``bench.run``: the
    line holds every key, none null on a card; the stages launched both
    kernels of their paths, the pair kernel once a pass; the first and
    the last pass of each n-body stage held against the plain version
    (the launches of that check not counted).  Returns (the line, the
    largest acc error of those checks)."""
    import io

    from particlesystem_tpu_torch import bench
    cut = cut or BENCH_CUT
    t0 = time.perf_counter()
    out = io.StringIO()
    checks = {}
    base = launched()
    res = bench.run(bench_stage_fns(dev, cut, checks),
                    card_line() if dev.type == "cuda" else "cpu", out=out)
    counts = launched(base)
    printed = json.loads(out.getvalue().splitlines()[-1])
    assert printed == res and set(res) == set(bench.empty_line("")), res
    passes = sum(bench_passes(name, kw) for name, kw in cut.items()
                 if name.startswith("nbody"))
    nbody_stages = sum(name.startswith("nbody") for name in cut)
    frames = sum(emitter_frames(kw) for name, kw in cut.items()
                 if name.startswith("cap"))
    if dev.type == "cuda":
        assert all(v is not None for v in res.values()), res
        # the threefry kernel once a pass, the fill kernel once an
        # init_fill; the emitter frame's spawn, physics and tail kernels
        # once a frame
        n = lambda k: counts.get(k, 0)
        assert (n("ps_cluster_pair"), n("ps_nbody_frame_fields"),
                n("ps_nbody_fill"), n("ps_flat_fields")) == (
                    passes, passes, nbody_stages, 0), (counts, passes)
        assert [n(k) for k in ("ps_emitter_spawn", "ps_physics_step",
                               "ps_emitter_tail", "ps_emitter_ring")] == [
            frames, frames, frames, 0], (counts, frames)
        # A once a single-device frame; B-E once a pass of either path
        # (the decomposed frame runs all but A)
        single = passes - sum(bench_passes(name, kw)
                              for name, kw in cut.items()
                              if name == "nbody_sharded_d1")
        assert [n(k) for k in FRAME_ENTRIES] == [
            single, passes, passes, passes, passes], (counts, single)
    err = max([r["err"] or 0.0 for recs in checks.values() for r in recs],
              default=0.0)
    print(f"phase 12a: bench stages at cut counts "
          f"({time.perf_counter() - t0:.1f} s), launches {counts} "
          f"({passes} n-body passes): {json.dumps(res)}")
    for name, recs in checks.items():
        print(f"phase 12a: {name}: the pair kernel vs its plain version on "
              f"{BENCH_CHECK_BLOCKS} evenly spaced live blocks: "
              f"{pair_check_text(recs)}")
    return res, err


def phase_entry(dev):
    """12b: ``entry()``'s frame on the card against the same frame on the
    CPU (bookkeeping and alive masks exact, fields within 1e-4, as phase
    6), two frames; then ``dryrun_multichip(8)`` on ``dev``."""
    import numpy as np
    from particlesystem_tpu_torch.entry import dryrun_multichip, entry
    from particlesystem_tpu_torch.runtime.engine import (
        engine_state_from_numpy, engine_state_to_numpy)

    fn, (es,) = entry(device=dev)
    fn_cpu, (es_cpu,) = entry(device="cpu")
    es_cpu = engine_state_from_numpy(engine_state_to_numpy(es), es_cpu)
    nf = es.n_fields
    base = launched()
    err = 0.0
    for frame in range(2):
        es, es_cpu = fn(es), fn_cpu(es_cpu)
        got, want = engine_state_to_numpy(es), engine_state_to_numpy(es_cpu)
        for a, b in zip(got[nf:], want[nf:]):
            assert np.array_equal(a, b), f"entry frame {frame}: bookkeeping"
        alive = [(f[6] <= f[7]) & (f[7] > 0) for f in (got, want)]
        assert np.array_equal(*alive), f"entry frame {frame}: alive"
        for a, b in zip(got[:nf], want[:nf]):
            np.testing.assert_allclose(a, b, rtol=TRAJ_TOL, atol=TRAJ_TOL)
            err = max(err, float(np.abs(a - b).max()))
    counts = launched(base, engine_frames("select",
                                          2 if dev.type == "cuda" else 0))
    n, n_rng = (counts.get(k, 0) for k in ("ps_physics_step",
                                           "ps_emitter_spawn"))
    print(f"phase 12b: entry() 2 frames on {dev} == cpu (bookkeeping and "
          f"alive exact, fields within {TRAJ_TOL}: max abs err {err:.3e}), "
          f"alive {int(alive[0].sum())}, physics launches {n}, spawn and "
          f"tail launches {n_rng}")
    t0 = time.perf_counter()
    stats = dryrun_multichip(8, device=dev)
    print(f"phase 12b: dryrun_multichip(8) on {dev} over gloo "
          f"({time.perf_counter() - t0:.1f} s with the spawn): "
          + "; ".join(f"{k} alive {v['n_alive']} spawned {v['n_spawned']} "
                      f"capped {v['n_spawn_capped']} pair launches a rank "
                      f"{v['pair_launches']}"
                      for k, v in stats.items()))
    for name, v in stats.items():
        assert v["n_alive"] > 0 and v["n_spawn_capped"] == 0, (name, v)
        assert v["pair_launches"] == (1 if dev.type == "cuda" else 0), \
            (name, v)


def launch_cli(device: str, tmp: str, tag: str):
    """Two processes of the CLI under the ``PSTPU_*`` launcher variables,
    each writing to its own file (a rank whose pipe filled would stall the
    other in a collective); returns each rank's output and its pair-kernel
    launches.  Both are killed at the time limit."""
    import os

    from particlesystem_tpu_torch.parallel.mesh import free_port
    port = free_port()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("PSTPU_", "LOCAL_"))}
    logs = [os.path.join(tmp, f"{tag}_rank{pid}.log") for pid in range(2)]
    procs = []
    try:
        for pid, log in enumerate(logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", CLI_MAIN, *CLI_ARGS, "--device",
                     device, "--save", os.path.join(tmp, tag)],
                    stdout=f, stderr=subprocess.STDOUT,
                    cwd=os.path.dirname(os.path.abspath(__file__)),
                    env=dict(base, PSTPU_COORDINATOR=f"127.0.0.1:{port}",
                             PSTPU_NUM_PROCESSES="2",
                             PSTPU_PROCESS_ID=str(pid),
                             LOCAL_WORLD_SIZE="2")))
        deadline = time.monotonic() + SPAWN_TIMEOUT
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [open(log).read() for log in logs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"--device {device}:\n{out[-3000:]}"
    counts = []
    for out in outs:
        line = [l for l in out.splitlines() if l.startswith("pair launches")]
        assert line, out[-3000:]
        counts.append(int(line[-1].split()[-1]))
    return outs, counts


def phase_cli_launcher(devices):
    """12c: ``nbody --devices 2 --validate --save`` as 2 processes under
    the ``PSTPU_*`` variables, for each of ``devices`` (gloo); on a card
    each rank launched the pair kernel at least once a frame."""
    import tempfile
    for device in devices:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            outs, counts = launch_cli(device, tmp, "run")
        lines = outs[0].splitlines()
        line = [l for l in lines if l.startswith("validate")]
        assert line and "'events_match': True" in line[0], outs[0][-3000:]
        final = [l for l in lines if l.startswith("final:")]
        if device.startswith("cuda"):
            assert all(n >= CLI_ITERS for n in counts), counts
        else:
            assert counts == [0, 0], counts
        print(f"phase 12c: CLI on 2 launched processes, --device {device}: "
              f"{final[0]}; {line[0]}; pair launches by rank {counts} "
              f"({time.perf_counter() - t0:.1f} s)")


def phase_tools(dev, ckpt_args=(), batched_args=()):
    """12d: ``tools.measure_ckpt_10m`` and ``tools.measure_batched_run``
    once each."""
    from particlesystem_tpu_torch.tools import (measure_batched_run,
                                                measure_ckpt_10m)
    dev_arg = ["--device", str(dev)]
    ck = measure_ckpt_10m.main(list(ckpt_args) + dev_arg)
    assert ck["n_dropped_on_load"] == 0, ck
    print(f"phase 12d: measure_ckpt_10m: {json.dumps(ck)}")
    br = measure_batched_run.main(list(batched_args) + dev_arg)
    print(f"phase 12d: measure_batched_run: {json.dumps(br)}")
    return ck, br


# ---------------------------------------------------------------------------
# phase 13: the threefry kernel
# ---------------------------------------------------------------------------

#: tags at the edges of the uint32 values they hold
EDGE_TAGS = (0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF)
#: slots of the 10M n-body stage (10,485,760 particles, twice the slots)
NBODY_10M_SLOTS = 20 * 2 ** 20
#: integer instructions of one threefry2x32 hash: an IADD, a SHF and a
#: LOP3 a round (60), the key injections and the key schedule's parity
INT_OPS_PER_HASH = 72
#: float32 operations at the peak that take the issue slot of one
#: instruction a lane: four schedulers an SM dispatch one warp instruction
#: a clock each (128 lanes, as for FP32, whose peak counts an FFMA as two);
#: the hash's adds go to the 64 INT32 lanes and, as IMAD, to the FMA lanes,
#: so the INT32 lanes alone do not bound it
FLOPS_A_SLOT = 2
#: hashes of one n-body tag: two fold_ins, three uvec draws, one fert draw
HASHES_PER_TAG = 6
#: the kernels' threads a block and most blocks (csrc/threefry.cu)
THREEFRY_THREADS, THREEFRY_MAX_BLOCKS = 256, 132 * 16


def threefry_blocks(items: int) -> int:
    return min(-(-items // THREEFRY_THREADS), THREEFRY_MAX_BLOCKS)


def nbody_fields_work(tags: int):
    """(hashes, bytes) of ``ps_nbody_frame_fields`` over ``tags`` tags: six
    hashes a tag and, in each block, two for the frame's keys; 8 bytes in
    and 16 out a tag, and the frame's 8 bytes."""
    return (HASHES_PER_TAG * tags + 2 * threefry_blocks(tags),
            24 * tags + 8)


def flat_fields_work(counters: int, items: int, key_hashes: int):
    """(hashes, bytes) of ``ps_flat_fields``: one hash a counter and, in
    each block, ``key_hashes`` for the draws' keys; 4 bytes out a counter,
    and the frame's 8 bytes in."""
    return (counters + key_hashes * threefry_blocks(items),
            4 * counters + 8)


def threefry_bound(hashes: int, n_bytes: int):
    """(least milliseconds, what bounds it) of ``hashes`` hashes that read
    and write ``n_bytes``: the instruction rate against device-memory
    bytes."""
    return bound_ms(FLOPS_A_SLOT * INT_OPS_PER_HASH * hashes, n_bytes)


def threefry_sass() -> dict:
    """{kernel: (instructions, {opcode: count})} of the threefry kernels in
    the built library, from ``cuobjdump -sass``."""
    from particlesystem_tpu_torch.utils.cuda_build import sass_instructions
    out = {}
    for name, instructions in sass_instructions().items():
        key = next((k for k in ("nbody_frame_fields", "flat_fields",
                                "nbody_fill") if k in name), None)
        if key is not None:
            counts: dict = {}
            for ins in instructions:
                op = ins.split(".")[0]
                counts[op] = counts.get(op, 0) + 1
            out[key] = (len(instructions), counts)
    return out


def time_threefry(name, kern, plain, hashes, n_bytes):
    """Kernel against plain version timed (plain, kernel, kernel, plain)
    beside the bound; returns the row of the kernels line."""
    p1 = cuda_ms(plain, 3)
    k1 = cuda_ms(kern, 50)
    k2 = cuda_ms(kern, 50)
    p2 = cuda_ms(plain, 3)
    dev_ms = graph_ms(kern, 50)
    bound, by = threefry_bound(hashes, n_bytes)
    print(f"phase 13: {name}: kernel {k1:.5f} / {k2:.5f} ms through the "
          f"wrapper, {dev_ms:.5f} ms in a CUDA graph; plain {p1:.3f} / "
          f"{p2:.3f} ms (plain, kernel, kernel, plain); {hashes} hashes x "
          f"{INT_OPS_PER_HASH} integer instructions, {n_bytes} bytes: bound "
          f"{bound:.5f} ms ({by}), {bound / min(k1, k2):.1%} of it through "
          f"the wrapper, {bound / dev_ms:.1%} in the graph")
    return dict(ms=min(k1, k2), graph_ms=dev_ms, plain_ms=min(p1, p2),
                bound_ms=bound, bound_by=by)


#: bytes the fill kernel writes a slot: pos, vel, acc 12 each; w, age, life
#: 4 each; alive, parent 1 each; tag 8
FILL_BYTES_PER_SLOT = 58
#: hashes of one filled particle: r and u_sign 3 each, age, life
FILL_HASHES = 8
#: hashes of a block's keys: four draws' frame key and split index
FILL_KEY_HASHES = 8
#: slots a thread of the fill kernel writes
FILL_SLOTS = 4
#: particle counts the fill is held at, beside the configuration's n_fill
#: and its slots: none, one, and one past a 4,096 boundary
FILL_COUNTS = (0, 1, 4097)
#: the small capacity the fill is also held at: no multiple of the
#: kernel's four slots a thread
FILL_SMALL_CAPACITY = 4099


def fill_cases():
    """(configuration, particle counts) the fill is held at on the card:
    ``NBodyConfig()`` and a small capacity, each at two seeds."""
    from particlesystem_tpu_torch import GridSpec, NBodyConfig
    out = []
    for seed in (42, (1 << 33) + 5):
        for cfg in (NBodyConfig(seed=seed),
                    NBodyConfig(n_fill=2000, capacity=FILL_SMALL_CAPACITY,
                                seed=seed, grid=GridSpec(grid_dim=4))):
            counts = sorted({min(n, cfg.slots) for n in
                             FILL_COUNTS + (cfg.n_fill, cfg.slots)})
            out.append((cfg, counts))
    return out


def hold_fill(dev) -> None:
    """The fill kernel (``init_fill`` on the card) against its plain version
    on the CPU, every field bit for bit, one launch a fill."""
    from particlesystem_tpu_torch.core.state import FIELDS
    from particlesystem_tpu_torch.models import nbody
    import torch
    for cfg, counts in fill_cases():
        for n in counts:
            base = launched()
            card = nbody.init_fill(cfg, dev, n)
            launched(base, dict(ps_nbody_fill=1))
            host = nbody.init_fill(cfg, "cpu", n)
            for f in FIELDS:
                a, b = getattr(card, f).cpu(), getattr(host, f)
                assert a.dtype == b.dtype and a.shape == b.shape, f
                if a.is_floating_point():
                    a, b = a.view(torch.int32), b.view(torch.int32)
                assert torch.equal(a, b), \
                    f"fill, seed {cfg.seed}, {cfg.slots} slots, n {n}: {f}"
        print(f"phase 13: fill kernel == plain (CPU) bit for bit, every "
              f"field, seed {cfg.seed}, {cfg.slots} slots, n in {counts}; "
              f"one launch a fill")


def fill_span_kernels(dev, cfg, k: int = 4) -> tuple:
    """(``nbody.fill`` spans, the names of the device operations) of a
    trace of ``k`` fills, each followed by a sync.  The operations are
    counted over the whole session, not put down to spans by their stamps:
    the device's and the host's clocks in a trace can sit milliseconds
    apart.  A session's first kernels can go missing, so a trace that holds
    fewer than ``k - 1`` operations is taken again, at most
    :data:`TRACE_ATTEMPTS` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from particlesystem_tpu_torch.models import nbody
    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(k):
                nbody.init_fill(cfg, dev)
                torch.cuda.synchronize()
        events = prof.events()
        spans = sum(e.name == "nbody.fill" and e.device_type != cuda
                    for e in events)
        ops = [e.name for e in events
               if e.device_type == cuda and e.name != "nbody.fill"]
        if len(ops) >= k - 1:
            return spans, ops
        print(f"trace of {k} fills, attempt {attempt}: {len(ops)} device "
              f"operations; taken again")
    raise AssertionError(f"no trace of {k} fills in {TRACE_ATTEMPTS} "
                         f"attempts")


def host_us(fn, reps: int) -> float:
    """Host microseconds a call of ``fn`` over ``reps`` calls, the card
    synced before and after (the card's work overlaps the host's)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def time_fill(dev) -> dict:
    """The fill kernel at ``NBodyConfig()`` (2,097,152 slots, 1,048,576
    drawn) through the wrapper (``init_fill``), in a CUDA graph and on the
    host's clock, beside the old composition (``init_fill_plain`` on the
    card: the threefry kernel and some 20 torch launches) and the bound;
    then a trace: one device kernel in each ``nbody.fill`` span."""
    from particlesystem_tpu_torch import NBodyConfig
    from particlesystem_tpu_torch.models import nbody
    cfg = NBodyConfig()
    n = cfg.n_fill
    kern = lambda: nbody.init_fill(cfg, dev)
    old = lambda: nbody.init_fill_plain(cfg, dev, n)
    o1 = cuda_ms(old, 10)
    k1 = cuda_ms(kern, 20)
    k2 = cuda_ms(kern, 20)
    o2 = cuda_ms(old, 10)
    k_graph = graph_ms(kern, 10)
    o_graph = graph_ms(old, 10)
    k_host, o_host = host_us(kern, 50), host_us(old, 20)
    hashes = FILL_HASHES * n + FILL_KEY_HASHES * threefry_blocks(
        -(-cfg.slots // FILL_SLOTS))
    n_bytes = FILL_BYTES_PER_SLOT * cfg.slots
    bound, by = threefry_bound(hashes, n_bytes)
    print(f"phase 13: fill kernel, {cfg.slots} slots, {n} drawn: "
          f"{k1:.5f} / {k2:.5f} ms through the wrapper, {k_graph:.5f} ms in "
          f"a CUDA graph, {k_host:.1f} us of host a call; the old "
          f"composition {o1:.5f} / {o2:.5f} ms, {o_graph:.5f} ms in a graph, "
          f"{o_host:.1f} us of host (old, kernel, kernel, old); {hashes} "
          f"hashes, {n_bytes} bytes written: bound {bound:.5f} ms ({by}), "
          f"{bound / min(k1, k2):.1%} of it through the wrapper, "
          f"{bound / k_graph:.1%} in the graph")
    spans, ops = fill_span_kernels(dev, cfg, 4)
    # every operation of the session a fill kernel, at most one a span
    assert spans == 4 and ops and len(ops) <= spans and all(
        "nbody_fill" in op for op in ops), (spans, ops)
    print(f"phase 13: a trace of {spans} nbody.fill spans holds {len(ops)} "
          f"device operations, each the fill kernel: {ops[0]}")
    return dict(ms=min(k1, k2), graph_ms=k_graph, plain_ms=min(o1, o2),
                bound_ms=bound, bound_by=by, host_us=k_host)


def phase_threefry(dev, plateau_tags):
    """13: the threefry kernel against its plain version, bit for bit, at
    full width: the n-body fields of ``NBodyConfig()``'s 2,097,152 tags,
    the 10M stage's 20,971,520 and the plateau prefix of phase 4
    (``plateau_tags``), each with the edge tags, at frames 0 and 20; the
    emitter's spawn draws at the bench scene's ``SpawnTable.total``,
    salts 0 and 3; ``init_fill``'s draws at 1M; the fill kernel against
    ``init_fill`` on the CPU (:func:`hold_fill`).  Then each timed beside
    its bound, and the kernels' SASS read; the fill as :func:`time_fill`."""
    import shutil

    import torch
    from particlesystem_tpu_torch import NBodyConfig
    from particlesystem_tpu_torch.models import emitter as em
    from particlesystem_tpu_torch.models import nbody
    from particlesystem_tpu_torch.ops import rng_kernel as rk

    cfg = NBodyConfig()
    seed, lo, hi = cfg.seed, cfg.min_fertility_age, cfg.max_fertility_age
    edge = torch.tensor(EDGE_TAGS, dtype=torch.int64, device=dev)
    err = 0.0
    for name, tags in (
            (f"plateau prefix {plateau_tags.numel()}", plateau_tags),
            (f"{cfg.slots} slots", torch.arange(cfg.slots, device=dev)),
            (f"{NBODY_10M_SLOTS} slots",
             torch.arange(NBODY_10M_SLOTS, device=dev))):
        tags = torch.cat([tags, edge])
        for frame in (0, 20):
            # the frame as the kernel reads it, from device memory
            frame_t = torch.tensor(frame, dtype=torch.int64, device=dev)
            err = max(err, same_bits(
                rk.nbody_fields_cuda(seed, frame_t, tags, lo, hi),
                rk.nbody_fields_plain(seed, frame, tags, lo, hi),
                f"n-body fields, {name}, frame {frame}"))
        print(f"phase 13: n-body fields, {name} + {len(EDGE_TAGS)} edge "
              f"tags, frames 0 and 20: uvec and fert kernel == plain bit "
              f"for bit")
        del tags
    scene = bench_scene(EMIT_SLOTS)
    total = em.SpawnTable(scene, dev).total
    for salt in (0, 3):
        draws = em.spawn_draws(scene, salt, total)
        for frame in (0, 20):
            frame_t = torch.tensor(frame, dtype=torch.int64, device=dev)
            err = max(err, same_bits(
                rk.flat_fields_cuda(draws, frame_t, dev),
                rk.flat_fields_plain(draws, frame, dev),
                f"spawn draws, salt {salt}, frame {frame}"))
    print(f"phase 13: spawn draws of the bench scene, {total} rows, salts 0 "
          f"and 3, frames 0 and 20: u and dirs kernel == plain bit for bit")
    fill = nbody.fill_draws(cfg, cfg.n_fill)
    err = max(err, same_bits(rk.flat_fields_cuda(fill, 0, dev),
                             rk.flat_fields_plain(fill, 0, dev), "init_fill"))
    print(f"phase 13: init_fill's four draws at {cfg.n_fill} particles: "
          f"kernel == plain bit for bit")
    hold_fill(dev)

    n = plateau_tags.numel()
    f20 = torch.tensor(20, dtype=torch.int64, device=dev)
    main = time_threefry(
        f"n-body fields, plateau prefix {n} tags",
        lambda: rk.nbody_fields_cuda(seed, f20, plateau_tags, lo, hi),
        lambda: rk.nbody_fields_plain(seed, 20, plateau_tags, lo, hi),
        *nbody_fields_work(n))
    for slots in (cfg.slots, NBODY_10M_SLOTS):
        tags = torch.arange(slots, device=dev)
        ms = cuda_ms(lambda: rk.nbody_fields_cuda(seed, f20, tags, lo, hi),
                     20)
        bound, by = threefry_bound(*nbody_fields_work(slots))
        print(f"phase 13: n-body fields, {slots} tags: kernel {ms:.5f} ms, "
              f"bound {bound:.5f} ms ({by}), {bound / ms:.1%} of it")
        del tags
    draws = em.spawn_draws(scene, 0, total)
    # draw keys: the salt folded in (2 hashes), then 1 (3 hashes)
    time_threefry(f"spawn draws, {total} rows",
                  lambda: rk.flat_fields_cuda(draws, f20, dev),
                  lambda: rk.flat_fields_plain(draws, 20, dev),
                  *flat_fields_work(11 * total, 9 * total, 2 + 3))
    fill_row = time_fill(dev)
    if shutil.which("cuobjdump") or shutil.which("nvcc"):
        for kernel, (count, ops) in threefry_sass().items():
            top = sorted(ops.items(), key=lambda kv: -kv[1])[:8]
            print(f"phase 13: sass {kernel}: {count} instructions; "
                  + " ".join(f"{op}:{c}" for op, c in top))
    else:
        print("phase 13: sass not read: no cuobjdump on this machine")
    return dict(err=err, fill=fill_row, **main)


# ---------------------------------------------------------------------------
# phase 14: the frame loops as CUDA graphs
# ---------------------------------------------------------------------------

#: engine frames of phase 14: two step_many calls, 120 frames
GRAPH_ENGINE_STEPS = (64, 56)
#: n-body batches of phase 14, 20 frames: the full-width key's warm-up,
#: capture and replays; the prefix key's warm-up, capture and a replay;
#: then replays only, timed
GRAPH_NBODY_BATCHES = (10, 2, 8)
#: frames of each phase-14 trace
GRAPH_TRACE_FRAMES = 8


#: a trace whose frames lack a launch is taken again, this often at most
TRACE_ATTEMPTS = 3
#: the profiler range around a trace's frames
TRACE_MARK = "chip_smoke.traced_frames"


def trace_frames(step, k: int, expect=()) -> dict:
    """``k`` calls of ``step`` (a frame each) under torch.profiler, after
    one more inside the same session whose events are left out (a
    session's first kernels can go missing): kernels and copies/sets a
    frame, device ms a frame, wall ms a frame, the device's busy share and
    the trace's sums by kernel name (``sums``).  Each kernel function of
    ``expect`` is launched once a frame: a trace that holds another count
    of one is taken again (``attempts``), and fails after
    :data:`TRACE_ATTEMPTS`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
            with record_function(TRACE_MARK):
                t0 = time.perf_counter()
                for _ in range(k):
                    step()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        cuda = torch.autograd.DeviceType.CUDA
        mark = next(e.time_range.start for e in prof.events()
                    if e.name == TRACE_MARK and e.device_type != cuda)
        # the device's kernels, copies and sets, not the range's own span
        events = [e for e in prof.events()
                  if e.device_type == cuda and e.name != TRACE_MARK
                  and e.time_range.start >= mark]
        sums = kernel_sums(events)
        short = {f: n for f in expect
                 if (n := sum(h[0] for h in _launches_of(sums, f))) != k}
        if not short:
            break
        print(f"trace of {k} frames, attempt {attempt}: launches seen "
              f"{short}, expected {k} of each; taken again")
    else:
        raise AssertionError(f"no complete trace of {k} frames in "
                             f"{TRACE_ATTEMPTS} attempts")
    moves = [e for e in events if e.name.startswith(("Memcpy", "Memset"))]
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    return dict(kernels=(len(events) - len(moves)) / k, moves=len(moves) / k,
                device_ms=busy_us / k / 1e3, wall_ms=wall_us / k / 1e3,
                busy=busy_us / wall_us, sums=sums, attempts=attempt)


def graph_nodes(fn):
    """Nodes of a CUDA graph of ``fn``, captured on its own and never
    replayed (its launches not counted), by libcuda's
    ``cuGraphGetNodes``; None where this torch cannot hand over the
    captured graph."""
    import ctypes

    import torch
    from particlesystem_tpu_torch.utils.cuda_build import recording
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        return None
    with recording(), torch.cuda.graph(graph,
                                       capture_error_mode="thread_local"):
        fn()
    try:
        raw = ctypes.c_void_p(int(graph.raw_cuda_graph()))
    except (AttributeError, RuntimeError, TypeError):
        return None
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(raw, None,
                                                       ctypes.byref(n))
    return None if err else n.value


def graph_launch_checks(graphs, key, frames: int, kernels, since) -> str:
    """The loop ran ``frames`` frames, each kernel of ``kernels`` (C entry
    points) once a frame: ``eager + replays == frames``, the graph of
    ``key`` records each kernel once, and ``frames`` launches of each were
    counted since ``since`` (:func:`launched`)."""
    rec = graphs.recorded(key)
    assert rec == {k: 1 for k in kernels}, f"the graph records {rec}"
    assert graphs.eager_frames + graphs.replays == frames, \
        (graphs.eager_frames, graphs.replays, frames)
    launched(since, {k: frames for k in kernels})
    return (f"{graphs.eager_frames} eager (captured {graphs.captures}) + "
            f"{graphs.replays} replays = {frames} frames, each kernel "
            f"({', '.join(kernels)}) recorded once a graph: {frames} "
            f"launches each")


def phase_graphs_nbody(dev, eager_kernels=None):
    """14 (n-body): ``NBodyConfig()`` at full width, 20 frames of ``run``
    through the frame graphs in batches of 10, 2 and 8 (the prefix engages
    after the first; the last batch replays only) against 20 eager
    ``nbody.step`` frames from the same state on the same prefix schedule:
    every field, mask and stat bit-identical after each batch; ms a frame
    of each in the last batch, the host's microseconds a replay, the
    graph's nodes, kernels a frame in a trace of replays and the busy
    share."""
    import torch
    from particlesystem_tpu_torch import NBodyConfig
    from particlesystem_tpu_torch.api import NBodySimulation
    from particlesystem_tpu_torch.core.state import FIELDS
    from particlesystem_tpu_torch.models import nbody

    cfg = NBodyConfig()
    sim = NBodySimulation(cfg, device=dev)
    ref = sim.state.map(lambda a: a.clone())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    frames = sum(GRAPH_NBODY_BATCHES)
    base = launched()
    batches = []
    for k in GRAPH_NBODY_BATCHES:
        active = sim._active
        start.record()
        sim.run(k, batch=k)
        end.record()
        torch.cuda.synchronize()
        batches.append(dict(k=k, active=active, ms=start.elapsed_time(end)
                            / k, stats=sim.last_stats,
                            state=sim.state.map(lambda a: a.clone()),
                            next_active=sim._active))
    key = sim._key()
    counted = graph_launch_checks(sim.graphs, key, frames,
                                  ("ps_cluster_pair", "ps_nbody_frame_fields")
                                  + FRAME_ENTRIES, base)

    base = launched()
    frame = 0
    for b in batches:
        t0 = time.perf_counter()
        start.record()
        for _ in range(b["k"]):
            ref, stats = nbody.step(ref, frame, cfg, "blocks", b["active"])
            frame += 1
        end.record()
        b["eager_host_us"] = (time.perf_counter() - t0) * 1e6 / b["k"]
        torch.cuda.synchronize()
        b["eager_ms"] = start.elapsed_time(end) / b["k"]
        for k, v in vars(stats).items():
            assert int(v) == int(getattr(b["stats"], k)), \
                f"frame {frame}: graph vs eager stat {k}"
        if (b["next_active"] or cfg.slots) < (b["active"] or cfg.slots):
            ref = nbody.compact_state(ref)
        for f in FIELDS:
            assert torch.equal(getattr(b["state"], f), getattr(ref, f)), \
                f"frame {frame}: graph vs eager {f}"
    launched(base, nbody_frames(frames))
    for f in FIELDS:
        assert torch.equal(getattr(sim.state, f), getattr(ref, f))
    del ref
    for b in batches:
        del b["state"]

    # the loop's own frame function, as the graph runs it: the host's time
    # a frame, a trace, the nodes (the static state runs on; not kept)
    fn = lambda: sim._loop_frame(sim._active, sim._width)
    step = lambda: sim.graphs.step(key, fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MAIN_ITERS):
        step()
    host_us = (time.perf_counter() - t0) * 1e6 / MAIN_ITERS
    torch.cuda.synchronize()
    # the same frames traced twice: replayed, then from the same state run
    # eagerly (the loop's frame function called, no graph), the two ends
    # bit-identical; the two traces' sums, kernel by kernel
    buffers = lambda: [*(getattr(sim._static, f) for f in FIELDS),
                       sim._frame_t, sim._guards, sim._stats]
    before = [b.clone() for b in buffers()]
    trace = trace_frames(step, GRAPH_TRACE_FRAMES, NBODY_FRAME_FUNCTIONS)
    replayed = [b.clone() for b in buffers()]
    for b, v in zip(buffers(), before):
        b.copy_(v)
    eager = trace_frames(fn, GRAPH_TRACE_FRAMES, NBODY_FRAME_FUNCTIONS)
    assert all(torch.equal(a, b) for a, b in zip(buffers(), replayed)), \
        "traced replays and traced eager frames end apart"
    del before, replayed
    nodes = graph_nodes(fn)
    last = batches[-1]
    per = lambda t, name: t["sums"].get(name, (0, 0.0))
    names = sorted(set(trace["sums"]) | set(eager["sums"]),
                   key=lambda k: -max(per(trace, k)[1], per(eager, k)[1]))
    print(f"phase 14: n-body, the same {GRAPH_TRACE_FRAMES} frames from "
          f"the same state (after one frame left out of each trace; traces "
          f"taken {trace['attempts']} | {eager['attempts']} times), each "
          f"kernel's launches and microseconds a frame, replayed | eager: "
          + "; ".join(
              f"{name[:40]} {per(trace, name)[0] / GRAPH_TRACE_FRAMES:g} "
              f"{per(trace, name)[1] / GRAPH_TRACE_FRAMES:.2f} | "
              f"{per(eager, name)[0] / GRAPH_TRACE_FRAMES:g} "
              f"{per(eager, name)[1] / GRAPH_TRACE_FRAMES:.2f}"
              for name in names)
          + f"; totals {trace['device_ms'] * 1e3:.2f} | "
          f"{eager['device_ms'] * 1e3:.2f} us in {trace['kernels']:.1f} | "
          f"{eager['kernels']:.1f} kernels")
    in_replay = frame_kernel_times(trace["sums"], GRAPH_TRACE_FRAMES)
    print(f"phase 14: the frame kernels in the {GRAPH_TRACE_FRAMES} traced "
          f"replays, microseconds a launch (launches): " + "; ".join(
              f"{k} {us / n:.2f} ({n})" for k, (n, us) in in_replay.items()))
    print(f"phase 14: n-body {cfg.n_fill} particles, {cfg.slots} slots, "
          f"run() in batches of {GRAPH_NBODY_BATCHES} through frame graphs "
          f"== {frames} eager nbody.step frames on the same prefixes "
          f"({[b['active'] or cfg.slots for b in batches]}): every field, "
          f"mask and stat bit-identical after each batch (alive "
          f"{int(last['stats'].n_alive)}); {counted}")
    print(f"phase 14: n-body ms a frame, frames {frames - last['k'] + 1}-"
          f"{frames} (replays only): graphs {last['ms']:.4f}, eager "
          f"{last['eager_ms']:.4f}; the earlier batches, each with a key's "
          f"warm-up frame and capture: graphs "
          f"{[round(b['ms'], 4) for b in batches[:-1]]}, eager "
          f"{[round(b['eager_ms'], 4) for b in batches[:-1]]}; the host's "
          f"microseconds a frame: {host_us:.1f} a replay, "
          f"{last['eager_host_us']:.1f} an eager frame; graph nodes "
          f"{'not measured' if nodes is None else nodes}; a trace of "
          f"{GRAPH_TRACE_FRAMES} replays: {trace['kernels']:.1f} kernels "
          f"and {trace['moves']:.1f} copies/sets a frame"
          + ("" if eager_kernels is None else
             f" ({eager_kernels} kernels and copies in phase 4's eager "
             f"frame)")
          + f", {trace['device_ms']:.4f} ms of device time in "
          f"{trace['wall_ms']:.4f} ms a frame, device busy "
          f"{trace['busy']:.1%}")
    return dict(ms=last["ms"], eager_ms=last["eager_ms"], host_us=host_us,
                nodes=nodes, eager_device_ms=eager["device_ms"], **trace)


def phase_graphs_dense(dev):
    """14 (dense): ``NBodySimulation(impl="dense")`` through its frame
    graphs on the card (keys changing with the adaptive list width)
    against the same loop on the CPU, at phase 3's config: stats and
    masks exact, floats by the chaotic-trajectory rule."""
    import numpy as np
    from particlesystem_tpu_torch import GridSpec, NBodyConfig
    from particlesystem_tpu_torch.api import NBodySimulation
    from particlesystem_tpu_torch.core.state import state_to_numpy

    cfg = NBodyConfig(n_fill=2000, capacity=4096, max_per_cell=48, seed=3,
                      grid=GridSpec(grid_dim=4, cell_size=5.0,
                                    chunk_factor=2))  # DENSE
    sims = [NBodySimulation(cfg, device=d, impl="dense",
                            active_bucketing=False) for d in (dev, "cpu")]
    widths = []
    for _ in range(4):
        widths.append(sims[0]._width)
        stats = [sim.run(2, batch=2) for sim in sims]
        for k, v in vars(stats[1]).items():
            assert int(getattr(stats[0], k)) == int(v), f"dense: {k}"
        a, b = (state_to_numpy(sim.state) for sim in sims)
        for f in ("alive", "parent"):
            assert np.array_equal(a[f], b[f]), f"dense: {f}"
        for f in ("pos", "vel", "age", "life", "w"):
            assert_close_chaotic(a[f], b[f], f"dense {f}")
    g = sims[0].graphs
    assert g.captures >= (dev.type == "cuda"), "no graph captured"
    assert g.eager_frames + g.replays == 8, \
        (g.eager_frames, g.replays)
    print(f"phase 14: dense, {cfg.n_fill} particles, run(2) four times "
          f"through frame graphs on the card == the same loop on the CPU "
          f"(stats and masks exact), list widths {widths}; "
          f"{g.eager_frames} eager (captured {g.captures}) + {g.replays} "
          f"replays")


#: the engine loops of phase 14, each at 10,485,760 slots
GRAPH_ENGINE_RUNS = (("select", "packed8"), ("select", "slim"),
                     ("ring", "packed8"))
#: the emitter frame's kernel functions, as a trace names them
EMITTER_FRAME_FUNCTIONS = ("emitter_spawn", "physics_step_kernel",
                           "emitter_tail")


def phase_graphs_engine(dev):
    """14 (emitter): ``PackedEngine`` at 10,485,760 slots from an
    all-alive state, select/packed8, select/slim and ring/packed8:
    ``step_many(64)`` then ``(56)`` through the frame graph (the emitter
    frame's kernels) against 120 eager frames (``PackedEngine._frame``,
    the plain versions around the physics kernel) from the same state:
    every tensor of the state bit-identical; ms a frame of each, the
    host's microseconds a replay, kernels and copies/sets a frame in a
    trace of replays (each of the frame's kernels once a frame) and the
    busy share.  Returns select/packed8's numbers."""
    import torch
    from particlesystem_tpu_torch.runtime.engine import PackedEngine

    cfg = bench_scene(EMIT_SLOTS)
    init = full_packed(EMIT_SLOTS, 27)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    frames = sum(GRAPH_ENGINE_STEPS)
    out = {}
    for alloc, layout in GRAPH_ENGINE_RUNS:
        eng = PackedEngine(cfg, alloc=alloc, layout=layout, device=dev)
        kernels = tuple(engine_frames(alloc, 1))
        base = launched()
        es = eng.init(init)
        ms = []
        for k in GRAPH_ENGINE_STEPS:
            start.record()
            es = eng.step_many(es, k)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end) / k)
        counted = graph_launch_checks(eng.graphs, False, frames, kernels,
                                      base)
        base = launched()
        ref = eng.init(init)
        eager_ms = []
        for k in GRAPH_ENGINE_STEPS:
            start.record()
            for _ in range(k):
                ref = eng._frame(ref)
            end.record()
            torch.cuda.synchronize()
            eager_ms.append(start.elapsed_time(end) / k)
        # the eager frame: the plain versions around the physics kernel
        launched(base, dict(ps_physics_step=frames, ps_flat_fields=frames))
        assert ref.frame == es.frame == frames
        for i, (a, b) in enumerate(zip(es.tensors(), ref.tensors(),
                                       strict=True)):
            assert torch.equal(a, b), \
                f"engine {alloc}/{layout}: graph vs eager, tensor {i}"
        n_alive = int(eng.alive_count(es))
        del ref

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        es = eng.step_many(es, GRAPH_ENGINE_STEPS[0])
        host_us = (time.perf_counter() - t0) * 1e6 / GRAPH_ENGINE_STEPS[0]
        torch.cuda.synchronize()
        expect = EMITTER_FRAME_FUNCTIONS + (
            ("emitter_ring",) if alloc == "ring" else ())
        trace = trace_frames(lambda: eng.step_many(es, 1),
                             GRAPH_TRACE_FRAMES, expect)
        print(f"phase 14: engine {EMIT_SLOTS} slots {alloc}/{layout}: "
              f"step_many({GRAPH_ENGINE_STEPS[0]}) and "
              f"({GRAPH_ENGINE_STEPS[1]}) through the frame graph == "
              f"{frames} eager frames: every tensor of the state "
              f"bit-identical (alive {n_alive}); {counted}")
        print(f"phase 14: engine {alloc}/{layout} ms a frame: graphs "
              f"{ms[1]:.4f} over step_many({GRAPH_ENGINE_STEPS[1]}) "
              f"({ms[0]:.4f} over ({GRAPH_ENGINE_STEPS[0]}), with the "
              f"warm-up and capture), eager {eager_ms[1]:.4f} "
              f"({eager_ms[0]:.4f}); the host's microseconds a frame "
              f"{host_us:.1f} a replay; a trace of {GRAPH_TRACE_FRAMES} "
              f"replays: {trace['kernels']:.1f} kernels and "
              f"{trace['moves']:.1f} copies/sets a frame, "
              f"{trace['device_ms']:.4f} ms of device time in "
              f"{trace['wall_ms']:.4f} ms a frame, device busy "
              f"{trace['busy']:.1%}; microseconds a frame: "
              + "; ".join(f"{name[:40]} {us / GRAPH_TRACE_FRAMES:.2f}"
                          for name, (_, us) in trace["sums"].items()))
        out[(alloc, layout)] = dict(ms=ms[1], eager_ms=eager_ms[1],
                                    host_us=host_us, **trace)
        del es, eng
        torch.cuda.empty_cache()
    return out[GRAPH_ENGINE_RUNS[0]]


# ---------------------------------------------------------------------------
# phase 15: the n-body frame's kernels A-E
# ---------------------------------------------------------------------------

#: frames of phase 15's kernel frames against the plain frames
FRAME_HOLD_FRAMES = 20
#: phase 15's slab rank: 4 ranks of 4 planes; halo buffers that hold a
#: plane of the full-width fill (~65,536 particles) and leave the pass
#: off the pair kernel's 512-row blocks
SLAB_RANKS, SLAB_HALO = 4, 70_000
#: each frame kernel's XLA counterpart in the JAX package (there is no
#: Pallas kernel there), by file and line
FRAME_REPLACES = dict(
    nbody_cells="particlesystem_tpu/ops/grid.py:49",
    cell_starts="particlesystem_tpu/ops/neighbor_blocks.py:178",
    block_prepare="particlesystem_tpu/ops/neighbor_blocks.py:118",
    nbody_lifecycle="particlesystem_tpu/models/nbody.py:117",
    nbody_spawn="particlesystem_tpu/models/nbody.py:161")


def nbody_10m_cfg():
    """The bench's 10M stage: 10,485,760 particles on 32^3."""
    from particlesystem_tpu_torch import GridSpec, NBodyConfig
    return NBodyConfig(n_fill=10 << 20, grid=GridSpec(grid_dim=32))


def pos_sectors(alive) -> int:
    """32-byte sectors of an (N, 3) float32 position tensor that hold an
    alive slot's coordinates (a slot's 12 bytes lie in one or two)."""
    import torch
    first = torch.nonzero(alive).squeeze(1) * 12
    return int(torch.unique(torch.cat([first // 32,
                                       (first + 11) // 32])).numel())


def frame_kernel_bytes(cfg, st, tiles, k: int) -> dict:
    """{kernel: the bytes it must move} on the state ``st``: each input
    read once, each output written once (``ops/frame_kernels.py``'s
    shapes; D in place, its tags not written).  A's and E's depend on the
    data: A without records reads the alive flag of every slot and the
    positions of the alive ones only, counted by the 32-byte sectors that
    hold them; E D's tile counts, the flags of the tiles (of D's 256
    slots) that hold ranks below ``k`` and the ``k`` children's reads and
    writes, none of its design's scratch (status words, tables).  The
    ``_records`` route: A reads every slot's pos, age, w and tag and writes
    its record, C reads one record a row where it otherwise gathers the
    row's pos, age, w and tag."""
    import torch
    from particlesystem_tpu_torch.ops import frame_kernels as fk
    from particlesystem_tpu_torch.ops import neighbor_blocks as nbk
    n = st.slots
    nc, nt = cfg.grid.num_cells, tiles.shape[0]
    before = torch.cumsum(tiles, 0) - tiles
    holds = ((before < k) & (tiles > 0)).any(dim=1)
    slots = torch.full((nt,), fk.TILE, device=tiles.device)
    slots[-1] = n - fk.TILE * (nt - 1)
    ranked = int(slots[holds].sum())
    starts = 4 * (nc + 2)
    stats = 8 * (len(fk.STATS) + cfg.grid.num_chunks)
    table = 16 * (n // nbk.B) * nbk.C_MAX
    # skey and order in; f, i, inv, overflow out; the starts, the chunk
    # table, the statistics
    c_rows = (4 + 8 + 41) * n + starts + table + stats
    return dict(
        # alive in, the key out; pos of the alive slots
        nbody_cells=(1 + 4) * n + 32 * pos_sectors(st.alive),
        # alive, pos, age, w, tag in; the key and the record out
        nbody_cells_records=(1 + 12 + 4 + 4 + 8 + 4 + 4 * fk.RECORD) * n,
        cell_starts=4 * n + starts,
        block_prepare=c_rows + fk.GATHERED * n,
        block_prepare_records=c_rows + 4 * fk.RECORD * n,
        # inv, acc_s, gmax_s, overflow_s, the state, uvec in; the state,
        # flags out; the tile counts
        nbody_lifecycle=(79 + 51) * n + 8 * nt + stats,
        # the tile counts in, the flags of the tiles that hold ranks below
        # k; a child's parent (pos, vel, fert, tag) in and its row out; the
        # three statistics
        nbody_spawn=8 * nt + ranked + (36 + 58) * k + 8 * 3)


def frame_kernel_calls(cfg, st, frame):
    """{kernel: (kernel thunk, plain thunk)} of A-E on the inputs one
    frame of ``st`` gives them (D and E into a scratch state, so that each
    call repeats), A and C without records and with them (``_records``),
    the stats buffers reused; and the inputs."""
    import torch
    from particlesystem_tpu_torch.models import nbody
    from particlesystem_tpu_torch.ops import frame_kernels as fk
    from particlesystem_tpu_torch.ops import neighbor_blocks as nbk
    grid = cfg.grid
    nc = grid.num_cells
    s = [fk.new_stats(st.device, grid.num_chunks) for _ in range(2)]
    uvec, fert = nbody.frame_fields(cfg, frame, st.tag)
    a_args = (st.pos, st.alive, st.age, st.w, st.tag, grid)
    key, rec = fk.nbody_cells_cuda(*a_args)
    skey, order = torch.sort(key, stable=True)
    starts = fk.cell_starts_cuda(skey, nc)
    c_args = (skey, order, starts, cfg)
    c_tail = (nbk.C_MAX, nbk.CH, nbk.B)
    fields = fk.Fields(st.pos, st.age, st.w, st.tag)
    snap, chunks, inv, ovf = fk.block_prepare_cuda(rec, *c_args, s[0],
                                                   *c_tail, grid=grid)
    acc_s, gmax_s = nbk.kernel_call(cfg, snap, chunks)
    scratch = [st.map(torch.empty_like) for _ in range(2)]
    d_args = (acc_s, gmax_s, ovf, inv, uvec, cfg)
    flags, tiles = fk.nbody_lifecycle_cuda(st, scratch[0], *d_args, s[0])
    fk.nbody_lifecycle_plain(st, scratch[1], *d_args, s[1])
    c_calls = lambda rows: (
        lambda: fk.block_prepare_cuda(rows, *c_args, s[0], *c_tail,
                                      grid=grid),
        lambda: fk.block_prepare_plain(rows, *c_args, s[1], *c_tail,
                                       grid=grid))
    calls = dict(
        nbody_cells=(lambda: fk.nbody_cells_cuda(*a_args, records=False),
                     lambda: fk.nbody_cells_plain(*a_args, records=False)),
        nbody_cells_records=(lambda: fk.nbody_cells_cuda(*a_args),
                             lambda: fk.nbody_cells_plain(*a_args)),
        cell_starts=(lambda: fk.cell_starts_cuda(skey, nc),
                     lambda: fk.cell_starts_plain(skey, nc)),
        block_prepare=c_calls(fields),
        block_prepare_records=c_calls(rec),
        nbody_lifecycle=(
            lambda: fk.nbody_lifecycle_cuda(st, scratch[0], *d_args, s[0]),
            lambda: fk.nbody_lifecycle_plain(st, scratch[1], *d_args, s[1])),
        nbody_spawn=(
            lambda: fk.nbody_spawn_cuda(scratch[0], fert, frame, flags, tiles,
                                        cfg, s[0]),
            lambda: fk.nbody_spawn_plain(scratch[1], fert, frame, flags,
                                         tiles, cfg, s[1])))
    library = dict(cell_starts=lambda: torch.searchsorted(
        skey, torch.arange(nc + 2, dtype=torch.int32, device=st.device),
        out_int32=True))
    return calls, library, tiles


def time_frame_kernels(cfg, st, frame, label: str) -> dict:
    """A-E (A and C with records and without) on one frame of ``st``: each
    kernel through its wrapper, in a CUDA graph and in a graph with the L2
    cleared, timed (plain, kernel, kernel, plain) beside its plain version,
    its bound (bytes) and, for B, ``torch.searchsorted``; then A + C of
    each route against their summed bound.  Returns {kernel: row of the
    kernels line}, A's and C's of the route the frame takes at this size
    (``frame_kernels.records_pay``)."""
    from particlesystem_tpu_torch.ops import frame_kernels as fk
    calls, library, tiles = frame_kernel_calls(cfg, st, frame)
    k = _spawned(cfg, st, frame)
    work = frame_kernel_bytes(cfg, st, tiles, k)
    floor = graph_ms(empty_kernel(st.device), 50)
    rows = {}
    for name, (kern, plain) in calls.items():
        p1 = cuda_ms(plain, 3)
        k1 = cuda_ms(kern, 50)
        k2 = cuda_ms(kern, 50)
        p2 = cuda_ms(plain, 3)
        in_graph = graph_ms(kern, 50)
        cold = cold_graph_ms(kern, 20)
        lib = library.get(name)
        lib_ms = None if lib is None else min(cuda_ms(lib, 50),
                                              cuda_ms(lib, 50))
        bound, by = bound_ms(0, work[name])
        rows[name] = dict(ms=min(k1, k2), graph_ms=in_graph, cold_ms=cold,
                          plain_ms=min(p1, p2), bound_ms=bound, bound_by=by,
                          library_ms=lib_ms, bytes=work[name])
        print(f"phase 15: {label}: {name}: kernel {k1:.5f} / {k2:.5f} ms "
              f"through the wrapper, {in_graph:.5f} ms in a CUDA graph, "
              f"{cold:.5f} ms in a graph with the L2 cleared before each "
              f"launch; plain {p1:.4f} / {p2:.4f} ms (plain, kernel, kernel, "
              f"plain); {work[name]} bytes: bound {bound:.5f} ms ({by}), "
              f"{bound / min(k1, k2):.1%} of it through the wrapper, "
              f"{bound / in_graph:.1%} in the graph, {bound / cold:.1%} "
              f"with the L2 cleared"
              + ("" if lib_ms is None else
                 f"; torch.searchsorted {lib_ms:.5f} ms")
              + (f"; one empty kernel {floor:.5f} ms in a CUDA graph"
                 if name == "nbody_spawn" else ""))
    records = fk.records_pay(st.slots, st.device)
    for route in ("", "_records"):
        a, c = rows["nbody_cells" + route], rows["block_prepare" + route]
        print(f"phase 15: {label}: A + C "
              f"{'with' if route else 'without'} records "
              f"{a['graph_ms'] + c['graph_ms']:.5f} ms in a graph, "
              f"{a['cold_ms'] + c['cold_ms']:.5f} with the L2 cleared, "
              f"against their summed bound "
              f"{a['bound_ms'] + c['bound_ms']:.5f} ms "
              f"({a['bytes'] + c['bytes']} bytes)"
              + ("; the frame's route at this size"
                 if bool(route) == records else ""))
    if records:
        for k in ("nbody_cells", "block_prepare"):
            rows[k] = rows.pop(k + "_records")
    return rows


#: bytes read between two launches of a reading with the L2 cleared:
#: twice the H100's 50 MB L2
L2_CLEAR_BYTES = 100 << 20


def empty_kernel(dev):
    """A thunk that launches one empty kernel (``ps_empty``) on ``dev``:
    a launch's floor."""
    from particlesystem_tpu_torch.utils.cuda_build import launch
    return lambda: launch("ps_empty", dev)


def spawn_split(cfg, st, frame, label: str, reps: int = 5) -> dict:
    """E through its wrapper on the inputs one frame of ``st`` gives it,
    traced ``reps`` times: each kernel's and memset's microseconds a call
    (E's launches, whatever its design; a trace that lacks a launch of
    ``spawn_rank`` or ``spawn_write``, which the three-kernel design ran
    too, is taken again).  Returns the trace's sums."""
    calls, _, _ = frame_kernel_calls(cfg, st, frame)
    trace = trace_frames(calls["nbody_spawn"][0], reps,
                         expect=("spawn_rank", "spawn_write"))
    print(f"phase 15: {label}: E by launch, a trace of {reps} calls "
          f"through the wrapper: " + "; ".join(
              f"{name[:40]} x{n / reps:g} {us / reps:.2f} us"
              for name, (n, us) in trace["sums"].items())
          + f"; {trace['device_ms'] * 1e3:.2f} us of device time a call in "
          f"{trace['kernels']:g} kernels and {trace['moves']:g} copies/sets")
    return trace["sums"]


def cold_graph_ms(fn, reps: int) -> float:
    """Milliseconds of ``fn``'s device work with its inputs out of the L2:
    a CUDA graph of ``reps`` times (a read of :data:`L2_CLEAR_BYTES`, then
    ``fn``), less a graph of the reads alone, per launch."""
    import torch
    buf = torch.ones((L2_CLEAR_BYTES // 4,), device="cuda")
    clear = lambda: buf.amax()
    both = graph_ms(lambda: (clear(), fn()), reps)
    return both - graph_ms(clear, reps)


def _spawned(cfg, st, frame) -> int:
    """The children one frame of ``st`` spawns (a plain frame's count)."""
    from particlesystem_tpu_torch.models import nbody
    return int(nbody.step(st, frame, cfg)[1].n_spawned)


def phase_frame_kernels(dev, plateau_state, plateau_frame: int):
    """15: the frame kernels A-E (``csrc/nbody_frame.cu``).  (a) Each
    against its plain version on the same inputs, bit for bit (every
    field, record, mask, tag, flag, tile count and statistic; A and C
    with records and without; D and E into a fresh state and in place): at
    full width (``NBodyConfig()``'s 2,097,152 slots, frame 0), on phase
    4's plateau prefix, on the 10M
    stage's 20,971,520 rows on 32^3 (frame 0), and on the edge states of
    ``tools/frame_states.py`` (a spawn burst past the budget, no free
    slot, the edge tags in contact and exploding, overflow rows beside
    all-dead blocks, a 2-chunk budget, the frame as a 0-dim tensor); B and
    C also on the decomposed step's inputs (a non-cubic grid, ids, -1
    padding).  (b) 20 frames of ``nbody.step`` (the kernels) against 20
    frames of ``frame_states.plain_frame`` (the plain versions), at full
    width: every field and statistic bit for bit.  (c) Each kernel (A and
    C with records and without) timed on the plateau prefix and at 10M
    beside its bound.  Returns the rows of the kernels line (A-E, A and C
    of the route the frame takes at the prefix) and the largest
    difference (0)."""
    import torch
    from particlesystem_tpu_torch import NBodyConfig
    from particlesystem_tpu_torch.models import nbody
    from particlesystem_tpu_torch.tools import frame_states as fs

    t0 = time.perf_counter()
    cfg = NBodyConfig()
    frame_t = torch.tensor(plateau_frame, dtype=torch.int64, device=dev)
    for label, c, st, frame in (
            (f"full width {cfg.slots} slots, frame 0", cfg,
             nbody.init_fill(cfg, dev), 0),
            (f"plateau prefix {plateau_state.slots} rows, frame "
             f"{plateau_frame}", cfg, plateau_state, frame_t),
            (f"10M stage {nbody_10m_cfg().slots} rows on 32^3, frame 0",
             nbody_10m_cfg(), None, 0)):
        if st is None:
            st = nbody.init_fill(c, dev)
        stats = fs.hold_kernels(c, st, frame)
        del st
        torch.cuda.empty_cache()
        print(f"phase 15: {label}: A-E == plain bit for bit (D and E also "
              f"in place, E again after other inputs, D + E under two "
              f"graph replays); stats {stats}")
    for case in fs.edge_states(dev):
        stats = fs.hold_kernels(case.cfg, case.state, case.frame, case.c_max)
        print(f"phase 15: edge state {case.name}: A-E == plain bit for bit; "
              f"stats {stats}")
        want = dict(burst="n_spawned", full="n_spawn_capped",
                    tags="n_collision_kills", cmax2="n_listed_dropped",
                    overflow="n_overflow_kills", kedge="n_spawned",
                    lasttile="n_spawned")[case.name]
        assert stats[want] > 0, f"edge state {case.name}: no {want}"
    dcfg, args, dims, ids = fs.dims_case(dev)
    stats = fs.hold_prepare(dcfg, args, dims, ids)
    print(f"phase 15: dims {dims} with ids and {int((ids == -1).sum())} "
          f"padding rows: B and C == plain bit for bit; stats {stats}")
    case = fs.slab_case(cfg, nbody.init_fill(cfg, dev), SLAB_RANKS, 1,
                        SLAB_HALO, 0)
    stats = fs.hold_slab(case)
    print(f"phase 15: rank 1 of a slab of {SLAB_RANKS} at full width, "
          f"frame 0, dims {case.dims}, halo buffers of {SLAB_HALO} rows: "
          f"D over the pass's {stats.pop('rows')} rows for its "
          f"{stats.pop('slots')} slots == plain bit for bit, then E, and "
          f"nbody_sharded.blocks_lifecycle in place; stats {stats}")
    del case
    frames = fs.hold_frames(cfg, FRAME_HOLD_FRAMES, dev)
    print(f"phase 15: {FRAME_HOLD_FRAMES} frames of nbody.step (the "
          f"kernels) == {FRAME_HOLD_FRAMES} frames composed of the plain "
          f"versions at {cfg.slots} slots, every field and stat bit for "
          f"bit; frame 0 {frames[0]}, frame {FRAME_HOLD_FRAMES - 1} "
          f"{frames[-1]}")
    rows = time_frame_kernels(cfg, plateau_state, frame_t,
                              f"plateau prefix {plateau_state.slots} rows")
    rows = {k: rows[k] for k in FRAME_KERNELS}
    big = nbody.init_fill(nbody_10m_cfg(), dev)
    time_frame_kernels(nbody_10m_cfg(), big, 0,
                       f"10M stage {big.slots} rows, frame 0")
    spawn_split(nbody_10m_cfg(), big, 0, f"10M stage {big.slots} rows, "
                f"frame 0")
    del big
    trace_10m(dev)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")
    return rows, 0.0


def trace_10m(dev, frames: int = 2, top: int = 12):
    """The 10M stage's frame at its plateau prefix, as the bench runs it
    (3 frames one by one, then a batch of 4 through the prefix's graph):
    a trace of ``frames`` replays, the largest kernels' sums."""
    from particlesystem_tpu_torch.api import NBodySimulation
    sim = NBodySimulation(nbody_10m_cfg(), device=dev)
    sim.run(3, batch=1)
    sim.run(4, batch=4)
    key = sim._key()
    fn = lambda: sim._loop_frame(sim._active, sim._width)
    trace = trace_frames(lambda: sim.graphs.step(key, fn), frames,
                         NBODY_FRAME_FUNCTIONS)
    largest = sorted(trace["sums"].items(), key=lambda kv: -kv[1][1])[:top]
    print(f"phase 15: 10M stage, frames {sim.frame + 1}-{sim.frame + frames} "
          f"replayed on the prefix {sim._active or sim.cfg.slots} of "
          f"{sim.cfg.slots} slots (alive {int(sim.last_stats.n_alive)}): "
          f"{trace['device_ms']:.4f} ms of device time in "
          f"{trace['wall_ms']:.4f} ms a frame, {trace['kernels']:.1f} "
          f"kernels and {trace['moves']:.1f} copies/sets; microseconds a "
          f"frame: " + "; ".join(f"{name[:40]} {us / frames:.1f}"
                                 for name, (_, us) in largest))


# ---------------------------------------------------------------------------
# phase 16: the emitter frame's kernels
# ---------------------------------------------------------------------------

#: each emitter frame kernel's XLA counterpart in the JAX package (no Pallas kernel there)
EMITTER_REPLACES = dict(
    emitter_spawn="particlesystem_tpu/models/emitter.py:68",
    emitter_ring="particlesystem_tpu/ops/fused_step.py:181",
    emitter_tail="particlesystem_tpu/runtime/engine.py:186")
#: frames and salts of the spawn window's checks (2^31 - 1: the last frame
#: of JAX's int32 frame, whose float32 rounds up in slim's death frame)
SPAWN_FRAMES = (0, 1, 2 ** 31 - 1)
SPAWN_SALTS = (0, 3)
#: the whole frames phase 16 holds: (alloc, layout, slots); the small ring
#: wraps within the frames (1,669 rows a frame into 65,536 slots)
FRAME_RUNS = (("select", "packed8", 1 << 20), ("select", "slim", 1 << 20),
              ("strided", "packed8", 1 << 20), ("ring", "packed8", 1 << 20),
              ("ring", "packed8", 1 << 16))
FRAME_RUN_FRAMES = 120
#: float32 operations of one spawn row besides its hashes, pow, sin and
#: cos: accum (3), r and pos (7), theta and its root (2), phi (1), the
#: direction (15), speed (5), vel (3), life (2), slim's death (2)
SPAWN_ROW_FLOPS = 40


def three_emitter_scene(capacity: int):
    """Three emitters whose budgets (168 + 118 + 52 = 338 rows) are no
    multiple of a warp, with unequal cones, jitters and radii."""
    from particlesystem_tpu_torch import (Emitter, EmitterSceneConfig,
                                          PlaneCollider)
    return EmitterSceneConfig(
        capacity=capacity, dt=1.0 / 60.0, gravity=(0.0, -9.8, 0.0),
        emitters=(
            Emitter(pos=(0.0, 1.0, 0.0), speed=6.0, rate=10_000.0,
                    cone_angle=1.1, speed_jitter=0.4, radius=0.2),
            Emitter(pos=(2.0, 0.5, -1.0), direction=(1.0, 0.2, 0.0),
                    speed=3.0, rate=7_000.0, cone_angle=0.05,
                    speed_jitter=0.0, radius=1.5, life_min=0.5,
                    life_max=0.75),
            Emitter(pos=(-1.0, 2.0, 3.0), direction=(0.0, -1.0, 0.3),
                    speed=12.0, rate=3_001.0, cone_angle=2.5,
                    speed_jitter=0.9, radius=0.0)),
        planes=(PlaneCollider(),), seed=7)


def spawn_scenes():
    """(name, scene) of the spawn window's checks: the bench scene at 1M
    and 10M, the entry scene, three emitters, none."""
    from particlesystem_tpu_torch import EmitterSceneConfig
    from particlesystem_tpu_torch.entry import entry_scene
    return (("bench 1M", bench_scene(1 << 20)),
            ("bench 10M", bench_scene(EMIT_SLOTS)),
            ("entry", entry_scene()),
            ("three emitters", three_emitter_scene(1 << 16)),
            ("no emitter", EmitterSceneConfig(capacity=1 << 16, seed=3)))


def spawn_inputs(cfg, n_fields: int, dev, seed: int):
    """(table, accum, window width, a fresh window) for ``cfg``: accum
    from ``seed`` in [0, 1), with 0 and the float just below 1."""
    import numpy as np
    import torch
    from particlesystem_tpu_torch.models import emitter as em
    from particlesystem_tpu_torch.ops import engine_kernels as ek
    from particlesystem_tpu_torch.runtime.engine import PackedEngine
    table = em.SpawnTable(cfg, dev)
    n = max(1, len(cfg.emitters))
    acc = np.random.default_rng(seed).uniform(0.0, 1.0, n).astype(np.float32)
    acc[0] = 0.0
    acc[-1] = np.nextafter(np.float32(1.0), np.float32(0.0))
    w = PackedEngine(cfg, alloc="ring", device=dev).spawn_width
    return (table, torch.tensor(acc, device=dev), w,
            ek.new_window(n_fields, w, n, dev))


def hold_window(got, want, what) -> float:
    """A window against the plain version's, bit for bit: every field of
    the rows, valid and the next accum; names the fields that differ."""
    import torch
    rows, valid, acc = (t.cpu() for t in got)
    wrows, wvalid, wacc = (t.cpu() for t in want)
    bad = [f"field {i} ({int((a.view(torch.int32) != b.view(torch.int32)).sum())} rows)"
           for i, (a, b) in enumerate(zip(rows, wrows))
           if not torch.equal(a.view(torch.int32), b.view(torch.int32))]
    if not torch.equal(valid, wvalid):
        bad.append(f"valid ({int((valid != wvalid).sum())} rows)")
    if not torch.equal(acc.view(torch.int32), wacc.view(torch.int32)):
        bad.append("accum")
    assert not bad, f"{what}: kernel and plain version differ in " + \
        ", ".join(bad)
    return max(float((rows - wrows).abs().max()),
               float((acc - wacc).abs().max()))


def hold_spawn(dev) -> tuple:
    """The spawn kernel against its plain version on the card, bit for
    bit, for every scene of :func:`spawn_scenes`, packed8 and slim, frames
    :data:`SPAWN_FRAMES` (read from device memory), salts
    :data:`SPAWN_SALTS`.  Returns (cases, largest difference)."""
    import torch
    from particlesystem_tpu_torch.ops import engine_kernels as ek
    cases, err = 0, 0.0
    for k, (name, cfg) in enumerate(spawn_scenes()):
        for nf in (8, 7):
            table, accum, w, out = spawn_inputs(cfg, nf, dev, 40 + k)
            for frame in SPAWN_FRAMES:
                frame_t = torch.tensor(frame, dtype=torch.int64, device=dev)
                for salt in SPAWN_SALTS:
                    want = ek.spawn_window_plain(cfg, table, accum, frame_t,
                                                 salt, nf, w)
                    got = ek.spawn_window_cuda(cfg, table, accum, frame_t,
                                               salt, out)
                    err = max(err, hold_window(
                        got, want, f"spawn window, {name}, "
                        f"{'slim' if nf == 7 else 'packed8'}, frame {frame}, "
                        f"salt {salt}"))
                    cases += 1
        print(f"phase 16: spawn window, {name} ({table.total} rows, "
              f"{len(cfg.emitters)} emitters, window {w}): packed8 and slim, "
              f"frames {SPAWN_FRAMES}, salts {SPAWN_SALTS}: rows, valid and "
              f"accum kernel == plain bit for bit")
    return cases, err


def ring_inputs(n_real: int, w: int, n_valid: int, cursor: int, dev,
                seed: int):
    """Random ring fields (n_real + w slots, 8 fields), a window of
    ``n_valid`` valid rows scattered over ``w`` and the cursor."""
    import torch
    gen = torch.Generator(device="cpu").manual_seed(seed)
    fields = [torch.rand((n_real + w,), generator=gen).to(dev)
              for _ in range(8)]
    rows = (torch.rand((8, w), generator=gen) * 4.0 - 1.0).to(dev)
    valid = torch.zeros((w,), dtype=torch.bool)
    valid[torch.randperm(w, generator=gen)[:n_valid]] = True
    return (fields, rows, valid.to(dev),
            torch.tensor(cursor, dtype=torch.int32, device=dev))


def ring_cases(n_real: int, w: int):
    """(name, n_valid, cursor) of the ring checks: a cursor at 0, one in
    the middle and one where the write wraps, with none, some and all
    rows valid."""
    some = w * 4 // 5 + 3
    return [(f"cursor {c}, {nv} valid", nv, c)
            for c in (0, n_real // 2, n_real - some // 2)
            for nv in (0, some, w)]


def hold_ring(dev, n_real: int = 1 << 20, w: int = 2048) -> tuple:
    """The ring kernel against ``fused_step.ring_spawn`` on the card, bit
    for bit (every field, shadow included, and the cursor)."""
    import torch
    from particlesystem_tpu_torch.ops import engine_kernels as ek
    err = 0.0
    cases = ring_cases(n_real, w)
    for k, (name, nv, c) in enumerate(cases):
        fields, rows, valid, cursor = ring_inputs(n_real, w, nv, c, dev,
                                                  50 + k)
        want_f = [f.clone() for f in fields]
        want_c = cursor.clone()
        ek.ring_write_plain(want_f, rows, valid, want_c, n_real)
        ek.ring_write_cuda(fields, rows, valid, cursor, n_real)
        err = max(err, same_bits(fields + [cursor.view(torch.float32)],
                                 want_f + [want_c.view(torch.float32)],
                                 f"ring write, {name}"))
    print(f"phase 16: ring write at {n_real} slots + a shadow of {w}: "
          + "; ".join(n for n, _, _ in cases)
          + ": every field and the cursor kernel == plain bit for bit")
    return len(cases), err


def hold_tail(dev) -> tuple:
    """The tail kernel against its plain version, bit for bit: accum,
    cursor and frame, with the cursor advanced (and wrapping) and not."""
    import torch
    from particlesystem_tpu_torch.ops import engine_kernels as ek
    gen = torch.Generator(device="cpu").manual_seed(60)
    cases = 0
    for n_acc, cursor, advance, slots, frame in (
            (2, 0, 2048, 1 << 20, 0), (3, (1 << 20) - 2048, 2048, 1 << 20, 7),
            (1, 5, 0, 1 << 16, 2 ** 31 - 1), (200, 1024, 1024, 4096, 12)):
        bufs = [torch.rand((n_acc,), generator=gen).to(dev),
                torch.rand((n_acc,), generator=gen).to(dev),
                torch.tensor(cursor, dtype=torch.int32, device=dev),
                torch.tensor(frame, dtype=torch.int64, device=dev)]
        want = [b.clone() for b in bufs]
        ek.frame_tail_plain(*want, advance, slots)
        ek.frame_tail_cuda(*bufs, advance, slots)
        for a, b, name in zip(bufs, want, ("accum", "next", "cursor",
                                           "frame")):
            assert torch.equal(a, b), f"tail: {name} differs"
        cases += 1
    print(f"phase 16: frame tail, {cases} cases (the cursor advanced, "
          f"wrapping and not; 200 emitters): accum, cursor and frame "
          f"kernel == plain bit for bit")
    return cases, 0.0


def hold_engine_frames(dev) -> None:
    """:data:`FRAME_RUNS`: ``step_many`` through the frame graph (the
    kernels) against as many eager ``_frame`` calls (the plain versions),
    every tensor of the state bit for bit, from an all-alive state; each
    replay launches the spawn, physics and tail kernels (and ring's) once
    and records nothing else."""
    import torch
    from particlesystem_tpu_torch.runtime.engine import PackedEngine
    for alloc, layout, slots in FRAME_RUNS:
        cfg = bench_scene(slots)
        init = full_packed(slots, 61)
        eng = PackedEngine(cfg, alloc=alloc, layout=layout, device=dev)
        base = launched()
        es = eng.step_many(eng.init(init), FRAME_RUN_FRAMES)
        counted = graph_launch_checks(eng.graphs, False, FRAME_RUN_FRAMES,
                                      tuple(engine_frames(alloc, 1)), base)
        ref = eng.init(init)
        for _ in range(FRAME_RUN_FRAMES):
            ref = eng._frame(ref, eng.salt)
        assert ref.frame == es.frame == FRAME_RUN_FRAMES
        for i, (a, b) in enumerate(zip(es.tensors(), ref.tensors(),
                                       strict=True)):
            assert torch.equal(a, b), \
                f"{alloc}/{layout} {slots}: graph vs eager, tensor {i}"
        print(f"phase 16: engine {slots} slots {alloc}/{layout}: "
              f"step_many({FRAME_RUN_FRAMES}) through the frame graph == "
              f"{FRAME_RUN_FRAMES} eager plain frames, every tensor of the "
              f"state bit for bit (cursor {int(es.cursor)}, alive "
              f"{int(eng.alive_count(es))}); {counted}")
        del es, ref, eng


def spawn_work(cfg, n_fields: int, w: int):
    """(bytes, hashes, float ops) of one spawn launch: the table (each
    column a row, the rates), the rows' emitter index, accum and the frame
    in; the window, valid and the next accum out.  8 hashes a row and 3 a
    block for the keys; :data:`SPAWN_ROW_FLOPS` a row."""
    from particlesystem_tpu_torch.models import emitter as em
    total = em.SpawnTable(cfg, "cpu").total
    e = max(1, len(cfg.emitters))
    columns = sum(width for _, width in em.SpawnTable.COLUMNS)
    n_bytes = (4 * (columns * total + len(cfg.emitters)) + 4 * total
               + 4 * e + 8 + 4 * n_fields * w + w + 4 * e)
    return n_bytes, 8 * total + 3 * -(-w // 256), SPAWN_ROW_FLOPS * total


def spawn_bound(n_bytes: int, hashes: int, flops: int):
    """(least milliseconds, what bounds it): the bytes at the memory rate
    against the hashes' integer instructions and the float operations at
    the lane rate (pow, sin and cos not counted)."""
    return bound_ms(FLOPS_A_SLOT * (hashes * INT_OPS_PER_HASH + flops),
                    n_bytes)


def ring_work(n_fields: int, w: int, n_valid: int, cursor: int,
              n_real: int) -> int:
    """Bytes of one ring write: valid, the valid rows in and out, the
    cursor in and out; on a wrap the fold's copy and the shadow's zeros."""
    n_bytes = w + 2 * 4 * n_fields * n_valid + 8
    wrapped = cursor + n_valid - n_real
    if wrapped > 0:
        n_bytes += 4 * n_fields * (2 * min(wrapped, n_real) + w)
    return n_bytes


def time_emitter_kernel(name, kern, plain, bound, by, floor) -> dict:
    """Kernel against plain version timed (plain, kernel, kernel, plain)
    through the wrapper, in a CUDA graph and in a graph with the L2
    cleared, beside the bound and one empty kernel's time in a graph."""
    p1 = cuda_ms(plain, 3)
    k1 = cuda_ms(kern, 50)
    k2 = cuda_ms(kern, 50)
    p2 = cuda_ms(plain, 3)
    in_graph = graph_ms(kern, 50)
    cold = cold_graph_ms(kern, 20)
    print(f"phase 16: {name}: kernel {k1:.5f} / {k2:.5f} ms through the "
          f"wrapper, {in_graph:.5f} ms in a CUDA graph, {cold:.5f} ms in a "
          f"graph with the L2 cleared; plain {p1:.4f} / {p2:.4f} ms "
          f"(plain, kernel, kernel, plain); bound {bound:.7f} ms ({by}); "
          f"one empty kernel {floor:.5f} ms in a CUDA graph")
    return dict(ms=min(k1, k2), graph_ms=in_graph, cold_ms=cold,
                plain_ms=min(p1, p2), bound_ms=bound, bound_by=by,
                library_ms=None)


def time_emitter_kernels(dev) -> dict:
    """Each kernel on the inputs the bench scene's 10M frame gives it
    (select/packed8 for spawn and tail; ring/packed8 at 10M for the ring
    write, the window of a frame that does not wrap), the plain versions
    on the same inputs.  Returns {kernel: row of the kernels line}."""
    import torch
    from particlesystem_tpu_torch.ops import engine_kernels as ek
    cfg = bench_scene(EMIT_SLOTS)
    floor = graph_ms(empty_kernel(dev), 50)
    table, accum, w, out = spawn_inputs(cfg, 8, dev, 62)
    frame_t = torch.tensor(20, dtype=torch.int64, device=dev)
    work = spawn_work(cfg, 8, w)
    rows = {"emitter_spawn": time_emitter_kernel(
        f"spawn window, bench scene, {table.total} rows in {w}",
        lambda: ek.spawn_window_cuda(cfg, table, accum, frame_t, 0, out),
        lambda: ek.spawn_window_plain(cfg, table, accum, frame_t, 0, 8, w),
        *spawn_bound(*work), floor)}
    print(f"phase 16: spawn window: {work[0]} bytes, {work[1]} hashes, "
          f"{work[2]} float operations")
    n_valid = int(out.valid.sum())
    # from the middle of the ring: the calls advance the cursor by
    # n_valid each and never reach the wrap
    fields, rows_w, valid, cursor = ring_inputs(EMIT_SLOTS, w, n_valid,
                                                EMIT_SLOTS // 2, dev, 63)
    n_bytes = ring_work(8, w, n_valid, EMIT_SLOTS // 2, EMIT_SLOTS)
    bound, by = bound_ms(0, n_bytes)
    rows["emitter_ring"] = time_emitter_kernel(
        f"ring write, {EMIT_SLOTS} slots, {n_valid} of {w} rows valid "
        f"({n_bytes} bytes)",
        lambda: ek.ring_write_cuda(fields, rows_w, valid, cursor, EMIT_SLOTS),
        lambda: ek.ring_write_plain(fields, rows_w, valid, cursor,
                                    EMIT_SLOTS),
        bound, by, floor)
    acc_next = out.accum.clone()
    cur = torch.zeros((), dtype=torch.int32, device=dev)
    n_bytes = 2 * 4 * accum.numel() + 8 + 16
    bound, by = bound_ms(0, n_bytes)
    rows["emitter_tail"] = time_emitter_kernel(
        f"frame tail ({n_bytes} bytes)",
        lambda: ek.frame_tail_cuda(accum, acc_next, cur, frame_t, w,
                                   EMIT_SLOTS),
        lambda: ek.frame_tail_plain(accum, acc_next, cur, frame_t, w,
                                    EMIT_SLOTS),
        bound, by, floor)
    return rows


def phase_emitter_kernels(dev) -> tuple:
    """16: the emitter frame's kernels (``csrc/emitter_frame.cu``, through
    ``ops/engine_kernels.py``).  (a) Each against its plain version on the
    card, bit for bit: the spawn window (rows, valid, next accum; slim's
    death frame among the rows) on the bench scene at 1M and 10M, the
    entry scene, three emitters and none, packed8 and slim, frames 0, 1
    and 2^31 - 1, salts 0 and 3; the ring write at three cursors with
    none, some and all rows valid; the tail.  (b) :data:`FRAME_RUNS`,
    120 frames of graph replays against 120 eager plain frames, bit for
    bit.  (c) Each kernel timed through its wrapper, in a CUDA graph and
    in a graph with the L2 cleared, beside its plain version, its bound
    and the launch floor.  Returns (rows of the kernels line, the largest
    difference)."""
    t0 = time.perf_counter()
    n_spawn, e1 = hold_spawn(dev)
    n_ring, e2 = hold_ring(dev)
    n_tail, e3 = hold_tail(dev)
    hold_engine_frames(dev)
    rows = time_emitter_kernels(dev)
    print(f"phase 16: {n_spawn} spawn windows, {n_ring} ring writes, "
          f"{n_tail} tails held; {time.perf_counter() - t0:.1f} s")
    return rows, max(e1, e2, e3)


#: phase 17: fresh full-size runs in one process, the card's reserved
#: memory read every FRESH_EVERY of them, and how far the last reading may
#: lie from the first
FRESH_RUNS = 1000
FRESH_EVERY = 100
FRESH_SLACK_BYTES = 64 << 20


def phase_fresh_runs(dev, runs: int = FRESH_RUNS, every: int = FRESH_EVERY):
    """17: the reference's own deployment in a loop: ``runs`` times
    ``NBodySimulation(NBodyConfig(seed=s)).run(10)`` at full size, each
    simulation dropped before the next is built (its fill, eager frame,
    capture, nine replays and compaction, then its frame graph freed).
    Every frame graph of the process shares one pool
    (``utils/frame_graph.shared_pool``), so the card's reserved memory,
    read every ``every`` runs, stays flat: passes when the last reading
    lies within :data:`FRESH_SLACK_BYTES` of the first (run ``every``'s)
    and the process made one pool."""
    import torch
    from particlesystem_tpu_torch import NBodyConfig
    from particlesystem_tpu_torch.api import NBodySimulation
    from particlesystem_tpu_torch.utils import frame_graph

    captures = frame_graph.counters["shared_captures"]
    readings = []
    t0 = time.perf_counter()
    for i in range(1, runs + 1):
        sim = NBodySimulation(NBodyConfig(seed=(1 << 32) + i), device=dev)
        sim.run(MAIN_ITERS)       # ends in the batch's readback
        del sim
        if i % every == 0:
            torch.cuda.synchronize(dev)
            readings.append(torch.cuda.memory_reserved(dev))
    ms = (time.perf_counter() - t0) * 1e3 / runs
    pools = frame_graph.counters["pools_created"]
    captured = frame_graph.counters["shared_captures"] - captures
    drift = readings[-1] - readings[0]
    print(f"phase 17: {runs} fresh runs of {MAIN_ITERS} frames, {ms:.3f} ms "
          f"a run, {captured} captures, pools made {pools}; reserved B at "
          f"runs {every}..{runs}: {readings}; last - first {drift} B")
    assert abs(drift) <= FRESH_SLACK_BYTES, readings
    assert pools == 1 and captured == runs, (pools, captured)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from particlesystem_tpu_torch.utils import cuda_build

    print(f"card: {card_line()}")
    print(f"torch device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    _, build_s, log = cuda_build.build()
    print(f"phase 1: kernel build {build_s:.2f} s")
    for line in log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill",
                                   "stack")):
            print(f"  ptxas: {line.strip()}")

    dev = torch.device("cuda", 0)
    worst = phase_kernel_vs_plain(dev)
    phase_card_vs_cpu(dev)
    sim, main_path = phase_main_path(dev)
    worst = max(worst, phase_pair_frames(dev, main_path["plateau_state"],
                                         main_path["plateau_frame"]))
    physics_err = phase_physics_vs_plain(dev)
    phase_engine_card_vs_cpu(dev)
    emitter = phase_emitter_main_path(dev)
    alu, affine = phase_probes(dev)
    phase_dense_vs_blocks(sim)
    phase_validate_checkpoint_profile(sim, dev)
    del sim
    phase_readback(dev)
    sharded = [phase_sharded_one_rank(dev)]
    sharded += phase_sharded_ranks(dev).values()
    phase_sharded_emitter(dev)
    _, bench_err = phase_bench(dev)
    phase_entry(dev)
    phase_cli_launcher(("cuda:0", "cpu"))
    phase_tools(dev)
    rng = phase_threefry(dev, main_path.pop("plateau_tags"))
    phase_graphs_nbody(dev, main_path["eager_kernels"])
    phase_graphs_dense(dev)
    phase_graphs_engine(dev)
    frame_rows, frame_err = phase_frame_kernels(
        dev, main_path.pop("plateau_state"), main_path["plateau_frame"])
    emitter_rows, emitter_err = phase_emitter_kernels(dev)
    phase_fresh_runs(dev)

    kernels = [{
        "name": "cluster_pair",
        "route": "cuda",
        "source": "particlesystem_tpu_torch/csrc/neighbor_blocks.cu",
        "replaces": "particlesystem_tpu/ops/neighbor_blocks.py:296",
        "launches": main_path["launches"],
        "max_abs_err": max([worst, main_path["err"], bench_err]
                           + [r["err"] for r in sharded]),
        "ms": main_path["plateau"]["ms"],
        "plain_ms": main_path["plateau"]["plain_ms"],
        "bound_ms": main_path["plateau"]["bound_ms"],
        "bound_by": main_path["plateau"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "physics_step",
        "route": "cuda",
        "source": "particlesystem_tpu_torch/csrc/physics_step.cu",
        "replaces": "particlesystem_tpu/ops/pallas_step.py:39",
        "launches": emitter["launches"],
        "max_abs_err": physics_err,
        "ms": emitter["ms"],
        "plain_ms": emitter["plain_ms"],
        "bound_ms": emitter["bound_ms"],
        "bound_by": emitter["bound_by"],
        "library_ms": None,
    }, {
        "name": "probe_alu_ops",
        "route": "cuda",
        "source": "particlesystem_tpu_torch/csrc/probe_alu_ops.cu",
        "replaces": "tools/probe_vpu_ops.py:60",
        "launches": alu["launches"],
        "max_abs_err": alu["err"],
        "ms": alu["ms"],
        "plain_ms": alu["plain_ms"],
        "bound_ms": alu["bound_ms"],
        "bound_by": alu["bound_by"],
        "library_ms": None,
    }, {
        "name": "probe_affine",
        "route": "cuda",
        "source": "particlesystem_tpu_torch/csrc/probe_affine.cu",
        "replaces": "tools/probe_same_pallas_two_sigs.py:43",
        "launches": affine["launches"],
        "max_abs_err": affine["err"],
        "ms": affine["ms"],
        "plain_ms": affine["plain_ms"],
        "bound_ms": affine["bound_ms"],
        "bound_by": affine["bound_by"],
        "library_ms": affine["library_ms"],
    }, {
        "name": "threefry_fields",
        "route": "cuda",
        "source": "particlesystem_tpu_torch/csrc/threefry.cu",
        # XLA's fused draw: the JAX package has no Pallas kernel here
        "replaces": "particlesystem_tpu/core/rng.py:53",
        "launches": main_path["rng_launches"] + emitter["rng_launches"],
        "max_abs_err": rng["err"],
        "ms": rng["ms"],
        "plain_ms": rng["plain_ms"],
        "bound_ms": rng["bound_ms"],
        "bound_by": rng["bound_by"],
        "library_ms": None,
    }, {
        "name": "nbody_fill",
        "route": "cuda",
        "source": "particlesystem_tpu_torch/csrc/threefry.cu",
        # XLA's fused draw and writes of the fill: no Pallas kernel there
        "replaces": "particlesystem_tpu/models/nbody.py:75",
        "launches": main_path["fill_launches"],
        "max_abs_err": rng["err"],
        "ms": rng["fill"]["ms"],
        "plain_ms": rng["fill"]["plain_ms"],
        "bound_ms": rng["fill"]["bound_ms"],
        "bound_by": rng["fill"]["bound_by"],
        "library_ms": None,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "particlesystem_tpu_torch/csrc/nbody_frame.cu",
        # XLA's fusions of the jitted frame: no Pallas kernel there
        "replaces": FRAME_REPLACES[name],
        "launches": main_path["frame_launches"][name],
        "max_abs_err": frame_err,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    } for name, row in frame_rows.items()] + [{
        "name": name,
        "route": "cuda",
        "source": "particlesystem_tpu_torch/csrc/emitter_frame.cu",
        # XLA's fusions of the jitted engine frame: no Pallas kernel there
        "replaces": EMITTER_REPLACES[name],
        "launches": emitter["emitter_launches"][name],
        "max_abs_err": emitter_err,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    } for name, row in emitter_rows.items()]
    assert all(k["launches"] > 0 for k in kernels), kernels
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
