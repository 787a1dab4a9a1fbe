#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``particlesystem_tpu_torch/csrc`` and
drives its main path, ``NBodySimulation(NBodyConfig(), device="cuda").run()``
at the reference's size (1,048,576 particles, 16^3 grid, 2,097,152 slots),
after checking the kernel against its plain PyTorch version and the port on
the card against the port on the CPU.  Imports nothing of JAX: the machine
with the card need not have it.

Phases (any failure raises and exits non-zero):

0. the card: ``nvidia-smi`` name and power limit, torch's device name;
1. build the kernel (nvcc, sm_90a) and print the build seconds;
2. kernel vs plain version on the card, on the prepared frame after two
   port frames of five small configs (three tile shapes, a 32-row/128-column
   tile, a 2-chunk budget that drops chunks): ``gmax`` exact, ``acc`` within
   1e-5 of max(1, max|acc|); ``prepare`` on the card equals ``prepare`` on
   the CPU;
3. 12 frames of the port on the card against the port on the CPU (plain
   version): every stat and the alive/parent masks exact, floats by the
   chaotic-trajectory rule of tests/test_nbody_parity.py;
4. the main path: ``run(10)`` twice at full size (the second call runs on
   the compacted active prefix), the kernel's launch count from those 20
   frames, ms/frame of the second call (CUDA events), peak device memory,
   then kernel vs plain version timed on 64 evenly spaced live blocks.

The last lines are one JSON object describing the kernel, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SUBSET_BLOCKS = 64
MAIN_ITERS = 10


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


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


def frame_inputs(cfg, state, **tiles):
    from particlesystem_tpu_torch.ops import neighbor_blocks as nbk
    from particlesystem_tpu_torch.ops.grid import coords_to_cell, wrap_positions
    cell = coords_to_cell(wrap_positions(state.pos, cfg.grid)[1], cfg.grid)
    return nbk.prepare(state.pos, state.age, state.w, cell, state.alive, cfg,
                       state.tag, **tiles)


def compare_kernel(cfg, snap, chunks, b, ch, blocks=None):
    """Kernel vs plain version on the same card inputs; returns the largest
    absolute acc difference."""
    import torch
    from particlesystem_tpu_torch.ops import neighbor_blocks as nbk
    acc, gmax = nbk.cluster_pair_cuda(cfg, snap, chunks, b, ch, blocks)
    ref_acc, ref_gmax = nbk.cluster_pair_plain(cfg, snap, chunks, b, ch,
                                               blocks)
    torch.cuda.synchronize()
    assert torch.isfinite(acc).all(), "kernel acc not finite"
    assert torch.equal(gmax, ref_gmax), \
        f"gmax differs in {int((gmax != ref_gmax).sum())} rows"
    err = (acc - ref_acc).abs().max().item()
    scale = max(1.0, ref_acc.abs().max().item())
    assert err / scale <= 1e-5, \
        f"acc error {err} exceeds 1e-5 of max(1, max|acc|) = {scale}"
    return err


def phase_kernel_vs_plain(dev):
    import torch
    from particlesystem_tpu_torch import GridSpec, NBodyConfig
    from particlesystem_tpu_torch.models import nbody
    from particlesystem_tpu_torch.ops import neighbor_blocks as nbk

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
        ("mid-g8-cmax2", NBodyConfig(n_fill=6000, capacity=8192, seed=13,
                                     grid=GridSpec(grid_dim=8,
                                                   chunk_factor=2)),
         dict(c_max=2)),
    ]
    worst = 0.0
    for name, cfg, tiles in configs:
        st = nbody.init_fill(cfg, dev)
        for f in range(2):
            st, _ = nbody.step(st, f, cfg)
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
        err = compare_kernel(cfg, snap, chunks, tiles.get("b", nbk.B),
                             tiles.get("ch", nbk.CH))
        worst = max(worst, err)
        print(f"phase 2 {name}: prepare card == cpu, gmax exact, acc max "
              f"abs err {err:.3e} (limit 1e-5 of max(1, max|acc|)), "
              f"dropped {int(dropped)}")
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
    from particlesystem_tpu_torch.ops import neighbor_blocks as nbk

    cfg = NBodyConfig()
    torch.cuda.reset_peak_memory_stats()
    nbk.cluster_pair_cuda.launches = 0
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
    launches = nbk.cluster_pair_cuda.launches
    ms_frame = start.elapsed_time(end) / MAIN_ITERS
    peak = torch.cuda.max_memory_allocated()

    st = sim.state
    alive = st.alive
    n_alive = int(alive.sum())
    assert launches == 2 * MAIN_ITERS, f"kernel launched {launches} times"
    assert sim.n_degraded_frames == 0 and int(
        sim.last_stats.n_listed_dropped) == 0, "chunks dropped"
    assert n_alive > 0, "nothing alive"
    for f in ("pos", "vel", "acc", "age", "life", "w"):
        assert torch.isfinite(getattr(st, f)).all(), f"non-finite {f}"
    bound = cfg.grid.half_extent + cfg.grid.cell_size
    assert (st.pos[alive].abs() <= bound).all(), "alive particle out of box"
    print(f"phase 4: frames 1-{MAIN_ITERS} {first_s:.3f} s (first call, "
          f"full width, includes warm-up); frames {MAIN_ITERS + 1}-"
          f"{2 * MAIN_ITERS} {ms_frame:.3f} ms/frame on active prefix "
          f"{active_second or cfg.slots} of {cfg.slots} slots; alive "
          f"{n_alive}; kernel launches {launches}; peak memory "
          f"{peak} bytes ({peak / 2**30:.3f} GiB)")

    # kernel vs plain on 64 evenly spaced live blocks of this frame
    rows = sim._active or cfg.slots
    head = st.map(lambda a: a[:rows])
    snap, chunks, *_ = frame_inputs(cfg, head)
    live_blocks = max(1, -(-n_alive // nbk.B))
    blocks = torch.linspace(0, live_blocks - 1, SUBSET_BLOCKS,
                            device=dev).round().to(torch.int32)
    err = compare_kernel(cfg, snap, chunks, nbk.B, nbk.CH, blocks)
    kern = lambda: nbk.cluster_pair_cuda(cfg, snap, chunks, nbk.B, nbk.CH,
                                         blocks)
    plain = lambda: nbk.cluster_pair_plain(cfg, snap, chunks, nbk.B, nbk.CH,
                                           blocks)
    plain_ms = cuda_ms(plain, 3)
    kern_ms = cuda_ms(kern, 20)
    kern_ms2 = cuda_ms(kern, 20)
    plain_ms2 = cuda_ms(plain, 3)
    full_ms = cuda_ms(lambda: nbk.cluster_pair_cuda(cfg, snap, chunks,
                                                    nbk.B, nbk.CH), 5)
    print(f"phase 4: {SUBSET_BLOCKS}-block subset of {chunks.shape[0]} "
          f"blocks: kernel {kern_ms:.4f} / {kern_ms2:.4f} ms, plain "
          f"{plain_ms:.3f} / {plain_ms2:.3f} ms (plain, kernel, kernel, "
          f"plain); acc max abs err {err:.3e}; whole-frame kernel "
          f"{full_ms:.3f} ms")
    return dict(launches=launches, err=err, ms=min(kern_ms, kern_ms2),
                plain_ms=min(plain_ms, plain_ms2))


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
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")

    dev = torch.device("cuda", 0)
    worst = phase_kernel_vs_plain(dev)
    phase_card_vs_cpu(dev)
    main_path = phase_main_path(dev)

    kernels = [{
        "name": "cluster_pair",
        "route": "cuda",
        "source": "particlesystem_tpu_torch/csrc/neighbor_blocks.cu",
        "replaces": "particlesystem_tpu/ops/neighbor_blocks.py:296",
        "launches": main_path["launches"],
        "max_abs_err": max(worst, main_path["err"]),
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
