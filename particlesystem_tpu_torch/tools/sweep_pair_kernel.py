"""Sweep the cluster-pair kernel's geometry on the card at reference scale.

Counterpart of ``tools/sweep_blocks.py``.  The JAX tool times variants of
the Pallas kernel's tiles; here the variants are builds of
``csrc/neighbor_blocks.cu`` with one of its named constants changed (``TW``,
the raw columns a piece; ``WIDE``, the rows a thread), each compiled by
``nvcc`` into a library of its own and bound with ``ctypes``.  Every variant
is timed alone on a whole frame of ``NBodyConfig()`` in the two states the
kernel meets:

* the plateau (frame 20 of a run, on the active prefix: most survivors are
  kids, almost no listed pair is inside the stencil);
* adult-heavy (frame 0, straight from ``init_fill``: every particle an
  adult, three listed pairs in four inside the stencil).

Variants are timed in turns for ``--rounds`` rounds, so that a drift of the
card's clocks shows as a difference between rounds, and the outputs of each
are compared bit for bit with the package's built kernel (the sums keep
their order whatever the geometry).  ``--earlier PATH`` adds a source file
of an earlier revision of the kernel, for example
``git show <commit>:particlesystem_tpu_torch/csrc/neighbor_blocks.cu``
written to a file; an entry point that still takes the chunk width ``ch``
is recognised.

This module also holds the frames that the kernel's checks share:
:func:`frame_inputs`, :func:`synthetic_frame` and :func:`source_constants`.

Usage: python -m particlesystem_tpu_torch.tools.sweep_pair_kernel
           [--earlier PATH] [--rounds 2] [--reps 5]
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .. import GridSpec, NBodyConfig
from ..ops import neighbor_blocks as nbk
from ..ops.grid import coords_to_cell, wrap_positions
from ..utils import cuda_build

SOURCE = cuda_build.CSRC / "neighbor_blocks.cu"
# (name, {constant of the source: value}); "tree" is the source as it stands
VARIANTS = (("tree", {}), ("TW=128", {"TW": 128}), ("WIDE=1", {"WIDE": 1}),
            ("WIDE=4", {"WIDE": 4}))
_CONSTANT = r"constexpr int {} = (\d+);"


def frame_inputs(cfg, state, **tiles):
    """``prepare``'s outputs for one frame of ``state``."""
    cell = coords_to_cell(wrap_positions(state.pos, cfg.grid)[1], cfg.grid)
    return nbk.prepare(state.pos, state.age, state.w, cell, state.alive, cfg,
                       state.tag, **tiles)


def synthetic_frame(dev, seed=5):
    """Inputs of ``prepare`` at 256 rows of a 4^3 grid, made with numpy, for
    32-row blocks and 128-column chunks: 32 kids in cell 0 (a block of kids
    only), 40 adults in cell 1, 50 adults in cell 2, 40 kids in cell 5 (for
    the block inside cell 1 the chunk of stencil offset i1 + 1 holds kids
    only) and 94 dead rows (blocks without a chunk).  All positions lie in one
    small cube, so that adults touch.  Returns (cfg, prepare's array
    arguments, tags)."""
    cfg = NBodyConfig(n_fill=128, capacity=256, max_per_cell=64,
                      grid=GridSpec(grid_dim=4, chunk_factor=2), seed=seed)
    rng = np.random.default_rng(seed)
    cell = np.repeat([0, 1, 2, 5, 63], [32, 40, 50, 40, 94])
    kid = np.repeat([True, False, False, True, False], [32, 40, 50, 40, 94])
    alive = cell != 63
    perm = rng.permutation(256)
    age = np.where(kid, 0.0, rng.uniform(cfg.kid_age, cfg.particle_life, 256))
    arrays = (rng.uniform(0.0, 1.5, (256, 3)).astype(np.float32)[perm],
              age.astype(np.float32)[perm],
              np.full(256, cfg.weight, np.float32),
              cell.astype(np.int32)[perm], alive[perm])
    tags = rng.permutation(1 << 20)[:256].astype(np.int64)
    return cfg, tuple(torch.tensor(a, device=dev) for a in arrays), \
        torch.tensor(tags, device=dev)


def source_constants(text: str | None = None) -> dict:
    """{TW, WIDE, MAX_WARPS} as the kernel's source declares them."""
    text = SOURCE.read_text() if text is None else text
    return {name: int(re.search(_CONSTANT.format(name), text).group(1))
            for name in ("TW", "WIDE", "MAX_WARPS")}


def _variant_source(edits: dict) -> str:
    text = SOURCE.read_text()
    for name, value in edits.items():
        text, n = re.subn(_CONSTANT.format(name),
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"constant {name} not found once in {SOURCE}")
    return text


def build_variants(sources: dict, workdir: Path) -> dict:
    """Compile each {name: source text} into a library of its own, all
    ``nvcc`` processes started together.  Returns {name: (entry point or
    None when the build failed, takes ch, ptxas's register lines)}."""
    nvcc = cuda_build._nvcc()
    procs = {}
    for k, (name, text) in enumerate(sources.items()):
        src, lib = workdir / f"v{k}.cu", workdir / f"libv{k}.so"
        src.write_text(text)
        procs[name] = (lib, text, subprocess.Popen(
            [nvcc, *cuda_build.COMPILE_FLAGS, "-shared", "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    p = ctypes.c_void_p
    built = {}
    for name, (lib, text, proc) in procs.items():
        out = proc.communicate()[0]
        info = [line.split(":", 1)[1].strip() for line in out.splitlines()
                if "Used" in line or "error" in line]
        if proc.returncode:
            built[name] = (None, False, info)
            continue
        takes_ch = re.search(r"ps_cluster_pair\([^)]*\bint ch\b", text,
                             re.S) is not None
        fn = ctypes.CDLL(str(lib)).ps_cluster_pair
        fn.argtypes = ([p, p, ctypes.c_longlong, p, p]
                       + [ctypes.c_int] * (4 if takes_ch else 3)
                       + [ctypes.c_float, ctypes.c_float, p,
                          ctypes.c_longlong, p, p])
        fn.restype = ctypes.c_int
        built[name] = (fn, takes_ch, info)
    return built


def call_variant(fn, takes_ch, cfg, snap, chunks):
    """One whole-frame launch of a variant's entry point."""
    eps2, r2 = nbk._pair_constants(cfg)
    n = snap.f.shape[1]
    acc = torch.empty((3, n), dtype=torch.float32, device=snap.f.device)
    gmax = torch.empty((n,), dtype=torch.int32, device=snap.f.device)
    tile = (nbk.B, nbk.CH) if takes_ch else (nbk.B,)
    err = fn(snap.f.data_ptr(), snap.i.data_ptr(), n, chunks.data_ptr(), None,
             chunks.shape[0], *tile, chunks.shape[1], eps2, r2,
             acc.data_ptr(), n, gmax.data_ptr(),
             cuda_build.current_stream_handle(snap.f.device.index))
    if err:
        raise RuntimeError(f"CUDA error {err}")
    return acc, gmax


def _ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", type=Path, default=None,
                    help="source file of an earlier revision of the kernel")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_pair_kernel: torch sees no CUDA device", file=sys.stderr)
        return 1
    from ..api import NBodySimulation
    from ..models import nbody

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"{card}; constants of the tree's source: {source_constants()}")
    sources = {name: _variant_source(edits) for name, edits in VARIANTS}
    if args.earlier is not None:
        sources[f"earlier ({args.earlier.name})"] = args.earlier.read_text()
    cuda_build.BUILD_DIR.mkdir(exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="sweep_pair.",
                                    dir=cuda_build.BUILD_DIR))
    try:
        built = build_variants(sources, workdir)
        for name, (fn, takes_ch, info) in built.items():
            print(f"built {name}: {'failed' if fn is None else 'ok'}"
                  f"{', takes ch' if takes_ch else ''}; " + " | ".join(info))

        cfg = NBodyConfig()
        sim = NBodySimulation(cfg, device=dev)
        sim.run(20)
        rows = sim._active or cfg.slots
        states = {
            f"plateau (frame {sim.frame})":
                frame_inputs(cfg, sim.state.map(lambda a: a[:rows]))[:2],
            "adult-heavy (frame 0)":
                frame_inputs(cfg, nbody.init_fill(cfg, dev))[:2]}
        del sim
        for rnd in range(args.rounds):
            for name, (fn, takes_ch, _) in built.items():
                if fn is None:
                    continue
                line = []
                for what, (snap, chunks) in states.items():
                    run = lambda: call_variant(fn, takes_ch, cfg, snap, chunks)
                    acc, gmax = run()
                    ref_acc, ref_gmax = nbk.cluster_pair_cuda(
                        cfg, snap, chunks, nbk.B, nbk.CH)
                    same = (torch.equal(acc.view(torch.int32),
                                        ref_acc.view(torch.int32))
                            and torch.equal(gmax, ref_gmax))
                    del acc, gmax, ref_acc, ref_gmax
                    line.append(f"{what} {_ms(run, args.reps):.4f} ms, "
                                f"{'bit for bit' if same else 'NOT'} the "
                                f"package's kernel")
                print(f"round {rnd} {name}: " + "; ".join(line), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
