"""Size and save/load time of the sharded checkpoint at 10M, on the card.

    python -m particlesystem_tpu_torch.tools.measure_ckpt_10m [dir] \\
        [--particles 10485760] [--grid-dim 32] [--device cuda]

Counterpart of the JAX package's ``tools/measure_ckpt_10m.py``: one
process, ``DistributedNBodySimulation`` with ``SlabSpec(n_devices=1)``, so
the one rank saves and loads the whole state through the sharded
directory format (``runtime/checkpoint.save_sharded``); on several ranks
each moves only its share.  No frame is stepped.  Host clock around each
call, with the card synchronised before and after.  The checkpoint goes in
``dir`` (a fresh temp directory when none is given), and is removed after.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import torch

from ..core.config import GridSpec, NBodyConfig
from ..core.state import FIELDS
from ..parallel import DistributedNBodySimulation, SlabSpec
from ..utils.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="measure_ckpt_10m")
    ap.add_argument("dir", nargs="?", default=None)
    ap.add_argument("--particles", type=int, default=10 << 20)
    ap.add_argument("--grid-dim", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    base = tempfile.mkdtemp(dir=args.dir)
    try:
        path = os.path.join(base, "ckpt_10m")
        cfg = NBodyConfig(n_fill=args.particles,
                          grid=GridSpec(grid_dim=args.grid_dim))
        t0 = time.perf_counter()
        sim = DistributedNBodySimulation(cfg, SlabSpec(n_devices=1),
                                         device=dev)
        sync()
        t_init = time.perf_counter() - t0
        state_bytes = sum(getattr(sim.state, f).numel()
                          * getattr(sim.state, f).element_size()
                          for f in FIELDS)
        t0 = time.perf_counter()
        sim.save(path)
        t_save = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        sync()
        t0 = time.perf_counter()
        dropped = sim.load(path)
        sync()
        t_load = time.perf_counter() - t0
    finally:
        shutil.rmtree(base, ignore_errors=True)
    out = {"device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "slots": cfg.slots, "state_bytes": state_bytes,
           "disk_bytes": disk, "fill_and_distribute_s": t_init,
           "save_s": t_save, "load_s": t_load,
           "save_MBps": state_bytes / 1e6 / t_save,
           "load_MBps": state_bytes / 1e6 / t_load,
           "n_dropped_on_load": dropped}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
