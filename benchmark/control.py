"""The control of a cell's comparison: the plain reference in the next
lower precision than the configuration's ``dtype`` states (:data:`LOWER`:
``bfloat16`` for ``float32``, which no matrix product here could take as
TF32) put in the program's place, at the cell's own size, on each
seed given.  Its numbers are the upper readings the limits of
``workloads/<cell>.json`` are set below.

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line a seed: the numbers, each beside its limit, and
whether the comparison refused the control (it has to).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from .harness import ROOT, load_json, prepare

#: the next lower precision below a configuration's ``dtype``
LOWER = {"float32": torch.bfloat16}


def control_type(config: dict) -> torch.dtype:
    """The control's float type: the one below the configuration's."""
    return LOWER[config["dtype"]]


def control_checks(bench: dict, cell: str, seed: int, device, edit=None):
    """The program's set-up for ``cell`` at ``seed`` (the resumed states,
    the emitter's start), then the comparison with the reference in
    :func:`control_type` in the program's place: [(name, value, limit)]."""
    ctx = prepare(bench, cell, seed, 0.0, False, device)
    if edit is not None:
        edit(ctx)
    ftype = control_type(ctx.config)
    driver = importlib.import_module(f"benchmark.drivers.{ctx.mix['driver']}")
    runner = driver.Runner(ctx)
    runner.setup()
    return runner.check(control=ftype)


def refused(checks) -> bool:
    return any(lim is not None and v > lim for _, v, lim in checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = load_json(ROOT / "BENCHMARK.json")
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = control_checks(bench, args.workload, seed,
                                torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "refused": refused(checks),
                          "seconds": time.perf_counter() - t0,
                          "checks": {n: {"value": v, "limit": lim}
                                     for n, v, lim in checks}}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
