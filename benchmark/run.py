"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Exits 2, printing no result, when torch sees
no card or fewer than the cell asks for, and 3 when a module the benchmark
must not load (JAX, or the JAX package) was loaded.  The numbers the
comparison checks are the last lines of standard error, each beside its
limit, and the last key of the result line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .harness import ROOT, ForbiddenImport, by_name, card_line, load_json, \
    loaded_forbidden, run_cell
from .peaks import FP32_FLOPS, HBM_BYTES

#: the driver's kernel cache (the PTX the card's driver compiles), at a
#: fixed path in the checkout; the program's own nvcc build lands in
#: ``particlesystem_tpu_torch/_build/``
CACHES = {"CUDA_CACHE_PATH": "nv_compute"}


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)

    bench = load_json(ROOT / "BENCHMARK.json")
    chips = by_name(bench["workloads"], args.workload, "workload")["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    print(f"card: {card_line()}; peaks assumed (H100 SXM data sheet): "
          f"{FP32_FLOPS:.3g} FLOP/s float32, {HBM_BYTES:.3g} B/s",
          file=sys.stderr)
    device = torch.device("cuda", 0)
    try:
        result, checks = run_cell(bench, args.workload, args.seed,
                                  args.seconds, bool(args.trace), device,
                                  t_start)
    except ForbiddenImport as exc:
        print(f"{exc}", file=sys.stderr)
        return 3
    leaked = loaded_forbidden()
    if leaked:  # the last look, once every module of the run is loaded
        print(f"{ForbiddenImport(leaked)}", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
