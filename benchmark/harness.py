"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, the metrics, the result line.

A cell of ``BENCHMARK.json`` names its configuration (whose ``file`` holds
the sizes) and its traffic; ``traffic/<mix>.json`` holds the mix's
parameters and names its driver (``drivers/<driver>.py``), which sets the
system up and runs one unit of work at a time; ``workloads/<cell>.json``
holds the comparison's sample and limits; ``metrics/<metric>.py`` reads
each metric from what the run recorded (:class:`Context`).  A later cell,
mix, limit or metric is a file added, never a file edited.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names a run must never load
FORBIDDEN = ("jax", "jaxlib", "flax", "particlesystem_tpu")


@dataclasses.dataclass
class Context:
    """What a run recorded, for the metrics' readers."""

    cell: dict
    config: dict           # the configuration file's contents
    mix: dict              # the traffic file's contents
    check: dict            # workloads/<cell>.json
    seed: int
    seconds: float
    traced: bool
    device: object
    setup_s: float = 0.0
    window_s: float = 0.0     # less the copies of sampled answers
    held_s: float = 0.0       # those copies
    unit_s: list = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    frames: int = 0        # frames the window stepped
    counters: dict = dataclasses.field(default_factory=dict)
    work: dict = dataclasses.field(default_factory=dict)
    trace: object = None   # trace.Trace of the window, when traced

    @property
    def completed(self) -> int:
        return self.attempted - self.failed


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def by_name(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, traced: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or,
    traced, its per-layer metrics."""
    def listed(m):
        return "workloads" not in m or cell in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def note(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def prepare(bench: dict, cell_name: str, seed: int, seconds: float,
            traced: bool, device) -> Context:
    cell = by_name(bench["workloads"], cell_name, "workload")
    conf = by_name(bench["configs"], cell["config"], "config")
    return Context(cell=cell, config=load_json(ROOT / conf["file"]),
                   mix=load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
                   check=load_json(HERE / "workloads" / f"{cell_name}.json"),
                   seed=seed, seconds=seconds, traced=traced, device=device)


def _hold(ctx: Context, runner, i: int, after: bool) -> float:
    """The seconds ``runner.hold`` took to copy a sampled unit's answer
    (or, ``after`` false, its start) to the host, device synchronised on
    both sides: left out of the window's time and of the unit's."""
    import torch
    sync = (lambda: torch.cuda.synchronize(ctx.device)) \
        if ctx.device.type == "cuda" else (lambda: None)
    sync()
    t = time.perf_counter()
    runner.hold(i, after)
    sync()
    return time.perf_counter() - t


def _window(ctx: Context, runner) -> None:
    """Units of work in a closed loop for ``ctx.seconds``; a sampled
    unit's start and answer are copied to the host between units, outside
    every timed interval and every unit's annotation."""
    import torch
    from torch.profiler import record_function

    from . import trace
    i, held = 0, 0.0
    with record_function(trace.WINDOW):
        w0 = time.perf_counter()
        while time.perf_counter() - w0 - held < ctx.seconds:
            kept = i in runner.sample
            if kept:
                held += _hold(ctx, runner, i, False)
            t = time.perf_counter()
            ctx.attempted += 1
            try:
                with record_function(trace.UNIT):
                    ok = runner.unit(i)
            except Exception as exc:  # a unit that raises is a failure
                print(f"unit {i} failed: {exc!r}", file=sys.stderr)
                ok, kept = False, False
            ctx.failed += 0 if ok else 1
            ctx.unit_s.append(time.perf_counter() - t)
            if kept:
                held += _hold(ctx, runner, i, True)
            i += 1
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        ctx.window_s = time.perf_counter() - w0 - held
    ctx.held_s = held


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             traced: bool, device, t_start: float, edit=None,
             driver_hook=None):
    """One run; returns (the result dict, [(check name, value, limit)]).
    ``edit(ctx)`` may change what the files gave before the driver is
    built, and ``driver_hook(runner)`` may replace parts of the runner
    (both for the tests, which run tiny cells on the CPU)."""
    import torch

    ctx = prepare(bench, cell_name, seed, seconds, traced, device)
    if edit is not None:
        edit(ctx)
    driver = importlib.import_module(f"benchmark.drivers.{ctx.mix['driver']}")
    runner = driver.Runner(ctx)
    if driver_hook is not None:
        driver_hook(runner)
    runner.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # what set-up made lives on: no collection in the window walks it
    gc.collect()
    gc.freeze()
    ctx.setup_s = time.perf_counter() - t_start

    if traced:
        from torch.profiler import ProfilerActivity, profile

        from . import trace
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            _window(ctx, runner)
        t0 = time.perf_counter()
        ctx.trace = trace.summarize(prof)
        del prof
        note(f"trace read in {time.perf_counter() - t0:.1f} s")
    else:
        _window(ctx, runner)
    ms = np.asarray(ctx.unit_s) * 1e3
    if ms.size:
        q = np.percentile(ms, [50, 90, 95, 99, 100])
        fifths = [c.mean() for c in np.array_split(ms, 5) if c.size]
        note(f"window {ctx.window_s:.3f} s (and {ctx.held_s:.3f} s of "
             f"copies to the host), {ms.size} units, unit ms "
             f"p50/p90/p95/p99/max " + "/".join(f"{v:.4g}" for v in q)
             + ", mean of each fifth of the window "
             + " / ".join(f"{v:.4g}" for v in fifths))

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    runner.finish()
    note(f"counters {ctx.counters}")
    leaked = loaded_forbidden()
    if leaked:
        raise ForbiddenImport(leaked)
    t0 = time.perf_counter()
    checks = runner.check()
    note(f"comparison in {time.perf_counter() - t0:.1f} s")
    correct = (ctx.failed == 0 and ctx.completed > 0 and bool(checks)
               and all(v <= lim for _, v, lim in checks))

    metrics = {}
    for m in cell_metrics(bench, cell_name, traced):
        reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
        v = reader.read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": ctx.cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": ctx.attempted,
              "failed": ctx.failed, "metrics": metrics, "device": dev}
    if traced:
        t = ctx.trace
        dev["busy_s"] = t.busy_s
        dev["window_s"] = t.window_s
        ops = sorted(t.by_name().items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {
            "device_ops": [[n, ns / 1e9] for n, ns in ops],
            "idle_gaps": t.gaps_by_label(10)}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    return result, checks


class ForbiddenImport(RuntimeError):
    def __init__(self, names):
        super().__init__(f"modules loaded that the benchmark must not load: "
                         f"{', '.join(names)}")
        self.names = names

