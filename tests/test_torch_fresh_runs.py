"""Fresh simulations one after another, the reference's own deployment
(``NBodySimulation(cfg).run(10)`` a run), on the CPU.

* the deployment's configuration holds the reference's constants, those
  of ``nbody_ref_1m`` (one source file, two deployments of it);
* a fresh run against the benchmark's plain reference from the same seed,
  particle by particle, the compaction to the prefix included
  (``benchmark/compare.nbody`` under the ``nbody1m_run10`` cell's limits:
  the same comparison that decides the cell's ``correct`` on the card);
* the cell's driver through the harness at a tiny size, in a process of
  its own (the harness refuses to run where JAX is loaded, and this
  file's conftest loads it): ``correct`` over three runs or more, and a
  planted leak that the memory guard fails and then stops;
* the driver lets go of a run's simulation before it builds the next, and
  a simulation is freed by reference counting alone;
* ``FrameGraphs``' bookkeeping: loops one after the other keep their own
  keys, ``retain`` drops graphs only, and the CPU makes no pool;
* the ``nbody.init`` span holds the fill's, and the reader of
  ``nbody_capture_host_us_per_run`` reads the capture spans.

The ``cuda``-marked test builds fresh simulations on a card and holds the
reserved memory flat; ``chip_smoke.py`` phase 17 does so at full size.
"""

import dataclasses
import gc
import json
import random
import subprocess
import sys
import time
import weakref
from pathlib import Path

import pytest
import torch

from benchmark import compare, harness
from benchmark.drivers import nbody_fresh, nbody_runs
from benchmark.metrics import nbody_capture_host_us_per_run as capture_reader
from benchmark.reference import nbody as ref
from particlesystem_tpu_torch import GridSpec, NBodyConfig
from particlesystem_tpu_torch.api import NBodySimulation
from particlesystem_tpu_torch.utils import frame_graph, timers

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CELL = "nbody1m_run10"
SEED = 2 ** 33 + 17
#: 500 particles in 1,024 slots on 4^3 cells, dying young; a spawn budget
#: of 128 and a prefix quantum of 256 let the prefix engage (768 rows)
TINY = dict(n_fill=500, capacity=0, particle_life=2.0, spawn_budget=128,
            grid=dict(grid_dim=4, cell_size=5.0, chunk_factor=2))
QUANTUM = 256


@pytest.fixture(scope="module")
def bench():
    return harness.load_json(REPO / "BENCHMARK.json")


def tiny_conf(bench) -> dict:
    conf = harness.by_name(bench["configs"],
                           harness.by_name(bench["workloads"], CELL,
                                           "workload")["config"], "config")
    return dict(harness.load_json(REPO / conf["file"]), **TINY)


def port_config(conf: dict, seed: int) -> NBodyConfig:
    keys = {f for f in NBodyConfig.__dataclass_fields__} - {"grid", "seed"}
    return NBodyConfig(grid=GridSpec(**conf["grid"]), seed=seed,
                       **{k: v for k, v in conf.items() if k in keys})


def test_deployment_holds_the_reference_constants(bench):
    conf = harness.by_name(bench["configs"],
                           harness.by_name(bench["workloads"], CELL,
                                           "workload")["config"], "config")
    ref_1m = harness.by_name(bench["configs"], "nbody_ref_1m", "config")
    got, want = (harness.load_json(REPO / c["file"]) for c in (conf, ref_1m))
    assert conf["reduced"] == ref_1m["reduced"] == []
    assert {k: v for k, v in got.items() if k != "_"} == {
        k: v for k, v in want.items() if k != "_"}
    assert port_config(got, 0) == NBodyConfig(seed=0)  # the class defaults


def test_fresh_run_agrees_with_the_reference(bench, monkeypatch):
    monkeypatch.setattr(NBodySimulation, "ACTIVE_QUANTUM", QUANTUM)
    conf = tiny_conf(bench)
    limits = harness.load_json(REPO / "benchmark" / "workloads"
                               / f"{CELL}.json")["limits"]
    for seed in (SEED, 7):
        sim = NBodySimulation(port_config(conf, seed), device="cpu")
        stats = sim.run(10)
        assert 0 < sim._active < sim.cfg.slots     # compacted to a prefix
        sc = ref.Scene.from_config(conf, seed)
        want, rstats, _ = ref.run(ref.fill(sc, "cpu"), 0, 10, sc)
        got = {f: int(getattr(stats, f)) for f in nbody_runs.STAT_FIELDS}
        nums = compare.nbody(nbody_runs.to_ref(sim.state), want, got, rstats)
        checks = compare.with_limits(nums, limits, f"seed{seed}")
        assert checks and all(v <= lim for _, v, lim in checks), checks


CHILD = r"""
import json, sys, time
import torch
torch.set_num_threads(1)
from benchmark import harness
from benchmark.drivers import nbody_fresh
from particlesystem_tpu_torch.api import NBodySimulation

mode, seconds = sys.argv[1], float(sys.argv[2])
TINY = json.loads(sys.argv[3])


class Sim(NBodySimulation):
    ACTIVE_QUANTUM = int(sys.argv[4])


def edit(ctx):
    ctx.config = dict(ctx.config, **TINY)
    ctx.mix = dict(ctx.mix, warm_runs=1)
    ctx.check = dict(ctx.check, sample_from=3, sample=2)


kept = []


def hook(runner):
    runner.Sim = Sim
    if mode == "leak":    # every simulation kept, half the guard's bytes each
        refill = runner._refill

        def keep(s):
            out = refill(s)
            kept.append(out[0])
            return out
        runner._refill = keep
        step = nbody_fresh.GUARD_BYTES // 2 + 1
        runner.reserved = lambda: len(kept) * step


bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
result, _ = harness.run_cell(bench, "nbody1m_run10", int(sys.argv[5]),
                             seconds, False, torch.device("cpu"),
                             time.perf_counter(), edit=edit, driver_hook=hook)
print(json.dumps(result))
"""


def run_child(mode: str, seconds: float):
    return subprocess.run(
        [sys.executable, "-c", CHILD, mode, str(seconds), json.dumps(TINY),
         str(QUANTUM), str(SEED)], cwd=REPO, capture_output=True, text=True,
        timeout=300)


def test_cell_runs_tiny_through_the_harness_and_is_correct():
    proc = run_child("sound", 3.0)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result
    assert result["attempted"] >= 3 and result["failed"] == 0
    sampled = random.Random(SEED).sample(range(3), 2)   # the driver's draw
    assert set(result["checks"]) == {f"run{i}.{k}" for i in sampled
                                     for k in ("rows_off", "stats_off")}
    assert {"nbody_run_ms", "nbody_run_p95_ms", "setup_s"} \
        == set(result["metrics"])


def test_a_leak_fails_the_memory_guard_and_ends_the_run():
    proc = run_child("leak", 120.0)
    # the guard reads after runs 3, 7, 11 (every fourth): the first two
    # fail it, the third ends the run
    assert proc.returncode == 1, proc.stderr[-3000:]
    assert proc.stdout.strip() == ""          # no result line
    failed = [ln for ln in proc.stderr.splitlines() if "failed:" in ln]
    every = nbody_fresh.GUARD_EVERY
    assert [ln.split()[1] for ln in failed] == [str(every - 1),
                                                str(2 * every - 1)], failed
    assert all("past the guard's" in ln for ln in failed)
    assert (f"{nbody_fresh.GUARD_STRIKES} runs failed the memory guard"
            in proc.stderr)


def runner_at(bench, seed=SEED):
    ctx = harness.prepare(bench, CELL, seed, 1.0, False, torch.device("cpu"))
    ctx.config = dict(ctx.config, **TINY)
    ctx.mix = dict(ctx.mix, warm_runs=0)
    return nbody_fresh.Runner(ctx)


def test_a_run_lets_go_of_the_last_simulation_first(bench):
    r = runner_at(bench)
    r.setup()
    built = []
    real = r.Sim

    def sim(*a, **k):
        # the previous run's simulation is gone before the next is built
        assert all(w() is None for w in built)
        s = real(*a, **k)
        built.append(weakref.ref(s))
        return s
    r.Sim = sim
    assert r.unit(0) and r.unit(1)
    assert built[0]() is None and built[1]() is r._last[0]
    r.finish()
    assert built[1]() is None
    assert r.ctx.counters["runs"] == 2
    assert r.ctx.counters["eager_frames"] == 20    # every CPU frame eager
    assert r.ctx.counters["pools_created"] == frame_graph.counters[
        "pools_created"]


def test_a_simulation_is_freed_by_reference_counting(monkeypatch):
    monkeypatch.setattr(NBodySimulation, "ACTIVE_QUANTUM", QUANTUM)
    gc.collect()
    gc.disable()
    try:
        sim = NBodySimulation(port_config(dict(TINY), 11), device="cpu")
        sim.run(10)
        assert sim._active          # compacted: two states were held
        refs = [weakref.ref(x) for x in (sim, sim.graphs, sim.state.pos,
                                         sim._static.pos)]
        del sim
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_guard_counts_growth_past_set_up(bench):
    r = runner_at(bench)
    every = nbody_fresh.GUARD_EVERY
    grown, reads = [0], []
    r.reserved = lambda: reads.append(1) or grown[0]
    r.setup()
    reads.clear()
    grown[0] = nbody_fresh.GUARD_BYTES       # at the guard: still sound
    for i in range(every):
        assert r.unit(i)
    assert len(reads) == 1                   # after the last of them only
    grown[0] += 1
    units = iter(range(every, every * (2 + nbody_fresh.GUARD_STRIKES)))
    for _ in range(nbody_fresh.GUARD_STRIKES - 1):
        for _ in range(every - 1):           # runs the guard does not read
            assert r.unit(next(units))
        with pytest.raises(RuntimeError, match="past the guard's"):
            r.unit(next(units))
    for _ in range(every - 1):
        assert r.unit(next(units))
    with pytest.raises(SystemExit):
        r.unit(next(units))
    assert len(reads) == 1 + nbody_fresh.GUARD_STRIKES


def test_two_loops_in_turn_keep_their_keys_on_the_cpu():
    before = dict(frame_graph.counters)
    ran = []
    a = frame_graph.FrameGraphs(torch.device("cpu"))
    for key in ("x", "x", "y"):
        a.step(key, lambda: ran.append(("a", key)))
    b = frame_graph.FrameGraphs(torch.device("cpu"))
    b.step("x", lambda: ran.append(("b", "x")))
    assert a.keys == ["x", "y"] and b.keys == ["x"]
    a.retain("y")
    assert a.keys == ["y"] and b.keys == ["x"]
    a.retain()
    assert a.keys == [] and b.keys == ["x"]
    a.step("x", lambda: ran.append(("a", "x")))   # a freed key comes back
    assert a.keys == ["x"] and a.eager_frames == 4 and b.eager_frames == 1
    assert ran == [("a", "x"), ("a", "x"), ("a", "y"), ("b", "x"),
                   ("a", "x")]
    assert a.captures == b.captures == a.replays == 0
    assert frame_graph.counters == before      # no pool on the CPU


def test_init_span_holds_the_fill():
    from torch.profiler import ProfilerActivity, profile
    timers.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        NBodySimulation(port_config(dict(TINY), 3), device="cpu")
    spans = timers.spans()
    names = [s.name for s in spans]
    assert names == ["nbody.init", "nbody.fill"], names
    init, fill = spans
    assert fill.parent == 0 and fill.run == init.run
    assert init.start_ns <= fill.start_ns <= fill.end_ns <= init.end_ns


class _Span:
    def __init__(self, name, start, end):
        self.name, self.start_ns, self.end_ns = name, start, end


class _Trace:
    window = (1_000, 100_000)


def test_capture_reader_reads_the_window_s_captures(bench, monkeypatch):
    ctx = harness.prepare(bench, CELL, 1, 1.0, True, torch.device("cpu"))
    ctx.attempted = 4
    assert capture_reader.read(ctx) is None      # no trace
    ctx.trace = _Trace()
    monkeypatch.setattr(timers, "spans", lambda: [
        _Span("graphs.capture", 2_000, 12_000),
        _Span("graphs.capture", 20_000, 26_000),
        _Span("graphs.eager", 12_000, 20_000),
        _Span("graphs.capture", 200_000, 300_000)])    # after the window
    assert capture_reader.read(ctx) == pytest.approx((10 + 6) / 4)
    monkeypatch.setattr(timers, "spans", lambda: [])
    assert capture_reader.read(ctx) is None


@pytest.mark.cuda
def test_cuda_fresh_simulations_hold_reserved_memory_flat():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py phase 17 runs 1,000 "
                    "fresh simulations at full size)")
    cfg = NBodyConfig(n_fill=1 << 16, grid=GridSpec(grid_dim=8,
                                                    cell_size=5.0,
                                                    chunk_factor=4))
    reserved, freed = [], []
    captures = frame_graph.counters["shared_captures"]
    for i in range(50):
        sim = NBodySimulation(dataclasses.replace(cfg, seed=100 + i))
        sim.run(10)
        assert sim.graphs.captures >= 1
        w = weakref.ref(sim)
        del sim
        freed.append(w() is None)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    assert all(freed)
    assert frame_graph.counters["pools_created"] == 1
    assert frame_graph.counters["shared_captures"] >= captures + 50
    assert len(set(reserved[1:])) == 1, reserved


def test_freed_graphs_go_with_retain_or_their_loop():
    """A graph freed by ``retain``, or held by a loop that is dropped, is
    let go at once, by reference counting alone: nothing else keeps it.
    (The CPU captures no graph; a stand-in object takes its place.)"""
    class Graph:
        pass

    gc.collect()
    gc.disable()
    try:
        loop = frame_graph.FrameGraphs(torch.device("cpu"))
        loop.step("cpu", lambda: None)
        a, b = Graph(), Graph()
        loop._graphs["a"] = frame_graph._Graph(a, {})
        loop._graphs["b"] = frame_graph._Graph(b, {})
        wa, wb = weakref.ref(a), weakref.ref(b)
        del a, b
        loop.retain("b")
        assert loop.keys == ["b"] and wa() is None and wb() is not None
        del loop
        assert wb() is None
    finally:
        gc.enable()
