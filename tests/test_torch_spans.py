"""The port's span recorder (``utils/timers``) on the CPU: off unless a
profiler records, the spans of ``NBodySimulation.run``, ``init_fill``,
the compaction, a key's first frame and ``PackedEngine.step_many``, their
``record_function`` twins in the profiler's events, and the buffer's
bound."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from particlesystem_tpu_torch import (Emitter, EmitterSceneConfig, GridSpec,
                                      NBodyConfig)
from particlesystem_tpu_torch.api import NBodySimulation
from particlesystem_tpu_torch.models import nbody
from particlesystem_tpu_torch.runtime.engine import PackedEngine
from particlesystem_tpu_torch.utils import timers

torch.set_num_threads(1)

#: 4,096 slots on a 4^3 grid (tests/test_torch_frame_loop.py's shape)
CFG = NBodyConfig(n_fill=1024, capacity=4096,
                  grid=GridSpec(grid_dim=4, cell_size=5.0, chunk_factor=2))


@pytest.fixture(autouse=True)
def _fresh_recorder():
    timers.clear()
    yield
    timers.clear()


def profiled(fn):
    """(the profiler's events, the recorded spans) of ``fn()``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.profiler.kineto_results.events(), timers.spans()


def warm_sim(**kw) -> NBodySimulation:
    """A simulation whose frame key has run, handed a copy of its state,
    which the next batch copies into its static buffers."""
    sim = NBodySimulation(CFG, device="cpu", **kw)
    sim.run(2, batch=2)
    sim.state = sim.state.map(lambda a: a.clone())
    return sim


#: a count a case does not pin
ANY = object()


def tree(spans):
    """(name, parent's name, n) of every span."""
    return [(s.name, spans[s.parent].name if s.parent >= 0 else None, s.n)
            for s in spans]


def test_off_unless_a_profiler_records():
    sim = NBodySimulation(CFG, device="cpu")
    sim.run(4, batch=2)
    nbody.init_fill(CFG, "cpu")
    assert timers.spans() == [] and timers.dropped() == 0
    assert dict(sim.timers.counts) == {"fill": 1, "step": 2}
    assert all(v > 0 for v in sim.timers.totals.values())


@pytest.fixture(scope="module")
def profiled_run():
    """A warm simulation, the profiler's events and the spans of its
    ``run(4, batch=2)``, after a profiled warm-up call (a first profiled
    call costs ms)."""
    sim = warm_sim()
    profiled(lambda: sim.run(2, batch=2))
    sim.state = sim.state.map(lambda a: a.clone())
    timers.clear()
    events, spans = profiled(lambda: sim.run(4, batch=2))
    return sim, events, spans


def test_run_records_its_batches_and_their_parts(profiled_run):
    sim, _, spans = profiled_run
    batch = [("nbody.batch", "nbody.run", 2), ("nbody.step", "nbody.batch",
                                                None)]
    parts = [("nbody.enqueue", "nbody.step", 2),
             ("nbody.readback", "nbody.step", 1),
             ("nbody.guards", "nbody.batch", None)]
    handin = [("nbody.handin", "nbody.step", len(nbody.FIELDS))]
    assert tree(spans) == ([("nbody.run", None, 4)] + batch + handin + parts
                           + batch + parts)
    assert len({s.run for s in spans}) == 1
    for s in spans:
        outer = spans[s.parent] if s.parent >= 0 else s
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    assert dict(sim.timers.counts) == {"fill": 1, "step": 4}


def _phase():
    t = timers.PhaseTimers("p.")
    with t.phase("a", n=3):
        pass
    assert dict(t.counts) == {"a": 1}


def _compaction():
    cfg = dataclasses.replace(CFG, n_fill=500)
    sim = NBodySimulation(cfg, device="cpu")
    sim.ACTIVE_QUANTUM = 1024
    sim.run(2, batch=2)
    assert 0 < sim._active < cfg.slots


def _step_many():
    cfg = EmitterSceneConfig(capacity=4096, emitters=(Emitter(rate=4000.0),))
    eng = PackedEngine(cfg, alloc="select", device="cpu")
    eng.step_many(eng.init(), 8)


@pytest.mark.parametrize("call, want", [
    (lambda: nbody.init_fill(CFG, "cpu"), [("nbody.fill", None, 1024)]),
    (_compaction, [("nbody.init", None, None),
                   ("nbody.fill", "nbody.init", 500),
                   ("graphs.eager", "nbody.enqueue", None),
                   ("nbody.compact", "nbody.guards", ANY)]),
    (_step_many, [("engine.batch", None, 8),
                  ("graphs.eager", "engine.batch", None)]),
    (_phase, [("p.a", None, 3)]),
], ids=["fill", "compaction", "step_many", "phase"])
def test_calls_record_their_spans(call, want):
    _, spans = profiled(call)
    got = tree(spans)
    for name, parent, n in want:
        assert any(g[:2] == (name, parent) and n in (ANY, g[2])
                   for g in got), (name, got)


def test_every_span_has_its_twin_in_the_trace(profiled_run):
    _, events, spans = profiled_run
    twins, mine = {}, {}
    for ev in events:
        twins.setdefault(ev.name(), []).append(ev.start_ns())
    for s in spans:
        mine.setdefault(s.name, []).append(s.start_ns)
    assert len(spans) == 12 and set(mine) <= set(twins)
    for name, starts in mine.items():
        assert len(starts) == len(twins[name]), name
        for a, b in zip(starts, sorted(twins[name])):
            assert abs(a - b) < 1_000_000, name


def test_spans_past_the_bound_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(timers, "MAX_SPANS", 3)

    def five():
        for _ in range(5):
            with timers.span("x"):
                with timers.span("y"):
                    pass
    _, spans = profiled(five)
    assert [s.name for s in spans] == ["x", "y", "x"]
    assert timers.dropped() == 7
    assert [s.parent for s in spans] == [-1, 0, -1]
    assert [s.run for s in spans] == [spans[0].run, spans[0].run,
                                      spans[0].run + 1]
