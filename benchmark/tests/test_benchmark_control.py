"""The comparison refuses what it has to: the control (the reference in
``bfloat16`` in the program's place) and a run whose timed path is broken
underneath, once for each fault a cell can have.  Tiny cells on the CPU;
the control at the cells' own sizes runs on the card
(``python3 -m benchmark.control``), and here under the ``cuda`` marker."""

import time

import pytest
import torch

from benchmark import control, harness
from particlesystem_tpu_torch import api
from particlesystem_tpu_torch.runtime import engine

from .conftest import tiny

CELLS = ["nbody1m_refill10", "nbody1m_resume", "emitter10m_batch"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_refused(bench, cell):
    checks = control.control_checks(bench, cell, 2 ** 31 + 7,
                                    torch.device("cpu"), edit=tiny(cell))
    assert checks and control.refused(checks)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_refused_on_the_card(bench, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    checks = control.control_checks(bench, cell, 2 ** 31 + 9,
                                    torch.device("cuda", 0))
    assert checks and control.refused(checks)


def run(bench, cell):
    result, _ = harness.run_cell(bench, cell, 2 ** 31 + 11, 0.05, False,
                                 torch.device("cpu"), time.perf_counter(),
                                 edit=tiny(cell))
    return result


# --- n-body: faults planted in the frame loop and in run() ---------------------

def frame_unchanged(monkeypatch):
    real = api.nbody.step_into

    def step_into(state, *a, **k):
        return real(state.map(lambda t: t.clone()), *a, **k)
    monkeypatch.setattr(api.nbody, "step_into", step_into)


def half_the_rows(monkeypatch):
    real = api.nbody.step_into

    def step_into(state, *a, **k):
        live = state.alive.nonzero().view(-1)
        h = int(live[live.shape[0] // 2])
        kept = state.map(lambda t: t[h:].clone())
        stats = real(state, *a, **k)
        for f in ("pos", "vel", "acc", "w", "age", "life", "alive",
                  "parent", "tag"):
            getattr(state, f)[h:] = getattr(kept, f)
        return stats
    monkeypatch.setattr(api.nbody, "step_into", step_into)


def answer_altered(monkeypatch):
    real = api.NBodySimulation.run

    def run_(self, *a, **k):
        out = real(self, *a, **k)
        self.state.age.add_(0.01)
        return out
    monkeypatch.setattr(api.NBodySimulation, "run", run_)


@pytest.mark.parametrize("cell", ["nbody1m_refill10", "nbody1m_resume"])
@pytest.mark.parametrize("fault", [frame_unchanged, half_the_rows,
                                   answer_altered],
                         ids=lambda f: f.__name__)
def test_nbody_fault_is_refused(bench, monkeypatch, cell, fault):
    if cell == "nbody1m_resume":
        # the resumed states are made by the sound program in set-up;
        # the fault breaks the window's runs
        from benchmark.drivers import nbody_runs
        real_setup = nbody_runs.Runner.setup

        def setup(self):
            real_setup(self)
            fault(monkeypatch)
        monkeypatch.setattr(nbody_runs.Runner, "setup", setup)
    else:
        fault(monkeypatch)
    assert run(bench, cell)["correct"] is False


# --- the emitter: faults planted in step_many -------------------------------------

def batch_unchanged(monkeypatch):
    def step_many(self, s, k):
        st = self._enter(s)
        st.frame += k
        self._frame_t.add_(k)
        return st
    monkeypatch.setattr(engine.PackedEngine, "step_many", step_many)


def half_the_batch(monkeypatch):
    real = engine.PackedEngine.step_many

    def step_many(self, s, k):
        st = real(self, s, k // 2)
        st.frame += k - k // 2
        self._frame_t.add_(k - k // 2)
        return st
    monkeypatch.setattr(engine.PackedEngine, "step_many", step_many)


def row_altered(monkeypatch):
    real = engine.PackedEngine.step_many

    def step_many(self, s, k):
        st = real(self, s, k)
        st.fields[0].view(-1)[123] += 1.0
        return st
    monkeypatch.setattr(engine.PackedEngine, "step_many", step_many)


@pytest.mark.parametrize("fault", [batch_unchanged, half_the_batch,
                                   row_altered], ids=lambda f: f.__name__)
def test_emitter_fault_is_refused(bench, monkeypatch, fault):
    from benchmark.drivers import emitter_batches
    real_setup = emitter_batches.Runner.setup

    def setup(self):
        real_setup(self)
        fault(monkeypatch)
    monkeypatch.setattr(emitter_batches.Runner, "setup", setup)
    assert run(bench, "emitter10m_batch")["correct"] is False
