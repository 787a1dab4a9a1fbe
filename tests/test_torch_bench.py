"""The port's bench (``particlesystem_tpu_torch/bench.py``) on the CPU.

Every stage runs at a tiny size with ``device="cpu"`` (the kernels' plain
versions; the times are the host's and say nothing of the card), and the
JSON line is held to its keys.  The n-body stages' guards hold on a normal
run, and each one that trips fails its stage: a dropped neighbour chunk,
a row alive past the prefix, a prefix that moves in the timed window, a
drop in the sharded run.  ``bench`` on a machine without a card fails
instead of measuring the CPU.  The two measuring tools that the bench
feeds (``tools/measure_ckpt_10m.py``, ``tools/measure_batched_run.py``)
run tiny.
"""

import contextlib
import dataclasses
import io
import json

import pytest
import torch

from particlesystem_tpu_torch import api
from particlesystem_tpu_torch import bench
from particlesystem_tpu_torch.__main__ import main as cli_main
from particlesystem_tpu_torch.parallel import driver
from particlesystem_tpu_torch.tools import (measure_batched_run,
                                            measure_ckpt_10m)

torch.set_num_threads(1)

# long batches several frames longer than the short ones, so that a busy
# host does not turn a slope negative
TINY = {
    "cap_10m": lambda: bench.bench_capacity(8192, k_short=2, k_long=10,
                                            reps=2, device="cpu"),
    "cap_1m": lambda: bench.bench_capacity(4096, k_short=2, k_long=40,
                                           reps=1, soak=1, device="cpu"),
    "nbody_1m": lambda: bench.bench_nbody(2048, 4, reps=1, device="cpu"),
    "nbody_sharded_d1": lambda: bench.bench_nbody_sharded_d1(
        2048, 4, reps=1, device="cpu"),
    "nbody_10m": lambda: bench.bench_nbody(1024, 4, reps=1, device="cpu"),
}


@pytest.fixture(scope="module")
def line():
    out = io.StringIO()
    res = bench.run(TINY, "cpu", out=out)
    return res, out.getvalue().splitlines()


def test_every_stage_fills_its_keys(line):
    res, printed = line
    assert len(printed) == len(TINY) + 1  # before the first, after each
    assert json.loads(printed[-1]) == res
    want = {"metric", "value", "unit", "backend"}
    for name, keys in bench.KEYS.items():
        want |= set(keys.values()) | {f"peak_bytes_{name}"}
    assert set(res) == want
    for k, v in res.items():
        if k.startswith("peak_bytes_"):
            assert v is None  # no device memory on the CPU
        else:
            assert v is not None, k
    assert res["backend"] == "cpu"
    assert res["alive_10M"] == 8192 and res["alive_1M"] == 4096
    assert res["value"] == pytest.approx(8192 / (res["p50_frame_ms_10M"]
                                                 * 1e-3))


def test_line_before_the_first_stage_is_all_null(line):
    first = json.loads(line[1][0])
    assert {k for k, v in first.items() if v is not None} == {
        "metric", "unit", "backend"}


def test_nbody_stage_guards_hold(line):
    res, _ = line
    assert 0 < res["nbody_1M_alive"] <= res["nbody_1M_active_rows"]
    assert res["nbody_1M_active_rows"] == 4096  # full width at this size
    assert res["nbody_1M_sharded_d1_alive"] > 0


def _tripping(monkeypatch, field, from_frame=bench.WARM_FRAMES):
    # the simulation's frame loop steps its state in place (step_into)
    inner = api.nbody.step_into

    def step_into(state, frame, *a, **k):
        stats = inner(state, frame, *a, **k)
        if frame >= from_frame:
            stats = dataclasses.replace(
                stats, **{field: torch.ones_like(getattr(stats, field))})
        return stats

    monkeypatch.setattr(api.nbody, "step_into", step_into)


def test_dropped_chunk_fails_the_stage(monkeypatch):
    _tripping(monkeypatch, "n_listed_dropped")
    with pytest.raises(RuntimeError, match="dropped neighbour chunks"):
        with pytest.warns(RuntimeWarning):
            bench.bench_nbody(1024, 4, k_long=4, reps=1, device="cpu")


def test_tail_row_alive_fails_the_stage(monkeypatch):
    _tripping(monkeypatch, "n_tail_alive")
    with pytest.raises(RuntimeError, match="beyond active prefix"):
        bench.bench_nbody(1024, 4, k_long=4, reps=1, device="cpu")


def test_moving_prefix_fails_the_stage(monkeypatch):
    inner = api.NBodySimulation._apply_bucketing

    def apply(self, alive):
        inner(self, alive)
        if self.frame > bench.WARM_FRAMES:  # a re-pick in the timed window
            self.state = api.nbody.compact_state(self.state)
            self._active = 1536

    monkeypatch.setattr(api.NBodySimulation, "_apply_bucketing", apply)
    with pytest.raises(RuntimeError, match="active prefix moved"):
        bench.bench_nbody(1024, 4, k_long=4, reps=1, device="cpu")


def test_sharded_drop_fails_the_stage(monkeypatch):
    inner = driver.make_step

    def make_step(*a, **k):
        step = inner(*a, **k)

        def dropping(state, frame):
            out, stats = step(state, frame)
            return out, dict(stats, halo_dropped=torch.ones_like(
                stats["halo_dropped"]))
        return dropping

    monkeypatch.setattr(driver, "make_step", make_step)
    with pytest.raises(RuntimeError, match="dropped particles"):
        with pytest.warns(RuntimeWarning):
            bench.bench_nbody_sharded_d1(1024, 4, k_long=4, reps=1,
                                         device="cpu")


def test_failing_stage_prints_the_line_so_far():
    def boom():
        raise ValueError("stage failed")

    out = io.StringIO()
    with pytest.raises(ValueError):
        bench.run({"cap_10m": TINY["cap_10m"], "cap_1m": boom}, "cpu",
                  out=out)
    last = json.loads(out.getvalue().splitlines()[-1])
    assert last["value"] is not None and last["p50_frame_ms_1M"] is None


def test_cli_bench_help_parses():
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        cli_main(["bench", "--help"])
    assert e.value.code == 0
    assert "bench" in out.getvalue()


def test_cli_bench_without_a_card_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["bench"])


def test_measure_ckpt_tool_tiny():
    out = measure_ckpt_10m.main(["--particles", "4096", "--grid-dim", "4",
                                 "--device", "cpu"])
    assert out["slots"] == 8192 and out["n_dropped_on_load"] == 0
    assert out["state_bytes"] == 8192 * 58  # pos, vel, acc, w, age, life,
    # alive, parent, an int64 tag; the file keeps tags as uint32
    assert out["disk_bytes"] > 8192 * 54


def test_measure_batched_run_tool_tiny():
    out = measure_batched_run.main(["--particles", "1024", "--grid-dim",
                                    "4", "--device", "cpu"])
    # every timed batch starts from the plateau checkpoint: frames 3-18
    assert out["frames"] == bench.WARM_FRAMES + measure_batched_run.BATCH
    assert len(out["driver_run_batch16_ms"]) == measure_batched_run.REPS
    assert out["active_rows"] == 2048


def test_measure_batched_run_fails_when_the_prefix_moves(monkeypatch):
    """A batch whose end re-picks the active prefix is not a plateau
    frame time: the tool raises, as the bench stage does."""
    monkeypatch.setattr(measure_batched_run.bench, "bench_nbody",
                        lambda *a, **k: {"ms": 1.0})
    pick = measure_batched_run.NBodySimulation._apply_bucketing
    last = bench.WARM_FRAMES + measure_batched_run.BATCH

    def moving(self, alive):
        pick(self, alive)
        if self.frame == last:  # the timed batch's end
            self._active = 1024

    monkeypatch.setattr(measure_batched_run.NBodySimulation,
                        "_apply_bucketing", moving)
    with pytest.raises(RuntimeError, match="prefix moved from 2048 to 1024"):
        measure_batched_run.main(["--particles", "1024", "--grid-dim", "4",
                                  "--device", "cpu"])
