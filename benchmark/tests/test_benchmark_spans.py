"""The readers of the port's spans on the CPU: a traced tiny run of each
cell reports its span metrics, each idle metric within the window's idle,
and the readers read nothing untraced or where the port records no span."""

import importlib

import pytest
import torch

from benchmark import harness

from .conftest import tiny
from .test_benchmark_harness import CELLS, run_tiny

SPAN_METRICS = ("nbody_idle_in_program_us_per_run", "nbody_replay_host_us",
                "emitter_idle_in_program_us_per_batch")


def idle_metric(cell):
    return ("emitter" if cell.startswith("emitter") else "nbody") \
        + "_device_idle_pct"


def listed(bench, cell):
    return [m["name"] for m in bench["per_layer"]
            if m["name"] in SPAN_METRICS and cell in m["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_tiny_run_reports_its_span_metrics(bench, cell):
    result, _ = run_tiny(bench, cell, traced=True)
    names = listed(bench, cell)
    assert names
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(names) <= set(m)
    runs = result["attempted"] - result["failed"]
    window_us = result["device"]["window_s"] * 1e6
    idle_us = m[idle_metric(cell)] / 100 * window_us / runs
    for name in names:
        assert m[name] >= 0, name
        if "_idle_" in name:
            assert m[name] <= idle_us * (1 + 1e-9), name


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_readers_read_nothing_untraced(bench, name):
    cell = "emitter10m_batch" if name.startswith("emitter") else CELLS[0]
    ctx = harness.prepare(bench, cell, 1, 1.0, False, torch.device("cpu"))
    tiny(cell)(ctx)
    ctx.attempted = 3
    reader = importlib.import_module(f"benchmark.metrics.{name}")
    assert reader.read(ctx) is None


def test_readers_read_nothing_where_the_port_records_no_span(bench,
                                                             monkeypatch):
    from particlesystem_tpu_torch.utils import timers
    monkeypatch.delattr(timers, "spans")
    result, _ = run_tiny(bench, "emitter10m_batch", traced=True)
    assert not set(SPAN_METRICS) & set(result["metrics"])
    assert "emitter_device_idle_pct" in result["metrics"]
