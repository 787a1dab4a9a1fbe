"""The benchmark's own checks on the CPU: ``BENCHMARK.json`` against its
contract and the files it names, each cell's traffic through the port's
plain versions at a tiny size, the result line, and the plain reference
against the port."""

import importlib
import json
import re
import time

import pytest
import torch

from benchmark import harness

from .conftest import ROOT, tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def metric_names(bench):
    return [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]


def test_top_level_keys_and_paths(bench):
    assert set(bench) == TOP
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert all(LINE.match(w) for w in bench["command"])
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_unique_and_allowed(bench, kind):
    names = [x["name"] for x in bench[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_name_their_files(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        used = [w for w in bench["workloads"] if w["config"] == c["name"]]
        assert used, f"{c['name']} has no cell"


def test_cells_find_their_files(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = harness.load_json(harness.HERE / "traffic"
                                / f"{w['traffic']}.json")
        importlib.import_module(f"benchmark.drivers.{mix['driver']}")
        check = harness.load_json(harness.HERE / "workloads"
                                  / f"{w['name']}.json")
        assert check["limits"] and all(v > 0 for v in
                                       check["limits"].values())


def test_metrics_find_their_readers(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
        assert callable(reader.read)
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in metric_names(bench)


def test_per_layer_metrics_move_what_their_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert LINE.match(m["layer"])
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])
    for w in bench["workloads"]:
        names = harness.cell_metrics(bench, w["name"], False)
        assert "setup_s" in [m["name"] for m in names] and len(names) >= 2
        assert harness.cell_metrics(bench, w["name"], True)


def test_roofline_names_carry_a_percent(bench):
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


CELLS = ["nbody1m_refill10", "nbody1m_resume", "emitter10m_batch"]


def run_tiny(bench, cell, traced=False, hook=None):
    return harness.run_cell(bench, cell, 2 ** 31 + 12345, 0.05, traced,
                            torch.device("cpu"), time.perf_counter(),
                            edit=tiny(cell), driver_hook=hook)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_tiny_and_agrees_with_the_reference(bench, cell):
    result, checks = run_tiny(bench, cell)
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert checks and all(v <= lim for _, v, lim in checks)
    assert result["correct"] is True
    names = {m["name"] for m in harness.cell_metrics(bench, cell, False)}
    assert set(result["metrics"]) == names


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(bench, traced):
    result, _ = run_tiny(bench, "emitter10m_batch", traced)
    keys = list(result)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[:5] == want and keys[-1] == "checks"
    assert set(keys) == set(want) | {"checks"} | (
        {"breakdown"} if traced else set())
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        b = result["breakdown"]
        assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    json.dumps(result)


def test_no_card_exits_without_a_result(capsys):
    from benchmark import run
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "nbody1m_refill10", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_seeds_of_runs_are_distinct():
    from benchmark.drivers.nbody_runs import run_seed
    seeds = {run_seed(s, i) for s in (2 ** 31 + 5, 2 ** 31 + 6)
             for i in range(-1004, 1000)}
    assert len(seeds) == 2 * 2004
