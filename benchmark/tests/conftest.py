"""Tiny cells for the CPU: each edit shrinks a cell's configuration and
traffic to a size the plain versions step in seconds."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_nbody(ctx):
    ctx.config = dict(ctx.config, n_fill=2048,
                      grid=dict(grid_dim=8, cell_size=5.0, chunk_factor=4))
    ctx.mix = dict(ctx.mix, warm_runs=0, states=1)
    ctx.check = dict(ctx.check, sample_from=1, sample=1)


def tiny_emitter(ctx):
    ctx.config = dict(ctx.config, capacity=16384)
    ctx.mix = dict(ctx.mix, setup_frames=40, frames=8)
    ctx.check = dict(ctx.check, sample_from=1, sample=1)


def tiny(cell: str):
    return tiny_emitter if cell.startswith("emitter") else tiny_nbody


@pytest.fixture(scope="session")
def bench():
    from benchmark import harness
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
