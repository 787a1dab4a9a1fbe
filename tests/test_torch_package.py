"""Package-level checks of the PyTorch port.

The port imports neither JAX nor the JAX package, its config copy is the
JAX config field for field, its kernel wrappers take the plain version for
CPU tensors without counting a launch, and a CUDA device without a card
raises instead of running on the CPU.  The ``cuda`` test runs the kernel
against its plain version on a card and skips where there is none.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import pytest
import torch

import particlesystem_tpu.core.config as jconfig
import particlesystem_tpu_torch
import particlesystem_tpu_torch.core.config as tconfig
import particlesystem_tpu_torch.ops.neighbor_blocks as tnbk
from particlesystem_tpu_torch.__main__ import main as cli_main
from particlesystem_tpu_torch.api import NBodySimulation
from particlesystem_tpu_torch.models import nbody as tnbody
from particlesystem_tpu_torch.ops.grid import coords_to_cell, wrap_positions
from particlesystem_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

PKG = pathlib.Path(particlesystem_tpu_torch.__file__).parent
REPO = PKG.parent


def _module(path):
    parts = (PKG.name,) + path.relative_to(PKG).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


MODULES = sorted(_module(p) for p in PKG.rglob("*.py"))


def test_scan_covers_every_module_of_the_port():
    """The two scans below walk the package: the runtime, the oracles and
    the tools are in it."""
    for name in ("cpu_ref.oracle_emitter", "cpu_ref.oracle_nbody",
                 "cpu_ref.native_emitter", "runtime.checkpoint",
                 "runtime.readback", "utils.native", "tools.probe_alu_ops",
                 "tools.probe_two_shapes", "ops.grid", "ops.neighbor"):
        assert f"{PKG.name}.{name}" in MODULES, name


def test_import_leaves_jax_out():
    code = ("import sys, importlib\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'particlesystem_tpu' or "
            "m.startswith('particlesystem_tpu.')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sources_import_no_jax():
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "particlesystem_tpu"), \
                    f"{path}: imports {name}"


def test_ops_leave_the_frame_loop_out():
    """The kernels' wrappers launch and count through ``utils/cuda_build``
    alone: no module under ``ops/`` knows of the frame loop above it."""
    for path in (PKG / "ops").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [f"{node.module or ''}.{a.name}" for a in node.names]
            for name in names:
                assert "frame_graph" not in name, f"{path}: imports {name}"


def test_launch_raises_naming_the_entry_point(monkeypatch):
    """A nonzero CUDA error code raises, naming the entry point and the
    code, and counts no launch (a fake entry point: no card needed)."""
    monkeypatch.setattr(cuda_build, "_entry", lambda name: lambda *a: 700)
    monkeypatch.setattr(cuda_build, "current_stream_handle", lambda i: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    before = cuda_build.launches().get("ps_fake_entry", 0)
    with pytest.raises(RuntimeError, match="ps_fake_entry.*CUDA error 700"):
        cuda_build.launch("ps_fake_entry", torch.device("cuda", 0), 1, 2)
    assert cuda_build.launches().get("ps_fake_entry", 0) == before
    with pytest.raises(ValueError, match="ps_fake_entry.*CUDA device"):
        cuda_build.launch("ps_fake_entry", torch.device("cpu"))


def test_dispatch_names_the_op_on_another_device():
    cuda, plain = object(), object()
    assert cuda_build.by_device(torch.zeros(1), "fake kernel", cuda,
                                plain) is plain
    assert cuda_build.by_device("cuda:1", "fake kernel", cuda, plain) is cuda
    with pytest.raises(ValueError, match="no fake kernel for device meta"):
        cuda_build.by_device(torch.zeros(1, device="meta"), "fake kernel",
                             cuda, plain)


CONFIG_CASES = [
    lambda m: m.NBodyConfig(),
    lambda m: m.NBodyConfig(n_fill=20_000, capacity=32768,
                            grid=m.GridSpec(grid_dim=16), seed=3),
    lambda m: m.NBodyConfig(n_fill=500, capacity=2048, particle_life=2.0,
                            grid=m.GridSpec(grid_dim=8, chunk_factor=2),
                            spawn_budget=64, fast_accum=False),
    lambda m: m.EmitterSceneConfig(
        emitters=(m.Emitter(rate=5000.0), m.Emitter(pos=(1.0, 2.0, 3.0))),
        planes=(m.PlaneCollider(),), spheres=(m.SphereCollider(),)),
    lambda m: m.Emitter(),
    lambda m: m.PlaneCollider(),
    lambda m: m.SphereCollider(),
]


@pytest.mark.parametrize("case", range(len(CONFIG_CASES)))
def test_config_copy_matches_jax_config(case):
    jc, tc = CONFIG_CASES[case](jconfig), CONFIG_CASES[case](tconfig)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    props = [n for n, v in vars(type(jc)).items() if isinstance(v, property)]
    assert props == [n for n, v in vars(type(tc)).items()
                     if isinstance(v, property)]
    for name in props:
        assert getattr(jc, name) == getattr(tc, name), name
    if hasattr(jc, "grid"):
        for name in ("num_cells", "chunk_dim", "num_chunks", "half_extent"):
            assert getattr(jc.grid, name) == getattr(tc.grid, name)
    assert {f.name for f in dataclasses.fields(jc)} == \
        {f.name for f in dataclasses.fields(tc)}


def test_kernel_call_on_cpu_counts_no_launch():
    cfg = tconfig.NBodyConfig(n_fill=1500, capacity=2048, max_per_cell=48,
                              grid=tconfig.GridSpec(grid_dim=4,
                                                    chunk_factor=2), seed=3)
    st = tnbody.init_fill(cfg, "cpu")
    cell = coords_to_cell(wrap_positions(st.pos, cfg.grid)[1], cfg.grid)
    snap, chunks, *_ = tnbk.prepare(st.pos, st.age, st.w, cell, st.alive,
                                    cfg, st.tag)
    before = cuda_build.launches().get("ps_cluster_pair", 0)
    acc, gmax = tnbk.kernel_call(cfg, snap, chunks)
    assert cuda_build.launches().get("ps_cluster_pair", 0) == before == 0
    assert acc.shape == (3, 2048) and gmax.dtype == torch.int32
    assert torch.isfinite(acc).all()
    with pytest.raises(ValueError, match="CUDA tensors"):
        tnbk.cluster_pair_cuda(cfg, snap, chunks, tnbk.B, tnbk.CH)


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tconfig.NBodyConfig(n_fill=100, capacity=1024)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NBodySimulation(cfg, device="cuda")


def test_cli_nbody_runs_on_cpu(capsys):
    cli_main(["nbody", "--particles", "1500", "--grid-dim", "4",
              "--iterations", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "iter 2: alive=" in out and "step:" in out


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card: python3 "
                    "chip_smoke.py checks the same on the main path)")
    cfg = tconfig.NBodyConfig(n_fill=6000, capacity=8192, seed=13,
                              grid=tconfig.GridSpec(grid_dim=8,
                                                    chunk_factor=2))
    st = tnbody.init_fill(cfg, "cuda")
    for f in range(2):
        st, _ = tnbody.step(st, f, cfg)
    cell = coords_to_cell(wrap_positions(st.pos, cfg.grid)[1], cfg.grid)
    snap, chunks, *_ = tnbk.prepare(st.pos, st.age, st.w, cell, st.alive,
                                    cfg, st.tag)
    acc, gmax = tnbk.cluster_pair_cuda(cfg, snap, chunks, tnbk.B, tnbk.CH)
    ref_acc, ref_gmax = tnbk.cluster_pair_plain(cfg, snap, chunks, tnbk.B,
                                                tnbk.CH)
    torch.cuda.synchronize()
    assert torch.equal(gmax, ref_gmax)
    scale = max(1.0, ref_acc.abs().max().item())
    assert (acc - ref_acc).abs().max().item() / scale < 1e-5
