"""The probes' plain versions against the JAX tools' Pallas kernels, on the
CPU, and the kernels against their plain versions on a card.

The JAX kernels run in interpret mode: ``tools/probe_vpu_ops._kernel``
inside a ``pl.pallas_call(..., interpret=True)`` built here at a (16, 128)
tile and ``k = 4``; ``tools/probe_same_pallas_two_sigs``'s ``pallas_fixed``
and ``pallas_var`` interpret by themselves off the TPU.  Inputs come from a
numpy seed, uniform in [-1, 2), so that compares, selects and the ``x < c``
test go both ways.  Tolerances:

* ``cmp``, ``select``, ``and2``, ``mul``: exact (no arithmetic that could
  round in two ways, and no compare of these inputs lies at a tie);
* ``fma``, ``chain16``, ``chainmix16``: ``rtol = 1e-5`` (the plain version
  rounds ``t * c + x`` once, as the card's FFMA does; XLA on the CPU may
  round twice, an ulp a multiply-add; ``chainmix16`` takes its multiply-add
  on negative lanes only, once, after which ``a > x`` stays false, so no
  compare can flip);
* ``rsqrt``: ``rtol = 1e-5``, NaN where ``t + x`` is negative in both;
* ``x * 2 + 1``: exact.

The kernel-against-plain tests carry the ``cuda`` marker and skip where
torch sees no card (``chip_smoke.py`` phase 8 makes the same comparison).
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from particlesystem_tpu_torch.tools import probe_alu_ops, probe_two_shapes
from particlesystem_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
K = 4
TILE = (16, 128)
RTOL = {"fma": 1e-5, "chain16": 1e-5, "chainmix16": 1e-5, "rsqrt": 1e-5}


def _load_tool(name):
    """Import ``tools/<name>.py`` by path; the compile-cache settings the
    tool makes at import are put back, so that other tests of this process
    run as they would without it."""
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(f"_tool_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in keep.items():
            jax.config.update(k, v)
    return mod


vpu = _load_tool("probe_vpu_ops")
sigs = _load_tool("probe_same_pallas_two_sigs")


def _tile(seed=0):
    return np.random.default_rng(seed).uniform(-1.0, 2.0, TILE).astype(
        np.float32)


def test_variants_and_constants_match_the_jax_tool():
    assert probe_alu_ops.VARIANTS == vpu.VARIANTS
    assert (probe_alu_ops.B, probe_alu_ops.CH) == (vpu.B, vpu.CH)
    assert (probe_alu_ops.K1, probe_alu_ops.K2) == (vpu.K1, vpu.K2)
    assert probe_alu_ops.REPS == vpu.G
    assert np.float32(probe_alu_ops.C) == np.float32(1.0000001)
    assert set(probe_alu_ops.OPS) == set(vpu.VARIANTS)
    np.testing.assert_array_equal(
        probe_alu_ops.tile("cpu").numpy(),
        np.random.default_rng(0).random((vpu.B, vpu.CH), np.float32))
    assert (probe_two_shapes.CAP, probe_two_shapes.ROWS) == (sigs.CAP, 16)


@pytest.mark.parametrize("variant", probe_alu_ops.VARIANTS)
def test_probe_layers_plain_matches_the_pallas_kernel(variant):
    x = _tile()
    want = np.asarray(pl.pallas_call(
        functools.partial(vpu._kernel, variant, K),
        out_shape=jax.ShapeDtypeStruct(TILE, jnp.float32),
        interpret=True)(jnp.asarray(x)))
    got = probe_alu_ops.probe_layers(variant, K, torch.tensor(x))
    assert got.dtype == torch.float32 and got.shape == TILE
    got = got.numpy()
    if variant in RTOL:
        np.testing.assert_allclose(got, want, rtol=RTOL[variant], atol=0,
                                   equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)
    if variant == "rsqrt":
        assert np.isnan(want).any() and np.isfinite(want).any()
    else:
        assert np.isfinite(want).all()
        # the layers did something, and not the same thing everywhere
        assert len(np.unique(want / x)) > 1


def test_probe_layers_depend_on_k_and_reject_misuse():
    x = torch.tensor(_tile(1))
    assert torch.equal(probe_alu_ops.probe_layers_plain("fma", 0, x), x * 0.5)
    assert not torch.equal(probe_alu_ops.probe_layers_plain("fma", 1, x),
                           probe_alu_ops.probe_layers_plain("fma", 2, x))
    before = cuda_build.launches().get("ps_probe_alu_ops", 0)
    probe_alu_ops.probe_layers("chain16", 2, x)
    assert cuda_build.launches().get("ps_probe_alu_ops", 0) == before
    with pytest.raises(ValueError, match="unknown variant"):
        probe_alu_ops.probe_layers_plain("div", 1, x)
    with pytest.raises(ValueError, match="unknown variant"):
        probe_alu_ops.probe_layers_cuda("div", 1, x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        probe_alu_ops.probe_layers_cuda("fma", 1, x)
    with pytest.raises(ValueError, match="no probe kernel"):
        probe_alu_ops.probe_layers("fma", 1, x.to("meta"))


def test_fma_of_the_plain_version_rounds_once():
    """``a * C + x`` where rounding the product first loses the answer."""
    a = torch.tensor([1.0 + 2.0 ** -23], dtype=torch.float32)
    x = -a.clone()
    once = probe_alu_ops._fma(a, x)
    twice = a * probe_alu_ops.C + x
    exact = float(a.double() * probe_alu_ops.C + x.double())
    assert once.item() == np.float32(exact) != twice.item()


@pytest.mark.parametrize("width", [512, 768, 1024])
def test_probe_affine_plain_matches_the_pallas_kernels(width):
    x = np.random.default_rng(width).uniform(-4.0, 4.0, (16, width)).astype(
        np.float32)
    want = np.asarray(sigs.pallas_var(jnp.asarray(x), width))
    got = probe_two_shapes.probe_affine(torch.tensor(x))
    np.testing.assert_array_equal(got.numpy(), want)
    if width == sigs.CAP:
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(sigs.pallas_fixed(jnp.asarray(x))))


@pytest.mark.parametrize("width", [512, 768])
def test_step_buckets_match_the_jax_tool(width):
    x = np.random.default_rng(width + 1).uniform(-4.0, 4.0, (16, width)
                                                 ).astype(np.float32)
    for frame in (0, 7):
        want = np.asarray(sigs.step_bucket(jnp.asarray(x), width,
                                           jnp.int32(frame)))
        want_var = np.asarray(sigs.step_bucket_var(jnp.asarray(x), width,
                                                   jnp.int32(frame)))
        got = probe_two_shapes.step_bucket(torch.tensor(x), frame)
        got_var = probe_two_shapes.step_bucket_var(torch.tensor(x), frame)
        assert got.shape == got_var.shape == (16, width)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got_var.numpy(), want_var)


def test_two_shapes_run_checks_every_result(capsys, monkeypatch):
    before = cuda_build.launches().get("ps_probe_affine", 0)
    assert probe_two_shapes.run("cpu") == 2 * probe_two_shapes.FRAMES
    out = capsys.readouterr().out
    assert "bucket A (512) launched twice: ok" in out
    assert "bucket B (768) launched twice: ok" in out
    assert cuda_build.launches().get("ps_probe_affine", 0) == before
    # a wrong kernel result is caught
    monkeypatch.setattr(probe_two_shapes, "probe_affine",
                        lambda x: x * 2.0 + 1.5)
    with pytest.raises(AssertionError, match="expected 3.0"):
        probe_two_shapes.run("cpu")


def test_affine_wrapper_rejects_misuse():
    with pytest.raises(ValueError, match="CUDA tensor"):
        probe_two_shapes.probe_affine_cuda(torch.zeros((16, 512)))
    with pytest.raises(ValueError, match="no affine kernel"):
        probe_two_shapes.probe_affine(torch.zeros((16, 512), device="meta"))
    assert cuda_build.launches().get("ps_probe_affine", 0) == 0 or \
        torch.cuda.is_available()


def test_tools_need_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert probe_alu_ops.main([]) == 1
    assert probe_two_shapes.main([]) == 1
    err = capsys.readouterr().err
    assert err.count("torch sees no CUDA device") == 2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card: python3 "
                    "chip_smoke.py phase 8 makes the same comparison)")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", probe_alu_ops.VARIANTS)
def test_cuda_probe_kernel_matches_plain(variant):
    _need_card()
    x = probe_alu_ops.tile("cuda")
    before = cuda_build.launches().get("ps_probe_alu_ops", 0)
    got = probe_alu_ops.probe_layers(variant, 8, x)
    want = probe_alu_ops.probe_layers_plain(variant, 8, x)
    torch.cuda.synchronize()
    assert cuda_build.launches()["ps_probe_alu_ops"] == before + 1
    if variant == "rsqrt":   # MUFU.RSQ: 2 ulp
        torch.testing.assert_close(got, want, rtol=2e-6, atol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [512, 768, 1024])
def test_cuda_affine_kernel_matches_plain(width):
    _need_card()
    x = torch.tensor(np.random.default_rng(width).uniform(
        -4.0, 4.0, (16, width)).astype(np.float32), device="cuda")
    got = probe_two_shapes.probe_affine(x)
    torch.cuda.synchronize()
    assert torch.equal(got, probe_two_shapes.probe_affine_plain(x))
