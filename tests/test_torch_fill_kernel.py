"""The n-body fill kernel's host half (``models/nbody.fill_args``,
``ops/rng_kernel.nbody_fill_cuda``) and ``init_fill``'s dispatch, on the
CPU.

``ps_nbody_fill`` (``csrc/threefry.cu``) writes a whole fresh state from a
handful of scalars.  Here those scalars are held to ``fill_draws`` and to
the configuration, and the kernel's arithmetic, written out in plain
torch from the scalars alone, is held bit for bit to ``init_fill`` on the
CPU, which ``tests/test_torch_nbody.py`` holds to the JAX package.  The
kernel itself runs only on a card: the ``cuda``-marked test below holds it
to the CPU fill there, and ``chip_smoke.py`` phase 13 does so at full
width.  This file imports no JAX, so the card's machine can run that test
by calling it: ``python3 -c "import sys; sys.path[:0] = ['.', 'tests'];
import test_torch_fill_kernel as t;
t.test_cuda_fill_is_the_cpu_fill_in_one_launch()"``.
"""

import numpy as np
import pytest
import torch

from particlesystem_tpu_torch import GridSpec as TGridSpec
from particlesystem_tpu_torch import NBodyConfig as TNBodyConfig
from particlesystem_tpu_torch.core import rng
from particlesystem_tpu_torch.core.state import FIELDS
from particlesystem_tpu_torch.models import nbody
from particlesystem_tpu_torch.ops import rng_kernel as rk
from particlesystem_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

SEEDS = [0, 7, 42, (1 << 33) + 5, (1 << 31) + 12345]
#: a small capacity that is no multiple of the kernel's four slots a thread
SMALL = dict(n_fill=700, capacity=1001, seed=11,
             grid=dict(grid_dim=4, cell_size=5.0, chunk_factor=2))


def small_cfg(**kw):
    d = {**SMALL, **kw}
    return TNBodyConfig(**{**d, "grid": TGridSpec(**d["grid"])})


def bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


def f32(x) -> float:
    return float(np.float32(x))


@pytest.mark.parametrize("seed", SEEDS)
def test_fill_args_follow_the_draws_and_the_config(seed):
    cfg = TNBodyConfig(seed=seed)
    for n in (0, 1, 4097, cfg.n_fill, cfg.slots):
        a = nbody.fill_args(cfg, n)
        draws = nbody.fill_draws(cfg, n)
        # the config: the FILL purpose key of the seed, split indices 0-3
        assert a.key == rng._purpose_key(seed, rng.FILL)
        assert a.key == rng.fold_in(rng.key(seed), rng.FILL)
        assert a.words == (0, 1, 2, 3)
        assert (a.n, a.slots) == (n, cfg.slots)
        assert a.half_extent == f32(cfg.grid.half_extent)
        assert a.weight == f32(cfg.weight)
        assert a.age == (f32(cfg.min_adult_age),
                         f32(cfg.max_adult_age - cfg.min_adult_age))
        assert a.life == (f32(cfg.min_fertility_age),
                          f32(cfg.max_fertility_age - cfg.min_fertility_age))
        # the draws: one purpose key, one word each, the kernel's counters
        # (3 a particle for r and u_sign, 1 for age and life)
        for d, word in zip(draws, a.words, strict=True):
            assert (d.key.seed, d.key.purpose) == (seed, rng.FILL)
            assert d.key.purpose_key == a.key and d.key.words == (word,)
        assert [(d.kind, d.shape) for d in draws] == [
            (rk.UNIT, (n, 3)), (rk.UNIT, (n, 3)), (rk.AFFINE, (n,)),
            (rk.AFFINE, (n,))]
        # the ranges as flat_fields_cuda packs them
        packed = np.asarray([(d.lo, d.hi - d.lo) for d in draws[2:]],
                            np.float32)
        assert (a.age, a.life) == tuple(tuple(map(float, p)) for p in packed)


def kernel_model(a: rk.Fill) -> dict:
    """``ps_nbody_fill``'s arithmetic in plain torch, from its scalars
    alone: the keys ``fold_in(fold_in(key, 0), word)``, element ``q`` of a
    draw at counter ``q``, ``pos = (sign * r) * half_extent``, ``lo +
    u*span``, every slot from ``n`` on zero and dead, ``tag[i] = i``."""
    base = rng.fold_in(a.key, 0)
    kr, ks, ka, kf = (rng.fold_in(base, w) for w in a.words)
    n, slots = a.n, a.slots
    r = rng.uniform01(kr, (n, 3), "cpu")
    u = rng.uniform01(ks, (n, 3), "cpu")
    half = torch.tensor(a.half_extent, dtype=torch.float32)
    pos = torch.zeros((slots, 3))
    pos[:n] = torch.where(u >= 0.5, r, -r) * half

    def affine(k, lo_span):
        lo, span = (torch.tensor(v, dtype=torch.float32) for v in lo_span)
        out = torch.zeros(slots)
        out[:n] = lo + rng.uniform01(k, (n,), "cpu") * span
        return out

    alive = torch.arange(slots) < n
    return dict(pos=pos, vel=torch.zeros((slots, 3)),
                acc=torch.zeros((slots, 3)),
                w=torch.where(alive, torch.tensor(a.weight), 0.0),
                age=affine(ka, a.age), life=affine(kf, a.life), alive=alive,
                parent=torch.zeros(slots, dtype=torch.bool),
                tag=torch.arange(slots, dtype=torch.int64))


@pytest.mark.parametrize("n", [0, 1, 4, 699, 1000, 1001])
def test_kernel_arithmetic_from_its_scalars_is_the_cpu_fill(n):
    cfg = small_cfg()
    want = nbody.init_fill(cfg, "cpu", n)
    got = kernel_model(nbody.fill_args(cfg, n))
    for f in FIELDS:
        a, b = got[f], getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=f)


def test_cpu_fill_launches_no_kernel():
    before = cuda_build.launches()
    nbody.init_fill(small_cfg(), "cpu")
    nbody.init_fill(small_cfg(), torch.device("cpu"), 3)
    after = cuda_build.launches()
    for name in ("ps_nbody_fill", "ps_flat_fields"):
        assert after.get(name, 0) == before.get(name, 0), name


def test_fill_refuses_what_it_does_not_take():
    cfg = small_cfg()
    with pytest.raises(ValueError, match="no fill for device meta"):
        nbody.init_fill(cfg, "meta")
    with pytest.raises(ValueError, match="exceeds capacity"):
        nbody.init_fill(cfg, "cpu", cfg.slots + 1)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        rk.nbody_fill_cuda(nbody.fill_args(cfg, 5), "cpu")


@pytest.mark.cuda
def test_cuda_fill_is_the_cpu_fill_in_one_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py phase 13 checks the "
                    "same on the card at full width)")
    for seed in (3, 42, (1 << 33) + 5):
        for cfg in (TNBodyConfig(seed=seed), small_cfg(seed=seed)):
            for n in sorted({min(n, cfg.slots) for n in
                             (0, 1, 4097, cfg.n_fill, cfg.slots)}):
                before = cuda_build.launches().get("ps_nbody_fill", 0)
                card = nbody.init_fill(cfg, "cuda", n)
                assert cuda_build.launches()["ps_nbody_fill"] == before + 1
                host = nbody.init_fill(cfg, "cpu", n)
                for f in FIELDS:
                    a, b = getattr(card, f).cpu(), getattr(host, f)
                    assert a.dtype == b.dtype and a.shape == b.shape, f
                    assert np.array_equal(bits(a), bits(b)), \
                        (seed, cfg.slots, n, f)
