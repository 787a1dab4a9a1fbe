"""The port's threefry RNG against jax.random, bit for bit.

Keys, fold_in, split, uniform draws and the per-tag fields of
``particlesystem_tpu_torch/core/rng.py`` must reproduce the JAX package's
bits exactly (jax 0.9, ``jax_threefry_partitionable`` on), and the port's
``init_fill`` must give the JAX package's initial state bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesystem_tpu import GridSpec, NBodyConfig
from particlesystem_tpu.core import rng as jrng
from particlesystem_tpu.models import nbody as jnbody
from particlesystem_tpu_torch import GridSpec as TGridSpec
from particlesystem_tpu_torch import NBodyConfig as TNBodyConfig
from particlesystem_tpu_torch.core import rng as trng
from particlesystem_tpu_torch.core.state import state_to_numpy
from particlesystem_tpu_torch.models import nbody as tnbody

torch.set_num_threads(1)

PURPOSES = {"UVEC": jrng.UVEC, "FERT": jrng.FERT, "FILL": jrng.FILL}
EDGE_TAGS = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)


def port_cfg(cfg):
    """The port's copy of a JAX-package config (same fields)."""
    d = dataclasses.asdict(cfg)
    return TNBodyConfig(**{**d, "grid": TGridSpec(**d["grid"])})


def bits(a):
    return np.asarray(a).view(np.uint32)


def raw(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def test_threefry_partitionable_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("purpose", sorted(PURPOSES))
def test_key_fold_in_split_uniform_bits(purpose):
    p = PURPOSES[purpose]
    for seed in (0, 1, 12345):
        assert trng.key(seed) == raw(jax.random.key(seed))
        for frame in (0, 1, 77):
            kj = jrng.frame_key(seed, jnp.int32(frame), p)
            kt = trng.frame_key(seed, frame, p)
            assert kt == raw(kj)
            assert trng.fold_in(kt, 5) == raw(jax.random.fold_in(kj, 5))
            sj = jax.random.split(kj, 4)
            st = trng.split(kt, 4)
            assert st == [raw(k) for k in sj]
            for kjj, ktt in zip(sj, st):
                uj = jax.random.uniform(kjj, (257, 3), jnp.float32)
                ut = trng.uniform01(ktt, (257, 3), "cpu")
                np.testing.assert_array_equal(bits(uj), bits(ut))
                aj = jrng.uniform(kjj, (33,), 0.3, 7.5)
                at = trng.uniform(ktt, (33,), 0.3, 7.5, "cpu")
                np.testing.assert_array_equal(bits(aj), bits(at))


@pytest.mark.parametrize("purpose", sorted(PURPOSES))
def test_per_tag_fields_bits(purpose):
    p = PURPOSES[purpose]
    rand = np.random.default_rng(1).integers(0, 2 ** 32, 500, np.uint32)
    tags = np.concatenate([EDGE_TAGS, rand])
    tt = torch.from_numpy(tags.astype(np.int64))
    for frame in (0, 9):
        kj = jrng.frame_key(3, jnp.int32(frame), p)
        kt = trng.frame_key(3, frame, p)
        # per-tag keys: vmap(fold_in) over the tags
        kdj = np.asarray(jax.vmap(
            lambda t: jax.random.key_data(jax.random.fold_in(kj, t)))(
                jnp.asarray(tags)))
        k1, k2 = trng.fold_in(kt, tt)
        np.testing.assert_array_equal(kdj[:, 0], k1.numpy())
        np.testing.assert_array_equal(kdj[:, 1], k2.numpy())
        np.testing.assert_array_equal(
            bits(jrng._per_tag_u01(kj, jnp.asarray(tags), 3)),
            bits(trng._per_tag_u01(kt, tt, 3)))
        np.testing.assert_array_equal(
            bits(jrng.per_tag_unit_vectors(kj, jnp.asarray(tags))),
            bits(trng.per_tag_unit_vectors(kt, tt)))
        np.testing.assert_array_equal(
            bits(jrng.per_tag_uniform(kj, jnp.asarray(tags), 2.5, 30.0)),
            bits(trng.per_tag_uniform(kt, tt, 2.5, 30.0)))


def test_tag_mix_matches_jax():
    rand = np.random.default_rng(2).integers(0, 2 ** 32, 4000, np.uint32)
    tags = np.concatenate([EDGE_TAGS, rand])
    for frame in (0, 1, 12345, 2 ** 31 - 1):
        mj = np.asarray(jrng.tag_mix(jnp.asarray(tags), jnp.int32(frame)))
        mt = trng.tag_mix(torch.from_numpy(tags.astype(np.int64)), frame)
        assert mt.min() >= 0 and mt.max() < 2 ** 32
        np.testing.assert_array_equal(mj.astype(np.int64), mt.numpy())


def test_init_fill_bit_exact():
    cfg = NBodyConfig(n_fill=3000, capacity=4096, grid=GridSpec(grid_dim=8),
                      seed=11)
    sj = jnbody.init_fill(cfg)
    st = state_to_numpy(tnbody.init_fill(port_cfg(cfg), "cpu"))
    for f in ("pos", "vel", "acc", "w", "age", "life", "alive", "parent",
              "tag"):
        a = np.asarray(getattr(sj, f))
        assert a.dtype == st[f].dtype, f
        np.testing.assert_array_equal(a.view(np.uint8), st[f].view(np.uint8),
                                      err_msg=f)
