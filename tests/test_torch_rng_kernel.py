"""The threefry kernel's wrapper (``ops/rng_kernel.py``) against the JAX
package, on the CPU.

On the CPU the wrapper takes its plain version (``core/rng.py``); it is held
to ``jax.random`` bit for bit, with no tolerance: every output is a discrete
function of the hash's bits.  The kernel itself (``csrc/threefry.cu``) runs
only on a card: the ``cuda``-marked test below holds it against the plain
version there, and ``chip_smoke.py`` does so at full width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesystem_tpu import NBodyConfig
from particlesystem_tpu.core import rng as jrng
from particlesystem_tpu.models import nbody as jnbody
from particlesystem_tpu_torch.core import rng as trng
from particlesystem_tpu_torch.ops import rng_kernel as rk
from particlesystem_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

EDGE_TAGS = np.array([0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
TAGS = np.concatenate([
    EDGE_TAGS, np.random.default_rng(0).integers(0, 2 ** 32, 2000, np.uint32)])
#: the bench scene's SpawnTable.total (budgets 1001 + 668 rows)
BENCH_TOTAL = 1669


def bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("frame", [0, 1, 54321])
def test_nbody_fields_match_jax(frame):
    # op by op: under jit, XLA's CPU backend contracts ``lo + u*span`` into
    # an FMA (one ulp off in ~5% of ``fert``); the port rounds each operation
    cfg = NBodyConfig()
    juvec, jfert = jnbody.frame_fields(cfg, jnp.int32(frame),
                                       jnp.asarray(TAGS))
    tuvec, tfert = rk.nbody_fields(
        cfg.seed, frame, torch.from_numpy(TAGS.astype(np.int64)),
        cfg.min_fertility_age, cfg.max_fertility_age)
    assert tuvec.shape == (len(TAGS), 3) and tfert.shape == (len(TAGS),)
    np.testing.assert_array_equal(bits(tuvec.numpy()), bits(juvec))
    np.testing.assert_array_equal(bits(tfert.numpy()), bits(jfert))


@pytest.mark.parametrize("salt", [0, 3])
def test_spawn_draws_match_jax(salt):
    seed, frame = 5, 17
    jbase = jax.random.fold_in(jrng.frame_key(seed, jnp.int32(frame),
                                              jrng.EMIT), salt)
    tbase = trng.FrameKey(seed, trng.EMIT).fold(salt)
    u, dirs = rk.flat_fields([rk.u01(tbase, (BENCH_TOTAL, 8)),
                              rk.unit_vectors(tbase.fold(1), BENCH_TOTAL)],
                             frame, "cpu")
    ju = jax.random.uniform(jbase, (BENCH_TOTAL, 8), jnp.float32)
    jd = jrng.random_unit_vectors(jax.random.fold_in(jbase, 1), BENCH_TOTAL)
    np.testing.assert_array_equal(bits(u.numpy()), bits(ju))
    np.testing.assert_array_equal(bits(dirs.numpy()), bits(jd))


def test_affine_draw_matches_jax():
    cfg = NBodyConfig()
    jk = jax.random.split(jrng.frame_key(cfg.seed, jnp.int32(0),
                                         jrng.FILL), 4)[2]
    tk = trng.FrameKey(cfg.seed, trng.FILL).fold(2)
    (age,) = rk.flat_fields([rk.uniform(tk, (777,), cfg.min_adult_age,
                                        cfg.max_adult_age)], 0, "cpu")
    ja = jrng.uniform(jk, (777,), cfg.min_adult_age, cfg.max_adult_age)
    np.testing.assert_array_equal(bits(age.numpy()), bits(ja))


def test_cpu_takes_the_plain_version():
    before = cuda_build.launches()
    tags = torch.from_numpy(TAGS[:64].astype(np.int64))
    got = rk.nbody_fields(1, 2, tags, 0.5, 4.0)
    want = rk.nbody_fields_plain(1, 2, tags, 0.5, 4.0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    draws = [rk.u01(trng.FrameKey(1, 2), (5, 8)),
             rk.unit_vectors(trng.FrameKey(3, 4, (1,)), 5),
             rk.uniform(trng.FrameKey(5, 6, (7, 8)), (7,), 0.25, 2.0)]
    for a, b in zip(rk.flat_fields(draws, 9, "cpu"),
                    rk.flat_fields_plain(draws, 9, "cpu")):
        assert torch.equal(a, b)
    after = cuda_build.launches()
    for name in ("ps_nbody_frame_fields", "ps_flat_fields"):
        assert after.get(name, 0) == before.get(name, 0), name


def test_wrapper_refuses_what_the_kernel_does_not_take():
    key = trng.FrameKey(1, 2)
    with pytest.raises(ValueError, match="no threefry kernel"):
        rk.nbody_fields(1, 2, torch.zeros(4, dtype=torch.int64,
                                          device="meta"), 0.0, 1.0)
    with pytest.raises(ValueError, match="no threefry kernel"):
        rk.flat_fields([rk.u01(key, (4,))], 0, "meta")
    with pytest.raises(ValueError, match="int64"):
        rk.nbody_fields(1, 2, torch.zeros(4, dtype=torch.int32), 0.0, 1.0)
    with pytest.raises(ValueError, match="2\\^32"):
        rk.flat_fields_plain([rk.unit_vectors(key, 1 << 31)], 0, "cpu")
    with pytest.raises(ValueError, match="draws"):
        rk.flat_fields_plain([rk.u01(key, (4,))] * 5, 0, "cpu")
    with pytest.raises(ValueError, match="FrameKey"):
        rk.flat_fields_plain([rk.u01((1, 2), (4,))], 0, "cpu")
    with pytest.raises(ValueError, match="at most 2 words"):
        key.fold(1).fold(2).fold(3)
    with pytest.raises(ValueError, match="0-dim int64"):
        rk.frame_on(torch.zeros((1,), dtype=torch.int64), torch.device("cpu"))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py phase 13 checks the "
                    "same on the card at full width)")
    cfg = NBodyConfig()
    tags = torch.from_numpy(TAGS.astype(np.int64))
    for frame in (0, 54321):
        got = rk.nbody_fields_cuda(cfg.seed, frame, tags.cuda(),
                                   cfg.min_fertility_age,
                                   cfg.max_fertility_age)
        want = rk.nbody_fields_plain(cfg.seed, frame, tags,
                                     cfg.min_fertility_age,
                                     cfg.max_fertility_age)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu().view(torch.int32),
                               b.view(torch.int32))
    draws = [rk.u01(trng.FrameKey(9, 10), (BENCH_TOTAL, 8)),
             rk.unit_vectors(trng.FrameKey(11, 12, (3, 1)), BENCH_TOTAL),
             rk.uniform(trng.FrameKey(13, 14, (2,)), (333,),
                        cfg.min_adult_age, cfg.max_adult_age)]
    for frame in (0, 54321):
        frame_t = torch.tensor(frame, dtype=torch.int64, device="cuda")
        for a, b in zip(rk.flat_fields_cuda(draws, frame_t, "cuda"),
                        rk.flat_fields_plain(draws, frame, "cpu")):
            assert torch.equal(a.cpu().view(torch.int32),
                               b.view(torch.int32))
