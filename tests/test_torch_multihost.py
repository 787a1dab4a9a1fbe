"""The port's launcher path on the CPU: ranks that are separate OS
processes, joined only by the ``PSTPU_*`` variables.

* One launch of ``particlesystem_tpu_torch.tools.multihost_worker`` on 8
  processes in two nodes of ``LOCAL_WORLD_SIZE=4`` runs slab 8, pencil
  (4, 2) and brick (2, 2, 2) over hybrid meshes whose "x" axis crosses the
  node seam, and is held as ``tests/test_multihost.py`` holds the JAX
  package's: identical statistics on every rank, equal to the JAX
  single-device trajectory for 3 frames, no drop, ``validate`` matching
  the oracle, each rank writing and reading only its own checkpoint rows.
* Two launches of the CLI, ``nbody --devices 2 --device cpu --validate
  --save``, run at once on distinct ports: each validates in a scratch
  directory of its own next to its ``--save``, removed after the run.
* The launcher's backend and local rank, with ``torch.cuda.is_available``
  patched to True: ``--device cpu`` and ``cuda:0`` take gloo, ``cuda``
  takes NCCL on the card of the rank's place in its node.
"""

import json
import os
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from particlesystem_tpu import GridSpec as JGridSpec
from particlesystem_tpu import NBodyConfig as JNBodyConfig
from particlesystem_tpu.models import nbody as jnbody
from particlesystem_tpu.parallel import nbody_brick as jbrick
from particlesystem_tpu.parallel import nbody_pencil as jpencil
from particlesystem_tpu.parallel import nbody_sharded as jslab
from particlesystem_tpu_torch.__main__ import main as cli_main
from particlesystem_tpu_torch.parallel import mesh as meshmod

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT = 300.0

# tools/multihost_worker.py:44-48 of the JAX package, as the port's worker
# runs it
JCFG = JNBodyConfig(
    n_fill=2000, capacity=8192,
    grid=JGridSpec(grid_dim=16, cell_size=5.0, chunk_factor=4),
    particle_life=3.0, seed=11)
JSPECS = {"slab": (jslab, jslab.SlabSpec(n_devices=8)),
          "pencil": (jpencil, jpencil.PencilSpec(d3=4, d1=2)),
          "brick": (jbrick, jbrick.BrickSpec(d3=2, d1=2, d2=2))}
EVENTS = ("n_alive", "n_age_deaths", "n_collision_kills", "n_survivals",
          "n_spawned")


def launch(argv, n, logdir, tag, env=None):
    """Start ``python argv`` as ``n`` ranks under the ``PSTPU_*``
    variables, each writing its output to ``logdir``; returns the
    processes and their log paths."""
    port = meshmod.free_port()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("PSTPU_", "LOCAL_"))}
    base.update(OMP_NUM_THREADS="1", **(env or {}))
    procs = []
    for pid in range(n):
        out = os.path.join(logdir, f"{tag}_{pid}.out")
        err = os.path.join(logdir, f"{tag}_{pid}.err")
        with open(out, "w") as fo, open(err, "w") as fe:
            procs.append((subprocess.Popen(
                [sys.executable, *argv], cwd=REPO, stdout=fo, stderr=fe,
                env=dict(base, PSTPU_COORDINATOR=f"127.0.0.1:{port}",
                         PSTPU_NUM_PROCESSES=str(n),
                         PSTPU_PROCESS_ID=str(pid))), out, err))
    return procs


def wait(procs, timeout=LAUNCH_TIMEOUT):
    """Wait for every process (all are killed when one fails or the time
    runs out); returns their standard outputs."""
    deadline = time.monotonic() + timeout
    try:
        for p, _, err in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
            if p.returncode != 0:
                with open(err) as f:
                    raise AssertionError(f"rank failed ({p.returncode}):\n"
                                         f"{f.read()[-4000:]}")
    finally:
        for p, _, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    outs = []
    for _, out, _ in procs:
        with open(out) as f:
            outs.append(f.read())
    return outs


@jax.jit
def _jax_step(state, frame):
    uvec, fert = jnbody.frame_fields(JCFG, frame, state.tag)
    return jnbody.step_fields(state, uvec, fert, frame, JCFG)


def jax_trajectory(name):
    """The JAX single-device statistics of 3 frames on the decomposition's
    slot arrangement."""
    mod, spec = JSPECS[name]
    ss, dropped = mod.distribute(jnbody.init_fill(JCFG), JCFG, spec)
    assert dropped == 0
    out = []
    for frame in range(3):
        ss, st = _jax_step(ss, jnp.int32(frame))
        out.append({k: int(getattr(st, k)) for k in EVENTS})
    return out


def records(outs, kind, name):
    """Each rank's JSON record of ``kind`` for decomposition ``name``."""
    got = []
    for text in outs:
        lines = [l for l in text.splitlines()
                 if l.startswith(f"{kind} {name} ")]
        assert len(lines) == 1, text
        got.append(json.loads(lines[0][len(kind) + len(name) + 2:]))
    return got


@pytest.fixture(scope="module")
def worker_run(tmp_path_factory):
    """One 8-process launch of the worker for all three decompositions;
    the JAX references are computed while it runs.  Returns (outputs,
    {decomposition: JAX statistics})."""
    d = tmp_path_factory.mktemp("multihost")
    procs = launch(["-m", "particlesystem_tpu_torch.tools.multihost_worker",
                    "--device", "cpu"], 8, str(d), "worker",
                   env={"LOCAL_WORLD_SIZE": "4", "TMPDIR": str(d)})
    try:
        ref = {name: jax_trajectory(name) for name in JSPECS}
    finally:
        outs = wait(procs)
    leftover = [f for f in os.listdir(d) if not f.startswith("worker_")]
    assert not leftover, f"scratch left behind: {leftover}"
    return outs, ref


@pytest.mark.parametrize("name", list(JSPECS))
def test_worker_across_the_node_seam(name, worker_run):
    outs, ref = worker_run
    stats = records(outs, "STATS", name)
    assert all(s == stats[0] for s in stats)  # one global view
    for frame, want in enumerate(ref[name]):
        got = stats[0][frame]
        assert {k: got[k] for k in EVENTS} == want, (frame, got, want)
        assert got["halo_dropped"] == got["migration_dropped"] == 0
        assert got["n_listed_dropped"] == got["n_spawn_capped"] == 0

    drv = records(outs, "DRIVER", name)
    for d in drv:
        assert d["events_match"] and d["max_dev"] < 1e-3 and d["alive"] > 0
    assert len({(d["alive"], d["digest"]) for d in drv}) == 1

    ck = records(outs, "SHARDCKPT", name)
    rows = sorted(c["rows"] for c in ck)
    c_local = JCFG.slots // 8
    assert rows == [[i * c_local, (i + 1) * c_local] for i in range(8)]
    for c in ck:
        assert c["ok"] and c["n_shard_files"] == 8
        # its own rows only: about an eighth of the state
        assert 0 < c["my_bytes"] < 0.2 * c["global_bytes"]


def test_cli_validate_runs_side_by_side(tmp_path):
    """Two 2-rank CLI runs at once: distinct scratch directories next to
    their --save, both gone after the run, nothing in the temp dir."""
    runs = tmp_path / "runs"
    runs.mkdir()
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    launches = [launch(["-m", "particlesystem_tpu_torch", "nbody",
                        "--devices", "2", "--device", "cpu",
                        "--particles", "2000", "--grid-dim", "16",
                        "--iterations", "3", "--validate",
                        "--save", str(runs / tag)], 2, str(tmp_path), tag,
                       env={"TMPDIR": str(tmp)})
                for tag in ("a", "b")]
    scratch = []
    for procs in launches:
        text = wait(procs)[0]
        m = re.search(r"validate \(rank 0's rows, scratch (\S+)\): "
                      r"(\{.*\})", text)
        assert m, text
        assert "'events_match': True" in m.group(2), text
        scratch.append(m.group(1))
    assert scratch[0] != scratch[1]
    assert all(os.path.dirname(s) == str(runs) for s in scratch)
    assert sorted(os.listdir(runs)) == ["a", "b"]
    assert not os.listdir(tmp)
    for tag in ("a", "b"):
        assert sorted(os.listdir(runs / tag)) == [
            "meta.json", "shard_p00000.npz", "shard_p00001.npz"]


class _Joined(Exception):
    pass


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"),
                                            ("cuda:0", "gloo"),
                                            ("cuda", "nccl")])
def test_cli_launcher_backend_follows_device(device, backend, monkeypatch):
    seen = {}

    def init(backend, init_method, world_size, rank, timeout):
        seen.update(backend=backend, world_size=world_size, rank=rank)
        raise _Joined

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setenv("PSTPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("PSTPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("PSTPU_PROCESS_ID", "1")
    with pytest.raises(_Joined):
        cli_main(["nbody", "--devices", "2", "--device", device,
                  "--particles", "2000", "--iterations", "1"])
    assert seen == dict(backend=backend, world_size=2, rank=1)


def test_maybe_init_distributed_default_is_kept(monkeypatch):
    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend))
    monkeypatch.setattr(torch, "set_num_threads",
                        lambda n: seen.update(threads=n))
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setenv("PSTPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("PSTPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("PSTPU_PROCESS_ID", "0")
    meshmod.maybe_init_distributed()
    assert seen == {"backend": "nccl"}
    # the ranks of a node share its cores
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    meshmod.maybe_init_distributed(backend="gloo")
    assert seen == {"backend": "gloo",
                    "threads": max(1, (os.cpu_count() or 1) // 2)}


@pytest.fixture
def eight_cards(monkeypatch):
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "PSTPU_PROCESS_ID",
              "PSTPU_NUM_PROCESSES"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    return monkeypatch


@pytest.mark.parametrize("env,card", [
    ({"LOCAL_RANK": "3", "LOCAL_WORLD_SIZE": "4",
      "PSTPU_NUM_PROCESSES": "8", "PSTPU_PROCESS_ID": "5"}, 3),
    ({"LOCAL_WORLD_SIZE": "4", "PSTPU_NUM_PROCESSES": "8",
      "PSTPU_PROCESS_ID": "5"}, 1),
    ({"LOCAL_WORLD_SIZE": "2", "PSTPU_NUM_PROCESSES": "8",
      "PSTPU_PROCESS_ID": "6"}, 0),
    ({"PSTPU_NUM_PROCESSES": "1", "PSTPU_PROCESS_ID": "0"}, 0),
    ({}, 0)])
def test_rank_card_from_local_rank(env, card, eight_cards):
    for k, v in env.items():
        eight_cards.setenv(k, v)
    assert meshmod.rank_device("cuda") == torch.device("cuda", card)
    assert meshmod.rank_device(None) == torch.device("cuda", card)
    assert meshmod.rank_device("cuda:5") == torch.device("cuda", 5)


def test_rank_card_unplaced_raises(eight_cards):
    eight_cards.setenv("PSTPU_NUM_PROCESSES", "2")
    eight_cards.setenv("PSTPU_PROCESS_ID", "1")
    with pytest.raises(RuntimeError, match="LOCAL_RANK"):
        meshmod.rank_device("cuda")
    # a shared device needs no placement
    assert meshmod.rank_device("cuda:0") == torch.device("cuda", 0)
