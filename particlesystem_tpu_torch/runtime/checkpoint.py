"""Checkpoint and resume.

Counterpart of ``particlesystem_tpu/runtime/checkpoint.py``; it reads and
writes the same files, so a run saved by either package resumes in the
other.

* **Monolithic** (:func:`save` / :func:`load`): a ``ParticleState`` or an
  ``EngineState`` in one ``.npz``: ``leaf_i`` in the order the JAX package
  flattens the state (``ParticleState``: pos, vel, acc, w, age, life,
  alive, parent, tag; ``EngineState``: the fields, accum, free_list,
  cursor, n_free, frame), in its dtypes (float32, bool, uint32 tags, int32
  cursors and frame), and ``__meta__``, JSON bytes holding the frame counter
  and the config fingerprint.
* **Sharded** (:func:`save_sharded` / :func:`load_sharded`): a directory
  of per-process ``shard_p{pid:05d}.npz`` files and one ``meta.json``, the
  JAX package's ``save_sharded`` format.  Each process writes only the
  rows it holds, with their global index ranges, and reads back only the
  ranges it owns; :func:`load_sharded_host` assembles the full state on
  the host (the path between decompositions).

The port keeps tags as uint32 values in int64 tensors (torch has no uint32
arithmetic) and the engine's frame as a host int; the conversion to and
from the file's dtypes happens here, at the file boundary, through
``core.state.state_to_numpy`` / ``state_from_numpy`` and
``runtime.engine.engine_state_to_numpy`` / ``engine_state_from_numpy``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..core.state import (FIELDS, ParticleState, state_from_numpy,
                          state_to_numpy)
from .engine import (EngineState, engine_state_from_numpy,
                     engine_state_to_numpy)

# in-memory dtype -> the file's dtype (int64 tensors hold uint32 tags)
_FILE_DTYPES = {torch.float32: np.float32, torch.bool: np.bool_,
                torch.int32: np.int32, torch.int64: np.uint32}


def _leaves(tree) -> list:
    """The state's leaves (tensors, or a host int) in the file's order."""
    if isinstance(tree, ParticleState):
        return [getattr(tree, f) for f in FIELDS]
    if isinstance(tree, EngineState):
        return [*tree.fields, tree.accum, tree.free_list, tree.cursor,
                tree.n_free, tree.frame]
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _file_spec(tree) -> List[Tuple[tuple, np.dtype]]:
    """(shape, dtype) each leaf has in the file, without copying it."""
    return [((), np.dtype(np.int32)) if isinstance(leaf, int)
            else (tuple(leaf.shape), np.dtype(_FILE_DTYPES[leaf.dtype]))
            for leaf in _leaves(tree)]


def _to_numpy(tree) -> List[np.ndarray]:
    if isinstance(tree, ParticleState):
        arrays = state_to_numpy(tree)
        return [arrays[f] for f in FIELDS]
    _leaves(tree)  # raises on an unknown type
    return engine_state_to_numpy(tree)


def _from_numpy(template, leaves):
    if isinstance(template, ParticleState):
        return state_from_numpy(dict(zip(FIELDS, leaves)), template.device)
    return engine_state_from_numpy(leaves, template)


def save(path: str, tree, meta: dict | None = None) -> None:
    """Write a sim state (and optional JSON-able metadata) to ``.npz``.
    Synchronises: every leaf is copied to the host."""
    arrays = {f"leaf_{i}": a for i, a in enumerate(_to_numpy(tree))}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load(path: str, template, expect_config=None):
    """Read a checkpoint written by :func:`save` (of either package);
    ``template`` provides the structure, shapes and device (e.g. a freshly
    built state of the same config).  Returns (tree, meta).

    ``expect_config``: the config the caller will resume under.  Most
    physics knobs (dt, gravity, eps2, seed...) do not change array shapes,
    so shape checks alone would let a checkpoint resume under a different
    config; pass the config (or its fingerprint dict) to reject that."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if expect_config is not None:
            _check_config(meta, expect_config)
        spec = _file_spec(template)
        loaded = [data[f"leaf_{i}"] for i in range(len(spec))]
    for (shape, dtype), got in zip(spec, loaded):
        if shape != got.shape:
            raise ValueError(f"checkpoint shape {got.shape} != template "
                             f"{shape} — config mismatch?")
        if dtype != got.dtype:
            raise ValueError(f"checkpoint dtype {got.dtype} != template "
                             f"{dtype} — config mismatch?")
    return _from_numpy(template, loaded), meta


# -- sharded (directory) format -----------------------------------------------

_SHARDED_FORMAT = "pstpu-sharded-v1"


class Shard(NamedTuple):
    """One leaf's part held by this process: ``data`` (numpy, the file's
    dtype) is the slice ``index`` ([[start, stop], ...] per dimension) of
    a global array of ``shape``."""

    data: np.ndarray
    index: list
    shape: tuple


def state_shards(state: ParticleState, rows: slice, slots: int
                 ) -> List[Shard]:
    """The leaves of a rank's local ``ParticleState`` as :class:`Shard` parts:
    rows ``[rows.start, rows.stop)`` of global leaves of ``slots`` rows."""
    out = []
    for a in _to_numpy(state):
        shape = (slots,) + a.shape[1:]
        out.append(Shard(a, [[rows.start, rows.stop]]
                         + [[0, d] for d in a.shape[1:]], shape))
    return out


def _barrier(group) -> None:
    if group is not None:
        import torch.distributed as dist
        if dist.get_world_size(group) > 1:
            dist.barrier(group=group)


def save_sharded(path: str, shards: List[Shard], meta: dict | None = None,
                 group=None) -> None:
    """Write a checkpoint directory: ``meta.json`` (process 0) and one
    ``shard_p{pid:05d}.npz`` for each process of ``group`` (None: a lone
    process), holding its :class:`Shard` parts, one per leaf, and their global
    index ranges.  Collective over ``group``: process 0 first removes stale
    shard files and ``meta.json`` behind a barrier (a re-save by fewer
    processes leaves no higher-pid file behind), and the call returns after
    a second barrier, so every process may load the result at once.  With
    several processes ``path`` must be a filesystem all of them share."""
    import torch.distributed as dist
    pid = 0 if group is None else dist.get_rank(group)
    n_proc = 1 if group is None else dist.get_world_size(group)
    os.makedirs(path, exist_ok=True)
    if pid == 0:
        for fn in glob.glob(os.path.join(path, "shard_p*.npz")):
            os.unlink(fn)
        stale_meta = os.path.join(path, "meta.json")
        if os.path.exists(stale_meta):
            os.unlink(stale_meta)
    _barrier(group)  # nobody writes before the stale files are gone
    arrays = {}
    for i, sh in enumerate(shards):
        arrays[f"l{i}s0"] = np.asarray(sh.data)
        arrays[f"l{i}s0_idx"] = np.asarray(sh.index, dtype=np.int64
                                           ).reshape(-1, 2)
    np.savez(os.path.join(path, f"shard_p{pid:05d}.npz"), **arrays)
    if pid == 0:
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(dict(format=_SHARDED_FORMAT, meta=meta or {},
                           n_processes=n_proc,
                           leaves=[dict(shape=list(sh.shape),
                                        dtype=str(np.asarray(sh.data).dtype))
                                   for sh in shards]), f)
    _barrier(group)


def load_sharded(path: str, wanted: List[Shard], expect_config=None):
    """Read from a :func:`save_sharded` directory (of either package) only
    the ranges this process owns.  ``wanted`` gives, per leaf, the index to
    read, the global shape and (as ``data``) an array of the expected
    dtype; shapes and dtypes must match the file's.  Returns (list of numpy
    arrays, meta).  A shard file missing from a multi-process checkpoint
    raises ``FileNotFoundError`` (they need a shared filesystem)."""
    info = _read_sharded_meta(path, expect_config)
    if len(info["leaves"]) != len(wanted):
        raise ValueError(f"checkpoint has {len(info['leaves'])} leaves, "
                         f"expected {len(wanted)}")
    for want, lm in zip(wanted, info["leaves"]):
        if list(want.shape) != lm["shape"]:
            raise ValueError(f"checkpoint leaf shape {lm['shape']} != "
                             f"{list(want.shape)} — config mismatch?")
        if np.dtype(lm["dtype"]) != np.asarray(want.data).dtype:
            raise ValueError(f"checkpoint leaf dtype {lm['dtype']} != "
                             f"{np.asarray(want.data).dtype} — config "
                             f"mismatch?")
    chunks, handles = _chunk_index(path, info["n_processes"])
    try:
        out = [_assemble(want.index, np.dtype(lm["dtype"]),
                         chunks.get(i, []))
               for i, (want, lm) in enumerate(zip(wanted, info["leaves"]))]
    finally:
        for z in handles:
            z.close()
    return out, info["meta"]


def is_sharded(path: str) -> bool:
    """True if ``path`` is a directory written by ``save_sharded``."""
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, "meta.json"))


def _read_sharded_meta(path: str, expect_config=None) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        info = json.load(f)
    if info.get("format") != _SHARDED_FORMAT:
        raise ValueError(f"unknown checkpoint format {info.get('format')!r}")
    if expect_config is not None:
        _check_config(info["meta"], expect_config)
    return info


def _chunk_index(path: str, n_processes: int):
    """Map leaf id -> list of (npz, key, [[start,stop],...]) WITHOUT loading
    chunk data: npz member arrays load lazily, so only the tiny ``_idx``
    arrays are read here.  Reads EXACTLY the ``n_processes`` shard files
    recorded in meta.json — never a glob, so stale higher-pid files from an
    older save cannot leak in — and errors if any expected file is absent
    (e.g. a multi-process checkpoint written to per-host local disks
    instead of a shared filesystem).  Returns (chunks, handles); the caller
    must close every handle after assembling (the NpzFiles stay open for
    lazy member reads until then)."""
    chunks: dict = {}
    handles = []
    for pid in range(n_processes):
        fn = os.path.join(path, f"shard_p{pid:05d}.npz")
        if not os.path.exists(fn):
            for z in handles:
                z.close()
            raise FileNotFoundError(
                f"checkpoint {path!r} lists {n_processes} processes in "
                f"meta.json but {os.path.basename(fn)} is missing — "
                f"multi-process checkpoints need a shared filesystem")
        z = np.load(fn)
        handles.append(z)
        for key in z.files:
            if key.endswith("_idx"):
                base = key[:-4]
                i = int(base[1:base.index("s")])
                chunks.setdefault(i, []).append(
                    (z, base, z[key].tolist()))
    return chunks, handles


def _assemble(dst_idx, dtype, chunks) -> np.ndarray:
    """Assemble the global slice ``dst_idx`` ([[start,stop],...]) from the
    saved chunks, loading ONLY chunk members that intersect it."""
    out = np.empty([b - a for a, b in dst_idx], dtype=dtype)
    # full-rank coverage mask (1 byte/element): replicated chunks may
    # overlap, so intersection volumes cannot simply be summed, and a
    # dim-0-only mask would miss a chunk that covers rows but only part of
    # the trailing dims
    filled = np.zeros(out.shape if out.ndim else (1,), dtype=bool)
    for z, base, src_idx in chunks:
        inter = [[max(a, c), min(b, d)]
                 for (a, b), (c, d) in zip(dst_idx, src_idx)]
        if any(a >= b for a, b in inter) and out.size:
            continue
        data = z[base]  # lazy zip-member read: only intersecting chunks
        dst_sl = tuple(slice(a - o[0], b - o[0])
                       for (a, b), o in zip(inter, dst_idx))
        src_sl = tuple(slice(a - o[0], b - o[0])
                       for (a, b), o in zip(inter, src_idx))
        out[dst_sl] = data[src_sl]
        if out.ndim:
            filled[dst_sl] = True
        else:
            filled[:] = True
    if not filled.all():
        raise ValueError(
            "checkpoint chunks do not cover the requested slice "
            f"({int(filled.sum())}/{filled.size} elements covered)")
    return out


def load_sharded_host(path: str, template=None, expect_config=None):
    """Assemble the full global state of a sharded checkpoint directory on
    the host (memory cost: the whole state in this process).  With a
    ``template`` state the leaves come back as that kind of state on its
    device; without one, as the list of numpy leaves in the file's order.
    Returns (tree-or-leaf-list, meta)."""
    info = _read_sharded_meta(path, expect_config)
    chunks, handles = _chunk_index(path, info["n_processes"])
    try:
        leaves = [_assemble([[0, d] for d in lm["shape"]],
                            np.dtype(lm["dtype"]), chunks.get(i, []))
                  for i, lm in enumerate(info["leaves"])]
    finally:
        for z in handles:
            z.close()
    if template is not None:
        return _from_numpy(template, leaves), info["meta"]
    return leaves, info["meta"]


def _check_config(meta: dict, expect_config) -> None:
    want = (expect_config if isinstance(expect_config, dict)
            else config_fingerprint(expect_config))
    stored = {k: meta[k] for k in want if k in meta}
    if stored != want:
        diff = {k: (stored.get(k), want[k])
                for k in want if stored.get(k) != want[k]}
        raise ValueError(
            f"checkpoint config mismatch (stored, current): {diff}")


def config_fingerprint(cfg) -> dict:
    """JSON-able snapshot of a frozen config dataclass, for save() metadata."""
    def enc(v):
        if dataclasses.is_dataclass(v):
            return {f.name: enc(getattr(v, f.name))
                    for f in dataclasses.fields(v)}
        if isinstance(v, tuple):
            return [enc(x) for x in v]
        return v
    return enc(cfg)
