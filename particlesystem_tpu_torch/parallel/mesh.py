"""Rank meshes, process groups and the collectives of the multi-device layer.

Counterpart of ``particlesystem_tpu/parallel/mesh.py``.  The reference's
launcher is ``mpirun -n 2 --hostfile mpi-hosts`` (``makefile:3-4``); here
one process runs each rank, joined by a ``torch.distributed`` process group
that the caller creates and passes down explicitly (no function of this
package reaches for an implicit default group).

* :class:`RankMesh` lays the ranks of a group on a logical grid (the
  ``jax.sharding.Mesh`` analog) and carries the collectives the
  decompositions use: :meth:`RankMesh.exchange` (a batch of ``ppermute``s
  along one axis), :meth:`RankMesh.psum` and :meth:`RankMesh.pmax`.
* ``ppermute`` follows JAX's rule: a rank that no one sends to receives
  zeros, so the non-cyclic halo's edge ranks see all-invalid rows.
* Transport: NCCL moves device tensors directly.  Gloo's point-to-point
  ops take host tensors, so with gloo every CUDA exchange buffer is copied
  to the host and back around the call (computation stays on the card);
  :attr:`RankMesh.staged_bytes` counts those copies.  NCCL cannot run two
  ranks on one device, so ranks that share a card use gloo.
* Every exchange of a phase is one ``batch_isend_irecv`` with the same op
  order on every rank and one tag a message, so two messages to the same
  peer (both migration rings at two ranks) match under either backend.
* :func:`default_mesh` / :func:`hybrid_mesh` keep the placement rule of the
  JAX package: the first axis spans the node seam block-wise, every other
  axis (the per-frame migration rings) stays inside a node.  Nodes are
  contiguous blocks of ``LOCAL_WORLD_SIZE`` ranks, as ``torchrun`` numbers
  them: the GPU meaning of a TPU slice.
* :func:`spawn` runs ``fn(rank, group, *args)`` in ``world_size`` fresh
  processes over a localhost group, with a timeout on every wait; rank r
  sees ``LOCAL_RANK=r``, so by default it computes on ``cuda:r``.
* Under a launcher (:func:`maybe_init_distributed`) a rank's card is
  ``cuda:{local_rank()}``: ``LOCAL_RANK`` when the launcher sets it, else
  the rank's place in its node of ``LOCAL_WORLD_SIZE`` ranks;
  :func:`device_backend` picks the group's backend from the device.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import socket
import traceback
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: how long a rank waits for its peers in any collective
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def maybe_init_distributed(backend: Optional[str] = None,
                           timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """Join a multi-process run described by the environment (the mpirun
    hostfile role): ``PSTPU_COORDINATOR`` (``host:port`` of rank 0),
    ``PSTPU_NUM_PROCESSES`` and ``PSTPU_PROCESS_ID``.  Returns the process
    group to pass on, or None when the variables are not set (a lone
    process).  ``backend`` defaults to NCCL where torch sees a card; a
    caller that knows its ranks' device passes :func:`device_backend` of
    it (the CLI does).  With ``LOCAL_WORLD_SIZE`` set, the ranks of a node
    share its cores: each takes cores / ``LOCAL_WORLD_SIZE`` threads, as
    :func:`spawn`'s ranks do."""
    coord = os.environ.get("PSTPU_COORDINATOR")
    if not coord:
        return None
    if "LOCAL_WORLD_SIZE" in os.environ:
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // int(os.environ["LOCAL_WORLD_SIZE"])))
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{coord}",
        world_size=int(os.environ["PSTPU_NUM_PROCESSES"]),
        rank=int(os.environ["PSTPU_PROCESS_ID"]), timeout=timeout)
    return dist.group.WORLD


def device_backend(device) -> str:
    """The process-group backend for ranks that compute on ``device``:
    NCCL when each rank has a card of its own (``cuda`` without an index),
    gloo when the ranks share one device (``cuda:N`` or ``cpu``; NCCL
    refuses two ranks on one card)."""
    dev = torch.device(device)
    return "nccl" if dev.type == "cuda" and dev.index is None else "gloo"


def local_rank() -> int:
    """This process's rank within its node: ``LOCAL_RANK`` when set (as
    :func:`spawn` and ``torchrun`` set it), else ``PSTPU_PROCESS_ID %
    LOCAL_WORLD_SIZE`` when ``LOCAL_WORLD_SIZE`` is set (nodes are
    contiguous blocks of ranks), else 0 for a lone process.  Raises for a
    process of a larger launch that neither variable places."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    pid = int(os.environ.get("PSTPU_PROCESS_ID", 0))
    if "LOCAL_WORLD_SIZE" in os.environ:
        return pid % int(os.environ["LOCAL_WORLD_SIZE"])
    if int(os.environ.get("PSTPU_NUM_PROCESSES", 1)) > 1:
        raise RuntimeError(
            "cannot place this rank on a card: set LOCAL_RANK (its index "
            "among the processes of its node) or LOCAL_WORLD_SIZE (the "
            "processes a node runs; ranks are numbered node by node), or "
            "give every rank one shared device (cuda:N or cpu)")
    return 0


def rank_device(device=None) -> torch.device:
    """The device a rank computes on, made the current CUDA device (NCCL
    wants it so): ``device`` when given (ranks then share it if the caller
    says so; ``cuda`` without an index is ``cuda:{local_rank()}``), else
    ``cuda:{local_rank()}``.  Raises when that card does not exist: ranks
    never share a card by default."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but torch sees no "
                               f"CUDA device")
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank device {dev} does not exist "
                f"({torch.cuda.device_count()} cards); pass device= to place "
                f"ranks explicitly")
        torch.cuda.set_device(dev)
    return dev


# ---------------------------------------------------------------------------
# rank layouts (pure: numpy arrays of ranks, no process group needed)
# ---------------------------------------------------------------------------


def _block_rank_array(granules, ici_shape, dcn_shape) -> np.ndarray:
    """Granule-block layout: granule ``gi`` (a list of ranks, one node)
    tiles the ``ici_shape`` block at super-grid position ``gi`` of
    ``dcn_shape``."""
    global_shape = tuple(d * i for d, i in zip(dcn_shape, ici_shape))
    arr = np.empty(global_shape, dtype=np.int64)
    for gi, idx in enumerate(np.ndindex(*dcn_shape)):
        block = np.asarray(granules[gi], dtype=np.int64).reshape(ici_shape)
        sl = tuple(slice(idx[k] * ici_shape[k], (idx[k] + 1) * ici_shape[k])
                   for k in range(len(ici_shape)))
        arr[sl] = block
    return arr


def _local_world_size(n_ranks: int, local_world_size: Optional[int]) -> int:
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", n_ranks))
    return max(1, min(local_world_size, n_ranks))


def _node_granules(n_ranks: int, n_granules: int) -> List[List[int]]:
    if n_ranks % n_granules:
        raise ValueError(f"{n_ranks} ranks cannot split into {n_granules} "
                         f"nodes")
    per = n_ranks // n_granules
    return [list(range(i * per, (i + 1) * per)) for i in range(n_granules)]


def hybrid_layout(ici_shape, dcn_shape,
                  local_world_size: Optional[int] = None) -> np.ndarray:
    """Ranks of a node-aware mesh: global axis ``i`` has size
    ``dcn_shape[i] * ici_shape[i]``; the ranks of one node tile the
    ``ici_shape`` block, blocks lie on the ``dcn_shape`` super-grid.  Give
    every axis that carries a migration ring a ``dcn_shape`` entry of 1."""
    ici_shape = tuple(int(s) for s in ici_shape)
    dcn_shape = tuple(int(s) for s in dcn_shape)
    if len(ici_shape) != len(dcn_shape):
        raise ValueError(f"rank mismatch: {ici_shape} {dcn_shape}")
    n_granules = int(np.prod(dcn_shape))
    n = n_granules * int(np.prod(ici_shape))
    per_node = _local_world_size(n, local_world_size)
    if n_granules > 1 and per_node * n_granules != n:
        raise ValueError(f"dcn_shape {dcn_shape} asks for {n_granules} "
                         f"nodes; {n} ranks at {per_node} a node are "
                         f"{n // per_node}")
    return _block_rank_array(_node_granules(n, n_granules), ici_shape,
                             dcn_shape)


def default_layout(shape, local_world_size: Optional[int] = None
                   ) -> np.ndarray:
    """Ranks of the drivers' default mesh of logical ``shape``: flat rank
    order.  Ranks are numbered node by node, so flat order already is the
    :func:`hybrid_layout` rule whenever the nodes divide the first axis:
    that axis spans the node seam block-wise and every other axis stays
    inside a node.  When they do not, migration rings may cross the seam
    every hop, and this warns."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    per_node = _local_world_size(n, local_world_size)
    n_nodes = -(-n // per_node)
    if n_nodes > 1 and (shape[0] % n_nodes or n % per_node):
        warnings.warn(
            f"multi-node topology ({n_nodes} nodes of {per_node} ranks) "
            f"cannot be honored for mesh shape {shape} (axis 0 size "
            f"{shape[0]} must divide evenly into the nodes); falling back "
            f"to flat rank order: migration rings may cross the node seam "
            f"every hop. Pass an explicit hybrid_mesh(...) instead.",
            RuntimeWarning, stacklevel=2)
    return np.arange(n, dtype=np.int64).reshape(shape)


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _pack(tensors) -> Tuple[torch.Tensor, list]:
    """One uint8 buffer holding ``tensors``' bytes, widest dtypes first so
    that every field starts aligned; returns (buffer, layout)."""
    order = sorted(range(len(tensors)),
                   key=lambda i: -tensors[i].element_size())
    parts, layout = [], [None] * len(tensors)
    for i in order:
        t = tensors[i]
        parts.append(t.contiguous().reshape(-1).view(torch.uint8))
        layout[i] = (t.dtype, tuple(t.shape), parts[-1].numel())
    return torch.cat(parts), (order, layout)


def _unpack(buf: torch.Tensor, packing) -> List[torch.Tensor]:
    order, layout = packing
    out, at = [None] * len(layout), 0
    for i in order:
        dtype, shape, nbytes = layout[i]
        out[i] = buf[at:at + nbytes].view(dtype).view(shape)
        at += nbytes
    return out


class RankMesh:
    """The ranks of ``group`` on a logical grid with named ``axes``
    (``ranks[coords]`` = group rank).  ``group=None`` is a lone process (a
    mesh of one rank, where every collective is the identity); a mesh of
    more ranks needs the group its collectives run on.  ``rank`` defaults
    to this process's rank in ``group``; give it to inspect a layout from
    outside the group."""

    def __init__(self, ranks, axes: Sequence[str], group=None,
                 rank: Optional[int] = None):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axes = tuple(axes)
        if self.ranks.ndim != len(self.axes):
            raise ValueError(f"{self.ranks.ndim}-d ranks, axes {self.axes}")
        if sorted(self.ranks.ravel().tolist()) != list(range(self.ranks.size)):
            raise ValueError(f"ranks {self.ranks.tolist()} are not a "
                             f"permutation of 0..{self.ranks.size - 1}")
        self.group = group
        if group is not None and _group_size(group) != self.ranks.size:
            raise ValueError(f"group of {_group_size(group)} ranks for a "
                             f"mesh of {self.ranks.size}")
        if rank is None:
            if group is None and self.ranks.size > 1:
                raise ValueError("a mesh of several ranks needs its group")
            rank = 0 if group is None else dist.get_rank(group)
        self.rank = int(rank)
        self.coords = tuple(int(c) for c in
                            np.argwhere(self.ranks == self.rank)[0])
        self.staged_bytes = 0

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.ranks.shape

    @property
    def size(self) -> int:
        return self.ranks.size

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axes.index(axis)]

    def peer(self, axis: str, index: int) -> int:
        """Group rank of the rank at ``index`` along ``axis`` that shares
        this rank's other coordinates."""
        c = list(self.coords)
        c[self.axes.index(axis)] = index
        return int(self.ranks[tuple(c)])

    # -- transport ---------------------------------------------------------
    def _global(self, group_rank: int) -> int:
        if self.group is dist.group.WORLD:
            return group_rank
        return dist.get_global_rank(self.group, group_rank)

    def _stages(self, t: torch.Tensor) -> bool:
        """Whether ``t`` goes through host memory for this group's
        backend (gloo takes no CUDA tensors point to point)."""
        return (t.device.type == "cuda"
                and dist.get_backend(self.group) == "gloo")

    def exchange(self, axis: str, messages) -> List[List[torch.Tensor]]:
        """A batch of ``ppermute``s along ``axis`` in one
        ``batch_isend_irecv``.  ``messages`` is a list of (tensors, perm),
        ``perm`` a list of (source index, destination index) pairs along
        the axis.  Returns, per message, the tensors this rank received:
        the sender's, or zeros of the same shapes where no one sends to it
        (JAX's rule).  Every rank must pass the same shapes."""
        me = self.axis_index(axis)
        plan = []
        for tensors, perm in messages:
            buf, packing = _pack(tensors)
            dst = dict(perm).get(me)
            src = {d: s for s, d in perm}.get(me)
            plan.append((buf, packing, dst, src))
        if all(dst is None and src is None for _, _, dst, src in plan):
            return [_unpack(torch.zeros_like(buf), packing)
                    for buf, packing, _, _ in plan]
        if self.group is None:
            raise ValueError("an exchange between ranks needs a group")
        ops, recvs = [], []
        for tag, (buf, packing, dst, src) in enumerate(plan):
            stage = self._stages(buf)
            if dst is not None:
                send = buf.cpu() if stage else buf
                self.staged_bytes += send.numel() if stage else 0
                ops.append(dist.P2POp(dist.isend, send,
                                      self._global(self.peer(axis, dst)),
                                      self.group, tag))
            recv = torch.zeros(buf.numel(), dtype=torch.uint8,
                               device="cpu" if stage else buf.device)
            if src is not None:
                ops.append(dist.P2POp(dist.irecv, recv,
                                      self._global(self.peer(axis, src)),
                                      self.group, tag))
            recvs.append((recv, packing, buf.device,
                          stage and src is not None))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        out = []
        for recv, packing, device, staged in recvs:
            if staged:
                self.staged_bytes += recv.numel()
            out.append(_unpack(recv.to(device), packing))
        return out

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.group is None:
            return x
        stage = self._stages(x)
        y = x.cpu() if stage else x.clone()
        dist.all_reduce(y, op=op, group=self.group)
        if stage:
            self.staged_bytes += 2 * y.numel() * y.element_size()
            return y.to(x.device)
        return y

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (one shape on all ranks), by group rank."""
        if self.group is None:
            return [x]
        stage = self._stages(x)
        y = x.contiguous()
        if y.dtype == torch.bool:  # gloo gathers bytes, not bools
            y = y.view(torch.uint8)
        y = y.cpu() if stage else y
        out = [torch.empty_like(y) for _ in range(self.size)]
        dist.all_gather(out, y, group=self.group)
        if stage:
            self.staged_bytes += (self.size + 1) * y.numel() * y.element_size()
        return [o.to(x.device).view(x.dtype) for o in out]

    def position(self, group_rank: int) -> int:
        """Row-major position on the mesh of the rank ``group_rank``: the
        block of global slots it holds."""
        at = np.argwhere(self.ranks == group_rank)[0]
        return int(np.ravel_multi_index(tuple(at), self.shape))

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over every rank of the mesh."""
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Maximum over every rank of the mesh."""
        return self._reduce(x, dist.ReduceOp.MAX)


def ppermute(x, perm, group) -> List[torch.Tensor]:
    """JAX's ``ppermute`` over the ranks of ``group`` (``perm`` pairs are
    group ranks): returns what this rank received, zeros where no one sends
    to it.  ``x`` is a tensor or a list of tensors (sent as one message)."""
    tensors = [x] if isinstance(x, torch.Tensor) else list(x)
    out = mesh_1d(_group_size(group), "x", group).exchange(
        "x", [(tensors, perm)])[0]
    return out[0] if isinstance(x, torch.Tensor) else out


def mesh_1d(n: int, axis: str = "x", group=None) -> RankMesh:
    """1-D mesh over the ``n`` ranks of ``group`` in rank order."""
    return RankMesh(np.arange(n), (axis,), group)


def mesh_2d(d3: int, d1: int, axes=("x", "y"), group=None) -> RankMesh:
    """2-D ``(d3, d1)`` mesh for the pencil decomposition: axis "x" shards
    grid planes (i3), "y" rows (i1)."""
    return RankMesh(np.arange(d3 * d1).reshape(d3, d1), axes, group)


def mesh_3d(d3: int, d1: int, d2: int, axes=("x", "y", "z"),
            group=None) -> RankMesh:
    """3-D ``(d3, d1, d2)`` mesh for the brick decomposition."""
    return RankMesh(np.arange(d3 * d1 * d2).reshape(d3, d1, d2), axes,
                    group)


def default_mesh(shape, axes, group=None,
                 local_world_size: Optional[int] = None) -> RankMesh:
    """:func:`default_layout` as a mesh over ``group``."""
    return RankMesh(default_layout(shape, local_world_size), axes, group)


def hybrid_mesh(ici_shape, dcn_shape, axes, group=None,
                local_world_size: Optional[int] = None) -> RankMesh:
    """:func:`hybrid_layout` as a mesh over ``group``.  Over 2 nodes of 4
    ranks: slab ``hybrid_mesh((4,), (2,), ("x",))``, pencil (4, 2)
    ``hybrid_mesh((2, 2), (2, 1), ("x", "y"))``, brick (2, 2, 2)
    ``hybrid_mesh((1, 2, 2), (2, 1, 1), ("x", "y", "z"))``."""
    if len(ici_shape) != len(axes):
        raise ValueError(f"rank mismatch: {ici_shape} {axes}")
    return RankMesh(hybrid_layout(ici_shape, dcn_shape, local_world_size),
                    axes, group)


# ---------------------------------------------------------------------------
# one process a rank
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_entry(rank, world_size, port, backend, timeout_s, fn, args, out):
    # one node, numbered as torchrun numbers it (rank_device reads
    # LOCAL_RANK); the ranks share this host's cores
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world_size)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}",
            world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, dist.group.WORLD, *args)
        finally:
            dist.destroy_process_group()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()  # nothing left queued at exit
        out.put((rank, True, result))
    except BaseException:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def spawn(fn, world_size: int, args: tuple = (), backend: str = "gloo",
          timeout: float = 600.0) -> list:
    """Run ``fn(rank, group, *args)`` in ``world_size`` new processes
    (spawn context) joined over a localhost ``backend`` group; returns the
    results in rank order (they must pickle).  A rank that fails raises
    here with its traceback; a run that has not finished after ``timeout``
    seconds (``math.inf``: no limit) is killed and raises, and no
    collective waits longer than :data:`DEFAULT_TIMEOUT` (or ``timeout``)
    for its peers, so a deadlocked exchange fails instead of hanging.
    ``fn`` must be importable by name (a module-level function)."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    # a collective waits at most this long for its peers
    wait = min(DEFAULT_TIMEOUT.total_seconds(), max(1.0, timeout - 5.0))
    procs = [ctx.Process(target=_spawn_entry,
                         args=(r, world_size, port, backend, wait, fn, args,
                               out),
                         daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results, errors = {}, []
    try:
        # drain the queue before any join: a rank exits only once its
        # result has left the pipe
        while len(results) < world_size and not errors:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue_mod.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)}
                if dead:
                    errors.append(f"ranks exited with codes {dead}")
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{fn.__name__}: {world_size - len(results)} of "
                        f"{world_size} ranks did not finish in {timeout} s"
                    ) from None
                continue
            if ok:
                results[rank] = value
            else:  # the other ranks may wait on this one forever
                errors.append(f"rank {rank}:\n{value}")
    finally:
        # every rank must be gone before this returns: wait for the clean
        # exits, then kill what is left (a failed run, or an exit that hangs)
        stop = time.monotonic() + (1.0 if errors or len(results) < world_size
                                   else 60.0)
        for p in procs:
            p.join(timeout=max(0.1, stop - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for r in hung:
            procs[r].kill()
            procs[r].join(timeout=10.0)
    if not errors and (hung or any(p.exitcode for p in procs)):
        errors.append(f"ranks {hung} did not exit and were killed; exit "
                      f"codes {[p.exitcode for p in procs]}")
    if errors:
        raise RuntimeError(f"{fn.__name__} failed:\n" + "\n".join(errors))
    return [results[r] for r in range(world_size)]
