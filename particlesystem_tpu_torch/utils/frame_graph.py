"""Frame loops as CUDA graphs: the port's counterpart of the JAX package's
``jax.jit`` of one frame and ``lax.fori_loop`` over a batch of frames.

A frame function here reads its state from static buffers (tensors that
live as long as the loop) and writes the next state back into them, with
the frame index among them as a 0-dim int64 tensor that the function
increments.  :class:`FrameGraphs` runs such a function once a frame: on a
card, the first frame of a key runs it eagerly (the warm-up a capture
needs, and a real frame), the function is then captured into a CUDA
graph, and every later frame of that key is one replay of the graph, one
``cudaGraphLaunch`` on the host with no Python between the kernels.  On
the CPU the same object runs the function eagerly every frame, on the
same buffers, so the buffer, keying and copy-back logic is what the CPU
tests run.

Nothing falls back: an operation that cannot be captured (one that reads
a value back to the host, ``.item()``, ``.tolist()``, a copy from pageable
host memory) makes the capture raise.

Launch counts (``utils/cuda_build.launches``): a capture records the
launches made inside it (``cuda_build.recording``), and a replay adds one
to the record's replays, so the counts take in the kernels each replay
ran without a walk over them in the loop.

Graph memory: every capture on a device goes into one memory pool,
shared by all the loops of the process and held for its lifetime
(:func:`shared_pool`).  A frame function keeps nothing it allocates, so
when a capture ends its temporaries are free blocks of the pool, whose
addresses the graph's replays write, and which the next capture on the
device, of any loop, allocates again.  So a process that builds and drops
loops one after another (a fresh ``NBodySimulation`` a run) keeps one
capture's worth of graph memory reserved, and needs neither a new
``cudaMalloc`` for each capture nor an ``empty_cache``; a pool of its own
per loop would stay cached after its graphs were freed, and a capture
cannot take such memory back.  :data:`counters` counts the pools made
(one a device) and the captures into them.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Tuple

import torch

from . import cuda_build
from .timers import span

#: the shared pools: ``pools_created`` (one a device the process captured
#: on) and ``shared_captures`` (captures into them)
counters = {"pools_created": 0, "shared_captures": 0}

#: device index -> (its pool, the side stream its captures run on, the
#: graph that holds the pool)
_shared: Dict[int, Tuple[object, object, object]] = {}


def shared_pool(device: torch.device):
    """(the graph memory pool, the capture stream) of ``device``, made at
    the first capture there and held for the process's lifetime.

    A pool's use count is the number of live graphs in it, kept by the
    device's allocator and by the pinned-host allocator alike, and both
    refuse a capture into a pool whose count has fallen to zero.  So the
    pool is held by a graph of its own, one node captured into it here and
    never freed: once every frame graph has been freed the pool is still
    live and capturable (a held ``torch.cuda.MemPool`` keeps up only the
    device allocator's count).  The stream is shared too, because the
    allocator hands a free block only to an allocation on the stream that
    made it: captures on one stream reuse each other's blocks."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index not in _shared:
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(index)
        keep = torch.zeros((), device=torch.device("cuda", index))
        holder = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(index))
        with torch.cuda.stream(stream):
            holder.capture_begin(pool, capture_error_mode="thread_local")
            keep.add_(0)
            holder.capture_end()
        torch.cuda.current_stream(index).wait_stream(stream)
        _shared[index] = (pool, stream, (holder, keep))
        counters["pools_created"] += 1
    return _shared[index][:2]


class _Graph:
    def __init__(self, graph, record: cuda_build.Record):
        self.graph = graph
        self.record = record


class FrameGraphs:
    """One CUDA graph a key of a frame function, replayed once a frame.

    ``step(key, fn)`` advances one frame through ``fn`` (which returns
    nothing and keeps nothing it allocates: its results go into the static
    buffers).  A key names what the captured frame bakes in (shapes,
    prefixes, branches taken on the host); callers free the graphs of keys
    that stop being current with :meth:`retain`.

    Every graph on a device, of this loop and of every other, is captured
    into the device's one pool (:func:`shared_pool`), so graphs share the
    memory of their captures' temporaries.  That is sound because the
    replays of two graphs never overlap: every user (``NBodySimulation``,
    ``PackedEngine`` and the sharded emitter through it,
    ``DistributedNBodySimulation``) replays on the caller's current
    stream, one replay after the other, and no frame function keeps what
    it allocated inside a capture, so no graph reads pool memory that an
    earlier replay of it left.  A caller that replayed graphs on two
    streams at once would need a pool a stream.

    Counters: ``eager_frames`` (frames run by calling ``fn``: every frame
    on the CPU, each key's first on a card), ``captures``, ``replays``.
    The CPU keeps its keys too, each with no graph and no pool, so what is
    kept and freed is the same on both."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._graphs: Dict[Hashable, _Graph] = {}
        self.eager_frames = 0
        self.captures = 0
        self.replays = 0

    def step(self, key: Hashable, fn: Callable[[], None]) -> None:
        g = self._graphs.get(key)
        if g is None:
            with span("graphs.eager"):
                fn()  # on a card the warm-up, and a real frame
            self.eager_frames += 1
            if self.device.type == "cuda":
                with span("graphs.capture"):
                    self._graphs[key] = self._capture(fn)
            else:  # the CPU keeps the key, with no graph
                self._graphs[key] = _Graph(None, cuda_build.Record())
            return
        if g.graph is None:
            fn()
            self.eager_frames += 1
            return
        g.graph.replay()
        self.replays += 1
        g.record.replays += 1

    def _capture(self, fn) -> _Graph:
        """``fn`` captured on the device's capture stream (a capture cannot
        run on the default stream) into its shared pool.
        ``torch.cuda.graph`` would also empty the allocator's cache first,
        which costs a frame's worth of allocations again after every
        capture; the pool needs no room made for it."""
        graph = torch.cuda.CUDAGraph()
        pool, stream = shared_pool(self.device)
        main = torch.cuda.current_stream(self.device)
        stream.wait_stream(main)
        with cuda_build.recording() as rec, torch.cuda.stream(stream):
            graph.capture_begin(pool, capture_error_mode="thread_local")
            try:
                fn()
            finally:
                graph.capture_end()
        main.wait_stream(stream)
        self.captures += 1
        counters["shared_captures"] += 1
        return _Graph(graph, rec)

    def recorded(self, key: Hashable) -> Dict[str, int]:
        """{entry point: launches} that one replay of ``key``'s graph makes
        (empty where no graph was captured, as on the CPU)."""
        g = self._graphs.get(key)
        return {} if g is None else dict(g.record.counts)

    @property
    def keys(self) -> list:
        return list(self._graphs)

    def retain(self, *keys: Hashable) -> None:
        """Free every graph whose key is not among ``keys``.  Their
        captures' memory stays in the shared pool for the next capture."""
        for k in [k for k in self._graphs if k not in keys]:
            del self._graphs[k]
