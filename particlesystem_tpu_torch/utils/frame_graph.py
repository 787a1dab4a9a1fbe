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

Launch counts (:func:`count_launch`): each kernel wrapper counts the
launches it makes in its ``launches`` attribute.  A launch made while a
frame is captured is not a launch, only a node of the graph: it is noted
in the capture's record, and each replay adds the record to the wrappers'
counts, so ``launches`` still counts the kernel's runs on the card.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Hashable, List

import torch

from .timers import span

_records: List[Dict[object, int]] = []


def count_launch(wrapper) -> None:
    """One launch by ``wrapper``: counted in ``wrapper.launches``, or,
    inside a capture, noted in the capture's record (the graph's replays
    count it)."""
    if _records:
        rec = _records[-1]
        rec[wrapper] = rec.get(wrapper, 0) + 1
    else:
        wrapper.launches += 1


@contextlib.contextmanager
def recording():
    """Collect the launches made inside into a dict {wrapper: launches},
    yielded, instead of the wrappers' counts: what a capture records."""
    rec: Dict[object, int] = {}
    _records.append(rec)
    try:
        yield rec
    finally:
        _records.pop()


class _Graph:
    def __init__(self, graph, recorded: Dict[object, int]):
        self.graph = graph
        self.recorded = recorded


class FrameGraphs:
    """One CUDA graph a key of a frame function, replayed once a frame.

    ``step(key, fn)`` advances one frame through ``fn`` (which returns
    nothing and keeps nothing it allocates: its results go into the static
    buffers).  A key names what the captured frame bakes in (shapes,
    prefixes, branches taken on the host); callers free the graphs of keys
    that stop being current with :meth:`retain`, since each keeps its
    capture's memory.  The graphs of one loop share one memory pool while
    any of them lives: they never run at the same time.

    Counters: ``eager_frames`` (frames run by calling ``fn``: every frame
    on the CPU, each key's first on a card), ``captures``, ``replays``.
    The CPU keeps its keys too, each with no graph, so what is kept and
    freed is the same on both."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._graphs: Dict[Hashable, _Graph] = {}
        self._pool = None
        self._stream = None
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
                self._graphs[key] = _Graph(None, {})
            return
        if g.graph is None:
            fn()
            self.eager_frames += 1
            return
        g.graph.replay()
        self.replays += 1
        for wrapper, n in g.recorded.items():
            wrapper.launches += n

    def _capture(self, fn) -> _Graph:
        """``fn`` captured on a side stream (a capture cannot run on the
        default stream).  ``torch.cuda.graph`` would also empty the
        allocator's cache first, which costs a frame's worth of
        allocations again after every capture; the pool needs no room
        made for it."""
        graph = torch.cuda.CUDAGraph()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with recording() as rec, torch.cuda.stream(self._stream):
            graph.capture_begin(self._pool,
                                capture_error_mode="thread_local")
            try:
                fn()
            finally:
                graph.capture_end()
        main.wait_stream(self._stream)
        self.captures += 1
        return _Graph(graph, rec)

    def recorded(self, key: Hashable) -> Dict[object, int]:
        """{wrapper: launches} that one replay of ``key``'s graph makes
        (empty where no graph was captured, as on the CPU)."""
        g = self._graphs.get(key)
        return {} if g is None else dict(g.recorded)

    @property
    def keys(self) -> list:
        return list(self._graphs)

    def retain(self, *keys: Hashable) -> None:
        """Free every graph whose key is not among ``keys``.  A pool that
        no graph holds any more is left to the allocator, which frees it
        when it needs the memory; the next capture takes a new one."""
        for k in [k for k in self._graphs if k not in keys]:
            del self._graphs[k]
        if not self._graphs:
            self._pool = None

