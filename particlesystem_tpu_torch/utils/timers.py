"""Per-phase wall-clock timers, and the spans the port records while a
profiler records.

The reference samples ``getCurrentTimeInSecs()`` around each pipeline stage
(``source/code/src/particleSystem.cpp:1846-1927``).  :class:`PhaseTimers`
is the structured equivalent: named phases with running totals, on
``time.perf_counter``.  Device work is asynchronous, so a phase measures
device time only when it ends at a synchronisation point (the driver's
per-batch guard readback is one); a phase that ends at none, as
``NBodySimulation``'s ``fill`` does, is the host's time alone.

A span (:func:`span`) is one interval of the host's work inside the port:
its name, its start and end in ns, the index of the span it opened inside
(``parent``, -1 for none), the id of the outermost span it belongs to
(``run``: every span of one ``NBodySimulation.run`` or
``PackedEngine.step_many`` call shares it) and an optional count ``n`` of
the work done inside it.  One process-wide recorder keeps them in memory,
and records exactly while a ``torch.profiler`` session records
(``torch._C._autograd._profiler_enabled()``); otherwise a span costs that
one check.  Stamps are on the clock of the profiler's own events, unix
epoch ns (``time.time_ns()``).  Each span is also a profiler range of the
same name, its twin, so an exported trace shows the port's phases beside
the kernels: the profiler's fast record function
(``torch._C._profiler._RecordFunctionFast``), which shows as a host
operation rather than a user annotation, and opens in ~1 us where
``torch.profiler.record_function`` takes ~6 us with a tail past 100 us
(an H100's host, torch 2.11).
A span starts as its twin's opening call returns, which keeps the two
starts within a microsecond, and ends just before the twin closes.  At
most :data:`MAX_SPANS` are kept; later ones are dropped and counted.  Read
them with :func:`spans` and :func:`dropped`.  A phase of
:class:`PhaseTimers` is also a span, named with the timers' prefix.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

#: the most spans the recorder keeps
MAX_SPANS = 1 << 20

_recording = torch._C._autograd._profiler_enabled


class Span:
    """One recorded span (see the module's docstring), and the ``with``
    target that records it."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "run", "n",
                 "_index", "_twin")

    def __init__(self, name: str, n: Optional[int] = None):
        self.name, self.n = name, n
        self.start_ns, self.end_ns = 0, -1    # -1 while the span is open
        self.parent, self.run = -1, 0         # index in spans(), -1 for none

    def __enter__(self) -> "Span":
        if _open:
            outer = _open[-1]
            self.parent, self.run = outer._index, outer.run
        else:
            _counts["runs"] += 1
            self.run = _counts["runs"]
        if len(_spans) < MAX_SPANS:
            self._index = len(_spans)
            _spans.append(self)
        else:
            self._index = -1
            _counts["dropped"] += 1
        _open.append(self)
        self._twin = torch._C._profiler._RecordFunctionFast(self.name)
        self._twin.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self._twin.__exit__(None, None, None)
        self._twin = None
        _open.pop()
        return False


_spans: List[Span] = []
_open: List[Span] = []
_counts = {"dropped": 0, "runs": 0}


class _Off:
    """What :func:`span` gives while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, n: Optional[int] = None):
    """``with span(name, n=...):`` records the block as a span while a
    profiler records."""
    return Span(name, n) if _recording() else _OFF


def spans() -> List[Span]:
    """The spans recorded so far, in the order they opened."""
    return list(_spans)


def dropped() -> int:
    """Spans not kept because :data:`MAX_SPANS` were kept already."""
    return _counts["dropped"]


def clear() -> None:
    """Forget the recorded spans and the dropped count; call it with no
    span open."""
    _spans.clear()
    _counts["dropped"] = 0


class PhaseTimers:
    """Named phases with running totals; ``prefix`` names their spans
    (``PhaseTimers("nbody.").phase("step")`` records ``nbody.step``)."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, n: Optional[int] = None):
        t0 = time.perf_counter()
        try:
            with span(self.prefix + name, n):
                yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """One more occurrence of phase ``name``, timed elsewhere."""
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(1, self.counts[name]),
            }
            for name in self.totals
        }

    def report(self) -> str:
        lines = [f"{n}: {d['total_s']:.4f}s over {d['count']} "
                 f"({d['mean_ms']:.3f} ms avg)"
                 for n, d in sorted(self.summary().items())]
        return "\n".join(lines)


def device_ms(fn: Callable[[], object], device: torch.device) -> float:
    """Milliseconds of ``fn()``: CUDA events around it on a card, so the
    device's time from the first queued launch to the last; the host clock
    on the CPU, where every op is done when it returns."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def slope_ms(run_k: Callable[[int], object], k_short: int, k_long: int,
             reps: int, device: torch.device) -> float:
    """Median over ``reps`` of the per-frame slope between ``run_k(
    k_short)`` and ``run_k(k_long)``, each timed on its own
    (:func:`device_ms`): the fixed cost of a run cancels."""
    samples = []
    for _ in range(reps):
        t_short = device_ms(lambda: run_k(k_short), device)
        t_long = device_ms(lambda: run_k(k_long), device)
        samples.append((t_long - t_short) / (k_long - k_short))
    return float(np.median(samples))
