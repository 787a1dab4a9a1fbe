"""What a profiler trace of the window says: device busy time, device time
by operation, device time inside given host intervals, and the idle gaps
by what the host was doing.

The trace stays in memory; only this summary leaves it.  Host intervals
are the harness's own annotations (``torch.profiler.record_function``
under the ``bench.`` prefix), which the trace times on the same clock as
the device's operations.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Tuple

import numpy as np

PREFIX = "bench."
WINDOW = PREFIX + "window"
UNIT = PREFIX + "unit"
#: idle gaps given a label, longest first
LABELLED_GAPS = 4000


@dataclasses.dataclass
class Trace:
    window: Tuple[int, int]                 # ns, the window's annotation
    ops: List[Tuple[int, int, str]]         # device operations in it
    busy_ns: int
    units: List[Tuple[int, int]]            # each unit's host interval
    gaps: List[Tuple[str, int]]             # (host label, idle ns)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def by_name(self) -> Dict[str, int]:
        out = collections.Counter()
        for s, e, n in self.ops:
            out[n] += e - s
        return dict(out)

    def time_in(self, intervals, match) -> int:
        """Device ns of operations whose name ``match`` accepts and which
        start inside one of ``intervals``."""
        starts = [s for s, _, _ in self.ops]
        total = 0
        for a, b in intervals:
            i = bisect.bisect_left(starts, a)
            while i < len(self.ops) and self.ops[i][0] < b:
                s, e, n = self.ops[i]
                if match(n):
                    total += e - s
                i += 1
        return total

    def gaps_by_label(self, top: int = 10):
        agg = collections.Counter()
        for label, ns in self.gaps:
            agg[label] += ns
        return [[k, v / 1e9] for k, v in agg.most_common(top)]


def idle_pct(ctx):
    """The share of the traced window in which no operation ran on the
    device (operations merged): the reader of every cell's idle metric."""
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def _union(ops) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e, _ in ops:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _label(cpu, starts, t: int) -> str:
    """The innermost harness annotation and the innermost host operation
    that hold time ``t``."""
    i = bisect.bisect_right(starts, t)
    annot = op = None
    for j in range(i - 1, max(-1, i - 2000), -1):
        s, e, name, user = cpu[j]
        if e >= t:
            if user and name.startswith(PREFIX):
                annot = annot or name
            elif not user:
                op = op or name
        if annot and op:
            break
    return f"{annot or 'host'}:{op or 'python'}"


def summarize(prof) -> Trace:
    """The summary of a finished ``torch.profiler.profile``."""
    events = prof.profiler.kineto_results.events()
    dev, cpu = [], []
    for ev in events:
        s, e = ev.start_ns(), ev.end_ns()
        if ev.device_type().name == "CPU":
            cpu.append((s, e, ev.name(), ev.is_user_annotation()))
        elif not (ev.is_user_annotation() or ev.name().startswith(PREFIX)):
            # the device's copies of the host's annotations are no work
            dev.append((s, e, ev.name()))
    windows = [(s, e) for s, e, n, _ in cpu if n == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no window annotation")
    w0, w1 = windows[0]
    ops = sorted((max(s, w0), min(e, w1), n) for s, e, n in dev
                 if e > w0 and s < w1)
    busy = _union(ops)
    units = sorted((s, e) for s, e, n, _ in cpu if n == UNIT)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(edges[k], edges[k + 1]) for k in range(0, len(edges) - 1, 2)
            if edges[k + 1] > edges[k]]
    idle.sort(key=lambda g: g[0] - g[1])
    cpu.sort()
    starts = [c[0] for c in cpu]
    gaps = [(_label(cpu, starts, (a + b) // 2), b - a)
            for a, b in idle[:LABELLED_GAPS]]
    rest = sum(b - a for a, b in idle[LABELLED_GAPS:])
    if rest:
        gaps.append(("shorter gaps", rest))
    return Trace(window=(w0, w1), ops=ops,
                 busy_ns=int(np.sum([e - s for s, e in busy])) if busy else 0,
                 units=units, gaps=gaps)
