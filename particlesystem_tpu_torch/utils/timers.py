"""Per-phase wall-clock timers.

The reference samples ``getCurrentTimeInSecs()`` around each pipeline stage
(``source/code/src/particleSystem.cpp:1846-1927``).  This is
the structured equivalent: named phases with running totals, on
``time.perf_counter``.  Device work is asynchronous, so a phase measures
device time only when it ends at a synchronisation point (the driver's
per-batch guard readback is one).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class PhaseTimers:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
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
