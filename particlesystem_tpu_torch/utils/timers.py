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
from typing import Callable, Dict

import numpy as np
import torch


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
