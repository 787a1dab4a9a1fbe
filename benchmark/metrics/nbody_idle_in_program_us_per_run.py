"""Device-idle microseconds a run inside the program's own spans: the
traced window's idle time (device operations merged, as
``trace.idle_pct`` merges them) that falls inside the union of the spans
the port recorded in the window (``particlesystem_tpu_torch.utils.timers
.spans()``: a run's hand-in, enqueue, readback, guards, compaction and
fill), over the runs the window completed.  The rest of the window's
idle lies in the benchmark's own code between calls into the port.  A
port that records no span reads nothing."""

from ..trace import _union


def window_spans(ctx) -> list:
    """The port's spans that overlap the traced window; [] where there is
    no trace or the port records none."""
    t = ctx.trace
    if t is None:
        return []
    try:
        from particlesystem_tpu_torch.utils import timers
    except ImportError:
        return []
    spans = getattr(timers, "spans", None)
    if spans is None:
        return []
    w0, w1 = t.window
    return [s for s in spans() if s.start_ns < w1 and s.end_ns > w0]


def _overlap_ns(a, b) -> int:
    """The ns two sorted lists of disjoint intervals share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_spans_ns(ctx, spans) -> int:
    """Device-idle ns of the window inside the union of ``spans``."""
    w0, w1 = ctx.trace.window
    inside = _union(sorted((max(s.start_ns, w0), min(s.end_ns, w1), None)
                           for s in spans))
    busy = _union(ctx.trace.ops)
    return sum(e - s for s, e in inside) - _overlap_ns(inside, busy)


def read(ctx):
    spans = window_spans(ctx)
    if not spans or ctx.completed <= 0:
        return None
    return idle_in_spans_ns(ctx, spans) / 1e3 / ctx.completed
