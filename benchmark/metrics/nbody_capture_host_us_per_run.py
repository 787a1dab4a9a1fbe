"""Host microseconds a run inside the frame loop's captures: the
``graphs.capture`` spans of the traced window (``FrameGraphs._capture``,
a key's frame captured into a CUDA graph) in total, over the runs the
window completed, host clock.  A port that records no span reads
nothing."""

from .nbody_idle_in_program_us_per_run import window_spans

SPAN = "graphs.capture"


def read(ctx):
    spans = [s for s in window_spans(ctx) if s.name == SPAN]
    if not spans or ctx.completed <= 0:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e3 / ctx.completed
