"""Host microseconds a frame enqueued: the ``nbody.enqueue`` spans of the
traced window (``NBodySimulation._batch``'s re-arm of the loop's buffers
and its ``FrameGraphs.step`` loop, one graph replay a frame) in total,
over the frames they enqueued (their summed ``n``), host clock.  A port
that records no span reads nothing."""

from .nbody_idle_in_program_us_per_run import window_spans

SPAN = "nbody.enqueue"


def read(ctx):
    spans = [s for s in window_spans(ctx) if s.name == SPAN]
    frames = sum(s.n or 0 for s in spans)
    if not frames:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e3 / frames
