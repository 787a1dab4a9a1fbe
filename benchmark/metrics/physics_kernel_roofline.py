"""The physics kernel's share of its bytes bound over a traced window:
every frame's bytes (``work.emitter_physics``: each slot's age and life,
a live row's fields, the window's valid rows; the live count of a batch
the mean of the counts read before and after it) at the card's memory
peak, over the kernel's device time."""

from .. import peaks, work

KERNEL = "physics_step_kernel"


def read(ctx):
    t, w = ctx.trace, ctx.work
    if t is None or "alive" not in w:
        return None
    ns = sum(v for n, v in t.by_name().items() if KERNEL in n)
    if not ns:
        return None
    alive, k = w["alive"], w["frames_per_unit"]
    nbytes = sum(k * work.emitter_physics(w["slots"], (a + b) / 2,
                                          w["spawned_per_frame"],
                                          w["window"])
                 for a, b in zip(alive, alive[1:]))
    return 100.0 * nbytes / peaks.HBM_BYTES / (ns / 1e9)
