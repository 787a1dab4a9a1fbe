"""Device microseconds a frame outside the physics kernel (the spawn and
tail kernels, and any copy or set) in the units of a traced window."""

from .physics_kernel_roofline import KERNEL


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.frames:
        return None
    ns = t.time_in(t.units, lambda n: KERNEL not in n)
    return ns / 1e3 / ctx.frames
