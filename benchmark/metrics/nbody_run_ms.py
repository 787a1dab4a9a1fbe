"""The window's wall time over the runs it completed, host clock: a
closed loop, so the mean time a run takes, every run of the window in it.
A resumed run of twenty frames counts as one."""


def read(ctx):
    if ctx.completed <= 0:
        return None
    return ctx.window_s * 1e3 / ctx.completed
