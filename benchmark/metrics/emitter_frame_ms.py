"""The window's wall time over the frames it stepped, host clock."""


def read(ctx):
    if not ctx.frames:
        return None
    return ctx.window_s * 1e3 / ctx.frames
