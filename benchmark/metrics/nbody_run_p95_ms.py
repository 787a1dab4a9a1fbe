"""The 95th percentile of the wall times of every run of the window,
host clock, each run ending in its host sync (``run`` reads its guards
back, then the last statistics are read)."""

import numpy as np


def read(ctx):
    if not ctx.unit_s:
        return None
    return float(np.percentile(np.asarray(ctx.unit_s) * 1e3, 95))
