"""The n-body frame's per-row work (everything on the device but the pair
kernel: the draw, the binning and sort, kernels A-E, the fill, the
compaction) against the bytes that work has to move in any
implementation: each live row's state read once and written once
(``work.nbody_rows``), over the sampled runs of a traced window."""

from .. import peaks, work
from .pair_kernel_roofline import KERNEL


def read(ctx):
    t, sampled = ctx.trace, ctx.work.get("sampled")
    if t is None or not sampled:
        return None
    bound = ns = 0.0
    for i, frames in sampled:
        if i >= len(t.units):
            continue
        k = t.time_in([t.units[i]], lambda n: KERNEL not in n)
        if not k:
            continue
        ns += k
        bound += sum(work.nbody_rows(alive) for _, _, alive, _ in frames) \
            / peaks.HBM_BYTES
    return 100.0 * bound / (ns / 1e9) if ns else None
