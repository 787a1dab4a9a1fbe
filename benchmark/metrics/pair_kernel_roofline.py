"""The pair kernel's share of its roofline over the sampled runs of a
traced window: the least time the card could take for the pair work of
every frame those runs stepped (the larger of the stencil's pairs at 27
float32 operations each and the live rows' bytes, ``work.pair_pass``),
over the kernel's device time in those runs' host intervals.  The pairs
are counted on the reference's states of the same frames."""

from .. import peaks, work

KERNEL = "cluster_pair_kernel"


def read(ctx):
    t, sampled = ctx.trace, ctx.work.get("sampled")
    if t is None or not sampled:
        return None
    bound = ns = 0.0
    for i, frames in sampled:
        if i >= len(t.units) or any(p is None for *_, p in frames):
            continue
        k = t.time_in([t.units[i]], lambda n: KERNEL in n)
        if not k:
            continue
        ns += k
        bound += sum(peaks.bound_s(*work.pair_pass(pairs, alive))
                     for _, _, alive, pairs in frames)
    return 100.0 * bound / (ns / 1e9) if ns else None
