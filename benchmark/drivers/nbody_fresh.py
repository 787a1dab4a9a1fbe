"""Traffic of fresh reference runs, the reference's own deployment: a
closed loop in which each run builds ``NBodySimulation(NBodyConfig(seed=
s_i))`` with the class's defaults (the blocks pass, the active prefix),
calls ``run(frames)`` (one eager frame, one capture, the replays, then the
compaction to the prefix), reads the last statistics to the host and
drops the simulation.

The mix's parameters (``traffic/<mix>.json``):

* ``frames`` — the frames a run steps (``run(frames)``, auto-batched);
* ``warm_runs`` — fresh runs made in set-up on seeds no run of the window
  takes, so the window finds every kernel built, every shape warmed and
  the graph memory the captures share already reserved.

Run ``i`` takes the seed ``nbody_runs.run_seed(seed, i)`` for its fill
and its frames alike, and is compared as ``nbody_runs`` compares a fresh
fill's run: sampled runs among the first ``sample_from`` against the
plain reference from the same seed, particle by particle (matched by tag,
so the compaction does not matter).

Memory guard: every :data:`GUARD_EVERY`-th run reads the card's reserved
memory after it, and fails (it raises, so the window counts it in
``failed``) when that lies more than :data:`GUARD_BYTES` above the reading
at the end of set-up; the :data:`GUARD_STRIKES`-th such run ends the whole
run with a non-zero exit.  A run lets go of the previous run's simulation
before it builds its own, so the guard reads one simulation's memory: a
program that leaks a graph pool a run (~258 MB at 1M) fails within a few
dozen runs and stops, instead of filling the card.  Reading the allocator
every few runs keeps its host time out of most runs' wall time.
"""

from __future__ import annotations

import torch

from ..reference import nbody as ref
from . import nbody_runs
from .nbody_runs import run_seed

#: growth of the reserved memory past set-up's at which a run fails
GUARD_BYTES = 1 << 30
#: failed guards that end the run: past them every run would fail alike
GUARD_STRIKES = 3
#: the guard reads the reserved memory after every this many runs
GUARD_EVERY = 4


def reserved_bytes(device) -> int:
    """``torch.cuda.memory_reserved(device)``, read from the allocator's
    nested statistics: ``memory_reserved`` flattens and sorts every
    statistic first, host time that every run would pay."""
    return torch.cuda.memory_stats_as_nested_dict(device)[
        "reserved_bytes"]["all"]["current"]


class Runner(nbody_runs.Runner):
    def __init__(self, ctx):
        super().__init__(ctx)
        dev = ctx.device
        #: the card's reserved bytes (0 on the CPU); the tests replace it
        self.reserved = ((lambda: reserved_bytes(dev))
                         if dev.type == "cuda" else (lambda: 0))
        self.reserved_setup = 0
        self.strikes = 0

    def setup(self):
        for j in range(int(self.ctx.mix.get("warm_runs", 0))):
            self._refill(run_seed(self.ctx.seed, -1 - j))
        self._sync()
        self.reserved_setup = self.reserved()
        self.ctx.counters["reserved_setup_bytes"] = self.reserved_setup

    def _sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def _refill(self, s: int):
        """A fresh simulation of seed ``s`` and its run, the previous
        run's simulation let go first: (simulation, last stats, [eager
        frames, captures, replays])."""
        self._last = None
        sim = self.Sim(self.config(s), device=self.ctx.device)
        stats = sim.run(self.frames)
        return sim, stats, list(self._counts(sim))

    def unit(self, i: int) -> bool:
        ok = super().unit(i)
        if i % GUARD_EVERY != GUARD_EVERY - 1:
            return ok
        grown = self.reserved() - self.reserved_setup
        if grown > GUARD_BYTES:
            self.strikes += 1
            msg = (f"run {i}: reserved memory {grown} B above set-up's, "
                   f"past the guard's {GUARD_BYTES} B")
            if self.strikes >= GUARD_STRIKES:
                raise SystemExit(f"{msg}; {self.strikes} runs failed the "
                                 f"memory guard, the run ends")
            raise RuntimeError(msg)
        return ok

    def finish(self):
        self._last = None
        self._sync()
        c = self.ctx.counters
        c["reserved_end_bytes"] = self.reserved()
        from particlesystem_tpu_torch.utils import frame_graph
        # the pool's counters, where the program keeps them
        c.update(getattr(frame_graph, "counters", {}))
        super().finish()

    def reference_run(self, i: int, ftype=torch.float32):
        """The reference's (scene, final state, last stats, frames' work)
        for run ``i``: its fill and frames from the run's own seed."""
        sc = ref.Scene.from_config(self.ctx.config,
                                   run_seed(self.ctx.seed, i))
        st, stats, work = ref.run(ref.fill(sc, self.ctx.device, ftype), 0,
                                  self.frames, sc,
                                  count_pairs=self.ctx.traced)
        return sc, st, stats, work
