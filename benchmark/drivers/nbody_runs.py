"""Traffic of reference n-body runs: a closed loop of runs of the user's
entry, ``NBodySimulation.run``, each from a state of its own.

The mix's parameters (``traffic/<mix>.json``):

* ``frames`` — the frames a run steps (``run(frames)``, auto-batched);
* ``resume_at`` — 0: every run starts from a fresh fill
  (``models/nbody.init_fill`` of ``NBodyConfig(seed=s_i)``), assigned to
  one warm ``NBodySimulation(active_bucketing=False)`` whose own seed
  draws every frame's fields, so every frame runs at full width and
  replays the one graph set-up captured; ``f > 0``: set-up makes
  ``states`` frame-``f`` states (a fresh simulation and ``run(f)`` for
  each of ``states`` seeds, compacted to the active prefix), and a run
  assigns the next of them to its warm simulation's ``state``, sets
  ``frame = f`` and calls ``run(frames)``; the simulation keeps the
  prefix it chose, so a run that moved it shows as a capture in the
  window (``counters``);
* ``warm_runs`` — fresh-fill runs made in set-up on seeds no run of the
  window takes, so the window finds every kernel built and every shape
  warmed.

A fresh ``NBodySimulation`` a run would leave its frame graphs' memory
pool cached, which a later capture cannot reclaim: a loop of them runs out
of memory (``PERF.md``, Open questions), hence the warm simulations.

Run ``i`` takes the seed :func:`run_seed` ``(seed, i)``.  The comparison
(``workloads/<cell>.json``: ``sample`` runs among the first
``sample_from``, drawn from the seed) runs the plain reference from the
fill (or, resumed, from the state the run was handed, itself held against
the reference from its fill) over the same frames and compares the
states by particle.  A sampled run's answer is copied to the host
(``hold``, outside the timed units).
"""

from __future__ import annotations

import dataclasses
import random

import torch

from .. import compare
from ..reference import nbody as ref

#: runs of a window whose seeds do not collide with set-up's
SEED_STRIDE = 1 << 20


def run_seed(seed: int, i: int) -> int:
    """Run ``i``'s seed: distinct for every (seed, i) with |i| below half
    the stride; set-up's runs take negative ``i``."""
    return seed * SEED_STRIDE + SEED_STRIDE // 2 + i


def to_ref(st) -> ref.State:
    return ref.State(**{f: getattr(st, f) for f in ref.FIELDS})


STAT_FIELDS = ref.STATS


class Runner:
    def __init__(self, ctx):
        from particlesystem_tpu_torch import (GridSpec, NBodyConfig,
                                              NBodySimulation)
        self.ctx = ctx
        self.Sim = NBodySimulation
        conf = ctx.config
        keys = {f.name for f in dataclasses.fields(NBodyConfig)} - {"grid",
                                                                   "seed"}
        kw = {k: v for k, v in conf.items() if k in keys}
        grid = GridSpec(**conf["grid"])
        self.config = lambda s: NBodyConfig(grid=grid, seed=s, **kw)
        mix = ctx.mix
        self.frames = int(mix["frames"])
        self.resume_at = int(mix.get("resume_at", 0))
        self.n_states = int(mix.get("states", 1))
        chk = ctx.check
        rng = random.Random(ctx.seed)
        self.sample = set(rng.sample(range(int(chk["sample_from"])),
                                     int(chk["sample"])))
        self.kept = {}        # run -> (state on the host, host stats)
        self.sims, self.starts = [], []
        self._last = None     # the last unit's (simulation, host stats)
        c = ctx.counters
        for k in ("runs", "eager_frames", "captures", "replays"):
            c[k] = 0

    @property
    def frame_seed(self) -> int:
        """The seed of the warm simulation's frames (fresh fills)."""
        return run_seed(self.ctx.seed, -2000)

    def state_seed(self, j: int) -> int:
        return run_seed(self.ctx.seed, -1000 - j)

    # -- set-up ------------------------------------------------------------
    def setup(self):
        dev = self.ctx.device
        if not self.resume_at:
            from particlesystem_tpu_torch.models.nbody import init_fill
            self.init_fill = init_fill
            self.sims.append(self.Sim(self.config(self.frame_seed),
                                      device=dev, active_bucketing=False))
            for j in range(int(self.ctx.mix.get("warm_runs", 0))):
                self._refill(run_seed(self.ctx.seed, -1 - j))
            return
        for j in range(self.n_states):
            sim = self.Sim(self.config(self.state_seed(j)), device=dev)
            sim.run(self.resume_at)
            self.starts.append(sim.state.map(lambda a: a.clone()))
            self.sims.append(sim)
            self._resume(j)     # the prefix's eager frame and capture

    # -- the window ----------------------------------------------------------
    @staticmethod
    def _counts(sim):
        g = sim.graphs
        return g.eager_frames, g.captures, g.replays

    def _refill(self, s: int):
        sim = self.sims[0]
        sim.state = self.init_fill(self.config(s), self.ctx.device)
        sim.frame = 0
        before = self._counts(sim)
        stats = sim.run(self.frames)
        return sim, stats, [a - b for a, b in zip(self._counts(sim), before)]

    def _resume(self, j: int):
        sim = self.sims[j]
        sim.state = self.starts[j]
        sim.frame = self.resume_at
        before = self._counts(sim)
        stats = sim.run(self.frames)
        return sim, stats, [a - b for a, b in zip(self._counts(sim), before)]

    def unit(self, i: int) -> bool:
        if self.resume_at:
            sim, stats, counts = self._resume(i % self.n_states)
        else:
            sim, stats, counts = self._refill(run_seed(self.ctx.seed, i))
        host = torch.stack([getattr(stats, f) for f in STAT_FIELDS]).tolist()
        c = self.ctx.counters
        c["runs"] += 1
        for k, v in zip(("eager_frames", "captures", "replays"), counts):
            c[k] += v
        self.ctx.frames += self.frames
        self._last = (sim, dict(zip(STAT_FIELDS, host)))
        return True

    def hold(self, i: int, after: bool) -> None:
        """A sampled run's final state and statistics, to the host."""
        if after:
            sim, host = self._last
            self.kept[i] = (sim.state.map(
                lambda a: a.to("cpu", copy=True)), host)

    def finish(self):
        """Frees the program's state; the kept answers stay."""
        self.sims.clear()
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
            torch.cuda.empty_cache()

    # -- the comparison ---------------------------------------------------------
    def reference_run(self, i: int, ftype=torch.float32):
        """The reference's (scene, final state, last stats, frames' work)
        for run ``i``, in ``ftype``."""
        dev = self.ctx.device
        if self.resume_at:
            j = i % self.n_states
            start = to_ref(self.starts[j]).map(
                lambda a: a.to(ftype) if a.is_floating_point() else a)
            sc = ref.Scene.from_config(self.ctx.config, self.state_seed(j))
        else:
            sc = ref.Scene.from_config(self.ctx.config, self.frame_seed,
                                       fill_seed=run_seed(self.ctx.seed, i))
            start = ref.fill(sc, dev, ftype)
        st, stats, work = ref.run(start, self.resume_at, self.frames, sc,
                                  count_pairs=self.ctx.traced)
        return sc, st, stats, work

    def check(self, control=None):
        """[(name, value, limit)] of the sampled runs against the
        reference; with ``control`` (a float type) the reference in that
        type takes the program's place, and no window is needed."""
        limits = self.ctx.check["limits"]
        dev = self.ctx.device
        out, sampled = [], []
        for i in sorted(self.kept if control is None else self.sample):
            if self.resume_at:
                j = i % self.n_states
                sc = ref.Scene.from_config(self.ctx.config,
                                           self.state_seed(j))
                r0 = ref.run(ref.fill(sc, dev), 0, self.resume_at, sc)[0]
                got = (to_ref(self.starts[j]) if control is None else
                       ref.run(ref.fill(sc, dev, control), 0,
                               self.resume_at, sc)[0])
                out += compare.with_limits(
                    compare.nbody(got, ref.compact(r0)), limits,
                    f"start.run{i}")
            _, st, rstats, work = self.reference_run(i)
            if control is None:
                got = to_ref(self.kept[i][0]).map(lambda a: a.to(dev))
                gstats = self.kept[i][1]
            else:
                _, got, gstats, _ = self.reference_run(i, control)
            out += compare.with_limits(compare.nbody(got, st, gstats, rstats),
                                       limits, f"run{i}")
            sampled.append((i, work))
        self.ctx.work["sampled"] = sampled
        return out
