"""Traffic of an emitter scene stepped in batches: a closed loop of
``PackedEngine.step_many(state, frames)``, the alive count read on the
host after each batch.

The mix's parameters (``traffic/<mix>.json``):

* ``setup_frames`` — frames stepped in set-up from the engine's empty
  ``init()``, to the scene's steady state;
* ``frames`` — frames a unit of work steps.

The configuration file holds the scene (``EmitterSceneConfig``'s fields),
its allocator and its layout; the scene's seed is ``--seed``.

The comparison (``workloads/<cell>.json``) checks the start on its own,
the plain reference stepping the set-up frames from empty, then follows
``sample`` batches, drawn from the seed among the first ``sample_from``,
from the program's own state before each: the window's whole length of
frames would outlast the window in plain PyTorch.  The states around a
sampled batch, and the start, are copied to the host (``hold``, outside
the timed units), so neither the window's time nor the device's memory
peak holds them.
"""

from __future__ import annotations

import random

import torch

from .. import compare
from ..reference import emitter as ref


def scene_config(conf: dict, seed: int):
    from particlesystem_tpu_torch import (Emitter, EmitterSceneConfig,
                                          PlaneCollider, SphereCollider)
    tup = lambda d: {k: tuple(v) if isinstance(v, list) else v
                     for k, v in d.items()}
    return EmitterSceneConfig(
        capacity=conf["capacity"], dt=conf["dt"],
        gravity=tuple(conf["gravity"]), wind=tuple(conf["wind"]),
        drag=conf["drag"],
        emitters=tuple(Emitter(**tup(e)) for e in conf["emitters"]),
        planes=tuple(PlaneCollider(**tup(p)) for p in conf["planes"]),
        spheres=tuple(SphereCollider(**tup(s)) for s in conf["spheres"]),
        seed=seed)


class Runner:
    def __init__(self, ctx):
        from particlesystem_tpu_torch import PackedEngine
        self.ctx = ctx
        conf = ctx.config
        self.cfg = scene_config(conf, ctx.seed)
        self.engine = PackedEngine(self.cfg, alloc=conf["alloc"],
                                   layout=conf["layout"], device=ctx.device)
        self.frames = int(ctx.mix["frames"])
        rng = random.Random(ctx.seed)
        chk = ctx.check
        self.sample = set(rng.sample(range(int(chk["sample_from"])),
                                     int(chk["sample"])))
        self.snaps = {}          # batch -> (before, after), on the host
        self._before = None
        self.alive = []          # alive count after each batch
        self.start = None
        ctx.counters.update(eager_frames=0, captures=0, replays=0)

    def _snap(self):
        """The engine's state copied to the host, field by field."""
        host = lambda a: a.to("cpu", copy=True)
        return (torch.stack([host(f) for f in
                             self.engine.flat_fields(self.es)]),
                host(self.es.accum), host(self.es.cursor), self.es.frame)

    def setup(self):
        self.es = self.engine.init()
        self.es = self.engine.step_many(self.es, int(self.ctx.mix["setup_frames"]))
        self.start = self._snap()
        self.alive0 = int(self.engine.alive_count(self.es))
        g = self.engine.graphs
        self._g0 = (g.eager_frames, g.captures, g.replays)

    def unit(self, i: int) -> bool:
        self.es = self.engine.step_many(self.es, self.frames)
        self.alive.append(int(self.engine.alive_count(self.es)))
        self.ctx.frames += self.frames
        return True

    def hold(self, i: int, after: bool) -> None:
        """A sampled batch's state before it and after it, to the host."""
        if after:
            self.snaps[i] = (self._before, self._snap())
        else:
            self._before = self._snap()

    def finish(self):
        g = self.engine.graphs
        c = self.ctx.counters
        c["eager_frames"] = g.eager_frames - self._g0[0]
        c["captures"] = g.captures - self._g0[1]
        c["replays"] = g.replays - self._g0[2]
        self.ctx.work.update(alive=[self.alive0] + self.alive,
                             frames_per_unit=self.frames,
                             slots=self.cfg.slots,
                             window=self.engine.spawn_width,
                             spawned_per_frame=sum(
                                 e.rate for e in self.cfg.emitters)
                             * self.cfg.dt)
        self.es = None
        self.engine = None
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
            torch.cuda.empty_cache()

    # -- the comparison --------------------------------------------------------
    def reference(self, ftype=torch.float32):
        sc = ref.Scene(self.ctx.config, self.ctx.seed)
        return sc, ref.Spawner(sc, self.ctx.device, ftype)

    def follow(self, snap, frames: int, sc, sp, ftype=torch.float32):
        fields, accum, cursor, frame = snap
        dev = self.ctx.device
        st = ref.State(fields.to(dev, ftype), accum.to(dev, ftype),
                       int(cursor), frame)
        return ref.run(st, frames, sc, sp)

    def check(self, control=None):
        """[(name, value, limit)] of the start and the sampled batches
        against the reference; with ``control`` (a float type) the
        reference in that type takes the program's place, from empty and
        for one batch from the program's set-up state, and no window is
        needed."""
        limits = self.ctx.check["limits"]
        dev, setup = self.ctx.device, int(self.ctx.mix["setup_frames"])
        sc, sp = self.reference()
        st = ref.run(ref.empty(sc, dev), setup, sc, sp)
        got, snaps = self.start, self.snaps
        if control is not None:
            csc, csp = self.reference(control)
            got = _snap_of(ref.run(ref.empty(csc, dev, control), setup,
                                   csc, csp))
            after = _snap_of(self.follow(self.start, self.frames, csc, csp,
                                         control))
            snaps = {0: (self.start, after)}
        out = compare.with_limits(self._numbers(got, st), limits, "start")
        for i in sorted(snaps):
            before, after = snaps[i]
            st = self.follow(before, self.frames, sc, sp)
            out += compare.with_limits(self._numbers(after, st), limits,
                                       f"batch{i}")
        return out

    @staticmethod
    def _numbers(snap, st):
        fields, accum, cursor, frame = snap
        return compare.emitter(
            fields.to(st.fields.device), st.fields,
            [*accum.tolist(), int(cursor), frame],
            [*st.accum.tolist(), st.cursor, st.frame])


def _snap_of(st: ref.State):
    return st.fields, st.accum, st.cursor, st.frame
