"""Numpy oracle for the emitter scene.

Independent re-implementation of ``models/emitter.step_core`` used as the
trajectory-fidelity contract: the reference *intended* serial-vs-parallel
validation but stubbed it out (``DoCompare`` returns 0 unconditionally,
the reference's
``source/code/src/particleSystem.cpp:2254-2257``; comparison
helpers ``utils.h:9-17`` are never called).  Here the oracle is real and the
tests enforce it.

All arithmetic is float32 to match the device path; spawn rows are supplied
by the caller (generated once by ``models/emitter.spawn_fields``) so the
comparison isolates physics from RNG plumbing.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.config import EmitterSceneConfig


@dataclasses.dataclass
class NpState:
    pos: np.ndarray
    vel: np.ndarray
    acc: np.ndarray
    w: np.ndarray
    age: np.ndarray
    life: np.ndarray
    alive: np.ndarray
    parent: np.ndarray
    tag: np.ndarray

    @classmethod
    def from_torch(cls, s):
        """From the port's ``ParticleState`` (tags come back as uint32)."""
        from ..core.state import state_to_numpy
        return cls(**state_to_numpy(s))


def _respond(pos, vel, n, depth, restitution, friction):
    contact = depth > 0
    pos = np.where(contact[:, None], pos + n * depth[:, None], pos)
    vn = np.sum(vel * n, axis=1, dtype=np.float32)
    inbound = contact & (vn < 0)
    vnn = n * vn[:, None]
    vt = vel - vnn
    new_vel = vt * np.float32(1.0 - friction) - vnn * np.float32(restitution)
    vel = np.where(inbound[:, None], new_vel, vel)
    return pos.astype(np.float32), vel.astype(np.float32)


def step(s: NpState, spawn_pos, spawn_vel, spawn_life, spawn_w, spawn_valid,
         cfg: EmitterSceneConfig) -> NpState:
    f32 = np.float32
    dt = f32(cfg.dt)
    alive = s.alive

    a = np.broadcast_to(np.asarray(cfg.gravity, f32), s.vel.shape).astype(f32)
    if cfg.drag:
        a = a + (np.asarray(cfg.wind, f32) - s.vel) * f32(cfg.drag)
    v1 = (s.vel + a * dt).astype(f32)
    p1 = (s.pos + v1 * dt).astype(f32)

    for pl in cfg.planes:
        n = np.asarray(pl.normal, f32)
        n = n / np.sqrt(np.sum(n * n)).astype(f32)
        d = np.sum((p1 - np.asarray(pl.point, f32)) * n, axis=1, dtype=f32)
        p1, v1 = _respond(p1, v1, n, -d, pl.restitution, pl.friction)
    for sp in cfg.spheres:
        c = np.asarray(sp.center, f32)
        dvec = p1 - c
        dist = np.sqrt(np.sum(dvec * dvec, axis=1, dtype=f32)).astype(f32)
        nrm = dvec / np.maximum(dist, f32(1e-20))[:, None]
        p1, v1 = _respond(p1, v1, nrm, f32(sp.radius) - dist,
                          sp.restitution, sp.friction)

    age1 = (s.age + dt).astype(f32)
    keep = alive[:, None]
    pos = np.where(keep, p1, s.pos)
    vel = np.where(keep, v1, s.vel)
    acc = np.where(keep, a, s.acc)
    age = np.where(alive, age1, s.age)
    alive1 = alive & (age1 <= s.life)

    # spawn: free slots ascending meet requests ascending (ops/compact.py)
    life = s.life.copy()
    w = s.w.copy()
    parent = s.parent.copy()
    free = np.flatnonzero(~alive1)
    req = np.flatnonzero(spawn_valid)
    nfit = min(len(free), len(req))
    tgt, src = free[:nfit], req[:nfit]
    pos[tgt] = spawn_pos[src]
    vel[tgt] = spawn_vel[src]
    acc[tgt] = 0.0
    age[tgt] = 0.0
    life[tgt] = spawn_life[src]
    w[tgt] = spawn_w[src]
    alive1[tgt] = True
    parent[tgt] = False
    tag = s.tag.copy()
    tag[tgt] = 0

    return NpState(pos=pos.astype(f32), vel=vel.astype(f32),
                   acc=acc.astype(f32), w=w, age=age.astype(f32),
                   life=life, alive=alive1, parent=parent, tag=tag)


def step_slim(pos, vel, death, cursor: int, frame: int,
              spawn_pos, spawn_vel, spawn_life, spawn_valid,
              cfg: EmitterSceneConfig):
    """Numpy mirror of the slim-layout engine frame
    (``runtime.engine.PackedEngine(layout="slim")``): integration of every
    once-spawned row (``death > 0``; expired rows are garbage until
    respawn, never-spawned rows stay frozen — the select shape
    ``ops.fused_step.physics_step_slim`` documents), then ring-ordered
    spawn writes; liveness is ``frame < death`` with
    ``death = spawn_frame + life/dt``.  Returns (pos, vel, death, cursor).
    """
    f32 = np.float32
    n = pos.shape[0]
    dt = f32(cfg.dt)

    a = np.broadcast_to(np.asarray(cfg.gravity, f32), vel.shape).astype(f32)
    if cfg.drag:
        a = a + (np.asarray(cfg.wind, f32) - vel) * f32(cfg.drag)
    v1 = (vel + a * dt).astype(f32)
    p1 = (pos + v1 * dt).astype(f32)
    for pl in cfg.planes:
        nrm = np.asarray(pl.normal, f32)
        nrm = nrm / np.sqrt(np.sum(nrm * nrm)).astype(f32)
        d = np.sum((p1 - np.asarray(pl.point, f32)) * nrm, axis=1, dtype=f32)
        p1, v1 = _respond(p1, v1, nrm, -d, pl.restitution, pl.friction)
    for sp in cfg.spheres:
        c = np.asarray(sp.center, f32)
        dvec = p1 - c
        dist = np.sqrt(np.sum(dvec * dvec, axis=1, dtype=f32)).astype(f32)
        nrm = dvec / np.maximum(dist, f32(1e-20))[:, None]
        p1, v1 = _respond(p1, v1, nrm, f32(sp.radius) - dist,
                          sp.restitution, sp.friction)

    frozen = ~(death > 0)
    p1[frozen] = pos[frozen]
    v1[frozen] = vel[frozen]

    death = death.copy()
    req = np.flatnonzero(spawn_valid)
    tgt = (cursor + np.arange(len(req))) % n
    p1[tgt] = spawn_pos[req]
    v1[tgt] = spawn_vel[req]
    death[tgt] = f32(frame) + spawn_life[req] / dt
    return (p1.astype(f32), v1.astype(f32), death,
            (cursor + len(req)) % n)
