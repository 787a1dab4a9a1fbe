"""Native (C++) fast path for the emitter-scene oracle.

The reference's CPU path is native C++ (``particleSystem.cpp`` host
kernels); this is its analog for large validation runs: the physics inner
loop runs in ``native/psnative.cpp::ps_emitter_step`` via ctypes, with spawn
bookkeeping staying in numpy (identical to ``oracle_emitter.step``).  Falls
back to the numpy oracle when the shared library is unavailable.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..core.config import EmitterSceneConfig
from ..utils import native
from . import oracle_emitter
from .oracle_emitter import NpState


def step(s: NpState, spawn_pos, spawn_vel, spawn_life, spawn_w, spawn_valid,
         cfg: EmitterSceneConfig) -> NpState:
    lib = native.get_lib()
    if lib is None:
        return oracle_emitter.step(s, spawn_pos, spawn_vel, spawn_life,
                                   spawn_w, spawn_valid, cfg)

    # writable copies — the native kernel mutates in place
    pos = np.array(s.pos, np.float32, order="C")
    vel = np.array(s.vel, np.float32, order="C")
    age = np.array(s.age, np.float32, order="C")
    life = np.array(s.life, np.float32, order="C")
    alive = np.array(s.alive, np.uint8, order="C")
    # acc is not touched by the native kernel; reproduce the numpy oracle's
    # bookkeeping (a = g + (wind - v_old) * drag on alive rows)
    f32 = np.float32
    a = np.broadcast_to(np.asarray(cfg.gravity, f32), s.vel.shape).astype(f32)
    if cfg.drag:
        a = a + (np.asarray(cfg.wind, f32) - s.vel) * f32(cfg.drag)
    acc = np.where(s.alive[:, None], a, s.acc).astype(f32)

    planes = (native.PsPlane * max(1, len(cfg.planes)))()
    for i, pl in enumerate(cfg.planes):
        n = np.asarray(pl.normal, np.float32)
        n = n / np.linalg.norm(n)
        planes[i] = native.PsPlane(*pl.point, *n, pl.restitution, pl.friction)
    spheres = (native.PsSphere * max(1, len(cfg.spheres)))()
    for i, sp in enumerate(cfg.spheres):
        spheres[i] = native.PsSphere(*sp.center, sp.radius, sp.restitution,
                                     sp.friction)

    fptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    lib.ps_emitter_step(
        fptr(pos), fptr(vel), fptr(age), fptr(life),
        alive.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(age), np.float32(cfg.dt),
        *(np.float32(v) for v in cfg.gravity),
        *(np.float32(v) for v in cfg.wind),
        np.float32(cfg.drag),
        planes, len(cfg.planes), spheres, len(cfg.spheres))

    alive_b = alive.astype(bool)

    # spawn (identical bookkeeping to oracle_emitter.step)
    w = s.w.copy()
    parent = s.parent.copy()
    tag = s.tag.copy()
    free = np.flatnonzero(~alive_b)
    req = np.flatnonzero(spawn_valid)
    nfit = min(len(free), len(req))
    tgt, src = free[:nfit], req[:nfit]
    pos[tgt] = spawn_pos[src]
    vel[tgt] = spawn_vel[src]
    acc[tgt] = 0.0
    age[tgt] = 0.0
    life[tgt] = spawn_life[src]
    w[tgt] = spawn_w[src]
    alive_b[tgt] = True
    parent[tgt] = False
    tag[tgt] = 0

    return NpState(pos=pos, vel=vel, acc=acc, w=w, age=age, life=life,
                   alive=alive_b, parent=parent, tag=tag)
