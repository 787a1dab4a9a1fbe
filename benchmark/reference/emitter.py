"""The emitter scene, frame by frame, in plain PyTorch.

Semantics of BASELINE.md's emitter scenes with the strided (``select``)
allocator:

* each emitter owes ``rate * dt`` particles a frame; a float32 credit
  carries the fraction, and the first ``floor(credit + rate dt)`` rows of
  its budget ``ceil(rate dt) + 1`` are valid;
* a row's draws: eight uniforms under ``frame_key(seed, f, EMIT, salt)``
  and a lattice unit vector under ``.., salt, 1``; position ``pos0 + dir *
  radius * cbrt(u0)``, direction in a cone (``theta = cone sqrt(u1)``,
  ``phi = 2 pi u2``) about the emitter's axis, speed ``speed (1 + jitter
  (2 u3 - 1))``, life ``life_min + u4 (life_max - life_min)``;
* physics of a live row (``age <= life`` and ``life > 0``): ``a = g +
  (wind - v) drag``, ``v += a dt``, ``p += v dt``, then each plane and
  sphere pushes the position out along its normal and reflects an
  inbound normal velocity (restitution) and scales the tangential one
  (``1 - friction``); ``age += dt``.  Dead rows are frozen;
* the frame's rows go to the window of the budget rounded up to 1,024
  slots at the cursor, a valid row replacing the slot's resident, and the
  cursor moves on by the window, modulo the slots.

Float operations take ``ftype`` (``float32`` the reference, ``bfloat16``
the control).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import threefry as tf


def f32(x: float) -> float:
    return float(np.float32(x))


def basis(direction) -> np.ndarray:
    """(axis, e1, e2) float32, orthonormal."""
    d = np.asarray(direction, np.float32)
    d = d / np.linalg.norm(d)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    if abs(float(np.dot(d, up))) > 0.9:
        up = np.array([1.0, 0.0, 0.0], np.float32)
    e1 = np.cross(d, up)
    e1 = e1 / np.linalg.norm(e1)
    return np.stack([d, e1, np.cross(d, e1)])


@dataclasses.dataclass
class Scene:
    conf: dict
    seed: int
    salt: int = 0

    @property
    def slots(self) -> int:
        return -(-self.conf["capacity"] // 1024) * 1024

    @property
    def budgets(self):
        dt = self.conf["dt"]
        return [int(math.ceil(e["rate"] * dt)) + 1
                for e in self.conf["emitters"]]

    @property
    def window(self) -> int:
        dt = self.conf["dt"]
        total = sum(e["rate"] for e in self.conf["emitters"])
        need = -(-(int(math.ceil(total * dt)) + len(self.conf["emitters"]))
                 // 8) * 8
        return -(-max(1, need) // 1024) * 1024


@dataclasses.dataclass
class State:
    fields: torch.Tensor   # (8, N): x, y, z, vx, vy, vz, age, life
    accum: torch.Tensor    # (E,) float32 credit
    cursor: int
    frame: int


def empty(sc: Scene, device, ftype=torch.float32) -> State:
    e = max(1, len(sc.conf["emitters"]))
    return State(torch.zeros((8, sc.slots), dtype=ftype, device=device),
                 torch.zeros(e, dtype=ftype, device=device), 0, 0)


class Spawner:
    """A scene's per-row constants, then each frame's rows."""

    def __init__(self, sc: Scene, device, ftype):
        self.sc, self.dev, self.ft = sc, device, ftype
        ems = sc.conf["emitters"]
        dt = sc.conf["dt"]
        col = lambda get: torch.tensor(np.concatenate(
            [np.full(b, get(e), np.float32) for e, b in
             zip(ems, sc.budgets)]), device=device)
        self.total = sum(sc.budgets)
        self.pos0 = torch.tensor(np.concatenate(
            [np.tile(np.asarray(e["pos"], np.float32), (b, 1))
             for e, b in zip(ems, sc.budgets)]), device=device)
        bs = np.concatenate([np.tile(basis(e["direction"]).reshape(1, 9),
                                     (b, 1)) for e, b in
                             zip(ems, sc.budgets)])
        self.b = [torch.tensor(bs[:, 3 * i:3 * i + 3], device=device)
                  for i in range(3)]
        self.radius = col(lambda e: e["radius"])
        self.cone = col(lambda e: e["cone_angle"])
        self.speed = col(lambda e: e["speed"])
        self.jitter = col(lambda e: e["speed_jitter"])
        self.lmin = col(lambda e: e["life_min"])
        self.lspan = col(lambda e: e["life_max"] - e["life_min"])
        self.local = torch.tensor(np.concatenate(
            [np.arange(b, dtype=np.float32) for b in sc.budgets]),
            device=device)
        self.owner = torch.tensor(np.repeat(np.arange(len(ems)),
                                            sc.budgets), device=device)
        self.rates = torch.tensor(
            np.asarray([e["rate"] * dt for e in ems], np.float32),
            device=device).to(ftype)

    def block(self, f0: int, count: int):
        """Frames ``f0 .. f0 + count - 1``'s rows, (count, 8, W), all
        drawn at once; their ``valid`` follows the credit, frame by
        frame (:meth:`valid`)."""
        sc, dev, t = self.sc, self.dev, self.total
        frames = torch.arange(f0, f0 + count, dtype=torch.int64, device=dev)
        base = tf.fold_in(tf.fold_in(tf.fold_in(tf.key(sc.seed), tf.EMIT),
                                     frames), sc.salt)
        u = tf.unit01(base, (t, 8), dev)                     # (F, t, 8)
        dirs = tf.lattice_unit(tf.unit01(tf.fold_in(base, 1), (t, 3), dev))
        r = self.radius * torch.pow(u[..., 0].double(), 1.0 / 3.0).float()
        pos = self.pos0 + dirs * r[..., None]
        theta = self.cone * torch.sqrt(u[..., 1].double()).float()
        phi = f32(2.0 * math.pi) * u[..., 2]
        d = (torch.cos(theta)[..., None] * self.b[0]
             + (torch.sin(theta) * torch.cos(phi))[..., None] * self.b[1]
             + (torch.sin(theta) * torch.sin(phi))[..., None] * self.b[2])
        speed = self.speed * (1.0 + self.jitter * (2.0 * u[..., 3] - 1.0))
        vel = d * speed[..., None]
        life = self.lmin + u[..., 4] * self.lspan
        rows = torch.zeros((count, 8, sc.window), dtype=self.ft, device=dev)
        rows[:, 0:3, :t] = pos.transpose(1, 2).to(self.ft)
        rows[:, 3:6, :t] = vel.transpose(1, 2).to(self.ft)
        rows[:, 7, :t] = life.to(self.ft)
        return rows

    def valid(self, accum: torch.Tensor):
        """(the frame's (W,) valid rows, the next credit)."""
        want = accum.to(self.ft) + self.rates
        n = torch.floor(want)
        v = torch.zeros(self.sc.window, dtype=torch.bool, device=self.dev)
        v[:self.total] = self.local < n[self.owner]
        return v, want - n


def physics(fl: torch.Tensor, conf: dict) -> torch.Tensor:
    """The next fields of every slot, dead rows frozen."""
    x, y, z, vx, vy, vz, age, life = fl.unbind(0)
    dt = f32(conf["dt"])
    gx, gy, gz = (f32(v) for v in conf["gravity"])
    k = f32(conf["drag"])
    wx, wy, wz = (f32(v) for v in conf["wind"])
    if k:
        vx1 = vx + (gx + (wx - vx) * k) * dt
        vy1 = vy + (gy + (wy - vy) * k) * dt
        vz1 = vz + (gz + (wz - vz) * k) * dt
    else:
        vx1, vy1, vz1 = vx + f32(gx * dt), vy + f32(gy * dt), vz + f32(gz * dt)
    x1, y1, z1 = x + vx1 * dt, y + vy1 * dt, z + vz1 * dt

    def respond(x1, y1, z1, vx1, vy1, vz1, n, depth_pos, contact, e, mu):
        nx, ny, nz = n
        x1 = torch.where(contact, x1 + nx * depth_pos, x1)
        y1 = torch.where(contact, y1 + ny * depth_pos, y1)
        z1 = torch.where(contact, z1 + nz * depth_pos, z1)
        vn = vx1 * nx + vy1 * ny + vz1 * nz
        inb = contact & (vn < 0)
        vx1 = torch.where(inb, (vx1 - nx * vn) * mu - nx * vn * e, vx1)
        vy1 = torch.where(inb, (vy1 - ny * vn) * mu - ny * vn * e, vy1)
        vz1 = torch.where(inb, (vz1 - nz * vn) * mu - nz * vn * e, vz1)
        return x1, y1, z1, vx1, vy1, vz1

    for pl in conf["planes"]:
        n = np.asarray(pl["normal"], np.float32)
        nx, ny, nz = (float(v) for v in n / np.linalg.norm(n))
        px, py, pz = (f32(v) for v in pl["point"])
        d = (x1 - px) * nx + (y1 - py) * ny + (z1 - pz) * nz
        x1, y1, z1, vx1, vy1, vz1 = respond(
            x1, y1, z1, vx1, vy1, vz1, (nx, ny, nz), -d, d < 0,
            f32(pl["restitution"]), f32(1.0 - pl["friction"]))
    for sp in conf["spheres"]:
        cx, cy, cz = (f32(v) for v in sp["center"])
        dx, dy, dz = x1 - cx, y1 - cy, z1 - cz
        dist = torch.sqrt((dx * dx + dy * dy + dz * dz).double()).to(x.dtype)
        safe = torch.clamp(dist, min=f32(1e-20))
        n = (dx / safe, dy / safe, dz / safe)
        depth = f32(sp["radius"]) - dist
        x1, y1, z1, vx1, vy1, vz1 = respond(
            x1, y1, z1, vx1, vy1, vz1, n, depth, depth > 0,
            f32(sp["restitution"]), f32(1.0 - sp["friction"]))
    alive = (age <= life) & (life > 0)
    new = [torch.where(alive, a, b) for a, b in
           zip((x1, y1, z1, vx1, vy1, vz1), (x, y, z, vx, vy, vz))]
    return torch.stack(new + [torch.where(alive, age + dt, age), life])


#: frames whose rows one draw makes
BLOCK = 256


def run(st: State, frames: int, sc: Scene, sp: Spawner) -> State:
    """``frames`` frames from ``st``: each frame's physics, then its rows
    into the window at the cursor."""
    fl, accum, cursor, w = st.fields, st.accum, st.cursor, sc.window
    for j in range(frames):
        if j % BLOCK == 0:
            rows = sp.block(st.frame + j, min(BLOCK, frames - j))
        valid, accum = sp.valid(accum)
        fl = physics(fl, sc.conf)
        win = fl[:, cursor:cursor + w]
        fl[:, cursor:cursor + w] = torch.where(valid, rows[j % BLOCK], win)
        cursor = (cursor + w) % sc.slots
    return State(fl, accum, cursor, st.frame + frames)
