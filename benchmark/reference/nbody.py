"""The reference particle simulation, frame by frame, in plain PyTorch.

Semantics of the reference's ``particleSystem.cpp`` as the n-body scene
states them:

* fill: slot ``i < n`` at ``sign * r * half_extent`` (each coordinate's
  ``r`` and fair sign drawn under ``frame_key(seed, 0, FILL, 0)`` and
  ``.., 1``), an adult age under ``.., 2``, a fertility age under ``.., 3``,
  the default weight; tag ``i`` for every slot;
* a frame: each slot's random fields keyed by its tag (a lattice unit
  vector under ``fold_in(frame_key(seed, f, UVEC), tag)``, a fertility age
  under ``FERT``); the torus wrap and the cell ids (``i1 = floor(-y/c) +
  G/2``, ``i2 = floor(x/c) + G/2``, ``i3 = floor(-z/c) + G/2``, id ``i3 G^2
  + i1 G + i2``); cell lists in ascending slot order, rows past the cell
  capacity killed; over the 27-cell stencil (no wrap at the box's faces)
  softened gravity between adults and the collision test, where a
  colliding adult in its life window dies if a partner's tag key is larger
  and survives otherwise; then age death, the clamped Euler step, aging
  and the explosion of fertile first-generation adults, whose children
  take the free slots in ascending order under the frame's budget.

Float operations take ``ftype``: ``float32`` is the reference,
``bfloat16`` the control.  A frame's pair work goes in cell batches, so a
full-size frame fits beside what the run keeps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import threefry as tf

IMIN = -(1 << 31)
STATS = ("n_alive", "n_age_deaths", "n_collision_kills", "n_overflow_kills",
         "n_survivals", "n_spawned", "n_spawn_capped", "n_listed_dropped",
         "max_cell_occupancy", "max_chunk_occupancy", "n_tail_alive")


def f32(x: float) -> float:
    return float(np.float32(x))


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class Scene:
    """The constants of a configuration file (``configs/*.json``, the
    scene's ``common.h`` knobs) and what follows from them."""

    n_fill: int
    x_factor: int
    grid_dim: int
    cell_size: float
    chunk_factor: int
    dt: float
    eps2: float
    collision_radius: float
    weight: float
    particle_life: float
    max_dx: float
    max_v: float
    explosion_speed: float
    seed: int = 1
    fill_seed: int | None = None   # the fill's seed, when not ``seed``
    capacity: int = 0
    max_per_cell: int = 0
    spawn_budget: int = 0

    @classmethod
    def from_config(cls, conf: dict, seed: int,
                    fill_seed: int | None = None) -> "Scene":
        g = conf["grid"]
        keys = {f.name for f in dataclasses.fields(cls)}
        flat = {k: v for k, v in conf.items() if k in keys}
        return cls(grid_dim=g["grid_dim"], cell_size=g["cell_size"],
                   chunk_factor=g["chunk_factor"],
                   **{**flat, "seed": seed, "fill_seed": fill_seed})

    @property
    def slots(self) -> int:
        return self.capacity or round_up(self.n_fill * self.x_factor, 1024)

    @property
    def num_cells(self) -> int:
        return self.grid_dim ** 3

    @property
    def cell_capacity(self) -> int:
        return self.max_per_cell or round_up(
            (self.n_fill // self.num_cells + 1) * self.x_factor, 8)

    @property
    def budget(self) -> int:
        e = self.spawn_budget or max(1024, self.slots // 32)
        return min(e, self.slots)

    @property
    def half(self) -> float:
        return self.grid_dim / 2 * self.cell_size


@dataclasses.dataclass
class State:
    """Slots as columns: pos, vel, acc (N, 3), w, age, life (N,) in the
    float type; alive, parent (N,) bool; tag (N,) int64 holding uint32."""

    pos: torch.Tensor
    vel: torch.Tensor
    acc: torch.Tensor
    w: torch.Tensor
    age: torch.Tensor
    life: torch.Tensor
    alive: torch.Tensor
    parent: torch.Tensor
    tag: torch.Tensor

    def map(self, fn) -> "State":
        return State(**{f.name: fn(getattr(self, f.name))
                        for f in dataclasses.fields(self)})


FIELDS = tuple(f.name for f in dataclasses.fields(State))


def fill(sc: Scene, device, ftype=torch.float32) -> State:
    n, slots = sc.n_fill, sc.slots
    seed = sc.seed if sc.fill_seed is None else sc.fill_seed
    r = tf.unit01(tf.frame_key(seed, 0, tf.FILL, 0), (n, 3), device)
    us = tf.unit01(tf.frame_key(seed, 0, tf.FILL, 1), (n, 3), device)
    ua = tf.unit01(tf.frame_key(seed, 0, tf.FILL, 2), (n,), device)
    uf = tf.unit01(tf.frame_key(seed, 0, tf.FILL, 3), (n,), device)
    life = sc.particle_life
    lo_a, hi_a = life / 7.0, life / 2.0
    lo_f, hi_f = life / 6.0, life * 2.0
    z = lambda *s: torch.zeros(s, dtype=ftype, device=device)
    st = State(pos=z(slots, 3), vel=z(slots, 3), acc=z(slots, 3),
               w=z(slots), age=z(slots), life=z(slots),
               alive=torch.zeros(slots, dtype=torch.bool, device=device),
               parent=torch.zeros(slots, dtype=torch.bool, device=device),
               tag=torch.arange(slots, dtype=torch.int64, device=device))
    sign = torch.where(us >= 0.5, 1.0, -1.0)
    st.pos[:n] = (sign * r * sc.half).to(ftype)
    st.age[:n] = (lo_a + ua * (hi_a - lo_a)).to(ftype)
    st.life[:n] = (lo_f + uf * (hi_f - lo_f)).to(ftype)
    st.w[:n] = sc.weight
    st.alive[:n] = True
    return st


def frame_fields(sc: Scene, frame: int, tags: torch.Tensor, ftype):
    """(unit vectors (N, 3), fertility ages (N,)) keyed by each tag."""
    dev = tags.device
    ku = tf.fold_in(tf.frame_key(sc.seed, frame, tf.UVEC), tags)
    kf = tf.fold_in(tf.frame_key(sc.seed, frame, tf.FERT), tags)
    uvec = tf.lattice_unit(tf.unit01(ku, (3,), dev))
    lo, hi = sc.particle_life / 6.0, sc.particle_life * 2.0
    fert = lo + tf.unit01(kf, (1,), dev)[:, 0] * (hi - lo)
    return uvec.to(ftype), fert.to(ftype)


def cells(pos: torch.Tensor, sc: Scene):
    """(wrapped positions, cell id (N,) int64, cell coordinates (N, 3)
    int64 as (i1, i2, i3)): whole cells are added or taken off, so a
    position keeps its place inside its cell."""
    g, half = sc.grid_dim, sc.grid_dim // 2
    inv = 1.0 / sc.cell_size
    c = torch.stack([torch.floor(-pos[:, 1] * inv),
                     torch.floor(pos[:, 0] * inv),
                     torch.floor(-pos[:, 2] * inv)], 1).to(torch.int64) + half
    cw = torch.remainder(c, g)
    d = (cw - c).to(pos.dtype)
    shift = torch.stack([d[:, 1], -d[:, 0], -d[:, 2]], 1) * sc.cell_size
    cid = cw[:, 2] * g * g + cw[:, 0] * g + cw[:, 1]
    return pos + shift, cid, cw


def okey(tags: torch.Tensor) -> torch.Tensor:
    """The collision order of a tag: its int32 bit pattern, kept one above
    INT32_MIN."""
    t = tags & tf.M32
    t = torch.where(t >= (1 << 31), t - (1 << 32), t)
    return torch.clamp(t, min=IMIN + 1)


@dataclasses.dataclass
class Binned:
    lists: torch.Tensor      # (cells, K) slot ids, -1 pad
    overflow: torch.Tensor   # (N,) bool
    max_occ: int


def bin_cells(cid: torch.Tensor, alive: torch.Tensor, sc: Scene) -> Binned:
    n, nc, cap = cid.shape[0], sc.num_cells, sc.cell_capacity
    key = torch.where(alive, cid, nc)
    skey, order = torch.sort(key, stable=True)
    counts = torch.zeros(nc + 1, dtype=torch.int64, device=cid.device)
    counts.index_add_(0, key, torch.ones_like(key))
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=cid.device) - start[skey]
    max_occ = int(counts[:nc].max())
    k = min(cap, round_up(max(max_occ, 1), 32))
    listed = (skey < nc) & (rank < k)
    flat = torch.where(listed, skey * k + rank, nc * k)
    lists = torch.full((nc * k + 1,), -1, dtype=torch.int64,
                       device=cid.device)
    lists[flat] = order
    overflow = torch.zeros(n, dtype=torch.bool, device=cid.device)
    overflow[order] = (rank >= cap) & (skey < nc)
    return Binned(lists[:-1].view(nc, k), overflow, max_occ)


#: pair elements of one cell batch's temporaries
PAIR_BUDGET = 1 << 24


def pair_pass(st: State, lists: torch.Tensor, sc: Scene):
    """(acc (N, 3), kill (N,), touch (N,)) over the 27-cell stencil:
    gravity ``w_j r_ij / (|r|^2 + eps2)^(3/2)`` between adults, and the
    collision test of adults both within their life, ``|r|^2 <= R^2`` with
    ``|r|^2 = (dx dx + dy dy) + dz dz``."""
    n, dev, ft = st.pos.shape[0], st.pos.device, st.pos.dtype
    g = sc.grid_dim
    nc, k = lists.shape
    kid = f32(sc.particle_life / 10.0)
    life = f32(sc.particle_life)
    r2 = float(np.float32(sc.collision_radius) ** 2)
    eps2 = f32(sc.eps2)
    adult = st.age >= kid
    young = st.age <= life
    keys = okey(st.tag)
    px, py, pz = st.pos.unbind(1)
    acc = torch.zeros((n + 1, 3), dtype=ft, device=dev)
    kill = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    touch = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    batch = max(1, min(nc, PAIR_BUDGET // (k * k)))
    for c0 in range(0, nc, batch):
        c = torch.arange(c0, min(c0 + batch, nc), device=dev)
        me = lists[c]
        mv = (me >= 0)[:, :, None]
        mi = me.clamp(min=0)
        mx, my, mz = (a[mi][:, :, None] for a in (px, py, pz))
        mk = keys[mi][:, :, None]
        ma = (adult[mi] & young[mi])[:, :, None]
        madult = adult[mi][:, :, None]
        c3, c1, c2 = c // (g * g), (c // g) % g, c % g
        ax = torch.zeros(mi.shape, dtype=ft, device=dev)
        ay, az = torch.zeros_like(ax), torch.zeros_like(ax)
        kl = torch.zeros(mi.shape, dtype=torch.bool, device=dev)
        tc = torch.zeros_like(kl)
        for o3 in (-1, 0, 1):
            for o1 in (-1, 0, 1):
                for o2 in (-1, 0, 1):
                    a1, a2, a3 = c1 + o1, c2 + o2, c3 + o3
                    inside = ((a1 >= 0) & (a1 < g) & (a2 >= 0) & (a2 < g)
                              & (a3 >= 0) & (a3 < g))
                    nb = (a3 * g * g + a1 * g + a2).clamp(0, nc - 1)
                    nb = torch.where(inside[:, None], lists[nb], -1)
                    ni = nb.clamp(min=0)
                    dx = px[ni][:, None, :] - mx
                    dy = py[ni][:, None, :] - my
                    dz = pz[ni][:, None, :] - mz
                    dsq = dx * dx + dy * dy + dz * dz
                    pa = (mv & (nb >= 0)[:, None, :]
                          & (ni[:, None, :] != mi[:, :, None])
                          & madult & adult[ni][:, None, :])
                    hit = (pa & (dsq <= r2) & ma & young[ni][:, None, :])
                    kl |= (hit & (keys[ni][:, None, :] > mk)).any(2)
                    tc |= hit.any(2)
                    dd = dsq + eps2
                    s = torch.where(pa, st.w[ni][:, None, :]
                                    / torch.sqrt(dd * dd * dd), 0.0)
                    ax += (dx * s).sum(2)
                    ay += (dy * s).sum(2)
                    az += (dz * s).sum(2)
        tgt = torch.where(me >= 0, me, n).reshape(-1)
        acc[tgt] = torch.stack([ax, ay, az], -1).reshape(-1, 3)
        kill[tgt] = kl.reshape(-1)
        touch[tgt] = tc.reshape(-1)
    return acc[:n], kill[:n], touch[:n]


def stencil_pairs(cid: torch.Tensor, adult: torch.Tensor, sc: Scene) -> int:
    """Ordered pairs of distinct adults inside each other's 27-cell
    stencil: what a pair pass has to evaluate, however it is written."""
    g = sc.grid_dim
    cnt = torch.zeros(sc.num_cells, dtype=torch.int64, device=cid.device)
    cnt.index_add_(0, cid[adult], torch.ones_like(cid[adult]))
    box = torch.nn.functional.pad(cnt.view(1, 1, g, g, g).double(),
                                  (1, 1, 1, 1, 1, 1))
    box = torch.nn.functional.avg_pool3d(box, 3, stride=1) * 27
    total = int((box.view(-1).round().long() * cnt).sum())
    return total - int(adult.sum())


def chunk_max(cw: torch.Tensor, live: torch.Tensor, sc: Scene) -> int:
    """The most live rows of a chunk, rows past their cell's capacity
    among them."""
    cd, cf = sc.grid_dim // sc.chunk_factor, sc.chunk_factor
    ch = (cw[:, 2] // cd) * cf * cf + (cw[:, 0] // cd) * cf + cw[:, 1] // cd
    cnt = torch.zeros(cf ** 3, dtype=torch.int64, device=cw.device)
    cnt.index_add_(0, ch[live], torch.ones_like(ch[live]))
    return int(cnt.max())


def rank_table(mask: torch.Tensor, e: int) -> torch.Tensor:
    """The first ``e`` slots where ``mask`` holds, ascending, padded with
    ``N``."""
    n = mask.shape[0]
    idx = torch.nonzero(mask).view(-1)[:e]
    out = torch.full((e,), n, dtype=torch.int64, device=mask.device)
    out[:idx.shape[0]] = idx
    return out


def step(st: State, frame: int, sc: Scene, count_pairs: bool = False):
    """One frame: (next state, stats dict, stepped pairs or None)."""
    ft = st.pos.dtype
    dt = f32(sc.dt)
    life_max = f32(sc.particle_life)
    uvec, fert = frame_fields(sc, frame, st.tag, ft)
    pos_w, cid, cw = cells(st.pos, sc)
    b = bin_cells(cid, st.alive, sc)
    acc, kill, touch = pair_pass(st, b.lists, sc)
    pairs = None
    if count_pairs:
        adult = st.alive & ~b.overflow & (st.age >= f32(sc.particle_life / 10))
        pairs = stencil_pairs(cid, adult, sc)

    alive1 = st.alive & ~b.overflow
    die_age = alive1 & (st.age > life_max)
    die_coll = alive1 & ~die_age & kill
    dead = die_age | die_coll | b.overflow
    survive = alive1 & ~die_age & ~die_coll & touch
    normal = alive1 & ~die_age & ~die_coll & ~survive

    dx = st.vel * dt + 0.5 * acc * dt * dt
    dx = torch.clamp(dx, -sc.max_dx, sc.max_dx)
    newpos, _, _ = cells(st.pos + dx, sc)
    v1 = torch.clamp(st.vel + acc * dt, -sc.max_v, sc.max_v)
    age1 = st.age + dt
    nm, dm, sm = normal[:, None], dead[:, None], survive[:, None]
    pos = torch.where(nm, newpos, torch.where(dm, 0.0, pos_w))
    vel = torch.where(nm, v1, torch.where(dm | sm, 0.0, st.vel))
    accf = torch.where(nm, acc, 0.0)
    age = torch.where(normal, age1, torch.where(dead | survive, 0.0, st.age))
    w = torch.where(dead, 0.0, st.w)
    lifef = torch.where(dead, 0.0, st.life)
    parent = torch.where(dead | survive, False, st.parent)
    alive2 = alive1 & ~dead
    explode = normal & (age1 >= st.life) & ~st.parent
    parent = parent | explode
    vel = torch.where(explode[:, None], uvec * f32(sc.explosion_speed), vel)
    nxt = State(pos=pos, vel=vel, acc=accf, w=w, age=age, life=lifef,
                alive=alive2, parent=parent, tag=st.tag.clone())

    # children: the i-th exploding parent takes the i-th free slot
    n, e = nxt.alive.shape[0], sc.budget
    free = ~nxt.alive
    n_child = int(explode.sum())
    k = min(n_child, int(free.sum()), e)
    src = rank_table(explode, e)[:k]
    tgt = rank_table(free, e)[:k]
    nxt.pos[tgt] = nxt.pos[src]
    nxt.vel[tgt] = -nxt.vel[src]
    nxt.acc[tgt] = 0.0
    nxt.w[tgt] = sc.weight
    nxt.age[tgt] = 0.0
    nxt.life[tgt] = fert[src]
    nxt.alive[tgt] = True
    nxt.parent[tgt] = False
    nxt.tag[tgt] = tf.tag_mix(st.tag[src], frame)
    stats = dict(
        n_alive=int(nxt.alive.sum()), n_age_deaths=int(die_age.sum()),
        n_collision_kills=int(die_coll.sum()),
        n_overflow_kills=int(b.overflow.sum()),
        n_survivals=int(survive.sum()), n_spawned=k,
        n_spawn_capped=min(n_child, e) - k, n_listed_dropped=0,
        max_cell_occupancy=b.max_occ,
        max_chunk_occupancy=chunk_max(cw, st.alive, sc), n_tail_alive=0)
    return nxt, stats, pairs


def compact(st: State) -> State:
    """Alive rows first, slot order kept within each class."""
    n = st.alive.shape[0]
    iot = torch.arange(n, device=st.alive.device)
    order = torch.argsort(torch.where(st.alive, iot, iot + n))
    return st.map(lambda a: a[order])


def run(st: State, first: int, frames: int, sc: Scene,
        count_pairs: bool = False):
    """``frames`` frames from frame ``first``: (state, the last frame's
    stats, [(frame, rows, alive rows, pairs)] of each frame stepped)."""
    work, stats = [], None
    for f in range(first, first + frames):
        alive_in = int(st.alive.sum())
        st, stats, pairs = step(st, f, sc, count_pairs)
        work.append((f, st.alive.shape[0], alive_in, pairs))
    return st, stats, work
