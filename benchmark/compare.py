"""The comparisons that decide ``correct``: what the program produced
against what the plain reference works out, as named numbers, each held
to a limit of ``workloads/<cell>.json``.

n-body states are compared particle by particle: a particle is its tag
and its fertility age (a tag alone can repeat, since a child's tag is a
hash of its parent's), so a discrete outcome that differs moves only its
own particles, never the slots of every later child.  The fertility age
enters the key rounded to bfloat16, which a run in a lower precision
reproduces too: the fill's and the spawn's draws are made in float32 and
rounded once, so such a run's particles are matched and judged by their
fields, not lost as unmatched.
"""

from __future__ import annotations

import math

import torch

#: a matched particle is off when a coordinate of its position or
#: velocity differs by more than this, or its age, weight, fertility age
#: or generation differ
POS_TOL = 1e-2
VEL_TOL = 5e-2
AGE_TOL = 1e-4
#: bits of a particle's rank among those of the same key
RANK_BITS = 14


def with_limits(nums: dict, limits: dict, prefix: str):
    """[(prefix.name, value, limit)] of the numbers ``limits`` holds a
    limit for: the cell's numbers compared."""
    return [(f"{prefix}.{k}", float(v), float(limits[k]))
            for k, v in nums.items() if k in limits]


def _keyed(st):
    """(a key a particle, ascending, and its fields in that order): the
    tag's 32 bits and the bfloat16 bits of its fertility age, then its
    rank among the particles of the same key, ordered by the full
    fertility age, so a rare repeat pairs up in the same order on both
    sides."""
    a = st.alive
    life = st.life[a].float()
    bits = life.to(torch.bfloat16).view(torch.int16).to(torch.int64)
    key = ((st.tag[a] & 0xFFFFFFFF) << 16) | (bits & 0xFFFF)
    by_life = torch.argsort(life, stable=True)
    order = by_life[torch.argsort(key[by_life], stable=True)]
    key = key[order]
    rank = torch.arange(key.shape[0], device=key.device) \
        - torch.searchsorted(key, key)
    cols = {f: getattr(st, f)[a][order].float()
            for f in ("pos", "vel", "w", "age", "life", "parent")}
    return (key << RANK_BITS) | rank.clamp(max=(1 << RANK_BITS) - 1), cols


def nbody(prog, refst, pstats=None, rstats=None) -> dict:
    """Numbers of a program state against the reference's:

    * ``rows_off`` — particles alive on one side only, or matched with a
      field off (:data:`POS_TOL`, :data:`VEL_TOL`, :data:`AGE_TOL`), over
      the reference's alive particles;
    * ``stats_off`` — with both sides' last-frame statistics, the summed
      gaps of the counts over the reference's alive count.

    A discrete outcome decided by a pair at the collision radius's edge
    can go either way under another order of the force sums, and moves the
    particles near it from then on, so neither number is 0 on every seed;
    the largest coordinate gap is no measure at all."""
    pk, pc = _keyed(prog)
    rk, rc = _keyed(refst)
    n_ref = max(1, rk.shape[0])
    idx = torch.searchsorted(pk, rk).clamp(max=max(0, pk.shape[0] - 1))
    hit = (pk[idx] == rk) if pk.shape[0] else torch.zeros_like(rk, dtype=torch.bool)
    m = idx[hit]
    gap = lambda f: (pc[f][m] - rc[f][hit]).abs().reshape(m.shape[0], -1) \
        .amax(1) if m.shape[0] else torch.zeros(0, device=rk.device)
    pg, vg = gap("pos"), gap("vel")
    off = (pg > POS_TOL) | (vg > VEL_TOL)
    for f in ("age", "life", "w"):
        off |= gap(f) > AGE_TOL
    off |= gap("parent") > 0
    n_hit = int(hit.sum())
    out = {"rows_off": (int(off.sum()) + (rk.shape[0] - n_hit)
                        + (pk.shape[0] - n_hit)) / n_ref}
    if pstats is not None and rstats is not None:
        keys = [k for k in rstats if k.startswith("n_") and k in pstats]
        out["stats_off"] = sum(abs(pstats[k] - rstats[k])
                               for k in keys) / n_ref
    return out


def emitter(prog_fields, ref_fields, prog_extra=(), ref_extra=()) -> dict:
    """Numbers of packed emitter fields (8, N) against the reference's:

    * ``alive_off`` — slots alive on one side only, over the slots;
    * ``field_gap`` — the largest gap of any field of any slot, relative to
      the field's largest magnitude (bit for bit gives 0);
    * ``state_gap`` — the largest gap of the credit, cursor and frame."""
    p, r = prog_fields.float(), ref_fields.float()
    pa = (p[6] <= p[7]) & (p[7] > 0)
    ra = (r[6] <= r[7]) & (r[7] > 0)
    scale = r.abs().amax(1, keepdim=True).clamp(min=1e-30)
    gap = ((p - r).abs() / scale)
    gap = torch.nan_to_num(gap, nan=math.inf)
    extra = [abs(float(a) - float(b)) for a, b in zip(prog_extra, ref_extra)]
    return {"alive_off": float((pa != ra).sum()) / p.shape[1],
            "field_gap": float(gap.max()),
            "state_gap": max(extra) if extra else 0.0}
