"""Cell-centric 27-stencil neighbor interactions (collision and gravity).

Counterpart of ``particlesystem_tpu/ops/neighbor.py``: the dense cell-pair
pass, plain tensor code, the reference beside the cluster-pair kernel
(``ops/neighbor_blocks.py``), plus the collision-order key and the float32
constants both passes share.

* The grid may be non-cubic: ``dims = (d1, d2, d3)`` with cell id
  ``i3*(d1*d2) + i1*d2 + i2``.
* Rows are identified by explicit ``ids``, the pair self-exclusion
  identity; they must be unique across all rows a pass sees.

Physics per pair (reference semantics):

* gravity ``a_i += w_j * r_ij / (|r|^2 + EPS2)^(3/2)`` for adult pairs
  (``bodyBodyInteraction``, ``app_common.cu:236-267``);
* collide when ``|r| <= COLLISION_RADIUS``, both adult, both within life;
  kill i if some colliding j has a larger order key, else i survives
  (``bodyBodyCollision``, ``app_common.cu:269-301``).

The stencil does not wrap at the box boundary even though positions
torus-wrap (``fill_cells``, ``app.cu:352-409``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.config import NBodyConfig

IMIN = -(1 << 31)


def as_f32(x: float) -> float:
    """``x`` rounded to float32: comparisons and products against it then
    match the JAX package's float32 constants on every device."""
    return np.float32(x).item()


def collision_okey(tags: torch.Tensor) -> torch.Tensor:
    """Placement-independent collision-order key (int32) from persistent
    uint32 tags (held in int64): the int32 bit pattern of the tag, clamped
    one above INT32_MIN so the kernels' no-collision sentinel stays strictly
    below every real key.  The clamp maps tag 0x80000000 onto INT32_MIN+1;
    particles with equal keys are order-equal and neither kills the other."""
    t = tags & 0xFFFFFFFF
    t = torch.where(t >= (1 << 31), t - (1 << 32), t)
    return torch.clamp(t, min=IMIN + 1).to(torch.int32)


#: pair elements (cells x width^2) one batch of :func:`neighbor_pass` holds
#: per temporary when ``batch_cells`` is 0: 2^25 float32 values are 128 MiB,
#: and about a dozen such temporaries are live at the peak
PAIR_BUDGET = 1 << 25


def neighbor_pass(pos0: torch.Tensor, age0: torch.Tensor, w0: torch.Tensor,
                  ids: torch.Tensor, cell_list: torch.Tensor,
                  dims: Tuple[int, int, int], cfg: NBodyConfig,
                  batch_cells: int = 0, okeys: torch.Tensor = None):
    """Returns per-row (acc (R, 3), kill (R,), touch (R,)), R = number of
    snapshot rows.  Rows absent from ``cell_list`` get zeros and False.
    ``okeys`` (int32, from :func:`collision_okey`) decides kill/survive
    ordering; defaults to ``ids`` (slot order).

    Cells are processed in batches of ``batch_cells`` (0: as many as
    :data:`PAIR_BUDGET` allows at this list width), each batch as tensor
    code over (cells, width, width) pair arrays.  The float operations that
    decide discrete outcomes keep the JAX package's order: ``dsq`` is
    ``(dx*dx + dy*dy) + dz*dz`` compared ``<= r2``, ``r2`` the float32
    square of the float32 radius.
    """
    if okeys is None:
        okeys = ids.to(torch.int32)
    d1, d2, d3 = dims
    num_cells = d1 * d2 * d3
    if cell_list.shape[0] != num_cells:
        raise ValueError(f"cell_list has {cell_list.shape[0]} cells, dims "
                         f"{dims} have {num_cells}")
    k = cell_list.shape[1]
    dev = pos0.device
    kid = as_f32(cfg.kid_age)
    life = as_f32(cfg.particle_life)
    r2 = (np.float32(cfg.collision_radius) ** 2).item()
    eps2 = as_f32(cfg.eps2)
    batch = batch_cells or max(1, PAIR_BUDGET // (k * k))
    batch = min(batch, num_cells)

    rows = pos0.shape[0]
    cl = cell_list.to(torch.int64)
    px, py, pz = pos0.unbind(dim=1)
    adult0 = age0 >= kid
    young0 = age0 <= life
    # one scratch row past the end takes the lists' padding
    acc = torch.zeros((rows + 1, 3), dtype=torch.float32, device=dev)
    kill = torch.zeros((rows + 1,), dtype=torch.bool, device=dev)
    touch = torch.zeros((rows + 1,), dtype=torch.bool, device=dev)

    for c0 in range(0, num_cells, batch):
        c = torch.arange(c0, min(c0 + batch, num_cells), device=dev)
        me = cl[c]                                        # (b, K)
        me_valid = (me >= 0)[:, :, None]
        mi = me.clamp(min=0)
        mx, my, mz = px[mi][:, :, None], py[mi][:, :, None], pz[mi][:, :, None]
        mids = ids[mi][:, :, None]
        mkeys = okeys[mi][:, :, None]
        madult = adult0[mi][:, :, None]
        myoung = young0[mi][:, :, None]

        i3 = c // (d1 * d2)
        rem = c % (d1 * d2)
        c1, c2 = rem // d2, rem % d2

        ax = torch.zeros(mi.shape, dtype=torch.float32, device=dev)
        ay, az = torch.zeros_like(ax), torch.zeros_like(ax)
        kl = torch.zeros(mi.shape, dtype=torch.bool, device=dev)
        tc = torch.zeros_like(kl)
        for o3 in (-1, 0, 1):
            for o1 in (-1, 0, 1):
                for o2 in (-1, 0, 1):
                    a1, a2, a3 = c1 + o1, c2 + o2, i3 + o3
                    ok = ((a1 >= 0) & (a1 < d1) & (a2 >= 0) & (a2 < d2)
                          & (a3 >= 0) & (a3 < d3))
                    nc = (a3 * d1 * d2 + a1 * d2 + a2).clamp(0, num_cells - 1)
                    nb = torch.where(ok[:, None], cl[nc], -1)   # (b, K)
                    nb_ok = (nb >= 0)[:, None, :]
                    ni = nb.clamp(min=0)
                    dx = px[ni][:, None, :] - mx                # (b, K, K)
                    dy = py[ni][:, None, :] - my
                    dz = pz[ni][:, None, :] - mz
                    dsq = dx * dx + dy * dy + dz * dz
                    pa = (me_valid & nb_ok & (ids[ni][:, None, :] != mids)
                          & madult & adult0[ni][:, None, :])    # pair & adult
                    collide = (pa & (dsq <= r2) & myoung
                               & young0[ni][:, None, :])
                    kl |= (collide & (okeys[ni][:, None, :] > mkeys)
                           ).any(dim=2)
                    tc |= collide.any(dim=2)
                    dd = dsq + eps2
                    s = torch.where(
                        pa, w0[ni][:, None, :] / torch.sqrt(dd * dd * dd),
                        0.0)
                    ax += (dx * s).sum(dim=2)
                    ay += (dy * s).sum(dim=2)
                    az += (dz * s).sum(dim=2)
        tgt = torch.where(me >= 0, me, rows).reshape(-1)
        acc[tgt] = torch.stack([ax, ay, az], dim=-1).reshape(-1, 3)
        kill[tgt] = kl.reshape(-1)
        touch[tgt] = tc.reshape(-1)
    return acc[:rows], kill[:rows], touch[:rows]
