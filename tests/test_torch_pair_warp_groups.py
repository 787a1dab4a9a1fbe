"""The cluster-pair kernel's walk of sparse blocks by groups of warps.

A block whose in-band rows need at most half of its CTA's warps is walked
by ``G`` groups of warps, each holding every in-band row and walking its
own warps' share of every piece, the groups' partial sums added in group
order (``csrc/neighbor_blocks.cu``, ``cluster_pair_kernel_sparse``).  On
the CPU:

* the rule that picks ``G`` (a copy of ``warp_groups``, with the walk's
  rows a thread and warps a CTA): a power of two, every row held, the
  partial sums within the tiles they are added in, a full block one group.

The kernel itself is held to the plain version by the ``cuda``-marked test
here (on a sparse state, a few in-band rows in a handful of blocks, and a
dense one: the counters, two launches and a subset bit for bit) and by
``chip_smoke.py`` on the card.  This file imports no JAX.
"""

import dataclasses

import pytest
import torch

import particlesystem_tpu_torch.ops.neighbor_blocks as nbk
from particlesystem_tpu_torch import NBodyConfig
from particlesystem_tpu_torch.models import nbody
from particlesystem_tpu_torch.ops.grid import coords_to_cell, wrap_positions
from particlesystem_tpu_torch.tools.sweep_pair_kernel import (
    frame_inputs, source_constants)

torch.set_num_threads(1)


def sparse_state(st, cfg, cells):
    """``st`` with every particle outside ``cells`` made a kid: out of
    band, so a few in-band rows lie in a handful of blocks."""
    cell = coords_to_cell(wrap_positions(st.pos, cfg.grid)[1], cfg.grid)
    keep = torch.isin(cell, torch.tensor(cells, device=cell.device))
    return dataclasses.replace(
        st, age=torch.where(keep, st.age, torch.zeros_like(st.age)))


def live_blocks(snap, b: int):
    """The blocks with an in-band row, ascending (int64)."""
    return torch.nonzero((snap.f[3].view(-1, b) >= 0).any(dim=1)).view(-1)


def warp_groups(nr: int, b: int):
    """(G, warps a group, rows a thread) of the walk for a block of ``b``
    rows with ``nr`` in band, as the kernel picks them."""
    c = source_constants()
    rows = c["WIDE"] if b >= 32 * c["WIDE"] else 1
    threads = 32
    while threads * rows < b:
        threads *= 2
    nw = threads // 32
    row_warps = (-(-nr // rows) + 31) // 32
    g = 1
    while 2 * g * row_warps <= nw and 2 * g * nr <= 2 * c["TW"]:
        g *= 2
    wpg = nw // g
    return g, wpg, -(-nr // (wpg * 32))


@pytest.mark.parametrize("b", [32, 48, 64, 96, 512, 1024])
def test_warp_groups_rule(b):
    c = source_constants()
    rows = c["WIDE"] if b >= 32 * c["WIDE"] else 1
    prev = None
    for nr in range(1, b + 1):
        g, wpg, rpt = warp_groups(nr, b)
        assert g & (g - 1) == 0 and wpg >= 1
        assert g == 1 or g * nr <= 2 * c["TW"]   # the partials' room
        assert rpt <= rows and rpt * wpg * 32 >= nr   # every row held
        assert prev is None or g <= prev         # fewer groups as rows grow
        prev = g
    # a full block walks as one group: the dense frames' order
    assert warp_groups(b, b)[0] == 1
    if b == 512:
        assert warp_groups(12, b) == (8, 1, 1)
        assert warp_groups(54, b) == (8, 1, 2)
        assert warp_groups(200, b) == (2, 4, 2)


@pytest.mark.cuda
def test_cuda_kernel_walks_sparse_blocks_by_groups():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (python3 chip_smoke.py holds the "
                    "kernel to its plain version on the plateau and frame 0)")
    cfg = NBodyConfig()
    dense = nbody.init_fill(cfg, "cuda")
    for name, st in (("sparse", sparse_state(dense, cfg,
                                             (700, 701, 717, 1800, 3000))),
                     ("dense", dense)):
        snap, chunks = frame_inputs(cfg, st)[:2]
        live = live_blocks(snap, nbk.B)
        before = nbk.walk_counts()
        acc, gmax = nbk.cluster_pair_cuda(cfg, snap, chunks, nbk.B, nbk.CH)
        again = nbk.cluster_pair_cuda(cfg, snap, chunks, nbk.B, nbk.CH)
        after = nbk.walk_counts()
        assert after["passes"] - before["passes"] == 2
        sparse = after["sparse_blocks"] - before["sparse_blocks"]
        assert (sparse > 0) == (name == "sparse"), (name, sparse)
        assert sparse <= 2 * live.numel()
        assert torch.equal(acc.view(torch.int32), again[0].view(torch.int32))
        assert torch.equal(gmax, again[1])
        out = snap.f[3] < 0
        assert not acc[:, out].any() and (gmax[out] == nbk.IMIN).all()
        sel = live if name == "sparse" else live[torch.linspace(
            0, live.numel() - 1, 64, device="cuda").round().long()]
        sub = sel.flip(0).to(torch.int32)
        acc_s, gmax_s = nbk.cluster_pair_cuda(cfg, snap, chunks, nbk.B,
                                              nbk.CH, sub)
        rows = (sub.long()[:, None] * nbk.B
                + torch.arange(nbk.B, device="cuda")).reshape(-1)
        assert torch.equal(acc_s.view(torch.int32),
                           acc[:, rows].view(torch.int32))
        assert torch.equal(gmax_s, gmax[rows])
        ref_acc, ref_gmax = nbk.cluster_pair_plain(
            cfg, snap, chunks, nbk.B, nbk.CH, sub)
        assert torch.equal(gmax_s, ref_gmax)
        scale = max(1.0, ref_acc.abs().max().item())
        assert (acc_s - ref_acc).abs().max().item() / scale < 1e-5
