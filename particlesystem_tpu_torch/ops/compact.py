"""Dead-slot recycling by prefix-sum compaction.

Counterpart of ``particlesystem_tpu/ops/compact.py``: the replacement for
the reference's per-segment circular free-id queues (``QUEUE_INFO`` +
``q_remove``/``q_insert``, the reference's
``source/code/inc/app_common.cu:305-429``).  Allocation is a deterministic
scan: free slots are handed out in ascending slot order to requests in
ascending request order, and requests beyond the number of free slots are
dropped (the reference drops them too when ``q_remove`` underflows,
``particleSystem.cpp:1321-1332``).

Every function here runs on the device with no host synchronisation:
counts stay 0-dim tensors, and writes aimed one past the last slot land on
a scratch row and are dropped.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rank_table(mask: torch.Tensor, e: int) -> torch.Tensor:
    """(e,) int64 table of the slots where ``mask`` holds, ascending;
    entries past the mask's count are ``n`` (one past the last slot)."""
    n = mask.shape[0]
    rank = torch.cumsum(mask, dim=0) - 1
    dest = torch.where(mask & (rank < e), rank, e)
    table = torch.full((e + 1,), n, dtype=torch.int64, device=mask.device)
    table.scatter_(0, dest, torch.arange(n, device=mask.device))
    return table[:e]


def write_rows(base: torch.Tensor, tgt: torch.Tensor, rows) -> torch.Tensor:
    """Copy of ``base`` with ``rows`` written at slots ``tgt``; targets equal
    to ``len(base)`` are dropped (they land on a scratch row).  A number
    for ``rows`` is filled in on ``base``'s device (a CUDA graph cannot
    capture its copy from the host)."""
    out = torch.cat([base, base[:1]])
    if not isinstance(rows, torch.Tensor):
        rows = torch.full((), rows, dtype=base.dtype, device=base.device)
    out[tgt] = rows
    return out[:-1]


def free_slots_ascending(alive: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(free_sorted, n_free): dead slot indices ascending, padded with ``n``
    past the count."""
    n = alive.shape[0]
    idx = torch.arange(n, device=alive.device)
    free_sorted = torch.sort(torch.where(alive, n, idx)).values
    return free_sorted, (~alive).sum()


def allocate(alive: torch.Tensor, request: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign a target slot to each requesting row: request rank (ascending
    index among requests) meets free rank (ascending dead slot).  Returns
    ``(target, ok)``; ``target`` is ``n`` where ``ok`` is False."""
    n = alive.shape[0]
    free_sorted, n_free = free_slots_ascending(alive)
    rank = torch.cumsum(request, dim=0) - 1
    ok = request & (rank < n_free)
    target = free_sorted[rank.clamp(0, n - 1)]
    return torch.where(ok, target, n), ok
