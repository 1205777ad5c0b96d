"""Radix partition packing: rows → fixed [n_targets, capacity] buffers.

Counterpart of citus_tpu/ops/partition.py.  The pack is formulated as a
GATHER: rows order by target (stable), each target's rows then occupy a
contiguous run of ordered positions, and output slot (t, r) pulls
position starts[t] + r.  Static capacity per target; the overflow count
is returned so the host can re-run with a larger capacity.
"""

from __future__ import annotations

import torch

# counting-rank eligibility bound (same as the JAX package): for few
# targets one prefix count per target replaces the stable sort
COUNTING_PACK_MAX_TARGETS = 32


def pack_by_target(columns: dict[str, torch.Tensor], valid: torch.Tensor,
                   target: torch.Tensor, n_targets: int, capacity: int,
                   ) -> tuple[dict[str, torch.Tensor], torch.Tensor,
                              torch.Tensor]:
    """Arrange rows into [n_targets, capacity] per column.

    Returns (packed_columns, packed_valid [n_targets, capacity],
    overflow_count — rows dropped because their partition exceeded
    capacity).  Garbage lanes hold zeros.  Row order within a target
    follows source order (stable)."""
    n = target.shape[0]
    dev = target.device
    t = torch.where(valid, target.to(torch.int64),
                    torch.full_like(target, n_targets, dtype=torch.int64))
    if n_targets <= COUNTING_PACK_MAX_TARGETS:
        # counting rank: row i's position within its target's run is the
        # inclusive prefix count of its target minus one; the resulting
        # order is identical to the stable sort's
        rank = torch.zeros(n, dtype=torch.int64, device=dev)
        counts_l = []
        for d in range(n_targets):
            is_d = t == d
            c = torch.cumsum(is_d.to(torch.int64), 0)
            rank = torch.where(is_d, c - 1, rank)
            counts_l.append(c[n - 1] if n else
                            torch.zeros((), dtype=torch.int64, device=dev))
        counts = torch.stack(counts_l)
        starts = torch.cumsum(counts, 0) - counts
        tc = torch.clamp(t, max=n_targets - 1)
        out_idx = torch.where(t < n_targets, starts[tc] + rank,
                              torch.full_like(t, n))
        # unique-index scatter; slot n is the trash lane
        order = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        order[out_idx] = torch.arange(n, dtype=torch.int64, device=dev)
        order = order[:n]
    else:
        order = torch.sort(t, stable=True).indices
        # a fixed-size count (bincount sizes its output from the data
        # and so waits on the device)
        counts = torch.zeros(n_targets + 1, dtype=torch.int64,
                             device=dev).scatter_add_(
            0, t, torch.ones_like(t))[:n_targets]
        starts = torch.cumsum(counts, 0) - counts

    # slot (t, r) ← ordered position starts[t] + r (gather, no scatter)
    slots = torch.arange(n_targets * capacity, dtype=torch.int64, device=dev)
    ti = torch.div(slots, capacity, rounding_mode="floor")
    r = slots - ti * capacity
    packed_valid = r < counts[ti]
    packed = {}
    if n:
        sp = torch.clamp(starts[ti] + r, 0, n - 1)
        src_row = order[sp]
    for name, col in columns.items():
        if n:
            buf = torch.where(packed_valid, col[src_row],
                              torch.zeros((), dtype=col.dtype, device=dev))
        else:
            buf = torch.zeros(n_targets * capacity, dtype=col.dtype,
                              device=dev)
        packed[name] = buf.reshape(n_targets, capacity)
    overflow = torch.clamp(counts - capacity, min=0).sum()
    return packed, packed_valid.reshape(n_targets, capacity), overflow
