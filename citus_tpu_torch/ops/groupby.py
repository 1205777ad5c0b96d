"""Bucketed dense-grid aggregation for high-cardinality GROUP BY.

Counterpart of citus_tpu/ops/groupby.py.  Rows carry a packed dense slot
id (the planner's key_ranges layout), partition by slot high bits into
[n_buckets, bucket_cap] buffers (tile_buckets + pack_by_target), and
each bucket reduces over its GROUP_TILE_SLOTS-wide tile sort-free:

* f32 sums and 0/1 counts ride the bucket-tiled sum kernel
  (ops.hopper_kernels.bucketed_groupby_sums) on the card, its plain
  per-bucket index_add_ on the CPU;
* integer / float64 sums stay exact on index_add_ in their own dtype;
* min / max use scatter_reduce over the flat slot space, as the JAX
  version keeps them on XLA segment ops.

A hot bucket overflows its static capacity and the host regrows and
retries; the realized max fill feeds capacity feedback.
"""

from __future__ import annotations

import torch

GROUP_TILE_SLOTS = 4096
GROUP_BUCKET_MAX_SLOTS = 1 << 24


def group_bucket_count(total: int) -> int:
    """Number of dense tiles covering [0, total)."""
    return max(1, -(-total // GROUP_TILE_SLOTS))


def group_bucket_eligible(total: int, rows: int) -> bool:
    """Planner threshold (the JAX package's rule): the slot space is
    materializable and the input dense enough to fill the tiles."""
    return total <= GROUP_BUCKET_MAX_SLOTS and rows * 4 >= total


def bucketed_grid_aggregate(slot: torch.Tensor, valid: torch.Tensor,
                            values: list[tuple[torch.Tensor, str]],
                            total: int, bucket_cap: int):
    """Aggregate rows onto a [total]-slot dense grid, bucket-tiled.

    slot: [n] dense packed slot per row, in [0, total) for valid rows.
    values: (array [n], kind) per aggregate, kind in sum|count|min|max;
    sum/count arrays hold 0 on non-contributing rows and min/max arrays
    the reduction identity (the caller owns NULL masking).

    Returns (results [total] per value, rows_per_slot [total] int32,
    overflow int64, bucket_max_fill int64)."""
    from .hashing import tile_buckets
    from .hopper_kernels import bucketed_groupby_sums
    from .partition import pack_by_target

    tile = GROUP_TILE_SLOTS
    n_buckets = group_bucket_count(total)
    ext_pad = n_buckets * tile
    dev = slot.device

    bucket, local = tile_buckets(slot.to(torch.int64), tile)
    cols = {f"v{i}": arr for i, (arr, _kind) in enumerate(values)}
    cols["local"] = local.to(torch.int32)
    packed, pvalid, overflow = pack_by_target(cols, valid, bucket,
                                              n_buckets, bucket_cap)
    bucket_max_fill = pvalid.sum(dim=1).max()
    loc2d = packed["local"].contiguous()  # garbage lanes: slot 0, zeros
    # flat slots for the scatter reductions: garbage lanes park at the
    # trash slot ext_pad so zeroed garbage never reads as a min/max
    biota = torch.arange(n_buckets, dtype=torch.int64, device=dev)[:, None]
    flat_slot = torch.where(pvalid, biota * tile + loc2d.to(torch.int64),
                            torch.full_like(biota, ext_pad)).reshape(-1)

    def _flat(colkeys):
        return torch.stack([packed[ck] for ck in colkeys], dim=2).reshape(
            n_buckets * bucket_cap, len(colkeys))

    ROWS = "rows"
    packed[ROWS] = pvalid.to(torch.int32)
    results: list = [None] * len(values)
    rows_per_slot = None
    by_kind: dict[tuple, list[tuple[object, str]]] = {}
    for i, (arr, kind) in enumerate(values):
        if kind == "count":
            by_kind.setdefault(("matsum", torch.int32), []) \
                .append((i, f"v{i}"))
        elif kind == "sum":
            # f32 sums accumulate in f32 either way; other sums stay on
            # the exact scatter in their own dtype
            key = (("matsum", arr.dtype) if arr.dtype == torch.float32
                   else ("segsum", arr.dtype))
            by_kind.setdefault(key, []).append((i, f"v{i}"))
        elif kind in ("min", "max"):
            by_kind.setdefault((kind, arr.dtype), []).append((i, f"v{i}"))
        else:
            raise ValueError(f"unsupported aggregate kind {kind!r}")
    by_kind.setdefault(("matsum", torch.int32), []).append((ROWS, ROWS))

    for (op, dt), items in by_kind.items():
        if op == "matsum" and bucket_cap >= (1 << 24):
            op = "segsum"  # counts past f32 exactness: exact scatter
        colkeys = [ck for _slot, ck in items]
        if op == "matsum":
            stack = torch.stack([packed[ck] for ck in colkeys], dim=2).to(
                torch.float32).contiguous()
            red = bucketed_groupby_sums(loc2d, stack, tile).reshape(
                ext_pad, len(colkeys)).to(dt)
        else:
            flat = _flat(colkeys)
            out = torch.zeros(ext_pad + 1, len(colkeys), dtype=flat.dtype,
                              device=dev)
            idx = flat_slot[:, None].expand_as(flat)
            if op == "segsum":
                out.index_add_(0, flat_slot, flat)
            else:
                ident = (float("inf") if flat.dtype.is_floating_point
                         else torch.iinfo(flat.dtype).max)
                if op == "max":
                    ident = (float("-inf") if flat.dtype.is_floating_point
                             else torch.iinfo(flat.dtype).min)
                out.fill_(ident)
                out.scatter_reduce_(0, idx, flat,
                                    reduce="amin" if op == "min" else "amax",
                                    include_self=True)
            red = out[:ext_pad]
        for j, (slot_i, _ck) in enumerate(items):
            if slot_i is ROWS:
                rows_per_slot = red[:total, j].to(torch.int32)
            else:
                results[slot_i] = red[:total, j]

    return results, rows_per_slot, overflow, bucket_max_fill
