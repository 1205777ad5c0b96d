"""Sort-based grouped aggregation with static output capacity.

Counterpart of citus_tpu/ops/aggregate.py: rows sort by group key and
reduce over the sorted runs.  Output capacity == input capacity, so there
is no overflow case; `group_valid` marks which output slots hold groups.

* sum / count — prefix-sum difference over each run; float prefixes
  accumulate in float64 so the subtraction does not cancel.
* min / max — a segmented inclusive scan that resets at group starts.
* group keys / first positions — one scatter with unique indices.
"""

from __future__ import annotations

import torch

from .join import lexsort

SUPPORTED_AGGS = ("sum", "count", "min", "max")


def _sort_order(keys: list[torch.Tensor], valid: torch.Tensor):
    """Stable order: valid rows first, grouped by key columns."""
    invalid = (~valid).to(torch.int32)
    return lexsort(list(reversed(keys)) + [invalid])


def _run_sum(x: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
             acc_dtype) -> torch.Tensor:
    """Sum of each [starts[g], ends[g]) run via prefix-sum difference."""
    prefix = torch.cat([torch.zeros(1, dtype=acc_dtype, device=x.device),
                        torch.cumsum(x.to(acc_dtype), 0)])
    return prefix[ends] - prefix[starts]


def _segmented_scan(x: torch.Tensor, boundary: torch.Tensor, op):
    """Inclusive segmented scan that resets at every boundary row
    (Hillis-Steele step doubling, log2(n) passes)."""
    n = x.shape[0]
    if n <= 1:
        return x
    idx = torch.arange(n, device=x.device)
    v, f = x, boundary
    step = 1
    while step < n:
        pv = torch.roll(v, step)
        pf = torch.roll(f, step)
        has_prev = idx >= step
        v = torch.where(has_prev & ~f, op(v, pv), v)
        f = torch.where(has_prev, f | pf, f)
        step <<= 1
    return v


def _identity_for(dtype, kind: str):
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def segment_aggregate(keys: list[torch.Tensor], values, valid: torch.Tensor,
                      out_keys: list[torch.Tensor] | None = None):
    """Group rows by `keys` and reduce.

    values: (array [N], kind, value_valid [N] | None) per aggregate.
    out_keys: when set, group-key VALUES come from these arrays while
    ordering runs on `keys` (a packed composite key whose invalid rows
    already hold the int64-max sentinel).

    Returns (group_keys, agg_results, group_valid, n_groups) — each
    result [N], group_valid = slot < n_groups."""
    n = valid.shape[0]
    dev = valid.device
    if out_keys is not None:
        order = torch.sort(keys[0], stable=True).indices
    else:
        order = _sort_order(keys, valid)
    keys_s = [k[order] for k in keys]
    valid_s = valid[order]

    def _shift_ne(a):
        return torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          a[1:] != a[:-1]])

    diff = torch.zeros(n, dtype=torch.bool, device=dev)
    for k in keys_s:
        diff = diff | _shift_ne(k)
    boundary = diff & valid_s
    seg_id = torch.cumsum(boundary.to(torch.int64), 0) - 1
    n_groups = boundary.sum()
    seg_id = torch.clamp(seg_id, min=0)

    # group g's run is [starts[g], ends[g]) in sorted space (one boundary
    # per group ⇒ unique scatter indices; index n+1 is the trash lane)
    gpos = torch.full((n + 2,), n, dtype=torch.int64, device=dev)
    gpos[torch.where(boundary, seg_id, torch.full_like(seg_id, n + 1))] = \
        torch.arange(n, dtype=torch.int64, device=dev)
    starts = gpos[:n]
    ends = gpos[1:n + 1]

    first_c = torch.clamp(starts, max=n - 1)
    if out_keys is None:
        group_keys = [k[first_c] for k in keys_s]
    else:
        first_idx = order[first_c]
        group_keys = [k[first_idx] for k in out_keys]

    results = []
    for arr, kind, value_valid in values:
        arr_s = arr[order]
        contrib = valid_s if value_valid is None else (
            valid_s & value_valid[order])
        if kind == "count":
            res = _run_sum(contrib.to(torch.int64), starts, ends,
                           torch.int64)
        elif kind == "sum":
            x = torch.where(contrib, arr_s, torch.zeros_like(arr_s))
            acc = (torch.float64 if arr_s.dtype.is_floating_point
                   else torch.int64)
            res = _run_sum(x, starts, ends, acc).to(arr_s.dtype)
        elif kind in ("min", "max"):
            ident = torch.full_like(arr_s, _identity_for(arr_s.dtype, kind))
            x = torch.where(contrib, arr_s, ident)
            op = torch.minimum if kind == "min" else torch.maximum
            sv = _segmented_scan(x, boundary, op)
            res = sv[torch.clamp(ends - 1, 0, n - 1)]
        else:
            raise ValueError(f"unsupported aggregate kind {kind!r}")
        results.append(res)

    group_valid = torch.arange(n, device=dev) < n_groups
    group_keys = [torch.where(group_valid, k, torch.zeros_like(k))
                  for k in group_keys]
    results = [torch.where(group_valid, r, torch.zeros_like(r))
               for r in results]
    return group_keys, results, group_valid, n_groups


def distinct(keys: list[torch.Tensor], valid: torch.Tensor):
    """DISTINCT = grouping with no aggregates."""
    gk, _, gv, n = segment_aggregate(keys, [], valid)
    return gk, gv, n
