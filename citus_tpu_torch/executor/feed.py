"""Host→device data feed: shard stripes → padded column tensors.

Counterpart of citus_tpu/executor/feed.py (its eager path).  On the
port's single device every shard's stripes concatenate into one padded
[capacity] buffer per column: the catalog's node↔device map folds every
node onto device 0, so a data_dir written by an 8-device JAX session
reads here unchanged.  Reference tables feed the same way, marked
replicated.  Shard pruning (ScanNode.pruned_shards) and chunk min/max
skipping apply host-side before anything is copied.

Every scan first tries the pipelined path (executor/scanpipe.py); the
eager path below serves when that returns None (scan_pipeline off, a
small table under 'auto', or a pipeline shed after a prefetch OOM) and
is the reference semantics the pipeline is held to.  Placement goes
through the accounted seam (executor/hbm.py): feeds built for the feed
cache are charged as ``cache``, the rest as ``feed``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..catalog import Catalog, DistributionMethod
from ..errors import ExecutionError
from ..planner import expr as ir
from ..planner.plan import (
    AggregateNode,
    JoinNode,
    PlanNode,
    ProjectNode,
    QueryPlan,
    ScanNode,
    WindowNode,
    table_placement,
)
from ..storage import TableStore
from .compiler import _round_cap
from .scanpipe import maybe_pipelined_feed


@dataclass
class FeedSpec:
    """Device feed for one scan: [capacity] tensors indexed like the plan."""

    node: ScanNode
    sharded: bool               # False ⇒ replicated (reference table)
    arrays: dict[str, torch.Tensor]
    nulls: dict[str, torch.Tensor]
    valid: torch.Tensor
    capacity: int
    # rows the device owns (pre-padding; None for replicated feeds)
    dev_rows: list[int] | None = None


def walk_plan(node: PlanNode):
    yield node
    if isinstance(node, JoinNode):
        yield from walk_plan(node.left)
        yield from walk_plan(node.right)
    elif isinstance(node, (AggregateNode, ProjectNode, WindowNode)):
        yield from walk_plan(node.input)


def build_feeds(plan: QueryPlan, catalog: Catalog, store: TableStore,
                device, compute_dtype, cache, accountant,
                stats) -> dict[int, FeedSpec]:
    """One FeedSpec per scan node, placed through `accountant` (the
    data_dir's DeviceMemoryAccountant); `stats` (a ScanPhaseStats)
    collects the pipelined scans' phase walls."""
    feeds: dict[int, FeedSpec] = {}
    for node in walk_plan(plan.root):
        if isinstance(node, ScanNode):
            feeds[id(node)] = _feed_scan_cached(node, catalog, store, device,
                                                plan.n_devices,
                                                compute_dtype, cache,
                                                accountant, stats)
    return feeds


def skippable_tests(filter_expr) -> tuple:
    """Canonical (col, op, value) skip tests from a scan filter — also the
    feed-cache key component."""
    if filter_expr is None:
        return ()
    _FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
    const_types = (ir.BConst, ir.BParam)
    tests: list[tuple[str, str, object]] = []
    for c in ir.split_conjuncts(filter_expr):
        if isinstance(c, ir.BCmp) and c.op in _FLIP:
            if isinstance(c.left, ir.BCol) \
                    and isinstance(c.right, const_types) \
                    and c.right.value is not None:
                tests.append((c.left.cid.split(".", 1)[1], c.op,
                              c.right.value))
            elif isinstance(c.right, ir.BCol) and \
                    isinstance(c.left, const_types) \
                    and c.left.value is not None:
                tests.append((c.right.cid.split(".", 1)[1], _FLIP[c.op],
                              c.left.value))
        elif isinstance(c, ir.BInConst) and not c.negated and \
                isinstance(c.operand, ir.BCol) and c.values:
            tests.append((c.operand.cid.split(".", 1)[1], "in",
                          tuple(c.values)))
    return tuple(sorted(tests, key=repr))


def make_chunk_filter(filter_expr, storage_name=None):
    """ScanNode filter → per-chunk min/max skip predicate (None when the
    filter has no skippable shape).  `storage_name` maps current →
    on-disk column names."""
    tests = skippable_tests(filter_expr)
    if not tests:
        return None
    if storage_name:
        tests = tuple((storage_name.get(col, col), op, val)
                      for col, op, val in tests)

    def chunk_filter(stats: dict) -> bool:
        for col, op, val in tests:
            s = stats.get(col)
            if s is None:
                continue
            mn, mx, _nulls = s
            if mn is None:
                continue
            ok = ((op == "<" and mn < val) or (op == "<=" and mn <= val)
                  or (op == ">" and mx > val) or (op == ">=" and mx >= val)
                  or (op == "=" and mn <= val <= mx)
                  or (op == "in" and any(mn <= v <= mx for v in val)))
            if not ok:
                return False
        return True

    return chunk_filter


def _overlay_touches(store: TableStore, table: str) -> bool:
    """Whether the open transaction staged stripes or deletes for
    `table`: its reads then bypass the feed cache and the pipelined scan
    (session-private visibility that changes mid-transaction)."""
    ov = store.overlay
    if ov is None:
        return False
    return (any(t == table for t, _ in ov.records)
            or any(t == table for t, _, _ in ov.deletes))


def _feed_scan_cached(node: ScanNode, catalog: Catalog, store: TableStore,
                      device, n_dev: int, compute_dtype, cache, accountant,
                      stats) -> FeedSpec:
    """Device-feed cache wrapper keyed on (table, data version, columns,
    pruning, placement, skip filter) — see executor/cache.py.  Eager and
    pipelined feeds share the key: both hold the same rows in the same
    places.  Open-transaction overlays bypass the cache."""
    table = node.rel.table
    if cache is None or _overlay_touches(store, table):
        return _feed_scan(node, catalog, store, device, n_dev, compute_dtype,
                          accountant, "feed", stats)
    shards = catalog.table_shards(table)
    placement_sig = tuple(
        (s.shard_id, catalog.active_placement(s.shard_id).node_id)
        for s in shards)
    skip_fp = tuple(
        (store.storage_column_name(table, col), op, val)
        for col, op, val in skippable_tests(node.filter))
    key = (table, store.data_version(table), tuple(node.columns),
           None if node.pruned_shards is None else tuple(node.pruned_shards),
           n_dev, str(np.dtype(compute_dtype)), placement_sig, skip_fp,
           str(device))
    entry = cache.get(key)
    if entry is None:
        cache.invalidate_table(table, keep_version=key[1])
        # charged as "cache" from the start: the tensors become
        # cache-resident below and release when the entry is evicted
        spec = _feed_scan(node, catalog, store, device, n_dev, compute_dtype,
                          accountant, "cache", stats)
        from .cache import CachedFeed

        nbytes = sum(t.numel() * t.element_size()
                     for t in list(spec.arrays.values())
                     + list(spec.nulls.values()) + [spec.valid])
        cache.put(key, CachedFeed(sharded=spec.sharded, arrays=spec.arrays,
                                  nulls=spec.nulls, valid=spec.valid,
                                  capacity=spec.capacity, nbytes=nbytes,
                                  dev_rows=spec.dev_rows))
        return spec
    return FeedSpec(node=node, sharded=entry.sharded, arrays=entry.arrays,
                    nulls=entry.nulls, valid=entry.valid,
                    capacity=entry.capacity, dev_rows=entry.dev_rows)


def _feed_scan(node: ScanNode, catalog: Catalog, store: TableStore,
               device, n_dev: int, compute_dtype, accountant,
               category: str, stats) -> FeedSpec:
    if n_dev != 1:
        raise ExecutionError("the port executes on one device")
    pipelined = maybe_pipelined_feed(node, catalog, store, device,
                                     compute_dtype, accountant, category,
                                     stats)
    if pipelined is not None:
        return pipelined
    rel = node.rel
    meta = catalog.table(rel.table)
    colnames = [cid.split(".", 1)[1] for cid in node.columns]
    shards = catalog.table_shards(rel.table)
    chunk_filter = None
    if node.filter is not None:
        name_map = {c.name: store.storage_column_name(rel.table, c.name)
                    for c in meta.schema.columns}
        chunk_filter = make_chunk_filter(node.filter, name_map)

    sharded = meta.method == DistributionMethod.HASH
    if not sharded and len(shards) != 1:
        raise ExecutionError(f"table {rel.table}: expected single shard")
    if sharded:
        # every shard this device owns (all of them, on one device)
        placement = table_placement(catalog, rel.table, n_dev)
        owned = [s for s, dev in zip(shards, placement) if dev == 0
                 and (node.pruned_shards is None
                      or s.shard_index in node.pruned_shards)]
    else:
        owned = shards
    vals_l: dict[str, list[np.ndarray]] = {c: [] for c in colnames}
    mask_l: dict[str, list[np.ndarray]] = {c: [] for c in colnames}
    rows = 0
    for s in owned:
        vals, mask, n = store.read_shard(rel.table, s.shard_id, colnames,
                                         chunk_filter)
        if n == 0:
            continue
        rows += n
        for c in colnames:
            vals_l[c].append(vals[c])
            mask_l[c].append(mask[c])
    cap = _round_cap(max(rows, 1))

    def place(host: np.ndarray) -> torch.Tensor:
        return accountant.place(host, device, category)

    arrays, nulls = {}, {}
    for cid, cname in zip(node.columns, colnames):
        dtype = rel.schema.column(cname).dtype.numpy_dtype
        if dtype == np.float64 and compute_dtype is not None:
            dtype = np.dtype(compute_dtype)
        buf = np.zeros(cap, dtype=dtype)
        if vals_l[cname]:
            buf[:rows] = np.concatenate(vals_l[cname]).astype(dtype)
            m = np.concatenate(mask_l[cname])
            if not m.all():
                nbuf = np.zeros(cap, dtype=bool)
                nbuf[:rows] = ~m
                nulls[cid] = place(nbuf)
        arrays[cid] = place(buf)
    valid = np.zeros(cap, dtype=bool)
    valid[:rows] = True
    return FeedSpec(node=node, sharded=sharded, arrays=arrays, nulls=nulls,
                    valid=place(valid), capacity=cap,
                    dev_rows=[rows] if sharded else None)
