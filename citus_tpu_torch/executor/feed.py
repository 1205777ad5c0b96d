"""Host→device data feed: shard stripes → padded column tensors.

Counterpart of citus_tpu/executor/feed.py (its eager path).  At one
position every shard's stripes concatenate into one padded [capacity]
buffer per column: the catalog's node↔device map folds every node onto
position 0, so a data_dir written by an 8-device JAX session reads here
unchanged.  On a mesh of N positions (distributed/mesh.py) a HASH
table's feed is device-owned: position i's slice holds only the shards
the node↔device map (`table_placement`) gives it, every slice padded to
one capacity, placed through `place_sharded_slices` — an [N, capacity]
plane when the positions share a card, one tensor per position
otherwise; either way `arrays[cid][i]` is position i's column.
Reference tables feed whole, marked replicated.  Shard pruning (ScanNode.pruned_shards) and chunk min/max
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
from ..stats.counters import CHUNKS_SKIPPED
from ..storage import TableStore
from .compiler import _round_cap
from .scanpipe import maybe_pipelined_feed


@dataclass
class FeedSpec:
    """Device feed for one scan: [capacity] tensors indexed like the plan
    (a sharded feed on a mesh: [n_positions, capacity], see above)."""

    node: ScanNode
    sharded: bool               # False ⇒ replicated (reference table)
    arrays: dict[str, torch.Tensor]
    nulls: dict[str, torch.Tensor]
    valid: torch.Tensor
    capacity: int
    # rows each position owns (pre-padding; None for replicated feeds)
    dev_rows: list[int] | None = None
    # the feed-cache key serving these tensors (None: not cache-resident,
    # so no CUDA graph may read them — executor/graphs.py)
    cache_key: tuple | None = None


def walk_plan(node: PlanNode):
    yield node
    if isinstance(node, JoinNode):
        yield from walk_plan(node.left)
        yield from walk_plan(node.right)
    elif isinstance(node, (AggregateNode, ProjectNode, WindowNode)):
        yield from walk_plan(node.input)


def feed_nbytes(arrays) -> int:
    """Device bytes of a feed's tensors (a per-position list counts each
    position's tensor)."""
    total = 0
    for t in arrays:
        for x in (t if isinstance(t, (list, tuple)) else (t,)):
            total += x.numel() * x.element_size()
    return total


def build_feeds(plan: QueryPlan, catalog: Catalog, store: TableStore,
                device, compute_dtype, cache, accountant,
                stats, no_cache_nodes=frozenset(),
                counters=None, mesh=None) -> dict[int, FeedSpec]:
    """One FeedSpec per scan node, placed through `accountant` (the
    data_dir's DeviceMemoryAccountant); `stats` (a ScanPhaseStats)
    collects the pipelined scans' phase walls, `counters` (the session's
    StatCounters) the skipped and prefetched chunks.  Scans in
    `no_cache_nodes` (a multi-pass pass's split scan) bypass the feed
    cache.  `mesh` is the plan's mesh (None: one position on `device`)."""
    if plan.n_devices > 1 and (mesh is None
                               or mesh.size != plan.n_devices):
        raise ExecutionError(
            f"a plan for {plan.n_devices} positions needs its mesh")
    feeds: dict[int, FeedSpec] = {}
    for node in walk_plan(plan.root):
        if isinstance(node, ScanNode):
            feeds[id(node)] = _feed_scan_cached(
                node, catalog, store, device, plan.n_devices, compute_dtype,
                None if id(node) in no_cache_nodes else cache, accountant,
                stats, counters, mesh)
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


def make_chunk_filter(filter_expr, storage_name=None, counters=None):
    """ScanNode filter → per-chunk min/max skip predicate (None when the
    filter has no skippable shape).  `storage_name` maps current →
    on-disk column names; each skipped chunk bumps `counters`'
    chunks_skipped."""
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
                if counters is not None:
                    counters.increment(CHUNKS_SKIPPED)
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
                      stats, counters=None, mesh=None) -> FeedSpec:
    """Device-feed cache wrapper keyed on (table, data version, columns,
    pruning, placement, skip filter, mesh width and the positions' ids
    and devices, and which position owns each shard) — see
    executor/cache.py.  Eager and pipelined feeds share the key: both
    hold the same rows in the same places.  Open-transaction overlays
    bypass the cache."""
    table = node.rel.table
    if cache is None or _overlay_touches(store, table):
        return _feed_scan(node, catalog, store, device, n_dev, compute_dtype,
                          accountant, "feed", stats, counters, mesh)
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
    if n_dev > 1:
        # a feed laid out for one mesh is never adopted by another: the
        # positions' ids and devices and the shard → position map
        key = key + (tuple(mesh.ids), tuple(str(d) for d in mesh.devices),
                     table_placement(catalog, table, n_dev, probe=False))
    entry = cache.get(key)
    if entry is None:
        cache.invalidate_table(table, keep_version=key[1])
        # charged as "cache" from the start: the tensors become
        # cache-resident below and release when the entry is evicted
        spec = _feed_scan(node, catalog, store, device, n_dev, compute_dtype,
                          accountant, "cache", stats, counters, mesh)
        from .cache import CachedFeed

        nbytes = feed_nbytes(list(spec.arrays.values())
                             + list(spec.nulls.values()) + [spec.valid])
        if cache.put(key, CachedFeed(sharded=spec.sharded,
                                     arrays=spec.arrays, nulls=spec.nulls,
                                     valid=spec.valid,
                                     capacity=spec.capacity, nbytes=nbytes,
                                     dev_rows=spec.dev_rows)):
            spec.cache_key = key
        return spec
    return FeedSpec(node=node, sharded=entry.sharded, arrays=entry.arrays,
                    nulls=entry.nulls, valid=entry.valid,
                    capacity=entry.capacity, dev_rows=entry.dev_rows,
                    cache_key=key)


def _feed_scan(node: ScanNode, catalog: Catalog, store: TableStore,
               device, n_dev: int, compute_dtype, accountant,
               category: str, stats, counters=None, mesh=None) -> FeedSpec:
    pipelined = maybe_pipelined_feed(node, catalog, store, device,
                                     compute_dtype, accountant, category,
                                     stats, counters, mesh)
    if pipelined is not None:
        return pipelined
    from ..utils.faultinjection import fault_point

    # named seam: the eager feed's placement of the scan's columns
    fault_point("executor.device_put")
    rel = node.rel
    meta = catalog.table(rel.table)
    colnames = [cid.split(".", 1)[1] for cid in node.columns]
    shards = catalog.table_shards(rel.table)
    chunk_filter = None
    if node.filter is not None:
        name_map = {c.name: store.storage_column_name(rel.table, c.name)
                    for c in meta.schema.columns}
        chunk_filter = make_chunk_filter(node.filter, name_map, counters)

    sharded = meta.method == DistributionMethod.HASH
    if not sharded and len(shards) != 1:
        raise ExecutionError(f"table {rel.table}: expected single shard")
    if sharded and n_dev > 1:
        return _feed_scan_mesh(node, catalog, store, mesh, compute_dtype,
                               accountant, category, colnames, shards,
                               chunk_filter)
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


def _feed_scan_mesh(node: ScanNode, catalog: Catalog, store: TableStore,
                    mesh, compute_dtype, accountant, category: str,
                    colnames: list, shards, chunk_filter) -> FeedSpec:
    """A HASH table's device-owned feed on a mesh: position i's slice
    holds the (unpruned) shards `table_placement` gives it, in shard
    order; every slice pads to one capacity (the largest position's
    rows) and places through `place_sharded_slices`."""
    rel = node.rel
    n_dev = mesh.size
    placement = table_placement(catalog, rel.table, n_dev)
    vals_l = [{c: [] for c in colnames} for _ in range(n_dev)]
    mask_l = [{c: [] for c in colnames} for _ in range(n_dev)]
    rows = [0] * n_dev
    for s, pos in zip(shards, placement):
        if node.pruned_shards is not None and \
                s.shard_index not in node.pruned_shards:
            continue
        vals, mask, n = store.read_shard(rel.table, s.shard_id, colnames,
                                         chunk_filter)
        if n == 0:
            continue
        rows[pos] += n
        for c in colnames:
            vals_l[pos][c].append(vals[c])
            mask_l[pos][c].append(mask[c])
    cap = _round_cap(max(max(rows), 1))

    def place(slices):
        return accountant.place_sharded_slices(mesh, slices, category)

    arrays, nulls = {}, {}
    for cid, cname in zip(node.columns, colnames):
        dtype = rel.schema.column(cname).dtype.numpy_dtype
        if dtype == np.float64 and compute_dtype is not None:
            dtype = np.dtype(compute_dtype)
        bufs = [np.zeros(cap, dtype=dtype) for _ in range(n_dev)]
        nbufs = [np.zeros(cap, dtype=bool) for _ in range(n_dev)]
        any_null = False
        for pos in range(n_dev):
            if not vals_l[pos][cname]:
                continue
            r = rows[pos]
            bufs[pos][:r] = np.concatenate(vals_l[pos][cname]).astype(dtype)
            m = np.concatenate(mask_l[pos][cname])
            if not m.all():
                nbufs[pos][:r] = ~m
                any_null = True
        arrays[cid] = place(bufs)
        if any_null:
            nulls[cid] = place(nbufs)
    valid = [np.arange(cap) < r for r in rows]
    return FeedSpec(node=node, sharded=True, arrays=arrays, nulls=nulls,
                    valid=place(valid), capacity=cap, dev_rows=rows)
