"""Execution caches: compiled plans + resident device tables.

The reference amortizes per-query work two ways: cached local plans
(planner/local_plan_cache.c:1-60 keeps prepared shard plans keyed on the
shard interval) and long-lived worker connections/pools reused across
queries (executor/adaptive_executor.c:962).  The port's analogues:

* **Plan cache** — the PlanCompiler for a plan shape (its capacities and
  output layout) is cached keyed on a deterministic structural
  fingerprint (plan tree + expressions + static capacities + feed
  signature + dtype).

* **Feed cache** — per-table device-resident column tensors ([cap]
  padded) keyed on (table, columns, pruning, placement, data version).
  Re-running a query re-uses resident tensors instead of re-reading
  stripes, decompressing, padding and copying to the device.
  Invalidation: TableStore bumps a per-table data version on every
  manifest mutation.

Both caches are LRU-bounded (plans by entry count, feeds by device bytes).
The feed cache is also an evictable of the data_dir's accountant: the
OOM ladder's first rung evicts it coldest first (`evict_coldest`).

The plan cache also holds each key's captured CUDA graph
(executor/graphs.py).  A graph reads the feeds it was captured over, so
the feed cache reports every entry it drops (`on_drop`): the executor
releases the graphs reading those tensors, and a dropped graph reads as
absent here.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass

from ..planner.plan import (
    AggregateNode,
    JoinNode,
    PlanNode,
    ProjectNode,
    QueryPlan,
    ScanNode,
    WindowNode,
)


def _dist_sig(dist) -> str:
    return (f"{dist.kind}:{sorted(dist.cids)}:{dist.shard_count}:"
            f"{dist.placement}:{dist.bounds}")


def node_fingerprint(node: PlanNode) -> str:
    """Deterministic structural serialization of a plan subtree.

    Covers everything PlanCompiler bakes into the traced program:
    expression trees (constants included — they become XLA literals),
    join strategies, aggregate modes, and distribution descriptors.
    Frozen-dataclass reprs contain only field values, so the string is
    stable across processes.
    """
    if isinstance(node, ScanNode):
        return (f"S({node.rel.rel_index};{node.rel.table};{node.columns};"
                f"{node.pruned_shards};{node.filter!r};"
                f"{_dist_sig(node.dist)})")
    if isinstance(node, ProjectNode):
        exprs = [(repr(e), cid) for e, cid in node.exprs]
        return f"P({node_fingerprint(node.input)};{exprs})"
    if isinstance(node, JoinNode):
        return (f"J({node.strategy};{node.join_type};{node.repart_key_idx};"
                f"{node.build_side};{node.left_key_extents};"
                f"{node.right_key_extents};{node.key_int32};"
                f"{node.fuse_lookup};{node.probe_bucketed};"
                f"{node.flag_combine};"
                f"{node_fingerprint(node.left)};"
                f"{node_fingerprint(node.right)};"
                f"{[repr(k) for k in node.left_keys]};"
                f"{[repr(k) for k in node.right_keys]};"
                f"{node.residual!r};{node.left_match_filter!r};"
                f"{node.right_match_filter!r};{_dist_sig(node.dist)})")
    if isinstance(node, WindowNode):
        fns = [(repr(w), cid) for w, cid in node.functions]
        return (f"W({node.combine};{fns};"
                f"{[repr(p) for p in node.partition_by]};"
                f"{node_fingerprint(node.input)};{_dist_sig(node.dist)})")
    if isinstance(node, AggregateNode):
        groups = [(repr(g), cid) for g, cid in node.group_keys]
        aggs = [(repr(a), cid) for a, cid in node.aggs]
        return (f"A({node.combine};{node.repart_keys};"
                f"{node_fingerprint(node.input)};"
                f"{groups};{aggs};{node.dense_keys};{node.dense_total};"
                f"{node.key_ranges};{node.bucket_keys};"
                f"{node.bucket_total};{node.group_bucketed};"
                f"{_dist_sig(node.dist)})")
    raise TypeError(f"unknown plan node {type(node).__name__}")


def plan_order(plan: QueryPlan) -> dict[int, int]:
    """id(node) → deterministic plan-walk index (for serializing the
    id-keyed Capacities dicts into cache keys)."""
    from .feed import walk_plan

    return {id(n): i for i, n in enumerate(walk_plan(plan.root))}


def caps_signature(plan: QueryPlan, caps) -> tuple:
    order = plan_order(plan)
    return (tuple(sorted((order[k], v) for k, v in caps.repartition.items())),
            tuple(sorted((order[k], v) for k, v in caps.join_out.items())),
            tuple(sorted((order[k], v) for k, v in caps.agg_out.items())),
            caps.dense_off,
            tuple(sorted((order[k], v) for k, v in caps.scan_out.items())),
            caps.output_repart,
            tuple(sorted((order[k], v)
                         for k, v in caps.bucket_probe.items())),
            tuple(sorted((order[k], v)
                         for k, v in caps.agg_bucket.items())))


def feeds_signature(plan: QueryPlan, feeds) -> tuple:
    """Feed array structure in deterministic plan order: what the jitted
    function's input signature depends on (shapes, dtypes, null columns)."""
    from .feed import walk_plan

    sig = []
    for node in walk_plan(plan.root):
        if isinstance(node, ScanNode):
            f = feeds[id(node)]
            sig.append((
                f.sharded, f.capacity,
                tuple((cid,) + _tensor_sig(f.arrays[cid])
                      for cid in sorted(f.arrays)),
                tuple(sorted(f.nulls)),
            ))
    return tuple(sig)


def _tensor_sig(t) -> tuple:
    """(dtype, shape) of a feed tensor; a per-position list (a mesh over
    several cards) reads as its stacked shape."""
    if isinstance(t, (list, tuple)):
        return (str(t[0].dtype), (len(t),) + tuple(t[0].shape))
    return (str(t.dtype), t.shape)


class PlanCache:
    """LRU cache of PlanCompilers keyed by plan fingerprint.

    Thread-safe: concurrent sessions threads race get/put (two threads
    compiling the same new plan is wasted work, never wrong results)."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._entries: OrderedDict[tuple, object] = OrderedDict()
        # key → the CapturedPlan its runs replay (live while the feeds
        # it reads are served)
        self._graphs: dict[tuple, object] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple):
        with self._lock:
            fn = self._entries.get(key)
            if fn is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return fn

    def put(self, key: tuple, fn) -> None:
        if self.max_entries <= 0:
            return
        with self._lock:
            self._entries[key] = fn
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                old, _ = self._entries.popitem(last=False)
                self._graphs.pop(old, None)

    def graph(self, key: tuple):
        """The key's live captured graph, or None."""
        with self._lock:
            g = self._graphs.get(key)
            if g is not None and not g.live:
                del self._graphs[key]
                g = None
            return g

    def put_graph(self, key: tuple, graph) -> None:
        with self._lock:
            if key in self._entries:
                self._graphs[key] = graph

    def drop_graph(self, key: tuple) -> None:
        with self._lock:
            self._graphs.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._graphs.clear()

    def __len__(self):
        return len(self._entries)


@dataclass
class CachedFeed:
    """Device-resident arrays for one (table, columns, pruning) scan."""

    sharded: bool
    arrays: dict          # cid → torch.Tensor on the device
    nulls: dict
    valid: object
    capacity: int
    nbytes: int = 0
    dev_rows: list | None = None  # per-device row counts (Mesh: line)


class FeedCache:
    """LRU byte-bounded cache of device-resident table feeds.

    Thread-safe; an evicted entry's tensors stay alive for any thread
    already holding them (tensors are reference-counted).  Eager and
    pipelined feeds are cached alike; their tensors carry the
    accountant's ``cache`` charge, released when the last holder of an
    evicted entry's tensors drops them.  Entries hold no views of placed
    tensors, so the charge never outlives or undercounts the memory."""

    def __init__(self, max_bytes: int = 4 << 30, on_drop=None):
        self.max_bytes = max_bytes
        # called, outside the lock, with the ids of the tensors of every
        # entry this cache dropped (the executor releases the graphs
        # that read them)
        self.on_drop = on_drop
        self._dropped: list[CachedFeed] = []
        self._entries: OrderedDict[tuple, CachedFeed] = OrderedDict()
        # per-table key index (key layout: (table, version, ...)):
        # every DML bumps the written table's data version and calls
        # invalidate_table — scanning the WHOLE entry dict under the
        # lock on each write serialized concurrent small writers behind
        # reader traffic for nothing
        self._by_table: dict[str, set] = {}
        self._lock = threading.Lock()
        self._total_bytes = 0
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def get(self, key: tuple) -> CachedFeed | None:
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return e

    def _pop_locked(self, key: tuple) -> None:
        e = self._entries.pop(key)
        self._total_bytes -= e.nbytes
        if self.on_drop is not None:
            self._dropped.append(e)
        keys = self._by_table.get(key[0])
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._by_table[key[0]]

    def _notify(self) -> None:
        """Report the entries dropped since the last call (outside the
        lock: a graph release takes the graph's own lock)."""
        if self.on_drop is None:
            return
        with self._lock:
            dropped, self._dropped = self._dropped, []
        if dropped:
            self.on_drop(frozenset(
                id(t) for e in dropped
                for t in (*e.arrays.values(), *e.nulls.values(), e.valid)))

    def put(self, key: tuple, feed: CachedFeed) -> bool:
        """Cache `feed`; False when the cache holds nothing (a zero
        byte budget)."""
        if self.max_bytes <= 0:
            return False
        with self._lock:
            if key in self._entries:
                self._pop_locked(key)
            self._entries[key] = feed
            self._by_table.setdefault(key[0], set()).add(key)
            self._total_bytes += feed.nbytes
            while self._total_bytes > self.max_bytes \
                    and len(self._entries) > 1:
                self._pop_locked(next(iter(self._entries)))
        self._notify()
        return True

    def invalidate_table(self, table: str, keep_version: int | None = None
                         ) -> None:
        """Drop entries for `table` via the per-table key index (no
        full-cache scan); keep_version spares the current version's
        entries."""
        with self._lock:
            keys = self._by_table.get(table)
            if not keys:
                return
            stale = [k for k in keys if k[1] != keep_version]
            for k in stale:
                self._pop_locked(k)
            self.invalidations += len(stale)
        self._notify()

    def evict_coldest(self, target_bytes: int | None = None) -> int:
        """Evict entries coldest first (LRU order) until `target_bytes`
        have been freed — everything when None.  The OOM degradation
        ladder's first rung (executor/hbm.py `evict_evictable`): an
        entry's tensors, and their ``cache`` charges, are released as
        soon as no running statement still holds them.  Returns entries
        evicted."""
        with self._lock:
            evicted = 0
            freed = 0
            while self._entries and (target_bytes is None
                                     or freed < target_bytes):
                key = next(iter(self._entries))
                freed += self._entries[key].nbytes
                self._pop_locked(key)
                evicted += 1
        self._notify()
        return evicted

    def clear(self) -> None:
        with self._lock:
            for key in list(self._entries):
                self._pop_locked(key)
            self._by_table.clear()
            self._total_bytes = 0
        self._notify()

    @property
    def total_bytes(self) -> int:
        return self._total_bytes

    def __len__(self):
        return len(self._entries)
