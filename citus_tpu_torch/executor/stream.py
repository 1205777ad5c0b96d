"""Streamed execution: tables larger than the device feed in stripe batches.

Counterpart of citus_tpu/executor/stream.py.  The
reference never holds a whole table in memory — the columnar reader
iterates stripe by stripe (columnar/columnar_reader.c:323).  The
resident-feed executor (executor/feed.py) holds every scanned table on
the card, which caps table size at device memory.  This module restores
the streaming property:

* the LARGEST hash-distributed scan on a semantics-preserving path is
  picked as the *stream* node when the plan's feeds exceed
  `max_feed_bytes_per_device` (or the accountant's smaller budget);
* its stripes are assembled into fixed-shape [batch_cap] batches — the
  same capacity every batch, so one cached PlanCompiler and one
  capacity set serve them all.  On a mesh each batch is an
  [n_positions, batch_cap] plane: position i's row pulls only from the
  shards the node↔device map gives position i, so the peak `stream`
  bytes stay bound per position (the budget is per position: a card's
  budget splits evenly among the positions on it);
* a producer thread decodes batch i+1 on the host, stages it in pinned
  memory and copies it on its own CUDA stream while the statement's
  thread runs batch i; the consumer waits on the batch's event and
  `record_stream`s its tensors.  At most `scan_prefetch_depth` + 1
  batches are placed at once, each charged to the ledger's ``stream``
  category;
* per-batch outputs merge on the host: group rows re-aggregate
  (count/sum/min/max are distributive; avg is already split into
  sum + count by the planner), plain row outputs concatenate.

Eligibility is a plan-shape property (`_stream_path`): every join between
the stream scan and the root must see the full other side per batch and
emit each output row in exactly one batch — inner joins anywhere, outer
joins only when the streamed side is the preserved side.  Aggregates are
allowed only at the root (distributive merge); windows never.

Device top-k (`plan.device_topk`) is kept per batch only where a batch's
top k is a superset of its share of the global top k: a row output, or
an aggregate ordered by group keys alone.  Ordered by an aggregate, a
batch's partial sums say nothing about the group's total, so the batch
plans run without it and the host sorts and limits after the merge
(`partial_plan`; executor/multipass.py applies it per pass).

Observability: the producer adopts the statement's trace context, so its
`stream.decode` / `stream.transfer` spans (a transfer carries a CUDA
event pair on the producer's stream) land in the statement's tree; each
batch's run is a `stream.batch` span.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import replace as dc_replace

import numpy as np
import torch

from ..catalog import DistributionMethod
from ..planner.plan import (
    AggregateNode,
    JoinNode,
    PlanNode,
    ProjectNode,
    QueryPlan,
    ScanNode,
    WindowNode,
)
from ..planner import expr as ir
from ..stats import counters as sc
from ..stats.tracing import (
    adopt_context,
    capture_context,
    device_timeline,
    trace_span,
)
from ..utils.cancellation import check_cancel
from ..utils.faultinjection import fault_point
from .cache import feeds_signature, node_fingerprint
from .compiler import _round_cap
from .feed import FeedSpec, _feed_scan_cached, make_chunk_filter, walk_plan
from .handoff import unpack_outputs


# ---------------------------------------------------------------------------
# eligibility + sizing

def _scan_width_bytes(node: ScanNode, catalog, compute_dtype) -> int:
    """Per-row feed bytes for one scan: column widths (after the f64→
    compute-dtype policy) + a null byte per column + the validity byte."""
    meta = catalog.table(node.rel.table)
    w = 1
    for cid in node.columns:
        cname = cid.split(".", 1)[1]
        dt = meta.schema.column(cname).dtype.numpy_dtype
        if dt == np.float64 and compute_dtype is not None:
            dt = np.dtype(compute_dtype)
        w += np.dtype(dt).itemsize + 1
    return w


def _scan_dev_rows(node: ScanNode, catalog, store, n_dev: int = 1) -> int:
    """Most rows any position would hold for this scan (pre-padding)."""
    from ..planner.plan import table_placement

    meta = catalog.table(node.rel.table)
    if meta.method != DistributionMethod.HASH:
        return store.table_row_count(node.rel.table)
    shards = catalog.table_shards(node.rel.table)
    # a placement pick per shard, through the catalog.placement_probe
    # seam, as the JAX package's estimate makes it
    placement = table_placement(catalog, node.rel.table, n_dev)
    per_dev = [0] * n_dev
    for s, dev in zip(shards, placement):
        if node.pruned_shards is None or \
                s.shard_index in node.pruned_shards:
            per_dev[dev] += store.shard_row_count(node.rel.table,
                                                  s.shard_id)
    return max(per_dev)


def _path_to(plan: QueryPlan, target_id: int) -> list[PlanNode] | None:
    """Root → node `target_id` (by id), or None."""

    def rec(node: PlanNode) -> list[PlanNode] | None:
        if id(node) == target_id:
            return [node]
        kids = []
        if isinstance(node, JoinNode):
            kids = [node.left, node.right]
        elif isinstance(node, (AggregateNode, ProjectNode, WindowNode)):
            kids = [node.input]
        for k in kids:
            p = rec(k)
            if p is not None:
                return [node] + p
        return None

    return rec(plan.root)


def _stream_path(plan: QueryPlan, stream_id: int) -> bool:
    """Is batching the scan `stream_id` semantics-preserving?

    Path constraints (root → stream scan):
    * JoinNode: inner always; LEFT / semi / anti only when the stream
      side is the left (preserved / probe) subtree; RIGHT only when it
      is the right.  FULL never (both sides preserved — unmatched flags
      need global state).
    * AggregateNode: only as the plan ROOT (its distributive partials
      merge host-side); a nested aggregate (DISTINCT rewrite) would
      dedupe per batch only.
    * WindowNode: never on the path.
    """
    path = _path_to(plan, stream_id)
    if path is None:
        return False
    for i, node in enumerate(path[:-1]):
        if isinstance(node, JoinNode):
            on_left = path[i + 1] is node.left
            if node.join_type == "inner":
                continue
            if node.join_type in ("left", "semi", "anti") and on_left:
                # semi/anti distribute over probe batches when the build
                # side is fully resident (each batch sees every match)
                continue
            if node.join_type == "right" and not on_left:
                continue
            return False
        if isinstance(node, WindowNode):
            return False
        if isinstance(node, AggregateNode):
            if i != 0 or not _mergeable_aggregate(node):
                return False
    return True


def _mergeable_aggregate(node: AggregateNode) -> bool:
    for a, _cid in node.aggs:
        if getattr(a, "distinct", False):
            return False
        if a.kind not in ("count", "count_star", "sum", "min", "max"):
            return False
    return True


def stream_candidates(plan: QueryPlan, catalog) -> list[ScanNode]:
    """Hash-distributed scans on a semantics-preserving stream path —
    the eligibility half of pick_stream_node, shared with the OOM
    degradation ladder (can a forced-stream rung help this plan?)."""
    return [s for s in walk_plan(plan.root) if isinstance(s, ScanNode)
            and catalog.table(s.rel.table).method ==
            DistributionMethod.HASH and _stream_path(plan, id(s))]


def pick_stream_node(plan: QueryPlan, catalog, store, compute_dtype,
                     budget: int, forced_rows: int = 0, shrink: int = 1,
                     force: bool = False, prefetch_depth: int = 1,
                     n_dev: int = 1):
    """(stream ScanNode, batch_cap) or None.

    Streams only when the combined feed bytes exceed `budget` and the
    largest hash-distributed scan is on a semantics-preserving path.  A
    non-zero `forced_rows` (stream_batch_rows) overrides batch sizing.

    `shrink` / `force` are the OOM degradation ladder's inputs
    (Executor.degrade_for_oom): `shrink` divides the computed batch_cap,
    `force` streams even when the feeds fit the configured budget — an
    OOM proved the effective ceiling lower than the configured one.

    `prefetch_depth` is the batch queue's depth (scan_prefetch_depth):
    depth + 1 batches can be on the device at once, so the per-batch
    budget divisor scales with it — a deeper queue means smaller
    batches, never more resident bytes than the budget.  Sizes and the
    budget are per position (`n_dev` positions)."""
    scans = [n for n in walk_plan(plan.root) if isinstance(n, ScanNode)]
    sizes = {}
    for s in scans:
        rows = _scan_dev_rows(s, catalog, store, n_dev)
        sizes[id(s)] = _round_cap(max(rows, 1)) * \
            _scan_width_bytes(s, catalog, compute_dtype)
    total = sum(sizes.values())
    if total <= budget and not force:
        return None
    candidates = stream_candidates(plan, catalog)
    if not candidates:
        return None
    stream = max(candidates, key=lambda s: sizes[id(s)])
    width = _scan_width_bytes(stream, catalog, compute_dtype)
    stream_rows = max(1, sizes[id(stream)] // width)
    if forced_rows:
        return stream, _round_cap(max(1, forced_rows // max(1, shrink)))
    other = total - sizes[id(stream)]
    # resident batches (depth queued + 1 consumed) + downstream join
    # intermediates sized off the batch: budget each batch at
    # 1/(depth+5) of what remains
    div = max(1, int(prefetch_depth)) + 5
    avail = budget - other
    if avail < div * width * 4096 and not force:
        return None  # other feeds leave no useful room — fall through
    batch_cap = int(max(avail, div * width * 1024) // (div * width))
    if force:
        # a forced stream must actually batch: at least 2 batches, and
        # the 1024-row floor must not re-inflate a small table's halved
        # cap into one full-table batch (128 is the _round_cap floor)
        batch_cap = min(batch_cap, -(-stream_rows // 2))
    floor = 128 if force else 1024
    batch_cap = _round_cap(max(floor, batch_cap // max(1, shrink)))
    if not force and batch_cap * 1.05 >= stream_rows:
        return None  # would be a single batch anyway
    return stream, batch_cap


# ---------------------------------------------------------------------------
# batched stream feeds

class StreamBatcher:
    """Assemble one scan's stripes into fixed-shape [batch_cap] feed
    batches ([n_pos, batch_cap] on a mesh, each position reading only
    its own shards), reading lazily (per position at most one open
    stripe, plus the rows carried over from it)."""

    def __init__(self, node: ScanNode, catalog, store, device,
                 compute_dtype, batch_cap: int, accountant, stats=None,
                 n_pos: int = 1):
        self.stats = stats
        self.node = node
        self.store = store
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.compute_dtype = compute_dtype
        self.batch_cap = batch_cap
        self.accountant = accountant
        table = node.rel.table
        self.colnames = [cid.split(".", 1)[1] for cid in node.columns]
        # the same storage-name-mapped chunk skip filter the resident
        # feed applies (min/max pruning must not vanish because the
        # table streams)
        self._chunk_filter = None
        if node.filter is not None:
            meta = catalog.table(table)
            name_map = {c.name: store.storage_column_name(table, c.name)
                        for c in meta.schema.columns}
            self._chunk_filter = make_chunk_filter(node.filter, name_map)
        shards = catalog.table_shards(table)
        self.n_pos = n_pos
        if n_pos == 1:
            pos_of = (0,) * len(shards)
        else:
            from ..planner.plan import table_placement

            pos_of = table_placement(catalog, table, n_pos)
        self._shards = [s.shard_id for s in shards
                        if node.pruned_shards is None
                        or s.shard_index in node.pruned_shards]
        by_pos: list[list[int]] = [[] for _ in range(n_pos)]
        for s, pos in zip(shards, pos_of):
            if node.pruned_shards is None or \
                    s.shard_index in node.pruned_shards:
                by_pos[pos].append(s.shard_id)
        self.rows_by_pos = [sum(store.shard_row_count(table, sid)
                                for sid in sids) for sids in by_pos]
        self.total_rows = sum(self.rows_by_pos)
        self._iters = [self._stripes(sids) for sids in by_pos]
        self._carries: list = [None] * n_pos
        # Which columns carry a nulls plane is decided ONCE, from the
        # manifest's stripe stats, so every batch presents the same
        # feed structure to the cached PlanCompiler (a per-batch
        # decision would change the plan's feed signature mid-stream
        # when NULL presence differs across stripes).  Missing stats
        # count as "may hold NULLs".
        storage_of = {c: store.storage_column_name(table, c)
                      for c in self.colnames}
        recs = [r for sid in self._shards
                for r in store.shard_stripe_records(table, sid)]
        null_cols: set[str] = set()
        for cname in self.colnames:
            s_name = storage_of[cname]
            for r in recs:
                st = (r.get("stats") or {}).get(s_name)
                if st is None or len(st) < 3 or st[2]:
                    null_cols.add(cname)
                    break
        self._null_cols = null_cols

    def _stripes(self, shard_ids):
        for sid in shard_ids:
            yield from self.store.iter_shard_stripes(
                self.node.rel.table, sid, self.colnames,
                self._chunk_filter)

    def _pull(self, want: int, pos: int = 0):
        """Up to `want` rows from position `pos`'s stripe stream."""
        pieces: list[tuple[dict, dict, int]] = []
        got = 0
        while got < want:
            if self._carries[pos] is not None:
                v, m, n = self._carries[pos]
                self._carries[pos] = None
            else:
                try:
                    v, m, n = next(self._iters[pos])
                except StopIteration:
                    break
                if n == 0:
                    continue
            take = min(n, want - got)
            if take < n:
                self._carries[pos] = ({c: a[take:] for c, a in v.items()},
                                      {c: a[take:] for c, a in m.items()},
                                      n - take)
                v = {c: a[:take] for c, a in v.items()}
                m = {c: a[:take] for c, a in m.items()}
            pieces.append((v, m, take))
            got += take
        return pieces, got

    def _host(self, dtype) -> tuple[torch.Tensor, np.ndarray]:
        """A zeroed [n_pos · batch_cap] staging buffer as (tensor, numpy
        view): pinned on a CUDA session, so its copy runs
        asynchronously."""
        t = torch.zeros(self.n_pos * self.batch_cap,
                        dtype=_torch_dtype(dtype), pin_memory=self.cuda)
        return t, t.numpy()

    def feed(self, batch_index: int) -> FeedSpec | None:
        """Build and place the next batch (called once per index, in
        order).  Returns None when the stream is exhausted — checked
        before any buffer or device memory is allocated.  Batch 0
        always materializes (an empty table still runs once)."""
        node, rel = self.node, self.node.rel
        t0 = time.perf_counter()
        cap = self.batch_cap
        with trace_span("stream.decode"):
            pulled = [self._pull(cap, p) for p in range(self.n_pos)]
            rows_by_pos = [got for _pieces, got in pulled]
            if batch_index > 0 and not any(rows_by_pos):
                return None
            host_arrays, host_nulls = {}, {}
            for cid, cname in zip(node.columns, self.colnames):
                dtype = rel.schema.column(cname).dtype.numpy_dtype
                if dtype == np.float64 and self.compute_dtype is not None:
                    dtype = np.dtype(self.compute_dtype)
                t, buf = self._host(dtype)
                with_nulls = cname in self._null_cols
                nt, nbuf = (self._host(np.bool_) if with_nulls
                            else (None, None))
                for p, (pieces, _got) in enumerate(pulled):
                    at = p * cap
                    for v, m, take in pieces:
                        buf[at:at + take] = v[cname].astype(dtype,
                                                            copy=False)
                        if with_nulls:
                            nbuf[at:at + take] = ~m[cname]
                        at += take
                host_arrays[cid] = t
                if with_nulls:
                    host_nulls[cid] = nt
            vt, vbuf = self._host(np.bool_)
            for p, got in enumerate(rows_by_pos):
                vbuf[p * cap:p * cap + got] = True
        t1 = time.perf_counter()
        acc, dev = self.accountant, self.device
        # on the producer's CUDA stream (the caller's context): the
        # event pair times the copies there
        with trace_span("stream.transfer") as sp, device_timeline(sp, dev):
            arrays = {c: acc.place(t, dev, "stream")
                      for c, t in host_arrays.items()}
            nulls = {c: acc.place(t, dev, "stream")
                     for c, t in host_nulls.items()}
            valid = acc.place(vt, dev, "stream")
        if self.stats is not None:
            self.stats.add(stream_decode_seconds=t1 - t0,
                           stream_transfer_seconds=time.perf_counter() - t1)
        if self.n_pos > 1:
            # position i's batch is row i of the plane
            def plane(t):
                return t.view(self.n_pos, cap)

            arrays = {c: plane(t) for c, t in arrays.items()}
            nulls = {c: plane(t) for c, t in nulls.items()}
            valid = plane(valid)
        return FeedSpec(node=node, sharded=True, arrays=arrays, nulls=nulls,
                        valid=valid, capacity=cap, dev_rows=rows_by_pos)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


# ---------------------------------------------------------------------------
# host merge

def _flatten_batch(cols, nulls):
    """One batch's (or pass's) rows as a part: copies, since they are
    views into the staging that the next fetch overwrites, and a NULL
    mask for every column."""
    fc, fn = {}, {}
    for cid, a in cols.items():
        fc[cid] = a.copy()
        fn[cid] = (nulls[cid].copy() if cid in nulls
                   else np.zeros(len(a), dtype=bool))
    return fc, fn


_BIG = {"min": lambda dt: (np.inf if np.issubdtype(dt, np.floating)
                           else np.iinfo(dt).max),
        "max": lambda dt: (-np.inf if np.issubdtype(dt, np.floating)
                           else np.iinfo(dt).min)}


def merge_aggregate_parts(node: AggregateNode, parts):
    """Re-aggregate per-batch group rows host-side (the coordinator
    combine over per-batch partials — the split the reference's logical
    optimizer plans, planner/multi_logical_optimizer.c:1419)."""
    cids = ([cid for _g, cid in node.group_keys]
            + [cid for _a, cid in node.aggs])
    cat, catn = {}, {}
    for cid in cids:
        cat[cid] = np.concatenate([p[0][cid] for p in parts])
        catn[cid] = np.concatenate([p[1][cid] for p in parts])
    n = len(next(iter(cat.values()))) if cids else 0
    if n == 0:
        return cat, catn  # typed empties straight through

    key_cols = []
    for _g, cid in node.group_keys:
        v = cat[cid]
        if np.issubdtype(v.dtype, np.floating):
            v = (v.astype(np.float32).view(np.int32)
                 if v.dtype == np.float32 else v.view(np.int64))
        nm = catn[cid]
        key_cols.append(np.where(nm, 0, v.astype(np.int64)))
        key_cols.append(nm.astype(np.int64))
    if key_cols:
        mat = np.stack(key_cols, axis=1)
        _, first, inv = np.unique(mat, axis=0, return_index=True,
                                  return_inverse=True)
        inv = inv.reshape(-1)
        m = len(first)
    else:
        first = np.zeros(1, dtype=np.int64)
        inv = np.zeros(n, dtype=np.int64)
        m = 1

    out_c, out_n = {}, {}
    for _g, cid in node.group_keys:
        out_c[cid] = cat[cid][first]
        out_n[cid] = catn[cid][first]
    for a, cid in node.aggs:
        v, nm = cat[cid], catn[cid]
        if a.kind in ("count", "count_star"):
            acc = np.zeros(m, dtype=v.dtype)
            np.add.at(acc, inv, v)
            out_c[cid] = acc
            out_n[cid] = np.zeros(m, dtype=bool)
            continue
        contrib = ~nm
        if a.kind == "sum":
            acc = np.zeros(m, dtype=v.dtype)
            np.add.at(acc, inv[contrib], v[contrib])
        elif a.kind == "min":
            acc = np.full(m, _BIG["min"](v.dtype), dtype=v.dtype)
            np.minimum.at(acc, inv[contrib], v[contrib])
        else:  # max
            acc = np.full(m, _BIG["max"](v.dtype), dtype=v.dtype)
            np.maximum.at(acc, inv[contrib], v[contrib])
        cnt = np.zeros(m, dtype=np.int64)
        np.add.at(cnt, inv, contrib.astype(np.int64))
        out_c[cid] = acc
        out_n[cid] = cnt == 0
    return out_c, out_n


def merge_parts(plan: QueryPlan, parts):
    """Per-batch (or per-pass) flattened parts → (cols, nulls, n): a
    mergeable aggregate root re-aggregates, row outputs concatenate."""
    if isinstance(plan.root, AggregateNode):
        merged_c, merged_n = merge_aggregate_parts(plan.root, parts)
    else:
        merged_c = {cid: np.concatenate([p[0][cid] for p in parts])
                    for cid in parts[0][0]} if parts else {}
        merged_n = {cid: np.concatenate([p[1][cid] for p in parts])
                    for cid in parts[0][1]} if parts else {}
    n = len(next(iter(merged_c.values()))) if merged_c else 0
    return merged_c, merged_n, n


# ---------------------------------------------------------------------------
# execution

class _BatchProducer:
    """The prefetch thread: builds batch i+1 (host decode, pinned
    staging, the copy on its own CUDA stream) while the statement's
    thread runs batch i.  `slots` bounds the batches placed at once to
    depth + 1; `stop_evt` lets a failing consumer unblock it."""

    def __init__(self, batcher: StreamBatcher, depth: int):
        self.batcher = batcher
        # the statement's trace context, adopted by the thread
        self.trace_ctx = capture_context()
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.slots = threading.Semaphore(depth + 1)
        self.stop_evt = threading.Event()
        self.side = None  # the producer's CUDA stream
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="citus-stream-producer")

    def _wait(self, fn) -> bool:
        """Retry a bounded blocking call until it succeeds or the
        consumer stops the stream."""
        while not self.stop_evt.is_set():
            if fn():
                return True
        return False

    def _put(self, item) -> bool:
        def attempt():
            try:
                self.q.put(item, timeout=0.2)
                return True
            except queue.Full:
                return False

        return self._wait(attempt)

    def _run(self):
        # stream.decode / stream.transfer land in the statement's trace
        # (leak-proof: adopt_context force-closes anything left open)
        with adopt_context(self.trace_ctx):
            self._produce()

    def _produce(self):
        b = self.batcher
        try:
            if b.cuda:
                torch.cuda.set_device(b.device)
                self.side = torch.cuda.Stream(device=b.device)
            i = 0
            while not self.stop_evt.is_set():
                # named seam: a producer death mid-stream must surface
                # as the statement's error, never a hang or a partial
                # result
                fault_point("stream.prefetch")
                if not self._wait(lambda: self.slots.acquire(timeout=0.2)):
                    return
                if self.side is not None:
                    with torch.cuda.stream(self.side):
                        feed = b.feed(i)
                    event = self.side.record_event()
                else:
                    feed, event = b.feed(i), None
                if feed is None:
                    self.slots.release()
                    break
                if not self._put(("ok", (feed, event))):
                    return
                del feed
                i += 1
            self._put(("done", None))
        except BaseException as e:  # noqa: BLE001  # graftlint: ignore[swallowed-base-exception] — not swallowed: forwarded over the queue and re-raised on the consumer thread
            # finished frames may hold a placed batch: clear them so its
            # charge releases now
            traceback.clear_frames(e.__traceback__)
            self._put(("err", e))

    def drain(self) -> None:
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                return

    def stop(self) -> None:
        """Stop and join the thread, dropping every queued batch."""
        self.stop_evt.set()
        self.drain()  # a blocked put wakes immediately
        self.thread.join()
        self.drain()


def _adopt(payload, device) -> FeedSpec:
    """Wait on a produced batch's copy event and mark its tensors used
    by the statement's stream, so the allocator does not reuse their
    memory while a kernel still reads them."""
    feed, event = payload
    if event is not None:
        cur = torch.cuda.current_stream(device)
        cur.wait_event(event)
        for t in (list(feed.arrays.values()) + list(feed.nulls.values())
                  + [feed.valid]):
            t.record_stream(cur)
    return feed


def partial_plan(plan: QueryPlan) -> QueryPlan:
    """`plan` as one stream batch or multi-pass pass runs it: without
    device top-k when its root aggregates and some ORDER BY key is not a
    group key (a partial aggregate's top k can drop a group whose total
    is in the global top k).  Row outputs, and aggregates ordered by
    group keys only, keep the pushdown: a key in the global top k is in
    the top k of every part that holds it."""
    if plan.device_topk is None or not isinstance(plan.root, AggregateNode):
        return plan
    group_cids = {cid for _e, cid in plan.root.group_keys}
    for e, _desc, _nf in plan.host_order_by:
        for n in ir.walk(e):
            if isinstance(n, ir.BCol) and n.cid not in group_cids:
                return dc_replace(plan, device_topk=None)
    return plan


def try_execute_streamed(executor, plan: QueryPlan, raw: bool,
                         return_parts: bool = False,
                         no_cache_nodes=frozenset()):
    """Streamed execution when the plan's feeds exceed the device
    budget; None ⇒ the caller proceeds on the resident-feed path.

    `return_parts=True` (multi-pass execution's mode) skips the final
    host combine and returns (parts, rows_scanned, retries, batches,
    caps) — flattened per-batch column/null dicts the caller merges
    across its own passes before ONE host combine."""
    settings = executor.settings
    budget = settings.get("max_feed_bytes_per_device")
    if budget <= 0:
        return None
    mesh = executor._mesh_for(plan)
    if mesh is not None and not mesh.single_device():
        return None  # per-card batches: not streamed (resident path)
    n_dev = plan.n_devices
    # the accountant may know a real ceiling below the configured one
    # (an armed MemSim, hbm_budget_bytes, the card's memory): size the
    # stream against it up front instead of discovering it by an OOM.
    # Positions sharing the card split its budget evenly.
    hw = executor.accountant.budget_bytes(executor.device, settings)
    if hw:
        budget = min(budget, hw // n_dev)
    compute_dtype = np.dtype(settings.get("compute_dtype"))
    oom = executor.oom
    depth = settings.get("scan_prefetch_depth")
    picked = pick_stream_node(plan, executor.catalog, executor.store,
                              compute_dtype, budget,
                              settings.get("stream_batch_rows"),
                              shrink=oom.batch_shrink,
                              force=oom.force_stream,
                              prefetch_depth=depth, n_dev=n_dev)
    if picked is None:
        return None
    stream_node, batch_cap = picked
    # downstream buffers size per batch, not per table
    total_rows = (sum(
        executor.store.shard_row_count(stream_node.rel.table, s.shard_id)
        for s in executor.catalog.table_shards(stream_node.rel.table))
        if n_dev == 1 else _scan_dev_rows(stream_node, executor.catalog,
                                          executor.store, n_dev))
    _scale_path_estimates(plan, id(stream_node),
                          min(1.0, batch_cap / max(1, total_rows)))
    batcher = StreamBatcher(stream_node, executor.catalog, executor.store,
                            executor.device, compute_dtype, batch_cap,
                            executor.accountant, executor.scan_stats,
                            n_pos=n_dev)

    feeds: dict[int, FeedSpec] = {}
    with trace_span("feed"):
        for node in walk_plan(plan.root):
            if isinstance(node, ScanNode) and node is not stream_node:
                cache = (None if id(node) in no_cache_nodes
                         else executor.feed_cache)
                feeds[id(node)] = _feed_scan_cached(
                    node, executor.catalog, executor.store,
                    executor.device, plan.n_devices, compute_dtype, cache,
                    executor.accountant, executor.scan_stats,
                    executor.counters, mesh)
    rows_in = list(batcher.rows_by_pos)
    for f in feeds.values():
        for p, r in enumerate(f.dev_rows or ()):
            rows_in[p] += r

    # the plan each batch runs; the host combine below keeps `plan`
    # (its sort and limit give the answer after the merge)
    batch_plan = partial_plan(plan)
    producer = _BatchProducer(batcher, depth)
    producer.thread.start()
    topk_sig = (batch_plan.device_topk, tuple(
        (repr(e), d, nf) for e, d, nf in plan.host_order_by)
        if batch_plan.device_topk is not None else ())
    caps = fingerprint = None
    parts = []
    rows_scanned = retries_total = n_consumed = 0
    sid = id(stream_node)
    try:
        while True:
            # batch boundaries are the stream's cancellation seams: a
            # statement_timeout_ms deadline or Session.cancel() stops
            # between batches; the bounded get keeps the deadline live
            # even when the producer is wedged
            check_cancel()
            try:
                kind, payload = producer.q.get(timeout=0.25)
            except queue.Empty:
                continue
            if kind == "err":
                raise payload
            if kind == "done":
                break
            n_consumed += 1
            feeds[sid] = _adopt(payload, executor.device)
            del payload
            if caps is None:
                # one PlanCompiler and one capacity set for every batch
                # (all share batch_cap): the memo keys on the plan's
                # fingerprint plus the batch shape
                fingerprint = ("stream", batch_cap,
                               node_fingerprint(plan.root), plan.n_devices,
                               str(compute_dtype),
                               feeds_signature(plan, feeds), topk_sig,
                               str(executor.device))
                if n_dev > 1:
                    fingerprint = fingerprint + (tuple(mesh.ids),)
                with executor._caps_lock:
                    memo = executor._caps_memo.get(fingerprint)
                caps = (executor._caps_from_order(plan, memo)
                        if memo is not None
                        else executor._initial_capacities(plan, feeds))
            # no feedback tightening mid-stream: per-batch actuals vary,
            # and tightening on batch 1 would risk an overflow-regrow
            # cycle on a later, fuller batch.  An overflow grows the
            # capacities once, for every later batch.
            with trace_span("stream.batch", batch=n_consumed - 1):
                out, out_meta, caps, r = executor.run_with_retry(
                    batch_plan, feeds, caps, fingerprint, compute_dtype,
                    allow_tighten=False, allow_graph=False)
                del feeds[sid]
                producer.slots.release()
                retries_total += r
                cols, nulls = unpack_outputs(out, out_meta)
                rows_scanned += out.slots
                parts.append(_flatten_batch(cols, nulls))
    finally:
        feeds.pop(sid, None)
        producer.stop()

    if return_parts:
        return parts, rows_scanned, retries_total, n_consumed, caps
    with trace_span("combine"):
        t0 = time.perf_counter()
        cols, nulls, n = merge_parts(plan, parts)
        executor.scan_stats.add(
            stream_merge_seconds=time.perf_counter() - t0)
        result = executor._host_combine(plan, cols, nulls, None, raw,
                                        device_rows=[n])
    result.retries = retries_total
    result.device_rows_scanned = rows_scanned
    result.streamed_batches = n_consumed
    result.device_rows_in = rows_in
    if executor.counters is not None:
        executor.counters.increment(sc.QUERIES_STREAMED)
    if caps is not None:
        # once per statement, after the batch loop
        executor.count_groupby_bucketed(plan, caps)
    return result


def _scale_path_estimates(plan: QueryPlan, stream_id: int,
                          frac: float) -> None:
    """Scale est_rows along root → stream scan (the output cardinality of
    every node containing the streamed batch scales with its share)."""

    def rec(node: PlanNode) -> bool:
        here = id(node) == stream_id
        kids = []
        if isinstance(node, JoinNode):
            kids = [node.left, node.right]
        elif isinstance(node, (AggregateNode, ProjectNode, WindowNode)):
            kids = [node.input]
        on_path = here or any(rec(k) for k in kids)
        if on_path and getattr(node, "est_rows", None):
            node.est_rows = max(1, int(node.est_rows * frac))
        return on_path

    rec(plan.root)
