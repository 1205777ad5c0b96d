"""Execution loop: capacities, overflow retry, host combine.

Counterpart of citus_tpu/executor/runner.py.  Builds the feeds, sizes
every static buffer (`_initial_capacities`), runs the plan through a
cached PlanCompiler, retries with grown capacities when a stage
overflowed (or on the general paths when statistics proved stale),
tightens over-sized buffers once from the recorded stage actuals
(`_tighten_caps`), and finishes on the host: HAVING, the select list,
dictionary decode, ORDER BY, OFFSET/LIMIT (`_host_combine`).  Raw mode
(`execute_plan(plan, raw=True)`, INSERT..SELECT's source) keeps the
result typed: a NULL mask per column, dictionary codes, day numbers.

A plan the fast-path router takes (executor/fastpath.py: one shard,
below fast_path_max_rows) answers host-side instead, as in the
reference.

Converged capacities are memoized in memory per plan fingerprint; the
JAX package's on-disk memo, executable cache, streaming, multi-pass and
OOM ladder are not part of the port yet.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from ..catalog import Catalog
from ..config import Settings
from ..errors import CapacityOverflowError, ExecutionError, PlanningError
from ..planner import expr as ir
from ..planner.plan import (
    AggregateNode,
    JoinNode,
    ProjectNode,
    QueryPlan,
    ScanNode,
    WindowNode,
)
from ..storage import TableStore
from ..storage.dictionary import resolve_decode
from ..types import DataType
from .cache import (
    FeedCache,
    PlanCache,
    caps_signature,
    feeds_signature,
    node_fingerprint,
    plan_order,
)
from .compiler import Capacities, PlanCompiler, _round_cap, unpack_outputs
from .fastpath import try_execute_fast_path
from .feed import build_feeds, walk_plan
from .hbm import accountant_for
from .host_exprs import ColumnSource, evaluate, predicate_mask
from .scanpipe import ScanPhaseStats

MAX_RETRIES = 4


@dataclass
class ResultSet:
    column_names: list[str]
    columns: dict[str, np.ndarray | list]
    row_count: int
    # output SQL types by column name
    dtypes: dict[str, DataType] | None = None
    retries: int = 0
    # result-transfer volume in row slots
    device_rows_scanned: int = 0
    device_rows_in: list[int] | None = None
    # answered host-side by the fast-path router (executor/fastpath.py)
    fast_path: bool = False
    # raw mode (execute_plan(raw=True), INSERT..SELECT): per-column NULL
    # masks, STRING columns as dictionary codes with their source
    # dictionary (table, column), DATE columns as day numbers
    null_masks: dict[str, np.ndarray] | None = None
    decode_map: dict[str, tuple[str, str]] | None = None

    def rows(self) -> list[tuple]:
        cols = [self.columns[n] for n in self.column_names]
        return [tuple(c[i] for c in cols) for i in range(self.row_count)]

    def __len__(self):
        return self.row_count


class Executor:
    def __init__(self, catalog: Catalog, store: TableStore,
                 settings: Settings, device):
        self.catalog = catalog
        self.store = store
        self.settings = settings
        self.device = device
        self.plan_cache = PlanCache(settings.get("max_cached_plans"))
        self.feed_cache = FeedCache(settings.get("max_cached_feed_bytes"))
        # the data_dir's device-memory ledger (shared by every session on
        # it) and this executor's pipelined-scan phase walls
        self.accountant = accountant_for(store.data_dir)
        self.scan_stats = ScanPhaseStats()
        # fingerprint → walk-index-keyed converged capacities
        self._caps_memo: dict = {}
        # fingerprints already tightened by feedback (at most once each)
        self._tightened_fps: set = set()
        self._caps_lock = threading.Lock()
        # scans the fast path answered through the point index
        self.point_index_lookups = 0

    # ------------------------------------------------------------------
    def execute_plan(self, plan: QueryPlan, raw: bool = False) -> ResultSet:
        for node in walk_plan(plan.root):
            if isinstance(node, ScanNode):
                self.store.refresh_if_stale(node.rel.table)
        # the reference's single-shard router: below fast_path_max_rows
        # a pruned plan answers host-side by design (on the card too)
        fast = try_execute_fast_path(self, plan, raw)
        if fast is not None:
            return fast
        compute_dtype = np.dtype(self.settings.get("compute_dtype"))
        feeds = build_feeds(plan, self.catalog, self.store, self.device,
                            compute_dtype, self.feed_cache, self.accountant,
                            self.scan_stats)
        topk_sig = (plan.device_topk, tuple(
            (repr(e), d, nf) for e, d, nf in plan.host_order_by)
            if plan.device_topk is not None else ())
        # a prepared SELECT's $n render as BParam(idx, dtype) in the
        # expression reprs, never with their values: every EXECUTE of
        # one shape shares its PlanCompiler and caps memo entry
        fingerprint = (node_fingerprint(plan.root), plan.n_devices,
                       str(compute_dtype), feeds_signature(plan, feeds),
                       topk_sig, str(self.device))
        with self._caps_lock:
            memo = self._caps_memo.get(fingerprint)
        caps = (self._caps_from_order(plan, memo) if memo is not None
                else self._initial_capacities(plan, feeds))
        packed, out_meta, caps, retries = self.run_with_retry(
            plan, feeds, caps, fingerprint, compute_dtype)
        cols, nulls, valid = unpack_outputs(packed, out_meta)
        result = self._host_combine(plan, cols, nulls, valid, raw)
        result.retries = retries
        result.device_rows_scanned = int(np.asarray(valid).size)
        rows_in = [sum(f.dev_rows[0] for f in feeds.values()
                       if f.dev_rows is not None)]
        result.device_rows_in = rows_in if any(
            f.dev_rows is not None for f in feeds.values()) else None
        return result

    # ------------------------------------------------------------------
    def run_with_retry(self, plan: QueryPlan, feeds, caps: Capacities,
                       fingerprint, compute_dtype, allow_tighten=True):
        """Run (with a cached PlanCompiler) + overflow-retry loop.
        Returns (packed, out_meta, converged_caps, retries).

        Capacity feedback: a clean execution whose recorded stage actuals
        sit far below their buffers tightens the capacities to
        actual×slack, re-executes once and memoizes; an over-tightened
        buffer simply overflows and regrows through the retry path."""
        limit = self.settings.get("max_plan_buffer_bytes")
        retries = 0
        tightened = False
        while True:
            if limit:
                est = _plan_buffer_bytes(plan, caps)
                if est > limit:
                    raise PlanningError(
                        f"plan needs ~{est / 1e9:.1f} GB of device "
                        f"buffers (max_plan_buffer_bytes = "
                        f"{limit / 1e9:.1f} GB) — usually a cartesian "
                        "or extreme-fanout join; rewrite the query or "
                        "raise the limit")
            key = fingerprint + (caps_signature(plan, caps),)
            compiler = self.plan_cache.get(key)
            if compiler is None:
                compiler = PlanCompiler(plan, compute_dtype, self.device)
                self.plan_cache.put(key, compiler)
            packed, counters, out_meta, stage_keys = compiler.run(
                plan, feeds, caps)
            cap_overflow = int(counters[0])
            dense_oob = int(counters[1])
            if cap_overflow == 0 and dense_oob == 0:
                first_tighten = False
                if allow_tighten and not tightened and \
                        self.settings.get("enable_capacity_feedback"):
                    with self._caps_lock:
                        if fingerprint not in self._tightened_fps:
                            if len(self._tightened_fps) > 512:
                                self._tightened_fps.clear()
                            self._tightened_fps.add(fingerprint)
                            first_tighten = True
                if first_tighten:
                    tight = self._tighten_caps(plan, caps, stage_keys,
                                               counters[2:])
                    if tight is not None:
                        caps = tight
                        tightened = True
                        self._memoize_caps(fingerprint, plan, caps)
                        continue  # re-execute at the tight sizes
                if retries or tightened:
                    self._memoize_caps(fingerprint, plan, caps)
                return packed, out_meta, caps, retries
            retries += 1
            if retries >= MAX_RETRIES:
                raise CapacityOverflowError(
                    f"buffer overflow persisted after {retries} retries "
                    f"({cap_overflow + dense_oob} rows dropped)",
                    cap_overflow + dense_oob, 0)
            if dense_oob:
                # statistics-planned dense structures saw out-of-range
                # keys: re-run on the general paths, keeping any growth
                fresh = self._initial_capacities(plan, feeds,
                                                 dense_off=True)
                caps = Capacities(
                    {k: max(v, caps.repartition.get(k, 0))
                     for k, v in fresh.repartition.items()},
                    {k: max(v, caps.join_out.get(k, 0))
                     for k, v in fresh.join_out.items()},
                    {k: max(v, caps.agg_out.get(k, 0))
                     for k, v in fresh.agg_out.items()},
                    dense_off=True,
                    scan_out={k: max(v, caps.scan_out.get(k, 0))
                              for k, v in fresh.scan_out.items()},
                    bucket_probe={k: max(v, caps.bucket_probe.get(k, 0))
                                  for k, v in fresh.bucket_probe.items()},
                    agg_bucket={k: max(v, caps.agg_bucket.get(k, 0))
                                for k, v in fresh.agg_bucket.items()})
            if cap_overflow:
                caps = caps.grown(cap_overflow)

    # ------------------------------------------------------------------
    def _memoize_caps(self, fingerprint, plan: QueryPlan,
                      caps: Capacities) -> None:
        with self._caps_lock:
            if len(self._caps_memo) >= 512:
                for k in list(self._caps_memo)[:256]:
                    del self._caps_memo[k]
            self._caps_memo.pop(fingerprint, None)
            self._caps_memo[fingerprint] = self._caps_to_order(plan, caps)

    # feedback sizing (the JAX package's thresholds): pure buffer sizes
    # tighten at 0.85; stages whose tightening installs a compaction pass
    # must shrink ≥3× to pay for it
    TIGHTEN_SLACK = 1.3
    TIGHTEN_THRESHOLD = {"repartition": 0.85, "agg_out": 0.85,
                         "bucket_probe": 0.85, "agg_bucket": 0.85,
                         "scan_out": 1.0 / 3.0, "join_out": 1.0 / 3.0,
                         "agg_grid": 1.0 / 3.0}

    def _tighten_caps(self, plan: QueryPlan, caps: Capacities,
                      stage_keys, actuals) -> Capacities | None:
        """Shrink buffers whose recorded actual row counts sit far below
        their current size; None when nothing material changed."""
        rev = {i: nid for nid, i in plan_order(plan).items()}
        new = {"repartition": dict(caps.repartition),
               "join_out": dict(caps.join_out),
               "agg_out": dict(caps.agg_out),
               "scan_out": dict(caps.scan_out),
               "bucket_probe": dict(caps.bucket_probe),
               "agg_bucket": dict(caps.agg_bucket)}
        changed = False
        for (widx, kind, width), actual in zip(stage_keys, actuals):
            nid = rev.get(widx)
            if nid is None:
                continue
            table = new["agg_out" if kind == "agg_grid" else kind]
            cur = table.get(nid, width)
            t = _round_cap(int(int(actual) * self.TIGHTEN_SLACK) + 128)
            if t < cur * self.TIGHTEN_THRESHOLD[kind]:
                table[nid] = t
                changed = True
        if not changed:
            return None
        return Capacities(new["repartition"], new["join_out"],
                          new["agg_out"], caps.dense_off,
                          new["scan_out"], caps.output_repart,
                          new["bucket_probe"], new["agg_bucket"])

    @staticmethod
    def _caps_to_order(plan: QueryPlan, caps: Capacities) -> tuple:
        """id(node)-keyed Capacities → plan-walk-index-keyed tuple."""
        order = plan_order(plan)
        return ({order[k]: v for k, v in caps.repartition.items()},
                {order[k]: v for k, v in caps.join_out.items()},
                {order[k]: v for k, v in caps.agg_out.items()},
                caps.dense_off,
                {order[k]: v for k, v in caps.scan_out.items()},
                caps.output_repart,
                {order[k]: v for k, v in caps.bucket_probe.items()},
                {order[k]: v for k, v in caps.agg_bucket.items()})

    @staticmethod
    def _caps_from_order(plan: QueryPlan, memo: tuple) -> Capacities:
        rev = {i: nid for nid, i in plan_order(plan).items()}
        return Capacities({rev[i]: v for i, v in memo[0].items()},
                          {rev[i]: v for i, v in memo[1].items()},
                          {rev[i]: v for i, v in memo[2].items()},
                          memo[3],
                          {rev[i]: v for i, v in memo[4].items()},
                          memo[5],
                          {rev[i]: v for i, v in memo[6].items()},
                          {rev[i]: v for i, v in memo[7].items()})

    def _initial_capacities(self, plan: QueryPlan, feeds,
                            dense_off: bool = False) -> Capacities:
        """Propagate static capacities bottom-up (the JAX package's
        rules, on one device: no repartition buffers)."""
        join_factor = self.settings.get("join_output_capacity_factor")
        group_factor = self.settings.get("agg_group_capacity_factor")
        bucket_factor = self.settings.get("join_probe_bucket_factor")
        agg_bucket_factor = self.settings.get("agg_bucket_capacity_factor")
        n_dev = plan.n_devices
        join_out: dict[int, int] = {}
        agg_out: dict[int, int] = {}
        scan_out: dict[int, int] = {}
        bucket_probe: dict[int, int] = {}
        agg_bucket: dict[int, int] = {}

        def cap_of(node, skip_emit: bool = False) -> int:
            if isinstance(node, ScanNode):
                base = feeds[id(node)].capacity
                if node.filter is None:
                    return base
                # selective scans compact survivors (only a ≥3× shrink
                # pays for the compaction pass)
                est = max(1, node.est_rows)
                per_dev = (est if not feeds[id(node)].sharded
                           else -(-est // n_dev))
                k = _round_cap(int(per_dev * 1.5) + 512)
                if k * 3 < base:
                    scan_out[id(node)] = k
                    return k
                return base
            if isinstance(node, ProjectNode):
                return cap_of(node.input)
            if isinstance(node, JoinNode):
                # on one device every repartition is the identity: each
                # side keeps its own capacity and no shuffle buffer exists
                lcap = cap_of(node.left)
                rcap = cap_of(node.right)
                if node.join_type in ("semi", "anti"):
                    # the output rows are probe rows; only a cross-side
                    # residual needs a candidate-pair buffer
                    if node.residual is not None:
                        join_out[id(node)] = _round_cap(int(
                            lcap * join_factor
                            * max(1.0, node.est_expansion)) + 128)
                    return lcap
                if skip_emit:
                    return max(lcap, rcap)
                if getattr(node, "fuse_lookup", False) and not dense_off \
                        and node.left_keys:
                    out = (rcap if node.join_type == "inner"
                           and node.build_side == "left" else lcap)
                    if getattr(node, "probe_bucketed", False):
                        ext = (node.left_key_extents
                               if node.build_side == "left"
                               else node.right_key_extents)
                        if ext and ext[0] is not None:
                            from ..ops.join import probe_bucket_count

                            nb = probe_bucket_count(int(ext[0][1]))
                            bucket_probe[id(node)] = _round_cap(
                                int(out / nb * bucket_factor))
                    if node.join_type == "inner" and node.residual is None:
                        est = max(1, node.est_rows)
                        k = _round_cap(int(-(-est // n_dev) * 1.5) + 512)
                        if k * 3 < out:
                            out = k
                    join_out[id(node)] = out
                    return out
                if not node.left_keys:
                    out = _round_cap(lcap * rcap)
                else:
                    out = _round_cap(int(
                        lcap * join_factor
                        * max(1.0, node.est_expansion)) + 128)
                    if node.join_type in ("left", "full"):
                        out = _round_cap(out + lcap)
                join_out[id(node)] = out
                if node.join_type in ("right", "full"):
                    out = out + rcap
                return out
            if isinstance(node, WindowNode):
                return cap_of(node.input)
            if isinstance(node, AggregateNode):
                if node.combine == "global" and \
                        isinstance(node.input, JoinNode) and \
                        PlanCompiler.agg_pushdown_shape(node):
                    cap_of(node.input, skip_emit=True)
                    return 1
                in_cap = cap_of(node.input)
                if node.combine == "global":
                    return 1
                if node.dense_keys is not None and not dense_off and \
                        node.combine in ("local", "repartition"):
                    return node.dense_total
                if PlanCompiler.agg_bucket_shape(node, dense_off):
                    from ..ops.groupby import group_bucket_count

                    nb = group_bucket_count(node.bucket_total)
                    agg_bucket[id(node)] = _round_cap(
                        int(-(-in_cap // nb) * agg_bucket_factor) + 128)
                    out = node.bucket_total
                    est_g = node.est_groups
                    if est_g:
                        k = _round_cap(
                            min(out, int(est_g * group_factor) + 16))
                        if k * 3 < out:
                            agg_out[id(node)] = k
                            out = k
                    return out
                est_g = node.est_groups
                if est_g:
                    agg_cap = _round_cap(
                        min(in_cap, int(est_g * group_factor) + 16))
                    agg_out[id(node)] = agg_cap
                    return agg_cap
                return in_cap
            raise ExecutionError(f"unknown node {type(node).__name__}")

        cap_of(plan.root)
        return Capacities({}, join_out, agg_out, dense_off, scan_out,
                          None, bucket_probe, agg_bucket)

    # ------------------------------------------------------------------
    def _host_combine(self, plan: QueryPlan, cols, nulls, valid,
                      raw: bool = False) -> ResultSet:
        valid_np = np.asarray(valid).reshape(-1)
        flat_cols: dict[str, np.ndarray] = {}
        flat_nulls: dict[str, np.ndarray] = {}
        for cid in cols:
            flat_cols[cid] = np.asarray(cols[cid]).reshape(-1)[valid_np]
            flat_nulls[cid] = np.asarray(nulls[cid]).reshape(-1)[valid_np]
        src = ColumnSource(flat_cols, flat_nulls)
        n = int(valid_np.sum())

        if plan.host_having is not None:
            mask = np.broadcast_to(np.asarray(
                predicate_mask(plan.host_having, src, np)), (n,))
            flat_cols = {c: a[mask] for c, a in flat_cols.items()}
            flat_nulls = {c: a[mask] for c, a in flat_nulls.items()}
            src = ColumnSource(flat_cols, flat_nulls)
            n = int(mask.sum())

        out_cols: dict[str, object] = {}
        out_nulls: dict[str, np.ndarray] = {}
        out_dtypes: dict[str, DataType] = {}
        decode_map: dict[str, tuple[str, str]] = {}
        names: list[str] = []
        for e, name in plan.host_select:
            v, nmask = evaluate(e, src, np)
            v = np.broadcast_to(np.asarray(v), (n,)).copy()
            nmask = (np.zeros(n, dtype=bool) if nmask is None
                     else np.broadcast_to(np.asarray(nmask), (n,)).copy())
            out_name = _unique_name(name, names)
            names.append(out_name)
            out_cols[out_name] = v
            out_nulls[out_name] = nmask
            out_dtypes[out_name] = e.dtype
            # raw mode keeps codes / day numbers typed so bulk consumers
            # (INSERT..SELECT) skip the decode → re-encode round trip
            if raw:
                if isinstance(e, ir.BCol) and e.cid in plan.decode:
                    decode_map[out_name] = plan.decode[e.cid]
            elif isinstance(e, ir.BCol) and e.cid in plan.decode:
                d = resolve_decode(self.store, plan.decode[e.cid])
                out_cols[out_name] = _decode_strings(d, v, nmask)
            elif e.dtype == DataType.DATE:
                out_cols[out_name] = _format_dates(v, nmask)

        # ORDER BY (host): exact multi-key sort via factorize + lexsort;
        # NULL placement follows PG defaults
        if plan.host_order_by and n > 0:
            order_src = ColumnSource(flat_cols, flat_nulls)
            lex_keys = []
            for e, desc, nulls_first in plan.host_order_by:
                v, nmask = evaluate(e, order_src, np)
                v = np.broadcast_to(np.asarray(v), (n,))
                nmask = (np.zeros(n, dtype=bool) if nmask is None
                         else np.broadcast_to(np.asarray(nmask), (n,)))
                if isinstance(e, ir.BCol) and e.cid in plan.decode:
                    d = resolve_decode(self.store, plan.decode[e.cid])
                    lut = np.asarray(d.values + [""], dtype=object)
                    codes = np.asarray(v).astype(np.int64)
                    oob = (codes < 0) | (codes >= len(d))
                    v = lut[np.where(oob, len(d), codes)].astype(str)
                _, codes = np.unique(v, return_inverse=True)
                codes = codes.astype(np.int64)
                if desc:
                    codes = -codes
                nulls_last = (not nulls_first if nulls_first is not None
                              else not desc)
                null_key = nmask if nulls_last else ~nmask
                lex_keys.append(null_key.astype(np.int8))
                lex_keys.append(codes)
            order = np.lexsort(tuple(reversed(lex_keys)))
            for c in names:
                out_cols[c] = out_cols[c][order]
                out_nulls[c] = out_nulls[c][order]
        lo = plan.offset or 0
        hi = n if plan.limit is None else min(n, lo + plan.limit)
        if lo or hi < n:
            for c in names:
                out_cols[c] = out_cols[c][lo:hi]
                out_nulls[c] = out_nulls[c][lo:hi]
        final_n = max(0, hi - lo)
        if raw:
            return ResultSet(names, out_cols, final_n, dtypes=out_dtypes,
                             null_masks=out_nulls, decode_map=decode_map)
        # surface NULLs as None in object columns
        for c in names:
            if out_nulls[c].any():
                col = np.asarray(out_cols[c], dtype=object)
                col[out_nulls[c]] = None
                out_cols[c] = col
        return ResultSet(names, out_cols, final_n, dtypes=out_dtypes)


def _unique_name(name: str, taken: list[str]) -> str:
    if name not in taken:
        return name
    i = 1
    while f"{name}_{i}" in taken:
        i += 1
    return f"{name}_{i}"


def _plan_buffer_bytes(plan: QueryPlan, caps: Capacities) -> int:
    """Worst single-buffer estimate for a capacity assignment (the JAX
    package's guard): each join/aggregate/compaction buffer holds its
    node's output columns at the static capacity; the bucketed packs
    are the buffers that can explode under skew."""
    nodes = {id(n): n for n in walk_plan(plan.root)}
    worst = 0
    for table in (caps.join_out, caps.agg_out, caps.scan_out):
        for nid, cap in table.items():
            node = nodes.get(nid)
            ncols = len(node.out_columns) if node is not None else 4
            worst = max(worst, cap * (ncols + 2) * 8)
    for nid, cap in caps.bucket_probe.items():
        node = nodes.get(nid)
        ext = (() if node is None else
               (node.left_key_extents if node.build_side == "left"
                else node.right_key_extents))
        if ext and ext[0] is not None:
            from ..ops.join import probe_bucket_count

            worst = max(worst,
                        cap * probe_bucket_count(int(ext[0][1])) * 3 * 8)
    for nid, cap in caps.agg_bucket.items():
        node = nodes.get(nid)
        total = getattr(node, "bucket_total", 0) if node is not None else 0
        if total:
            from ..ops.groupby import group_bucket_count

            ncols = len(node.out_columns)
            worst = max(worst,
                        cap * group_bucket_count(total) * (ncols + 2) * 8,
                        total * (ncols + 2) * 8)
    return worst


def _decode_strings(d, codes, nmask) -> np.ndarray:
    """Vectorized dictionary decode: codes → object array (None = NULL)."""
    lut = np.asarray(d.values + [None], dtype=object)
    codes = np.asarray(codes).astype(np.int64)
    codes = np.where(nmask | (codes < 0) | (codes >= len(d)), len(d), codes)
    return lut[codes]


def _format_dates(days, nmask) -> np.ndarray:
    """Vectorized day-number → ISO date string (None = NULL)."""
    days = np.asarray(days).astype("int64")
    iso = (days.astype("datetime64[D]")).astype(str).astype(object)
    iso[np.asarray(nmask)] = None
    return iso
