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

Dispatch order, as in the reference: a plan the fast-path router takes
(executor/fastpath.py: one shard, below fast_path_max_rows) answers
host-side; a statement the OOM ladder sent to multi-pass runs in passes
over shard groups (executor/multipass.py); a plan whose feeds exceed
the device budget streams its largest scan in batches
(executor/stream.py); everything else runs on resident feeds.

Device memory is governed: each PlanCompiler run leases its buffer
estimate from the data_dir's accountant (executor/hbm.py), a CUDA
allocator OOM inside the run is classified as DeviceMemoryExhausted, and
the session's retry envelope walks the degradation ladder
(`degrade_for_oom`: evict caches → shrink stream batches → force
streaming → multi-pass) before a clean ResourceExhausted.  An
over-limit plan (max_plan_buffer_bytes) or a capacity regrow that can no
longer fit the budget enters the same ladder when its shape can degrade.

Converged capacities are memoized per plan fingerprint and persisted in
`<data_dir>/caps_memo.json` (the JAX package's file, version and JSON
codec; each package's fingerprints have their own form, so neither ever
matches the other's entries), so a new session starts from the converged
sizes.  The compiled form (executor/graphs.py): a plan-cache key runs
eagerly until it settles (one clean run with nothing left to tighten);
its next run over the same feed keys captures its dispatch once as a
CUDA graph — single-flight across the data_dir's sessions
(executor/execcache.py's CompileGate) — and replayed.  A settled key
lands in the persisted cache (`<data_dir>/exec_cache/`) with its
converged capacities, so that a fresh process resolves it from disk and
captures at its first run; the warm-before-admit phase
(`warmup_from_cache`) arms the hottest entries before the workload
manager admits traffic.

A mesh session (distributed/mesh.py) runs each plan over its N
positions (`self.mesh`): the feeds are device-owned slices, capacities
are per position with the JAX package's repartition buffers
(`_initial_capacities`), the packed output is [n_out, N, cap] and
`ResultSet.device_rows` counts each position's output rows.  A mesh plan
runs eagerly (its MeshSim seams are host checks a replay would skip).
`adopt_mesh` narrows the executor to the survivors of a device loss.

Observability: the feed build, the host combine and (in PlanCompiler.run)
the device program's dispatch and fetch are trace spans; the session's
StatCounters (`counters`) count bucketed group-bys, the ladder's cache
evictions and batch shrinks, and the feed path's chunk skips.
"""

from __future__ import annotations

import threading
import traceback
from dataclasses import dataclass

import numpy as np
import torch

from ..catalog import Catalog
from ..config import Settings
from ..errors import (
    CapacityOverflowError,
    DeviceMemoryExhausted,
    ExecutionError,
    PlanningError,
)
from ..planner import expr as ir
from ..planner.plan import (
    AggregateNode,
    JoinNode,
    ProjectNode,
    QueryPlan,
    ScanNode,
    WindowNode,
)
from ..stats import counters as sc
from ..stats.tracing import trace_span
from ..storage import TableStore
from ..storage.dictionary import resolve_decode
from ..types import DataType
from ..utils.cancellation import check_cancel
from ..utils.faultinjection import fault_point
from .cache import (
    FeedCache,
    PlanCache,
    caps_signature,
    feeds_signature,
    node_fingerprint,
    plan_order,
)
from .compiler import Capacities, PlanCompiler, _round_cap, unpack_outputs
from .execcache import exec_cache_for, key_from_json, key_to_json
from .fastpath import try_execute_fast_path
from .feed import build_feeds, walk_plan
from .hbm import _TORCH_OOM, accountant_for
from .host_exprs import ColumnSource, evaluate, predicate_mask
from .scanpipe import ScanPhaseStats

MAX_RETRIES = 4

# degradation ladder bound: each batch-shrink rung halves the stream
# batch; beyond this the rung is spent and the ladder moves on
MAX_BATCH_SHRINK = 64


@dataclass
class OomState:
    """Sticky (per-executor) outcome of the OOM degradation ladder —
    kept so a statement that needed rungs does not re-discover them (and
    re-pay the OOM) on every execution.

    * ``batch_shrink`` — divisor applied to the stream batch_cap;
    * ``force_stream`` — stream even when the feeds fit the configured
      budget (an OOM proved the effective ceiling lower);
    * ``multipass_k`` — split the build side into K passes
      (executor/multipass.py)."""

    batch_shrink: int = 1
    force_stream: bool = False
    multipass_k: int = 1


@dataclass
class ResultSet:
    column_names: list[str]
    columns: dict[str, np.ndarray | list]
    row_count: int
    # output SQL types by column name
    dtypes: dict[str, DataType] | None = None
    retries: int = 0
    # the part of `retries` the session's retry envelope added (its
    # retries and OOM rungs); the rest are the executor's capacity
    # retries
    envelope_retries: int = 0
    # result-transfer volume in row slots
    device_rows_scanned: int = 0
    # rows each mesh position fed in, and (where the result keeps the
    # position-major order: no HAVING, ORDER BY or LIMIT) returned
    device_rows_in: list[int] | None = None
    device_rows: list[int] | None = None
    # answered host-side by the fast-path router (executor/fastpath.py)
    fast_path: bool = False
    streamed_batches: int = 0  # >0 ⇒ executed via the stream pipeline
    spill_passes: int = 0      # >0 ⇒ executed via multi-pass passes
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
                 settings: Settings, device, counters=None, mesh=None):
        from ..distributed.mesh import make_mesh

        self.catalog = catalog
        self.store = store
        self.settings = settings
        self.device = device
        # the session's mesh of positions (one position on `device`
        # unless the session asked for more)
        self.mesh = mesh if mesh is not None else make_mesh(
            1, default_device=device)
        # the owning session's StatCounters (None: nothing counted)
        self.counters = counters
        self.plan_cache = PlanCache(settings.get("max_cached_plans"))
        # the data_dir's device-memory ledger (shared by every session on
        # it) and this executor's pipelined-scan phase walls; a feed the
        # cache drops releases the captured graphs that read it
        self.accountant = accountant_for(store.data_dir)
        self.feed_cache = FeedCache(settings.get("max_cached_feed_bytes"),
                                    on_drop=self._feeds_dropped)
        self.accountant.register_evictable(self.feed_cache)
        self.scan_stats = ScanPhaseStats()
        self.oom = OomState()
        # per-thread plan of the in-flight statement: the degradation
        # ladder peeks at it to skip rungs that cannot help its shape
        self._oom_tls = threading.local()
        # the data_dir's persisted plan cache and capture gate, and the
        # keys the warmup armed from it (key → its persisted entry)
        self.exec_cache = exec_cache_for(store.data_dir)
        self._armed: dict = {}
        # per thread: how the last resident run dispatched, and why
        # (EXPLAIN ANALYZE's Caches line)
        self._graph_tls = threading.local()
        # fingerprint → walk-index-keyed converged capacities, persisted
        # in caps_memo.json (debounced: see _caps_memo_insert)
        self._caps_memo: dict = self._load_caps_memo()
        self._memo_dirty = 0
        self._memo_last_write = 0.0
        # fingerprints already tightened by feedback (at most once each)
        self._tightened_fps: set = set()
        self._caps_lock = threading.Lock()

    def adopt_mesh(self, mesh) -> None:
        """Run later plans on `mesh` (the survivors after a device loss,
        or a drained mesh): compiled plans and feeds laid out for the
        old mesh are dropped, and the ledger's per-position axis
        narrows.  The caps memo and the persisted cache key on the
        width and the positions' ids, so no entry of the old mesh is
        adopted."""
        self.mesh = mesh
        self.plan_cache.clear()
        self.feed_cache.clear()
        self.accountant.resize_mesh(mesh.size)

    def _mesh_for(self, plan: QueryPlan):
        """The mesh a plan runs on (its seams check the positions' ids,
        at one position too)."""
        if self.mesh.size != plan.n_devices:
            from ..errors import StaleMeshPlan

            # planned for a mesh this executor no longer has (a
            # concurrent failover shrank it): re-plan
            raise StaleMeshPlan(
                f"plan for {plan.n_devices} positions, mesh has "
                f"{self.mesh.size}")
        return self.mesh

    def _feeds_dropped(self, tensor_ids) -> None:
        self.accountant.release_graphs(lambda g: g.reads_any(tensor_ids))

    # ------------------------------------------------------------------
    def execute_plan(self, plan: QueryPlan, raw: bool = False) -> ResultSet:
        for node in walk_plan(plan.root):
            if isinstance(node, ScanNode):
                self.store.refresh_if_stale(node.rel.table)
        self._oom_tls.plan = plan
        # a mesh plan runs eagerly (see `_graph_for`)
        self._graph_tls.last = ("eager",
                                "mesh" if plan.n_devices > 1 else None)
        # the reference's single-shard router: below fast_path_max_rows
        # a pruned plan answers host-side by design (on the card too)
        fast = try_execute_fast_path(self, plan, raw)
        if fast is not None:
            return fast
        try:
            return self._execute_device(plan, raw)
        except _TORCH_OOM as e:
            # a CUDA allocator refusal outside the plan's run (a decode
            # on the card while a feed is built): the same classified
            # error the ladder degrades on
            raise self._classify_oom(e, "building the plan's feeds")

    def _execute_device(self, plan: QueryPlan, raw: bool) -> ResultSet:
        from .stream import try_execute_streamed

        if self.oom.multipass_k > 1:
            from .multipass import try_execute_multipass

            mp = try_execute_multipass(self, plan, raw,
                                       self.oom.multipass_k)
            if mp is not None:
                return mp
        streamed = try_execute_streamed(self, plan, raw)
        if streamed is not None:
            return streamed
        compute_dtype = np.dtype(self.settings.get("compute_dtype"))
        packed, out_meta, caps, retries, feeds = self._run_resident(
            plan, compute_dtype)
        self.count_groupby_bucketed(plan, caps)
        with trace_span("combine"):
            cols, nulls, valid = unpack_outputs(packed, out_meta)
            result = self._host_combine(plan, cols, nulls, valid, raw)
        result.retries = retries
        result.device_rows_scanned = int(np.asarray(valid).size)
        result.device_rows_in = feed_device_rows(feeds)
        return result

    def _run_resident(self, plan: QueryPlan, compute_dtype,
                      no_cache_nodes=frozenset()):
        """Resident-feed execution core: build the feeds, resolve the
        capacity memo, run the overflow-retry loop.  Shared by
        execute_plan and each multi-pass pass."""
        mesh = self._mesh_for(plan)
        with trace_span("feed"):
            feeds = build_feeds(plan, self.catalog, self.store,
                                self.device, compute_dtype, self.feed_cache,
                                self.accountant, self.scan_stats,
                                no_cache_nodes, self.counters, mesh)
        topk_sig = (plan.device_topk, tuple(
            (repr(e), d, nf) for e, d, nf in plan.host_order_by)
            if plan.device_topk is not None else ())
        # a prepared SELECT's $n render as BParam(idx, dtype) in the
        # expression reprs, never with their values: every EXECUTE of
        # one shape shares its PlanCompiler and caps memo entry
        fingerprint = (node_fingerprint(plan.root), plan.n_devices,
                       str(compute_dtype), feeds_signature(plan, feeds),
                       topk_sig, str(self.device))
        if plan.n_devices > 1:
            # the width and the positions' ids: a shape converged on one
            # mesh is never adopted by another (a drained or failed-over
            # one included)
            fingerprint = fingerprint + (tuple(mesh.ids),)
        with self._caps_lock:
            memo = self._caps_memo.get(fingerprint)
        caps = (self._caps_from_order(plan, memo) if memo is not None
                else self._initial_capacities(plan, feeds))
        packed, out_meta, caps, retries = self.run_with_retry(
            plan, feeds, caps, fingerprint, compute_dtype)
        return packed, out_meta, caps, retries, feeds

    def execute_pass(self, plan: QueryPlan, split_nid: int):
        """One multi-pass pass (executor/multipass.py): run the pruned
        plan through the stream pipeline when it still exceeds the
        budget, else resident, and return its flattened pre-combine
        parts as (parts, rows_scanned, retries, streamed_batches).  The
        split scan's per-pass feed bypasses the feed cache — caching
        every pass's partition would defeat the pass."""
        from .stream import _flatten_batch, try_execute_streamed

        streamed = try_execute_streamed(self, plan, raw=True,
                                        return_parts=True,
                                        no_cache_nodes=frozenset(
                                            {split_nid}))
        if streamed is not None:
            parts, scanned, retries, batches, _caps = streamed
            return parts, scanned, retries, batches
        compute_dtype = np.dtype(self.settings.get("compute_dtype"))
        packed, out_meta, _caps, retries, _feeds = self._run_resident(
            plan, compute_dtype, no_cache_nodes=frozenset({split_nid}))
        cols, nulls, valid = unpack_outputs(packed, out_meta)
        scanned = int(np.asarray(valid).size)
        return [_flatten_batch(cols, nulls, valid)], scanned, retries, 0

    def _classify_oom(self, e: BaseException, what: str,
                      nbytes: int | None = None) -> DeviceMemoryExhausted:
        """A CUDA allocator OOM → the classified DeviceMemoryExhausted
        the session's ladder degrades on.  The finished frames of the
        failed run hold its tensors: clear them, so the memory returns
        to the allocator before the ladder retries."""
        self.accountant.note_oom()
        traceback.clear_frames(e.__traceback__)
        err = DeviceMemoryExhausted(f"device allocator OOM {what}: {e}")
        if nbytes is not None:
            err.nbytes = nbytes
        return err

    # ------------------------------------------------------------------
    def run_with_retry(self, plan: QueryPlan, feeds, caps: Capacities,
                       fingerprint, compute_dtype, allow_tighten=True,
                       allow_graph=True):
        """Run (with a cached PlanCompiler) + overflow-retry loop.
        Returns (packed, out_meta, converged_caps, retries).

        Capacity feedback: a clean execution whose recorded stage actuals
        sit far below their buffers tightens the capacities to
        actual×slack, re-executes once and memoizes; an over-tightened
        buffer simply overflows and regrows through the retry path.

        On the card a settled key replays its captured CUDA graph
        (`_graph_for`); `allow_graph=False` (streamed batches, whose
        buffers rotate) keeps every run eager."""
        limit = self.settings.get("max_plan_buffer_bytes")
        # positions sharing the card each allocate the plan's buffers
        on_card = plan.n_devices if self.mesh.single_device() else 1
        retries = 0
        tightened = False
        while True:
            check_cancel()  # overflow-retry iterations are cancel seams
            est = _plan_buffer_bytes(plan, caps)
            if limit and est > limit:
                if self._plan_degradable(plan):
                    # an over-limit plan whose shape the ladder can
                    # shrink (stream / multi-pass) degrades instead of
                    # erroring: the guard is a pre-allocation OOM signal
                    raise DeviceMemoryExhausted(
                        f"RESOURCE_EXHAUSTED (guard): plan needs "
                        f"~{est / 1e9:.1f} GB of device buffers "
                        f"(max_plan_buffer_bytes = "
                        f"{limit / 1e9:.1f} GB) — degrading")
                raise PlanningError(
                    f"plan needs ~{est / 1e9:.1f} GB of device "
                    f"buffers (max_plan_buffer_bytes = "
                    f"{limit / 1e9:.1f} GB) — usually a cartesian "
                    "or extreme-fanout join; rewrite the query or "
                    "raise the limit")
            key = fingerprint + (caps_signature(plan, caps),)
            compiler = self._resolve(key, plan, compute_dtype)
            # the run allocates its intermediates where the placement
            # seam cannot see them: the lease makes the estimate visible
            # to the ledger (and to an armed MemSim) for the run's window
            try:
                with self.accountant.lease("plan", est * on_card):
                    graph = (self._graph_for(key, compiler, plan, feeds,
                                             caps)
                             if allow_graph and self._graphs_on()
                             else None)
                    out = (compiler.run(plan, feeds, caps, graph=graph)
                           if graph is not None else None)
                    if out is None:
                        graph = None
                        out = compiler.run(plan, feeds, caps)
                    packed, counters, out_meta, stage_keys = out
            except _TORCH_OOM as e:
                raise self._classify_oom(
                    e, f"running the plan (~{est} intermediate bytes)",
                    est)
            cap_overflow = int(counters[0])
            dense_oob = int(counters[1])
            if cap_overflow == 0 and dense_oob == 0:
                if graph is not None:
                    # a graph exists only for a settled key
                    return packed, out_meta, caps, retries
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
                if self.counters is not None and compiler.shuffle_bytes:
                    # the all_to_all volume of the converged run (the
                    # psum-directory pushdown moves none; a stream passes
                    # here per batch)
                    self.counters.increment(sc.SHUFFLE_BYTES_TOTAL,
                                            compiler.shuffle_bytes)
                self._settle(key, compiler, plan, feeds, caps, out_meta,
                             stage_keys)
                return packed, out_meta, caps, retries
            if graph is not None:
                # a replay overflowed: the graph no longer fits its data
                self.plan_cache.drop_graph(key)
                graph.release()
            compiler.armed = False
            retries += 1
            # named seam: a failure while growing capacities must leave
            # the plan cache and capacity memo consistent
            fault_point("executor.overflow_retry")
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
            # an overflow regrow whose buffers no longer fit what is
            # left of the device budget would retry straight into an
            # OOM — degrade (stream / multi-pass) instead
            budget = self.accountant.budget_bytes(self.device,
                                                  self.settings)
            if budget:
                need = _plan_buffer_bytes(plan, caps) * on_card
                room = budget - self.accountant.pressure_bytes()
                if need > room and self._plan_degradable(plan):
                    raise DeviceMemoryExhausted(
                        f"RESOURCE_EXHAUSTED (regrow guard): capacity "
                        f"regrow needs ~{need} bytes but only ~{room} "
                        f"remain of the {budget}-byte device budget — "
                        "degrading instead of retrying into an OOM")

    # ------------------------------------------------------------------
    def _resolve(self, key, plan: QueryPlan, compute_dtype) -> PlanCompiler:
        """The key's PlanCompiler: cached, or built on a plan-cache miss,
        which first asks the persisted cache whether the key converged
        before (a hit arms it: its first run captures at once)."""
        compiler = self.plan_cache.get(key)
        if compiler is not None:
            return compiler
        # named seam: a failure while building the compiler must leave
        # the plan cache without a half-built entry
        fault_point("executor.plan_cache_fill")
        status = "miss"
        armed = key in self._armed
        if armed:
            status = "hit"  # adopted by the warmup: counted there
        elif self.settings.get("exec_cache_enabled"):
            with trace_span("compile.cache_load"):
                entry, status = self.exec_cache.load(key, self.device)
            if self.counters is not None:
                self.counters.increment({
                    "hit": sc.EXEC_CACHE_HITS_TOTAL,
                    "reject": sc.EXEC_CACHE_REJECTS_TOTAL,
                    "miss": sc.EXEC_CACHE_MISSES_TOTAL}[status])
            armed = entry is not None
        with trace_span("compile", cache=status):
            compiler = PlanCompiler(plan, compute_dtype, self.device,
                                    self._mesh_for(plan))
            compiler.armed = armed
        self.plan_cache.put(key, compiler)
        return compiler

    def _settle(self, key, compiler: PlanCompiler, plan: QueryPlan, feeds,
                caps: Capacities, out_meta, stage_keys) -> None:
        """A clean run at `key` with nothing left to tighten: the key's
        next run over the same feed keys captures; its first such run
        persists the entry."""
        first = compiler.settled_feeds is None
        compiler.settled_feeds = _feed_keys(plan, feeds)
        if first and not compiler.armed and \
                self.settings.get("exec_cache_enabled") and \
                not self.exec_cache.contains(key, self.device):
            self.exec_cache.store(key, self.device,
                                  self._caps_to_order(plan, caps),
                                  out_meta, stage_keys)

    def _graphs_on(self) -> bool:
        """CUDA graphs exist on the card only: the CPU runs eagerly."""
        return self.device.type == "cuda"

    def last_dispatch(self) -> tuple[str, str | None]:
        """(how this thread's last resident run dispatched — replayed,
        captured, eager or uncapturable — and the reason it stayed
        eager, if one was recorded)."""
        return getattr(self._graph_tls, "last", ("eager", None))

    def _graph_for(self, key, compiler: PlanCompiler, plan: QueryPlan,
                   feeds, caps: Capacities):
        """The CUDA graph this run replays, or None (eager).  A key
        captures — once per data_dir, through the gate, whose followers
        replay the leader's graph — when it is armed or its last clean
        eager run read the same feed keys: a new `$n` pruning or a new
        data version runs eager once first, as a new key does."""
        from . import graphs

        if plan.n_devices > 1:
            # a mesh plan runs eagerly: its MeshSim seams are host checks
            # that a replay would skip (ROADMAP queue A item 14)
            self._graph_tls.last = ("eager", "mesh")
            return None
        feed_keys = _feed_keys(plan, feeds)
        g = self.plan_cache.graph(key)
        if g is not None:
            if g.valid_for(feed_keys):
                self._graph_tls.last = ("replayed", None)
                return g
            self.plan_cache.drop_graph(key)
        self._graph_tls.last = ("eager", None)
        if not (compiler.armed or compiler.settled_feeds == feed_keys):
            return None
        if any(k is None for k in feed_keys):
            with trace_span("compile", cache="uncapturable",
                            reason=graphs.NOT_RESIDENT):
                pass
            self._graph_tls.last = ("uncapturable", graphs.NOT_RESIDENT)
            return None

        def capture():
            # another session may have captured this key over the same
            # feed keys since: adopt its graph
            g = self.accountant.find_graph(key, feed_keys)
            if g is not None:
                return g, True
            g = graphs.capture(key, compiler, plan, feeds, caps, feed_keys,
                               self.accountant)
            if g is not None:
                self.exec_cache.note_compile()
            return g, False

        with trace_span("compile", cache="miss") as sp:
            (g, adopted), joined = self.exec_cache.gate.run(
                ("graph", key, feed_keys), capture)
            deduped = adopted or joined
            if deduped and sp is not None:
                sp.meta["cache"] = "hit"
        if deduped and self.counters is not None:
            self.counters.increment(sc.COMPILES_DEDUPED_TOTAL)
        # an armed key captures at once only for its first feed keys
        compiler.armed = False
        if g is None or not g.live:
            return None  # the warm-up run overflowed: the retry path takes it
        self.plan_cache.put_graph(key, g)
        self._graph_tls.last = ("replayed" if deduped else "captured",
                                None)
        return g

    # ------------------------------------------------------------------
    def warmup_from_cache(self, deadline: float, top_n: int,
                          stop=None) -> int:
        """Warm-before-admit: what a fresh process lacks before its first
        statement can capture at once — the kernel libraries (built and
        loaded), the CUDA context, and the persisted cache's hottest
        entries, armed (their converged capacities in the memo, their
        keys marked).  Runs until the entries or the monotonic
        `deadline` run out, or `stop` is set; a fault degrades to lazy
        resolution.  Returns entries armed."""
        import time as _time

        if self.device.type == "cuda":
            from ..ops import hopper_kernels

            hopper_kernels.build_all()
            torch.cuda.init()
            torch.empty(1, device=self.device)
        armed = 0
        for h in self.exec_cache.top_hashes(max(0, top_n)):
            if _time.monotonic() >= deadline or \
                    (stop is not None and stop.is_set()):
                break  # budget spent or the session is closing
            try:
                fault_point("wlm.warmup")
                with trace_span("wlm.warmup"):
                    key, entry = self.exec_cache.load_hash(h, self.device)
            except Exception:  # graftlint: ignore[swallowed-fault-seam] — a warmup failure (injected or real) degrades to lazy resolution by design; the admission hold releases in the caller's finally
                break
            if entry is None:
                continue  # skewed (the JAX package's) or corrupt
            with self._caps_lock:
                self._caps_memo.setdefault(key[:-1], entry["caps"])
                self._tightened_fps.add(key[:-1])
            self._armed[key] = entry
            armed += 1
            if self.counters is not None:
                self.counters.increment(sc.WARMUP_COMPILES_TOTAL)
        return armed

    # ------------------------------------------------------------------
    def _plan_degradable(self, plan: QueryPlan) -> bool:
        """Can the degradation ladder shrink this plan's footprint?
        (executor/multipass.py owns the shape rules; windows and
        cartesian blowups stay clean immediate rejects.)"""
        from .multipass import ladder_degradable

        return ladder_degradable(
            plan, self.catalog, self.store,
            np.dtype(self.settings.get("compute_dtype")))

    def degrade_for_oom(self, step: int, nbytes: int | None = None
                        ) -> str | None:
        """Apply the next rung of the OOM degradation ladder; returns the
        rung's name, or None when no rung can help (the session then
        raises a clean ResourceExhausted).  `step` is the statement's
        1-based OOM count — monotone, so repeated OOMs walk DOWN the
        ladder instead of cycling on one rung; `nbytes` is the failed
        allocation's size when known (bounds the eviction target).

        Rungs, cheapest first:
          1. release captured graphs, evict feed caches coldest first
             (frees device memory, nothing recompiles) and empty the
             CUDA caching allocator;
          2. halve the stream batch_cap;
          3. force the stream path even under the resident ceiling;
          4+. multi-pass execution, K doubling per rung.
        EVERY rung evicts first — a retry re-fills the cache, and
        cached feeds riding into a shrunk or streamed re-run would eat
        exactly the headroom the rung created.  The shrink / force /
        multi-pass state is sticky on the executor, so later statements
        start from the converged shape."""
        evicted = self._evict_for_oom(nbytes)
        if step <= 1:
            if evicted:
                return "evict_caches"
            step = 2  # nothing to evict: spend the escalation rung now
        plan = getattr(self._oom_tls, "plan", None)
        can_stream = can_multipass = False
        if plan is not None:
            from .multipass import multipass_candidate
            from .stream import stream_candidates

            can_stream = bool(stream_candidates(plan, self.catalog))
            can_multipass = multipass_candidate(
                plan, self.catalog, self.store,
                np.dtype(self.settings.get("compute_dtype"))) is not None
        max_passes = self.settings.get("oom_max_spill_passes")
        i = step - 2  # escalation ladder position (0-based)
        while True:
            if i == 0:
                if can_stream and self.oom.batch_shrink < MAX_BATCH_SHRINK:
                    self.oom.batch_shrink *= 2
                    if self.counters is not None:
                        self.counters.increment(
                            sc.STREAM_BATCH_SHRINKS_TOTAL)
                    return "shrink_stream_batch"
            elif i == 1:
                if can_stream and not self.oom.force_stream:
                    self.oom.force_stream = True
                    return "force_stream"
            else:
                if can_multipass and self.oom.multipass_k < max_passes:
                    self.oom.multipass_k = min(
                        max_passes, max(2, self.oom.multipass_k * 2))
                    return "multipass"
                return None
            i += 1

    def _evict_for_oom(self, nbytes: int | None = None) -> int:
        """Rung 1: drop cache-resident feeds coldest first — across
        EVERY session's FeedCache on this data_dir (the device is
        shared).  Frees at least 4× the failed allocation when its size
        is known, everything otherwise.  Then hands the CUDA caching
        allocator's free blocks back to CUDA: the ledger does not
        see that reserve, and the retry needs it.  Captured CUDA graphs
        are released before any feed, and their pools return to CUDA
        with the same empty_cache.  Also clears the data_dir's serving
        result cache.  Returns feed-cache entries evicted plus graphs
        released — only those mark the rung successful."""
        # captured graphs first (every session's on the data_dir): their
        # pools hold a whole plan's intermediates, and a replay later
        # re-captures
        graphs = self.accountant.release_graphs()
        evicted = self.accountant.evict_evictable(
            nbytes * 4 if nbytes else None)
        if evicted and self.counters is not None:
            self.counters.increment(sc.CACHE_EVICTIONS_TOTAL, evicted)
        # best-effort: finished results are host bytes, but a data_dir
        # under memory pressure keeps no serving cache warm either; the
        # peek never resurrects a released registry entry, and this
        # never counts toward the rung's success.  (Eviction above drops
        # only the feed cache's reference: a feed another admitted
        # statement is running on stays alive, and charged, through that
        # statement's own reference until it ends.)
        from ..serving.result_cache import peek_result_cache

        rcache = peek_result_cache(self.store.data_dir)
        if rcache is not None and len(rcache):
            rcache.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return evicted + graphs

    def count_groupby_bucketed(self, plan: QueryPlan,
                               caps: Capacities) -> None:
        """groupby_bucketed_total: once per executed statement whose
        converged plan ran the bucketed group-by (the streamed path
        calls this once after its batch loop; a dense_oob fallback onto
        the sort path, caps.dense_off, counts nothing)."""
        if self.counters is None:
            return
        nbk = sum(1 for nd in walk_plan(plan.root)
                  if isinstance(nd, AggregateNode)
                  and PlanCompiler.agg_bucket_shape(nd, caps.dense_off))
        if nbk:
            self.counters.increment(sc.GROUPBY_BUCKETED_TOTAL, nbk)

    # ------------------------------------------------------------------
    CAPS_MEMO_VERSION = 6  # the JAX package's: the same file and codec

    def _memo_path(self) -> str:
        import os

        return os.path.join(self.store.data_dir, "caps_memo.json")

    def _load_caps_memo(self) -> dict:
        """The persisted memo (plain JSON: tuples and dicts of ints,
        strings, bools and Nones through execcache's codec — never
        pickle in a shared data_dir); an unreadable or other-version
        file starts cold."""
        import json as _json

        try:
            with open(self._memo_path()) as f:
                obj = _json.load(f)
            if obj.get("version") == self.CAPS_MEMO_VERSION:
                return {key_from_json(k): key_from_json(v)
                        for k, v in obj["memo"]}
        except (OSError, ValueError, KeyError, TypeError,
                AttributeError):
            # unreadable/corrupt memo file (valid JSON that is not an
            # object makes obj.get raise AttributeError): start cold
            pass
        return {}

    # memo bounds + rewrite debounce (the JAX package's): overflow
    # evicts the OLDEST HALF, and the whole-file rewrite coalesces under
    # a burst of new shapes.  A lone memoization past the idle window
    # still writes at once; close() drains the rest (flush_persistent)
    CAPS_MEMO_MAX = 512
    CAPS_MEMO_FLUSH_EVERY = 8
    CAPS_MEMO_FLUSH_IDLE_S = 0.25

    def _memoize_caps(self, fingerprint, plan: QueryPlan,
                      caps: Capacities) -> None:
        self._caps_memo_insert(fingerprint,
                               self._caps_to_order(plan, caps))

    def _caps_memo_insert(self, fingerprint, ordered) -> None:
        import time as _time

        with self._caps_lock:
            if fingerprint not in self._caps_memo and \
                    len(self._caps_memo) >= self.CAPS_MEMO_MAX:
                for k in list(self._caps_memo)[
                        :len(self._caps_memo) // 2]:
                    del self._caps_memo[k]
            # LRU: a re-memoized hot shape moves to the young end
            self._caps_memo.pop(fingerprint, None)
            self._caps_memo[fingerprint] = ordered
            self._memo_dirty += 1
            now = _time.monotonic()
            if self._memo_dirty < self.CAPS_MEMO_FLUSH_EVERY and \
                    now - self._memo_last_write < \
                    self.CAPS_MEMO_FLUSH_IDLE_S:
                return  # coalesce: a later insert or close() flushes
        self._flush_caps_memo()

    def _flush_caps_memo(self) -> None:
        import time as _time

        from ..utils.io import atomic_write_json

        # snapshot under the lock, write the file outside it
        with self._caps_lock:
            if not self._memo_dirty:
                return
            self._memo_dirty = 0
            self._memo_last_write = _time.monotonic()
            payload = [[key_to_json(k), key_to_json(v)]
                       for k, v in self._caps_memo.items()]
        try:
            atomic_write_json(self._memo_path(),
                              {"version": self.CAPS_MEMO_VERSION,
                               "memo": payload})
        except (OSError, TypeError, ValueError):
            pass  # persistence is best-effort; the in-memory memo serves

    def flush_persistent(self) -> None:
        """Drain debounced persistence (the caps memo, the persisted
        cache's hotness index): Session.close() calls this so a clean
        shutdown leaves the warm-start state current on disk."""
        self._flush_caps_memo()
        self.exec_cache.flush_index()

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
        """Propagate static per-position capacities bottom-up (the JAX
        package's rules; at one position no repartition buffer exists)."""
        repart_factor = self.settings.get("repartition_capacity_factor")
        repart: dict[int, int] = {}
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
                # at one position every repartition is the identity: each
                # side keeps its own capacity and no shuffle buffer exists
                lcap = cap_of(node.left)
                rcap = cap_of(node.right)
                if n_dev > 1:
                    if node.strategy == "repart_right":
                        repart[id(node)] = _round_cap(
                            int(rcap * repart_factor))
                        rcap = n_dev * repart[id(node)]
                    elif node.strategy == "repart_left":
                        repart[id(node)] = _round_cap(
                            int(lcap * repart_factor))
                        lcap = n_dev * repart[id(node)]
                    elif node.strategy == "repart_both":
                        repart[id(node)] = _round_cap(
                            int(max(lcap, rcap) * repart_factor))
                        lcap = n_dev * repart[id(node)]
                        rcap = n_dev * repart[id(node)]
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
                    if node.strategy == "cartesian_gather" and n_dev > 1:
                        # the gathered build side is n_dev shards wide
                        rcap = rcap * n_dev
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
                in_cap = cap_of(node.input)
                if node.combine != "repartition" or n_dev == 1:
                    return in_cap
                if node.partition_by:
                    repart[id(node)] = _round_cap(
                        int(in_cap * repart_factor))
                else:
                    # one global partition: every row on one position
                    repart[id(node)] = _round_cap(
                        int(in_cap * n_dev * repart_factor))
                return n_dev * repart[id(node)]
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
                combine = node.combine == "repartition" and n_dev > 1
                est_g = node.est_groups
                if est_g:
                    agg_cap = _round_cap(
                        min(in_cap, int(est_g * group_factor) + 16))
                    agg_out[id(node)] = agg_cap
                    if combine:
                        # worst case: every group hashes to one target
                        repart[id(node)] = agg_cap
                    return agg_cap
                if combine:
                    repart[id(node)] = _round_cap(int(in_cap * repart_factor))
                    return n_dev * repart[id(node)]
                return in_cap
            raise ExecutionError(f"unknown node {type(node).__name__}")

        root_cap = cap_of(plan.root)
        out_rp = None
        if plan.output_repart is not None:
            # balanced-hash expectation with headroom; skew overflows and
            # regrows through the normal retry path
            out_rp = _round_cap(
                int(-(-root_cap // n_dev) * repart_factor) + 256)
        return Capacities(repart, join_out, agg_out, dense_off, scan_out,
                          out_rp, bucket_probe, agg_bucket)

    # ------------------------------------------------------------------
    def _host_combine(self, plan: QueryPlan, cols, nulls, valid,
                      raw: bool = False) -> ResultSet:
        valid_2d = np.asarray(valid)
        # rows per position while the result keeps position-major order
        device_rows = (valid_2d.sum(axis=1).astype(int).tolist()
                       if valid_2d.ndim == 2 else None)
        valid_np = valid_2d.reshape(-1)
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
            device_rows = None  # filtered: per-position counts are stale

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
            device_rows = None  # re-sorted: position-major order destroyed
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
            device_rows = None  # sliced: per-position counts are stale
        final_n = max(0, hi - lo)
        if raw:
            return ResultSet(names, out_cols, final_n, dtypes=out_dtypes,
                             null_masks=out_nulls, decode_map=decode_map,
                             device_rows=device_rows)
        # surface NULLs as None in object columns
        for c in names:
            if out_nulls[c].any():
                col = np.asarray(out_cols[c], dtype=object)
                col[out_nulls[c]] = None
                out_cols[c] = col
        return ResultSet(names, out_cols, final_n, dtypes=out_dtypes,
                         device_rows=device_rows)


def _feed_keys(plan: QueryPlan, feeds) -> tuple:
    """The feed-cache key of each scan's feed, in walk order (None for
    a feed the cache does not serve)."""
    return tuple(feeds[id(n)].cache_key for n in walk_plan(plan.root)
                 if isinstance(n, ScanNode))


def feed_device_rows(feeds) -> list[int] | None:
    """Rows each position fed into the plan (the sharded feeds' rows,
    summed per position — the Mesh line's input column), or None when
    no feed is sharded."""
    totals: list[int] = []
    for f in feeds.values():
        if f.dev_rows is None:
            continue
        if len(totals) < len(f.dev_rows):
            totals.extend([0] * (len(f.dev_rows) - len(totals)))
        for d, r in enumerate(f.dev_rows):
            totals[d] += int(r)
    return totals or None


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
    for nid, cap in caps.repartition.items():
        # a position's [N, cap] pack and its exchanged copy
        node = nodes.get(nid)
        ncols = len(node.out_columns) if node is not None else 4
        worst = max(worst, cap * plan.n_devices * (ncols + 2) * 8)
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
