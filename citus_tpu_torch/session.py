"""Session: the port's connection object (SQL in, ResultSet out).

Counterpart of citus_tpu/session.py, carrying CREATE TABLE,
create_distributed_table / create_reference_table, the bulk TPC-H load
(ingest.tpch.load_into_session), SET, and read-only SELECT through
binder → planner → feeds → PlanCompiler → runner on the session's device.
A Session opens any data_dir the JAX package wrote (same catalog,
manifests, stripes and dictionaries) and the JAX package opens the port's.

Recursive planning comes before binding, as in the reference: CTEs,
subqueries in FROM and views materialise into `__intermediate_{n}` temp
reference tables; correlated EXISTS / IN / scalar aggregates decorrelate
into semi / anti joins and grouped derived tables
(planner/decorrelate.py); uncorrelated scalar, IN and EXISTS subqueries
run first and fold into literals; set operations (UNION / INTERSECT /
EXCEPT) run over one combined temp; approx_percentile becomes a
DDSketch bucket pre-pass.  Every temp is dropped when its statement
ends.

PREPARE / EXECUTE / DEALLOCATE keep generic plans: a prepared SELECT
binds its $n as BParam values that the executor reads at run time, so
every EXECUTE shares one cached PlanCompiler.  EXPLAIN renders the plan
(planner/explain.py).  DDL: CREATE/DROP VIEW and SEQUENCE, ALTER TABLE
ADD/DROP/RENAME COLUMN, DROP TABLE; the catalog UDFs of `_try_udf`.

Writes: INSERT … VALUES (with nextval), INSERT … SELECT
(executor/insert_select.py; set operations as the source too), COPY …
FROM (ingest/copy_from.py), UPDATE / DELETE (WHERE subqueries planned
recursively first) and MERGE (executor/dml.py).  Each runs in
autocommit or inside BEGIN … COMMIT/ROLLBACK (transaction/manager.py):
an open transaction's writes stage into the store's overlay, which this
session's reads see; COMMIT is the 2PC dance of the JAX package's
commit log, and opening a data_dir recovers interrupted commits before
any read.  DML holds (table, shard) locks with deadlock detection
(transaction/locks.py) and journals to the change feed (cdc/feed.py).

Every statement runs under the resilience envelope
(`_execute_resilient`): one cooperative deadline (`statement_timeout_ms`
and `Session.cancel`) around a bounded retry loop
(`max_statement_retries`, exponential backoff with jitter) that marks a
failed shard read's placement suspect so the retry reads a replica,
finishes interrupted 2PC commits before re-running, resolves a COMMIT
that died mid-2PC by its commit record, and walks the OOM degradation
ladder (executor/runner.py `degrade_for_oom`) on DeviceMemoryExhausted.

Observability (stats/): each Session owns `stats` (a SessionStats) —
the counters behind citus_stat_counters, per-statement and per-tenant
statistics, the live activity registry and the span flight recorder.
`execute` traces every statement (parse → execute attempts → plan →
feed → mesh.dispatch / mesh.fetch → combine, with CUDA-event device
legs on a cuda session); EXPLAIN ANALYZE prints its Timing line from
that trace.

Concurrent sessions (wlm/, serving/, replication/): every non-exempt
statement passes the data_dir's workload manager between parse and the
envelope (`_execute_admitted`: slots, the device-memory gate, per-tenant
fair queueing and shedding, one deadline over queue wait and execution);
fast-path point reads coalesce across sessions in the micro-batcher; a
repeated read statement answers from the CDC-invalidated result cache
(`_execute_select`; never inside an open transaction); a follower
data_dir applies shipped batches when it opens and before each
statement, refuses writes and bounds its visible staleness
(`_replica_gate`).

Shard operations and background jobs (operations/, background/):
split, tenant isolation, moves, the rebalancer (inline or as a
background job with live progress), the deferred cleanup registry
(swept at open, by the maintenance daemon and after promotion), the
storage scrubber and restore points.  Each Session starts a job runner
(its tasks admit at the workload manager's `background` class) and a
maintenance daemon; close() stops and joins both.  Every stripe read
goes through the store's read-repair seam, and each statement folds its
integrity accounting (stripes verified, corruption detected, read
repairs) into the session counters and its activity row.

A session opened with `n_devices=N` (or `devices=[...]`) runs every
statement as N hash-sharded mesh positions driven by this one controller
(distributed/mesh.py); the envelope fails a lost position over to the
survivors (`_degrade_mesh`), and `citus_stat_mesh`,
`citus_rebalance_mesh` and `citus_drain_device` read and fit the mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import tempfile
import threading
from dataclasses import replace as dc_replace

import numpy as np

from .catalog import Catalog, DistributionMethod
from .config import Settings
from .background import BackgroundJobRunner, MaintenanceDaemon
from .errors import (
    CatalogError,
    ExecutionError,
    PlanningError,
    UnsupportedQueryError,
)
from .executor.runner import Executor, ResultSet
from .operations.cleanup import cleanup_registry_for
from .planner.bind import Binder, DictProvider
from .planner.decorrelate import (
    _map_children,
    decorrelate_select,
    rewrite_multi_distinct,
)
from .planner.explain import format_plan
from .planner.plan import DistributedPlanner, QueryPlan, StatsProvider
from .replication import apply_pending, replication_for
from .runtime import resolve_device
from .sql import ast, parse
from .stats import SessionStats, extract_tenants
from .stats import counters as sc
from .stats.tracing import trace_span
from .storage import TableStore
from .storage import integrity as _integrity
from .transaction.locks import lock_manager_for
from .transaction.manager import TransactionManager
from .types import (
    ColumnDef,
    DataType,
    TableSchema,
    date_to_days,
    sql_type_to_datatype,
)
from .wlm import workload_manager_for


# the UDFs this port answers (Session._try_udf): the catalog's, the
# workload, serving and replication UDFs, the stats and health UDFs of
# stats/ and operations/health.py, and the shard operations and job UDFs
# of operations/ and background/
_UDFS = ("create_distributed_table", "create_reference_table",
         "citus_add_node", "citus_remove_node", "citus_disable_node",
         "citus_activate_node", "nextval", "currval",
         "citus_tables", "citus_shards", "citus_change_feed",
         "citus_get_node_clock",
         "citus_stat_wlm", "citus_stat_serving", "citus_stat_replication",
         "citus_replication_ship", "citus_promote_replica",
         "citus_stat_counters", "citus_stat_counters_reset",
         "citus_stat_statements", "citus_stat_statements_reset",
         "citus_stat_latency", "citus_stat_latency_reset",
         "citus_stat_tenants", "citus_stat_activity", "citus_stat_memory",
         "citus_check_cluster_node_health", "citus_promote_node",
         "rebalance_table_shards", "citus_move_shard_placement",
         "get_rebalance_progress", "citus_split_shard_by_split_points",
         "isolate_tenant_to_node", "citus_cleanup_orphaned_resources",
         "citus_rebalance_start", "citus_rebalance_wait",
         "citus_job_wait", "citus_job_cancel", "citus_job_list",
         "citus_create_restore_point", "citus_check_cluster",
         "citus_stat_mesh", "citus_rebalance_mesh", "citus_drain_device")

# the JAX package's UDFs still to port, by the ROADMAP queue A item that
# brings their module: each raises UnsupportedQueryError naming it
_UNPORTED_UDFS: dict[str, str] = {}


# fault points that fire AFTER a write's visibility flip: the effect is
# already committed, so re-executing the statement would apply it twice —
# the error propagates instead (the reference likewise never retries a
# task once its placement reported success)
_NON_RETRYABLE_POINTS = frozenset({"cdc.append"})

# statement shapes a follower refuses: every mutation belongs on the
# leader, and the journal is the only way data reaches a replica
_REPLICA_WRITE_STMTS = (
    ast.InsertValues, ast.InsertSelect, ast.Update, ast.Delete, ast.Merge,
    ast.CopyFrom, ast.CreateTable, ast.DropTable, ast.AlterTable,
    ast.CreateView, ast.DropView, ast.CreateSequence, ast.DropSequence)
# admin UDFs that mutate catalog or data (the JAX package's list)
_REPLICA_WRITE_UDFS = frozenset({
    "create_distributed_table", "create_reference_table",
    "citus_add_node", "citus_remove_node", "citus_disable_node",
    "citus_activate_node", "rebalance_table_shards",
    "citus_move_shard_placement", "citus_split_shard_by_split_points",
    "isolate_tenant_to_node", "citus_rebalance_start",
    "citus_rebalance_mesh", "citus_drain_device",
    "citus_promote_node", "citus_create_restore_point", "nextval"})


class _StoreStats(StatsProvider):
    def __init__(self, store: TableStore):
        self.store = store

    def table_rows(self, table: str) -> int:
        return self.store.table_row_count(table)

    def column_ndv(self, table: str, column: str, dtype) -> int | None:
        ext = self.column_extent(table, column, dtype)
        return None if ext is None else ext[1]

    def column_extent(self, table: str, column: str,
                      dtype) -> tuple[int, int] | None:
        if dtype == DataType.STRING:
            try:
                d = self.store.dictionary(table, column)
            except Exception:
                return None
            return (0, len(d)) if len(d) else None
        if dtype in (DataType.INT32, DataType.INT64, DataType.DATE,
                     DataType.BOOL):
            rng = self.store.column_range(table, column)
            if rng is None:
                return None
            return int(rng[0]), int(rng[1] - rng[0]) + 1
        return None


class _StoreDicts(DictProvider):
    def __init__(self, store: TableStore):
        self.store = store

    def dictionary(self, table: str, column: str):
        return self.store.dictionary(table, column)


class Session:
    def __init__(self, data_dir: str | None = None, device=None,
                 n_devices: int | None = None, devices=None, **settings):
        """`device=None` runs on cuda:0 and raises when no GPU is
        visible; `device="cpu"` runs the plain formulations (tests).
        `n_devices=N` runs every statement as N hash-sharded mesh
        positions (distributed/mesh.py), all on `device` unless
        `devices` lists one device per position (a device may repeat);
        `n_devices` above what `devices` provides raises.  `settings`
        are config variables (config.py), e.g. scan_pipeline="off" for
        the eager feed path."""
        self.device = resolve_device(
            device if device is not None or not devices else devices[0])
        self.data_dir = data_dir or tempfile.mkdtemp(prefix="citus_port_")
        os.makedirs(self.data_dir, exist_ok=True)
        self.settings = Settings(settings or None)
        # counters, statement/tenant stats, activity and the tracer
        self.stats = SessionStats(self.data_dir, self.settings)
        cat_path = os.path.join(self.data_dir, "catalog.json")
        self.catalog = (Catalog.load(cat_path) if os.path.exists(cat_path)
                        else Catalog())
        self.store = TableStore(self.data_dir, self.catalog, self.settings)
        from .distributed.mesh import make_mesh

        self.mesh = make_mesh(
            n_devices, [resolve_device(d) for d in devices]
            if devices else None, default_device=self.device)
        # the catalog's node↔device map folds the nodes of a data_dir
        # written for another width onto this mesh's positions
        self.n_devices = self.mesh.size
        if not self.catalog.nodes:
            for i in range(self.n_devices):
                self.catalog.add_node(f"device:{i}")
        self.executor = Executor(self.catalog, self.store, self.settings,
                                 self.device, self.stats.counters,
                                 self.mesh)
        # intermediate-result names: itertools.count is GIL-atomic, so
        # concurrent statements never mint the same temp
        self._temp_counter = itertools.count(1)
        self._view_tls = threading.local()  # view-expansion cycle guard
        # PREPARE name → statement; EXECUTE args of the statement being
        # planned (subplans substitute them, the outer plan keeps $n)
        self._prepared: dict[str, ast.Statement] = {}
        self._params_tls = threading.local()
        # transaction coordinator + the data_dir's shared lock table;
        # interrupted 2PC commits (this package's or the JAX package's)
        # roll forward/back NOW, before any read
        # (transaction/transaction_recovery.c)
        self.txn_manager = TransactionManager(self.store, self.data_dir)
        self.locks = lock_manager_for(self.data_dir)
        self.txn_manager.recover()
        # crash-recovery sweep: half-finished splits and moves resolve
        # against the catalog (operations/cleanup.py)
        cleanup_registry_for(self.data_dir).sweep(self.store, self.catalog)
        # Session.cancel() → the executing statement's next seam raises
        self._cancel_evt = threading.Event()
        # the OOM ladder's rungs taken by the last statement, in order
        self.last_oom_rungs: list[str] = []
        # the workload manager: sessions sharing a data_dir share ONE
        # admission gate (they share the card and its memory ledger)
        self.wlm = workload_manager_for(self.data_dir)
        # per thread: the last admission (EXPLAIN ANALYZE's Workload
        # line) and the last follower staleness check (its Replication
        # line)
        self._wlm_tls = threading.local()
        self._replica_stale_tls = threading.local()
        # this session's reference on the shared result cache, taken on
        # first use; the lock keeps concurrent first uses to ONE
        # reference, which close() gives back
        self._result_cache_handle = None
        self._result_cache_mu = threading.Lock()
        # replication role: a follower drains the batches shipped while
        # no session was open BEFORE serving, then adopts the shipped
        # catalog
        self.replication = replication_for(self.data_dir)
        if self.replication.is_follower():
            res = apply_pending(self.data_dir, counters=self.stats.counters,
                                store=self.store)
            if res["applied"]:
                self.catalog.maybe_reload(cat_path)
        # background services: the job runner (its tasks admit at the
        # workload manager's background class) and the maintenance
        # daemon (2PC recovery, deferred cleanup, health sweep, scrub,
        # log shipping, deadlock checks)
        self.jobs = BackgroundJobRunner(
            self.settings.get("max_background_task_executors"),
            wlm=self.wlm, wlm_request=self._wlm_background_request)
        self._last_rebalance_job = 0
        self.maintenance = MaintenanceDaemon(self)
        self.maintenance.start()
        # warm-before-admit (executor/runner.py warmup_from_cache): a
        # fresh session over a populated persisted plan cache builds its
        # kernels, makes the CUDA context and arms the hottest keys while
        # the workload manager holds non-exempt admissions — for at most
        # warmup_budget_ms (the hold expires: an overrun degrades to lazy
        # resolution, never an admission block)
        self._warmup_thread = None
        self._warmup_stop = threading.Event()
        warm_ms = self.settings.get("warmup_budget_ms")
        if warm_ms > 0 and self.settings.get("exec_cache_enabled") \
                and self.executor.exec_cache.has_entries():
            import time as _time

            deadline = _time.monotonic() + warm_ms / 1000.0
            self.wlm.hold_admissions(deadline)
            self._warmup_thread = threading.Thread(
                target=self._run_warmup, args=(deadline,),
                name="citus-warmup", daemon=True)
            self._warmup_thread.start()

    def _run_warmup(self, deadline: float) -> None:
        """Warmup-thread body: arm persisted plans, then ALWAYS release
        the hold on the shared workload manager (close() sets the stop
        event and joins this thread)."""
        try:
            self.executor.warmup_from_cache(
                deadline, self.settings.get("warmup_top_shapes"),
                stop=self._warmup_stop)
        finally:
            self.wlm.release_admissions()

    # ------------------------------------------------------------------
    def execute(self, sql: str):
        """Run a SQL script; returns the last statement's ResultSet/None.

        Each statement of the script gets its own trace (the first one's
        covers parse, so top-level spans tile the wall), runs tracked in
        the activity registry, and folds into the counters; the script
        records once in citus_stat_statements and per pinned tenant."""
        import time as _time

        # adopt another session's committed DDL; never mid-transaction
        # (the open transaction pinned its snapshot)
        if self.txn_manager.current is None:
            self.catalog.maybe_reload(os.path.join(self.data_dir,
                                                   "catalog.json"))
        self._cancel_evt.clear()  # a fresh script clears stale cancels
        result = None
        tenant_hits: list[tuple[str, object]] = []
        tracer = self.stats.tracing
        th = tracer.begin(sql)
        trace_err = None
        try:
            with trace_span("parse"):
                stmts = parse(sql)
            with self.stats.activity.track(sql) as activity:
                t0 = _time.perf_counter()
                for i, stmt in enumerate(stmts):
                    if i:
                        tracer.end(th)
                        th = tracer.begin(sql)
                    activity.retries = 0
                    activity.read_repairs = 0
                    # per statement: the citus_stat_activity cache
                    # columns show the in-flight statement's own traffic
                    activity.cache_base = (
                        self.executor.plan_cache.hits,
                        self.executor.plan_cache.misses,
                        self.executor.feed_cache.hits,
                        self.executor.feed_cache.misses)
                    ibase = _integrity.snapshot()
                    try:
                        result = self._execute_admitted(stmt, activity)
                    finally:
                        self._fold_integrity(_integrity.delta(ibase),
                                             activity)
                    self._count_statement(stmt, result)
                    tenant_hits.extend(extract_tenants(stmt, self.catalog))
                elapsed_ms = (_time.perf_counter() - t0) * 1000.0
        except BaseException as e:
            trace_err = e
            raise
        finally:
            tracer.end(th, error=trace_err)
        rows = getattr(result, "row_count", 0) if result is not None else 0
        self.stats.queries.record(sql, elapsed_ms, rows)
        for table, tenant in tenant_hits:
            self.stats.tenants.record(table, tenant, elapsed_ms)
        return result

    def _fold_integrity(self, idelta: dict, activity) -> None:
        """Fold one statement's storage-integrity traffic (module-wide
        accounting, storage/integrity.py) into the session counters and
        its activity row."""
        c = self.stats.counters
        for key, counter in (("stripes_verified", sc.STRIPES_VERIFIED_TOTAL),
                             ("corruption_detected",
                              sc.CORRUPTION_DETECTED_TOTAL),
                             ("read_repairs", sc.READ_REPAIRS_TOTAL)):
            if idelta[key]:
                c.increment(counter, idelta[key])
        activity.read_repairs += idelta["read_repairs"]

    def _count_statement(self, stmt: ast.Statement, result) -> None:
        c = self.stats.counters
        if isinstance(stmt, ast.Select):
            if (not stmt.from_items and len(stmt.items) == 1
                    and isinstance(stmt.items[0].expr, ast.FuncCall)
                    and stmt.items[0].expr.name in _UDFS):
                return  # admin UDF calls aren't query traffic
            if result is not None:
                c.increment(sc.ROWS_RETURNED, result.row_count)
                # the executor's capacity retries (the envelope's own
                # retries and rungs count in retries_total and
                # oom_events_total)
                c.increment(sc.CAPACITY_RETRIES,
                            result.retries - result.envelope_retries)
                c.increment(sc.DEVICE_ROWS_SCANNED,
                            result.device_rows_scanned)
                if result.fast_path:
                    c.increment(sc.QUERIES_FAST_PATH)
        elif isinstance(stmt, ast.Update):
            c.increment(sc.DML_UPDATE)
        elif isinstance(stmt, ast.Delete):
            c.increment(sc.DML_DELETE)
        elif isinstance(stmt, ast.Merge):
            c.increment(sc.DML_MERGE)
        elif isinstance(stmt, (ast.CreateTable, ast.DropTable)):
            c.increment(sc.DDL_COMMANDS)

    def cancel(self) -> None:
        """Cooperative cross-thread cancel of the statement running on
        this session (the pg_cancel_backend analogue): it raises
        QueryCanceled at its next seam — fault point, stream/COPY batch
        boundary, multi-pass pass, retry iteration."""
        self._cancel_evt.set()

    # -- workload management -----------------------------------------------
    def _wlm_background_request(self):
        """Admission request of a background job task (rebalance moves,
        the scrub): the background class — user statements always
        dispatch first — with an effectively unbounded queue (a
        maintenance task waits for capacity rather than shedding)."""
        from .wlm import AdmissionRequest

        return AdmissionRequest(
            tenant="background", priority="background",
            max_slots=self.settings.get("max_concurrent_statements"),
            max_feed_bytes=self.settings.get("max_feed_bytes_per_device"),
            queue_depth=1_000_000)

    def _execute_admitted(self, stmt: ast.Statement, activity=None):
        """Admission around the resilience envelope: classify the
        statement, hold a slot and its device-memory budget through
        every retry of its execution, release at statement end.  Exempt
        statements (utility, transaction control, admin UDFs, fast-path
        point reads) and every statement inside an open transaction
        skip the gate (wlm/admission.py).  The queue wait honors
        statement_timeout_ms and Session.cancel() as execution does,
        and the time spent queued comes out of the statement's one
        timeout budget."""
        from .errors import AdmissionRejected, QueryCanceled, StatementTimeout
        from .utils.cancellation import deadline_scope
        from .wlm import (
            AdmissionRequest,
            parse_tenant_weights,
            planned_feed_bytes,
            statement_exempt,
            statement_tenant,
        )

        self._wlm_tls.last = None
        # EXECUTE classifies by its prepared statement's real shape
        target = stmt
        if isinstance(stmt, ast.ExecutePrepared):
            target = self._prepared.get(stmt.name, stmt)
        # an open transaction already owns its resources: queueing for a
        # slot while holding 2PL locks would make slot↔lock deadlock
        # cycles the lock manager's detector cannot see.  The
        # classification is admission work, so it books under `queue`
        with trace_span("queue"):
            exempt = (self.txn_manager.current is not None
                      or not self.settings.get("wlm_enabled")
                      or statement_exempt(target, self.catalog,
                                          self.settings, _UDFS))
        if exempt:
            return self._execute_resilient(stmt, activity)

        # this span covers the estimate and the wait; it carries the
        # ticket's queued_ms
        with trace_span("queue") as qspan:
            tenant = statement_tenant(target, self.catalog, self.settings)
            weights = parse_tenant_weights(
                self.settings.get("wlm_tenant_weights"))
            req = AdmissionRequest(
                tenant=tenant,
                priority=self.settings.get("wlm_default_priority"),
                feed_bytes=planned_feed_bytes(target, self.catalog,
                                              self.store, self.n_devices,
                                              self.settings),
                weight=weights.get(tenant, 1),
                max_slots=self.settings.get("max_concurrent_statements"),
                max_feed_bytes=self.settings.get(
                    "max_feed_bytes_per_device"),
                queue_depth=self.settings.get("wlm_queue_depth"))
            timeout_ms = self.settings.get("statement_timeout_ms")
            if activity is not None:
                activity.wait_state = "queued"
            try:
                with deadline_scope(timeout_ms or None, self._cancel_evt):
                    ticket = self.wlm.admit(req)
            except Exception as e:
                if activity is not None:
                    activity.wait_state = "running"
                if isinstance(e, AdmissionRejected):
                    self.stats.counters.increment(sc.WLM_SHED_TOTAL)
                elif isinstance(e, StatementTimeout):
                    self.stats.counters.increment(sc.TIMEOUTS_TOTAL)
                elif isinstance(e, QueryCanceled):
                    self.stats.counters.increment(sc.QUERIES_CANCELED)
                raise
            if qspan is not None:
                qspan.meta = {"tenant": ticket.tenant,
                              "queued_ms": round(ticket.queued_ms, 3)}
        if activity is not None:
            activity.wait_state = "admitted"
            activity.queued_ms = ticket.queued_ms
        self.stats.counters.increment(sc.WLM_ADMITTED_TOTAL)
        if ticket.was_queued:
            self.stats.counters.increment(sc.WLM_QUEUED_TOTAL)
            self.stats.counters.increment(
                sc.WLM_QUEUE_WAIT_MS, int(round(ticket.queued_ms)))
        self._wlm_tls.last = {
            "tenant": ticket.tenant, "priority": ticket.priority,
            "queued_ms": ticket.queued_ms,
            "feed_bytes": ticket.feed_bytes,
            "slots_in_use": ticket.slots_in_use,
            "slots_total": ticket.slots_total}
        # ONE deadline spans queue wait and execution
        remaining_ms = (max(1.0, timeout_ms - ticket.queued_ms)
                        if timeout_ms else None)
        try:
            if activity is not None:
                activity.wait_state = "running"
            return self._execute_resilient(stmt, activity,
                                           timeout_ms=remaining_ms)
        finally:
            self.wlm.release(ticket)

    # -- the statement envelope --------------------------------------------
    def _execute_resilient(self, stmt: ast.Statement, activity=None,
                           timeout_ms=None):
        """One statement under the resilience envelope: a cooperative
        deadline (`statement_timeout_ms` + Session.cancel) around a
        bounded retry loop (`max_statement_retries`, exponential backoff
        with jitter) that classifies errors, marks failing placements
        suspect so the retry's routing fails over to surviving replicas,
        and runs 2PC recovery first so no retry observes half-applied
        state — the adaptive executor's task-retry/failover loop
        (adaptive_executor.c:95-116) hoisted to the statement level.
        DeviceMemoryExhausted walks the OOM degradation ladder instead
        (its own budget: the ladder's depth is a property of the shape,
        not a transient-fault allowance).  A returned ResultSet's
        `retries` adds this loop's retries and rungs to the executor's
        capacity retries (`envelope_retries` holds the added part).
        `activity` (the statement's ActivityEntry) shows the attempts
        live in citus_stat_activity.  Each attempt is an `execute`
        span; rungs and backoff waits are spans of their own.
        `timeout_ms=None` reads `statement_timeout_ms`; admission passes
        what its queue wait left of it."""
        import random as _random
        import traceback as _traceback

        from .errors import (
            DeviceLostError,
            DeviceMemoryExhausted,
            MeshDegradedError,
            PlacementLostError,
            QueryCanceled,
            ResourceExhausted,
            StaleMeshPlan,
            StatementTimeout,
        )
        from .utils.cancellation import check_cancel, deadline_scope

        max_retries = self.settings.get("max_statement_retries")
        if timeout_ms is None:
            timeout_ms = self.settings.get("statement_timeout_ms")
        attempt = 0
        oom_steps = 0  # statement-local position on the OOM ladder
        mesh_steps = 0  # statement-local device-loss failover count
        replans = 0  # plans found stale against a narrowed mesh
        rescued = False  # a mesh failover happened; counted on success
        width0 = self.n_devices  # bounds the failover budget
        self.last_oom_rungs = []
        with deadline_scope(timeout_ms or None,
                            self._cancel_evt) as deadline:
            while True:
                # a COMMIT that dies mid-2PC is resolved through
                # recovery, never re-execution — remember its txid now
                # (the manager clears `current` on the way out)
                commit_txid = None
                if isinstance(stmt, ast.TransactionStmt) and \
                        stmt.kind == "commit" and \
                        self.txn_manager.current is not None:
                    commit_txid = self.txn_manager.current.txid
                try:
                    check_cancel()
                    n_attempt = attempt + oom_steps + mesh_steps + replans
                    # first attempts (the steady state) skip the meta
                    espan = (trace_span("execute") if n_attempt == 0
                             else trace_span("execute", attempt=n_attempt))
                    with espan:
                        result = self._execute_statement(stmt)
                    if isinstance(result, ResultSet):
                        result.retries += n_attempt
                        result.envelope_retries = n_attempt
                    if rescued:
                        # answered because the mesh-degrade path rescued it
                        self.stats.counters.increment(
                            sc.QUERIES_RESCUED_TOTAL)
                    return result
                except (StatementTimeout, QueryCanceled) as e:
                    if commit_txid is not None and \
                            self._resolve_failed_commit(commit_txid):
                        # the deadline/cancel fired inside the 2PC with
                        # the commit record durable: the transaction IS
                        # committed (recovery just rolled it forward)
                        return None
                    self.stats.counters.increment(
                        sc.TIMEOUTS_TOTAL
                        if isinstance(e, StatementTimeout)
                        else sc.QUERIES_CANCELED)
                    raise
                except Exception as e:
                    if getattr(e, "injected_fault", False):
                        self.stats.counters.increment(
                            sc.FAULTS_INJECTED_TOTAL)
                    # device loss is retryable after a mesh degrade: mark
                    # the position suspect, rebuild the mesh from the
                    # survivors, re-plan through the node↔device map
                    # (replicated placements fail over) and re-run —
                    # ending in a clean MeshDegradedError when nothing
                    # survives or an unreplicated shard is stranded,
                    # never wrong rows.  Failovers ride their own budget
                    # (the mesh width).  A COMMIT dying mid-2PC resolves
                    # through recovery; COPY commits per batch, so a
                    # re-run would double-load: both fall through.
                    # a plan made for a width the mesh no longer has (a
                    # failover, drain or shrink between planning and
                    # running): no device was lost, so re-plan at the
                    # current width without counting one or probing
                    if isinstance(e, StaleMeshPlan) and \
                            commit_txid is None and \
                            not isinstance(stmt, ast.CopyFrom):
                        replans += 1
                        if replans > max(1, width0):
                            raise
                        continue
                    if isinstance(e, DeviceLostError) and \
                            commit_txid is None and \
                            not isinstance(stmt, ast.CopyFrom):
                        self.stats.counters.increment(sc.DEVICE_LOST_TOTAL)
                        did = getattr(e, "device_id", None)
                        if did is not None:
                            self.catalog.set_device_state(did, "suspect")
                        if isinstance(e, MeshDegradedError) or \
                                not self.settings.get("mesh_failover"):
                            raise
                        mesh_steps += 1
                        if mesh_steps > max(1, width0):
                            raise MeshDegradedError(
                                f"device-loss failover budget spent after "
                                f"{mesh_steps - 1} mesh degrade(s): {e}",
                                device_id=did, seam=e.seam) from e
                        _traceback.clear_frames(e.__traceback__)
                        with trace_span("mesh.degrade"):
                            status = self._degrade_mesh(e)
                        if status == "unsurvivable":
                            raise MeshDegradedError(
                                f"no surviving mesh position to fail over "
                                f"to: {e}", device_id=did,
                                seam=e.seam) from e
                        if status == "failover":
                            self.stats.counters.increment(
                                sc.MESH_FAILOVERS_TOTAL)
                            rescued = True
                        # 'transient': every position answered the probe
                        # (a link flap) — a bare re-run, same budget
                        if activity is not None:
                            activity.retries = (attempt + oom_steps
                                                + mesh_steps)
                        continue  # re-plan + re-run (deadline intact)
                    # an unroutable shard while positions are lost is the
                    # replication-1 terminal case of device loss
                    if isinstance(e, PlacementLostError) and \
                            self.catalog.dead_nodes():
                        raise MeshDegradedError(
                            "shard unroutable after device loss (its only "
                            "placement is on a lost position; "
                            "shard_replication_factor >= 2 would have "
                            f"failed over): {e}") from e
                    # device-memory exhaustion is retryable after
                    # degradation: each OOM applies the next rung of the
                    # ladder (evict caches → shrink stream batches →
                    # force streaming → multi-pass), then re-runs —
                    # ending in a clean ResourceExhausted when no rung
                    # can help.  A write's device SELECT half runs
                    # before any visibility flip, so the re-run is safe.
                    if isinstance(e, DeviceMemoryExhausted) and \
                            commit_txid is None:
                        self.stats.counters.increment(sc.OOM_EVENTS_TOTAL)
                        if not self.settings.get("oom_degradation"):
                            raise
                        # the failed attempt's finished frames hold its
                        # feeds: release them before the rung evicts
                        _traceback.clear_frames(e.__traceback__)
                        oom_steps += 1
                        with trace_span("oom.degrade", rung=oom_steps):
                            rung = self.executor.degrade_for_oom(
                                oom_steps, getattr(e, "nbytes", None))
                        if rung is None:
                            raise ResourceExhausted(
                                "statement does not fit device memory "
                                f"even after {oom_steps - 1} "
                                f"degradation rung(s): {e}") from e
                        self.last_oom_rungs.append(rung)
                        if activity is not None:
                            activity.retries = attempt + oom_steps
                        continue  # re-run degraded (deadline intact)
                    retryable = self._retryable_error(e)
                    # COPY commits each parsed batch on its own, so
                    # re-executing a partially ingested file would
                    # double-load the committed batches
                    if isinstance(stmt, ast.CopyFrom):
                        retryable = False
                    # max_statement_retries=0 switches the envelope off
                    # (crash semantics: the NEXT session's recovery
                    # pass resolves)
                    if commit_txid is not None and retryable and \
                            max_retries > 0:
                        if self._resolve_failed_commit(commit_txid):
                            return None  # recovery rolled it forward
                        raise  # rolled back: a clean, reported failure
                    if not retryable or attempt >= max_retries:
                        raise
                    attempt += 1
                    self.stats.counters.increment(sc.RETRIES_TOTAL)
                    if activity is not None:
                        activity.retries = attempt + oom_steps
                    self._mark_failover(e)
                    # retries must never observe half-applied state:
                    # finish any interrupted 2PC before re-executing
                    # (transaction_recovery.c at the retry boundary),
                    # deadline-free — an expired deadline must not abort
                    # the roll-forward
                    if self.txn_manager.current is None:
                        try:
                            with deadline_scope(None):
                                self.txn_manager.recover()
                        except Exception:  # noqa: BLE001 — recovery retries on the next pass
                            pass
                    base_s = self.settings.get(
                        "retry_backoff_base_ms") / 1000.0
                    cap_s = self.settings.get(
                        "retry_backoff_max_ms") / 1000.0
                    delay = base_s * (2 ** (attempt - 1))
                    delay *= 0.5 + _random.random()  # ±50% jitter
                    delay = min(cap_s, delay)  # cap AFTER jitter
                    rem = deadline.remaining()
                    if rem is not None:
                        delay = max(0.0, min(delay, rem))
                    if delay:
                        # waiting on the cancel event (not time.sleep)
                        # keeps Session.cancel() prompt mid-backoff
                        with trace_span("retry.backoff"):
                            self._cancel_evt.wait(delay)
                    # loop: the next check_cancel raises if the wait
                    # consumed the deadline or a cancel arrived

    def _retryable_error(self, e: BaseException) -> bool:
        """Transient ⇒ retry: injected faults (the killed-connection
        analogue), storage IO.  Semantic errors (parse / planning /
        catalog / capacity), cancellation and post-visibility faults
        are not."""
        from .errors import QueryCanceled, StorageError
        from .utils.faultinjection import InjectedFault

        if isinstance(e, QueryCanceled):
            return False
        # post-visibility failures (tagged by the seam itself, or known
        # by fault-point name): the effect is committed, a rerun would
        # double-apply
        if getattr(e, "post_visibility", False):
            return False
        if getattr(e, "fault_point", None) in _NON_RETRYABLE_POINTS:
            return False
        return isinstance(e, (InjectedFault, StorageError, OSError))

    def _degrade_mesh(self, e: BaseException) -> str:
        """Shrink this session's mesh around a lost position.  Returns
        'failover' (mesh rebuilt from the survivors, the lost position's
        nodes marked dead so replicated shards re-route), 'transient'
        (every position answered the probe: a bare re-run) or
        'unsurvivable' (no position survives).  The error names the lost
        position when its seam knew it; an opaque collective failure
        names none, so every position is probed.  The node↔device map
        is read BEFORE the nodes die: the lost positions' nodes are what
        must leave routing."""
        from .distributed.mesh import (
            mesh_device_ids,
            mesh_without,
            probe_mesh_devices,
        )

        ids = mesh_device_ids(self.mesh)
        did = getattr(e, "device_id", None)
        dead = [did] if did is not None else probe_mesh_devices(self.mesh)
        dead = [d for d in dead if d in set(ids)]
        if not dead:
            return "transient"
        dmap = self.catalog.node_device_map(self.n_devices)
        dead_pos = {i for i, d in enumerate(ids) if d in set(dead)}
        new_mesh = mesh_without(self.mesh, dead)
        for d in dead:
            self.catalog.set_device_state(d, "dead")
        if new_mesh is None:
            return "unsurvivable"
        for node_id, pos in dmap.items():
            if pos in dead_pos:
                self.catalog.mark_node_dead(node_id)
        self._adopt_mesh(new_mesh)
        return "failover"

    def _adopt_mesh(self, mesh) -> None:
        """Run later statements on `mesh` (a failover's survivors, a
        drained or a shrunk mesh)."""
        self.mesh = mesh
        self.n_devices = mesh.size
        self.executor.adopt_mesh(mesh)

    def _mark_failover(self, e: BaseException) -> None:
        """A failed shard read carries (table, shard_id): mark the
        placement it routed to suspect, so `catalog.active_placement`
        (and with it `store.stripe_read_path`) routes the retry to a
        surviving replica, and count the failover when one exists."""
        shard_id = getattr(e, "shard_id", None)
        if shard_id is None:
            return
        try:
            p = self.catalog.active_placement(shard_id)
        except Exception:  # noqa: BLE001 — no placement: a bare retry
            return
        if self.catalog.mark_placement_suspect(p.placement_id):
            self.stats.counters.increment(sc.FAILOVERS_TOTAL)

    def _resolve_failed_commit(self, txid: int) -> bool:
        """COMMIT died mid-2PC: resolve by the recovery rule instead of
        re-executing (the transaction state is already torn down).
        Commit record durable → roll the prepared transaction forward
        (the idempotent apply replays safely over a partial first
        apply) and the statement SUCCEEDS; no record → recovery
        discards the prepare and the original error propagates.
        Returns True when rolled forward (transaction_recovery.c's
        rule)."""
        from .utils.cancellation import deadline_scope

        had_commit_record = self.txn_manager.has_commit_record(txid)
        try:
            # deadline-free: an expired statement deadline must not
            # abort the roll-forward mid-apply
            with deadline_scope(None):
                self.txn_manager.recover()
        except Exception:  # noqa: BLE001 — unresolved: the caller re-raises the original error
            return False
        return had_commit_record

    def change_events(self, table: str | None = None,
                      from_lsn: int = 0) -> list[dict]:
        """Committed logical changes with lsn > from_lsn (the change-feed
        subscription read)."""
        return self.store.change_log.read(table, from_lsn)

    def change_rows(self, event: dict):
        """Materialize one event's row payload: (values, validity)."""
        from .cdc.feed import rows_for

        return rows_for(self.store, event)

    # -- replication -------------------------------------------------------
    def promote_replica(self) -> int:
        """Promote this follower data_dir to leader (leader-death
        failover): roll the shipped journal forward, bump the fencing
        epoch (stamping the old leader's dir so its late ships are
        refused), flip the role record, then run 2PC recovery and the
        cleanup sweep through this session's own managers and adopt the
        rolled-forward catalog.  Returns the new epoch; this session
        accepts writes from its next statement on."""
        from .replication import promote

        epoch = promote(self.data_dir, counters=self.stats.counters,
                        store=self.store)
        self.txn_manager.recover()
        cleanup_registry_for(self.data_dir).sweep(self.store, self.catalog)
        self.catalog.maybe_reload(os.path.join(self.data_dir,
                                               "catalog.json"))
        return epoch

    def _replica_gate(self, stmt: ast.Statement) -> None:
        """Follower-session statement gate: refuse writes cleanly, then
        drain any shipped batches and bound the visible staleness before
        a read plans (replication/applier.ensure_fresh)."""
        if not self.replication.is_follower():
            return
        from .errors import ReadOnlyReplica
        from .replication import ensure_fresh

        if isinstance(stmt, _REPLICA_WRITE_STMTS):
            raise ReadOnlyReplica(
                f"cannot execute {type(stmt).__name__} on a read "
                "replica — writes belong on the leader "
                f"({(self.replication.state() or {}).get('leader_dir')})")
        if isinstance(stmt, ast.Select) and not stmt.from_items and \
                len(stmt.items) == 1 and \
                isinstance(stmt.items[0].expr, ast.FuncCall) and \
                stmt.items[0].expr.name in _REPLICA_WRITE_UDFS:
            raise ReadOnlyReplica(
                f"cannot execute {stmt.items[0].expr.name}() on a read "
                "replica — cluster mutations belong on the leader")
        fresh = ensure_fresh(
            self.data_dir, self.settings.get("replica_max_staleness_lsn"),
            counters=self.stats.counters, store=self.store)
        self._replica_stale_tls.last = fresh
        # an applied batch may have shipped DDL: adopt the leader's
        # catalog before planning (never mid-transaction)
        if fresh["applied"] and self.txn_manager.current is None:
            self.catalog.maybe_reload(
                os.path.join(self.data_dir, "catalog.json"))

    def _execute_statement(self, stmt: ast.Statement):
        self._replica_gate(stmt)
        if isinstance(stmt, ast.Select):
            udf = self._try_udf(stmt)
            if udf is not None:
                return udf
            return self._execute_select(stmt)
        if isinstance(stmt, ast.SetOp):
            return self._execute_setop(stmt)
        if isinstance(stmt, ast.CreateTable):
            return self._execute_create_table(stmt)
        if isinstance(stmt, ast.CreateSequence):
            self.catalog.create_sequence(stmt.name, stmt.start,
                                         stmt.increment)
            self._save_catalog()
            return None
        if isinstance(stmt, ast.DropSequence):
            self.catalog.drop_sequence(stmt.name, stmt.if_exists)
            self._save_catalog()
            return None
        if isinstance(stmt, ast.CreateView):
            # validate the body against the current catalog before
            # persisting (parse already checked syntax)
            body = parse(stmt.sql)[0]
            if not isinstance(body, (ast.Select, ast.SetOp)):
                raise PlanningError("a view body must be a SELECT")
            if stmt.columns and isinstance(body, ast.Select) and \
                    len(stmt.columns) != len(body.items):
                raise PlanningError(
                    f"view {stmt.name!r} declares {len(stmt.columns)} "
                    f"columns but its SELECT has {len(body.items)}")
            self.catalog.create_view(stmt.name, stmt.sql, stmt.columns,
                                     stmt.or_replace)
            self._save_catalog()
            return None
        if isinstance(stmt, ast.DropView):
            self.catalog.drop_view(stmt.name, stmt.if_exists)
            self._save_catalog()
            return None
        if isinstance(stmt, ast.AlterTable):
            return self._execute_alter_table(stmt)
        if isinstance(stmt, ast.DropTable):
            return self._execute_drop_table(stmt)
        if isinstance(stmt, ast.InsertValues):
            return self._execute_insert_values(stmt)
        if isinstance(stmt, ast.InsertSelect):
            return self._execute_insert_select(stmt)
        if isinstance(stmt, (ast.Update, ast.Delete, ast.Merge)):
            return self._execute_dml(stmt)
        if isinstance(stmt, ast.CopyFrom):
            from .ingest.copy_from import copy_from

            return copy_from(self, stmt)
        if isinstance(stmt, ast.TransactionStmt):
            return self._execute_transaction_stmt(stmt)
        if isinstance(stmt, ast.Explain):
            return self._execute_explain(stmt)
        if isinstance(stmt, ast.Prepare):
            if stmt.name in self._prepared:  # PG raises here too
                raise PlanningError(
                    f"prepared statement {stmt.name!r} already exists")
            self._prepared[stmt.name] = stmt.statement
            return None
        if isinstance(stmt, ast.ExecutePrepared):
            return self._execute_prepared(stmt)
        if isinstance(stmt, ast.Deallocate):
            if stmt.name == "all":
                self._prepared.clear()
            elif self._prepared.pop(stmt.name, None) is None:
                raise PlanningError(
                    f"prepared statement {stmt.name!r} does not exist")
            return None
        if isinstance(stmt, ast.SetVariable):
            self.settings.set(stmt.name, stmt.value)
            return None
        if isinstance(stmt, ast.ShowVariable):
            if stmt.name == "all":
                items = sorted(self.settings.show_all().items())
                return ResultSet(["name", "setting"],
                                 {"name": [k for k, _ in items],
                                  "setting": [str(v) for _, v in items]},
                                 len(items))
            return ResultSet(["setting"],
                             {"setting": [str(self.settings.get(
                                 stmt.name))]}, 1)
        raise UnsupportedQueryError(
            f"{type(stmt).__name__} is not in this port yet")

    # -- UDF surface -------------------------------------------------------
    def _try_udf(self, sel: ast.Select):
        """`SELECT udf(literal, ...)` without FROM → the catalog UDF's
        ResultSet; None when the statement is no UDF call."""
        if sel.from_items or len(sel.items) != 1:
            return None
        e = sel.items[0].expr
        if not isinstance(e, ast.FuncCall):
            return None
        if e.name in _UNPORTED_UDFS:
            raise UnsupportedQueryError(
                f"{e.name}() is not in this port yet: it comes with "
                f"{_UNPORTED_UDFS[e.name]}")
        if e.name not in _UDFS:
            return None
        args = []
        for a in e.args:
            if not isinstance(a, ast.Literal):
                raise PlanningError(f"{e.name}: arguments must be literals")
            args.append(a.value)
        if e.name == "create_distributed_table":
            shard_count = int(args[2]) if len(args) > 2 else None
            self.create_distributed_table(str(args[0]), str(args[1]),
                                          shard_count)
        elif e.name == "create_reference_table":
            self.create_reference_table(str(args[0]))
        elif e.name in ("citus_add_node", "citus_remove_node",
                        "citus_disable_node", "citus_activate_node"):
            op = {"citus_add_node": self.catalog.add_node,
                  "citus_remove_node": self.catalog.remove_node,
                  "citus_disable_node": self.catalog.disable_node,
                  "citus_activate_node": self.catalog.activate_node}
            op[e.name](str(args[0]))
            self._save_catalog()
        elif e.name == "nextval":
            v, _inc = self.catalog.sequence_nextval(str(args[0]))
            self._save_catalog()
            return ResultSet(["nextval"], {"nextval": [v]}, 1)
        elif e.name == "currval":
            v = self.catalog.sequence_currval(str(args[0]))
            return ResultSet(["currval"], {"currval": [v]}, 1)
        elif e.name == "citus_get_node_clock":
            from .transaction.clock import global_clock

            return ResultSet(["clock"], {"clock": [global_clock.now()]}, 1)
        elif e.name == "citus_change_feed":
            table = str(args[0]) if args else None
            from_lsn = int(args[1]) if len(args) > 1 else 0
            events = self.change_events(table, from_lsn)
            return ResultSet(
                ["lsn", "kind", "shard_id", "file", "rows"],
                {"lsn": [ev["lsn"] for ev in events],
                 "kind": [ev["kind"] for ev in events],
                 "shard_id": [ev["shard_id"] for ev in events],
                 "file": [ev["file"] for ev in events],
                 "rows": [ev.get("rows", ev.get("count", 0))
                          for ev in events]}, len(events))
        elif e.name == "citus_tables":
            names = sorted(self.catalog.tables)
            kinds, dcols, colo, sizes, shards = [], [], [], [], []
            for t in names:
                m = self.catalog.table(t)
                kinds.append(m.method.value)
                dcols.append(m.distribution_column or "")
                colo.append(m.colocation_id)
                tshards = self.catalog.table_shards(t)
                shards.append(len(tshards))
                sizes.append(sum(
                    self.store.shard_size_bytes(t, s.shard_id)
                    for s in tshards))
            return ResultSet(
                ["table_name", "citus_table_type", "distribution_column",
                 "colocation_id", "shard_count", "table_size_bytes"],
                {"table_name": names, "citus_table_type": kinds,
                 "distribution_column": dcols, "colocation_id": colo,
                 "shard_count": shards, "table_size_bytes": sizes},
                len(names))
        elif e.name == "citus_shards":
            rows: list[tuple] = []
            tables = ([str(args[0])] if args
                      else sorted(self.catalog.tables))
            for t in tables:
                for s in self.catalog.table_shards(t):
                    p = self.catalog.active_placement(s.shard_id)
                    rows.append((
                        t, s.shard_id, s.min_value, s.max_value,
                        f"device:{p.node_id}" if p else "",
                        self.store.shard_size_bytes(t, s.shard_id),
                        self.store.shard_row_count(t, s.shard_id)))
            cols = list(zip(*rows)) if rows else [[]] * 7
            return ResultSet(
                ["table_name", "shard_id", "min_value", "max_value",
                 "node", "size_bytes", "live_rows"],
                {"table_name": list(cols[0]), "shard_id": list(cols[1]),
                 "min_value": list(cols[2]), "max_value": list(cols[3]),
                 "node": list(cols[4]), "size_bytes": list(cols[5]),
                 "live_rows": list(cols[6])}, len(rows))
        elif e.name.startswith("citus_stat_") and \
                e.name != "citus_stat_mesh":
            return self._stat_udf(e.name)
        elif e.name == "citus_replication_ship":
            # leader side: stage one batch for every registered follower
            from .replication import ship_all

            srows = ship_all(self.data_dir, counters=self.stats.counters)
            cols = {"follower": [r["follower"] for r in srows],
                    "status": [r["status"] for r in srows],
                    "batch_seq": [r.get("batch_seq", 0) for r in srows],
                    "files": [r.get("files", 0) for r in srows],
                    "bytes": [r.get("bytes", 0) for r in srows]}
            return ResultSet(list(cols), cols, len(srows))
        elif e.name == "citus_promote_replica":
            return ResultSet(["epoch"], {"epoch": [self.promote_replica()]},
                             1)
        elif e.name == "citus_check_cluster_node_health":
            # health_check.c analogue: one probe row per node (device +
            # storage reachability from the controller)
            from .operations.health import check_cluster_health

            hrows = check_cluster_health(self)
            return ResultSet(
                ["node_name", "is_active", "healthy"],
                {"node_name": [r[0] for r in hrows],
                 "is_active": [r[1] for r in hrows],
                 "healthy": [r[2] for r in hrows]}, len(hrows))
        elif e.name == "citus_promote_node":
            # node_promotion.c analogue: demote a dead node's placements
            # so every shard's surviving replica becomes its primary
            from .operations.health import promote_node_replicas

            n = promote_node_replicas(self, str(args[0]))
            return ResultSet(["placements_demoted"],
                             {"placements_demoted": [n]}, 1)
        else:
            return self._operations_udf(e.name, args)
        return ResultSet(["ok"], {"ok": [True]}, 1)

    def _mesh_udf(self, name: str, args: list):
        """citus_stat_mesh (the mesh's width, the node↔device map, each
        position's health, the all_to_all volume and the per-position
        memory ledger), citus_rebalance_mesh (fit the node set to the
        mesh width and spread the placements) and citus_drain_device(i)
        (empty position i and take its nodes out of rotation)."""
        import json as _json

        if name == "citus_stat_mesh":
            by_dev = self.executor.accountant.live_bytes_by_device()
            dmap = self.catalog.node_device_map(self.n_devices)
            csnap = self.stats.counters.snapshot()
            # per-position health (active | suspect | draining | dead);
            # ids outside this session's (possibly shrunken) mesh with no
            # recorded state show as 'unused'
            ledger = self.catalog.device_states()
            in_mesh = set(self.mesh.ids)
            states = {d: ledger.get(d, "active" if d in in_mesh
                                    else "unused")
                      for d in sorted(in_mesh | set(ledger))}
            cols = {
                "devices": self.n_devices,
                "platform": self.device.type,
                "nodes": len(self.catalog.active_nodes()),
                "dead_nodes": len(self.catalog.dead_nodes()),
                "node_device_map": _json.dumps(
                    {str(k): v for k, v in sorted(dmap.items())}),
                "device_states": _json.dumps(
                    {str(k): v for k, v in sorted(states.items())}),
                "shuffle_bytes_total": csnap.get(sc.SHUFFLE_BYTES_TOTAL, 0),
                "device_lost_total": csnap.get(sc.DEVICE_LOST_TOTAL, 0),
                "mesh_failovers_total": csnap.get(
                    sc.MESH_FAILOVERS_TOTAL, 0),
                "queries_rescued_total": csnap.get(
                    sc.QUERIES_RESCUED_TOTAL, 0),
                "live_bytes_by_device": _json.dumps(by_dev),
                "live_bytes_hot_device": max(by_dev, default=0),
            }
            return ResultSet(list(cols),
                             {k: [v] for k, v in cols.items()}, 1)
        if name == "citus_rebalance_mesh":
            from .operations.rebalancer import rebalance_mesh

            added, moves = rebalance_mesh(
                self.catalog, self.store, self.n_devices,
                self.settings.get("rebalance_threshold"),
                progress=self.stats.progress)
            self._save_catalog()
            return ResultSet(["nodes_added", "shards_moved"],
                             {"nodes_added": [len(added)],
                              "shards_moved": [len(moves)]}, 1)
        from .operations.rebalancer import drain_device

        moved, drained = drain_device(self, int(args[0]))
        self._save_catalog()
        return ResultSet(["placements_moved", "nodes_drained"],
                         {"placements_moved": [moved],
                          "nodes_drained": [drained]}, 1)

    def _operations_udf(self, name: str, args: list):
        """The shard operations, job, integrity and mesh UDFs
        (operations/, background/), with the JAX package's arguments and
        columns."""
        if name in ("citus_stat_mesh", "citus_rebalance_mesh",
                    "citus_drain_device"):
            return self._mesh_udf(name, args)
        if name == "rebalance_table_shards":
            from .operations.rebalancer import rebalance_table_shards

            moves = rebalance_table_shards(
                self.catalog, self.store,
                self.settings.get("rebalance_threshold"),
                self.settings.get("rebalance_improvement_threshold"),
                progress=self.stats.progress)
            self._save_catalog()
            return ResultSet(["moves"], {"moves": [len(moves)]}, 1)
        if name == "citus_move_shard_placement":
            from .operations.shard_transfer import move_shard_placement

            move_shard_placement(self.catalog, self.store, int(args[0]),
                                 str(args[1]))
            self._save_catalog()
        elif name == "citus_split_shard_by_split_points":
            from .operations.shard_split import split_shard_by_split_points

            points = [int(p) for p in str(args[1]).split(",")]
            children = split_shard_by_split_points(self, int(args[0]),
                                                   points)
            return ResultSet(["new_shard_ids"],
                             {"new_shard_ids":
                              [",".join(map(str, children))]}, 1)
        elif name == "isolate_tenant_to_node":
            from .operations.shard_split import isolate_tenant_to_node

            sid = isolate_tenant_to_node(self, str(args[0]), args[1])
            return ResultSet(["shard_id"], {"shard_id": [sid]}, 1)
        elif name == "citus_cleanup_orphaned_resources":
            n = cleanup_registry_for(self.data_dir).sweep(self.store,
                                                           self.catalog)
            return ResultSet(["cleaned"], {"cleaned": [n]}, 1)
        elif name == "citus_rebalance_start":
            job_id = self._start_background_rebalance()
            return ResultSet(["job_id"], {"job_id": [job_id]}, 1)
        elif name in ("citus_rebalance_wait", "citus_job_wait"):
            job_id = int(args[0]) if args else self._last_rebalance_job
            if job_id == 0:  # nothing was scheduled (already balanced)
                return ResultSet(["status"], {"status": ["done"]}, 1)
            status = self.jobs.wait(job_id)
            return ResultSet(["status"], {"status": [status.value]}, 1)
        elif name == "citus_job_cancel":
            self.jobs.cancel(int(args[0]))
        elif name == "citus_job_list":
            jobs = self.jobs.jobs()
            return ResultSet(
                ["job_id", "description", "status", "tasks"],
                {"job_id": [j.job_id for j in jobs],
                 "description": [j.description for j in jobs],
                 "status": [j.status.value for j in jobs],
                 "tasks": [len(j.tasks) for j in jobs]}, len(jobs))
        elif name == "get_rebalance_progress":
            mons = self.stats.progress.all()
            return ResultSet(
                ["operation", "target", "progress", "total", "detail"],
                {"operation": [m.operation for m in mons],
                 "target": [m.target for m in mons],
                 "progress": [m.done_steps for m in mons],
                 "total": [m.total_steps for m in mons],
                 "detail": [m.detail for m in mons]}, len(mons))
        elif name == "citus_create_restore_point":
            from .operations.restore_point import create_restore_point

            rp = create_restore_point(self, str(args[0]))
            return ResultSet(["restore_point"], {"restore_point": [rp]}, 1)
        elif name == "citus_check_cluster":
            # the storage scrub as a background job: verify every
            # placement copy, quarantine + re-replicate corrupt ones,
            # GC crash debris.  Optional argument: the temp-file age
            # floor in seconds (default scrub_temp_max_age_s)
            from .operations.scrubber import scrub_session

            rep = scrub_session(
                self, temp_max_age_s=float(args[0]) if args else None)
            cols = ("stripes_verified", "masks_verified",
                    "corrupt_copies", "quarantined", "repaired",
                    "unrepairable", "temps_removed",
                    "replica_dirs_removed")
            return ResultSet(list(cols),
                             {c: [getattr(rep, c)] for c in cols}, 1)
        return ResultSet(["ok"], {"ok": [True]}, 1)

    def _start_background_rebalance(self) -> int:
        """citus_rebalance_start: plan the moves and run them as a
        dependency-chained background job with live progress
        (get_rebalance_progress).  Returns the job id, 0 when the
        cluster is already balanced."""
        from .operations.rebalancer import plan_rebalance
        from .operations.shard_transfer import move_shard_placement

        moves = plan_rebalance(
            self.catalog, self.store,
            self.settings.get("rebalance_threshold"),
            self.settings.get("rebalance_improvement_threshold"))
        if not moves:
            return 0
        mon = self.stats.progress.create("rebalance", "background",
                                         len(moves))

        def make_move(mv):
            def run():
                target = self.catalog.nodes[mv.target_node]
                move_shard_placement(self.catalog, self.store,
                                     mv.shard_id, target.name)
                self._save_catalog()
                mon.advance(1, f"moved shard {mv.shard_id}")
            return run

        # parallel across nodes under a per-node concurrency cap of 1: a
        # move depends only on the LAST earlier move touching either of
        # its nodes (mv.source_node is the planner's simulated source,
        # right even when one group moves twice in a plan)
        tasks = []
        last_on_node: dict[int, int] = {}
        for i, mv in enumerate(moves):
            deps = sorted({last_on_node[n]
                           for n in (mv.source_node, mv.target_node)
                           if n in last_on_node})
            tasks.append((make_move(mv), f"move shard {mv.shard_id}",
                          deps))
            last_on_node[mv.source_node] = i
            last_on_node[mv.target_node] = i
        tasks.append((mon.finish, "finalize", list(range(len(moves)))))
        job_id = self.jobs.submit_job("rebalance", tasks)
        self._last_rebalance_job = job_id
        return job_id

    def _stat_udf(self, name: str):
        """The citus_stat_* UDFs (the JAX package's columns); the
        *_reset ones answer like any admin UDF."""
        st = self.stats
        if name == "citus_stat_counters":
            snap = st.counters.snapshot()
            names = sorted(sc.ALL_COUNTERS)
            return ResultSet(["name", "value"],
                             {"name": names,
                              "value": [snap[n] for n in names]}, len(names))
        if name == "citus_stat_statements":
            entries = st.queries.entries()
            return ResultSet(
                ["query", "calls", "total_time_ms", "rows"],
                {"query": [q.query for q in entries],
                 "calls": [q.calls for q in entries],
                 "total_time_ms": [round(q.total_time_ms, 3)
                                   for q in entries],
                 "rows": [q.rows for q in entries]}, len(entries))
        if name == "citus_stat_latency":
            # per-statement-class DDSketch histograms of the recorder
            lrows = st.tracing.latency_rows()
            lcols = ["statement_class", "calls", "mean_ms", "p50_ms",
                     "p95_ms", "p99_ms", "max_ms"]
            return ResultSet(
                lcols, {c: [r[c] for r in lrows] for c in lcols},
                len(lrows))
        if name == "citus_stat_tenants":
            entries = st.tenants.entries()
            return ResultSet(
                ["table_name", "tenant_attribute", "query_count",
                 "total_time_ms"],
                {"table_name": [t.table for t in entries],
                 "tenant_attribute": [t.tenant for t in entries],
                 "query_count": [t.query_count for t in entries],
                 "total_time_ms": [round(t.total_time_ms, 3)
                                   for t in entries]}, len(entries))
        if name == "citus_stat_activity":
            return self._stat_activity()
        if name == "citus_stat_memory":
            return self._stat_memory()
        if name == "citus_stat_wlm":
            return self._stat_wlm()
        if name == "citus_stat_serving":
            return self._stat_serving()
        if name == "citus_stat_replication":
            return self._stat_replication()
        reset = {"citus_stat_counters_reset": st.counters.reset,
                 "citus_stat_statements_reset": st.queries.reset,
                 "citus_stat_latency_reset": st.tracing.reset_latency}
        reset[name]()
        return ResultSet(["ok"], {"ok": [True]}, 1)

    def _stat_activity(self):
        entries = self.stats.activity.entries()
        # per-statement cache activity: live executor totals minus the
        # snapshot taken when the statement started
        ex = self.executor
        live = (ex.plan_cache.hits, ex.plan_cache.misses,
                ex.feed_cache.hits, ex.feed_cache.misses)

        def delta(a, i):
            if a.cache_base is None:
                return 0
            return max(0, live[i] - a.cache_base[i])

        # live/peak device bytes are the data_dir-shared accountant's
        # ledger at snapshot time (repeated per row)
        hbm_live = ex.accountant.live_bytes()
        hbm_peak = ex.accountant.peak_bytes
        return ResultSet(
            ["global_pid", "query", "state", "wait_state",
             "queued_ms", "retries", "read_repairs",
             "plan_cache_hits", "plan_cache_misses",
             "feed_cache_hits", "feed_cache_misses",
             "hbm_live_bytes", "hbm_peak_bytes"],
            {"global_pid": [a.gpid for a in entries],
             "query": [a.query for a in entries],
             "state": [a.state for a in entries],
             "wait_state": [a.wait_state for a in entries],
             "queued_ms": [round(a.queued_ms, 3) for a in entries],
             "retries": [a.retries for a in entries],
             "read_repairs": [a.read_repairs for a in entries],
             "plan_cache_hits": [delta(a, 0) for a in entries],
             "plan_cache_misses": [delta(a, 1) for a in entries],
             "feed_cache_hits": [delta(a, 2) for a in entries],
             "feed_cache_misses": [delta(a, 3) for a in entries],
             "hbm_live_bytes": [hbm_live] * len(entries),
             "hbm_peak_bytes": [hbm_peak] * len(entries)},
            len(entries))

    def _stat_wlm(self):
        """The shared gate's occupancy and one row per (priority class,
        tenant) it has seen (the JAX package's columns)."""
        snap = self.wlm.snapshot()
        rows = snap["tenants"] or [
            {"priority": "*", "tenant": "*", "queued": 0, "running": 0,
             "admitted_total": 0, "shed_total": 0, "weight": 0}]
        cols = {c: [r[c] for r in rows]
                for c in ("priority", "tenant", "queued", "running",
                          "admitted_total", "shed_total", "weight")}
        for c in ("slots_in_use", "slots_total", "feed_bytes_admitted",
                  "requests_total", "timedout_total", "canceled_total",
                  "queue_wait_ms_total"):
            cols[c] = [snap[c]] * len(rows)
        return ResultSet(list(cols), cols, len(rows))

    def _stat_serving(self):
        """One row: the shared micro-batcher's ledger and the result
        cache's traffic for this data_dir."""
        from .serving.batcher import batcher_for
        from .serving.result_cache import result_cache_for

        b = batcher_for(self.data_dir).snapshot()
        c = result_cache_for(self.data_dir).snapshot()
        cols = {k: b[k] for k in (
            "requests_total", "answered_total", "errored_total",
            "fallback_total", "batch_dispatch_total",
            "batched_lookups_total", "max_batch_seen",
            "avg_batch_occupancy", "queue_depth")}
        cols.update({
            "cache_entries": c["entries"], "cache_bytes": c["bytes"],
            "cache_hits_total": c["hits_total"],
            "cache_misses_total": c["misses_total"],
            "cache_invalidations_total": c["invalidations_total"],
            "cache_last_lsn": c["last_lsn"]})
        return ResultSet(list(cols), {k: [v] for k, v in cols.items()}, 1)

    def _stat_replication(self):
        """Per-peer lag in lsns and bytes: a leader reports one row per
        registered follower, a follower one row about its own cursor
        against its leader's journal tail."""
        from .replication import journal_tail_lsn, load_cursor, staleness

        state = self.replication.state()
        out = {c: [] for c in ("peer", "peer_role", "applied_lsn",
                               "leader_lsn", "lag_lsn", "lag_bytes",
                               "epoch")}

        def row(peer, role, applied, leader, lag_l, lag_b, epoch):
            for c, v in zip(out, (peer, role, applied, leader, lag_l,
                                  lag_b, epoch)):
                out[c].append(v)

        if state and state.get("role") == "leader":
            leader_lsn = journal_tail_lsn(self.data_dir)
            try:
                jbytes = os.path.getsize(os.path.join(
                    self.data_dir, "cdc_changes.jsonl"))
            except OSError:
                jbytes = 0
            for fdir in state.get("followers", []):
                cur = load_cursor(fdir)
                a = int(cur["applied_lsn"]) if cur else 0
                fb = int(cur["journal_size"]) if cur else 0
                row(fdir, "follower", a, leader_lsn,
                    max(0, leader_lsn - a), max(0, jbytes - fb),
                    int(cur["epoch"]) if cur else int(state["epoch"]))
        elif state and state.get("role") == "follower":
            st = staleness(self.data_dir)
            cur = load_cursor(self.data_dir)
            row(st["leader_dir"] or "", "leader", st["applied_lsn"],
                st["leader_lsn"], st["lag_lsn"], st["lag_bytes"],
                int(cur["epoch"]) if cur else int(state["epoch"]))
        return ResultSet(list(out), out, len(out["peer"]))

    def _stat_memory(self):
        """Device-memory snapshot: the shared accountant's ledger, this
        executor's degradation state, and the CUDA allocator's own
        stats (none on a CPU session)."""
        from .executor.hbm import DeviceMemoryAccountant

        acc = self.executor.accountant
        csnap = self.stats.counters.snapshot()
        dev = DeviceMemoryAccountant.device_memory_stats(self.device)
        cols = dict(acc.snapshot())
        cols["budget_bytes"] = acc.budget_bytes(self.device, self.settings)
        for c in (sc.OOM_EVENTS_TOTAL, sc.CACHE_EVICTIONS_TOTAL,
                  sc.STREAM_BATCH_SHRINKS_TOTAL, sc.SPILL_PASSES_TOTAL):
            cols[c] = csnap.get(c, 0)
        oom = self.executor.oom
        cols["degradation_batch_shrink"] = oom.batch_shrink
        cols["degradation_force_stream"] = oom.force_stream
        cols["degradation_multipass_k"] = oom.multipass_k
        cols["device_bytes_in_use"] = (
            sum(d["bytes_in_use"] for d in dev) if dev else None)
        cols["device_bytes_limit"] = (
            min(d["bytes_limit"] for d in dev) if dev else None)
        return ResultSet(list(cols), {k: [v] for k, v in cols.items()}, 1)

    def create_distributed_table(self, name: str, distribution_column: str,
                                 shard_count: int | None = None,
                                 colocate_with: str | None = None):
        """Convert a (created, still-empty) table into a hash-distributed
        one (commands/create_distributed_table.c:222 analogue)."""
        meta = self.catalog.table(name)
        if self.store.table_row_count(name) > 0:
            raise CatalogError(
                f"table {name!r} already contains data; distribute before "
                "loading")
        schema = meta.schema
        self.catalog.drop_table(name)
        self.catalog.create_distributed_table(
            name, schema, distribution_column,
            shard_count or self.settings.get("shard_count"),
            colocate_with=colocate_with,
            replication_factor=self.settings.get(
                "shard_replication_factor"))
        self._save_catalog()

    def create_reference_table(self, name: str):
        meta = self.catalog.table(name)
        if self.store.table_row_count(name) > 0:
            raise CatalogError(f"table {name!r} already contains data")
        schema = meta.schema
        self.catalog.drop_table(name)
        self.catalog.create_reference_table(name, schema)
        self._save_catalog()

    def close(self):
        if self._warmup_thread is not None:
            self._warmup_stop.set()  # stop between entries
            self._warmup_thread.join(timeout=30.0)
            self._warmup_thread = None
        self.maintenance.stop()
        self.jobs.shutdown()
        self._save_catalog()
        # drain debounced warm-start persistence (the caps memo, the
        # persisted cache's hotness index) so a clean shutdown leaves
        # the restart state current on disk
        self.executor.flush_persistent()
        # this session's hold on its captured graphs: a graph no other
        # session replays frees its pool now, not at garbage collection
        self.executor.plan_cache.clear()
        # give back this session's reference on the shared result
        # cache: the last one out drops the data_dir's cached results
        with self._result_cache_mu:
            handle, self._result_cache_handle = \
                self._result_cache_handle, None
        if handle is not None:
            from .serving.result_cache import release_result_cache

            release_result_cache(self.data_dir)

    # ------------------------------------------------------------------
    def _execute_create_table(self, stmt: ast.CreateTable):
        if self.catalog.has_table(stmt.name):
            if stmt.if_not_exists:
                return None
            raise CatalogError(f"table {stmt.name!r} already exists")
        cols = tuple(ColumnDef(c.name, sql_type_to_datatype(c.type_name),
                               nullable=not c.not_null)
                     for c in stmt.columns)
        self.catalog.create_local_table(stmt.name, TableSchema(cols))
        self._save_catalog()
        return None

    def _execute_alter_table(self, stmt: ast.AlterTable):
        """ALTER TABLE ADD/DROP/RENAME COLUMN as manifest-level schema
        evolution, as the JAX package does it (either package reads the
        other's): stripes are immutable; columns added later read as
        NULL from older stripes, dropped columns leave the schema and
        their storage name is retired."""
        meta = self.catalog.table(stmt.table)
        schema = meta.schema
        if stmt.action == "add_column":
            if schema.has_column(stmt.column.name):
                if stmt.if_not_exists:
                    return None
                raise CatalogError(
                    f"column {stmt.column.name!r} already exists")
            new_col = ColumnDef(stmt.column.name,
                                sql_type_to_datatype(stmt.column.type_name),
                                nullable=not stmt.column.not_null)
            if stmt.column.not_null and \
                    self.store.table_row_count(stmt.table) > 0:
                raise CatalogError(
                    "cannot add a NOT NULL column to a non-empty table "
                    "(existing rows would hold NULL)")
            # never resurrect a dropped/renamed-away column's on-disk
            # data under the new name
            self.store.register_column(stmt.table, new_col.name)
            new_schema = TableSchema(schema.columns + (new_col,))
        elif stmt.action == "drop_column":
            if not schema.has_column(stmt.column_name):
                if stmt.if_exists:
                    return None
                raise CatalogError(
                    f"column {stmt.column_name!r} does not exist")
            if meta.method == DistributionMethod.HASH and \
                    stmt.column_name == meta.distribution_column:
                raise CatalogError(
                    "cannot drop the distribution column")
            new_schema = TableSchema(tuple(
                c for c in schema.columns if c.name != stmt.column_name))
            if not new_schema.columns:
                raise CatalogError("cannot drop the last column")
            self.store.retire_column(stmt.table, stmt.column_name)
        elif stmt.action == "rename_column":
            if not schema.has_column(stmt.column_name):
                raise CatalogError(
                    f"column {stmt.column_name!r} does not exist")
            if schema.has_column(stmt.new_name):
                raise CatalogError(
                    f"column {stmt.new_name!r} already exists")
            if meta.method == DistributionMethod.HASH and \
                    stmt.column_name == meta.distribution_column:
                meta.distribution_column = stmt.new_name
            new_schema = TableSchema(tuple(
                ColumnDef(stmt.new_name if c.name == stmt.column_name
                          else c.name, c.dtype, nullable=c.nullable)
                for c in schema.columns))
            # stripes keep the old on-disk name; the store records the
            # mapping so reads translate
            self.store.rename_column(stmt.table, stmt.column_name,
                                     stmt.new_name)
        else:
            raise UnsupportedQueryError(
                f"ALTER TABLE {stmt.action} is not supported")
        meta.schema = new_schema
        self.catalog._bump()
        self.store.bump_data_version(stmt.table)
        self.executor.feed_cache.invalidate_table(stmt.table)
        self._save_catalog()
        self.stats.counters.increment(sc.DDL_COMMANDS)
        return None

    def _execute_drop_table(self, stmt: ast.DropTable):
        if not self.catalog.has_table(stmt.name):
            if stmt.if_exists:
                return None
            raise CatalogError(f"table {stmt.name!r} does not exist")
        self.catalog.drop_table(stmt.name)
        self.store.drop_table_storage(stmt.name)
        self.executor.feed_cache.invalidate_table(stmt.name)
        self._save_catalog()
        return None

    # -- transactions and DML -------------------------------------------
    def _execute_transaction_stmt(self, stmt: ast.TransactionStmt):
        if stmt.kind == "begin":
            self.txn_manager.begin()
            return None
        txn = self.txn_manager.current
        txid = txn.txid if txn is not None else None
        try:
            if stmt.kind == "commit":
                self.txn_manager.commit()
            else:
                self.txn_manager.rollback()
        finally:
            if txid is not None:
                self.locks.release_all(txid)
        return None

    def _apply_dml(self, table: str, deletes, pending) -> None:
        """Route a DML effect set: stage into the open transaction
        (visible via the read overlay, durable at COMMIT) or apply
        immediately in autocommit (one manifest flip, which bumps the
        table's data version: the feed cache misses from then on)."""
        txn = self.txn_manager.current
        if txn is not None:
            txn.stage_dml(table, deletes, list(pending))
        else:
            self.store.apply_dml(table, deletes, list(pending))

    @contextlib.contextmanager
    def _dml_locks(self, table: str, shards_fn):
        """Exclusive (table, shard) locks around a DML read-modify-apply
        window (AcquireExecutorShardLocksForExecution analogue,
        executor/distributed_execution_locks.c).  Transaction locks are
        held to COMMIT/ROLLBACK (2PL); autocommit locks release at
        statement end.  The deadlock victim's transaction rolls back,
        like the reference canceling the youngest backend.

        `shards_fn` re-derives the target shard list from the current
        catalog: the loop adopts the on-disk catalog after acquiring and
        re-derives until stable (a shard split committed while we
        waited).  Yields the stable shard list."""
        from .transaction.clock import global_clock
        from .transaction.locks import DeadlockDetectedError

        txn = self.txn_manager.current
        txid = txn.txid if txn is not None else global_clock.now()
        try:
            while True:
                version = self.catalog.version
                shards = shards_fn()
                for sid in sorted(s.shard_id for s in shards):
                    self.locks.acquire(txid, (table, sid))
                self.catalog.maybe_reload(
                    os.path.join(self.data_dir, "catalog.json"))
                if self.catalog.version == version:
                    break
            # see the latest committed state from sessions sharing this
            # data_dir (the manifest cache may predate the lock wait)
            self.store.refresh(table)
            yield shards
        except DeadlockDetectedError:
            if txn is not None and self.txn_manager.current is txn:
                self.txn_manager.rollback()
                self.locks.release_all(txid)
            raise
        finally:
            if txn is None:
                self.locks.release_all(txid)

    def _execute_insert_values(self, stmt: ast.InsertValues):
        from .ingest.copy_from import insert_rows

        meta = self.catalog.table(stmt.table)
        columns = stmt.columns or tuple(meta.schema.names)

        def is_nextval(e):
            return (isinstance(e, ast.FuncCall) and e.name == "nextval"
                    and len(e.args) == 1
                    and isinstance(e.args[0], ast.Literal))

        # sequence values: allocate each sequence's whole range in ONE
        # catalog bump (commands/sequence.c's per-node range allocation)
        seq_counts: dict[str, int] = {}
        for row in stmt.rows:
            for e in row:
                if is_nextval(e):
                    name = str(e.args[0].value)
                    seq_counts[name] = seq_counts.get(name, 0) + 1
        seq_iters: dict[str, object] = {}
        if seq_counts:
            for name, cnt in seq_counts.items():
                first, step = self.catalog.sequence_nextval(name, cnt)
                seq_iters[name] = iter(
                    range(first, first + step * cnt, step))
            self._save_catalog()

        rows = []
        for row in stmt.rows:
            if len(row) != len(columns):
                raise PlanningError("INSERT row arity mismatch")
            values = []
            for e in row:
                if is_nextval(e):
                    values.append(next(seq_iters[str(e.args[0].value)]))
                    continue
                if not isinstance(e, ast.Literal):
                    raise PlanningError("INSERT values must be literals")
                if e.type_hint == "date":
                    values.append(date_to_days(str(e.value)))
                else:
                    values.append(e.value)
            rows.append(values)
        return insert_rows(self, stmt.table, list(columns), rows)

    def _execute_insert_select(self, stmt: ast.InsertSelect):
        """Array-path INSERT..SELECT (colocated / host-routed repartition
        modes, executor/insert_select.py); falls back to the row-based
        pull-to-coordinator mode only for shapes the raw path refuses,
        as the reference does."""
        from .executor.insert_select import execute_insert_select

        if isinstance(stmt.query, ast.SetOp):
            # compound source: materialise the set operation, then insert
            # from the temp (recursive-planning route)
            cleanup: list[str] = []
            try:
                sel = self._setop_select(stmt.query, cleanup, {})
                return self._execute_insert_select(
                    dc_replace(stmt, query=sel))
            finally:
                for t in cleanup:
                    self._drop_temp(t)
        try:
            result, _mode = execute_insert_select(self, stmt)
            return result
        except (PlanningError, UnsupportedQueryError):
            from .ingest.copy_from import insert_rows

            result = self._execute_select(stmt.query)
            meta = self.catalog.table(stmt.table)
            columns = list(stmt.columns or meta.schema.names)
            rows = [list(r) for r in result.rows()]
            self.stats.counters.increment(sc.INSERT_SELECT_PULL)
            return insert_rows(self, stmt.table, columns, rows)

    def _execute_dml(self, stmt):
        """UPDATE / DELETE / MERGE — router-planned modify commands
        (CreateModifyPlan / merge_planner analogues).  Subqueries in the
        WHERE clause go through recursive planning first, like SELECT."""
        from .executor.dml import execute_delete, execute_merge, execute_update

        cleanup: list[str] = []
        try:
            if isinstance(stmt, (ast.Update, ast.Delete)) and \
                    stmt.where is not None:
                stmt = dc_replace(stmt, where=self._rewrite_expr(
                    stmt.where, cleanup, {}))
            if isinstance(stmt, ast.Update):
                return execute_update(self, stmt)
            if isinstance(stmt, ast.Delete):
                return execute_delete(self, stmt)
            return execute_merge(self, stmt)
        finally:
            for t in cleanup:
                self._drop_temp(t)

    def _serving_cache(self):
        """The shared per-data_dir result cache, or None when serving is
        off, its byte budget is 0, or this session is inside an open
        transaction (staged rows are session-private: neither a fill
        nor a hit may cross the transaction boundary)."""
        if self.txn_manager.current is not None:
            return None
        if not self.settings.get("serving_enabled") or \
                self.settings.get("serving_result_cache_bytes") <= 0:
            return None
        if self._result_cache_handle is None:
            from .serving.result_cache import acquire_result_cache

            with self._result_cache_mu:
                if self._result_cache_handle is None:
                    self._result_cache_handle = acquire_result_cache(
                        self.data_dir)
        return self._result_cache_handle

    def _execute_select(self, sel: ast.Select,
                        params: tuple = ()) -> ResultSet:
        """A statement's SELECT: answer from the result cache when it
        holds a provably fresh result (CDC-driven invalidation plus the
        manifest-identity backstop — serving/result_cache.py); else
        plan, count its shape, run, drop the temps, and fill."""
        fill = None
        cache = self._serving_cache()
        if cache is not None:
            from .serving.result_cache import cache_key

            with trace_span("serving.cache_lookup"):
                keyed = cache_key(sel, params, self.catalog,
                                  self.settings, _UDFS, self.device.type)
                if keyed is not None:
                    key, tables = keyed
                    hit, d_inv = cache.lookup(
                        key, self.store.manifest_stat_sig)
                    if d_inv:  # this statement's poll did the dropping
                        self.stats.counters.increment(
                            sc.SERVING_CACHE_INVALIDATIONS_TOTAL, d_inv)
                    if hit is not None:
                        self.stats.counters.increment(
                            sc.SERVING_CACHE_HITS_TOTAL)
                        # fresh metadata over the shared (immutable)
                        # columns: a hit did no device work of its own
                        return dc_replace(hit, retries=0,
                                          envelope_retries=0,
                                          device_rows_scanned=0,
                                          streamed_batches=0)
                    self.stats.counters.increment(
                        sc.SERVING_CACHE_MISSES_TOTAL)
                    # freshness tokens taken BEFORE execution: a write
                    # landing mid-execution refuses this fill (epoch) or
                    # drops the entry later (manifest identity)
                    fill = (key, tables,
                            {t: self.store.manifest_stat_sig(t)
                             for t in tables},
                            cache.fill_token())
        plan, cleanup = self._plan_select(sel, params)
        self._count_plan_shape(plan)
        try:
            result = self.executor.execute_plan(plan)
        finally:
            for t in cleanup:
                self._drop_temp(t)
        if fill is not None:
            key, tables, sigs, token = fill
            cache.put(key, result, tables, sigs, token,
                      self.settings.get("serving_result_cache_bytes"))
        return result

    def _execute_subselect(self, sel: ast.Select) -> ResultSet:
        """Nested execution (recursive planning, set-operation sides,
        MERGE sources): counts as a subplan, not as query traffic."""
        self.stats.counters.increment(sc.SUBPLANS_EXECUTED)
        plan, cleanup = self._plan_select(sel)
        try:
            return self.executor.execute_plan(plan)
        finally:
            for t in cleanup:
                self._drop_temp(t)

    def _count_plan_shape(self, plan: QueryPlan) -> None:
        from .executor.feed import walk_plan
        from .planner.plan import JoinNode, ScanNode

        scans = [n for n in walk_plan(plan.root) if isinstance(n, ScanNode)]
        repartition = any(
            isinstance(n, JoinNode) and n.strategy.startswith("repart")
            for n in walk_plan(plan.root))
        single_shard = all(n.pruned_shards is not None
                           and len(n.pruned_shards) <= 1 for n in scans)
        if repartition:
            self.stats.counters.increment(sc.QUERIES_REPARTITION)
        if single_shard and scans:
            self.stats.counters.increment(sc.QUERIES_SINGLE_SHARD)
        else:
            self.stats.counters.increment(sc.QUERIES_MULTI_SHARD)

    def _plan_select(self, sel: ast.Select, params: tuple = ()
                     ) -> tuple[QueryPlan, list[str]]:
        """Recursive planning, then bind and plan.  Returns the plan and
        the temps it materialised, which the caller drops (_drop_temp)
        once the plan has run.  `params` are a prepared statement's
        EXECUTE arguments: the outer query binds them as BParam values
        (generic over them); subplans substitute them (_sub_params)."""
        cleanup: list[str] = []
        try:
            with trace_span("plan"):
                prev = getattr(self._params_tls, "value", ())
                self._params_tls.value = params
                try:
                    sel = self._recursive_plan(sel, cleanup)
                finally:
                    self._params_tls.value = prev
                # another session's commit since this session cached a
                # table's manifest and dictionaries: reload both before
                # binding (string literals bind through the dictionary)
                for t in _from_tables(sel):
                    if self.catalog.has_table(t):
                        self.store.refresh_if_stale(t)
                binder = Binder(self.catalog, _StoreDicts(self.store),
                                params=params)
                bound = binder.bind_select(sel)
                planner = DistributedPlanner(
                    self.catalog, _StoreStats(self.store), self.n_devices,
                    self.settings.get("enable_repartition_joins"),
                    dicts=_StoreDicts(self.store), device=self.device)
                return planner.plan(bound), cleanup
        except BaseException:
            for t in cleanup:
                self._drop_temp(t)
            raise

    # -- PREPARE / EXECUTE / EXPLAIN ----------------------------------------
    def _execute_prepared(self, stmt: ast.ExecutePrepared):
        """EXECUTE name(args): a SELECT binds args as BParam values, so
        the cached PlanCompiler and capacities serve every EXECUTE (the
        reference's cached shard plans, planner/local_plan_cache.c);
        other statement kinds substitute the literals into the AST."""
        target = self._prepared.get(stmt.name)
        if target is None:
            raise PlanningError(
                f"prepared statement {stmt.name!r} does not exist")
        for a in stmt.args:
            if not isinstance(a, ast.Literal):
                raise PlanningError("EXECUTE arguments must be literals")
        if isinstance(target, ast.Select):
            return self._execute_select(target, params=stmt.args)
        return self._execute_statement(
            _substitute_params(target, stmt.args))

    def _execute_explain(self, stmt: ast.Explain):
        """EXPLAIN [ANALYZE] [EXECUTE name(args)] SELECT: the plan's
        lines, as the JAX package renders them at one device; ANALYZE
        runs the plan and appends the JAX package's run lines."""
        target = stmt.statement
        params: tuple = ()
        if isinstance(target, ast.ExecutePrepared):
            # EXPLAIN EXECUTE name(args): show the generic plan
            prepared = self._prepared.get(target.name)
            if prepared is None:
                raise PlanningError(
                    f"prepared statement {target.name!r} does not exist")
            if not isinstance(prepared, ast.Select):
                raise UnsupportedQueryError(
                    "EXPLAIN EXECUTE supports prepared SELECTs only")
            params = target.args
            target = prepared
        if not isinstance(target, ast.Select):
            raise UnsupportedQueryError("EXPLAIN supports SELECT only")
        plan, cleanup = self._plan_select(target, params)
        try:
            lines = format_plan(plan, self.catalog, self.settings,
                                self.device)
            if stmt.analyze:
                lines += self._explain_analyze(plan, target, params)
            return ResultSet(["QUERY PLAN"], {"QUERY PLAN": lines},
                             len(lines))
        finally:
            for t in cleanup:
                self._drop_temp(t)

    def _explain_analyze(self, plan: QueryPlan, target: ast.Select,
                         params: tuple = ()) -> list[str]:
        """Run `plan` and render the JAX package's EXPLAIN ANALYZE lines,
        in its order and format: Execution Time, Timing (from this
        statement's span trace; a dispatch's device_ms stays in the
        trace), Rows, Chunks Skipped, Device Rows Scanned, Streamed
        Execution, Mesh, Integrity, Memory, Resilience, Caches, Workload,
        Serving and Replication.  The Caches line ends with how the run
        dispatched (`graph=replayed|captured|eager|uncapturable`, with
        the reason a run stayed eager).  `target` and `params` are the
        explained SELECT and its EXECUTE arguments (the Serving line's
        cache probe)."""
        import time

        from .planner.explain import explain_tag
        from .stats.tracing import current_root, format_timing_line

        counters = self.stats.counters
        snap0 = counters.snapshot()
        pc, fc = self.executor.plan_cache, self.executor.feed_cache
        cache0 = (pc.hits, pc.misses, fc.hits, fc.misses)
        ibase0 = _integrity.snapshot()
        t0 = time.perf_counter()
        result = self.executor.execute_plan(plan)
        elapsed = time.perf_counter() - t0
        lines = [f"Execution Time: {elapsed * 1000:.2f} ms"]
        troot = current_root()
        if troot is not None:
            lines.append(f"{explain_tag('Timing')}: "
                         + format_timing_line(troot))
        else:
            lines.append(f"{explain_tag('Timing')}: "
                         f"total={elapsed * 1000:.2f}ms "
                         "(no trace: tracing off or sampled out)")
        lines.append(f"Rows: {result.row_count}"
                     + (f" (capacity retries: {result.retries})"
                        if result.retries else ""))
        snap = counters.snapshot()

        def d(name):
            return snap.get(name, 0) - snap0.get(name, 0)

        if d(sc.CHUNKS_SKIPPED):
            lines.append(f"{explain_tag('Chunks Skipped')}: "
                         f"{d(sc.CHUNKS_SKIPPED)}")
        if result.device_rows_scanned:
            lines.append(f"{explain_tag('Device Rows Scanned')}: "
                         f"{result.device_rows_scanned}")
        if result.streamed_batches:
            lines.append(f"{explain_tag('Streamed Execution')}: "
                         f"{result.streamed_batches} batches")
        rows_in = result.device_rows_in
        rows_out = result.device_rows
        lines.append(
            f"{explain_tag('Mesh')}: devices={self.n_devices} "
            f"rows_in={rows_in if rows_in is not None else 'n/a'} "
            f"rows_out={rows_out if rows_out is not None else 'n/a'} "
            f"all_to_all_bytes={d(sc.SHUFFLE_BYTES_TOTAL)}")
        # this execution's integrity traffic; it folds into the session
        # counters only when the statement ends, so the totals add it
        idelta = _integrity.delta(ibase0)
        sv_total = (snap.get(sc.STRIPES_VERIFIED_TOTAL, 0)
                    + idelta["stripes_verified"])
        rr_total = (snap.get(sc.READ_REPAIRS_TOTAL, 0)
                    + idelta["read_repairs"])
        lines.append(
            f"{explain_tag('Integrity')}: stripes verified="
            f"{idelta['stripes_verified']} read repairs="
            f"{idelta['read_repairs']} corruption detected="
            f"{idelta['corruption_detected']} (session totals: "
            f"stripes_verified_total={sv_total} "
            f"read_repairs_total={rr_total})")
        msnap = self.executor.accountant.snapshot()
        lines.append(
            f"{explain_tag('Memory')}: "
            f"oom_events={d(sc.OOM_EVENTS_TOTAL)} "
            f"cache_evictions={d(sc.CACHE_EVICTIONS_TOTAL)} "
            f"spill_passes={d(sc.SPILL_PASSES_TOTAL)} "
            f"live={msnap['live_bytes']} peak={msnap['peak_bytes']} "
            f"(session totals: oom_events_total="
            f"{snap.get(sc.OOM_EVENTS_TOTAL, 0)} "
            "stream_batch_shrinks_total="
            f"{snap.get(sc.STREAM_BATCH_SHRINKS_TOTAL, 0)} "
            f"spill_passes_total={snap.get(sc.SPILL_PASSES_TOTAL, 0)})")
        lines.append(
            f"{explain_tag('Resilience')}: "
            f"retries={d(sc.RETRIES_TOTAL)} "
            f"failovers={d(sc.FAILOVERS_TOTAL)} "
            f"devices_lost={d(sc.DEVICE_LOST_TOTAL)} "
            f"mesh_failovers={d(sc.MESH_FAILOVERS_TOTAL)} "
            "(session totals: retries_total="
            f"{snap.get(sc.RETRIES_TOTAL, 0)} failovers_total="
            f"{snap.get(sc.FAILOVERS_TOTAL, 0)} timeouts_total="
            f"{snap.get(sc.TIMEOUTS_TOTAL, 0)} faults_injected_total="
            f"{snap.get(sc.FAULTS_INJECTED_TOTAL, 0)} device_lost_total="
            f"{snap.get(sc.DEVICE_LOST_TOTAL, 0)} mesh_failovers_total="
            f"{snap.get(sc.MESH_FAILOVERS_TOTAL, 0)} "
            "queries_rescued_total="
            f"{snap.get(sc.QUERIES_RESCUED_TOTAL, 0)})")
        graph, why = self.executor.last_dispatch()
        lines.append(
            f"{explain_tag('Caches')}: plan-cache hits="
            f"{pc.hits - cache0[0]} misses={pc.misses - cache0[1]}  "
            f"feed-cache hits={fc.hits - cache0[2]} "
            f"misses={fc.misses - cache0[3]}  exec-cache hits="
            f"{d(sc.EXEC_CACHE_HITS_TOTAL)} "
            f"misses={d(sc.EXEC_CACHE_MISSES_TOTAL)} "
            f"rejects={d(sc.EXEC_CACHE_REJECTS_TOTAL)} "
            f"deduped={d(sc.COMPILES_DEDUPED_TOTAL)} (session totals: plan "
            f"{pc.hits}/{pc.misses}, feed {fc.hits}/{fc.misses} "
            f"hits/misses, feed invalidations={fc.invalidations}, "
            f"exec-cache {snap.get(sc.EXEC_CACHE_HITS_TOTAL, 0)}/"
            f"{snap.get(sc.EXEC_CACHE_MISSES_TOTAL, 0)} hits/misses, "
            "warmup_compiles_total="
            f"{snap.get(sc.WARMUP_COMPILES_TOTAL, 0)})  graph={graph}"
            + (f" ({why})" if why else ""))
        lines.append(self._workload_line(snap))
        lines.append(self._serving_line(snap, snap0, target, params))
        rline = self._replication_line()
        if rline is not None:
            lines.append(rline)
        return lines

    def _workload_line(self, snap: dict) -> str:
        """This statement's trip through the admission gate (the EXPLAIN
        ANALYZE statement itself was the admitted unit), with session
        totals."""
        from .planner.explain import explain_tag

        info = getattr(self._wlm_tls, "last", None)
        totals = (f"(session totals: wlm_admitted_total="
                  f"{snap.get(sc.WLM_ADMITTED_TOTAL, 0)} wlm_queued_total="
                  f"{snap.get(sc.WLM_QUEUED_TOTAL, 0)} wlm_shed_total="
                  f"{snap.get(sc.WLM_SHED_TOTAL, 0)})")
        if info is None:
            return (f"{explain_tag('Workload')}: exempt (fast-path/utility "
                    f"or wlm disabled) {totals}")
        return (f"{explain_tag('Workload')}: class={info['priority']} "
                f"tenant={info['tenant']} "
                f"queued_ms={info['queued_ms']:.1f} "
                f"slots={info['slots_in_use']}/{info['slots_total']} "
                f"feed_bytes={info['feed_bytes']} {totals}")

    def _serving_line(self, snap: dict, snap0: dict, target,
                      params: tuple) -> str:
        """This statement's micro-batch trip, whether its result is
        cache-resident, and the shared batcher's occupancy."""
        from .planner.explain import explain_tag

        if not self.settings.get("serving_enabled"):
            return f"{explain_tag('Serving')}: off"
        from .serving.batcher import batcher_for
        from .serving.result_cache import cache_key

        bsnap = batcher_for(self.data_dir).snapshot()

        def d(name):
            return snap.get(name, 0) - snap0.get(name, 0)

        rcache = self._serving_cache()
        cstate = "off"
        if rcache is not None:
            keyed = cache_key(target, params, self.catalog, self.settings,
                              _UDFS, self.device.type)
            if keyed is None:
                cstate = "uncacheable"
            elif rcache.probe(keyed[0]):
                cstate = "cached"
            else:
                cstate = "uncached"
        return (f"{explain_tag('Serving')}: "
                f"batched lookups={d(sc.SERVING_BATCHED_LOOKUPS_TOTAL)} "
                f"dispatches led={d(sc.SERVING_BATCH_DISPATCH_TOTAL)} "
                f"result-cache={cstate} (layer: avg batch occupancy="
                f"{bsnap['avg_batch_occupancy']} max_batch_seen="
                f"{bsnap['max_batch_seen']}; session totals: cache hits="
                f"{snap.get(sc.SERVING_CACHE_HITS_TOTAL, 0)} misses="
                f"{snap.get(sc.SERVING_CACHE_MISSES_TOTAL, 0)})")

    def _replication_line(self) -> str | None:
        """This data_dir's role and, on a follower, the staleness the
        read gate saw for this statement; None when never replicated."""
        from .planner.explain import explain_tag

        rstate = self.replication.state()
        if rstate is None:
            return None
        if rstate.get("role") == "follower":
            gate = getattr(self._replica_stale_tls, "last", None) or {}
            return (f"{explain_tag('Replication')}: role=follower "
                    f"epoch={rstate['epoch']} "
                    f"applied_lsn={gate.get('applied_lsn', 0)} "
                    f"lag_lsn={gate.get('lag_lsn', 0)} "
                    f"lag_bytes={gate.get('lag_bytes', 0)} "
                    "(bound: replica_max_staleness_lsn="
                    f"{self.settings.get('replica_max_staleness_lsn')})")
        return (f"{explain_tag('Replication')}: role=leader "
                f"epoch={rstate['epoch']} "
                f"followers={len(rstate.get('followers', []))}")

    # -- recursive planning ------------------------------------------------
    def _sub_params(self, node):
        """Substitute EXECUTE args into a subquery before it runs as a
        subplan (subplans execute ahead of outer binding, so $n must
        resolve here; the outer query's params stay generic)."""
        args = getattr(self._params_tls, "value", ())
        return _substitute_params(node, args) if args else node

    def _recursive_plan(self, sel: ast.Select, cleanup: list[str],
                        cte_scope: dict[str, str] | None = None
                        ) -> ast.Select:
        """CTEs → temps, decorrelation, the multi-DISTINCT rewrite, then
        FROM items and expression subqueries planned recursively (the
        GenerateSubplansForSubqueriesAndCTEs analogue, Citus
        planner/recursive_planning.c:223)."""
        cte_scope = dict(cte_scope or {})
        for cte in sel.ctes:
            temp = self._query_to_temp(cte.query, cleanup, cte_scope,
                                       cte.column_names)
            cte_scope[cte.name] = temp

        def columns_of(name: str):
            name = cte_scope.get(name, name)
            if not self.catalog.has_table(name):
                return None
            return frozenset(
                c.name for c in self.catalog.table(name).schema.columns)

        sel = decorrelate_select(sel, columns_of)
        sel = self._rewrite_approx_percentile(sel, cleanup, cte_scope)

        def column_nullable(ref: ast.ColumnRef):
            """Can this plain column ref hold NULLs?  Schema nullability
            refined by the exact manifest null-count rollup (a nullable
            column whose committed data has no NULLs is safe to join
            on).  None = unresolvable or ambiguous."""
            found = None
            for fi in sel.from_items:
                if not isinstance(fi, ast.TableRef):
                    continue
                name = cte_scope.get(fi.name, fi.name)
                if ref.table is not None and \
                        (fi.alias or fi.name) != ref.table:
                    continue
                if not self.catalog.has_table(name):
                    continue
                schema = self.catalog.table(name).schema
                if schema.has_column(ref.name):
                    if found is not None:
                        return None  # ambiguous
                    nullable = schema.column(ref.name).nullable
                    if nullable:
                        has = self.store.column_has_nulls(name, ref.name)
                        nullable = True if has is None else has
                    found = nullable
            return found

        sel = rewrite_multi_distinct(sel, column_nullable)
        new_from = tuple(self._rewrite_from(fi, cleanup, cte_scope)
                         for fi in sel.from_items)

        def rewrite(e):
            return self._rewrite_expr(e, cleanup, cte_scope)

        new_semis = tuple(
            ast.SemiJoin(sj.join_type,
                         self._rewrite_from(sj.item, cleanup, cte_scope),
                         rewrite(sj.condition))
            for sj in sel.semi_joins)
        return ast.Select(
            items=tuple(ast.SelectItem(rewrite(i.expr), i.alias)
                        for i in sel.items),
            from_items=new_from,
            where=rewrite(sel.where) if sel.where is not None else None,
            group_by=tuple(rewrite(g) for g in sel.group_by),
            having=rewrite(sel.having) if sel.having is not None else None,
            order_by=tuple(ast.OrderItem(rewrite(o.expr), o.descending,
                                         o.nulls_first)
                           for o in sel.order_by),
            limit=sel.limit, offset=sel.offset, distinct=sel.distinct,
            ctes=(), semi_joins=new_semis)

    def _rewrite_from(self, fi: ast.FromItem, cleanup, cte_scope):
        if isinstance(fi, ast.TableRef):
            if fi.name in cte_scope:
                return ast.TableRef(cte_scope[fi.name],
                                    fi.alias or fi.name)
            view = self.catalog.views.get(fi.name)
            if view is not None:
                # expand like a derived table: materialise the view body
                # in a fresh scope (view bodies bind to base tables, never
                # to the referencing statement's CTEs); a thread-local
                # stack refuses self- and mutually-recursive views
                stack = getattr(self._view_tls, "stack", None)
                if stack is None:
                    stack = self._view_tls.stack = []
                if fi.name in stack:
                    raise PlanningError(
                        f"infinite recursion detected in view "
                        f"{fi.name!r}")
                stack.append(fi.name)
                try:
                    body = parse(view["sql"])[0]
                    temp = self._query_to_temp(body, cleanup, {},
                                               tuple(view["columns"]))
                finally:
                    stack.pop()
                return ast.TableRef(temp, fi.alias or fi.name)
            return fi
        if isinstance(fi, ast.SubqueryRef):
            temp = self._query_to_temp(fi.query, cleanup, cte_scope)
            return ast.TableRef(temp, fi.alias)
        if isinstance(fi, ast.Join):
            return ast.Join(fi.join_type,
                            self._rewrite_from(fi.left, cleanup, cte_scope),
                            self._rewrite_from(fi.right, cleanup, cte_scope),
                            (self._rewrite_expr(fi.condition, cleanup,
                                                cte_scope)
                             if fi.condition is not None else None),
                            fi.using_cols)
        return fi

    def _rewrite_approx_percentile(self, sel: ast.Select, cleanup,
                                   cte_scope) -> ast.Select:
        """approx_percentile(col, q) → DDSketch bucket pre-pass.

        The device runs ``group by (G…, dd_bucket(col)) → count(*)``
        over the same FROM/WHERE — the log-domain buckets ARE the
        mergeable quantile sketch (per-shard counts add through the
        ordinary aggregate split, the way HLL registers merge by max),
        with a RELATIVE error bound α = (γ-1)/(γ+1) ≈ 1% that one
        outlier cannot degrade (ops/sketches.py).  The host folds the
        per-(group, bucket) counts into quantile values:

        * global: the value replaces the call as a constant wrapped in
          max() — one row, NULL over an empty input.
        * GROUP BY: per-group values materialize as a temp reference
          table (g…, pctl) joined back into the query on the group
          keys; the call becomes max(pctl) over the (unique-per-group)
          joined column.

        Reference: percentile → worker tdigest + coordinator merge,
        multi_logical_optimizer.c:2046."""
        from .ops.sketches import dd_quantile

        calls = [n for it in sel.items for n in ast.walk_expr(it.expr)
                 if isinstance(n, ast.FuncCall)
                 and n.name == "approx_percentile"]
        if not calls:
            return sel
        if sel.distinct:
            raise UnsupportedQueryError(
                "approx_percentile cannot combine with SELECT DISTINCT")
        group_keys = list(sel.group_by)
        for g in group_keys:
            if not isinstance(g, ast.ColumnRef):
                raise UnsupportedQueryError(
                    "approx_percentile with GROUP BY requires plain "
                    "column group keys")
        parsed: list[tuple[ast.FuncCall, ast.ColumnRef, float]] = []
        for call in calls:
            if call.window is not None or call.distinct or \
                    len(call.args) != 2:
                raise UnsupportedQueryError(
                    "approx_percentile(column, quantile) expects two "
                    "arguments")
            col, qlit = call.args
            if not (isinstance(qlit, ast.Literal)
                    and isinstance(qlit.value, (int, float))
                    and 0.0 <= float(qlit.value) <= 1.0):
                raise UnsupportedQueryError(
                    "approx_percentile quantile must be a literal in "
                    "[0, 1]")
            if not isinstance(col, ast.ColumnRef):
                raise UnsupportedQueryError(
                    "approx_percentile argument must be a plain column")
            parsed.append((call, col, float(qlit.value)))

        repl: dict[ast.FuncCall, ast.Expr] = {}
        extra_from: list[ast.FromItem] = []
        extra_where: list[ast.Expr] = []
        # one pre-pass per distinct sketched column; every quantile over
        # that column reads the same (group, bucket) counts
        by_col: dict[ast.ColumnRef, list[tuple[ast.FuncCall, float]]] = {}
        for call, col, q in parsed:
            by_col.setdefault(col, []).append((call, q))
        for col, wants in by_col.items():
            bucket = ast.FuncCall("__dd_bucket", (col,))
            g_items = tuple(ast.SelectItem(g, f"g{i}")
                            for i, g in enumerate(group_keys))
            hist = ast.Select(
                items=g_items + (
                    ast.SelectItem(bucket, "hb"),
                    ast.SelectItem(
                        ast.FuncCall("count", (), star=True), "c")),
                from_items=sel.from_items, where=sel.where,
                group_by=tuple(group_keys) + (bucket,),
                # decorrelated EXISTS filters must apply here too
                semi_joins=sel.semi_joins)
            inner = self._recursive_plan(hist, cleanup, cte_scope)
            result = self._execute_subselect(self._sub_params(inner))
            nk = len(group_keys)
            # NULL column values form a NULL bucket group: percentile
            # ignores NULLs (PG semantics), so drop it
            rows = [r for r in result.rows() if r[nk] is not None]
            if not group_keys:
                keys = np.asarray([r[0] for r in rows], dtype=np.int64)
                cnts = np.asarray([r[1] for r in rows], dtype=np.int64)
                for call, q in wants:
                    repl[call] = ast.FuncCall(
                        "max", (ast.Literal(dd_quantile(keys, cnts, q)),))
                continue
            # grouped: fold per group tuple.  Groups whose sketched
            # column is ALL NULL appear only in the dropped NULL-bucket
            # rows — they must still produce an output row (with a NULL
            # percentile, PG semantics), so collect group tuples from
            # the UNFILTERED result
            per_group: dict[tuple, list[tuple[int, int]]] = {}
            for r in rows:
                per_group.setdefault(tuple(r[:nk]), []).append(
                    (int(r[nk]), int(r[nk + 1])))
            gtuples = []
            seen_g = set()
            for r in result.rows():
                g = tuple(r[:nk])
                if g not in seen_g:
                    seen_g.add(g)
                    gtuples.append(g)
            pctls: list[list] = []  # per want, per group tuple
            for call, q in wants:
                vals = []
                for g in gtuples:
                    pairs = per_group.get(g)
                    if not pairs:
                        vals.append(None)  # all-NULL group
                        continue
                    keys = np.asarray([k for k, _ in pairs],
                                      dtype=np.int64)
                    cnts = np.asarray([c for _, c in pairs],
                                      dtype=np.int64)
                    vals.append(dd_quantile(keys, cnts, q))
                pctls.append(vals)
            key_dts = [_result_dtype(result, i) for i in range(nk)]
            if DataType.STRING in key_dts:
                # string group keys can't ride the temp join (cross-
                # table string equality needs dictionary alignment);
                # inline a CASE over the observed group values instead
                if len(gtuples) > 1000:
                    raise UnsupportedQueryError(
                        "approx_percentile with string GROUP BY keys "
                        "supports at most 1000 groups")
                for j, (call, _q) in enumerate(wants):
                    whens = []
                    for gi, g in enumerate(gtuples):
                        conds = []
                        for i, gk in enumerate(group_keys):
                            v = g[i]
                            conds.append(
                                ast.IsNull(gk) if v is None
                                else ast.BinaryOp(
                                    "=", gk, _value_to_literal(
                                        v, key_dts[i])))
                        cond = conds[0]
                        for c in conds[1:]:
                            cond = ast.BinaryOp("AND", cond, c)
                        whens.append((cond,
                                      ast.Literal(pctls[j][gi])))
                    repl[call] = ast.FuncCall(
                        "max", (ast.CaseWhen(tuple(whens), None),))
                continue
            # numeric/date keys: materialize a temp reference table and
            # join it back on the group keys
            temp_cols: dict[str, object] = {}
            temp_names: list[str] = []
            temp_dtypes: dict[str, object] = {}
            for i in range(nk):
                nmi = f"__pg{i}"
                temp_names.append(nmi)
                temp_cols[nmi] = np.asarray([g[i] for g in gtuples],
                                            dtype=object)
                temp_dtypes[nmi] = key_dts[i]
            for j, (call, q) in enumerate(wants):
                nmj = f"__pctl{len(extra_from)}_{j}"
                temp_names.append(nmj)
                temp_cols[nmj] = np.asarray(pctls[j], dtype=object)
                temp_dtypes[nmj] = DataType.FLOAT64
            shim = ResultSet(temp_names, temp_cols, len(gtuples),
                             dtypes=temp_dtypes)
            temp = self._store_result(shim, cleanup)
            alias = f"__pctl_t{len(extra_from)}"
            extra_from.append(ast.TableRef(temp, alias))
            for i, g in enumerate(group_keys):
                tcol = ast.ColumnRef(f"__pg{i}", table=alias)
                eq = ast.BinaryOp("=", g, tcol)
                if any(gt[i] is None for gt in gtuples):
                    # NULL group keys group together (PG semantics) but
                    # never compare equal — match them explicitly
                    eq = ast.BinaryOp(
                        "OR", eq,
                        ast.BinaryOp("AND", ast.IsNull(g),
                                     ast.IsNull(tcol)))
                extra_where.append(eq)
            for j, (call, _q) in enumerate(wants):
                repl[call] = ast.FuncCall(
                    "max",
                    (ast.ColumnRef(f"__pctl{len(extra_from) - 1}_{j}",
                                   table=alias),))

        def sub(e: ast.Expr) -> ast.Expr:
            if isinstance(e, ast.FuncCall) and e in repl:
                return repl[e]
            return _map_children(e, sub)

        where = sel.where
        for c in extra_where:
            where = c if where is None else ast.BinaryOp("AND", where, c)
        return dc_replace(
            sel,
            items=tuple(ast.SelectItem(sub(it.expr), it.alias)
                        for it in sel.items),
            from_items=sel.from_items + tuple(extra_from),
            where=where)

    def _subquery_select(self, q, cleanup, cte_scope) -> ast.Select:
        """Expression-subquery body → plain Select (compound bodies
        materialise to a temp first)."""
        if isinstance(q, ast.SetOp):
            temp = self._query_to_temp(q, cleanup, cte_scope)
            return ast.Select(items=(ast.SelectItem(ast.Star()),),
                              from_items=(ast.TableRef(temp),))
        return q

    def _rewrite_expr(self, e: ast.Expr, cleanup, cte_scope) -> ast.Expr:
        def run(q, **changes) -> ResultSet:
            inner = self._recursive_plan(
                self._subquery_select(q, cleanup, cte_scope), cleanup,
                cte_scope)
            return self._execute_subselect(
                dc_replace(self._sub_params(inner), **changes))

        if isinstance(e, ast.ScalarSubquery):
            result = run(e.query)
            if result.row_count > 1:
                raise ExecutionError(
                    "scalar subquery returned more than one row")
            if result.row_count == 0:
                return ast.Literal(None)
            dt = _result_dtype(result, 0)
            return _value_to_literal(result.rows()[0][0], dt)
        if isinstance(e, ast.InSubquery):
            result = run(e.query)
            dt = _result_dtype(result, 0)
            raw = [r[0] for r in result.rows()]
            has_null = any(v is None for v in raw)
            values = tuple(_value_to_literal(v, dt) for v in raw
                           if v is not None)
            operand = self._rewrite_expr(e.operand, cleanup, cte_scope)
            if e.negated:
                # x NOT IN (..., NULL) is never TRUE (SQL three-valued)
                if has_null:
                    return ast.Literal(False)
                if not values:
                    return ast.Literal(True)  # NOT IN (empty) holds
                return ast.InList(operand, values, True)
            if not values:
                return ast.Literal(False)
            # positive IN: dropping NULLs is exact under WHERE semantics
            # (x IN (..., NULL) is TRUE or NULL, never FALSE-turned-TRUE)
            return ast.InList(operand, values, False)
        if isinstance(e, ast.Exists):
            found = run(e.query, limit=1).row_count > 0
            return ast.Literal(found != e.negated)
        # window specs carry expressions the generic mapper does not
        # descend into
        if isinstance(e, ast.FuncCall) and e.window is not None:
            window = ast.WindowSpec(
                tuple(self._rewrite_expr(p, cleanup, cte_scope)
                      for p in e.window.partition_by),
                tuple((self._rewrite_expr(o, cleanup, cte_scope), d)
                      for o, d in e.window.order_by))
            return ast.FuncCall(e.name,
                                tuple(self._rewrite_expr(a, cleanup,
                                                         cte_scope)
                                      for a in e.args),
                                e.distinct, e.star, window)
        return _map_children(
            e, lambda c: self._rewrite_expr(c, cleanup, cte_scope))

    def _store_result(self, result, cleanup: list[str],
                      column_names: tuple[str, ...] = ()) -> str:
        """ResultSet → temp reference table `__intermediate_{n}`."""
        name = f"__intermediate_{next(self._temp_counter)}"
        names = (list(column_names) if column_names
                 else result.column_names)
        cols = []
        arrays = {}
        dicts = {}
        for out_name, col_name in zip(result.column_names, names):
            data = result.columns[out_name]
            if _result_dtype(result, out_name) == DataType.DATE:
                # keep DATE columns as day numbers in the temp table (the
                # host combine formatted them to ISO text)
                arr = np.array([None if x is None else date_to_days(str(x))
                                for x in data], dtype=object)
                dtype, dvals = DataType.DATE, None
            else:
                dtype, arr, dvals = _infer_column(data)
            cols.append(ColumnDef(col_name, dtype))
            arrays[col_name] = arr
            if dvals is not None:
                dicts[col_name] = dvals
        self.catalog.create_reference_table(name, TableSchema(tuple(cols)))
        cleanup.append(name)
        if result.row_count > 0:
            # validity from the pre-intern object arrays (None = NULL)
            validity = {c: (~_none_mask(a) if a.dtype == object
                            else np.ones(result.row_count, dtype=bool))
                        for c, a in arrays.items()}
            for col_name, values in dicts.items():
                d = self.store.dictionary(name, col_name)
                arrays[col_name] = d.intern_array(values)
            arrays = {c: _object_to_typed(a) for c, a in arrays.items()}
            shard = self.catalog.table_shards(name)[0]
            self.store.append_stripe(name, shard.shard_id, arrays, validity)
        return name

    # -- set operations ----------------------------------------------------
    def _execute_setop(self, stmt: ast.SetOp) -> ResultSet:
        """UNION [ALL] / INTERSECT / EXCEPT through recursive
        materialisation.  Both sides land in ONE combined temp (one
        dictionary per string column) and the set semantics ride the
        aggregate path: GROUP BY all columns with a side tag,
            UNION      →  the groups themselves,
            INTERSECT  →  HAVING min(__side) = 0 AND max(__side) = 1,
            EXCEPT     →  HAVING max(__side) = 0.
        NULLs compare equal, as GROUP BY groups them."""
        cleanup: list[str] = []
        try:
            final = self._setop_select(stmt, cleanup, {})
            return self._execute_select(final)
        finally:
            for t in cleanup:
                self._drop_temp(t)

    def _setop_select(self, stmt: ast.SetOp, cleanup: list[str],
                      cte_scope: dict[str, str]) -> ast.Select:
        """SetOp tree → a plain Select over the combined temp table."""
        cte_scope = dict(cte_scope)
        for cte in stmt.ctes:
            temp = self._query_to_temp(cte.query, cleanup, cte_scope,
                                       cte.column_names)
            cte_scope[cte.name] = temp
        if stmt.all and stmt.op != "union":
            raise UnsupportedQueryError(
                f"{stmt.op.upper()} ALL is not supported (bag semantics "
                "need per-group multiplicity matching)")
        left = self._setop_result(stmt.left, cleanup, cte_scope)
        right = self._setop_result(stmt.right, cleanup, cte_scope)
        if len(left.column_names) != len(right.column_names):
            raise PlanningError(
                f"each {stmt.op.upper()} side must have the same number "
                f"of columns ({len(left.column_names)} vs "
                f"{len(right.column_names)})")
        tag = not (stmt.op == "union" and stmt.all)
        combined = self._store_result(
            _concat_results(left, right, tag), cleanup)
        names = [c for c in self.catalog.table(combined).schema.names
                 if c != "__side"]
        refs = tuple(ast.ColumnRef(n) for n in names)
        items = tuple(ast.SelectItem(r, n) for r, n in zip(refs, names))
        having = None
        group_by: tuple = ()
        if stmt.op == "union" and not stmt.all:
            group_by = refs
        elif stmt.op == "intersect":
            group_by = refs
            side = ast.ColumnRef("__side")
            having = ast.BinaryOp(
                "AND",
                ast.BinaryOp("=", ast.FuncCall("min", (side,)),
                             ast.Literal(0)),
                ast.BinaryOp("=", ast.FuncCall("max", (side,)),
                             ast.Literal(1)))
        elif stmt.op == "except":
            group_by = refs
            having = ast.BinaryOp("=", ast.FuncCall(
                "max", (ast.ColumnRef("__side"),)), ast.Literal(0))
        return ast.Select(items=items,
                          from_items=(ast.TableRef(combined),),
                          group_by=group_by, having=having,
                          order_by=stmt.order_by, limit=stmt.limit,
                          offset=stmt.offset)

    def _setop_result(self, q, cleanup: list[str], cte_scope) -> ResultSet:
        """One set-operation side → its executed ResultSet."""
        if isinstance(q, ast.SetOp):
            inner = self._setop_select(q, cleanup, cte_scope)
        else:
            inner = self._recursive_plan(q, cleanup, cte_scope)
        return self._execute_subselect(self._sub_params(inner))

    def _query_to_temp(self, q, cleanup: list[str], cte_scope,
                       column_names: tuple[str, ...] = ()) -> str:
        """Select | SetOp → executed, its rows stored as a temp reference
        table (the intermediate-result broadcast analogue; CTE and
        derived-table bodies may be compound queries)."""
        if isinstance(q, ast.SetOp):
            sel = self._setop_select(q, cleanup, cte_scope)
        else:
            sel = self._recursive_plan(q, cleanup, cte_scope)
        return self._store_result(
            self._execute_subselect(self._sub_params(sel)), cleanup,
            column_names)

    def _drop_temp(self, name: str) -> None:
        """Drop a temp's catalog entry, its storage and its device feeds
        (fresh names never meet the feed cache's version eviction)."""
        try:
            self.catalog.drop_table(name)
        except CatalogError:
            pass
        self.store.drop_table_storage(name)
        self.executor.feed_cache.invalidate_table(name)

    def _save_catalog(self):
        self.catalog.save(os.path.join(self.data_dir, "catalog.json"))


def _concat_results(left: ResultSet, right: ResultSet,
                    tag: bool) -> ResultSet:
    """Two ResultSets → one (columns matched by position, names from the
    left side), plus an int `__side` column (0 = left, 1 = right) when
    `tag`.  Feeds _store_result for set-operation temps."""
    n = left.row_count + right.row_count
    names = list(left.column_names)
    cols: dict[str, object] = {}
    dtypes: dict[str, DataType] = {}
    numeric = {DataType.INT32, DataType.INT64, DataType.FLOAT32,
               DataType.FLOAT64}
    for lname, rname in zip(names, right.column_names):
        cols[lname] = np.asarray(list(left.columns[lname])
                                 + list(right.columns[rname]), dtype=object)
        ldt = _result_dtype(left, lname)
        rdt = _result_dtype(right, rname)
        if ldt is not None and ldt == rdt:
            dtypes[lname] = ldt
        elif ldt is not None and rdt is not None:
            # PG: "UNION types X and Y cannot be matched"; numeric widths
            # widen, every other mix is an error
            if not (ldt in numeric and rdt in numeric):
                raise PlanningError(
                    f"set-operation column {lname!r} mixes "
                    f"{ldt.value} and {rdt.value} — types cannot be "
                    "matched")
            dtypes[lname] = (
                DataType.FLOAT64
                if DataType.FLOAT64 in (ldt, rdt)
                or DataType.FLOAT32 in (ldt, rdt) else DataType.INT64)
    if tag:
        names.append("__side")
        cols["__side"] = np.concatenate(
            [np.zeros(left.row_count, dtype=np.int64),
             np.ones(right.row_count, dtype=np.int64)])
        dtypes["__side"] = DataType.INT64
    return ResultSet(names, cols, n, dtypes=dtypes)


def _result_dtype(result: ResultSet, col: int | str):
    if result.dtypes is None:
        return None
    if isinstance(col, int):
        col = result.column_names[col]
    return result.dtypes.get(col)


def _value_to_literal(v, dtype=None) -> ast.Literal:
    if v is None:
        return ast.Literal(None)
    if dtype == DataType.DATE:
        # the host combine formatted DATE to ISO text; fold back to day
        # numbers so comparisons against DATE columns bind as integers
        return ast.Literal(date_to_days(str(v)))
    if isinstance(v, np.integer):
        return ast.Literal(int(v))
    if isinstance(v, np.floating):
        return ast.Literal(float(v))
    if isinstance(v, (np.bool_, bool)):
        return ast.Literal(bool(v))
    if isinstance(v, (str, int, float)):
        return ast.Literal(v)
    raise ExecutionError(f"cannot inline value of type {type(v).__name__}")


def _infer_column(data):
    """Result column → (DataType, array, dict_values | None)."""
    arr = np.asarray(data)
    if arr.dtype == object:
        non_null = [x for x in data if x is not None]
        if non_null and isinstance(non_null[0], str):
            return DataType.STRING, np.asarray(data, dtype=object), list(data)
        typed = np.array([0 if x is None else x for x in data])
        return _np_to_datatype(typed.dtype), np.asarray(data,
                                                        dtype=object), None
    return _np_to_datatype(arr.dtype), arr, None


def _np_to_datatype(dt) -> DataType:
    if dt == np.int32:
        return DataType.INT32
    if np.issubdtype(dt, np.integer):
        return DataType.INT64
    if dt == np.float32:
        return DataType.FLOAT32
    if np.issubdtype(dt, np.floating):
        return DataType.FLOAT64
    if dt == np.bool_:
        return DataType.BOOL
    return DataType.FLOAT64


def _none_mask(arr) -> np.ndarray:
    return np.array([x is None for x in arr], dtype=bool)


def _object_to_typed(arr: np.ndarray) -> np.ndarray:
    if arr.dtype != object:
        return arr
    return np.array([0 if x is None else x for x in arr])


def _substitute_params(node, args: tuple):
    """Replace ast.Param nodes with the EXECUTE argument literals across
    an arbitrary (frozen-dataclass) statement tree: a prepared SELECT's
    subplans, and prepared statements of other kinds (no compiled plan
    to keep generic there)."""
    if isinstance(node, ast.Param):
        if node.index >= len(args):
            raise PlanningError(
                f"parameter ${node.index + 1} has no value")
        return args[node.index]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        changes = {}
        for f in dataclasses.fields(node):
            old = getattr(node, f.name)
            new = _substitute_params(old, args)
            if new is not old:
                changes[f.name] = new
        return dataclasses.replace(node, **changes) if changes else node
    if isinstance(node, tuple):
        subst = tuple(_substitute_params(x, args) for x in node)
        return subst if any(a is not b for a, b in zip(subst, node)) \
            else node
    if isinstance(node, list):
        return [_substitute_params(x, args) for x in node]
    return node


def _from_tables(sel: ast.Select) -> set[str]:
    """Table names a bound SELECT reads (FROM items, joins, semi-join
    items) — after recursive planning, so temps and plain tables."""
    out: set[str] = set()

    def visit(fi) -> None:
        if isinstance(fi, ast.TableRef):
            out.add(fi.name)
        elif isinstance(fi, ast.Join):
            visit(fi.left)
            visit(fi.right)

    for fi in sel.from_items:
        visit(fi)
    for sj in sel.semi_joins:
        visit(sj.item)
    return out
