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

Not in this port yet: the statement retry envelope with its statement
timeout (`_UNPORTED_SETTINGS`), EXPLAIN ANALYZE, the UDFs of unported
modules (`_UNPORTED_UDFS`), serving, WLM, replication, tracing and the
stats counters, streaming and the OOM ladder.
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
from .errors import (
    CatalogError,
    ExecutionError,
    PlanningError,
    UnsupportedQueryError,
)
from .executor.runner import Executor, ResultSet
from .planner.bind import Binder, DictProvider
from .planner.decorrelate import (
    _map_children,
    decorrelate_select,
    rewrite_multi_distinct,
)
from .planner.explain import format_plan
from .planner.plan import DistributedPlanner, QueryPlan, StatsProvider
from .runtime import resolve_device
from .sql import ast, parse
from .storage import TableStore
from .transaction.locks import lock_manager_for
from .transaction.manager import TransactionManager
from .types import (
    ColumnDef,
    DataType,
    TableSchema,
    date_to_days,
    sql_type_to_datatype,
)


# the catalog UDFs this port answers (Session._try_udf)
_UDFS = ("create_distributed_table", "create_reference_table",
         "citus_add_node", "citus_remove_node", "citus_disable_node",
         "citus_activate_node", "nextval", "currval",
         "citus_tables", "citus_shards", "citus_change_feed",
         "citus_get_node_clock")

# the JAX package's other UDFs, by the ROADMAP queue A item that brings
# their module: each raises UnsupportedQueryError naming it
_UNPORTED_UDFS = {
    **dict.fromkeys(
        ("citus_stat_counters", "citus_stat_counters_reset",
         "citus_stat_statements", "citus_stat_statements_reset",
         "citus_stat_latency", "citus_stat_latency_reset",
         "citus_stat_tenants", "citus_stat_activity",
         "citus_check_cluster_node_health", "citus_promote_node"),
        "queue A item 8 (stats/ and operations/health.py)"),
    "citus_stat_memory": "queue A item 5 (the OOM ladder's accountant)",
    **dict.fromkeys(
        ("citus_stat_mesh", "citus_rebalance_mesh", "citus_drain_device"),
        "queue A item 9 (multi-GPU)"),
    **dict.fromkeys(
        ("rebalance_table_shards", "citus_move_shard_placement",
         "get_rebalance_progress", "citus_split_shard_by_split_points",
         "isolate_tenant_to_node", "citus_cleanup_orphaned_resources",
         "citus_rebalance_start", "citus_rebalance_wait",
         "citus_job_wait", "citus_job_cancel", "citus_job_list",
         "citus_create_restore_point", "citus_check_cluster"),
        "queue A item 10 (operations/ and background/ jobs)"),
    **dict.fromkeys(
        ("citus_stat_wlm", "citus_stat_serving", "citus_stat_replication",
         "citus_replication_ship", "citus_promote_replica"),
        "queue A item 11 (serving/, wlm/ and replication/)"),
}


# the JAX package's settings whose module is not ported: SET refuses
# each, naming the ROADMAP queue A item that brings it
_UNPORTED_SETTINGS = dict.fromkeys(
    ("statement_timeout_ms", "max_statement_retries",
     "retry_backoff_base_ms", "retry_backoff_max_ms"),
    "queue A item 13 (the statement retry envelope)")


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
                 **settings):
        """`device=None` runs on cuda:0 and raises when no GPU is
        visible; `device="cpu"` runs the plain formulations (tests).
        `settings` are config variables (config.py), e.g.
        scan_pipeline="off" for the eager feed path."""
        self.device = resolve_device(device)
        self.data_dir = data_dir or tempfile.mkdtemp(prefix="citus_port_")
        os.makedirs(self.data_dir, exist_ok=True)
        self.settings = Settings(settings or None)
        cat_path = os.path.join(self.data_dir, "catalog.json")
        self.catalog = (Catalog.load(cat_path) if os.path.exists(cat_path)
                        else Catalog())
        self.store = TableStore(self.data_dir, self.catalog, self.settings)
        # one device: the catalog's node↔device map folds every node of a
        # data_dir written for a wider mesh onto device 0
        self.n_devices = 1
        if not self.catalog.nodes:
            self.catalog.add_node("device:0")
        self.executor = Executor(self.catalog, self.store, self.settings,
                                 self.device)
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
        # Session.cancel() → the executing statement's next seam raises
        self._cancel_evt = threading.Event()

    # ------------------------------------------------------------------
    def execute(self, sql: str):
        """Run a SQL script; returns the last statement's ResultSet/None."""
        from .utils.cancellation import deadline_scope

        # adopt another session's committed DDL; never mid-transaction
        # (the open transaction pinned its snapshot)
        if self.txn_manager.current is None:
            self.catalog.maybe_reload(os.path.join(self.data_dir,
                                                   "catalog.json"))
        self._cancel_evt.clear()  # a fresh script clears stale cancels
        result = None
        for stmt in parse(sql):
            with deadline_scope(self._cancel_evt):
                result = self._execute_statement(stmt)
        return result

    def cancel(self) -> None:
        """Cancel the statement running on this session (another thread
        calls this): it raises QueryCanceled at its next seam."""
        self._cancel_evt.set()

    def change_events(self, table: str | None = None,
                      from_lsn: int = 0) -> list[dict]:
        """Committed logical changes with lsn > from_lsn (the change-feed
        subscription read)."""
        return self.store.change_log.read(table, from_lsn)

    def change_rows(self, event: dict):
        """Materialize one event's row payload: (values, validity)."""
        from .cdc.feed import rows_for

        return rows_for(self.store, event)

    def _execute_statement(self, stmt: ast.Statement):
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
            if stmt.name in _UNPORTED_SETTINGS:
                raise UnsupportedQueryError(
                    f"{stmt.name} is not in this port yet: it comes with "
                    f"{_UNPORTED_SETTINGS[stmt.name]}")
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
        return ResultSet(["ok"], {"ok": [True]}, 1)

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
        self._save_catalog()

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

    def _execute_select(self, sel: ast.Select,
                        params: tuple = ()) -> ResultSet:
        """A statement or a subplan: plan, run, drop the temps."""
        plan, cleanup = self._plan_select(sel, params)
        try:
            return self.executor.execute_plan(plan)
        finally:
            for t in cleanup:
                self._drop_temp(t)

    def _plan_select(self, sel: ast.Select, params: tuple = ()
                     ) -> tuple[QueryPlan, list[str]]:
        """Recursive planning, then bind and plan.  Returns the plan and
        the temps it materialised, which the caller drops (_drop_temp)
        once the plan has run.  `params` are a prepared statement's
        EXECUTE arguments: the outer query binds them as BParam values
        (generic over them); subplans substitute them (_sub_params)."""
        cleanup: list[str] = []
        try:
            prev = getattr(self._params_tls, "value", ())
            self._params_tls.value = params
            try:
                sel = self._recursive_plan(sel, cleanup)
            finally:
                self._params_tls.value = prev
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
        """EXPLAIN [EXECUTE name(args)] SELECT: the plan's lines, as
        the JAX package renders them at one device."""
        if stmt.analyze:
            raise UnsupportedQueryError(
                "EXPLAIN ANALYZE is not in this port yet: it comes with "
                "stats/tracing (queue A item 8)")
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
            return ResultSet(["QUERY PLAN"], {"QUERY PLAN": lines},
                             len(lines))
        finally:
            for t in cleanup:
                self._drop_temp(t)

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
            result = self._execute_select(self._sub_params(inner))
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
            return self._execute_select(
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
        return self._execute_select(self._sub_params(inner))

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
            self._execute_select(self._sub_params(sel)), cleanup,
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
