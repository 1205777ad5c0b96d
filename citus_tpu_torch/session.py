"""Session: the port's connection object (SQL in, ResultSet out).

Counterpart of citus_tpu/session.py, carrying only what the first slice
needs: CREATE TABLE, create_distributed_table / create_reference_table,
the bulk TPC-H load (ingest.tpch.load_into_session), SET, and read-only
SELECT through binder → planner → feeds → PlanCompiler → runner on the
session's device.  A Session opens any data_dir the JAX package wrote
(same catalog, manifests, stripes and dictionaries) and the JAX package
opens the port's.

Not in this slice: DML beyond ingest, transactions, prepared statements,
EXPLAIN, subqueries and WITH (refused with UnsupportedQueryError before
binding), UDFs, serving, WLM, replication, CDC, tracing, streaming and
the OOM ladder.
"""

from __future__ import annotations

import os
import tempfile

from .catalog import Catalog
from .config import Settings
from .errors import CatalogError, UnsupportedQueryError
from .executor.runner import Executor, ResultSet
from .planner.bind import Binder, DictProvider
from .planner.plan import DistributedPlanner, QueryPlan, StatsProvider
from .runtime import resolve_device
from .sql import ast, parse
from .storage import TableStore
from .types import ColumnDef, DataType, TableSchema, sql_type_to_datatype


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


def _refuse_recursive_shapes(sel: ast.Select) -> None:
    """Refuse the shapes the reference plans recursively before binding
    (citus_tpu/session.py _recursive_plan): WITH, subqueries in FROM,
    and scalar, IN and EXISTS subqueries.  The port has no recursive
    planning yet, and the binder takes none of them."""
    if sel.ctes:
        raise UnsupportedQueryError("WITH queries are not in this port yet")
    exprs = [it.expr for it in sel.items] + list(sel.group_by) + [
        o.expr for o in sel.order_by] + [
        e for e in (sel.where, sel.having) if e is not None]
    items = list(sel.from_items)
    while items:
        item = items.pop()
        if isinstance(item, ast.SubqueryRef):
            raise UnsupportedQueryError(
                "subqueries in FROM are not in this port yet")
        if isinstance(item, ast.Join):
            items += [item.left, item.right]
            if item.condition is not None:
                exprs.append(item.condition)
    for e in exprs:
        for node in ast.walk_expr(e):
            if isinstance(node, ast.ScalarSubquery):
                raise UnsupportedQueryError(
                    "scalar subqueries are not in this port yet")
            if isinstance(node, ast.InSubquery):
                raise UnsupportedQueryError(
                    "IN (subquery) is not in this port yet")
            if isinstance(node, ast.Exists):
                raise UnsupportedQueryError(
                    "EXISTS (subquery) is not in this port yet")


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

    # ------------------------------------------------------------------
    def execute(self, sql: str):
        """Run a SQL script; returns the last statement's ResultSet/None."""
        self.catalog.maybe_reload(os.path.join(self.data_dir,
                                               "catalog.json"))
        result = None
        for stmt in parse(sql):
            result = self._execute_statement(stmt)
        return result

    def _execute_statement(self, stmt: ast.Statement):
        if isinstance(stmt, ast.Select):
            return self._execute_select(stmt)
        if isinstance(stmt, ast.CreateTable):
            return self._execute_create_table(stmt)
        if isinstance(stmt, ast.SetVariable):
            self.settings.set(stmt.name, stmt.value)
            return None
        if isinstance(stmt, ast.ShowVariable) and stmt.name != "all":
            return ResultSet(["setting"],
                             {"setting": [str(self.settings.get(
                                 stmt.name))]}, 1)
        raise UnsupportedQueryError(
            f"{type(stmt).__name__} is not in this port yet")

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

    def _execute_select(self, sel: ast.Select) -> ResultSet:
        return self.executor.execute_plan(self.plan_select(sel))

    def plan_select(self, sel: ast.Select) -> QueryPlan:
        _refuse_recursive_shapes(sel)
        binder = Binder(self.catalog, _StoreDicts(self.store))
        bound = binder.bind_select(sel)
        planner = DistributedPlanner(
            self.catalog, _StoreStats(self.store), self.n_devices,
            self.settings.get("enable_repartition_joins"),
            dicts=_StoreDicts(self.store), device=self.device)
        return planner.plan(bound)

    def _save_catalog(self):
        self.catalog.save(os.path.join(self.data_dir, "catalog.json"))
