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
EXCEPT) run over one combined temp.  Every temp is dropped when its
statement ends.

Not in this port yet: DML beyond ingest, transactions, prepared
statements, EXPLAIN, UDFs, serving, WLM, replication, CDC, tracing,
streaming and the OOM ladder.
"""

from __future__ import annotations

import itertools
import os
import tempfile
import threading
from dataclasses import replace as dc_replace

import numpy as np

from .catalog import Catalog
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
from .planner.plan import DistributedPlanner, QueryPlan, StatsProvider
from .runtime import resolve_device
from .sql import ast, parse
from .storage import TableStore
from .types import (
    ColumnDef,
    DataType,
    TableSchema,
    date_to_days,
    sql_type_to_datatype,
)


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
        if isinstance(stmt, ast.SetOp):
            return self._execute_setop(stmt)
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
        """A statement or a subplan: plan, run, drop the temps."""
        plan, cleanup = self._plan_select(sel)
        try:
            return self.executor.execute_plan(plan)
        finally:
            for t in cleanup:
                self._drop_temp(t)

    def _plan_select(self, sel: ast.Select) -> tuple[QueryPlan, list[str]]:
        """Recursive planning, then bind and plan.  Returns the plan and
        the temps it materialised, which the caller drops (_drop_temp)
        once the plan has run."""
        cleanup: list[str] = []
        try:
            sel = self._recursive_plan(sel, cleanup)
            binder = Binder(self.catalog, _StoreDicts(self.store))
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

    # -- recursive planning ------------------------------------------------
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
            return self._execute_select(dc_replace(inner, **changes))

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
            return self._execute_select(
                self._setop_select(q, cleanup, cte_scope))
        return self._execute_select(
            self._recursive_plan(q, cleanup, cte_scope))

    def _query_to_temp(self, q, cleanup: list[str], cte_scope,
                       column_names: tuple[str, ...] = ()) -> str:
        """Select | SetOp → executed, its rows stored as a temp reference
        table (the intermediate-result broadcast analogue; CTE and
        derived-table bodies may be compound queries)."""
        if isinstance(q, ast.SetOp):
            sel = self._setop_select(q, cleanup, cte_scope)
        else:
            sel = self._recursive_plan(q, cleanup, cte_scope)
        return self._store_result(self._execute_select(sel), cleanup,
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
