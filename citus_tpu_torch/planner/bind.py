"""Binder/analyzer: AST → bound query over the catalog.

Resolves names against the catalog (the reference leans on PostgreSQL's
analyzer; here it's ours), expands USING and stars, type-checks, folds
constant date arithmetic, and — the TPU-specific part — lowers STRING
predicates into dictionary-code space so the device never touches bytes:

    c_mktsegment = 'BUILDING'   →  code(c_mktsegment) = 17
    p_type LIKE '%BRASS'        →  code(p_type) IN {codes matching}
    n_name < 'G'                →  code(n_name) IN {codes of values < 'G'}

(The host-side dictionary is small; scanning it at bind time replaces
per-row string compares — late materialization.)

Subqueries/CTEs must already be flattened away by the session's recursive
planning pass (the GenerateSubplansForSubqueriesAndCTEs analogue,
Citus src/backend/distributed/planner/recursive_planning.c:223);
the binder rejects any that remain.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from ..catalog import Catalog, DistributionMethod
from ..errors import PlanningError, UnsupportedQueryError
from ..sql import ast
from ..types import ColumnDef, DataType, TableSchema, date_to_days
from . import expr as ir


@dataclass(frozen=True)
class BoundRel:
    """One FROM entry (range-table entry analogue)."""

    rel_index: int
    table: str
    alias: str
    schema: TableSchema

    def cid(self, column: str) -> str:
        return f"{self.rel_index}.{column}"


@dataclass(frozen=True)
class OuterJoinSpec:
    """One LEFT/RIGHT/FULL/SEMI/ANTI join step: the accumulated tree of
    previously bound rels joins one single relation (`right_rel_index`)
    with its own ON conjuncts (which must NOT merge into WHERE — null
    extension happens before WHERE filters).  join_type is relative to
    (tree, right_rel): 'left' preserves the tree, 'right' preserves the
    single rel, 'full' preserves both; 'semi'/'anti' (decorrelated
    EXISTS/NOT EXISTS) filter the tree by match existence and expose no
    right-side columns."""

    join_type: str
    tree_rels: frozenset[int]
    right_rel_index: int
    on: tuple[ir.BExpr, ...]


@dataclass
class BoundQuery:
    rels: list[BoundRel]
    # all join/filter conjuncts merged (inner-join semantics)
    conjuncts: list[ir.BExpr]
    select: list[tuple[ir.BExpr, str]]        # (expr, output name)
    group_by: list[ir.BExpr]
    having: ir.BExpr | None
    order_by: list[tuple[ir.BExpr, bool, bool | None]]  # (expr, desc, nulls_first)
    limit: int | None
    offset: int | None
    distinct: bool
    is_aggregate: bool
    # outer joins, in application order; rel indices whose columns may be
    # NULL-extended (multi_router_planner.c outer-join handling analogue)
    outer_joins: list[OuterJoinSpec] = field(default_factory=list)
    nullable_rels: frozenset[int] = frozenset()


class DictProvider:
    """(table, column) → Dictionary; implemented by the TableStore."""

    def dictionary(self, table: str, column: str):  # pragma: no cover
        raise NotImplementedError


def like_to_regex(pattern: str) -> re.Pattern:
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


MISSING_CODE = -2  # equality target for strings absent from the dictionary


class Binder:
    def __init__(self, catalog: Catalog, dicts: DictProvider,
                 params: tuple = ()):
        self.catalog = catalog
        self.dicts = dicts
        # prepared-statement argument values ($1 → params[0]); see BParam
        self.params = params

    # -- entry -------------------------------------------------------------
    def bind_select(self, sel: ast.Select) -> BoundQuery:
        if sel.ctes:
            raise PlanningError(
                "CTEs must be planned recursively before binding")
        rels: list[BoundRel] = []
        conjuncts: list[ir.BExpr] = []
        outer_joins: list[OuterJoinSpec] = []
        nullable: set[int] = set()
        for item in sel.from_items:
            self._bind_from_item(item, rels, conjuncts, outer_joins,
                                 nullable)
        if not rels:
            raise PlanningError("SELECT without FROM is not supported")
        scope = _Scope(rels)

        if sel.where is not None:
            w = self.bind_expr(sel.where, scope, allow_agg=False)
            conjuncts.extend(ir.split_conjuncts(w))

        select: list[tuple[ir.BExpr, str]] = []
        for i, it in enumerate(sel.items):
            if isinstance(it.expr, ast.Star):
                for rel in rels:
                    if it.expr.table and rel.alias != it.expr.table:
                        continue
                    for col in rel.schema.columns:
                        select.append((ir.BCol(rel.cid(col.name), col.dtype,
                                               rel.table, col.name,
                                               rel.rel_index), col.name))
                continue
            e = self.bind_expr(it.expr, scope)
            name = it.alias or _default_name(it.expr, i)
            select.append((e, name))

        alias_map = {name: e for e, name in select}

        group_by: list[ir.BExpr] = []
        for g in sel.group_by:
            group_by.append(self._bind_alias_or_expr(g, scope, alias_map,
                                                     select))

        having = None
        if sel.having is not None:
            having = self.bind_expr(sel.having, scope, allow_agg=True)

        order_by = []
        for o in sel.order_by:
            e = self._bind_alias_or_expr(o.expr, scope, alias_map, select,
                                         allow_agg=True)
            order_by.append((e, o.descending, o.nulls_first))

        is_aggregate = bool(group_by) or any(
            ir.contains_agg(e) for e, _ in select)
        if having is not None and not is_aggregate:
            raise PlanningError("HAVING requires GROUP BY or aggregates")
        if is_aggregate:
            self._check_grouping(select, group_by)

        # decorrelated EXISTS/NOT EXISTS: semi/anti join the whole FROM
        # tree against each subquery relation (bound AFTER select/where so
        # its columns are invisible to the rest of the query)
        for sj in sel.semi_joins:
            n_before = len(rels)
            tree = frozenset(range(n_before))
            if not isinstance(sj.item, ast.TableRef):
                raise PlanningError(
                    "semi-join subqueries must be planned recursively "
                    "before binding")
            self._bind_from_item(sj.item, rels, conjuncts, outer_joins,
                                 nullable)
            on = ir.split_conjuncts(
                self.bind_expr(sj.condition, _Scope(rels)))
            outer_joins.append(
                OuterJoinSpec(sj.join_type, tree, n_before, tuple(on)))

        conjuncts, outer_joins, nullable = _reduce_outer_joins(
            conjuncts, outer_joins, nullable)

        return BoundQuery(rels=rels, conjuncts=conjuncts, select=select,
                          group_by=group_by, having=having,
                          order_by=order_by, limit=sel.limit,
                          offset=sel.offset, distinct=sel.distinct,
                          is_aggregate=is_aggregate,
                          outer_joins=outer_joins,
                          nullable_rels=frozenset(nullable))

    # -- FROM --------------------------------------------------------------
    def _bind_from_item(self, item: ast.FromItem, rels: list[BoundRel],
                        conjuncts: list[ir.BExpr],
                        outer_joins: list[OuterJoinSpec],
                        nullable: set[int]) -> None:
        if isinstance(item, ast.TableRef):
            if not self.catalog.has_table(item.name):
                raise PlanningError(f"table {item.name!r} does not exist")
            meta = self.catalog.table(item.name)
            alias = item.alias or item.name
            for r in rels:
                if r.alias == alias:
                    raise PlanningError(f"duplicate table alias {alias!r}")
            rels.append(BoundRel(len(rels), item.name, alias, meta.schema))
            return
        if isinstance(item, ast.SubqueryRef):
            raise PlanningError(
                "FROM subqueries must be planned recursively before binding")
        if isinstance(item, ast.Join):
            if item.join_type not in ("inner", "cross", "left", "right",
                                      "full"):
                raise PlanningError(
                    f"{item.join_type.upper()} JOIN is not supported yet")
            n0 = len(rels)
            self._bind_from_item(item.left, rels, conjuncts, outer_joins,
                                 nullable)
            n_before = len(rels)
            self._bind_from_item(item.right, rels, conjuncts, outer_joins,
                                 nullable)
            scope = _Scope(rels)
            on = self._bind_join_condition(item, rels, n_before, scope)
            if item.join_type in ("inner", "cross"):
                conjuncts.extend(on)
                return
            # outer join: the right side must be a single relation (the
            # reference handles arbitrary trees; v1 covers the dominant
            # pattern — tree LEFT/RIGHT/FULL JOIN rel ON ...)
            if len(rels) - n_before != 1:
                raise PlanningError(
                    "outer join right side must be a single table")
            if not on:
                raise PlanningError(
                    "outer joins require an ON/USING condition")
            tree = frozenset(range(n0, n_before))
            spec = OuterJoinSpec(item.join_type, tree, n_before, tuple(on))
            outer_joins.append(spec)
            if item.join_type in ("left", "full"):
                nullable.add(n_before)
            if item.join_type in ("right", "full"):
                nullable.update(tree)
            return
        raise PlanningError(f"unsupported FROM item {type(item).__name__}")

    def _bind_join_condition(self, item: ast.Join, rels, n_before: int,
                             scope: "_Scope") -> list[ir.BExpr]:
        out: list[ir.BExpr] = []
        if item.using_cols:
            right_rel = rels[n_before]
            left_rels = rels[:n_before]
            for col in item.using_cols:
                lrel = _rel_with_column(left_rels, col)
                if lrel is None:
                    raise PlanningError(
                        f"USING column {col!r} not found on left side")
                if not right_rel.schema.has_column(col):
                    raise PlanningError(
                        f"USING column {col!r} not found on right side")
                lc = lrel.schema.column(col)
                rc = right_rel.schema.column(col)
                out.append(ir.BCmp(
                    "=",
                    ir.BCol(lrel.cid(col), lc.dtype, lrel.table, col,
                            lrel.rel_index),
                    ir.BCol(right_rel.cid(col), rc.dtype, right_rel.table,
                            col, right_rel.rel_index)))
        elif item.condition is not None:
            e = self.bind_expr(item.condition, scope)
            out.extend(ir.split_conjuncts(e))
        return out

    # -- expressions -------------------------------------------------------
    def bind_expr(self, e: ast.Expr, scope: "_Scope",
                  allow_agg: bool = True) -> ir.BExpr:
        # allow_agg=False marks aggregate-free contexts (WHERE, JOIN ON,
        # GROUP BY); SELECT items / HAVING / ORDER BY allow aggregates
        if isinstance(e, ast.Literal):
            return self._bind_literal(e)
        if isinstance(e, ast.Param):
            return self._bind_param(e)
        if isinstance(e, ast.ColumnRef):
            return scope.resolve(e)
        if isinstance(e, ast.BinaryOp):
            return self._bind_binary(e, scope, allow_agg)
        if isinstance(e, ast.UnaryOp):
            if e.op == "NOT":
                return ir.BBool("NOT", (self.bind_expr(e.operand, scope,
                                                       allow_agg),))
            operand = self.bind_expr(e.operand, scope, allow_agg)
            zero = ir.BConst(0, operand.dtype)
            return ir.BArith("-", zero, operand, operand.dtype)
        if isinstance(e, ast.IsNull):
            return ir.BIsNull(self.bind_expr(e.operand, scope, allow_agg),
                              e.negated)
        if isinstance(e, ast.Between):
            operand = self.bind_expr(e.operand, scope, allow_agg)
            if operand.dtype == DataType.STRING:
                lo = self._expect_str_literal(e.low)
                hi = self._expect_str_literal(e.high)
                codes = self._codes_where(operand,
                                          lambda v: lo <= v <= hi)
                return ir.BInConst(operand, codes, e.negated)
            low = self._coerce(self.bind_expr(e.low, scope, allow_agg),
                               operand.dtype)
            high = self._coerce(self.bind_expr(e.high, scope, allow_agg),
                                operand.dtype)
            inside = ir.BBool("AND", (ir.BCmp("<=", low, operand),
                                      ir.BCmp("<=", operand, high)))
            return ir.BBool("NOT", (inside,)) if e.negated else inside
        if isinstance(e, ast.InList):
            operand = self.bind_expr(e.operand, scope, allow_agg)
            if operand.dtype == DataType.STRING:
                wanted = {self._expect_str_literal(x) for x in e.items}
                codes = self._codes_where(operand, lambda v: v in wanted)
                return ir.BInConst(operand, codes, e.negated)
            vals = []
            for x in e.items:
                b = self.bind_expr(x, scope)
                if not isinstance(b, ir.BConst):
                    raise PlanningError("IN list items must be constants")
                vals.append(_coerce_const(b, operand.dtype))
            return ir.BInConst(operand, tuple(vals), e.negated)
        if isinstance(e, ast.Like):
            operand = self.bind_expr(e.operand, scope, allow_agg)
            if operand.dtype != DataType.STRING:
                raise PlanningError("LIKE requires a string operand")
            pattern = self._expect_str_literal(e.pattern)
            rx = like_to_regex(pattern)
            codes = self._codes_where(operand, lambda v: bool(rx.match(v)))
            return ir.BInConst(operand, codes, e.negated)
        if isinstance(e, ast.FuncCall):
            return self._bind_func(e, scope, allow_agg)
        if isinstance(e, ast.Cast):
            from ..types import sql_type_to_datatype

            operand = self.bind_expr(e.operand, scope, allow_agg)
            return ir.BCast(operand, sql_type_to_datatype(e.type_name))
        if isinstance(e, ast.Extract):
            operand = self.bind_expr(e.operand, scope, allow_agg)
            if operand.dtype != DataType.DATE:
                raise PlanningError("EXTRACT requires a date operand")
            return ir.BExtract(e.part, operand)
        if isinstance(e, ast.CaseWhen):
            whens = []
            results = []
            for c, r in e.whens:
                whens.append(self.bind_expr(c, scope, allow_agg))
                results.append(self.bind_expr(r, scope, allow_agg))
            else_r = (self.bind_expr(e.else_result, scope, allow_agg)
                      if e.else_result is not None else None)
            dtypes = [r.dtype for r in results] + (
                [else_r.dtype] if else_r is not None else [])
            if DataType.STRING in dtypes:
                raise UnsupportedQueryError(
                    "CASE with a text result is not in this port yet")
            dtype = dtypes[0]
            for d in dtypes[1:]:
                dtype = ir.promote(dtype, d)
            bound_whens = tuple(
                (w, self._coerce(r, dtype)) for w, r in zip(whens, results))
            if else_r is not None:
                else_r = self._coerce(else_r, dtype)
            return ir.BCase(bound_whens, else_r, dtype)
        if isinstance(e, (ast.ScalarSubquery, ast.InSubquery, ast.Exists)):
            raise PlanningError(
                "subqueries must be planned recursively before binding")
        if isinstance(e, ast.Substring):
            return self._bind_substring(e, scope, allow_agg)
        raise PlanningError(f"unsupported expression {type(e).__name__}")

    def _bind_substring(self, e: ast.Substring, scope: "_Scope",
                        allow_agg: bool) -> ir.BExpr:
        """SUBSTRING over a dictionary-encoded column → code-remap LUT:
        the (small) dictionary transforms host-side once; the device does
        one gather.  No per-row string ops ever reach the device."""
        operand = self.bind_expr(e.operand, scope, allow_agg)
        if operand.dtype != DataType.STRING:
            raise PlanningError("SUBSTRING requires a string operand")

        def int_lit(x, what):
            if isinstance(x, ast.Literal) and isinstance(x.value, int):
                return x.value
            raise PlanningError(f"SUBSTRING {what} must be an integer "
                                "literal")

        start = int_lit(e.start, "start")
        length = (int_lit(e.length, "length")
                  if e.length is not None else None)
        if start < 1 or (length is not None and length < 0):
            raise PlanningError("SUBSTRING bounds out of range")
        lo = start - 1
        hi = None if length is None else lo + length
        label = (f"substring({start})" if length is None
                 else f"substring({start},{length})")
        return self._bind_strmap(operand, lambda v: v[lo:hi], label)

    def _bind_strmap(self, operand: ir.BExpr, fn, label: str) -> ir.BExpr:
        values = self._string_values(operand)
        uniq: dict[str, int] = {}
        lut = []
        for v in values:
            lut.append(uniq.setdefault(fn(v), len(uniq)))
        if isinstance(operand, ir.BStrRemap):
            # compose remaps: one gather instead of two
            lut = [lut[c] for c in operand.lut]
            operand = operand.operand
        return ir.BStrRemap(operand, tuple(lut), tuple(uniq), label)

    def _string_values(self, col: ir.BExpr) -> tuple[str, ...]:
        if isinstance(col, ir.BStrRemap):
            return col.values
        d = self._dict_for(col)
        return tuple(d.values)

    def _bind_literal(self, e: ast.Literal) -> ir.BConst:
        if e.type_hint == "date":
            return ir.BConst(date_to_days(str(e.value)), DataType.DATE)
        if e.type_hint == "interval":
            return ir.BConst((int(e.value), e.interval_unit), DataType.INT32)
        if e.value is None:
            return ir.BConst(None, DataType.INT32)
        if isinstance(e.value, bool):
            return ir.BConst(e.value, DataType.BOOL)
        if isinstance(e.value, int):
            dt = DataType.INT64 if abs(e.value) > 2**31 - 1 else DataType.INT32
            return ir.BConst(e.value, dt)
        if isinstance(e.value, float):
            return ir.BConst(e.value, DataType.FLOAT64)
        return ir.BConst(str(e.value), DataType.STRING)

    def _bind_param(self, e: ast.Param) -> ir.BExpr:
        if e.index >= len(self.params):
            raise PlanningError(
                f"parameter ${e.index + 1} has no value (statement has "
                f"{len(self.params)} argument(s) — is it running outside "
                "EXECUTE?)")
        lit = self.params[e.index]
        if not isinstance(lit, ast.Literal):
            raise PlanningError("EXECUTE arguments must be literals")
        const = self._bind_literal(lit)
        # NULLs and intervals stay plain constants — their folding
        # machinery is literal-driven.  STRING params stay generic: the
        # raw text rides in the BParam and _bind_cmp translates it to a
        # dictionary CODE per execution (each EXECUTE re-binds, the
        # fingerprint excludes the value, so one compiled program serves
        # every string argument — the local_plan_cache.c behavior)
        if const.value is None or isinstance(const.value, tuple):
            return const
        return ir.BParam(e.index, const.dtype, const.value)

    def _bind_binary(self, e: ast.BinaryOp, scope: "_Scope",
                     allow_agg: bool = True) -> ir.BExpr:
        if e.op in ("AND", "OR"):
            return ir.BBool(e.op, (self.bind_expr(e.left, scope, allow_agg),
                                   self.bind_expr(e.right, scope,
                                                  allow_agg)))
        left = self.bind_expr(e.left, scope, allow_agg)
        right = self.bind_expr(e.right, scope, allow_agg)
        if e.op in ("+", "-", "*", "/", "%"):
            return self._bind_arith(e.op, left, right)
        if e.op in ("=", "<>", "<", "<=", ">", ">="):
            return self._bind_cmp(e.op, left, right)
        if e.op == "||":
            raise PlanningError("string concatenation on device is not supported")
        raise PlanningError(f"unsupported operator {e.op!r}")

    def _bind_arith(self, op: str, left: ir.BExpr, right: ir.BExpr) -> ir.BExpr:
        # interval folding: const date ± interval → const date
        for a, b, sign in ((left, right, 1), (right, left, 1)):
            if (isinstance(b, ir.BConst) and isinstance(b.value, tuple)):
                qty, unit = b.value
                if op == "-":
                    if b is right:
                        qty = -qty
                    else:
                        raise PlanningError("interval - date is invalid")
                elif op != "+":
                    raise PlanningError("intervals support only + and -")
                if a.dtype != DataType.DATE:
                    raise PlanningError("interval arithmetic needs a date")
                if isinstance(a, ir.BConst):
                    return ir.BConst(_shift_date(a.value, qty, unit),
                                     DataType.DATE)
                if unit == "day":
                    # column date ± N days stays exact
                    return ir.BArith("+", a, ir.BConst(qty, DataType.INT32),
                                     DataType.DATE)
                raise PlanningError(
                    "month/year interval arithmetic requires a constant date")
        if left.dtype == DataType.DATE and right.dtype == DataType.DATE:
            if op != "-":
                raise PlanningError("date + date is invalid")
            return ir.BArith("-", left, right, DataType.INT32)
        dtype = ir.promote(left.dtype, right.dtype)
        if op == "/" and dtype.type_class.value == "int":
            dtype = DataType.FLOAT64  # SQL-ish: promote to avoid silent trunc
        return ir.BArith(op, self._coerce(left, dtype),
                         self._coerce(right, dtype), dtype)

    def _bind_cmp(self, op: str, left: ir.BExpr, right: ir.BExpr) -> ir.BExpr:
        if DataType.STRING in (left.dtype, right.dtype):
            # normalize: column-ish on the left, literal/param on the right
            if isinstance(left, (ir.BConst, ir.BParam)) and \
                    left.dtype == DataType.STRING and \
                    not isinstance(right, (ir.BConst, ir.BParam)):
                left, right = right, left
                op = _flip_cmp(op)
            if isinstance(right, ir.BParam) and \
                    right.dtype == DataType.STRING:
                # generic plan: translate the string argument to this
                # column's dictionary code NOW but keep the node a param
                # — the code is the program INPUT, so a different string
                # on the next EXECUTE reuses the compiled plan
                if op not in ("=", "<>"):
                    # range predicates lower to a code SET (value-
                    # dependent shape): bake for this execution
                    codes = self._codes_where(
                        left, _str_cmp_fn(op, str(right.value)))
                    return ir.BInConst(left, codes)
                code = self._code_of(left, str(right.value))
                return ir.BCmp(op, left,
                               ir.BParam(right.idx, DataType.STRING, code))
            if not isinstance(right, ir.BConst):
                raise PlanningError(
                    "string-to-string column comparisons need dictionary "
                    "alignment (not supported yet)")
            text = str(right.value)
            if op == "=":
                code = self._code_of(left, text)
                return ir.BCmp("=", left, ir.BConst(code, DataType.STRING))
            if op == "<>":
                code = self._code_of(left, text)
                return ir.BCmp("<>", left, ir.BConst(code, DataType.STRING))
            codes = self._codes_where(left, _str_cmp_fn(op, text))
            return ir.BInConst(left, codes)
        dtype = ir.promote(left.dtype, right.dtype)
        return ir.BCmp(op, self._coerce(left, dtype),
                       self._coerce(right, dtype))

    _WINDOW_ONLY = ("row_number", "rank", "dense_rank")

    def _bind_func(self, e: ast.FuncCall, scope: "_Scope",
                   allow_agg: bool) -> ir.BExpr:
        if e.window is not None or e.name in self._WINDOW_ONLY:
            return self._bind_window(e, scope, allow_agg)
        if e.name == "__dd_bucket":
            # DDSketch bucket key (internal marker emitted by the
            # session's approx_percentile rewrite)
            if len(e.args) != 1:
                raise PlanningError("__dd_bucket takes one argument")
            arg = self.bind_expr(e.args[0], scope, allow_agg=False)
            return ir.BDDBucket(arg)
        if e.name in ast.AGGREGATE_FUNCS:
            if not allow_agg:
                raise PlanningError("aggregate not allowed here")
            if e.name == "approx_percentile":
                # the session rewrites supported shapes into a DDSketch
                # bucket pre-pass before binding ever sees the call
                raise UnsupportedQueryError(
                    "approx_percentile is supported over plain columns "
                    "with plain-column GROUP BY keys")
            if e.name == "approx_count_distinct":
                if len(e.args) != 1 or e.star:
                    raise PlanningError(
                        "approx_count_distinct takes exactly one argument")
                arg = self.bind_expr(e.args[0], scope, allow_agg=False)
                return ir.BAgg("approx_count_distinct", arg, False,
                               DataType.INT64)
            if e.star:
                return ir.BAgg("count_star", None, dtype=DataType.INT64)
            if len(e.args) != 1:
                raise PlanningError(f"{e.name} takes exactly one argument")
            arg = self.bind_expr(e.args[0], scope, allow_agg=False)
            if e.name == "count":
                return ir.BAgg("count", arg, e.distinct, DataType.INT64)
            if e.name in ("min", "max"):
                return ir.BAgg(e.name, arg, e.distinct, arg.dtype)
            # sum/avg promote to float64 accumulation (compute dtype applies
            # on device); sum over ints stays int64
            if e.name == "sum" and arg.dtype.type_class.value == "int":
                return ir.BAgg("sum", arg, e.distinct, DataType.INT64)
            return ir.BAgg(e.name, arg, e.distinct, DataType.FLOAT64)
        raise PlanningError(f"unsupported function {e.name!r}")

    def _bind_window(self, e: ast.FuncCall, scope: "_Scope",
                     allow_agg: bool) -> ir.BExpr:
        """OVER (...) call → BWindow (planned into a WindowNode)."""
        if not allow_agg:
            raise PlanningError(
                "window functions are not allowed here")
        if e.window is None:
            raise PlanningError(f"{e.name}() requires an OVER clause")
        if e.distinct:
            raise PlanningError("DISTINCT window aggregates are not "
                                "supported")
        part = tuple(self.bind_expr(p, scope, allow_agg=False)
                     for p in e.window.partition_by)
        order = tuple((self.bind_expr(o, scope, allow_agg=False), d)
                      for o, d in e.window.order_by)
        for o, _d in order:
            if o.dtype == DataType.STRING:
                # device sorts operate on dictionary CODES, which are in
                # insertion order — ranking by them would be wrong.
                # (PARTITION BY only needs equality, so codes are fine.)
                raise PlanningError(
                    "ORDER BY on a string column inside OVER (...) is "
                    "not supported; order by a non-string key")
        if e.name in self._WINDOW_ONLY:
            if e.args or e.star:
                raise PlanningError(f"{e.name}() takes no arguments")
            if not order:
                raise PlanningError(
                    f"{e.name}() requires ORDER BY in its OVER clause")
            return ir.BWindow(e.name, None, part, order, DataType.INT64)
        if e.name not in ast.AGGREGATE_FUNCS:
            raise PlanningError(
                f"unsupported window function {e.name!r}")
        if e.star and e.name != "count":
            raise PlanningError(f"{e.name}(*) is not a valid window call")
        if e.name == "count" and (e.star or not e.args):
            return ir.BWindow("count_star", None, part, order,
                              DataType.INT64)
        if len(e.args) != 1:
            raise PlanningError(f"{e.name} takes exactly one argument")
        arg = self.bind_expr(e.args[0], scope, allow_agg=False)
        if arg.dtype == DataType.STRING and e.name != "count":
            # min/max over codes would compare insertion order, and the
            # output could not be decoded (no single source column)
            raise PlanningError(
                f"window {e.name}() over a string column is not supported")
        if e.name == "count":
            return ir.BWindow("count", arg, part, order, DataType.INT64)
        if e.name in ("min", "max"):
            return ir.BWindow(e.name, arg, part, order, arg.dtype)
        if e.name == "sum" and arg.dtype.type_class.value == "int":
            return ir.BWindow("sum", arg, part, order, DataType.INT64)
        return ir.BWindow(e.name, arg, part, order, DataType.FLOAT64)

    # -- helpers -----------------------------------------------------------
    def _coerce(self, e: ir.BExpr, dtype: DataType) -> ir.BExpr:
        if e.dtype == dtype:
            return e
        if isinstance(e, ir.BConst):
            return _coerce_const_expr(e, dtype)
        if isinstance(e, ir.BParam):
            # coerce the VALUE and stay a param (a BCast wrapper would
            # hide the node from pruning / chunk-skip matching)
            coerced = _coerce_const_expr(ir.BConst(e.value, e.dtype), dtype)
            return ir.BParam(e.idx, dtype, coerced.value)
        return ir.BCast(e, dtype)

    def _expect_str_literal(self, e: ast.Expr) -> str:
        if isinstance(e, ast.Literal) and isinstance(e.value, str):
            return e.value
        raise PlanningError("expected a string literal")

    def _dict_for(self, col: ir.BExpr):
        if not isinstance(col, ir.BCol) or col.dtype != DataType.STRING:
            raise PlanningError("string predicate requires a string column")
        return self.dicts.dictionary(col.table, col.column)

    def _code_of(self, col: ir.BExpr, text: str) -> int:
        if isinstance(col, ir.BStrRemap):
            try:
                return col.values.index(text)
            except ValueError:
                return MISSING_CODE
        d = self._dict_for(col)
        code = d.code_of(text)
        return MISSING_CODE if code is None else code

    def _codes_where(self, col: ir.BExpr, pred) -> tuple[int, ...]:
        if isinstance(col, ir.BStrRemap):
            return tuple(i for i, v in enumerate(col.values) if pred(v))
        d = self._dict_for(col)
        return tuple(i for i, v in enumerate(d.values) if pred(v))

    def _bind_alias_or_expr(self, e: ast.Expr, scope: "_Scope",
                            alias_map: dict, select, allow_agg=False):
        # output-column aliases and 1-based positions (PG extension used by
        # GROUP BY/ORDER BY)
        if isinstance(e, ast.ColumnRef) and e.table is None and \
                e.name in alias_map and not scope.has_column(e.name):
            return alias_map[e.name]
        if isinstance(e, ast.Literal) and isinstance(e.value, int) \
                and not e.type_hint:
            pos = e.value
            if not 1 <= pos <= len(select):
                raise PlanningError(f"position {pos} is not in select list")
            return select[pos - 1][0]
        return self.bind_expr(e, scope, allow_agg=allow_agg)

    def _check_grouping(self, select, group_by):
        group_set = set(group_by)
        for e, name in select:
            if ir.contains_agg(e):
                continue
            if e in group_set:
                continue
            raise PlanningError(
                f"column {name!r} must appear in GROUP BY or be aggregated")


class _Scope:
    def __init__(self, rels: list[BoundRel]):
        self.rels = rels

    def has_column(self, name: str) -> bool:
        return any(r.schema.has_column(name) for r in self.rels)

    def resolve(self, ref: ast.ColumnRef) -> ir.BCol:
        matches = []
        for r in self.rels:
            if ref.table is not None and r.alias != ref.table:
                continue
            if r.schema.has_column(ref.name):
                matches.append(r)
        if not matches:
            where = f" in table {ref.table!r}" if ref.table else ""
            raise PlanningError(f"column {ref.name!r} does not exist{where}")
        if len(matches) > 1:
            raise PlanningError(f"column reference {ref.name!r} is ambiguous")
        rel = matches[0]
        col = rel.schema.column(ref.name)
        return ir.BCol(rel.cid(ref.name), col.dtype, rel.table, ref.name,
                       rel.rel_index)


def _rel_with_column(rels: list[BoundRel], col: str) -> BoundRel | None:
    found = None
    for r in rels:
        if r.schema.has_column(col):
            if found is not None:
                raise PlanningError(f"USING column {col!r} is ambiguous")
            found = r
    return found


def _default_name(e: ast.Expr, i: int) -> str:
    if isinstance(e, ast.ColumnRef):
        return e.name
    if isinstance(e, ast.FuncCall):
        return e.name
    return f"column{i + 1}"


def _flip_cmp(op: str) -> str:
    return {"=": "=", "<>": "<>", "<": ">", "<=": ">=", ">": "<",
            ">=": "<="}[op]


def _str_cmp_fn(op: str, text: str):
    import operator

    f = {"<": operator.lt, "<=": operator.le, ">": operator.gt,
         ">=": operator.ge}[op]
    return lambda v: f(v, text)


def _coerce_const(c: ir.BConst, dtype: DataType):
    return _coerce_const_expr(c, dtype).value


def _coerce_const_expr(c: ir.BConst, dtype: DataType) -> ir.BConst:
    v = c.value
    if v is None:
        return ir.BConst(None, dtype)
    if dtype in (DataType.INT32, DataType.INT64, DataType.DATE):
        if isinstance(v, float) and v != int(v):
            # keep exact comparisons exact: let the evaluator compare in float
            return ir.BConst(v, DataType.FLOAT64)
        return ir.BConst(int(v), dtype)
    if dtype in (DataType.FLOAT32, DataType.FLOAT64):
        return ir.BConst(float(v), dtype)
    if dtype == DataType.BOOL:
        return ir.BConst(bool(v), dtype)
    return ir.BConst(v, dtype)


def _shift_date(days: int, qty: int, unit: str) -> int:
    import datetime

    d = datetime.date(1970, 1, 1) + datetime.timedelta(days=int(days))
    if unit == "day":
        d = d + datetime.timedelta(days=qty)
    elif unit == "month":
        total = d.year * 12 + (d.month - 1) + qty
        y, m = divmod(total, 12)
        day = min(d.day, _days_in_month(y, m + 1))
        d = datetime.date(y, m + 1, day)
    elif unit == "year":
        day = min(d.day, _days_in_month(d.year + qty, d.month))
        d = datetime.date(d.year + qty, d.month, day)
    return (d - datetime.date(1970, 1, 1)).days


def _days_in_month(y: int, m: int) -> int:
    import calendar

    return calendar.monthrange(y, m)[1]


# -- outer-join reduction ---------------------------------------------------

def _null_propagating_rels(e: ir.BExpr) -> frozenset[int]:
    """Relations R such that a NULL in a referenced column of R forces
    `e` itself to evaluate to NULL.  Arithmetic, casts, extract and
    column references propagate; CASE, IS NULL, boolean logic and any
    unknown node kind can absorb a NULL into a non-NULL result, so
    recursion STOPS there (collecting their columns would wrongly mark
    null-tolerant predicates as strict)."""
    if isinstance(e, ir.BCol):
        return (frozenset((e.rel_index,)) if e.rel_index >= 0
                else frozenset())
    if isinstance(e, ir.BArith):
        return _null_propagating_rels(e.left) | \
            _null_propagating_rels(e.right)
    if isinstance(e, (ir.BCast, ir.BExtract)):
        return _null_propagating_rels(e.operand)
    return frozenset()  # constants, params, CASE, IS NULL, bool, agg, …


def _strict_rels(e: ir.BExpr) -> frozenset[int]:
    """Relations in which predicate `e` is null-rejecting: a NULL in any
    null-propagating referenced column of such a rel makes the predicate
    non-TRUE, so the row cannot survive WHERE/inner-ON filtering.
    Comparisons and IN are strict in the rels their null-propagating
    operands reference; AND unions, OR intersects; NOT is strict only
    over a bare comparison/IN (strictness of AND/OR children guarantees
    merely non-TRUE, and NOT FALSE is TRUE); IS NULL and unknown node
    kinds are never strict."""
    if isinstance(e, ir.BCmp):
        return _null_propagating_rels(e.left) | \
            _null_propagating_rels(e.right)
    if isinstance(e, ir.BInConst):
        return _null_propagating_rels(e.operand)
    if isinstance(e, ir.BBool):
        parts = [_strict_rels(a) for a in e.args]
        if not parts:
            return frozenset()
        if e.op == "AND":
            return frozenset().union(*parts)
        if e.op == "OR":
            out = parts[0]
            for p in parts[1:]:
                out &= p
            return out
        # NOT: strictness of the child only says "not TRUE" (could be
        # FALSE), and NOT FALSE is TRUE — so NOT preserves strictness
        # only over children that are themselves NULL-PROPAGATING
        # (a NULL input makes the child NULL, and NOT NULL is NULL):
        # direct comparisons / IN.  NOT(AND/OR/...) is never strict.
        child = e.args[0]
        if isinstance(child, (ir.BCmp, ir.BInConst)):
            return _strict_rels(child)
        return frozenset()
    return frozenset()


def _reduce_outer_joins(conjuncts, outer_joins, nullable):
    """Demote outer joins whose null-extended side cannot survive later
    strict predicates (the reduce_outer_joins transformation; the
    reference inherits it from PostgreSQL's planner prep).  A LEFT join
    whose nullable rel is referenced by a strict WHERE / inner-ON
    conjunct is really an inner join — demoting it frees the join-order
    search to use that rel's equi-join edges instead of falling into
    cartesian orders (and matches SQL semantics exactly).

    FULL joins reduce one side at a time (strict on the right side ⇒
    only the right-preserving half survives ⇒ RIGHT; and vice versa).
    Demoted ON conditions join the inner-conjunct pool, which may
    cascade further reductions — iterate to a fixpoint."""
    conjuncts = list(conjuncts)
    specs = list(outer_joins)
    changed = True
    while changed and specs:
        changed = False
        strict: frozenset[int] = frozenset()
        for c in conjuncts:
            strict |= _strict_rels(c)
        for i, spec in enumerate(specs):
            if spec.join_type in ("semi", "anti"):
                continue  # no null extension: nothing to reduce
            right = frozenset((spec.right_rel_index,))
            if spec.join_type == "left":
                reduce_now = bool(strict & right)
                new_type = "inner"
            elif spec.join_type == "right":
                reduce_now = bool(strict & spec.tree_rels)
                new_type = "inner"
            else:  # full
                hit_r = bool(strict & right)
                hit_t = bool(strict & spec.tree_rels)
                if hit_r and hit_t:
                    reduce_now, new_type = True, "inner"
                elif hit_r:
                    # strict on the RIGHT rel kills the tree-preserved
                    # rows (their right columns are the NULLs) — only
                    # right-preservation survives
                    specs[i] = OuterJoinSpec("right", spec.tree_rels,
                                             spec.right_rel_index, spec.on)
                    changed = True
                    continue
                elif hit_t:
                    # symmetric: strict on the tree side kills the
                    # right-preserved rows — tree-preservation survives
                    specs[i] = OuterJoinSpec("left", spec.tree_rels,
                                             spec.right_rel_index, spec.on)
                    changed = True
                    continue
                else:
                    reduce_now = False
                    new_type = "inner"
            if reduce_now and new_type == "inner":
                conjuncts.extend(spec.on)
                del specs[i]
                changed = True
                break
    new_nullable: set[int] = set()
    for spec in specs:
        if spec.join_type in ("left", "full"):
            new_nullable.add(spec.right_rel_index)
        if spec.join_type in ("right", "full"):
            new_nullable.update(spec.tree_rels)
    return conjuncts, specs, new_nullable
