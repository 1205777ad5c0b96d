"""SQL abstract syntax tree.

The reference consumes PostgreSQL's parse trees (Query nodes) directly; this
framework owns its SQL surface, so the AST is defined here.  Node inventory
is scoped to the query shapes the planner cascade supports (TPC-H-class
analytics + DDL/COPY/INSERT), per SURVEY.md §7 "SQL surface control".

All nodes are frozen dataclasses: hashable, comparable, safe as plan-cache
keys (the reference relies on PG plan-cache invariants for the same purpose).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


class Node:
    """Marker base class."""


# --------------------------------------------------------------------------
# expressions
# --------------------------------------------------------------------------

class Expr(Node):
    pass


@dataclass(frozen=True)
class ColumnRef(Expr):
    name: str
    table: Optional[str] = None  # qualifier as written (alias or table)

    def __str__(self):
        return f"{self.table}.{self.name}" if self.table else self.name


@dataclass(frozen=True)
class Literal(Expr):
    value: object          # int | float | str | bool | None
    type_hint: str = ""    # "" | "date" | "interval"
    interval_unit: str = ""  # day/month/year for intervals

    def __str__(self):
        if self.type_hint == "date":
            return f"DATE '{self.value}'"
        if self.type_hint == "interval":
            return f"INTERVAL '{self.value}' {self.interval_unit.upper()}"
        if isinstance(self.value, str):
            escaped = self.value.replace("'", "''")
            return f"'{escaped}'"
        if self.value is None:
            return "NULL"
        return str(self.value)


@dataclass(frozen=True)
class Param(Expr):
    """Prepared-statement parameter $N (0-based index)."""

    index: int

    def __str__(self):
        return f"${self.index + 1}"


@dataclass(frozen=True)
class Star(Expr):
    table: Optional[str] = None

    def __str__(self):
        return f"{self.table}.*" if self.table else "*"


@dataclass(frozen=True)
class BinaryOp(Expr):
    op: str  # + - * / % = <> < <= > >= AND OR ||
    left: Expr
    right: Expr

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # NOT, -
    operand: Expr

    def __str__(self):
        return f"({self.op} {self.operand})"


@dataclass(frozen=True)
class IsNull(Expr):
    operand: Expr
    negated: bool = False

    def __str__(self):
        return f"({self.operand} IS {'NOT ' if self.negated else ''}NULL)"


@dataclass(frozen=True)
class Between(Expr):
    operand: Expr
    low: Expr
    high: Expr
    negated: bool = False

    def __str__(self):
        neg = "NOT " if self.negated else ""
        return f"({self.operand} {neg}BETWEEN {self.low} AND {self.high})"


@dataclass(frozen=True)
class InList(Expr):
    operand: Expr
    items: tuple[Expr, ...]
    negated: bool = False

    def __str__(self):
        neg = "NOT " if self.negated else ""
        return f"({self.operand} {neg}IN ({', '.join(map(str, self.items))}))"


@dataclass(frozen=True)
class Like(Expr):
    operand: Expr
    pattern: Expr
    negated: bool = False

    def __str__(self):
        neg = "NOT " if self.negated else ""
        return f"({self.operand} {neg}LIKE {self.pattern})"


@dataclass(frozen=True)
class WindowSpec(Node):
    """OVER (PARTITION BY … ORDER BY …) clause."""

    partition_by: tuple[Expr, ...] = ()
    order_by: tuple[tuple[Expr, bool], ...] = ()   # (expr, descending)

    def __str__(self):
        parts = []
        if self.partition_by:
            parts.append("PARTITION BY "
                         + ", ".join(map(str, self.partition_by)))
        if self.order_by:
            parts.append("ORDER BY " + ", ".join(
                f"{e}{' DESC' if d else ''}" for e, d in self.order_by))
        return f"OVER ({' '.join(parts)})"


@dataclass(frozen=True)
class FuncCall(Expr):
    name: str                 # lowercased
    args: tuple[Expr, ...]
    distinct: bool = False    # count(DISTINCT x)
    star: bool = False        # count(*)
    window: WindowSpec | None = None   # OVER (...) → window function

    def __str__(self):
        if self.star:
            base = f"{self.name}(*)"
        else:
            d = "DISTINCT " if self.distinct else ""
            base = f"{self.name}({d}{', '.join(map(str, self.args))})"
        return f"{base} {self.window}" if self.window else base


@dataclass(frozen=True)
class Cast(Expr):
    operand: Expr
    type_name: str

    def __str__(self):
        return f"CAST({self.operand} AS {self.type_name})"


@dataclass(frozen=True)
class Extract(Expr):
    part: str  # year | month | day
    operand: Expr

    def __str__(self):
        return f"EXTRACT({self.part.upper()} FROM {self.operand})"


@dataclass(frozen=True)
class Substring(Expr):
    operand: Expr
    start: Expr            # 1-based
    length: Optional[Expr] = None

    def __str__(self):
        if self.length is None:
            return f"SUBSTRING({self.operand} FROM {self.start})"
        return f"SUBSTRING({self.operand} FROM {self.start} FOR {self.length})"


@dataclass(frozen=True)
class CaseWhen(Expr):
    whens: tuple[tuple[Expr, Expr], ...]  # (condition, result)
    else_result: Optional[Expr] = None

    def __str__(self):
        parts = " ".join(f"WHEN {c} THEN {r}" for c, r in self.whens)
        els = f" ELSE {self.else_result}" if self.else_result is not None else ""
        return f"CASE {parts}{els} END"


@dataclass(frozen=True)
class ScalarSubquery(Expr):
    query: "Select"

    def __str__(self):
        return "(<subquery>)"


@dataclass(frozen=True)
class InSubquery(Expr):
    operand: Expr
    query: "Select"
    negated: bool = False

    def __str__(self):
        neg = "NOT " if self.negated else ""
        return f"({self.operand} {neg}IN (<subquery>))"


@dataclass(frozen=True)
class Exists(Expr):
    query: "Select"
    negated: bool = False

    def __str__(self):
        neg = "NOT " if self.negated else ""
        return f"{neg}EXISTS (<subquery>)"


AGGREGATE_FUNCS = frozenset({"count", "sum", "avg", "min", "max",
                             "approx_count_distinct",
                             "approx_percentile"})


def is_aggregate_call(e: Expr) -> bool:
    return isinstance(e, FuncCall) and e.name in AGGREGATE_FUNCS


def contains_aggregate(e: Expr) -> bool:
    if is_aggregate_call(e):
        return True
    return any(contains_aggregate(c) for c in expr_children(e))


def expr_children(e: Expr) -> tuple[Expr, ...]:
    if isinstance(e, BinaryOp):
        return (e.left, e.right)
    if isinstance(e, UnaryOp):
        return (e.operand,)
    if isinstance(e, IsNull):
        return (e.operand,)
    if isinstance(e, Between):
        return (e.operand, e.low, e.high)
    if isinstance(e, InList):
        return (e.operand,) + e.items
    if isinstance(e, Like):
        return (e.operand, e.pattern)
    if isinstance(e, FuncCall):
        return e.args
    if isinstance(e, Cast):
        return (e.operand,)
    if isinstance(e, Extract):
        return (e.operand,)
    if isinstance(e, Substring):
        return ((e.operand, e.start) +
                ((e.length,) if e.length is not None else ()))
    if isinstance(e, CaseWhen):
        out: tuple[Expr, ...] = ()
        for c, r in e.whens:
            out += (c, r)
        if e.else_result is not None:
            out += (e.else_result,)
        return out
    if isinstance(e, InSubquery):
        return (e.operand,)
    return ()


def walk_expr(e: Expr):
    yield e
    for c in expr_children(e):
        yield from walk_expr(c)


def collect_column_refs(e: Expr) -> list[ColumnRef]:
    return [n for n in walk_expr(e) if isinstance(n, ColumnRef)]


# --------------------------------------------------------------------------
# FROM items / joins
# --------------------------------------------------------------------------

class FromItem(Node):
    pass


@dataclass(frozen=True)
class TableRef(FromItem):
    name: str
    alias: Optional[str] = None

    @property
    def output_name(self) -> str:
        return self.alias or self.name

    def __str__(self):
        return f"{self.name} {self.alias}" if self.alias else self.name


@dataclass(frozen=True)
class SubqueryRef(FromItem):
    query: "Select"
    alias: str

    @property
    def output_name(self) -> str:
        return self.alias

    def __str__(self):
        return f"(<subquery>) {self.alias}"


@dataclass(frozen=True)
class Join(FromItem):
    join_type: str  # inner | left | right | full | cross
    left: FromItem
    right: FromItem
    condition: Optional[Expr] = None   # ON clause; None for cross/USING
    using_cols: tuple[str, ...] = ()   # USING (...) — expanded by the binder

    def __str__(self):
        if self.using_cols:
            return (f"({self.left} {self.join_type.upper()} JOIN "
                    f"{self.right} USING ({', '.join(self.using_cols)}))")
        cond = f" ON {self.condition}" if self.condition is not None else ""
        return f"({self.left} {self.join_type.upper()} JOIN {self.right}{cond})"


# --------------------------------------------------------------------------
# statements
# --------------------------------------------------------------------------

class Statement(Node):
    pass


@dataclass(frozen=True)
class SelectItem(Node):
    expr: Expr
    alias: Optional[str] = None

    def __str__(self):
        return f"{self.expr} AS {self.alias}" if self.alias else str(self.expr)


@dataclass(frozen=True)
class OrderItem(Node):
    expr: Expr
    descending: bool = False
    nulls_first: Optional[bool] = None

    def __str__(self):
        return f"{self.expr} {'DESC' if self.descending else 'ASC'}"


@dataclass(frozen=True)
class CommonTableExpr(Node):
    name: str
    query: "Select"
    column_names: tuple[str, ...] = ()


@dataclass(frozen=True)
class SemiJoin(Node):
    """A WHERE-level EXISTS / NOT EXISTS decorrelated into a join: the
    whole FROM tree semi-joins (anti-joins) `item` on `condition`.  Only
    produced by the decorrelation rewrite (planner/decorrelate.py) — no
    SQL surface spells it directly.  `item`'s columns are invisible to
    the rest of the query."""

    join_type: str        # semi | anti
    item: FromItem        # TableRef after recursive planning
    condition: Expr       # correlation predicates (AND-conjoined)


@dataclass(frozen=True)
class Select(Statement):
    items: tuple[SelectItem, ...]
    from_items: tuple[FromItem, ...] = ()   # comma-separated = implicit cross
    where: Optional[Expr] = None
    group_by: tuple[Expr, ...] = ()
    having: Optional[Expr] = None
    order_by: tuple[OrderItem, ...] = ()
    limit: Optional[int] = None
    offset: Optional[int] = None
    distinct: bool = False
    ctes: tuple[CommonTableExpr, ...] = ()
    # decorrelated EXISTS/NOT EXISTS clauses (applied after from_items)
    semi_joins: tuple[SemiJoin, ...] = ()


@dataclass(frozen=True)
class SetOp(Statement):
    """Compound query: UNION [ALL] / INTERSECT / EXCEPT.  `left`/`right`
    are Select or nested SetOp; ORDER BY / LIMIT / OFFSET apply to the
    combined result (SQL scoping).  INTERSECT ALL / EXCEPT ALL are
    rejected at execution (bag semantics need per-group multiplicity
    matching)."""

    op: str                 # union | intersect | except
    all: bool
    left: Statement
    right: Statement
    order_by: tuple[OrderItem, ...] = ()
    limit: Optional[int] = None
    offset: Optional[int] = None
    ctes: tuple[CommonTableExpr, ...] = ()


@dataclass(frozen=True)
class ColumnSpec(Node):
    name: str
    type_name: str
    not_null: bool = False


@dataclass(frozen=True)
class CreateTable(Statement):
    name: str
    columns: tuple[ColumnSpec, ...]
    if_not_exists: bool = False


@dataclass(frozen=True)
class CreateSequence(Statement):
    name: str
    start: int = 1
    increment: int = 1


@dataclass(frozen=True)
class DropSequence(Statement):
    name: str
    if_exists: bool = False


@dataclass(frozen=True)
class DropTable(Statement):
    name: str
    if_exists: bool = False


@dataclass(frozen=True)
class CreateView(Statement):
    """CREATE [OR REPLACE] VIEW name [(cols)] AS select.

    Views are propagated catalog objects in the reference
    (commands/view.c:1-832); here the definition persists in the catalog
    and references expand as derived tables at planning time."""

    name: str
    columns: tuple[str, ...]    # () = take names from the select list
    sql: str                    # the view body's SQL text
    or_replace: bool = False


@dataclass(frozen=True)
class DropView(Statement):
    name: str
    if_exists: bool = False


@dataclass(frozen=True)
class AlterTable(Statement):
    """ALTER TABLE … ADD/DROP/RENAME COLUMN (manifest-level schema
    evolution; reference: commands/alter_table.c)."""

    table: str
    action: str                        # add_column | drop_column | rename_column
    column: ColumnSpec | None = None   # for add_column
    column_name: str = ""              # for drop/rename
    new_name: str = ""                 # for rename_column
    if_not_exists: bool = False        # ADD COLUMN IF NOT EXISTS
    if_exists: bool = False            # DROP COLUMN IF EXISTS


@dataclass(frozen=True)
class InsertValues(Statement):
    table: str
    columns: tuple[str, ...]          # empty = all, in schema order
    rows: tuple[tuple[Expr, ...], ...]


@dataclass(frozen=True)
class InsertSelect(Statement):
    table: str
    columns: tuple[str, ...]
    query: Select


@dataclass(frozen=True)
class Assignment(Node):
    column: str
    value: Expr


@dataclass(frozen=True)
class Update(Statement):
    table: str
    alias: Optional[str]
    assignments: tuple[Assignment, ...]
    where: Optional[Expr] = None


@dataclass(frozen=True)
class Delete(Statement):
    table: str
    alias: Optional[str] = None
    where: Optional[Expr] = None


@dataclass(frozen=True)
class MergeAction(Node):
    """One WHEN [NOT] MATCHED [AND cond] THEN <action> clause."""

    kind: str                                  # update | delete | insert | nothing
    condition: Optional[Expr] = None
    assignments: tuple[Assignment, ...] = ()   # kind == update
    insert_columns: tuple[str, ...] = ()       # kind == insert; empty = all
    insert_values: tuple[Expr, ...] = ()


@dataclass(frozen=True)
class Merge(Statement):
    target: str
    target_alias: Optional[str]
    source: FromItem          # TableRef or SubqueryRef
    on: Expr
    matched: tuple[MergeAction, ...] = ()
    not_matched: tuple[MergeAction, ...] = ()


@dataclass(frozen=True)
class CopyFrom(Statement):
    table: str
    path: str
    format: str = "csv"     # csv | text(tbl)
    delimiter: str = ","
    header: bool = False
    null_string: str = ""


@dataclass(frozen=True)
class Explain(Statement):
    statement: Statement
    analyze: bool = False
    verbose: bool = False


@dataclass(frozen=True)
class TransactionStmt(Statement):
    kind: str  # begin | commit | rollback


@dataclass(frozen=True)
class Prepare(Statement):
    """PREPARE name AS <statement> (ref: PG prepared statements; Citus
    caches the distributed plan per shard interval,
    planner/local_plan_cache.c)."""

    name: str
    statement: Statement


@dataclass(frozen=True)
class ExecutePrepared(Statement):
    name: str
    args: tuple = ()  # Literal expressions


@dataclass(frozen=True)
class Deallocate(Statement):
    name: str  # or "all"


@dataclass(frozen=True)
class SetVariable(Statement):
    name: str
    value: object


@dataclass(frozen=True)
class ShowVariable(Statement):
    name: str  # or "all"
