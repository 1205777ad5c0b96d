"""Parse-tree fast-path point-read shape classifier (counterpart of
citus_tpu/serving/classify.py).

ONE matcher answers "is this statement a single-table
``distcol = const`` point read?" for every consumer:

* WLM admission exemption (wlm/admission.statement_exempt) — point
  reads skip the slot gate because the serving micro-batcher is their
  governor (they coalesce instead of queueing);
* the serving layer's EXPLAIN/observability surface (the "Serving:"
  line reports the statement's shape);
* tests, which assert both call sites classify a shared corpus
  identically.

The check mirrors (conservatively) the bound-plan matcher in
executor/fastpath.fast_path_shape — the reference accepts the same
slack between FastPathRouterQuery's parse-tree check and the real
router plan.  A statement classified here that the planner then routes
to the device still executes correctly; it just bypassed the gate.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..catalog import Catalog, DistributionMethod
from ..sql import ast


@dataclass(frozen=True)
class PointRead:
    """A classified point read: the pinned table / distribution column /
    literal key (the citus_stat_tenants attribution triple)."""

    table: str
    column: str
    value: object


def classify_point_read(sel: ast.Select, catalog: Catalog,
                        settings=None) -> PointRead | None:
    """Parse-tree fast-path shape: one hash-distributed table, the
    distribution column pinned to a non-NULL literal, no aggregates,
    subqueries, grouping or CTEs.  Returns the pinned (table, column,
    value) or None."""
    if settings is not None and \
            not settings.get("enable_fast_path_router"):
        return None
    if not isinstance(sel, ast.Select):
        return None
    if sel.ctes or sel.group_by or sel.having is not None or \
            sel.distinct or sel.semi_joins:
        return None
    if len(sel.from_items) != 1 or \
            not isinstance(sel.from_items[0], ast.TableRef):
        return None
    ref = sel.from_items[0]
    if not catalog.has_table(ref.name):
        return None
    meta = catalog.table(ref.name)
    if meta.method != DistributionMethod.HASH:
        return None
    if sel.where is None:
        return None
    # any function call (aggregate or otherwise) or nested subquery
    # disqualifies — the device path would run it
    exprs = [it.expr for it in sel.items] + [sel.where]
    for e in exprs:
        for n in ast.walk_expr(e):
            if isinstance(n, (ast.FuncCall, ast.ScalarSubquery,
                              ast.InSubquery, ast.Exists)):
                return None
    from ..executor.host_eval import split_conjuncts

    dcol = meta.distribution_column
    quals = {ref.alias or ref.name, ref.name}
    for c in split_conjuncts(sel.where):
        if not (isinstance(c, ast.BinaryOp) and c.op == "="):
            continue
        col, lit = c.left, c.right
        if not isinstance(col, ast.ColumnRef):
            col, lit = c.right, c.left
        if isinstance(col, ast.ColumnRef) and \
                isinstance(lit, ast.Literal) and lit.value is not None \
                and col.name == dcol and \
                (col.table is None or col.table in quals):
            return PointRead(ref.name, dcol, lit.value)
    return None
