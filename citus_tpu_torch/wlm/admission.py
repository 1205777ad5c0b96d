"""Statement classification for the workload manager.

Counterpart of citus_tpu/wlm/admission.py.  Three questions, answered
from the parse tree and the catalog (no plan exists yet — admission sits
between parse and execution, where the reference's fast-path router
decides from the parse tree, fast_path_router_planner.c:530):

* **exempt?** — utility and transaction-control statements, admin-UDF
  calls and single-shard fast-path point reads skip the gate: they are
  host-only and cheap, and blocking BEGIN/COMMIT behind a slot could
  wedge a transaction whose statements already hold locks.  (The
  session also exempts every statement inside an open transaction —
  session state, not statement shape; see Session._execute_admitted.)
* **which tenant / class?** — the session's ``wlm_tenant``, else the
  tenant key the statement pins via ``distcol = const``, else
  ``"default"``.  The class is the session's ``wlm_default_priority``.
* **planned feed bytes?** — the device bytes the statement's base tables
  would feed plus a coarse estimate of its plan intermediates.  On-disk
  shard sizes stand in for tensor bytes: the gate guards against gross
  oversubscription, streaming bounds the residency of any one statement.
  The per-position figure is the hottest position's: shard bytes fold
  onto the mesh positions through `planner/plan.table_placement`, as the
  JAX package's estimate does (at one position, the whole table).
"""

from __future__ import annotations

from ..catalog import Catalog, DistributionMethod
from ..errors import CatalogError
from ..sql import ast

# statement kinds that never touch the device path
_EXEMPT_KINDS = (
    ast.TransactionStmt, ast.SetVariable, ast.ShowVariable,
    ast.Prepare, ast.Deallocate, ast.CreateView, ast.DropView,
    ast.CreateSequence, ast.DropSequence, ast.CreateTable,
    ast.DropTable, ast.AlterTable,
)


def _is_udf_call(sel: ast.Select, udfs) -> bool:
    return (not sel.from_items and len(sel.items) == 1
            and isinstance(sel.items[0].expr, ast.FuncCall)
            and sel.items[0].expr.name in udfs)


def fastpath_exempt_shape(sel: ast.Select, catalog: Catalog,
                          settings=None) -> bool:
    """Parse-tree fast-path shape, through the one shared matcher
    (serving/classify.py): a statement that skips the slot gate here is
    exactly one whose lookups the micro-batcher governs instead."""
    from ..serving.classify import classify_point_read

    return classify_point_read(sel, catalog, settings) is not None


def statement_exempt(stmt: ast.Statement, catalog: Catalog,
                     settings, udfs) -> bool:
    """True when `stmt` skips admission entirely.  `udfs` are the
    session's answered UDF names (session._UDFS)."""
    if isinstance(stmt, _EXEMPT_KINDS):
        return True
    if isinstance(stmt, ast.Explain):
        # plain EXPLAIN plans without executing; ANALYZE runs the query
        return not stmt.analyze
    if isinstance(stmt, ast.Select):
        if _is_udf_call(stmt, udfs):
            return True
        return fastpath_exempt_shape(stmt, catalog, settings)
    return False


def _collect_tables(fi: ast.FromItem, out: set[str]) -> None:
    if isinstance(fi, ast.TableRef):
        out.add(fi.name)
    elif isinstance(fi, ast.Join):
        _collect_tables(fi.left, out)
        _collect_tables(fi.right, out)
    elif isinstance(fi, ast.SubqueryRef):
        out.update(statement_tables(fi.query))


def statement_tables(stmt: ast.Statement) -> set[str]:
    """Base tables a statement's execution will feed (coarse: CTE and
    FROM-subquery bodies are included, views are not expanded)."""
    tables: set[str] = set()
    if isinstance(stmt, ast.Select):
        for fi in stmt.from_items:
            _collect_tables(fi, tables)
        for cte in stmt.ctes:
            tables.update(statement_tables(cte.query))
    elif isinstance(stmt, ast.SetOp):
        tables.update(statement_tables(stmt.left))
        tables.update(statement_tables(stmt.right))
    elif isinstance(stmt, (ast.Update, ast.Delete)):
        tables.add(stmt.table)
    elif isinstance(stmt, ast.Merge):
        tables.add(stmt.target)
        _collect_tables(stmt.source, tables)
    elif isinstance(stmt, ast.InsertSelect):
        tables.add(stmt.table)
        tables.update(statement_tables(stmt.query))
    elif isinstance(stmt, (ast.InsertValues, ast.CopyFrom)):
        tables.add(stmt.table)
    elif isinstance(stmt, ast.Explain):
        tables.update(statement_tables(stmt.statement))
    return tables


def read_tables(stmt: ast.Statement) -> set[str]:
    """Tables whose data the statement READS (what actually feeds the
    card).  Write-only targets are left out: INSERT VALUES / COPY route
    rows on the host in bounded batches and never feed the target."""
    if isinstance(stmt, (ast.InsertValues, ast.CopyFrom)):
        return set()
    if isinstance(stmt, ast.InsertSelect):
        return statement_tables(stmt.query)
    if isinstance(stmt, ast.Explain):
        return read_tables(stmt.statement)
    return statement_tables(stmt)


def _base_table_bytes(stmt: ast.Statement, catalog: Catalog, store,
                      n_devices: int) -> tuple[dict[str, int], int]:
    """Per-device feed bytes by table (the hottest device's sum, through
    the catalog's node↔device map) and the total row count of the
    statement's read tables."""
    per_table: dict[str, int] = {}
    rows = 0
    for t in read_tables(stmt):
        if not catalog.has_table(t):
            continue
        try:
            shards = catalog.table_shards(t)
            sizes = [store.shard_size_bytes(t, s.shard_id)
                     for s in shards]
            meta = catalog.table(t)
            rows += store.table_row_count(t)
            if meta.method == DistributionMethod.HASH and n_devices > 0:
                from ..planner.plan import table_placement

                # probe=False: an estimate must not consume a placement
                # fault armed for the execution path
                placement = table_placement(catalog, t, n_devices,
                                            probe=False)
                by_dev = [0] * n_devices
                for dev, b in zip(placement, sizes):
                    by_dev[dev] += b
                per_table[t] = max(by_dev) if by_dev else 0
            else:
                per_table[t] = sum(sizes)  # reference/local: whole copy
        except (CatalogError, OSError, KeyError):
            continue  # table dropped/moved mid-estimate: skip its bytes
    return per_table, rows


def _count_joins(stmt: ast.Statement) -> int:
    """Binary joins the statement's FROM clauses imply (explicit JOINs,
    comma sources, semi joins, subquery and CTE bodies)."""
    if isinstance(stmt, ast.Explain):
        return _count_joins(stmt.statement)
    if isinstance(stmt, ast.InsertSelect):
        return _count_joins(stmt.query)
    if isinstance(stmt, ast.SetOp):
        return _count_joins(stmt.left) + _count_joins(stmt.right)
    if isinstance(stmt, ast.Merge):
        return 1
    if not isinstance(stmt, ast.Select):
        return 0
    joins = 0

    def walk_fi(fi: ast.FromItem) -> None:
        nonlocal joins
        if isinstance(fi, ast.Join):
            joins += 1
            walk_fi(fi.left)
            walk_fi(fi.right)
        elif isinstance(fi, ast.SubqueryRef):
            joins += _count_joins(fi.query)

    for fi in stmt.from_items:
        walk_fi(fi)
    joins += max(0, len(stmt.from_items) - 1)
    joins += len(stmt.semi_joins)
    for cte in stmt.ctes:
        joins += _count_joins(cte.query)
    return joins


def _has_group_by(stmt: ast.Statement) -> bool:
    if isinstance(stmt, ast.Explain):
        return _has_group_by(stmt.statement)
    if isinstance(stmt, ast.InsertSelect):
        return _has_group_by(stmt.query)
    if isinstance(stmt, ast.SetOp):
        return _has_group_by(stmt.left) or _has_group_by(stmt.right)
    return isinstance(stmt, ast.Select) and bool(stmt.group_by)


def planned_intermediate_bytes(stmt: ast.Statement, catalog: Catalog,
                               store, n_devices: int,
                               settings=None) -> int:
    """Coarse estimate of the statement's plan intermediates: each join
    charges (repartition + output) headroom off the largest read table,
    a GROUP BY charges its grid slots off the total row count."""
    per_table, rows = _base_table_bytes(stmt, catalog, store, n_devices)
    return _intermediates_from(stmt, per_table, rows, n_devices,
                               settings)


def _intermediates_from(stmt: ast.Statement, per_table: dict[str, int],
                        rows: int, n_devices: int, settings) -> int:
    if not per_table:
        return 0
    biggest = max(per_table.values())
    repart_f = (settings.get("repartition_capacity_factor")
                if settings is not None else 1.5)
    join_f = (settings.get("join_output_capacity_factor")
              if settings is not None else 1.0)
    total = int(_count_joins(stmt) * (repart_f + join_f + 1.0) * biggest)
    if _has_group_by(stmt):
        from ..ops.groupby import GROUP_BUCKET_MAX_SLOTS

        slots = min(GROUP_BUCKET_MAX_SLOTS,
                    max(1, rows // max(1, n_devices)))
        n_out = len(stmt.items) if isinstance(stmt, ast.Select) else 4
        total += slots * 8 * (n_out + 2)
    return total


def planned_feed_bytes(stmt: ast.Statement, catalog: Catalog, store,
                       n_devices: int, settings=None) -> int:
    """Device-byte estimate for the admission gate: base-table feed
    bytes plus plan intermediates, from one table walk."""
    per_table, rows = _base_table_bytes(stmt, catalog, store, n_devices)
    return sum(per_table.values()) + _intermediates_from(
        stmt, per_table, rows, n_devices, settings)


def statement_tenant(stmt: ast.Statement, catalog: Catalog,
                     settings) -> str:
    """Tenant attribution for fair queueing: the session's identity
    first, else the statement's pinned tenant key, else 'default'."""
    explicit = settings.get("wlm_tenant")
    if explicit:
        return str(explicit)
    from ..stats import extract_tenants

    try:
        hits = extract_tenants(stmt, catalog)
    except Exception:  # noqa: BLE001 — attribution is best-effort
        hits = []
    if hits:
        return str(hits[0][1])
    return "default"
