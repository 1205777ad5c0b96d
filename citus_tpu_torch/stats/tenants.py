"""Per-tenant statistics — citus_stat_tenants analogue (Citus
src/backend/distributed/stats/stat_tenants.c).

Counterpart of citus_tpu/stats/tenants.py over the port's parse tree and
catalog: queries whose filters pin the distribution column to a constant
are attributed to that tenant; per-tenant counts and time accumulate
with a bounded table evicting the coldest tenants."""

from __future__ import annotations

import threading
from dataclasses import dataclass

from ..catalog import Catalog, DistributionMethod
from ..sql import ast


@dataclass
class TenantStat:
    tenant: str
    table: str
    query_count: int = 0
    total_time_ms: float = 0.0
    # recency stamp (a per-registry logical clock, bumped on every
    # record): the eviction tie-breaker — "coldest" means fewest
    # queries AND least-recently seen
    last_seen: int = 0


class TenantStats:
    def __init__(self, limit: int = 100):
        self.limit = limit
        self._lock = threading.Lock()
        self._stats: dict[tuple[str, str], TenantStat] = {}
        self._clock = 0

    def record(self, table: str, tenant, elapsed_ms: float) -> None:
        key = (table, str(tenant))
        with self._lock:
            self._clock += 1
            st = self._stats.get(key)
            if st is None:
                if len(self._stats) >= self.limit:
                    # deterministic coldest-first eviction: fewest
                    # queries, then least-recently seen, then key order
                    # (the old min() over query_count alone broke ties
                    # by dict insertion order — which tenant survived
                    # depended on arrival history, not coldness)
                    victim = min(
                        self._stats,
                        key=lambda k: (self._stats[k].query_count,
                                       self._stats[k].last_seen, k))
                    del self._stats[victim]
                st = self._stats[key] = TenantStat(str(tenant), table)
            st.query_count += 1
            st.last_seen = self._clock
            st.total_time_ms += elapsed_ms

    def entries(self) -> list[TenantStat]:
        with self._lock:
            # hottest first; deterministic order under ties
            return sorted(self._stats.values(),
                          key=lambda s: (-s.query_count, s.table,
                                         s.tenant))

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


def extract_tenants(stmt: ast.Statement,
                    catalog: Catalog) -> list[tuple[str, object]]:
    """(table, tenant_key) pairs a statement pins via `distcol = const`
    equality — the reference's AttributeTask-style partition-key capture."""
    from ..executor.host_eval import split_conjuncts

    refs: list[tuple[str, str | None]] = []  # (table, alias)
    where = None
    if isinstance(stmt, ast.Select):
        for fi in stmt.from_items:
            _collect_tables(fi, refs)
        where = stmt.where
    elif isinstance(stmt, (ast.Update, ast.Delete)):
        refs = [(stmt.table, stmt.alias)]
        where = stmt.where
    if not refs or where is None:
        return []
    # (qualifier-or-None, dist column) → table; qualifier-aware so
    # `a.customer_id = 7` never credits a different table's tenant
    dist: list[tuple[str, str, set[str]]] = []  # (table, distcol, quals)
    for t, alias in refs:
        if not catalog.has_table(t):
            continue
        meta = catalog.table(t)
        if meta.method == DistributionMethod.HASH:
            dist.append((t, meta.distribution_column,
                         {alias or t, t} if alias else {t}))
    if not dist:
        return []
    out = []
    for c in split_conjuncts(where):
        if (isinstance(c, ast.BinaryOp) and c.op == "="):
            ref, lit = None, None
            if isinstance(c.left, ast.ColumnRef) and \
                    isinstance(c.right, ast.Literal):
                ref, lit = c.left, c.right
            elif isinstance(c.right, ast.ColumnRef) and \
                    isinstance(c.left, ast.Literal):
                ref, lit = c.right, c.left
            if ref is None or lit.value is None:
                continue
            candidates = [
                (t, col) for t, col, quals in dist
                if col == ref.name
                and (ref.table in quals if ref.table else True)]
            # an unqualified match must be unambiguous across tables
            if len(candidates) == 1:
                out.append((candidates[0][0], lit.value))
    return out


def _collect_tables(fi: ast.FromItem,
                    out: list[tuple[str, str | None]]) -> None:
    if isinstance(fi, ast.TableRef):
        out.append((fi.name, fi.alias))
    elif isinstance(fi, ast.Join):
        _collect_tables(fi.left, out)
        _collect_tables(fi.right, out)
