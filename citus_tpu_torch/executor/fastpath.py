"""Fast-path router execution: single-shard queries skip the device.

Counterpart of citus_tpu/executor/fastpath.py.  The reference plans
`distcol = const` queries straight to one shard and bypasses the whole
distributed machinery (Citus src/backend/distributed/planner/
fast_path_router_planner.c:530, distributed_planner.c:719
PlanFastPathDistributedStmt).  The JAX package does the same on its
accelerator, and so does the port on the card: when every
hash-distributed scan prunes to at most ONE shard and the surviving rows
are few (fast_path_max_rows), building feeds and running the plan on
the device costs far more than the query itself.  This module executes
the SAME bound plan tree host-side with numpy — exact sizes, no
capacities, no device round trip — and reuses the executor's host
combine (HAVING / ORDER BY / LIMIT / decode) unchanged.  It is the
reference's own routing, not a fallback: the same statement with
enable_fast_path_router off runs on the device.

A table with rows staged by the open transaction never answers through
the point index (index_probe), as in the JAX package.

Scope: Scan / Project / inner+left Join plans.  Aggregates and
right/full joins take the device path.  The row ceiling keeps the host
from scanning big shards a devious filter failed to prune.
"""

from __future__ import annotations

import numpy as np

from ..catalog import DistributionMethod
from ..planner import expr as ir
from ..planner.plan import JoinNode, ProjectNode, QueryPlan, ScanNode
from ..types import DataType
from .feed import make_chunk_filter, walk_plan
from .host_exprs import ColumnSource, evaluate, predicate_mask


def _conjuncts(e):
    if isinstance(e, ir.BBool) and e.op == "AND":
        return [c for a in e.args for c in _conjuncts(a)]
    return [e]


def point_lookup_const(node: ScanNode, catalog, settings=None):
    """Structural point-index eligibility: the distribution-column
    equality constant when the plan shape qualifies for the persistent
    point-lookup index (storage/pkindex.py); else None.  Shared by the
    executor and EXPLAIN so the plan display cannot drift from the
    runtime's matcher.  As in the reference, only a literal qualifies:
    a prepared statement's $n scans its one shard instead."""
    if settings is not None and \
            not settings.get("enable_point_lookup_index"):
        return None
    if node.filter is None or node.pruned_shards is None or \
            len(node.pruned_shards) != 1:
        return None
    meta = catalog.table(node.rel.table)
    if meta.method != DistributionMethod.HASH:
        return None
    dcol = meta.distribution_column
    if meta.schema.column(dcol).dtype not in (
            DataType.INT32, DataType.INT64, DataType.DATE):
        return None
    for c in _conjuncts(node.filter):
        if isinstance(c, ir.BCmp) and c.op == "=":
            col, const = c.left, c.right
            if not isinstance(col, ir.BCol):
                col, const = c.right, c.left
            if isinstance(col, ir.BCol) and isinstance(const, ir.BConst) \
                    and col.column == dcol \
                    and col.table == node.rel.table \
                    and isinstance(const.value, (int, np.integer)):
                return int(const.value)
    return None


def index_probe(executor, node: ScanNode):
    """point_lookup_const + this session's transaction state: staged
    overlay rows are invisible to the index, so report ineligible here
    and the row-ceiling gate counts the shard instead of assuming an
    indexed answer."""
    value = point_lookup_const(node, executor.catalog, executor.settings)
    if value is None:
        return None
    store = executor.store
    if store.overlay is not None and (
            any(t == node.rel.table for (t, _s) in store.overlay.records)):
        return None
    return value


def fast_path_shape(plan: QueryPlan, catalog) -> bool:
    """Structural eligibility: Scan/Project/inner+left-Join plans whose
    hash-distributed scans all prune to at most one shard.  Shared by
    the executor and EXPLAIN (the executor adds the setting and the row
    count on top)."""
    pruned_any = False
    for node in walk_plan(plan.root):
        if isinstance(node, ProjectNode):
            continue
        if isinstance(node, JoinNode):
            if node.join_type not in ("inner", "left"):
                return False
            # the device compiler refuses float keys with PlanningError;
            # they must not silently truncate here
            for e in (*node.left_keys, *node.right_keys):
                if e.dtype.value in ("float32", "float64"):
                    return False
        elif isinstance(node, ScanNode):
            meta = catalog.table(node.rel.table)
            if meta.method == DistributionMethod.HASH:
                if node.pruned_shards is None or \
                        len(node.pruned_shards) > 1:
                    return False
                pruned_any = True
        else:
            return False  # aggregates and windows take the device path
    return pruned_any


def try_execute_fast_path(executor, plan: QueryPlan, raw: bool = False):
    """Host-side execution, or None when the plan doesn't qualify.
    `raw` keeps the result typed (executor._host_combine)."""
    if not executor.settings.get("enable_fast_path_router"):
        return None
    if not fast_path_shape(plan, executor.catalog):
        return None
    max_rows = executor.settings.get("fast_path_max_rows")
    total = 0
    for node in walk_plan(plan.root):
        if not isinstance(node, ScanNode):
            continue
        if index_probe(executor, node) is not None:
            continue  # answered by the point index: O(matches), not O(shard)
        meta = executor.catalog.table(node.rel.table)
        shards = executor.catalog.table_shards(node.rel.table)
        if meta.method == DistributionMethod.HASH:
            for idx in node.pruned_shards:
                total += executor.store.shard_row_count(
                    node.rel.table, shards[idx].shard_id)
        else:
            total += executor.store.shard_row_count(
                node.rel.table, shards[0].shard_id)
        if total > max_rows:
            return None
    cols, nulls, valid = _exec_host(executor, plan.root)
    # the host combine expects a null mask per column (the device path
    # always materializes them)
    for cid, arr in cols.items():
        if cid not in nulls:
            nulls[cid] = np.zeros(arr.shape[0], dtype=bool)
    result = executor._host_combine(plan, cols, nulls, valid, raw)
    result.fast_path = True
    result.device_rows_scanned = 0
    return result


def _exec_host(executor, node):
    """Mirror of PlanCompiler._exec with numpy + exact row counts."""
    if isinstance(node, ScanNode):
        return _scan_host(executor, node)
    if isinstance(node, ProjectNode):
        cols, nulls, valid = _exec_host(executor, node.input)
        src = ColumnSource(cols, nulls)
        out_cols, out_nulls = {}, {}
        n = valid.shape[0]
        for e, cid in node.exprs:
            v, nm = evaluate(e, src, np)
            out_cols[cid] = np.broadcast_to(np.asarray(v), (n,))
            if nm is not None:
                out_nulls[cid] = np.broadcast_to(np.asarray(nm), (n,))
        return out_cols, out_nulls, valid
    if isinstance(node, JoinNode):
        return _join_host(executor, node)
    raise AssertionError(f"fast path: unexpected {type(node).__name__}")


def _scan_host(executor, node: ScanNode):
    from ..storage import pkindex

    store = executor.store
    meta = executor.catalog.table(node.rel.table)
    shards = executor.catalog.table_shards(node.rel.table)
    if meta.method == DistributionMethod.HASH:
        wanted = [shards[i] for i in (node.pruned_shards or [])]
    else:
        wanted = [shards[0]]
    colnames = [cid.split(".", 1)[1] for cid in node.columns]

    value = index_probe(executor, node)
    if value is not None and len(wanted) == 1:
        hits = pkindex.lookup(store, node.rel.table, wanted[0].shard_id,
                              meta.distribution_column, value)
        executor.point_index_lookups += 1
        vals, mask, n = pkindex.read_rows(store, node.rel.table,
                                          wanted[0].shard_id, colnames,
                                          hits)
        cols = {cid: vals[cname]
                for cid, cname in zip(node.columns, colnames)}
        nulls = {cid: ~mask[cname]
                 for cid, cname in zip(node.columns, colnames)
                 if not mask[cname].all()}
        valid = np.ones(n, dtype=bool)
        if n:  # the remaining (non-key) conjuncts still apply
            valid = valid & np.broadcast_to(np.asarray(predicate_mask(
                node.filter, ColumnSource(cols, nulls), np)), (n,))
        return _compress(cols, nulls, valid)
    chunk_filter = None
    if node.filter is not None:
        name_map = {c.name: store.storage_column_name(node.rel.table,
                                                      c.name)
                    for c in meta.schema.columns}
        chunk_filter = make_chunk_filter(node.filter, name_map)
    parts_v = {c: [] for c in colnames}
    parts_m = {c: [] for c in colnames}
    n = 0
    for s in wanted:
        vals, mask, cnt = store.read_shard(node.rel.table, s.shard_id,
                                           colnames, chunk_filter)
        if cnt == 0:
            continue
        n += cnt
        for c in colnames:
            parts_v[c].append(vals[c])
            parts_m[c].append(mask[c])
    cols, nulls = {}, {}
    for cid, cname in zip(node.columns, colnames):
        if parts_v[cname]:
            cols[cid] = np.concatenate(parts_v[cname])
            m = np.concatenate(parts_m[cname])
            if not m.all():
                nulls[cid] = ~m
        else:
            dtype = node.rel.schema.column(cname).dtype.numpy_dtype
            cols[cid] = np.zeros(0, dtype=dtype)
    valid = np.ones(n, dtype=bool)
    if node.filter is not None and n:
        valid = valid & np.broadcast_to(np.asarray(
            predicate_mask(node.filter, ColumnSource(cols, nulls), np)),
            (n,))
    return _compress(cols, nulls, valid)


def _compress(cols, nulls, valid):
    if valid.all():
        return cols, nulls, valid
    return ({c: a[valid] for c, a in cols.items()},
            {c: a[valid] for c, a in nulls.items()},
            np.ones(int(valid.sum()), dtype=bool))


def _eval_keys_host(keys, cols, nulls, n):
    src = ColumnSource(cols, nulls)
    arrays = []
    matchable = np.ones(n, dtype=bool)
    for e in keys:
        v, nm = evaluate(e, src, np)
        arrays.append(np.broadcast_to(np.asarray(v), (n,)).astype(np.int64))
        if nm is not None:
            matchable &= ~np.broadcast_to(np.asarray(nm), (n,))
    return arrays, matchable


def _join_host(executor, node: JoinNode):
    lcols, lnulls, lvalid = _exec_host(executor, node.left)
    rcols, rnulls, rvalid = _exec_host(executor, node.right)
    ln, rn = lvalid.shape[0], rvalid.shape[0]
    if node.left_keys:
        lkeys, lmatch = _eval_keys_host(node.left_keys, lcols, lnulls, ln)
        rkeys, rmatch = _eval_keys_host(node.right_keys, rcols, rnulls, rn)
    else:  # keyless product against a replicated side
        lkeys, lmatch = [np.zeros(ln, np.int64)], np.ones(ln, bool)
        rkeys, rmatch = [np.zeros(rn, np.int64)], np.ones(rn, bool)
    src_l = ColumnSource(lcols, lnulls)
    src_r = ColumnSource(rcols, rnulls)
    if node.left_match_filter is not None:
        lmatch &= np.broadcast_to(np.asarray(predicate_mask(
            node.left_match_filter, src_l, np)), (ln,))
    if node.right_match_filter is not None:
        rmatch &= np.broadcast_to(np.asarray(predicate_mask(
            node.right_match_filter, src_r, np)), (rn,))

    # sorted build + run expansion, exact sizes via np.repeat
    bkey = np.stack(rkeys, axis=0)[:, rmatch] if rn else \
        np.zeros((len(rkeys), 0), np.int64)
    border = np.nonzero(rmatch)[0]
    order = np.lexsort(bkey[::-1]) if border.size else np.zeros(0, np.int64)
    border = border[order]
    skey = bkey[:, order]
    pk = np.stack(lkeys, axis=0)
    # multi-key bounds compare packed int64 tuples as structured rows
    if skey.shape[0] == 1:
        lo = np.searchsorted(skey[0], pk[0], side="left")
        hi = np.searchsorted(skey[0], pk[0], side="right")
    else:
        void_b = np.ascontiguousarray(skey.T).view(
            [("", np.int64)] * skey.shape[0]).reshape(-1)
        void_p = np.ascontiguousarray(pk.T).view(
            [("", np.int64)] * pk.shape[0]).reshape(-1)
        lo = np.searchsorted(void_b, void_p, side="left")
        hi = np.searchsorted(void_b, void_p, side="right")
    counts = np.where(lmatch, hi - lo, 0)

    probe_outer = node.join_type == "left"
    emit = np.where(lvalid & (counts == 0), 1, counts) if probe_outer \
        else counts
    probe_idx = np.repeat(np.arange(ln), emit)
    offs = np.arange(int(emit.sum())) - np.repeat(
        np.cumsum(emit) - emit, emit)
    matched = np.repeat(counts > 0, emit)
    sorted_pos = np.minimum(np.repeat(lo, emit) + offs,
                            max(border.size - 1, 0))
    build_idx = np.where(matched, border[sorted_pos] if border.size
                         else 0, 0)

    cols, nulls = {}, {}
    for cid, arr in lcols.items():
        cols[cid] = arr[probe_idx]
    for cid, nm in lnulls.items():
        nulls[cid] = nm[probe_idx]
    for cid, arr in rcols.items():
        cols[cid] = arr[build_idx] if arr.size else \
            np.zeros(probe_idx.shape[0], arr.dtype)
        nm = rnulls.get(cid)
        gathered = nm[build_idx] if (nm is not None and arr.size) else None
        if probe_outer:
            missing = ~matched
            nulls[cid] = missing if gathered is None else \
                (gathered | missing)
        elif gathered is not None:
            nulls[cid] = gathered
    valid = np.ones(probe_idx.shape[0], dtype=bool)
    if node.residual is not None and valid.size:
        valid &= np.broadcast_to(np.asarray(predicate_mask(
            node.residual, ColumnSource(cols, nulls), np)),
            valid.shape)
    return _compress(cols, nulls, valid)
