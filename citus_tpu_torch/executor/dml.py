"""Distributed DML: UPDATE / DELETE / MERGE over sharded columnar tables.

Counterpart of citus_tpu/executor/dml.py.  The reference plans
UPDATE/DELETE through the router planner (Citus src/backend/distributed/
planner/multi_router_planner.c:214 CreateModifyPlan: prune by the
distribution column, then run the rewritten statement per shard
placement) and MERGE through its own planner (planner/merge_planner.c,
requiring the ON clause to match the distribution column).

Tables are immutable columnar stripes in the host store, so modification
is a functional operation: DELETE writes per-stripe deletion bitmaps,
UPDATE appends rewritten rows and tombstones the old positions, and both
flip visibility with one atomic manifest write
(storage.table_store.TableStore.apply_dml).  Shard pruning reuses the
planner's PruneShards analogue, so a DML statement constrained on the
distribution column locks and touches one shard.

The matching and the UPDATE arithmetic run on the host in numpy float64
(executor/host_exprs.py), as in the JAX package, so both packages write
the same values bit for bit; the card's float32 compute would round
them differently.
"""

from __future__ import annotations

import numpy as np

from ..catalog import DistributionMethod
from ..catalog.distribution import hash_token, shard_index_for_token_ranges
from ..errors import ExecutionError, PlanningError, UnsupportedQueryError
from ..planner import expr as ir
from ..planner.bind import Binder
from ..sql import ast
from ..types import DataType
from . import host_eval
from .host_exprs import ColumnSource, evaluate, predicate_mask


def _result(count: int, tag: str):
    from .runner import ResultSet

    return ResultSet([tag], {tag: [count]}, 1)


def _bind_single_table(session, table: str, alias: str | None,
                       where: ast.Expr | None,
                       item_exprs: tuple[ast.Expr, ...] = ()):
    """Bind a one-table pseudo-SELECT; returns (BoundQuery, BoundRel)."""
    from ..session import _StoreDicts

    meta = session.catalog.table(table)
    items = tuple(ast.SelectItem(e) for e in item_exprs) or (
        ast.SelectItem(ast.ColumnRef(meta.schema.names[0])),)
    sel = ast.Select(items=items,
                     from_items=(ast.TableRef(table, alias),),
                     where=where)
    binder = Binder(session.catalog, _StoreDicts(session.store))
    bound = binder.bind_select(sel)
    return bound, bound.rels[0]


def _target_shards(session, table: str, rel, conjuncts):
    """All shards, narrowed by distribution-column pruning when possible."""
    from ..planner.plan import DistributedPlanner
    from ..session import _StoreDicts, _StoreStats

    shards = session.catalog.table_shards(table)
    planner = DistributedPlanner(session.catalog,
                                 _StoreStats(session.store),
                                 session.n_devices, True,
                                 dicts=_StoreDicts(session.store),
                                 device=session.device)
    pruned = planner._prune_shards(rel, conjuncts)
    if pruned is not None:
        keep = set(pruned)
        shards = [s for s in shards if s.shard_index in keep]
    return shards


def _stripe_source(rel, vals, valid):
    cols = {rel.cid(c): v for c, v in vals.items()}
    nulls = {rel.cid(c): ~m for c, m in valid.items() if not m.all()}
    return ColumnSource(cols, nulls)


def _match_mask(bound, rel, vals, valid, n, dmask):
    """Rows (physical stripe positions) the WHERE clause selects and that
    are still alive."""
    mask = np.ones(n, dtype=bool)
    if bound.conjuncts:
        src = _stripe_source(rel, vals, valid)
        for c in bound.conjuncts:
            m = predicate_mask(c, src, np)
            mask &= np.broadcast_to(np.asarray(m, dtype=bool), (n,))
    if dmask is not None:
        mask &= ~dmask
    return mask


def _pred_columns(bound, rel) -> list[str]:
    prefix = f"{rel.rel_index}."
    out: set[str] = set()
    for c in bound.conjuncts:
        for node in ir.walk(c):
            if isinstance(node, ir.BCol) and node.cid.startswith(prefix):
                out.add(node.cid[len(prefix):])
    return sorted(out) or [rel.schema.names[0]]


def execute_delete(session, stmt: ast.Delete):
    bound, rel = _bind_single_table(session, stmt.table, stmt.alias,
                                    stmt.where)
    cols = _pred_columns(bound, rel)
    deletes: dict[int, dict[str, np.ndarray]] = {}
    count = 0
    with session._dml_locks(
            stmt.table,
            lambda: _target_shards(session, stmt.table, rel,
                                   bound.conjuncts)) as shards:
        for shard in shards:
            for rec in session.store.shard_stripe_records(stmt.table,
                                                          shard.shard_id):
                vals, valid, n, dmask = session.store.read_stripe_raw(
                    stmt.table, shard.shard_id, rec["file"], cols, rec)
                mask = _match_mask(bound, rel, vals, valid, n, dmask)
                hits = int(mask.sum())
                if hits:
                    deletes.setdefault(shard.shard_id, {})[rec["file"]] = mask
                    count += hits
        if deletes:
            session._apply_dml(stmt.table, deletes, [])
    return _result(count, "DELETE")


def _split_assignments(session, table: str, meta, assignments):
    """→ (direct, exprs): direct = {col: (value_array_fn)} for STRING/NULL
    literals handled outside the binder; exprs = [(col, ast expr)] bound
    through the pseudo-SELECT."""
    seen = set()
    direct: list[tuple[str, object]] = []
    bindable: list[tuple[str, ast.Expr]] = []
    for a in assignments:
        if a.column in seen:
            raise PlanningError(
                f"multiple assignments to column {a.column!r}")
        seen.add(a.column)
        col = meta.schema.column(a.column)  # raises on unknown column
        if (meta.method == DistributionMethod.HASH
                and a.column == meta.distribution_column):
            # reference errors identically: modifying the partition value
            # is not allowed (multi_router_planner.c)
            raise UnsupportedQueryError(
                "modifying the distribution column is not supported")
        is_null_lit = isinstance(a.value, ast.Literal) and a.value.value is None
        if col.dtype == DataType.STRING:
            if not isinstance(a.value, ast.Literal) or not (
                    is_null_lit or isinstance(a.value.value, str)):
                raise UnsupportedQueryError(
                    "string column assignment must be a literal")
            code = None
            if not is_null_lit:
                with session.store.interning(table, a.column) as d:
                    code = int(d.intern_array([a.value.value])[0])
            direct.append((a.column, code))
        elif is_null_lit:
            direct.append((a.column, None))
        else:
            bindable.append((a.column, a.value))
    return direct, bindable


def execute_update(session, stmt: ast.Update):
    meta = session.catalog.table(stmt.table)
    direct, bindable = _split_assignments(session, stmt.table, meta,
                                          stmt.assignments)
    bound, rel = _bind_single_table(
        session, stmt.table, stmt.alias, stmt.where,
        tuple(e for _, e in bindable))
    if bindable:
        for bexpr, _name in bound.select[:len(bindable)]:
            for node in ir.walk(bexpr):
                if isinstance(node, ir.BAgg):
                    raise PlanningError(
                        "aggregates are not allowed in UPDATE SET")
    bound_assign = list(zip((c for c, _ in bindable),
                            (e for e, _ in bound.select[:len(bindable)])))

    deletes: dict[int, dict[str, np.ndarray]] = {}
    pending: list[tuple[int, dict]] = []
    count = 0
    codec = session.settings.get("columnar_compression")
    level = session.settings.get("columnar_compression_level")
    chunk_rows = session.settings.get("columnar_chunk_group_row_limit")
    with session._dml_locks(
            stmt.table,
            lambda: _target_shards(session, stmt.table, rel,
                                   bound.conjuncts)) as shards:
        try:
            count = _update_shards(session, stmt, meta, bound, rel,
                                   bound_assign, direct, deletes, pending,
                                   codec, level, chunk_rows, shards)
        except Exception:
            session.store.discard_pending(stmt.table, pending)
            raise
        if deletes or pending:
            session._apply_dml(stmt.table, deletes, pending)
    return _result(count, "UPDATE")


def _update_shards(session, stmt, meta, bound, rel, bound_assign, direct,
                   deletes, pending, codec, level, chunk_rows, shards) -> int:
    count = 0
    for shard in shards:
        new_vals: dict[str, list[np.ndarray]] = {c: [] for c in
                                                 meta.schema.names}
        new_valid: dict[str, list[np.ndarray]] = {c: [] for c in
                                                  meta.schema.names}
        shard_rows = 0
        for rec in session.store.shard_stripe_records(stmt.table,
                                                      shard.shard_id):
            if bound.conjuncts:
                # cheap pass: predicate columns only; decompress the full
                # stripe only when something actually matches
                pv, pm, n, dmask = session.store.read_stripe_raw(
                    stmt.table, shard.shard_id, rec["file"],
                    _pred_columns(bound, rel), rec)
                mask = _match_mask(bound, rel, pv, pm, n, dmask)
                if not mask.any():
                    continue
                vals, valid, _n, _dm = session.store.read_stripe_raw(
                    stmt.table, shard.shard_id, rec["file"], record=rec)
            else:
                vals, valid, n, dmask = session.store.read_stripe_raw(
                    stmt.table, shard.shard_id, rec["file"], record=rec)
                mask = _match_mask(bound, rel, vals, valid, n, dmask)
            hits = int(mask.sum())
            if not hits:
                continue
            deletes.setdefault(shard.shard_id, {})[rec["file"]] = mask
            count += hits
            shard_rows += hits
            idx = np.nonzero(mask)[0]
            sub_vals = {c: vals[c][idx] for c in vals}
            sub_valid = {c: valid[c][idx] for c in valid}
            src = _stripe_source(rel, sub_vals, sub_valid)
            assigned: dict[str, tuple[np.ndarray, np.ndarray]] = {}
            for colname, bexpr in bound_assign:
                dt = meta.schema.column(colname).dtype.numpy_dtype
                v, nm = evaluate(bexpr, src, np)
                v = np.broadcast_to(np.asarray(v).astype(dt), (hits,)).copy()
                ok = (np.ones(hits, dtype=bool) if nm is None
                      else ~np.broadcast_to(nm, (hits,)))
                assigned[colname] = (v, ok.copy())
            for colname, code in direct:
                dt = meta.schema.column(colname).dtype.numpy_dtype
                if code is None:
                    assigned[colname] = (np.zeros(hits, dtype=dt),
                                         np.zeros(hits, dtype=bool))
                else:
                    assigned[colname] = (np.full(hits, code, dtype=dt),
                                         np.ones(hits, dtype=bool))
            for c in meta.schema.names:
                if c in assigned:
                    v, ok = assigned[c]
                    if not meta.schema.column(c).nullable and not ok.all():
                        raise ExecutionError(
                            f"NULL in non-nullable column {c!r}")
                else:
                    v, ok = sub_vals[c], sub_valid[c]
                new_vals[c].append(v)
                new_valid[c].append(ok)
        if shard_rows:
            cols = {c: np.concatenate(new_vals[c]) for c in new_vals}
            validity = {c: np.concatenate(new_valid[c]) for c in new_valid}
            rec = session.store.append_stripe(
                stmt.table, shard.shard_id, cols, validity,
                codec=codec, level=level, chunk_rows=chunk_rows,
                commit=False)
            pending.append((shard.shard_id, rec))
    return count


# ---------------------------------------------------------------------------
# MERGE
# ---------------------------------------------------------------------------

def _decode_columns(store, table, schema, vals, valid):
    """Stored arrays → decoded (strings as objects) + null masks."""
    out = {}
    for name in schema.names:
        dtype = schema.column(name).dtype
        v = vals[name]
        nulls = ~valid[name]
        if dtype == DataType.STRING:
            d = store.dictionary(table, name)
            v = np.asarray(d.decode_array(v), dtype=object)
        out[name] = (v, nulls if nulls.any() else None)
    return out


def _merge_source(session, source: ast.FromItem):
    """→ (alias, {col: (values, nulls)}, n_rows)."""
    if isinstance(source, ast.TableRef):
        meta = session.catalog.table(source.name)
        parts: list[dict] = []
        total = 0
        for shard in session.catalog.table_shards(source.name):
            vals, valid, n = session.store.read_shard(source.name,
                                                      shard.shard_id)
            if n:
                parts.append((vals, valid, n))
                total += n
        merged_v = {c: np.concatenate([p[0][c] for p in parts])
                    if parts else np.empty(
                        0, dtype=meta.schema.column(c).dtype.numpy_dtype)
                    for c in meta.schema.names}
        merged_m = {c: np.concatenate([p[1][c] for p in parts])
                    if parts else np.empty(0, dtype=bool)
                    for c in meta.schema.names}
        cols = _decode_columns(session.store, source.name, meta.schema,
                               merged_v, merged_m)
        return source.alias or source.name, cols, total
    if isinstance(source, ast.SubqueryRef):
        res = session._execute_subselect(source.query)
        cols = {}
        for name in res.column_names:
            data = res.columns[name]
            dt = (res.dtypes or {}).get(name)
            if dt == DataType.DATE:
                from ..types import date_to_days

                arr = np.array([None if x is None else date_to_days(str(x))
                                for x in data], dtype=object)
                nulls = np.array([x is None for x in data], dtype=bool)
                vals = np.array([0 if x is None else x for x in arr],
                                dtype=np.int32)
            else:
                lst = list(data)
                nulls = np.array([x is None for x in lst], dtype=bool)
                if any(isinstance(x, str) for x in lst):
                    vals = np.asarray(lst, dtype=object)
                else:
                    vals = np.array([0 if x is None else x for x in lst])
            cols[name] = (vals, nulls if nulls.any() else None)
        return source.alias, cols, res.row_count
    raise UnsupportedQueryError("MERGE source must be a table or subquery")


def _classify_on(on: ast.Expr, target_names: set[str],
                 target_quals: set[str], source_names: set[str],
                 source_qual: str):
    """ON conjuncts → ([(target_col, source_col)], residual conjuncts)."""

    def side_of(ref: ast.ColumnRef) -> str:
        if ref.table:
            if ref.table in target_quals:
                return "t"
            if ref.table == source_qual:
                return "s"
            raise PlanningError(f"unknown qualifier {ref.table!r} in MERGE ON")
        in_t, in_s = ref.name in target_names, ref.name in source_names
        if in_t and in_s:
            raise PlanningError(
                f"ambiguous column {ref.name!r} in MERGE ON")
        if in_t:
            return "t"
        if in_s:
            return "s"
        raise PlanningError(f"unknown column {ref.name!r} in MERGE ON")

    pairs: list[tuple[str, str]] = []
    residual: list[ast.Expr] = []
    for c in host_eval.split_conjuncts(on):
        if (isinstance(c, ast.BinaryOp) and c.op == "="
                and isinstance(c.left, ast.ColumnRef)
                and isinstance(c.right, ast.ColumnRef)):
            ls, rs = side_of(c.left), side_of(c.right)
            if ls == "t" and rs == "s":
                pairs.append((c.left.name, c.right.name))
                continue
            if ls == "s" and rs == "t":
                pairs.append((c.right.name, c.left.name))
                continue
        residual.append(c)
    return pairs, residual


def execute_merge(session, stmt: ast.Merge):
    meta = session.catalog.table(stmt.target)
    target_alias = stmt.target_alias or stmt.target
    src_alias, src_cols, src_n = _merge_source(session, stmt.source)
    source_names = set(src_cols.keys())
    pairs, residual = _classify_on(
        stmt.on, set(meta.schema.names), {target_alias, stmt.target},
        source_names, src_alias)
    if not pairs:
        raise UnsupportedQueryError(
            "MERGE ON must contain at least one target = source equality")

    if meta.method == DistributionMethod.HASH:
        dist_pairs = [p for p in pairs if p[0] == meta.distribution_column]
        if not dist_pairs:
            # reference requirement: MERGE ON must join on the distribution
            # column (merge_planner.c)
            raise UnsupportedQueryError(
                "MERGE ON must include the target distribution column")
        dist_src = dist_pairs[0][1]
        dv, dn = src_cols[dist_src]
        dt = meta.schema.column(meta.distribution_column).dtype
        if dt == DataType.STRING:
            from ..storage.dictionary import string_hash_tokens

            tokens = string_hash_tokens(
                ["" if x is None else str(x) for x in dv])
        else:
            tokens = hash_token(np.asarray(
                [0 if x is None else x for x in dv], dtype=dt.numpy_dtype))

        def _route():
            # shard INDEXES come from the catalog — derived under the
            # DML locks so a concurrent split can't strand source rows
            src_shard = np.asarray(
                shard_index_for_token_ranges(
                    tokens, session.catalog.shard_mins(stmt.target)),
                dtype=np.int64)
            if dn is not None:
                # NULL join keys never match; those source rows go
                # straight to WHEN NOT MATCHED (PostgreSQL semantics)
                src_shard = np.where(dn, np.int64(-1), src_shard)
            return src_shard
    else:
        def _route():
            return np.zeros(src_n, dtype=np.int64)

    codec = session.settings.get("columnar_compression")
    level = session.settings.get("columnar_compression_level")
    chunk_rows = session.settings.get("columnar_chunk_group_row_limit")
    all_deletes: dict[int, dict[str, np.ndarray]] = {}
    all_pending: list[tuple[int, dict]] = []

    with session._dml_locks(
            stmt.target,
            lambda: session.catalog.table_shards(stmt.target)) as shards:
        src_shard = _route()
        try:
            n_updated, n_deleted, n_inserted, insert_cols, insert_rows_acc = \
                _merge_shards(session, stmt, meta, shards, src_shard,
                              src_cols, src_alias, target_alias, pairs,
                              residual, all_deletes, all_pending,
                              codec, level, chunk_rows)
            if insert_rows_acc:
                # inserts join the same manifest flip as updates/deletes —
                # the whole MERGE becomes visible atomically or not at all
                from ..ingest.copy_from import prepare_rows

                _n, ins_pending = prepare_rows(
                    session, stmt.target, list(insert_cols),
                    [list(r) for r in insert_rows_acc], commit=False)
                all_pending.extend(ins_pending)
        except Exception:
            session.store.discard_pending(stmt.target, all_pending)
            raise

        if all_deletes or all_pending:
            session._apply_dml(stmt.target, all_deletes, all_pending)
    return _result(n_updated + n_deleted + n_inserted, "MERGE")


def _merge_shards(session, stmt, meta, shards, src_shard, src_cols,
                  src_alias, target_alias, pairs, residual,
                  all_deletes, all_pending, codec, level, chunk_rows):
    n_updated = n_deleted = n_inserted = 0
    insert_rows_acc: list[list] = []
    insert_cols: list[str] | None = None

    def handle_not_matched(srow: int) -> None:
        nonlocal insert_cols, n_inserted
        action = _first_action(stmt.not_matched, {}, src_cols, target_alias,
                               stmt.target, src_alias, [], srow,
                               source_only=True)
        if action is None or action.kind == "nothing":
            return
        cols = list(action.insert_columns or meta.schema.names)
        if len(cols) != len(action.insert_values):
            raise PlanningError("MERGE INSERT arity mismatch")
        scope = _pair_scope({}, src_cols, target_alias, stmt.target,
                            src_alias, None, srow)
        row = []
        for e in action.insert_values:
            v, nm = host_eval.eval_expr(e, scope)
            isnull = nm is not None and bool(np.asarray(nm).any())
            row.append(None if isnull else _to_py(np.asarray(v)[()]))
        if insert_cols is None:
            insert_cols = cols
        elif insert_cols != cols:
            raise UnsupportedQueryError(
                "MERGE INSERT column lists must agree across rows")
        insert_rows_acc.append(row)
        n_inserted += 1

    # source rows whose join key is NULL match nothing anywhere
    for srow in np.nonzero(src_shard < 0)[0]:
        handle_not_matched(int(srow))

    for si, shard in enumerate(shards):
        rows_here = np.nonzero(src_shard == si)[0]
        if len(rows_here) == 0:
            continue
        # materialize the target shard with per-stripe position tracking
        stripes = []  # (fname, start, nrows, dmask)
        tv: dict[str, list[np.ndarray]] = {c: [] for c in meta.schema.names}
        tm: dict[str, list[np.ndarray]] = {c: [] for c in meta.schema.names}
        start = 0
        for rec in session.store.shard_stripe_records(stmt.target,
                                                      shard.shard_id):
            vals, valid, n, dmask = session.store.read_stripe_raw(
                stmt.target, shard.shard_id, rec["file"], record=rec)
            stripes.append((rec["file"], start, n, dmask))
            start += n
            for c in meta.schema.names:
                tv[c].append(vals[c])
                tm[c].append(valid[c])
        total = start
        tvals = {c: (np.concatenate(tv[c]) if tv[c] else np.empty(
            0, dtype=meta.schema.column(c).dtype.numpy_dtype))
            for c in meta.schema.names}
        tvalid = {c: (np.concatenate(tm[c]) if tm[c]
                      else np.empty(0, dtype=bool))
                  for c in meta.schema.names}
        alive = np.ones(total, dtype=bool)
        for _f, s0, n, dmask in stripes:
            if dmask is not None:
                alive[s0:s0 + n] &= ~dmask
        tcols = _decode_columns(session.store, stmt.target, meta.schema,
                                tvals, tvalid)

        # hash index on the target join keys (alive rows only)
        index: dict[tuple, list[int]] = {}
        key_arrays = []
        for tcol, _scol in pairs:
            v, nm = tcols[tcol]
            key_arrays.append((v, nm))
        for pos in np.nonzero(alive)[0]:
            key = tuple(
                None if (nm is not None and nm[pos]) else v[pos]
                for v, nm in key_arrays)
            if None in key:
                continue
            index.setdefault(key, []).append(int(pos))

        touched: set[int] = set()
        del_mask = np.zeros(total, dtype=bool)
        upd_rows: list[dict] = []   # {col: (value, is_null)}

        for srow in rows_here:
            key = tuple(
                None if (nm is not None and nm[srow]) else v[srow]
                for (_t, scol) in pairs
                for v, nm in [src_cols[scol]])
            matches = index.get(key, []) if None not in key else []
            if matches and residual:
                matches = [p for p in matches
                           if _pair_truthy(residual, tcols, src_cols,
                                           target_alias, stmt.target,
                                           src_alias, p, srow)]
            if matches:
                # WHEN MATCHED conditions are per (target, source) pair:
                # each matching target row picks its own first-passing
                # clause (PostgreSQL MERGE semantics)
                for p in matches:
                    action = _first_action(stmt.matched, tcols, src_cols,
                                           target_alias, stmt.target,
                                           src_alias, [p], srow)
                    if action is None or action.kind == "nothing":
                        continue
                    if p in touched:
                        raise ExecutionError(
                            "MERGE command cannot affect row a second time")
                    touched.add(p)
                    del_mask[p] = True
                    if action.kind == "delete":
                        n_deleted += 1
                        continue
                    # update = tombstone + rewritten row
                    n_updated += 1
                    row = {}
                    scope = _pair_scope(tcols, src_cols, target_alias,
                                        stmt.target, src_alias, p, srow)
                    assigned = {}
                    for a in action.assignments:
                        meta.schema.column(a.column)  # validates existence
                        if (meta.method == DistributionMethod.HASH and
                                a.column == meta.distribution_column):
                            raise UnsupportedQueryError(
                                "modifying the distribution column is not "
                                "supported")
                        v, nm = host_eval.eval_expr(a.value, scope)
                        isnull = bool(np.asarray(nm).any()) if nm is not None \
                            else False
                        assigned[a.column] = (None if isnull
                                              else np.asarray(v)[()], isnull)
                    for c in meta.schema.names:
                        if c in assigned:
                            row[c] = assigned[c]
                        else:
                            v, nm = tcols[c]
                            isnull = nm is not None and bool(nm[p])
                            row[c] = (None if isnull else v[p], isnull)
                    upd_rows.append(row)
            else:
                handle_not_matched(int(srow))

        # accumulate this shard's tombstones + rewrites; applied for ALL
        # shards in one manifest flip after the statement fully evaluates
        for fname, s0, n, _dm in stripes:
            sub = del_mask[s0:s0 + n]
            if sub.any():
                all_deletes.setdefault(shard.shard_id, {})[fname] = sub.copy()
        if upd_rows:
            cols_arr: dict[str, np.ndarray] = {}
            valid_arr: dict[str, np.ndarray] = {}
            for c in meta.schema.names:
                cdef = meta.schema.column(c)
                nulls = np.array([r[c][1] for r in upd_rows], dtype=bool)
                if cdef.dtype == DataType.STRING:
                    with session.store.interning(stmt.target, c) as d:
                        codes = d.intern_array(
                            [None if isnull else str(v)
                             for (v, isnull) in (r[c] for r in upd_rows)])
                    cols_arr[c] = codes
                else:
                    cols_arr[c] = np.array(
                        [0 if r[c][1] else r[c][0] for r in upd_rows],
                        dtype=cdef.dtype.numpy_dtype)
                if not cdef.nullable and nulls.any():
                    raise ExecutionError(
                        f"NULL in non-nullable column {c!r}")
                valid_arr[c] = ~nulls
            rec = session.store.append_stripe(
                stmt.target, shard.shard_id, cols_arr, valid_arr,
                codec=codec, level=level, chunk_rows=chunk_rows,
                commit=False)
            all_pending.append((shard.shard_id, rec))

    return n_updated, n_deleted, n_inserted, insert_cols, insert_rows_acc


def _to_py(v):
    if isinstance(v, np.generic):
        return v.item()
    return v


def _pair_scope(tcols, src_cols, target_alias, target_name, src_alias,
                tpos: int | None, spos: int) -> host_eval.Scope:
    scope = host_eval.Scope()
    if tpos is not None:
        for c, (v, nm) in tcols.items():
            val = np.asarray(v[tpos]) if v.dtype != object else \
                np.asarray(v[tpos], dtype=object)
            nul = (np.asarray(True) if (nm is not None and nm[tpos])
                   else None)
            scope.add(target_alias, c, val, nul)
            if target_alias != target_name:
                scope.add(target_name, c, val, nul)
    for c, (v, nm) in src_cols.items():
        val = np.asarray(v[spos]) if v.dtype != object else \
            np.asarray(v[spos], dtype=object)
        nul = np.asarray(True) if (nm is not None and nm[spos]) else None
        scope.add(src_alias, c, val, nul)
    return scope


def _pair_truthy(conjuncts, tcols, src_cols, target_alias, target_name,
                 src_alias, tpos, spos) -> bool:
    scope = _pair_scope(tcols, src_cols, target_alias, target_name,
                        src_alias, tpos, spos)
    for c in conjuncts:
        v, nm = host_eval.eval_expr(c, scope)
        if nm is not None and bool(np.asarray(nm).any()):
            return False
        if not bool(np.asarray(v).all()):
            return False
    return True


def _first_action(actions, tcols, src_cols, target_alias, target_name,
                  src_alias, matches, srow, source_only: bool = False):
    for action in actions:
        if action.condition is None:
            return action
        tpos = None if source_only or not matches else matches[0]
        if _pair_truthy([action.condition], tcols, src_cols, target_alias,
                        target_name, src_alias, tpos, srow):
            return action
    return None
