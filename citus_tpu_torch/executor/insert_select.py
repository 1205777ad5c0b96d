"""INSERT .. SELECT execution modes.

Counterpart of citus_tpu/executor/insert_select.py.  The reference plans
INSERT..SELECT as pushdown / repartition / pull-to-coordinator (Citus
src/backend/distributed/planner/insert_select_planner.c,
executor/repartition_executor.c).  Here the source SELECT always runs as
one device program (the port's PlanCompiler in raw mode, with the hand
kernels of its shape); the modes differ in how results reach the target
shards:

* colocated — the source plan's output distribution already matches the
  target's sharding on the inserted distribution column (the pushdown
  mode).  On one GPU the rows hash-route on the host, exactly as the JAX
  package does at one device; slicing a device-major result straight
  into each device's shard comes with multi-GPU (ROADMAP queue A item 9).
* repartition, host-routed — a vectorized numpy hash-route over the raw
  result arrays.  The JAX package's device-routed output shuffle
  (QueryPlan.output_repart) comes with multi-GPU (ROADMAP queue A item
  9): on one device it is the identity, and the compiler refuses it.

The reference's pull-to-coordinator mode is the session's fallback for
source shapes the raw path refuses (Session._execute_insert_select).

All modes use the executor's raw results: STRING columns stay
dictionary codes (translated dictionary→dictionary by a vectorized LUT)
and DATE columns stay day numbers — no decode→parse round trip.
"""

from __future__ import annotations

import numpy as np

from ..catalog import DistributionMethod
from ..catalog.distribution import hash_token, shard_index_for_token_ranges
from ..errors import IngestError, PlanningError
from ..planner import expr as ir
from ..planner.plan import QueryPlan
from ..storage.dictionary import NULL_CODE
from ..types import DataType


def choose_mode(session, plan: QueryPlan, meta,
                columns: list[str]) -> str:
    """colocated | repartition — pushdown applies when the source root is
    hash-distributed with the target's shard map and the select item
    feeding the target's distribution column is a bare column of the
    source's partition equivalence set."""
    if meta.method != DistributionMethod.HASH:
        return "repartition"  # single-shard target: routing is trivial
    root = plan.root
    if root.dist.kind != "hash":
        return "repartition"
    from ..planner.plan import table_placement

    shards = session.catalog.table_shards(meta.name)
    placement = table_placement(session.catalog, meta.name,
                                session.n_devices)
    bounds = tuple(session.catalog.shard_mins(meta.name))
    if root.dist.shard_count != len(shards) or \
            root.dist.placement != placement or \
            (root.dist.bounds and tuple(root.dist.bounds) != bounds):
        return "repartition"
    try:
        di = columns.index(meta.distribution_column)
    except ValueError:
        return "repartition"
    if di >= len(plan.host_select):
        return "repartition"
    e, _name = plan.host_select[di]
    # resolve projection outputs back to their source expressions (the
    # host_select references ProjectNode cids like "p0", while dist.cids
    # carry relation cids like "0.k")
    from ..planner.plan import ProjectNode

    node = root
    while isinstance(e, ir.BCol):
        if e.cid in node.dist.cids:
            return "colocated"
        if isinstance(node, ProjectNode):
            src = next((se for se, cid in node.exprs if cid == e.cid),
                       None)
            if src is None:
                break
            e = src
            node = node.input
            continue
        break
    return "repartition"


def execute_insert_select(session, stmt):
    """Array-path INSERT..SELECT; returns (ResultSet, mode)."""
    from .runner import ResultSet

    meta = session.catalog.table(stmt.table)
    columns = list(stmt.columns or meta.schema.names)
    plan, cleanup = session._plan_select(stmt.query)
    try:
        if len(plan.host_select) != len(columns):
            raise PlanningError(
                f"INSERT..SELECT arity mismatch: {len(columns)} target "
                f"columns, {len(plan.host_select)} select items")
        mode = choose_mode(session, plan, meta, columns)
        result = session.executor.execute_plan(plan, raw=True)
        n = _write_result(session, meta, columns, result)
        return ResultSet(["inserted"], {"inserted": [n]}, 1), mode
    finally:
        for t in cleanup:
            session._drop_temp(t)


def _target_arrays(session, meta, columns, result):
    """Raw result columns → typed target arrays + validity, dictionary
    codes translated source→target."""
    n = result.row_count
    typed: dict[str, np.ndarray] = {}
    validity: dict[str, np.ndarray] = {}
    for tgt_col, out_name in zip(columns, result.column_names):
        cdef = meta.schema.column(tgt_col)
        arr = np.asarray(result.columns[out_name])
        nmask = result.null_masks.get(out_name)
        nmask = (np.zeros(n, dtype=bool) if nmask is None
                 else np.asarray(nmask, dtype=bool))
        if not cdef.nullable and nmask.any():
            raise IngestError(
                f"NULL in non-nullable column {tgt_col!r} of {meta.name!r}")
        if cdef.dtype == DataType.STRING:
            src = (result.decode_map or {}).get(out_name)
            if src is None:
                if arr.dtype == object or arr.dtype.kind in ("U", "S"):
                    # string values materialized host-side (e.g. literals)
                    d = session.store.dictionary(meta.name, tgt_col)
                    codes = d.intern_array(
                        [None if nm else str(v)
                         for v, nm in zip(arr, nmask)])
                    typed[tgt_col] = codes
                else:
                    raise PlanningError(
                        f"cannot infer dictionary for string column "
                        f"{tgt_col!r}")
            else:
                from ..storage.dictionary import resolve_decode

                src_d = resolve_decode(session.store, src)
                tgt_d = session.store.dictionary(meta.name, tgt_col)
                if src == (meta.name, tgt_col):
                    codes = arr.astype(np.int32)
                elif len(src_d) == 0:
                    codes = np.zeros(n, dtype=np.int32)
                else:
                    # translate only the codes actually present — interning
                    # the whole source dictionary would permanently bloat
                    # the target's (dictionaries persist at commit)
                    safe = np.clip(arr.astype(np.int64), 0, len(src_d) - 1)
                    present = np.unique(safe[~nmask]) if (~nmask).any() \
                        else np.empty(0, dtype=np.int64)
                    lut = np.zeros(len(src_d), dtype=np.int32)
                    src_vals = src_d.values
                    for c in present:
                        lut[c] = tgt_d.intern(src_vals[int(c)])
                    codes = lut[safe]
                codes = np.where(nmask, np.int32(NULL_CODE),
                                 codes.astype(np.int32))
                typed[tgt_col] = codes
        else:
            dt = cdef.dtype.numpy_dtype
            if arr.dtype == object:
                arr = np.array([0 if (v is None or nm) else v
                                for v, nm in zip(arr, nmask)])
            vals = arr.astype(dt)
            if nmask.any():
                vals = np.where(nmask, np.zeros((), dtype=dt), vals)
            typed[tgt_col] = vals
        validity[tgt_col] = ~nmask
    # unspecified target columns become NULL
    for c in meta.schema.names:
        if c not in typed:
            cdef = meta.schema.column(c)
            if not cdef.nullable:
                raise IngestError(
                    f"non-nullable column {c!r} missing from INSERT")
            typed[c] = np.zeros(n, dtype=(np.int32 if cdef.dtype ==
                                          DataType.STRING
                                          else cdef.dtype.numpy_dtype))
            if cdef.dtype == DataType.STRING:
                typed[c] = np.full(n, NULL_CODE, dtype=np.int32)
            validity[c] = np.zeros(n, dtype=bool)
    return typed, validity


def _write_result(session, meta, columns, result) -> int:
    n = result.row_count
    if n == 0:
        return 0
    typed, validity = _target_arrays(session, meta, columns, result)
    # Every write happens under the DML shard locks (the shard split
    # holds them while it flips the catalog), with _dml_locks' reload
    # loop adopting the committed catalog before we route — otherwise a
    # split committing between routing and append sends rows into the
    # dropped parent shard (lost).
    table = meta.name
    with session._dml_locks(
            table, lambda: session.catalog.table_shards(table)):
        return _route_and_write(session, meta, typed, validity, n)


def _route_and_write(session, meta, typed, validity, n) -> int:
    from ..utils.faultinjection import fault_point

    # named seam: a failure while shuffling INSERT..SELECT rows to their
    # target shards must leak no invisible stripes (the discard_pending
    # cleanup below is the recovery path under test)
    fault_point("executor.repartition_shuffle")
    codec = session.settings.get("columnar_compression")
    level = session.settings.get("columnar_compression_level")
    chunk_rows = session.settings.get("columnar_chunk_group_row_limit")
    pending: list[tuple[int, dict]] = []
    table = meta.name
    try:
        if meta.method == DistributionMethod.HASH:
            dist_col = meta.distribution_column
            if not validity[dist_col].all():
                raise IngestError(
                    f"NULL distribution column value in {table!r}")
            dt = meta.schema.column(dist_col).dtype
            if dt == DataType.STRING:
                d = session.store.dictionary(table, dist_col)
                tokens = d.hash_tokens()[typed[dist_col]]
            else:
                tokens = hash_token(typed[dist_col])
            shards = session.catalog.table_shards(table)
            shard_idx = shard_index_for_token_ranges(
                tokens, session.catalog.shard_mins(table))
            for i, s in enumerate(shards):
                mask = shard_idx == i
                if not mask.any():
                    continue
                sub = {c: typed[c][mask] for c in typed}
                subv = {c: validity[c][mask] for c in validity}
                rec = session.store.append_stripe(
                    table, s.shard_id, sub, subv, codec=codec,
                    level=level, chunk_rows=chunk_rows, commit=False)
                pending.append((s.shard_id, rec))
        else:
            shard = session.catalog.table_shards(table)[0]
            rec = session.store.append_stripe(
                table, shard.shard_id, typed, validity, codec=codec,
                level=level, chunk_rows=chunk_rows, commit=False)
            pending.append((shard.shard_id, rec))
    except Exception:
        session.store.discard_pending(table, pending)
        raise
    session._apply_dml(table, {}, pending)
    return n
