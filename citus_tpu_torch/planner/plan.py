"""Distributed plan nodes + the join-order/strategy planner.

Mirrors the reference's planning cascade pieces:

* join-order search with rule preferences — multi_join_order.c:286
  JoinOrderList / BestJoinOrder (reference rules REFERENCE_JOIN,
  LOCAL_PARTITION_JOIN, SINGLE_{HASH,RANGE}_PARTITION_JOIN,
  DUAL_PARTITION_JOIN, CARTESIAN_PRODUCT → here BROADCAST, LOCAL,
  REPART_LEFT/REPART_RIGHT, REPART_BOTH, CARTESIAN)
* worker/master aggregate split — multi_logical_optimizer.c:1419 (here:
  partial aggregation per device + LOCAL / GLOBAL-psum / REPARTITION
  combine strategies)
* physical Job/MapMergeJob tree — multi_physical_planner.c:274 (here the
  strategy annotations compile into one shard_map program whose
  repartition stages are all_to_all collectives instead of map/fetch
  tasks)

A node's `dist` describes how its rows are spread over the mesh —
the placement-map equality check is the colocation test
(colocation_utils.c analogue).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..catalog import Catalog, DistributionMethod
from ..errors import PlanningError
from ..types import DataType
from . import expr as ir
from .bind import BoundQuery, BoundRel


# --------------------------------------------------------------------------
# distribution descriptors
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Dist:
    """How a node's rows map onto devices.

    kind: 'hash' (token-range sharded), 'replicated' (every device has all
    rows), 'device' (hash-partitioned directly to n_dev buckets after a
    repartition).
    cids: columns (equivalence set) the rows are partitioned by.
    shard_count / placement: token-space split + shard→device map; for
    kind='device', shard_count == n_devices and placement is identity.
    bounds: ascending token-range lower bound per shard — uniform at
    creation, arbitrary after shard splits; all routing goes through it.
    """

    kind: str
    cids: frozenset[str] = frozenset()
    shard_count: int = 0
    placement: tuple[int, ...] = ()
    bounds: tuple[int, ...] = ()

    def colocated_with(self, other: "Dist") -> bool:
        return (self.kind in ("hash", "device")
                and other.kind in ("hash", "device")
                and self.shard_count == other.shard_count
                and self.placement == other.placement
                and self.bounds == other.bounds)


# --------------------------------------------------------------------------
# plan nodes
# --------------------------------------------------------------------------

@dataclass
class PlanNode:
    dist: Dist = field(default=None, init=False)  # type: ignore
    out_columns: dict[str, DataType] = field(default_factory=dict, init=False)
    est_rows: int = field(default=0, init=False)


@dataclass
class ScanNode(PlanNode):
    rel: BoundRel
    filter: Optional[ir.BExpr]
    columns: list[str]               # cids to load
    pruned_shards: Optional[list[int]] = None  # shard indices after pruning


@dataclass
class JoinNode(PlanNode):
    strategy: str  # local | broadcast | repart_left | repart_right | repart_both | cartesian
    left: PlanNode
    right: PlanNode
    left_keys: list[ir.BExpr]
    right_keys: list[ir.BExpr]
    residual: Optional[ir.BExpr] = None
    # for repart_left/right: index of the key pair aligned with the
    # partner's distribution column — the shuffle hashes ONLY that key
    # (hashing all keys would route rows off the partner's shards)
    repart_key_idx: int = 0
    # inner | left | right | full | semi | anti — relative to THIS node's
    # sides ('left' preserves the probe/left side, 'right' the build/right
    # side; semi/anti filter the probe side by match existence and emit
    # probe columns only)
    join_type: str = "inner"
    # estimated matches per probe row (build_rows / build-key ndv): sizes
    # the join-output buffer so many-to-many joins don't start at the
    # PK-FK assumption and burn overflow retries
    est_expansion: float = 1.0
    # single-side ON predicates of an outer join: gate matching without
    # filtering the preserved side's rows (ON vs WHERE distinction)
    left_match_filter: Optional[ir.BExpr] = None
    right_match_filter: Optional[ir.BExpr] = None
    # semi/anti only: probe side replicated over a sharded build — the
    # executor psum-combines per-device match flags across the mesh
    flag_combine: bool = False
    # which side the executor sorts / builds a key directory over (the
    # smaller side for inner joins; outer joins keep 'right' — the
    # null-extension machinery is oriented build=right)
    build_side: str = "right"
    # per key pair: (base, extent) of each side's key value range from
    # table statistics (manifest min/max — exact for committed data), or
    # None when unknown.  Drives the dense-directory probe path and
    # int32 key narrowing; stale ranges are caught at runtime (dense_oob)
    left_key_extents: tuple = ()
    right_key_extents: tuple = ()
    # per key pair: both sides' ranges proven to fit int32 (TPU int64 is
    # software-emulated — narrowing halves key gather/compare traffic)
    key_int32: tuple = ()
    # statistics say the build side is unique on the join key (PK side):
    # the executor fuses the join as a per-probe lookup — output block ==
    # probe block + gathered build columns, no pair-expansion buffers.
    # A runtime duplicate (stale stats) surfaces as dense_oob and retries
    # on the general expansion path
    fuse_lookup: bool = False
    # fused-lookup probe strategy: True routes the probe through the
    # bucketed, tile-resident path (ops.join.bucketed_unique_lookup)
    # instead of the single random directory gather.  Chosen by the
    # size-threshold rule probe_bucket_eligible on a CUDA device
    # (bucketed_paths_enabled).  Per-bucket probe capacity is a static
    # buffer with the usual overflow-retry + feedback.
    probe_bucketed: bool = False


@dataclass
class AggregateNode(PlanNode):
    combine: str  # local | global | repartition
    input: PlanNode
    group_keys: list[tuple[ir.BExpr, str]]      # (expr, out cid)
    aggs: list[tuple[ir.BAgg, str]]             # (agg, out cid)
    # estimated distinct group count (0 = unknown); sizes the static
    # aggregate-output/shuffle buffers so low-cardinality GROUP BYs don't
    # allocate (and transfer) input-sized results
    est_groups: int = 0
    # dense-grid aggregation: when every group key is a bare column with a
    # known small value range, keys map to a dense slot id and aggregation
    # is ONE unsorted segment reduction over [total_slots] — no sort, and
    # the cross-device combine is psum/pmin/pmax instead of an all_to_all
    # shuffle (the TPU-native fast path; the sort path remains for
    # high-cardinality keys).  Entries: (base, extent, has_null) per key.
    dense_keys: Optional[tuple[tuple[int, int, bool], ...]] = None
    dense_total: int = 0
    # (base, extent, has_null) per group key whenever every range is
    # known (no size cap): the sort-path executor packs the composite
    # key into ONE int64 so group detection rides a single-operand
    # argsort instead of a multi-operand lexsort (TPU sorts are much
    # faster single-operand); stale ranges retry via dense_oob
    key_ranges: Optional[tuple[tuple[int, int, bool], ...]] = None
    # combine='repartition' only: route the shuffle by THIS subset of
    # group-key indices (None = all keys).  The DISTINCT rewrite routes
    # the dedupe level by the outer GROUP BY keys alone so the
    # re-aggregation level stays device-local
    repart_keys: Optional[tuple[int, ...]] = None
    # bucketed dense-grid aggregation (ops/groupby.py): the packed key
    # space is ABOVE the dense grid's slot cap but small/occupied
    # enough to radix-partition into GROUP_TILE_SLOTS-wide tiles and
    # reduce sort-free — the aggregation twin of the bucketed join
    # probe.  Entries mirror key_ranges ((base, extent, has_null) per
    # key; the slot always reserves the null lane, so bucket_total is
    # the product of extent+1).  Stale ranges retry via dense_oob.
    bucket_keys: Optional[tuple[tuple[int, int, bool], ...]] = None
    bucket_total: int = 0
    # the planner's device-gated pick (bucketed_paths_enabled): True
    # on a CUDA device wherever bucket_keys is structurally set, where
    # the tile sums run in the shared-memory kernel; the CPU keeps the
    # sort path.
    group_bucketed: bool = False


@dataclass
class ProjectNode(PlanNode):
    input: PlanNode
    exprs: list[tuple[ir.BExpr, str]]           # (expr, out cid)


@dataclass
class WindowNode(PlanNode):
    """Window-function stage: co-locate partitions, sort, segmented scan.

    The partition-by axis maps onto the same shuffle machinery joins use
    (reference: window pushdown in planner/query_pushdown_planning.c —
    Citus requires the partition key to include the distribution column;
    here non-aligned partitions repartition with all_to_all instead).
    All functions share one partition_by (v1); functions with different
    ORDER BY specs get separate device sorts over the same shuffle."""

    input: PlanNode
    functions: list[tuple["ir.BWindow", str]]   # (window, out cid)
    partition_by: tuple = ()
    combine: str = "local"        # local | repartition


# --------------------------------------------------------------------------
# planner context
# --------------------------------------------------------------------------

def table_placement(catalog: Catalog, table: str, n_devices: int,
                    probe: bool = True) -> tuple[int, ...]:
    """shard index → device index map (the single source of the
    node→device rule; feed placement and planners must agree).

    Routes through the catalog's explicit node↔device map
    (catalog.node_device_map): active nodes ranked by node_id take
    devices round-robin.  A placement on a node outside the map (a
    suspect read failing over through a disabled node's replica) falls
    back to the legacy node-id fold rather than erroring — the rows
    still land on one deterministic device.

    `probe=False` skips the catalog.placement_probe fault seam
    (active_placement's estimation-caller contract): the WLM admission
    byte estimator resolves placements per statement and must not
    multiply — or consume — an armed probe fault meant for the
    execution path."""
    dmap = catalog.node_device_map(n_devices)
    out = []
    for s in catalog.table_shards(table):
        node_id = catalog.active_placement(s.shard_id,
                                           probe=probe).node_id
        out.append(dmap.get(node_id, (node_id - 1) % n_devices))
    return tuple(out)


def bucketed_paths_enabled(device) -> bool:
    """The one gate of the planner's two bucketed picks (JoinNode.
    probe_bucketed, AggregateNode.group_bucketed): on when the plan runs
    on a CUDA device, where the tile-resident kernels serve them.  The
    structural eligibility rules (probe_bucket_eligible,
    group_bucket_eligible) apply on top.  The CPU tests patch this
    function to walk the bucketed paths with the plain formulations."""
    import torch

    return torch.device(device).type == "cuda"


class StatsProvider:
    """Row counts + column cardinalities for capacity planning
    (shard_size/row metadata analogue, metadata/metadata_utility.c; ndv
    plays the role of pg_statistic's n_distinct for the estimator)."""

    def table_rows(self, table: str) -> int:  # pragma: no cover
        raise NotImplementedError

    def column_ndv(self, table: str, column: str,
                   dtype) -> int | None:  # pragma: no cover
        """Distinct-value estimate for a column; None = unknown."""
        return None

    def column_extent(self, table: str, column: str,
                      dtype) -> tuple[int, int] | None:  # pragma: no cover
        """(base, extent) of the column's value range — dictionary codes
        for strings, manifest min/max for ints/dates; None = unknown."""
        return None


@dataclass
class QueryPlan:
    """Device plan + the host-side combine phase
    (combine_query_planner.c analogue)."""

    root: PlanNode
    n_devices: int
    # host phase — exprs over the device plan's output cids:
    host_select: list[tuple[ir.BExpr, str]]     # (expr, output name)
    host_having: Optional[ir.BExpr]
    host_order_by: list[tuple[ir.BExpr, bool, bool | None]]
    limit: Optional[int]
    offset: Optional[int]
    # cid → (table, column) for dictionary decode of string outputs
    decode: dict[str, tuple[str, str]]
    catalog_version: int = 0
    # ORDER BY + LIMIT pushed onto the device: each device keeps only its
    # top-(limit+offset) rows by the ORDER BY keys, so the result
    # transfer is O(n_dev·k) instead of the full padded buffer (the
    # device-side analogue of the reference's worker-side LIMIT pushdown,
    # planner/multi_logical_optimizer.c worker limit handling)
    device_topk: Optional[int] = None
    # INSERT..SELECT repartition mode: route the final block to the
    # TARGET table's sharding on device (pack_by_target + all_to_all —
    # the worker_partition_query_result analogue,
    # partitioned_intermediate_results.c:108) so the host writes
    # per-device slices instead of re-hashing rows on numpy.
    # (shard_count, placement, bounds, key_expr over root outputs)
    output_repart: Optional[tuple] = None


class DistributedPlanner:
    def __init__(self, catalog: Catalog, stats: StatsProvider,
                 n_devices: int, enable_repartition: bool = True,
                 dicts=None, device="cpu"):
        self.catalog = catalog
        # the device the plan runs on: gates the bucketed probe and
        # group-by picks (bucketed_paths_enabled)
        self.device = device
        self.stats = stats
        self.n_devices = n_devices
        self.enable_repartition = enable_repartition
        self.dicts = dicts  # DictProvider for string routing-token lookup

    # -- table dist --------------------------------------------------------
    def _table_dist(self, rel: BoundRel) -> Dist:
        meta = self.catalog.table(rel.table)
        if meta.method == DistributionMethod.REFERENCE:
            return Dist("replicated")
        if meta.method == DistributionMethod.LOCAL:
            # controller-local tables are fed replicated for now
            return Dist("replicated")
        shards = self.catalog.table_shards(rel.table)
        placement = table_placement(self.catalog, rel.table, self.n_devices)
        return Dist("hash",
                    frozenset({rel.cid(meta.distribution_column)}),
                    len(shards), placement,
                    tuple(int(s.min_value) for s in shards))

    def device_dist(self, cids: frozenset[str]) -> Dist:
        from ..catalog.distribution import shard_interval_bounds

        return Dist("device", cids, self.n_devices,
                    tuple(range(self.n_devices)),
                    tuple(lo for lo, _ in
                          shard_interval_bounds(self.n_devices)))

    # -- entry -------------------------------------------------------------
    def plan(self, q: BoundQuery) -> QueryPlan:
        needed = self._collect_needed_columns(q)

        # WHERE conjuncts over NULL-extendable rels apply AFTER the outer
        # join (null extension precedes WHERE); the rest participate in
        # inner planning / scan pushdown as before
        inner_conjuncts: list[ir.BExpr] = []
        post_conjuncts: list[ir.BExpr] = []
        for c in q.conjuncts:
            rels = {n.rel_index for n in ir.walk(c) if isinstance(n, ir.BCol)}
            if rels & q.nullable_rels:
                post_conjuncts.append(c)
            else:
                inner_conjuncts.append(c)

        # classify each outer join's ON clause: equi edges, single-side
        # gates, and predicates pushable into a non-preserved side's scan
        outer_info = []
        push_extra: dict[int, list[ir.BExpr]] = {}
        for spec in q.outer_joins:
            info = self._classify_outer_on(spec, q)
            outer_info.append(info)
            for ri, cs in info["push"].items():
                push_extra.setdefault(ri, []).extend(cs)

        scans = {}
        for rel in q.rels:
            cols = sorted(needed.get(rel.rel_index, set()))
            rel_conjuncts = inner_conjuncts + push_extra.get(
                rel.rel_index, [])
            scans[rel.rel_index] = self._make_scan(rel, cols, rel_conjuncts)

        joined = self._plan_joins(q, scans, inner_conjuncts, post_conjuncts,
                                  outer_info)

        decode: dict[str, tuple[str, str]] = {}
        has_window = any(
            isinstance(n, ir.BWindow)
            for e, _ in q.select for n in ir.walk(e)) or any(
            isinstance(n, ir.BWindow)
            for e, _, _ in q.order_by for n in ir.walk(e))
        if q.having is not None and any(
                isinstance(n, ir.BWindow) for n in ir.walk(q.having)):
            # PG also rejects this (windows run after HAVING)
            raise PlanningError(
                "window functions are not allowed in HAVING")
        if has_window:
            if q.is_aggregate or q.distinct:
                raise PlanningError(
                    "window functions over GROUP BY / DISTINCT queries "
                    "are not supported yet")
            joined, q = self._plan_window_stage(q, joined)
        if q.is_aggregate or q.distinct:
            root, host_select, having, host_order = self._plan_aggregate(
                q, joined, decode)
        else:
            root, host_select, host_order = self._plan_projection(
                q, joined, decode)
            having = None

        plan = QueryPlan(root=root, n_devices=self.n_devices,
                         host_select=host_select, host_having=having,
                         host_order_by=host_order, limit=q.limit,
                         offset=q.offset, decode=decode,
                         catalog_version=self.catalog.version)
        plan.device_topk = self._plan_device_topk(plan)
        return plan

    def _plan_device_topk(self, plan: QueryPlan) -> Optional[int]:
        """LIMIT (+ ORDER BY) pushdown: per-device top-k selection.

        Pushable when every ORDER BY key evaluates device-side with the
        same ordering the host sort would apply — which excludes
        dictionary-decoded strings (code order ≠ collation order).  The
        host still sorts/limits the merged n_dev·k rows, so per-device
        selection only has to return a superset of each device's
        contribution to the global top-k."""
        if plan.limit is None or plan.host_having is not None:
            return None
        k = plan.limit + (plan.offset or 0)
        for e, _desc, _nf in plan.host_order_by:
            for n in ir.walk(e):
                if isinstance(n, ir.BCol):
                    if n.cid in plan.decode:
                        return None  # string order needs the dictionary
                    if n.cid not in plan.root.out_columns:
                        return None
            if e.dtype == DataType.STRING:
                return None
        return k

    # -- column collection -------------------------------------------------
    def _collect_needed_columns(self, q: BoundQuery) -> dict[int, set[str]]:
        needed: dict[int, set[str]] = {}

        def visit(e: ir.BExpr):
            for node in ir.walk(e):
                if isinstance(node, ir.BCol):
                    needed.setdefault(node.rel_index, set()).add(node.cid)

        for c in q.conjuncts:
            visit(c)
        for spec in q.outer_joins:
            for c in spec.on:
                visit(c)
        for e, _ in q.select:
            visit(e)
        for g in q.group_by:
            visit(g)
        if q.having is not None:
            visit(q.having)
        for e, _, _ in q.order_by:
            visit(e)
        return needed

    # -- scans + filter pushdown ------------------------------------------
    def _make_scan(self, rel: BoundRel, cols: list[str],
                   conjuncts: list[ir.BExpr]) -> ScanNode:
        local = []
        for c in conjuncts:
            rels = {n.rel_index for n in ir.walk(c) if isinstance(n, ir.BCol)}
            # subset includes the empty set: constant predicates (WHERE
            # false, folded empty-IN-subquery) attach to every scan
            if rels <= {rel.rel_index}:
                local.append(c)
        node = ScanNode(rel=rel, filter=ir.make_and(local), columns=cols)
        node.dist = self._table_dist(rel)
        base_rows = max(1, self.stats.table_rows(rel.table))
        node.est_rows = max(1, int(base_rows
                                   * self._selectivity(rel, local)))
        node.out_columns = {}
        for cid in cols:
            col = rel.schema.column(cid.split(".", 1)[1])
            node.out_columns[cid] = col.dtype
        node.pruned_shards = self._prune_shards(rel, local)
        return node

    def _selectivity(self, rel: BoundRel, filters: list[ir.BExpr]) -> float:
        """Product of per-conjunct selectivities from column extents
        (uniform-distribution assumption — the pg_statistic-lite
        estimator; defaults mirror PostgreSQL's 1/3 inequality and
        1/ndv equality guesses)."""
        sel = 1.0
        for f in filters:
            sel *= self._conjunct_selectivity(rel, f)
        return min(1.0, max(sel, 1e-6))

    def _conjunct_selectivity(self, rel: BoundRel, f: ir.BExpr) -> float:
        col = const = None
        op = None
        if isinstance(f, ir.BCmp):
            if isinstance(f.left, ir.BCol) and isinstance(f.right, ir.BConst):
                col, op, const = f.left, f.op, f.right.value
            elif isinstance(f.right, ir.BCol) and \
                    isinstance(f.left, ir.BConst):
                flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
                if f.op in flip:
                    col, op, const = f.right, flip[f.op], f.left.value
        elif isinstance(f, ir.BInConst) and isinstance(f.operand, ir.BCol):
            ndv = self.stats.column_ndv(f.operand.table, f.operand.column,
                                        f.operand.dtype)
            frac = (len(f.values) / ndv) if ndv else 0.05 * len(f.values)
            return min(1.0, 1.0 - frac if f.negated else frac)
        elif isinstance(f, ir.BBool) and f.op == "AND":
            out = 1.0
            for a in f.args:
                out *= self._conjunct_selectivity(rel, a)
            return out
        if col is None or const is None or not col.table:
            return 1.0 / 3.0 if isinstance(f, (ir.BCmp, ir.BBool)) else 1.0
        ext = self.stats.column_extent(col.table, col.column, col.dtype)
        if op == "=":
            ndv = ext[1] if ext else None
            return 1.0 / ndv if ndv else 0.005
        if ext is None or ext[1] <= 1 or not isinstance(const, (int, float)):
            return 1.0 / 3.0
        lo, extent = ext
        frac = (float(const) - lo) / extent  # fraction below const
        frac = min(1.0, max(0.0, frac))
        if op in ("<", "<="):
            return max(frac, 1e-6)
        if op in (">", ">="):
            return max(1.0 - frac, 1e-6)
        return 1.0 / 3.0

    def _prune_shards(self, rel: BoundRel,
                      filters: list[ir.BExpr]) -> Optional[list[int]]:
        """Equality/IN on the distribution column → shard list
        (PruneShards analogue, planner/shard_pruning.c:304 — hash
        distribution prunes on equality only)."""
        meta = self.catalog.table(rel.table)
        if meta.method != DistributionMethod.HASH:
            return None
        from ..catalog.distribution import (
            hash_token,
            shard_index_for_token_ranges,
        )
        import numpy as np

        dist_cid = rel.cid(meta.distribution_column)
        dtype = meta.schema.column(meta.distribution_column).dtype
        candidates: Optional[set[int]] = None
        for f in filters:
            values = None
            # BParam counts: pruning is host-side per execution, so the
            # bound value is usable even in a generic plan (the deferred
            # param-pruning of CitusBeginScan, citus_custom_scan.c:213)
            if isinstance(f, ir.BCmp) and f.op == "=":
                col, lit = f.left, f.right
                if not (isinstance(col, ir.BCol) and col.cid == dist_cid):
                    col, lit = f.right, f.left  # literal-first: 5 = k
                if isinstance(col, ir.BCol) and col.cid == dist_cid \
                        and isinstance(lit, (ir.BConst, ir.BParam)) \
                        and lit.value is not None:
                    values = [lit.value]
            elif (isinstance(f, ir.BInConst) and not f.negated
                    and isinstance(f.operand, ir.BCol)
                    and f.operand.cid == dist_cid):
                values = list(f.values)
            if values is None:
                continue
            if dtype == DataType.STRING:
                # STRING predicates are lowered to dictionary CODES by the
                # binder; routing tokens come from the dictionary's token
                # table, NOT from hashing the code itself
                if self.dicts is None:
                    continue
                d = self.dicts.dictionary(rel.table,
                                          meta.distribution_column)
                token_table = d.hash_tokens()
                codes = [int(v) for v in values
                         if 0 <= int(v) < len(token_table)]
                if not codes:
                    return []  # value absent from the table: no shard
                tokens = token_table[np.asarray(codes, dtype=np.int64)]
            else:
                arr = np.asarray(values, dtype=dtype.numpy_dtype)
                tokens = hash_token(arr)
            idx = set(int(i) for i in shard_index_for_token_ranges(
                tokens, self.catalog.shard_mins(rel.table)))
            candidates = idx if candidates is None else (candidates & idx)
        return sorted(candidates) if candidates is not None else None

    # -- outer + semi/anti joins ------------------------------------------
    def _classify_outer_on(self, spec, q: BoundQuery) -> dict:
        """ON conjuncts → equi edges + single-side gates + scan pushdowns.

        A predicate over only the NON-preserved side may push into that
        side's scan (its rows vanish from the result anyway); a predicate
        over only the PRESERVED side becomes a match gate (rows failing it
        still emit, null-extended).  Cross-side non-equi residuals are
        supported for semi/anti joins only (they gate match existence —
        the Q21 `l2.l_suppkey <> l1.l_suppkey` shape); outer joins still
        reject them."""
        right = spec.right_rel_index
        semi = spec.join_type in ("semi", "anti")
        edges = []
        left_gate: list[ir.BExpr] = []
        right_gate: list[ir.BExpr] = []
        residual: list[ir.BExpr] = []
        push: dict[int, list[ir.BExpr]] = {}
        for c in spec.on:
            rels = {n.rel_index for n in ir.walk(c) if isinstance(n, ir.BCol)}
            if rels <= {right}:
                if spec.join_type in ("left", "semi", "anti"):
                    # semi/anti: a pure-inner predicate restricts which
                    # rows EXIST in the subquery side → scan filter
                    push.setdefault(right, []).append(c)
                else:  # right/full preserve the right side → gate only
                    right_gate.append(c)
                continue
            if right not in rels:
                if spec.join_type == "right" and len(rels) == 1:
                    push.setdefault(next(iter(rels)), []).append(c)
                else:  # left/full/semi/anti preserve the tree side → gate
                    left_gate.append(c)
                continue
            if (isinstance(c, ir.BCmp) and c.op == "=" and len(rels) == 2
                    and c.left.dtype.value not in ("float32", "float64")
                    and c.right.dtype.value not in ("float32", "float64")):
                lrels = {n.rel_index for n in ir.walk(c.left)
                         if isinstance(n, ir.BCol)}
                rrels = {n.rel_index for n in ir.walk(c.right)
                         if isinstance(n, ir.BCol)}
                if len(lrels) == 1 and len(rrels) == 1 and lrels != rrels:
                    edges.append((frozenset(rels), c.left, c.right))
                    continue
            if semi:
                residual.append(c)  # evaluated per candidate pair
                continue
            raise PlanningError(
                "outer join ON supports equality keys and single-side "
                "predicates only")
        if not edges:
            kind = ("correlated EXISTS/IN" if semi else "outer joins")
            raise PlanningError(f"{kind} require an equality join key")
        return {"spec": spec, "edges": edges, "left_gate": left_gate,
                "right_gate": right_gate, "residual": residual,
                "push": push}

    def _apply_outer_join(self, current: PlanNode, scan: ScanNode,
                          info: dict, placed: set[int]) -> PlanNode:
        spec = info["spec"]
        if spec.join_type in ("right", "full") and \
                placed != set(spec.tree_rels):
            raise PlanningError(
                f"{spec.join_type.upper()} JOIN cannot combine with other "
                "FROM entries (its left side must be the whole join tree)")
        if spec.join_type in ("semi", "anti"):
            return self._apply_semi_join(current, scan, info)
        strategy = self._choose_strategy(current, scan, info["edges"])
        if strategy in ("cartesian", "cartesian_broadcast"):
            raise PlanningError("outer joins require an equality join key")
        node = self._make_join(current, scan, info["edges"], strategy,
                               scan.rel.rel_index,
                               join_type=spec.join_type)
        # gates are relative to (tree=left, rel=right); _make_join swapped
        # sides (and flipped join_type) for broadcast_left
        swapped = node.left is scan
        node.left_match_filter = ir.make_and(
            info["right_gate"] if swapped else info["left_gate"])
        node.right_match_filter = ir.make_and(
            info["left_gate"] if swapped else info["right_gate"])
        return node

    def _apply_semi_join(self, current: PlanNode, scan: ScanNode,
                         info: dict) -> PlanNode:
        """Semi/anti join: probe (tree) rows filtered by match existence
        against the subquery relation.  Sides never swap — the probe side
        is always the tree.  When the probe is replicated and the build
        sharded, each device sees only part of the build, so the executor
        psum-combines the per-device match flags (`flag_combine`)."""
        spec = info["spec"]
        strategy = self._choose_strategy(current, scan, info["edges"])
        flag_combine = False
        if strategy in ("cartesian", "cartesian_broadcast"):
            raise PlanningError(
                "correlated EXISTS/IN require an equality correlation")
        if strategy == "broadcast_left":
            # probe replicated, build sharded: run devicewise and combine
            # match flags across the mesh instead of swapping sides
            strategy = "local"
            flag_combine = self.n_devices > 1
        node = self._make_join(current, scan, info["edges"], strategy,
                               scan.rel.rel_index,
                               join_type=spec.join_type)
        assert node.left is current, "semi join sides must not swap"
        node.flag_combine = flag_combine
        if flag_combine:
            node.dist = current.dist
        node.left_match_filter = ir.make_and(info["left_gate"])
        node.right_match_filter = ir.make_and(info["right_gate"])
        if info["residual"]:
            node.residual = ir.make_and(info["residual"])
        # output = probe rows only; the build side's columns vanish
        node.out_columns = dict(current.out_columns)
        sel = 0.5  # default semi-join selectivity (no distinct stats)
        node.est_rows = max(1, int(current.est_rows * sel))
        return node

    # -- join order + strategies ------------------------------------------
    def _plan_joins(self, q: BoundQuery, scans: dict[int, ScanNode],
                    inner_conjuncts: list[ir.BExpr],
                    post_conjuncts: list[ir.BExpr],
                    outer_info: list[dict]) -> PlanNode:
        outer_rels = {s.right_rel_index for s in q.outer_joins}
        inner_scans = {ri: s for ri, s in scans.items()
                       if ri not in outer_rels}
        current = self._plan_inner_joins(q, inner_scans, inner_conjuncts)
        placed = set(inner_scans)
        # true outer joins first; then post-join WHERE conjuncts (they
        # filter null-extended rows, so they must precede semi/anti
        # application only logically — semi nodes' residual field means
        # "pair-match residual", never an output filter)
        semi_info = [i for i in outer_info
                     if i["spec"].join_type in ("semi", "anti")]
        for info in outer_info:
            if info["spec"].join_type in ("semi", "anti"):
                continue
            spec = info["spec"]
            current = self._apply_outer_join(
                current, scans[spec.right_rel_index], info, placed)
            placed.add(spec.right_rel_index)
        if post_conjuncts:
            if not isinstance(current, JoinNode):
                raise PlanningError(
                    "internal: post-join filter without a join")
            res = ir.make_and(post_conjuncts)
            current.residual = (res if current.residual is None
                                else ir.make_and([current.residual, res]))
        for info in semi_info:
            spec = info["spec"]
            current = self._apply_outer_join(
                current, scans[spec.right_rel_index], info, placed)
            placed.add(spec.right_rel_index)
        return current

    def _plan_inner_joins(self, q: BoundQuery,
                          scans: dict[int, ScanNode],
                          conjuncts: list[ir.BExpr]) -> PlanNode:
        if len(scans) == 1:
            return next(iter(scans.values()))

        # classify cross-rel conjuncts into equi-join edges vs residuals
        edges = []      # (rel_set, left_expr, right_expr)
        residuals = []  # (rel_set, expr)
        for c in conjuncts:
            rels = {n.rel_index for n in ir.walk(c) if isinstance(n, ir.BCol)}
            if len(rels) <= 1:
                continue
            if (isinstance(c, ir.BCmp) and c.op == "=" and len(rels) == 2
                    and c.left.dtype.value not in ("float32", "float64")
                    and c.right.dtype.value not in ("float32", "float64")):
                # float equalities (e.g. Q2's decorrelated
                # ps_supplycost = min-cost) can't drive the key
                # machinery — they join as residual filters instead
                lrels = {n.rel_index for n in ir.walk(c.left)
                         if isinstance(n, ir.BCol)}
                rrels = {n.rel_index for n in ir.walk(c.right)
                         if isinstance(n, ir.BCol)}
                if len(lrels) == 1 and len(rrels) == 1 and lrels != rrels:
                    edges.append((frozenset(rels), c.left, c.right))
                    continue
            residuals.append((frozenset(rels), c))

        # greedy left-deep order: start from the largest relation
        # (BestJoinOrder starts from the largest table too); among
        # candidates of one strategy rank, fewer matches per probe row
        # first.  On one device every keyed join ranks "local", so size
        # alone would join a small relation through a many-to-many key
        # first (Q5's customer on c_nationkey = s_nationkey, thousands
        # of matches per row at SF1) ahead of the PK join that keeps the
        # stream one row per row
        remaining = dict(scans)
        start = max(remaining, key=lambda r: remaining[r].est_rows)
        current = remaining.pop(start)
        placed = {start}
        pending_edges = list(edges)
        pending_residuals = list(residuals)

        while remaining:
            best = None  # (rank, rel_index, join_edges)
            for ri, scan in remaining.items():
                join_edges = [e for e in pending_edges
                              if e[0] <= (placed | {ri})
                              and ri in e[0]]
                strategy = self._choose_strategy(current, scan, join_edges)
                rank = _STRATEGY_RANK[strategy]
                size = scan.est_rows
                keys = [a if {n.rel_index for n in ir.walk(a)
                              if isinstance(n, ir.BCol)} == {ri} else b
                        for _, a, b in join_edges]
                fanout = self._estimate_expansion_for(scan, keys)
                key = (rank, max(1.0, fanout or 1.0), size, ri)
                if best is None or key < best[0]:
                    best = (key, ri, join_edges, strategy)
            _, ri, join_edges, strategy = best
            right = remaining.pop(ri)
            placed.add(ri)
            pending_edges = [e for e in pending_edges if e not in join_edges]
            current = self._make_join(current, right, join_edges, strategy, ri)
            # attach residuals once all their rels are placed
            ready = [r for r in pending_residuals if r[0] <= placed]
            if ready:
                pending_residuals = [r for r in pending_residuals
                                     if r not in ready]
                res = ir.make_and([r[1] for r in ready])
                existing = current.residual
                current.residual = (res if existing is None
                                    else ir.make_and([existing, res]))
        return current

    def _choose_strategy(self, left: PlanNode, right: ScanNode,
                         join_edges) -> str:
        if not join_edges:
            # keyless join: only viable against a replicated side, and
            # ranked last so edge-connected relations join first
            if right.dist.kind == "replicated" or \
                    left.dist.kind == "replicated":
                return "cartesian_broadcast"
            return "cartesian"
        if right.dist.kind == "replicated":
            return "broadcast"
        if left.dist.kind == "replicated":
            # left replicated, right sharded: join runs devicewise against
            # right's shards; result inherits right's distribution
            return "broadcast_left"
        if self.n_devices == 1:
            # a 1-device mesh holds every shard on the same chip: any
            # keyed join is trivially co-located; all_to_all there would
            # be an identity shuffle paying full pack/unpack buffers
            # (the single-node local-join behavior of the reference's
            # local executor, executor/local_executor.c:163)
            return "local"
        # per-edge alignment with each side's partition columns: a join can
        # run locally / with a single repartition only through ONE edge
        # whose key matches the partition column (multi-edge joins like
        # Q5's customer ⋈ {orders,supplier} on (custkey, nationkey) must
        # not hash the extra keys into the routing)
        edge_align = []  # (left_aligned, right_aligned) per edge
        for _, a, b in join_edges:
            a_rels = {n.rel_index for n in ir.walk(a) if isinstance(n, ir.BCol)}
            if a_rels == {right.rel.rel_index}:
                r_e = {n.cid for n in ir.walk(a) if isinstance(n, ir.BCol)}
                l_e = {n.cid for n in ir.walk(b) if isinstance(n, ir.BCol)}
            else:
                l_e = {n.cid for n in ir.walk(a) if isinstance(n, ir.BCol)}
                r_e = {n.cid for n in ir.walk(b) if isinstance(n, ir.BCol)}
            edge_align.append((bool(left.dist.cids & l_e),
                               bool(right.dist.cids & r_e)))
        if any(la and ra for la, ra in edge_align) and \
                left.dist.colocated_with(right.dist):
            return "local"
        if not self.enable_repartition:
            raise PlanningError(
                "the query requires repartitioning, but "
                "enable_repartition_joins is off")
        if any(la for la, _ in edge_align):
            return "repart_right"
        if any(ra for _, ra in edge_align):
            return "repart_left"
        return "repart_both"

    def _make_join(self, left: PlanNode, right: ScanNode, join_edges,
                   strategy: str, right_rel_index: int,
                   join_type: str = "inner") -> JoinNode:
        left_keys, right_keys = [], []
        for _, a, b in join_edges:
            a_rels = {n.rel_index for n in ir.walk(a) if isinstance(n, ir.BCol)}
            if a_rels == {right_rel_index}:
                right_keys.append(a)
                left_keys.append(b)
            else:
                left_keys.append(a)
                right_keys.append(b)
        if strategy == "cartesian_broadcast":
            # keyless product against a replicated relation: put the
            # replicated side on the build (right) side
            if right.dist.kind == "replicated":
                node = JoinNode(strategy="broadcast", left=left, right=right,
                                left_keys=[], right_keys=[])
                node.dist = left.dist
            else:
                node = JoinNode(strategy="broadcast", left=right, right=left,
                                left_keys=[], right_keys=[])
                node.dist = right.dist
            node.est_rows = max(left.est_rows, right.est_rows)
            node.out_columns = {**left.out_columns, **right.out_columns}
            return node
        if strategy == "broadcast_left":
            # swap so the replicated side is the broadcast (right) side;
            # outer direction flips with the sides (LEFT ↔ RIGHT)
            node = JoinNode(strategy="broadcast", left=right, right=left,
                            left_keys=right_keys, right_keys=left_keys,
                            join_type={"left": "right", "right": "left"}.get(
                                join_type, join_type))
            node.dist = right.dist
        else:
            node = JoinNode(strategy=strategy, left=left, right=right,
                            left_keys=left_keys, right_keys=right_keys,
                            join_type=join_type)
        # per-edge cid sets, index-aligned with left_keys/right_keys
        edge_lcids = [frozenset(n.cid for n in ir.walk(e)
                                if isinstance(n, ir.BCol))
                      for e in left_keys]
        edge_rcids = [frozenset(n.cid for n in ir.walk(e)
                                if isinstance(n, ir.BCol))
                      for e in right_keys]

        def extend_cids(base: frozenset) -> frozenset:
            # equality edges propagate partition-column membership:
            # if one side of an edge is a partition col, so is the other
            out = set(base)
            changed = True
            while changed:
                changed = False
                for lc, rc in zip(edge_lcids, edge_rcids):
                    if (lc & out) and not (rc <= out):
                        out |= rc
                        changed = True
                    if (rc & out) and not (lc <= out):
                        out |= lc
                        changed = True
            return frozenset(out)

        if strategy == "local":
            node.dist = Dist(left.dist.kind, extend_cids(left.dist.cids),
                             left.dist.shard_count, left.dist.placement,
                             left.dist.bounds)
        elif strategy == "broadcast":
            node.dist = left.dist
        elif strategy == "broadcast_left":
            pass  # set above
        elif strategy == "repart_right":
            node.repart_key_idx = next(
                i for i, lc in enumerate(edge_lcids)
                if lc & left.dist.cids)
            node.dist = Dist(left.dist.kind, extend_cids(left.dist.cids),
                             left.dist.shard_count, left.dist.placement,
                             left.dist.bounds)
        elif strategy == "repart_left":
            node.repart_key_idx = next(
                i for i, rc in enumerate(edge_rcids)
                if rc & right.dist.cids)
            node.dist = Dist(right.dist.kind, extend_cids(right.dist.cids),
                             right.dist.shard_count, right.dist.placement,
                             right.dist.bounds)
        elif strategy == "repart_both":
            if len(edge_lcids) == 1 and \
                    isinstance(left_keys[0], ir.BCol) and \
                    isinstance(right_keys[0], ir.BCol):
                # a single BARE-COLUMN key shuffles by hash_token over
                # identity placement — genuinely reusable as a partition
                # property; expression keys route by the expression's hash,
                # which is NOT a partitioning of the underlying columns
                node.dist = self.device_dist(edge_lcids[0] | edge_rcids[0])
            else:
                # multi-key shuffles route by the COMPOSITE hash; claiming
                # per-column partitioning would let a later join/aggregate
                # falsely align with single-column hash placement
                node.dist = self.device_dist(frozenset())
        elif strategy == "cartesian":
            # sharded × sharded keyless product: all_gather the (smaller)
            # build side across the mesh, then cross each device's probe
            # shard against the full build relation.  Result keeps the
            # probe side's distribution (build columns replicate).
            # Reference analogue: CARTESIAN_PRODUCT join rule,
            # multi_join_order.h:40
            node.strategy = "cartesian_gather"
            node.dist = Dist(left.dist.kind, frozenset(left.dist.cids),
                             left.dist.shard_count, left.dist.placement,
                             left.dist.bounds)
        if node.join_type != "inner" and node.dist is not None:
            # null-extended rows carry NULL partition values, so only the
            # preserved side's own partition columns survive as a reliable
            # distribution property (no equivalence-extension either).
            # semi/anti output IS the probe side (no null extension), so
            # the probe's partition columns survive like 'left'
            if node.join_type in ("left", "semi", "anti"):
                keep = node.dist.cids & node.left.dist.cids
            elif node.join_type == "right":
                keep = node.dist.cids & node.right.dist.cids
            else:
                keep = frozenset()
            node.dist = Dist(node.dist.kind, keep, node.dist.shard_count,
                             node.dist.placement, node.dist.bounds)
        node.est_expansion = self._estimate_expansion(node)
        node.est_rows = max(int(node.left.est_rows * node.est_expansion),
                            left.est_rows, right.est_rows)
        if node.strategy == "cartesian_gather" or (
                node.strategy == "broadcast" and not node.left_keys):
            node.est_rows = max(1, node.left.est_rows
                                * node.right.est_rows)
        node.out_columns = {**left.out_columns, **right.out_columns}
        self._annotate_join_keys(node)
        return node

    def _annotate_join_keys(self, node: JoinNode) -> None:
        """Key range stats → dense-directory extents, int32 narrowing,
        and the build-side choice (smaller side sorts; inner joins only —
        the outer-join null-extension path is oriented build=right)."""
        node.left_key_extents = tuple(
            self._key_extent(e) for e in node.left_keys)
        node.right_key_extents = tuple(
            self._key_extent(e) for e in node.right_keys)
        int32_ok = []
        for le, re in zip(node.left_key_extents, node.right_key_extents):
            ok = False
            if le is not None and re is not None:
                lo = min(le[0], re[0])
                hi = max(le[0] + le[1], re[0] + re[1])
                ok = lo >= -(1 << 31) and hi <= (1 << 31) - 1
            int32_ok.append(ok)
        node.key_int32 = tuple(int32_ok)
        exp_left = self._estimate_expansion_for(node.left, node.left_keys)
        exp_right = self._estimate_expansion_for(node.right,
                                                 node.right_keys)
        uniq_l = exp_left is not None and exp_left <= 1.0
        uniq_r = exp_right is not None and exp_right <= 1.0
        if node.join_type == "inner" and node.left_keys:
            # prefer a provably-unique side as build (enables lookup
            # fusion); otherwise sort the smaller side
            if uniq_l != uniq_r:
                node.build_side = "left" if uniq_l else "right"
            else:
                node.build_side = ("left" if node.left.est_rows
                                   < node.right.est_rows else "right")
        if node.left_keys:
            build_uniq = (uniq_l if node.build_side == "left" else uniq_r)
            node.fuse_lookup = (build_uniq and node.join_type
                                in ("inner", "left"))
        if node.fuse_lookup:
            from ..ops.join import probe_bucket_eligible

            ext = (node.left_key_extents if node.build_side == "left"
                   else node.right_key_extents)
            probe = (node.right if node.build_side == "left"
                     else node.left)
            if ext and ext[0] is not None and \
                    bucketed_paths_enabled(self.device):
                # device-gated pick: the bucketed pack spends a sort to
                # buy gather locality, which the tile kernel turns into
                # shared-memory gathers on the card; on the CPU the
                # plain single gather rides the caches
                node.probe_bucketed = probe_bucket_eligible(
                    int(ext[0][1]), probe.est_rows)
        if node.fuse_lookup and node.join_type == "inner":
            # PK-side build: P(probe row matches) ≈ surviving build
            # fraction — the FK-join selectivity the generic estimate
            # (max of side estimates) misses entirely.  Feeds join-output
            # compaction, aggregate sizing, and group-count estimates.
            build = node.left if node.build_side == "left" else node.right
            probe = node.right if node.build_side == "left" else node.left
            base = self._unfiltered_rows(build)
            frac = min(1.0, build.est_rows / base) if base > 0 else 1.0
            node.est_rows = max(1, int(probe.est_rows * frac))

    def _unfiltered_rows(self, node: PlanNode) -> int:
        """Rows the node would produce with every filter removed — the
        denominator for FK-match-fraction estimation."""
        if isinstance(node, ScanNode):
            return max(1, self.stats.table_rows(node.rel.table))
        if isinstance(node, ProjectNode):
            return self._unfiltered_rows(node.input)
        if isinstance(node, JoinNode) and node.fuse_lookup and \
                node.join_type == "inner":
            probe = (node.right if node.build_side == "left"
                     else node.left)
            return self._unfiltered_rows(probe)
        return max(1, node.est_rows)

    def _key_extent(self, e: ir.BExpr) -> tuple[int, int] | None:
        if isinstance(e, ir.BCol) and e.table:
            return self.stats.column_extent(e.table, e.column, e.dtype)
        return None

    def _estimate_expansion(self, node: JoinNode) -> float:
        """Matches per probe row ≈ build_rows / ndv(build key) — the
        pg_statistic-style selectivity estimate for equi-joins; min over
        edges (every key must match), 1.0 when unknown/PK-like."""
        best = self._estimate_expansion_for(node.right, node.right_keys)
        return max(1.0, best) if best is not None else 1.0

    def _estimate_expansion_for(self, build_node: PlanNode,
                                build_keys) -> float | None:
        """Raw matches-per-probe estimate for one side as build; None =
        no usable statistics.  A value <= 1.0 marks the side as
        PK-unique on the key (lookup-fusion eligible — verified at
        runtime, stale claims retry on the expansion path)."""
        best = None
        rows = max(1, build_node.est_rows)
        for k in build_keys:
            if not (isinstance(k, ir.BCol) and k.table):
                continue
            ndv = self.stats.column_ndv(k.table, k.column, k.dtype)
            if ndv is None or ndv <= 0:
                continue
            e = rows / ndv
            best = e if best is None else min(best, e)
        return best

    # -- aggregation -------------------------------------------------------
    def _plan_aggregate(self, q: BoundQuery, input_node: PlanNode,
                        decode: dict):
        # rewrite select/having/order exprs: BAgg → BCol("aggN"); group
        # exprs → BCol("gN")
        group_keys: list[tuple[ir.BExpr, str]] = []
        group_map: dict[ir.BExpr, ir.BCol] = {}
        if q.distinct and not q.is_aggregate:
            # SELECT DISTINCT x, y = group by all select items
            items = [e for e, _ in q.select]
        else:
            items = q.group_by
        for i, g in enumerate(items):
            cid = f"g{i}"
            group_keys.append((g, cid))
            group_map[g] = ir.BCol(cid, g.dtype)
            if isinstance(g, ir.BCol) and g.dtype == DataType.STRING:
                decode[cid] = (g.table, g.column)
            elif isinstance(g, ir.BStrRemap):
                from ..storage.dictionary import EXPR_DICT

                decode[cid] = (EXPR_DICT, g.values)

        aggs: list[tuple[ir.BAgg, str]] = []
        agg_map: dict[ir.BAgg, ir.BExpr] = {}
        approx_args: list[ir.BExpr] = []

        def register_agg(a: ir.BAgg) -> ir.BExpr:
            if a in agg_map:
                return agg_map[a]
            if a.kind == "approx_count_distinct":
                # HLL: the registers materialize as groups (level 1),
                # level 2 folds them to (hcnt, hsum), and the returned
                # expression computes the estimate from those columns
                approx_args.append(a.arg)
                out = _hll_estimate_expr()
                agg_map[a] = out
                return out
            if a.distinct and a.kind in ("min", "max"):
                # DISTINCT is a no-op for min/max
                return register_agg(ir.BAgg(a.kind, a.arg, False, a.dtype))
            if a.kind == "avg":
                s = register_agg(ir.BAgg("sum", a.arg, a.distinct,
                                         DataType.FLOAT64))
                c = register_agg(ir.BAgg("count", a.arg, a.distinct,
                                         DataType.INT64))
                out = ir.BArith("/", s, ir.BCast(c, DataType.FLOAT64),
                                DataType.FLOAT64)
            else:
                cid = f"agg{len(aggs)}"
                aggs.append((a, cid))
                out = ir.BCol(cid, a.dtype)
                if a.kind in ("count", "count_star"):
                    # SQL count is NEVER NULL — but the distinct/approx
                    # splits re-aggregate partial counts as sum, and sum
                    # over an EMPTY input is NULL (fuzz catch: mixed
                    # count + count(distinct) over zero rows)
                    out = ir.BCase(
                        ((ir.BIsNull(out),
                          ir.BConst(0, DataType.INT64)),),
                        out, DataType.INT64)
            agg_map[a] = out
            return out

        def rewrite(e: ir.BExpr) -> ir.BExpr:
            if e in group_map:
                return group_map[e]
            if isinstance(e, ir.BAgg):
                return register_agg(e)
            return _rebuild(e, [rewrite(c) for c in ir.children(e)])

        host_select = [(rewrite(e), name) for e, name in q.select]
        having = rewrite(q.having) if q.having is not None else None
        host_order = []
        group_cids = {cid for _, cid in group_keys}
        for e, desc, nf in q.order_by:
            re_ = rewrite(e)  # may register new aggregates (ORDER BY sum(x))
            for n in ir.walk(re_):
                # after rewrite, only group ("gN") / aggregate ("aggN")
                # references are legal; a raw relation cid ("2.col") means
                # the sort column is neither grouped nor aggregated
                if isinstance(n, ir.BCol) and n.cid not in group_cids \
                        and not n.cid.startswith("agg"):
                    raise PlanningError(
                        f"ORDER BY column {n.cid.split('.')[-1]!r} must "
                        "appear in the GROUP BY clause or be used in an "
                        "aggregate function")
            host_order.append((re_, desc, nf))

        if approx_args:
            node = self._plan_approx_aggregate(
                input_node, group_keys, aggs, approx_args,
                q.nullable_rels)
            return node, host_select, having, host_order
        if not any(a.distinct for a, _ in aggs):
            node = self._finish_aggregate(input_node, group_keys, aggs,
                                          q.nullable_rels)
            return node, host_select, having, host_order

        node = self._plan_distinct_aggregate(input_node, group_keys, aggs,
                                             q.nullable_rels)
        return node, host_select, having, host_order

    def _plan_approx_aggregate(self, input_node: PlanNode, group_keys,
                               aggs, approx_args,
                               nullable_rels) -> AggregateNode:
        """approx_count_distinct via HyperLogLog over the aggregate split
        (reference rewrite: count(distinct)→hll worker/coordinator pair,
        planner/multi_logical_optimizer.c:286).  TPU-native shape: the
        HLL registers ARE groups —

          level 1: GROUP BY (G…, hll_bucket(x))  max(hll_rho(x)) as hr
                   (a segment max; shuffle/psum combine like any
                   aggregate — registers merge by max, so distribution
                   falls out of the existing machinery)
          level 2: GROUP BY G…  count(hr) as hcnt,
                   sum(2^-hr) as hsum

        and the host/device estimate expression (register_agg) computes
        alpha·m²/(empty + hsum) with the linear-counting small-range
        correction from those two columns.  NULL x rows carry NULL rho,
        which count()/sum() skip — count-distinct's NULL semantics."""
        from ..ops.sketches import HLL_P

        dargs = set(approx_args)
        if len(dargs) > 1:
            raise PlanningError(
                "multiple approx_count_distinct over different "
                "expressions are not supported in one query")
        if any(a.distinct for a, _ in aggs):
            raise PlanningError(
                "approx_count_distinct cannot combine with exact "
                "DISTINCT aggregates in one query")
        arg = next(iter(dargs))
        bucket = ir.BHllBucket(arg, HLL_P)
        rho = ir.BHllRho(arg, HLL_P)
        inner_keys = list(group_keys) + [(bucket, "hb")]
        inner_aggs: list[tuple[ir.BAgg, str]] = [
            (ir.BAgg("max", rho, False, DataType.INT32), "hr")]
        hr = ir.BCol("hr", DataType.INT32)
        outer_aggs: list[tuple[ir.BAgg, str]] = [
            (ir.BAgg("count", hr, False, DataType.INT64), "hcnt"),
            (ir.BAgg("sum", ir.BMath("exp2neg", hr), False,
                     DataType.FLOAT64), "hsum")]
        for a, cid in aggs:  # plain aggregates: partial + re-aggregate
            pcid = f"p{len(inner_aggs)}"
            inner_aggs.append((a, pcid))
            okind = "sum" if a.kind in ("count", "count_star") else a.kind
            pdtype = (DataType.INT64
                      if a.kind in ("count", "count_star") else a.dtype)
            outer_aggs.append((ir.BAgg(
                okind, ir.BCol(pcid, pdtype), False, a.dtype), cid))

        inner = self._finish_aggregate(input_node, inner_keys, inner_aggs,
                                       nullable_rels)
        g_cids = {g.cid for g, _ in group_keys if isinstance(g, ir.BCol)}
        if inner.combine == "repartition" and group_keys:
            inner.repart_keys = tuple(range(len(group_keys)))

        outer_keys = [(ir.BCol(cid, g.dtype), cid)
                      for g, cid in group_keys]
        outer = AggregateNode(combine="", input=inner,
                              group_keys=outer_keys, aggs=outer_aggs)
        outer.est_groups = self._estimate_groups(group_keys, input_node)
        if not group_keys:
            outer.combine = "global"
        elif inner.combine in ("repartition", "local") and \
                self.n_devices == 1:
            outer.combine = "local"
        elif inner.combine == "repartition" or (
                input_node.dist.kind in ("hash", "device")
                and (input_node.dist.cids & g_cids)):
            outer.combine = "local"
        else:
            outer.combine = "repartition"
        outer.dist = (self.device_dist(frozenset())
                      if outer.combine == "repartition" else inner.dist)
        outer.est_rows = inner.est_rows
        outer.out_columns = {}
        for g, cid in group_keys:
            outer.out_columns[cid] = g.dtype
        for a, cid in outer_aggs:
            outer.out_columns[cid] = a.dtype
        return outer

    def _plan_distinct_aggregate(self, input_node: PlanNode, group_keys,
                                 aggs, nullable_rels) -> AggregateNode:
        """DISTINCT aggregates as a two-level split (the worker/master
        count(distinct) rewrite of the reference's logical optimizer,
        planner/multi_logical_optimizer.c:286 GetAggregateType — here
        without requiring an hll extension):

          inner:  GROUP BY (G…, arg)  — global dedupe; the shuffle
                  routes by G alone so same-G rows co-locate,
          outer:  GROUP BY G, device-local — count/sum over the deduped
                  arg rows, re-aggregation of the non-distinct partials.
        """
        dargs = {a.arg for a, _ in aggs if a.distinct}
        if len(dargs) > 1:
            raise PlanningError(
                "multiple DISTINCT aggregates over different "
                "expressions are not supported")
        darg = next(iter(dargs))
        inner_keys = list(group_keys) + [(darg, "gd")]
        inner_aggs: list[tuple[ir.BAgg, str]] = []
        outer_aggs: list[tuple[ir.BAgg, str]] = []
        for a, cid in aggs:
            if a.distinct:
                outer_aggs.append((ir.BAgg(
                    a.kind, ir.BCol("gd", darg.dtype), False, a.dtype),
                    cid))
            else:
                pcid = f"p{len(inner_aggs)}"
                inner_aggs.append((a, pcid))
                okind = "sum" if a.kind in ("count", "count_star") \
                    else a.kind
                pdtype = (DataType.INT64
                          if a.kind in ("count", "count_star") else a.dtype)
                outer_aggs.append((ir.BAgg(
                    okind, ir.BCol(pcid, pdtype), False, a.dtype), cid))

        inner = self._finish_aggregate(input_node, inner_keys, inner_aggs,
                                       nullable_rels)
        g_cids = {g.cid for g, _ in group_keys if isinstance(g, ir.BCol)}
        if inner.combine == "repartition" and group_keys:
            inner.repart_keys = tuple(range(len(group_keys)))

        outer_keys = [(ir.BCol(cid, g.dtype), cid)
                      for g, cid in group_keys]
        outer = AggregateNode(combine="", input=inner,
                              group_keys=outer_keys, aggs=outer_aggs)
        outer.est_groups = self._estimate_groups(group_keys, input_node)
        if not group_keys:
            outer.combine = "global"
        elif inner.combine == "repartition" or (
                input_node.dist.kind in ("hash", "device")
                and (input_node.dist.cids & g_cids)):
            # either the dedupe shuffle routed by G, or the input was
            # already partitioned on a G column: G-groups device-disjoint
            outer.combine = "local"
        else:
            outer.combine = "repartition"
        outer.dist = (self.device_dist(frozenset())
                      if outer.combine == "repartition" else inner.dist)
        outer.est_rows = inner.est_rows
        outer.out_columns = {}
        for g, cid in group_keys:
            outer.out_columns[cid] = g.dtype
        for a, cid in outer_aggs:
            outer.out_columns[cid] = a.dtype
        return outer

    def _finish_aggregate(self, input_node: PlanNode, group_keys, aggs,
                          nullable_rels) -> AggregateNode:
        """Combine-mode / distribution / estimate annotation shared by
        plain, inner-dedupe, and outer-reaggregation nodes."""
        node = AggregateNode(
            combine="", input=input_node,
            group_keys=group_keys, aggs=aggs)
        node.est_groups = self._estimate_groups(group_keys, input_node)
        self._plan_dense_grid(node, nullable_rels)
        gk_cids = set()
        for g, _ in group_keys:
            if isinstance(g, ir.BCol):
                gk_cids.add(g.cid)
        if not group_keys:
            node.combine = "global"
        elif self.n_devices == 1 and input_node.dist.kind != "replicated":
            # a 1-device mesh already holds every row of every group: the
            # all_to_all combine would be an identity shuffle paying full
            # pack/unpack buffers (same rule as 1-device local joins)
            node.combine = "local"
        elif input_node.dist.kind in ("hash", "device") and \
                (input_node.dist.cids & gk_cids):
            node.combine = "local"  # groups already device-disjoint
        else:
            node.combine = "repartition"
        if node.combine != "repartition":
            node.dist = input_node.dist
        elif len(group_keys) == 1 and gk_cids:
            node.dist = self.device_dist(frozenset(gk_cids))
        else:
            # multi-key shuffles route by the COMPOSITE hash; claiming
            # per-column partitioning would let a stacked consumer
            # falsely align (same rule as repart_both joins)
            node.dist = self.device_dist(frozenset())
        node.est_rows = input_node.est_rows
        node.out_columns = {}
        for g, cid in group_keys:
            node.out_columns[cid] = g.dtype
        for a, cid in aggs:
            node.out_columns[cid] = a.dtype
        return node

    DENSE_GROUP_LIMIT = 8192

    # packed composite sort keys must leave headroom for the invalid-row
    # sentinel and stay clear of int64 edges
    PACK_SLOT_LIMIT = 1 << 62

    def _plan_dense_grid(self, node: AggregateNode,
                         nullable_rels: frozenset = frozenset()) -> None:
        """Annotate the aggregate with dense-slot metadata when every
        group key is a bare column over a known small value range; and
        with `key_ranges` whenever every key's range is known AT ALL —
        the sort-path executor packs those into ONE int64 sort key
        (single-operand argsort) instead of a multi-operand lexsort,
        with stale ranges caught by the dense_oob retry protocol."""
        if not node.group_keys:
            return
        specs = []
        total = 1
        pack_total = 1
        for g, _cid in node.group_keys:
            if not isinstance(g, ir.BCol) or not g.table:
                return
            ext = self.stats.column_extent(g.table, g.column, g.dtype)
            if ext is None or ext[1] <= 0:
                return
            base, extent = ext
            # outer-join null extension can make any column NULL at
            # runtime regardless of its schema nullability
            has_null = (self._column_nullable(g)
                        or g.rel_index in nullable_rels)
            specs.append((int(base), int(extent), has_null))
            total *= extent + (1 if has_null else 0)
            # the packed key always reserves the null slot (runtime null
            # masks may exist even when the planner thinks otherwise)
            pack_total *= extent + 1
        if pack_total <= self.PACK_SLOT_LIMIT:
            node.key_ranges = tuple(specs)
        if total <= self.DENSE_GROUP_LIMIT:
            node.dense_keys = tuple(specs)
            node.dense_total = total
        elif pack_total <= self.PACK_SLOT_LIMIT:
            # past the dense grid's cap: the bucketed grid
            # (ops/groupby.py) radix-partitions the packed slot space
            # into dense tiles.  Structural eligibility (annotated so
            # group_by_kernel can force the path on any backend) needs
            # the slot space materializable and occupied; the AUTO pick
            # is device-gated (bucketed_paths_enabled): on the card the
            # tile sums run in the shared-memory kernel
            from ..ops.groupby import group_bucket_eligible

            if group_bucket_eligible(pack_total,
                                     node.input.est_rows):
                node.bucket_keys = tuple(specs)
                node.bucket_total = pack_total
                node.group_bucketed = bucketed_paths_enabled(self.device)

    def _column_nullable(self, col: ir.BCol) -> bool:
        try:
            meta = self.catalog.table(col.table)
            return meta.schema.column(col.column).nullable
        except Exception:
            return True

    def _estimate_groups(self, group_keys, input_node: PlanNode) -> int:
        """Product of per-key ndv estimates, clipped to input rows
        (0 = some key has no estimate).  Mirrors the role of the
        reference's worker-hash-size estimation in the logical optimizer."""
        if not group_keys:
            return 1
        est = 1
        for g, _cid in group_keys:
            ndv = None
            if isinstance(g, ir.BCol) and g.table:
                ndv = self.stats.column_ndv(g.table, g.column, g.dtype)
            elif isinstance(g, ir.BExtract) and \
                    isinstance(g.operand, ir.BCol) and g.operand.table:
                days = self.stats.column_ndv(g.operand.table,
                                             g.operand.column,
                                             g.operand.dtype)
                if days is not None:
                    ndv = {"year": days // 365, "month": 12,
                           "day": 31}.get(g.part)
                    ndv = max(1, ndv) if ndv is not None else None
            if isinstance(g, ir.BHllBucket):
                ndv = 1 << g.p
                if isinstance(g.operand, ir.BCol) and g.operand.table:
                    arg_ndv = self.stats.column_ndv(
                        g.operand.table, g.operand.column, g.operand.dtype)
                    if arg_ndv:
                        ndv = min(ndv, arg_ndv)
            if isinstance(g, ir.BDDBucket):
                from ..ops.sketches import DD_NKEYS

                ndv = DD_NKEYS
                if isinstance(g.operand, ir.BCol) and g.operand.table:
                    arg_ndv = self.stats.column_ndv(
                        g.operand.table, g.operand.column, g.operand.dtype)
                    if arg_ndv:
                        ndv = min(ndv, arg_ndv)
            if ndv is None or ndv <= 0:
                return 0
            est *= ndv
            if est > input_node.est_rows:
                return input_node.est_rows
        return max(1, est)

    def _plan_window_stage(self, q: BoundQuery, input_node: PlanNode
                           ) -> tuple[PlanNode, BoundQuery]:
        """Extract window functions into a WindowNode; select/order then
        reference its output columns (w0, w1, …)."""
        from dataclasses import replace as dc_replace

        windows: list[tuple[ir.BWindow, str]] = []
        wmap: dict[ir.BWindow, ir.BCol] = {}

        def rewrite(e: ir.BExpr) -> ir.BExpr:
            if isinstance(e, ir.BWindow):
                if e not in wmap:
                    cid = f"w{len(windows)}"
                    windows.append((e, cid))
                    wmap[e] = ir.BCol(cid, e.dtype)
                return wmap[e]
            return _rebuild(e, [rewrite(c) for c in ir.children(e)])

        new_select = [(rewrite(e), n) for e, n in q.select]
        new_order = [(rewrite(e), d, nf) for e, d, nf in q.order_by]
        parts = {w.partition_by for w, _ in windows}
        if len(parts) > 1:
            raise PlanningError(
                "all window functions in one query must share the same "
                "PARTITION BY clause")
        partition_by = next(iter(parts))
        node = WindowNode(input=input_node, functions=windows,
                          partition_by=partition_by)
        p_cids = {p.cid for p in partition_by if isinstance(p, ir.BCol)}
        if partition_by and input_node.dist.kind in ("hash", "device") \
                and (input_node.dist.cids & p_cids):
            node.combine = "local"   # partitions already device-disjoint
        else:
            # all_to_all by partition-key hash (an empty PARTITION BY is
            # one global partition: every row routes to one device)
            node.combine = "repartition"
        if node.combine == "local":
            node.dist = input_node.dist
        elif len(partition_by) == 1 and p_cids:
            node.dist = self.device_dist(frozenset(p_cids))
        else:
            node.dist = self.device_dist(frozenset())
        node.est_rows = input_node.est_rows
        node.out_columns = dict(input_node.out_columns)
        for w, cid in windows:
            node.out_columns[cid] = w.dtype
        return node, dc_replace(q, select=new_select, order_by=new_order)

    def _plan_projection(self, q: BoundQuery, input_node: PlanNode,
                         decode: dict):
        exprs = []
        host_select = []
        col_by_expr: dict[ir.BExpr, ir.BCol] = {}

        def add_output(e: ir.BExpr, cid: str) -> ir.BCol:
            exprs.append((e, cid))
            col = ir.BCol(cid, e.dtype)
            col_by_expr[e] = col
            if isinstance(e, ir.BCol) and e.dtype == DataType.STRING:
                decode[cid] = (e.table, e.column)
            elif isinstance(e, ir.BStrRemap):
                from ..storage.dictionary import EXPR_DICT

                decode[cid] = (EXPR_DICT, e.values)
            return col

        for i, (e, name) in enumerate(q.select):
            host_select.append((add_output(e, f"p{i}"), name))
        # ORDER BY columns not in the select list become hidden device
        # outputs (the sort happens host-side over device results)
        host_order = []
        for e, desc, nf in q.order_by:
            if any(isinstance(n, ir.BAgg) for n in ir.walk(e)):
                raise PlanningError(
                    "aggregates in ORDER BY require a GROUP BY query")
            col = col_by_expr.get(e)
            if col is None:
                col = add_output(e, f"s{len(exprs)}")
            host_order.append((col, desc, nf))
        node = ProjectNode(input=input_node, exprs=exprs)
        node.dist = input_node.dist
        node.est_rows = input_node.est_rows
        node.out_columns = {cid: e.dtype for e, cid in exprs}
        return node, host_select, host_order


_STRATEGY_RANK = {"broadcast": 0, "broadcast_left": 0, "local": 1,
                  "repart_right": 2, "repart_left": 2, "repart_both": 3,
                  "cartesian_broadcast": 4, "cartesian": 5}


def _rebuild(e: ir.BExpr, new_children: list[ir.BExpr]) -> ir.BExpr:
    if not new_children:
        return e
    if isinstance(e, ir.BArith):
        return ir.BArith(e.op, new_children[0], new_children[1], e.dtype)
    if isinstance(e, ir.BCmp):
        return ir.BCmp(e.op, new_children[0], new_children[1])
    if isinstance(e, ir.BBool):
        return ir.BBool(e.op, tuple(new_children))
    if isinstance(e, ir.BIsNull):
        return ir.BIsNull(new_children[0], e.negated)
    if isinstance(e, ir.BInConst):
        return ir.BInConst(new_children[0], e.values, e.negated)
    if isinstance(e, ir.BCast):
        return ir.BCast(new_children[0], e.dtype)
    if isinstance(e, ir.BStrRemap):
        return ir.BStrRemap(new_children[0], e.lut, e.values, e.label)
    if isinstance(e, ir.BMath):
        return ir.BMath(e.op, new_children[0])
    if isinstance(e, ir.BHllBucket):
        return ir.BHllBucket(new_children[0], e.p)
    if isinstance(e, ir.BHllRho):
        return ir.BHllRho(new_children[0], e.p)
    if isinstance(e, ir.BDDBucket):
        return ir.BDDBucket(new_children[0])
    if isinstance(e, ir.BExtract):
        return ir.BExtract(e.part, new_children[0])
    if isinstance(e, ir.BCase):
        n = len(e.whens)
        whens = tuple((new_children[2 * i], new_children[2 * i + 1])
                      for i in range(n))
        else_r = new_children[2 * n] if len(new_children) > 2 * n else None
        return ir.BCase(whens, else_r, e.dtype)
    if isinstance(e, ir.BWindow):
        i = 0 if e.arg is None else 1
        arg = None if e.arg is None else new_children[0]
        np_ = len(e.partition_by)
        part = tuple(new_children[i:i + np_])
        order = tuple((c, d) for c, (_, d) in zip(
            new_children[i + np_:], e.order_by))
        return ir.BWindow(e.kind, arg, part, order, e.dtype)
    raise PlanningError(f"cannot rebuild {type(e).__name__}")


def _hll_estimate_expr() -> ir.BExpr:
    """HyperLogLog cardinality estimate over the level-2 outputs
    (hcnt = non-empty registers, hsum = sum of 2^-rho), as a planner
    expression evaluable on device (top-k) and host (combine).
    alpha·m²/(empty + hsum), linear counting below 2.5m (Flajolet et
    al. 2007); +0.5 then int cast rounds to the nearest count."""
    from ..ops.sketches import HLL_M, hll_alpha

    F = DataType.FLOAT64
    m = float(HLL_M)

    def c(v):
        return ir.BConst(float(v), F)

    def coalesce0(e):
        # over an EMPTY input the level-2 sum (and, defensively, count)
        # is NULL; with both coalesced to 0 the linear-counting branch
        # yields m·ln(m/m) = 0 — matching exact count(distinct) on empty
        return ir.BCase(((ir.BIsNull(e), c(0.0)),), e, F)

    cnt = coalesce0(ir.BCast(ir.BCol("hcnt", DataType.INT64), F))
    s = coalesce0(ir.BCol("hsum", F))
    empty = ir.BArith("-", c(m), cnt, F)
    raw = ir.BArith("/", c(hll_alpha(HLL_M) * m * m),
                    ir.BArith("+", empty, s, F), F)
    # guard the ln argument so the unselected branch stays finite
    safe_empty = ir.BCase(((ir.BCmp(">", empty, c(0.5)), empty),),
                          c(1.0), F)
    linear = ir.BArith("*", c(m),
                       ir.BMath("ln", ir.BArith("/", c(m), safe_empty,
                                                F)), F)
    cond = ir.BBool("AND", (ir.BCmp("<=", raw, c(2.5 * m)),
                            ir.BCmp(">", empty, c(0.5))))
    est = ir.BCase(((cond, linear),), raw, F)
    return ir.BCast(ir.BArith("+", est, c(0.5), F), DataType.INT64)


_STRATEGY_RANK = {"broadcast": 0, "broadcast_left": 0, "local": 1,
                  "repart_right": 2, "repart_left": 2, "repart_both": 3,
                  "cartesian_broadcast": 4, "cartesian": 5}


def _rebuild(e: ir.BExpr, new_children: list[ir.BExpr]) -> ir.BExpr:
    if not new_children:
        return e
    if isinstance(e, ir.BArith):
        return ir.BArith(e.op, new_children[0], new_children[1], e.dtype)
    if isinstance(e, ir.BCmp):
        return ir.BCmp(e.op, new_children[0], new_children[1])
    if isinstance(e, ir.BBool):
        return ir.BBool(e.op, tuple(new_children))
    if isinstance(e, ir.BIsNull):
        return ir.BIsNull(new_children[0], e.negated)
    if isinstance(e, ir.BInConst):
        return ir.BInConst(new_children[0], e.values, e.negated)
    if isinstance(e, ir.BCast):
        return ir.BCast(new_children[0], e.dtype)
    if isinstance(e, ir.BStrRemap):
        return ir.BStrRemap(new_children[0], e.lut, e.values, e.label)
    if isinstance(e, ir.BMath):
        return ir.BMath(e.op, new_children[0])
    if isinstance(e, ir.BHllBucket):
        return ir.BHllBucket(new_children[0], e.p)
    if isinstance(e, ir.BHllRho):
        return ir.BHllRho(new_children[0], e.p)
    if isinstance(e, ir.BDDBucket):
        return ir.BDDBucket(new_children[0])
    if isinstance(e, ir.BExtract):
        return ir.BExtract(e.part, new_children[0])
    if isinstance(e, ir.BCase):
        n = len(e.whens)
        whens = tuple((new_children[2 * i], new_children[2 * i + 1])
                      for i in range(n))
        else_r = new_children[2 * n] if len(new_children) > 2 * n else None
        return ir.BCase(whens, else_r, e.dtype)
    if isinstance(e, ir.BWindow):
        i = 0 if e.arg is None else 1
        arg = None if e.arg is None else new_children[0]
        np_ = len(e.partition_by)
        part = tuple(new_children[i:i + np_])
        order = tuple((c, d) for c, (_, d) in zip(
            new_children[i + np_:], e.order_by))
        return ir.BWindow(e.kind, arg, part, order, e.dtype)
    raise PlanningError(f"cannot rebuild {type(e).__name__}")
