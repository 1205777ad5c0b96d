"""Multi-pass partitioned execution: the Grace-hash move for a too-big
NON-stream side.

Counterpart of citus_tpu/executor/multipass.py.  The
stream pipeline (executor/stream.py) bounds the residency of ONE scan —
the probe side — but a join whose build side alone exceeds device
memory still cannot run.  The classic answer is Grace hash join:
partition the build input, run one pass per partition, merge.  Hash
shards ARE disjoint partitions of the build table, the feed path honors
`pruned_shards`, and the stream path's distributive merge recombines
per-pass partials — so a pass is the ordinary executor run with the
split scan pruned to one shard group:

* pick the LARGEST eligible hash-distributed scan (the split node);
* divide its (unpruned) shards into K balanced groups;
* run the plan K times, each pass with the split scan pruned to one
  group — each pass may itself stream its probe side, so the two
  larger-than-memory mechanisms compose;
* merge: a mergeable aggregate root re-aggregates across passes, plain
  row outputs concatenate.

Eligibility is stricter than streaming: every join between the split
scan and the root must be INNER with keys (disjoint build partitions ⇒
each output row materializes in exactly one pass), aggregates only at
the root and distributive, windows never.

On a mesh each pass's pruned split scan feeds each position only the
shards of the pass's group that the node↔device map gives it, so every
position runs its own slice of the pass.

Multi-pass execution is a rung of the OOM degradation ladder
(Executor.degrade_for_oom): it runs only after eviction, batch shrink
and forced streaming all failed to fit the statement.
"""

from __future__ import annotations

import copy

import numpy as np

from ..catalog import DistributionMethod
from ..planner.plan import (
    AggregateNode,
    JoinNode,
    QueryPlan,
    ScanNode,
    WindowNode,
)
from ..stats import counters as sc
from ..utils.cancellation import check_cancel
from .feed import walk_plan
from .stream import (
    _mergeable_aggregate,
    _path_to,
    _scale_path_estimates,
    _scan_dev_rows,
    _scan_width_bytes,
    merge_parts,
    partial_plan,
    stream_candidates,
)


def _multipass_path(plan: QueryPlan, split_id: int) -> bool:
    """Is pruning the scan `split_id` to disjoint shard groups and
    unioning the per-pass outputs semantics-preserving?"""
    path = _path_to(plan, split_id)
    if path is None:
        return False
    for i, node in enumerate(path[:-1]):
        if isinstance(node, JoinNode):
            if node.join_type != "inner" or not node.left_keys:
                return False
        elif isinstance(node, WindowNode):
            return False
        elif isinstance(node, AggregateNode):
            if i != 0 or not _mergeable_aggregate(node):
                return False
    return True


def _effective_shards(node: ScanNode, catalog) -> list[int]:
    """Shard indices the scan would actually read (its pruning
    applied)."""
    return [s.shard_index for s in catalog.table_shards(node.rel.table)
            if node.pruned_shards is None
            or s.shard_index in node.pruned_shards]


def _scan_bytes(node: ScanNode, catalog, store, compute_dtype) -> int:
    return _scan_dev_rows(node, catalog, store) * \
        _scan_width_bytes(node, catalog, compute_dtype)


def multipass_candidate(plan: QueryPlan, catalog, store, compute_dtype,
                        prefer_not: int | None = None) -> ScanNode | None:
    """The largest hash-distributed scan whose path admits disjoint
    partition passes and that has ≥ 2 shards to split; None when the
    plan has no useful split.

    `prefer_not` (a node id): when the stream pipeline already bounds
    one scan's residency (the forced-stream rung ran before this one),
    splitting that SAME scan buys nothing — the pressure left is the
    other side's feeds and the join buffers sized off them.  Prefer a
    different split when one is eligible; fall back to the largest."""
    best, best_bytes = None, -1
    alt, alt_bytes = None, -1
    for s in walk_plan(plan.root):
        if not isinstance(s, ScanNode):
            continue
        if catalog.table(s.rel.table).method != DistributionMethod.HASH:
            continue
        if len(_effective_shards(s, catalog)) < 2:
            continue
        if not _multipass_path(plan, id(s)):
            continue
        nbytes = _scan_bytes(s, catalog, store, compute_dtype)
        if nbytes > best_bytes:
            best, best_bytes = s, nbytes
        if id(s) != prefer_not and nbytes > alt_bytes:
            alt, alt_bytes = s, nbytes
    return alt if alt is not None else best


def _shard_groups(node: ScanNode, catalog, store, k: int) -> list[list[int]]:
    """Split the scan's effective shards into ≤ k balanced groups
    (greedy largest-first into the lightest group)."""
    table = node.rel.table
    shards = {s.shard_index: s.shard_id for s in catalog.table_shards(table)}
    eff = _effective_shards(node, catalog)
    k = min(k, len(eff))
    sized = sorted(((store.shard_row_count(table, shards[i]), i)
                    for i in eff), reverse=True)
    groups: list[list[int]] = [[] for _ in range(k)]
    loads = [0] * k
    for rows, idx in sized:
        g = loads.index(min(loads))
        groups[g].append(idx)
        loads[g] += rows
    return [g for g in groups if g]


def try_execute_multipass(executor, plan: QueryPlan, raw: bool, k: int):
    """K passes over disjoint shard groups of the split scan; None ⇒ the
    caller proceeds on the stream / resident path."""
    if k <= 1:
        return None
    catalog, store = executor.catalog, executor.store
    compute_dtype = np.dtype(executor.settings.get("compute_dtype"))
    prefer_not = None
    if executor.oom.force_stream:
        # the stream rung already bounds the largest stream-eligible
        # scan — split the OTHER side when one is eligible
        cands = stream_candidates(plan, catalog)
        if cands:
            prefer_not = id(max(cands, key=lambda s: _scan_bytes(
                s, catalog, store, compute_dtype)))
    split = multipass_candidate(plan, catalog, store, compute_dtype,
                                prefer_not=prefer_not)
    if split is None:
        return None
    groups = _shard_groups(split, catalog, store, k)
    if len(groups) < 2:
        return None
    split_widx = next(i for i, n in enumerate(walk_plan(plan.root))
                      if n is split)
    n_eff = sum(len(g) for g in groups)
    # each pass runs without a device top-k that could cut a partial
    # aggregate (stream.partial_plan); the host combine keeps `plan`
    pass_plan = partial_plan(plan)

    parts: list = []
    rows_scanned = retries_total = batches_total = 0
    for group in groups:
        # pass boundaries are cancellation seams, like stream batches
        check_cancel()
        p = copy.deepcopy(pass_plan)
        node = next(n for i, n in enumerate(walk_plan(p.root))
                    if i == split_widx)
        node.pruned_shards = sorted(group)
        # downstream buffers size per pass, not per table
        _scale_path_estimates(p, id(node), len(group) / max(1, n_eff))
        pass_parts, scanned, retries, batches = \
            executor.execute_pass(p, id(node))
        parts.extend(pass_parts)
        rows_scanned += scanned
        retries_total += retries
        batches_total += batches
    if executor.counters is not None:
        executor.counters.increment(sc.SPILL_PASSES_TOTAL, len(groups))

    cols, nulls, n = merge_parts(plan, parts)
    result = executor._host_combine(plan, cols, nulls, None, raw,
                                    device_rows=[n])
    result.retries = retries_total
    result.device_rows_scanned = rows_scanned
    result.streamed_batches = batches_total
    result.spill_passes = len(groups)
    return result


def ladder_degradable(plan: QueryPlan, catalog, store,
                      compute_dtype) -> bool:
    """Can ANY rung of the degradation ladder reduce this plan's device
    footprint?  Windows and keyless (cartesian) joins anywhere in the
    tree are the ineligible shapes — for those the
    max_plan_buffer_bytes guard keeps its clean immediate reject."""
    for n in walk_plan(plan.root):
        if isinstance(n, WindowNode):
            return False
        if isinstance(n, JoinNode) and not n.left_keys:
            return False
    if stream_candidates(plan, catalog):
        return True
    return multipass_candidate(plan, catalog, store,
                               compute_dtype) is not None
