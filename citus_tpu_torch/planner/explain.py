"""EXPLAIN output: render the distributed plan tree.

Counterpart of citus_tpu/planner/explain.py: on the same plan and
settings the port renders the JAX package's lines.  The
analogue of the reference's distributed EXPLAIN (planner/
multi_explain.c:215 RemoteExplain) — but there are no remote per-task
plans to fetch: the strategy annotations ARE the execution plan.
EXPLAIN ANALYZE's run lines (Session._explain_analyze) register their
tags here too.
"""

from __future__ import annotations

from ..catalog import Catalog
from .plan import (
    AggregateNode,
    JoinNode,
    PlanNode,
    ProjectNode,
    QueryPlan,
    ScanNode,
    WindowNode,
)

_JOIN_LABEL = {
    "local": "Colocated Join",
    "broadcast": "Broadcast Join",
    "repart_right": "Repartition Join (single: right)",
    "repart_left": "Repartition Join (single: left)",
    "repart_both": "Repartition Join (dual all_to_all)",
    "cartesian_gather": "Cartesian Product (all_gather build)",
}

# EXPLAIN tag registry: every strategy tag a plan renders in this port.
# Render sites call explain_tag("…") instead of inlining the literal
# (tests grep these strings — a silently renamed tag is a silently
# broken assertion).
EXPLAIN_TAGS: dict[str, str] = {
    "Fast Path Router": "single-shard host execution, device skipped",
    "point index lookup": "scan answered by the persistent PK index",
    "dense directory": "join build side is a dense key directory",
    "fused lookup": "PK-lookup join fused into the probe gather",
    "bucketed probe": "tile-resident bucketed probe path",
    "bucketed group-by": "dense-grid bucketed aggregation path",
    "Chunks Skipped": "chunk groups pruned by min/max skip nodes",
    "pipelined scan":
        "feed built by the prefetch/decode/transfer pipeline "
        "(executor/scanpipe.py; scan_pipeline=host|device)",
    "Streamed Execution": "scan ran via the batched stream pipeline",
    "Device Rows Scanned": "result-transfer volume in row slots",
    "Mesh": "device count, rows in/out, all_to_all bytes for this "
            "statement",
    "Timing": "per-phase wall-clock breakdown from this statement's "
              "span trace (stats/tracing.py)",
    "Integrity": "stripes CRC-verified / read-repaired this statement",
    "Memory": "device-memory ledger + OOM degradation for this statement",
    "Resilience": "retry/failover totals for this statement",
    "Caches": "plan/feed cache traffic for this statement",
    "Workload": "admission-gate trip for this statement",
    "Serving": "micro-batch / result-cache trip for this statement",
    "Replication": "replica role, applied lsn and visible staleness "
                   "(followers) or follower fleet state (leaders)",
}


def explain_tag(name: str) -> str:
    """Return the tag verbatim; KeyError on an unregistered tag."""
    EXPLAIN_TAGS[name]
    return name


def format_plan(plan: QueryPlan, catalog: Catalog,
                settings=None, device="cpu") -> list[str]:
    """`device` is the session's: the pipelined-scan line names the mode
    scan_pipeline resolves to there."""
    lines = [f"Distributed Query  (devices: {plan.n_devices})"]
    if plan.host_order_by or plan.limit is not None or plan.host_having:
        combine = ["Host Combine:"]
        if plan.host_having is not None:
            combine.append(f"having {plan.host_having}")
        if plan.host_order_by:
            keys = ", ".join(f"{e}{' DESC' if d else ''}"
                             for e, d, _ in plan.host_order_by)
            combine.append(f"order by {keys}")
        if plan.limit is not None:
            combine.append(f"limit {plan.limit}")
        lines.append("  " + "  ".join(combine))
    if plan.device_topk is not None:
        lines.append(f"  Device TopK: {plan.device_topk} rows/device")
    from ..executor.compiler import collect_device_params

    n_params = len(collect_device_params(plan))
    if n_params:
        lines.append(f"  Generic Plan: {n_params} parameter(s) as "
                     "program inputs")
    from ..executor.fastpath import fast_path_shape

    enabled = (settings is None
               or settings.get("enable_fast_path_router"))
    fast = enabled and fast_path_shape(plan, catalog)
    if fast:
        lines.append(f"  {explain_tag('Fast Path Router')}: "
                     "single-shard host execution "
                     "(below fast_path_max_rows)")
    elif settings is not None:
        from ..executor.feed import walk_plan
        from ..executor.scanpipe import resolve_scan_mode

        mode = resolve_scan_mode(settings, device)
        if mode != "off" and any(isinstance(n, ScanNode)
                                 for n in walk_plan(plan.root)):
            # plan-level: feeds build through the prefetch/decode/
            # transfer pipeline.  Tiny scans (under the 'auto' row
            # floor) and overlay-touching tables still read eagerly —
            # a per-feed decision this shape-level line cannot see.
            lines.append(f"  {explain_tag('pipelined scan')}: {mode}")
    _format_node(plan.root, lines, 1, catalog, settings)
    return lines


def _point_index_eligible(node: ScanNode, catalog, settings) -> bool:
    """The runtime's own structural matcher (no store/overlay state —
    EXPLAIN shows the plan's shape, not this instant's transaction)."""
    from ..executor.fastpath import point_lookup_const

    return point_lookup_const(node, catalog, settings) is not None


def _format_node(node: PlanNode, lines: list[str], depth: int,
                 catalog=None, settings=None) -> None:
    pad = "  " * depth
    if isinstance(node, ScanNode):
        extra = ""
        if node.pruned_shards is not None:
            extra = f"  (shards pruned to {node.pruned_shards})"
        if catalog is not None and \
                _point_index_eligible(node, catalog, settings):
            extra += f"  ({explain_tag('point index lookup')})"
        lines.append(f"{pad}-> Columnar Scan on {node.rel.table} "
                     f"[{node.dist.kind}]{extra}")
        if node.filter is not None:
            lines.append(f"{pad}     Filter: {node.filter}")
        return
    if isinstance(node, ProjectNode):
        exprs = ", ".join(f"{e} AS {cid}" for e, cid in node.exprs)
        lines.append(f"{pad}-> Project [{exprs}]")
        _format_node(node.input, lines, depth + 1, catalog,
                     settings)
        return
    if isinstance(node, JoinNode):
        label = _JOIN_LABEL.get(node.strategy, node.strategy)
        if node.join_type in ("semi", "anti"):
            kind = "Semi" if node.join_type == "semi" else "Anti"
            label = f"{kind} {label}"
            if node.flag_combine:
                label += " (psum flags)"
        elif node.join_type != "inner":
            label = f"{node.join_type.capitalize()} Outer {label}"
        conds = ", ".join(f"{l} = {r}" for l, r in
                          zip(node.left_keys, node.right_keys))
        from ..ops.join import dense_directory_ok

        build = node.left if node.build_side == "left" else node.right
        ext = (node.left_key_extents if node.build_side == "left"
               else node.right_key_extents)
        # same predicate the executor applies (est_rows stands in for the
        # padded build capacity)
        dense = (bool(ext) and ext[0] is not None
                 and len(node.left_keys) == 1
                 and dense_directory_ok(ext[0][1], build.est_rows))
        bucketed = dense and node.fuse_lookup and node.probe_bucketed
        mods = [f"build: {node.build_side}"]
        if dense:
            mods.append(explain_tag("dense directory"))
        if node.fuse_lookup:
            mods.append(explain_tag("fused lookup"))
        if bucketed:
            mods.append(explain_tag("bucketed probe"))
        lines.append(f"{pad}-> {label} on ({conds})  "
                     f"[{', '.join(mods)}]")
        if node.residual is not None:
            lines.append(f"{pad}     Residual: {node.residual}")
        _format_node(node.left, lines, depth + 1, catalog,
                     settings)
        _format_node(node.right, lines, depth + 1, catalog,
                     settings)
        return
    if isinstance(node, WindowNode):
        combine = {"local": "device-local partitions",
                   "repartition": "all_to_all partitions"}[node.combine]
        fns = ", ".join(str(w) for w, _ in node.functions)
        lines.append(f"{pad}-> WindowAgg [{combine}] {fns}")
        _format_node(node.input, lines, depth + 1, catalog,
                     settings)
        return
    if isinstance(node, AggregateNode):
        combine = {"local": "device-local groups",
                   "global": "psum combine",
                   "repartition": "all_to_all combine"}[node.combine]
        keys = ", ".join(str(g) for g, _ in node.group_keys) or "()"
        aggs = ", ".join(str(a) for a, _ in node.aggs)
        # same predicate the executor applies (agg_bucket_shape)
        from ..executor.compiler import PlanCompiler

        extra = (", " + explain_tag("bucketed group-by")
                 if PlanCompiler.agg_bucket_shape(node, False)
                 else "")
        lines.append(f"{pad}-> GroupAggregate [{combine}{extra}] "
                     f"keys: {keys}  aggs: {aggs}")
        _format_node(node.input, lines, depth + 1, catalog,
                     settings)
        return
    lines.append(f"{pad}-> {type(node).__name__}")
