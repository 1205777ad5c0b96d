"""Greedy shard rebalancer.

Counterpart of citus_tpu/operations/rebalancer.py (`plan_rebalance`
and `rebalance_table_shards`; the mesh-fitting `rebalance_mesh` and
`drain_device` come with multi-GPU, ROADMAP queue A item 9).  The
reference algorithm's semantics (Citus src/backend/distributed/
operations/shard_rebalancer.c rebalance_table_shards; strategy knobs
from pg_dist_rebalance_strategy — by_disk_size, threshold 10%,
improvement_threshold 50%): repeatedly move a shard group from the
most-utilized node to the least-utilized one while the imbalance
exceeds the threshold and each move improves utilization enough.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..catalog import Catalog
from ..storage import TableStore
from .shard_transfer import move_shard_placement


@dataclass(frozen=True)
class PlacementUpdate:
    """PlacementUpdateEvent analogue."""

    shard_id: int
    source_node: int
    target_node: int
    cost: float


def plan_rebalance(catalog: Catalog, store: TableStore,
                   threshold: float = 0.1,
                   improvement_threshold: float = 0.5,
                   by: str = "disk_size") -> list[PlacementUpdate]:
    """Compute the move list without applying it (GetRebalanceSteps)."""
    nodes = catalog.active_nodes()
    if len(nodes) < 2:
        return []

    def shard_cost(shard_id: int) -> float:
        s = catalog.shards[shard_id]
        if by == "disk_size":
            return float(max(store.shard_size_bytes(s.table_name, shard_id),
                             1))
        return 1.0

    # colocated shards move together
    groups: dict[tuple[int, int], list[int]] = {}
    for s in catalog.shards.values():
        if s.min_value is None:
            continue  # reference tables don't rebalance
        meta = catalog.table(s.table_name)
        groups.setdefault((meta.colocation_id, s.shard_index),
                          []).append(s.shard_id)

    node_util: dict[int, float] = {n.node_id: 0.0 for n in nodes}
    capacity = {n.node_id: n.capacity for n in nodes}
    group_node: dict[tuple[int, int], int] = {}
    group_cost: dict[tuple[int, int], float] = {}
    for key, shard_ids in groups.items():
        cost = sum(shard_cost(sid) for sid in shard_ids)
        node = catalog.active_placement(shard_ids[0]).node_id
        group_node[key] = node
        group_cost[key] = cost
        node_util[node] += cost

    moves: list[PlacementUpdate] = []
    for _ in range(len(groups) * 2):  # bounded
        util = {n: node_util[n] / capacity[n] for n in node_util}
        avg = sum(node_util.values()) / sum(capacity.values())
        if avg == 0:
            break
        hi = max(util, key=lambda n: util[n])
        lo = min(util, key=lambda n: util[n])
        if util[hi] - util[lo] <= threshold * max(avg, 1e-12):
            break
        candidates = [k for k, n in group_node.items() if n == hi]
        if not candidates:
            break
        # smallest group that still helps
        candidates.sort(key=lambda k: group_cost[k])
        moved = False
        for key in candidates:
            cost = group_cost[key]
            new_hi = (node_util[hi] - cost) / capacity[hi]
            new_lo = (node_util[lo] + cost) / capacity[lo]
            # improvement gate: the move must shrink the peak, by at
            # least `improvement_threshold` of the peak's distance to
            # the mean
            gain = util[hi] - max(new_hi, new_lo)
            if gain > 0 and gain >= improvement_threshold * (util[hi] - avg):
                moves.append(PlacementUpdate(min(groups[key]), hi, lo,
                                             cost))
                node_util[hi] -= cost
                node_util[lo] += cost
                group_node[key] = lo
                moved = True
                break
        if not moved:
            break
    return moves


def rebalance_table_shards(catalog: Catalog, store: TableStore,
                           threshold: float = 0.1,
                           improvement_threshold: float = 0.5,
                           progress=None) -> list[PlacementUpdate]:
    """Plan + apply (rebalance_table_shards UDF).  `progress` is an
    optional stats.ProgressRegistry (get_rebalance_progress)."""
    moves = plan_rebalance(catalog, store, threshold, improvement_threshold)
    mon = (progress.create("rebalance", "all", len(moves))
           if progress is not None and moves else None)
    try:
        for mv in moves:
            move_shard_placement(catalog, store, mv.shard_id,
                                 catalog.nodes[mv.target_node].name)
            if mon is not None:
                mon.advance(1, f"moved shard {mv.shard_id}")
    except Exception:
        if mon is not None:
            mon.detail = "failed"
            mon.finished = True
        raise
    if mon is not None:
        mon.finish()
    return moves
