"""Greedy shard rebalancer.

Counterpart of citus_tpu/operations/rebalancer.py: `plan_rebalance`,
`rebalance_table_shards`, and the mesh fitting (`rebalance_mesh` grows or
shrinks the node set to the mesh width, `drain_device` empties one mesh
position).  On one card a move flips the catalog and copies no device
memory: the stripes stay on disk, and the next plan's feeds route
through the new node↔device map.  The reference algorithm's semantics (Citus src/backend/distributed/
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


def rebalance_mesh(catalog: Catalog, store: TableStore, n_devices: int,
                   threshold: float = 0.1, progress=None):
    """Fit the node set to the mesh width, both directions
    (citus_rebalance_mesh() UDF surface).

    *Grow* (1→N scale-out without reloading): add catalog nodes until
    one exists per mesh position, then spread shard placements over them
    with the ordinary greedy rebalancer.  A data_dir created on a
    1-device mesh holds every shard on one node; reopened with
    n_devices=8 the node↔device map (catalog.node_device_map) still
    folds everything onto device 0 — feeds pad every device to the hot
    device's row count and 7 devices chew zeros.  Growing the node set
    and moving placements (the existing shard_transfer machinery —
    stripe files stay in place, only the catalog flips) spreads the
    map, so the same data serves from N devices with per-device feed
    bytes ≈ 1/N.

    *Shrink* (N→M elastic scale-in): more active nodes than mesh
    devices used to be a SILENT no-op — the old node loop only added
    (`while len(active) < n`), so placements stayed spread over nodes
    the narrower mesh folds several-per-device, and nothing migrated
    or errored.  Now the surplus nodes (highest node_id first — the
    youngest mesh slots leave) are drained: every active placement
    migrates onto a kept node that doesn't already hold a copy of the
    shard (surplus replicas beyond the kept-node count are dropped,
    the Citus rule when the cluster shrinks below the replication
    factor), reference-table replicas on leaving nodes are dropped
    (every kept node holds one), and the emptied nodes are removed.

    Returns (nodes_added, moves) — shrink drains count as moves."""
    added = []
    with catalog._lock:
        existing = {n.name for n in catalog.nodes.values()}
        i = 0
        while len(catalog.active_nodes()) < max(1, n_devices):
            name = f"device:{i}"
            i += 1
            if name in existing:
                continue
            added.append(catalog.add_node(name))
    shrink_moves = _shrink_to(catalog, store, max(1, n_devices))
    # grow-rebalance runs with improvement_threshold=0: that gate
    # compares each move's gain against the peak's distance to the
    # post-growth mean, and with N-1 freshly-empty nodes the FIRST move
    # off the hot node can never clear 50% of that distance (1 group of
    # K shrinks the peak by 1/K) — the steady-state damping rule would
    # leave a grown mesh permanently unbalanced.  The imbalance
    # `threshold` still applies, so an already-spread cluster moves
    # nothing.
    moves = rebalance_table_shards(catalog, store, threshold,
                                   improvement_threshold=0.0,
                                   progress=progress)
    return added, shrink_moves + moves


def _shrink_to(catalog: Catalog, store: TableStore,
               n_keep: int) -> list[PlacementUpdate]:
    """Drain and remove active nodes beyond the first `n_keep`
    (node_id order).  Returns synthetic PlacementUpdate records for the
    migrations so callers count shrink work like rebalance moves."""
    active = catalog.active_nodes()
    if len(active) <= n_keep:
        return []
    keep, leave = active[:n_keep], active[n_keep:]
    moves: list[PlacementUpdate] = []
    for node in leave:
        moves.extend(_drain_node(catalog, store, node, keep))
        catalog.remove_node(node.name)
    return moves


def _drain_node(catalog: Catalog, store: TableStore, node,
                targets) -> list[PlacementUpdate]:
    """Migrate every active placement off `node` onto `targets`
    (least-utilized first, skipping nodes that already hold a copy of
    the shard — a node never hosts two replicas of one shard).  A
    placement whose shard already has a copy on EVERY target is a
    surplus replica: it is dropped (to_delete, the deferred-cleanup
    state) instead of moved.  Reference-table placements drop too —
    every kept node already carries one."""
    from .shard_transfer import move_placement

    util = {t.node_id: sum(
        store.shard_size_bytes(catalog.shards[p.shard_id].table_name,
                               p.shard_id)
        for p in catalog.placements.values()
        if p.node_id == t.node_id and p.shard_state == "active")
        for t in targets}
    by_name = {t.node_id: t.name for t in targets}
    moves: list[PlacementUpdate] = []
    from ..catalog import DistributionMethod

    for p in sorted(catalog.placements.values(),
                    key=lambda p: p.placement_id):
        if p.node_id != node.node_id or p.shard_state != "active":
            continue
        shard = catalog.shards[p.shard_id]
        meta = catalog.tables.get(shard.table_name)
        if meta is not None and \
                meta.method == DistributionMethod.REFERENCE:
            # reference tables: a replica exists on every kept node —
            # drop this copy rather than move it.  LOCAL tables look
            # identical shard-wise (single shard, min_value None) but
            # hold their ONLY placement here — they fall through to
            # the migrate path below like distributed shards (dropping
            # it stranded the table permanently unreadable)
            catalog.set_placement_state(p.placement_id, "to_delete")
            continue
        holders = {q.node_id
                   for q in catalog.shard_placements(p.shard_id)}
        cands = [t for t in targets if t.node_id not in holders]
        if not cands:
            # surplus replica: every kept node already holds a copy
            catalog.set_placement_state(p.placement_id, "to_delete")
            continue
        target = min(cands, key=lambda t: util[t.node_id])
        size = store.shard_size_bytes(shard.table_name, p.shard_id)
        # placement-targeted (not move_shard_placement, which moves
        # the PRIMARY): the drain must bury THIS node's copy, and it
        # visits every placement on the node itself so colocated
        # siblings need no grouped move
        move_placement(catalog, store, p.placement_id,
                       by_name[target.node_id])
        util[target.node_id] += size
        moves.append(PlacementUpdate(p.shard_id, node.node_id,
                                     target.node_id, float(size)))
    return moves


def drain_device(session, device_index: int) -> tuple[int, int]:
    """citus_drain_device(i) implementation: migrate every placement
    off the nodes the node↔device map currently assigns to mesh position
    `device_index`, then take those nodes out of rotation
    (is_active=False — the persisted operator fact, unlike the
    in-memory device-loss marks).  The device keeps its mesh slot but
    feeds zero rows from the next plan on; per-position WLM and memory budgets
    follow automatically because estimates and charges both ride the
    placement map.  Returns (placements_moved, nodes_drained)."""
    from ..errors import CatalogError

    catalog, store = session.catalog, session.store
    n_dev = session.n_devices
    if not 0 <= device_index < n_dev:
        raise CatalogError(
            f"device index {device_index} outside the mesh "
            f"(0..{n_dev - 1})")
    dmap = catalog.node_device_map(n_dev)
    leaving = [catalog.nodes[nid] for nid, pos in dmap.items()
               if pos == device_index]
    targets = [catalog.nodes[nid] for nid, pos in dmap.items()
               if pos != device_index]
    if not targets:
        raise CatalogError(
            "cannot drain the only device hosting nodes — grow the "
            "mesh or add nodes first")
    from ..distributed.mesh import mesh_device_ids

    dev_ids = mesh_device_ids(session.mesh)
    if device_index < len(dev_ids):
        catalog.set_device_state(dev_ids[device_index], "draining")
    moved = 0
    for node in leaving:
        moved += len(_drain_node(catalog, store, node, targets))
        catalog.disable_node(node.name)
    # park the position so the node↔device fold cannot re-occupy it
    # (without the park, the surviving nodes would simply repack onto
    # this slot and the "drained" device would keep feeding rows)
    catalog.park_device(device_index)
    if device_index < len(dev_ids):
        # drained: out of rotation until the operator re-activates the
        # nodes (citus_activate_node clears the health marks too)
        catalog.set_device_state(dev_ids[device_index], "dead")
    return moved, len(leaving)


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
