"""Shard placement moves and placement repair.

Counterpart of citus_tpu/operations/shard_transfer.py.  The reference
moves shard groups between workers with logical replication + catch-up
+ a metadata flip (Citus src/backend/distributed/operations/
shard_transfer.c, citus_move_shard_placement).  Tables here are
immutable stripe sets in one host store, so a move is a catalog flip:
the old placement turns `to_delete` (deferred cleanup) and a new one
becomes active on the target node; the stripe files stay in place.
"""

from __future__ import annotations

from ..catalog import Catalog, ShardPlacement
from ..errors import CatalogError
from ..storage import TableStore, integrity
from ..utils import io as dio
from ..utils.faultinjection import fault_point


def move_placement(catalog: Catalog, store: TableStore,
                   placement_id: int, target_node_name: str) -> bool:
    """Move ONE specific placement to another node.  Unlike
    move_shard_placement — which moves whichever replica is the
    shard's primary — this retires exactly the given copy (a node
    drain must bury the leaving node's replica).  Returns True when a
    move happened."""
    target = catalog.node_by_name(target_node_name)
    with catalog._lock:
        # same seam contract as move_shard_placement: a death before
        # the flip leaves the old placement active
        fault_point("operations.shard_move")
        p = catalog.placements.get(placement_id)
        if p is None:
            raise CatalogError(
                f"placement {placement_id} does not exist")
        if p.node_id == target.node_id or p.shard_state != "active":
            return False
        p.shard_state = "to_delete"
        pid = catalog.allocate_placement_id()
        catalog.placements[pid] = ShardPlacement(pid, p.shard_id,
                                                 target.node_id)
        catalog._bump()
        return True


def move_shard_placement(catalog: Catalog, store: TableStore,
                         shard_id: int, target_node_name: str,
                         colocated: bool = True) -> list[int]:
    """Move a shard (and its colocated siblings) to another node.
    Returns the shard ids moved."""
    if shard_id not in catalog.shards:
        raise CatalogError(f"shard {shard_id} does not exist")
    target = catalog.node_by_name(target_node_name)
    shard = catalog.shards[shard_id]
    to_move = [shard]
    if colocated and shard.min_value is not None:
        for other_name in catalog.colocated_tables(shard.table_name):
            if other_name == shard.table_name:
                continue
            to_move.append(
                catalog.table_shards(other_name)[shard.shard_index])
    moved = []
    with catalog._lock:  # a background rebalance runs moves off-thread
        # named seam: a move that dies before the placement flip must
        # leave the old placement active (the flip below is atomic
        # under the catalog lock — nothing is half-moved)
        fault_point("operations.shard_move")
        for s in to_move:
            placement = catalog.active_placement(s.shard_id)
            if placement.node_id == target.node_id:
                continue
            # deferred cleanup: the old placement lingers as to_delete
            placement.shard_state = "to_delete"
            pid = catalog.allocate_placement_id()
            catalog.placements[pid] = ShardPlacement(
                pid, s.shard_id, target.node_id)
            moved.append(s.shard_id)
        catalog._bump()
    return moved


def repair_shard_placement(catalog: Catalog, placement,
                           source_path: str, dest_path: str) -> None:
    """Re-replicate one damaged physical copy: rewrite `dest_path` from
    the verified `source_path` (atomic + durable), verify the rewrite,
    then restore the placement to `active` and clear its suspect mark —
    the data plane of the scrubber's self-healing (immutable stripes
    make it one file copy)."""
    dio.copy_file_durable(source_path, dest_path)
    integrity.verify_stripe_file(dest_path)
    if placement is not None:
        if placement.shard_state == "quarantined":
            catalog.set_placement_state(placement.placement_id, "active")
        catalog.clear_placement_suspect(placement.placement_id)
