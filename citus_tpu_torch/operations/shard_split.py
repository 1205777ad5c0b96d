"""Shard split and tenant isolation.

Counterpart of citus_tpu/operations/shard_split.py: the same child
shard ids, ranges, placements and row sets on the same data_dir.  The
reference splits a shard by standing up child shards, streaming rows
through logical replication and flipping metadata under a write block
(Citus src/backend/distributed/operations/shard_split.c; isolate_shards.c
for tenant isolation).  With immutable columnar stripes it collapses to
re-hash-and-rewrite:

1. register child dirs (on_failure) and parent dirs (deferred) in the
   cleanup registry — a crash at any point leaves only registry records;
2. for EVERY table in the colocation group (split points apply to the
   whole group, keeping colocated joins aligned): read the parent
   shard's live rows, route them to child ranges by hash token, write
   child stripes (format v2 with CRCs, through the table's shared
   dictionary), and copy them to each replica placement's dir so the
   children keep the parent's replication factor physically too;
3. ONE catalog save is the commit point: parents out, children in,
   shard indexes renumbered by token order, the colocation group's
   shard_count updated;
4. the cleanup sweep (inline, the maintenance daemon, the next open)
   removes the parent dirs and manifest entries.

The children's `PKIDX_*.npz` point-index sidecars are not written
here: the first point lookup on a child builds its own.
"""

from __future__ import annotations

import os

import numpy as np

from ..catalog.catalog import Catalog, ShardPlacement
from ..catalog.distribution import (
    ShardInterval,
    hash_token,
    shard_index_for_token_ranges,
)
from ..errors import CatalogError
from ..storage.dictionary import string_hash_token
from ..transaction.clock import global_clock
from ..transaction.locks import lock_manager_for
from ..types import DataType
from ..utils import io as dio
from ..utils.faultinjection import fault_point
from .cleanup import DEFERRED, ON_FAILURE, cleanup_registry_for


def split_shard_by_split_points(session, shard_id: int,
                                split_points: list[int]) -> list[int]:
    """Split `shard_id`'s token range after each point in split_points.
    Returns the new shard ids for the named shard's table.  Applies to
    every colocated table (citus_split_shard_by_split_points
    semantics)."""
    catalog = session.catalog
    store = session.store
    shard = catalog.shards.get(shard_id)
    if shard is None:
        raise CatalogError(f"shard {shard_id} does not exist")
    if shard.min_value is None:
        raise CatalogError("cannot split a reference/local table shard")
    points = sorted(set(int(p) for p in split_points))
    for p in points:
        if not (shard.min_value <= p < shard.max_value):
            raise CatalogError(
                f"split point {p} outside shard range "
                f"[{shard.min_value}, {shard.max_value})")
    if not points:
        raise CatalogError("no valid split points")

    # child ranges: [min..p1], [p1+1..p2], ..., [pk+1..max]
    los = [shard.min_value] + [p + 1 for p in points]
    his = points + [shard.max_value]

    meta = catalog.table(shard.table_name)
    group_tables = catalog.colocated_tables(shard.table_name)
    registry = cleanup_registry_for(session.data_dir)
    op = registry.start_operation()

    # plan child ids per (table, child range) and register everything
    # BEFORE writing any data
    plan: dict[str, dict] = {}
    for t in group_tables:
        parent = next(s for s in catalog.table_shards(t)
                      if s.shard_index == shard.shard_index)
        child_ids = [catalog.allocate_shard_id() for _ in los]
        for cid in child_ids:
            registry.register(op, "shard_dir", t, cid, ON_FAILURE)
        registry.register(op, "shard_dir", t, parent.shard_id, DEFERRED)
        plan[t] = {"parent": parent, "children": child_ids,
                   "nodes": _placement_nodes(catalog, parent.shard_id)}

    # block concurrent writers on every parent shard for the duration
    locks = lock_manager_for(session.data_dir)
    lock_txid = global_clock.now()
    # a failure after the in-memory catalog mutated but before the
    # durable save must not let the cleanup sweep think the split
    # committed (it decides success by looking at the catalog)
    with catalog._lock:
        snapshot = catalog.to_json()
    try:
        for t, p in sorted((t, plan[t]["parent"].shard_id)
                           for t in group_tables):
            locks.acquire(lock_txid, (t, p))
        for t in group_tables:
            # adopt rows another session committed before we locked:
            # the rewrite reads the CURRENT manifest, not a cache
            store.refresh(t)
            _rewrite_shard(session, t, plan[t]["parent"],
                           plan[t]["children"], los, plan[t]["nodes"])
        # named seam: every child stripe is written but the catalog
        # commit has not happened — a kill here must leave the parent
        # authoritative and the children invisible (cleanup-swept)
        fault_point("operations.shard_split")
        # --- the commit point: one catalog mutation + save ---
        with catalog._lock:
            for t in group_tables:
                parent = plan[t]["parent"]
                for pid in [p.placement_id
                            for p in catalog.placements.values()
                            if p.shard_id == parent.shard_id]:
                    del catalog.placements[pid]
                del catalog.shards[parent.shard_id]
                # children inherit the parent's FULL placement node list
                # (primary first), so the replication factor survives
                for cid, lo, hi in zip(plan[t]["children"], los, his):
                    catalog.shards[cid] = ShardInterval(
                        cid, t, 0, int(lo), int(hi))
                    for node_id in plan[t]["nodes"]:
                        pid = catalog.allocate_placement_id()
                        catalog.placements[pid] = ShardPlacement(
                            pid, cid, node_id)
                # renumber shard_index by token order
                for i, s in enumerate(sorted(
                        (s for s in catalog.shards.values()
                         if s.table_name == t),
                        key=lambda s: s.min_value)):
                    catalog.shards[s.shard_id] = ShardInterval(
                        s.shard_id, t, i, s.min_value, s.max_value)
            group = catalog.colocation_groups[meta.colocation_id]
            group.shard_count += len(points)
            catalog._bump()
        session._save_catalog()
    except Exception:
        _restore_catalog(catalog, snapshot)
        registry.finish_operation(op)
        registry.sweep(store, catalog)  # children lose: no catalog entry
        raise
    finally:
        locks.release_all(lock_txid)
    registry.finish_operation(op)
    registry.sweep(store, catalog)      # parents lose: superseded
    return plan[shard.table_name]["children"]


def _placement_nodes(catalog: Catalog, shard_id: int) -> list[int]:
    """The shard's placement nodes, the routing primary first."""
    with catalog._lock:
        primary = catalog.active_placement(shard_id)
        return [primary.node_id] + [
            p.node_id for p in catalog.shard_placements(shard_id)
            if p.placement_id != primary.placement_id]


def _restore_catalog(catalog: Catalog, snapshot: dict) -> None:
    """Roll the in-memory catalog back to a pre-mutation snapshot (the
    persisted catalog was never updated, so this re-aligns memory with
    disk before the failure sweep consults it)."""
    restored = Catalog.from_json(snapshot)
    with catalog._lock:
        catalog.tables = restored.tables
        catalog.shards = restored.shards
        catalog.placements = restored.placements
        catalog.nodes = restored.nodes
        catalog.colocation_groups = restored.colocation_groups
        catalog.version = restored.version
        catalog._bump()  # invalidates cached plans and the placement index
        catalog._next_shard_id = max(catalog._next_shard_id,
                                     restored._next_shard_id)
        catalog._next_placement_id = max(catalog._next_placement_id,
                                         restored._next_placement_id)


def _rewrite_shard(session, table: str, parent: ShardInterval,
                   child_ids: list[int], los: list[int],
                   nodes: list[int]) -> None:
    """Route the parent shard's live rows into child shards by token,
    and mirror each child stripe to the replica nodes' dirs."""
    meta = session.catalog.table(table)
    store = session.store
    vals, valid, n = store.read_shard(table, parent.shard_id)
    if n == 0:
        return
    dist_col = meta.distribution_column
    if meta.schema.column(dist_col).dtype == DataType.STRING:
        tokens = store.dictionary(table, dist_col).hash_tokens()[
            vals[dist_col]]
    else:
        tokens = hash_token(vals[dist_col])
    child_idx = shard_index_for_token_ranges(
        tokens, np.asarray(los, dtype=np.int64))
    settings = session.settings
    # physical re-placement, not a logical change: the change feed must
    # not see split rewrites
    with store.change_log.suppress():
        for i, cid in enumerate(child_ids):
            mask = child_idx == i
            if not mask.any():
                continue
            rec = store.append_stripe(
                table, cid, {c: vals[c][mask] for c in vals},
                {c: valid[c][mask] for c in valid},
                codec=settings.get("columnar_compression"),
                level=settings.get("columnar_compression_level"),
                chunk_rows=settings.get("columnar_chunk_group_row_limit"))
            src = os.path.join(store.shard_dir(table, cid), rec["file"])
            for node_id in nodes[1:]:
                d = store.replica_dir(table, cid, node_id)
                os.makedirs(d, exist_ok=True)
                dio.copy_file_durable(src, os.path.join(d, rec["file"]))


def isolate_tenant_to_node(session, table: str, tenant_value) -> int:
    """Give one tenant (distribution-column value) its own shard: split
    the containing shard at [token-1, token].  Returns the tenant's new
    shard id."""
    catalog = session.catalog
    meta = catalog.table(table)
    dist_col = meta.distribution_column
    if dist_col is None:
        raise CatalogError(f"table {table!r} is not hash-distributed")
    dt = meta.schema.column(dist_col).dtype
    if dt == DataType.STRING:
        token = string_hash_token(str(tenant_value))
    else:
        token = int(hash_token(np.asarray([tenant_value],
                                          dtype=dt.numpy_dtype))[0])
    shard = next((s for s in catalog.table_shards(table)
                  if s.contains_token(token)), None)
    if shard is None:
        raise CatalogError(f"no shard contains token {token}")
    points = []
    if shard.min_value < token:
        points.append(token - 1)
    if token < shard.max_value:
        points.append(token)
    if not points:
        return shard.shard_id  # already isolated (single-token shard)
    split_shard_by_split_points(session, shard.shard_id, points)
    return next(s for s in catalog.table_shards(table)
                if s.contains_token(token)).shard_id
