"""Cluster health checks + node promotion.

Counterpart of citus_tpu/operations/health.py.  Reference analogues:

* operations/health_check.c — `citus_check_cluster_node_health()` opens
  a connection to every node from every node and reports the NxN
  connectivity matrix.  Single-controller mapping: "connectivity" is
  (a) the device backing a node answering a tiny round trip and (b)
  the shared store answering a directory read — probed from the one
  controller, so the matrix collapses to one row per node.  The device
  leg places a 4-byte tensor on the device of the node's mesh position
  (cuda:0 in a cuda session, the CPU in a CPU one) and reads it back,
  after the MeshSim check of that position: a killed simulated position
  fails the probe exactly like a dead real one, so the maintenance
  daemon's health sweep is a second device-loss detector beside the
  statement retry envelope.
* operations/node_promotion.c — `citus_promote_clone_and_rebalance`
  turns a standby into a primary.  Replica placements already serve
  reads when a node dies (catalog.active_placement failover); promotion
  makes that durable: the dead node's placements demote to `to_delete`
  and each shard's surviving replica becomes the primary.

The maintenance daemon runs `health_sweep` periodically
(`health_check_interval_ms`, off by default): a probe failure only
DISABLES the node (reads fail over at once); promotion stays an
explicit operator action, as the reference splits detection from
promotion.
"""

from __future__ import annotations

import os

from ..errors import CatalogError


def probe_node(session, node) -> bool:
    """One node's health: its device answers (device-backed nodes) and
    the storage it hosts answers a directory read.  Non-device nodes
    (spares, logical replicas) probe storage only."""
    try:
        if node.name.startswith("device:"):
            idx = int(node.name.split(":", 1)[1])
            mesh = session.mesh
            if idx >= mesh.size:
                return False
            import torch

            from ..utils.faultinjection import mesh_device_check

            mesh_device_check("mesh.device_put", (mesh.ids[idx],))
            # a 4-byte round trip, outside the accountant: charging it
            # would make the probe depend on the ledger it may be
            # diagnosing
            out = torch.ones((), dtype=torch.int32,
                             device=mesh.devices[idx])
            if int(out.cpu()) != 1:
                return False
        # storage probe: an actual disk read of a shard directory this
        # node hosts (an in-memory catalog read can never fail)
        probed = False
        for p in session.catalog.placements.values():
            if p.node_id != node.node_id or p.shard_state != "active":
                continue
            shard = session.catalog.shards.get(p.shard_id)
            if shard is None:
                continue
            sdir = session.store.shard_dir(shard.table_name, p.shard_id)
            if os.path.isdir(sdir):  # shard dirs materialize lazily
                os.listdir(sdir)     # raises on unreadable storage
                probed = True
                break
        if not probed:
            # the node hosts no materialized shards (a spare): the store
            # root itself must exist and answer a directory read
            os.listdir(session.store.data_dir)
        return True
    except Exception:  # noqa: BLE001 — any failure is an unhealthy probe
        return False


def check_cluster_health(session) -> list[tuple[str, bool, bool]]:
    """[(node_name, is_active, healthy)] for every catalog node."""
    return [(node.name, node.is_active, probe_node(session, node))
            for node in sorted(session.catalog.nodes.values(),
                               key=lambda n: n.node_id)]


def health_sweep(session) -> list[str]:
    """Disable nodes that fail their probe (reads fail over to replicas
    at the next active_placement call); returns the names disabled.
    Nodes already inactive are left alone — reactivation is an operator
    decision (citus_activate_node)."""
    disabled = []
    for name, is_active, healthy in check_cluster_health(session):
        if is_active and not healthy:
            try:
                session.catalog.disable_node(name)
                disabled.append(name)
            except CatalogError:
                pass  # a safety check (e.g. last placement) vetoes
    if disabled:
        session._save_catalog()
    return disabled


def promote_node_replicas(session, dead_node_name: str) -> int:
    """Durably promote replicas: every shard whose placement on
    `dead_node_name` is active gets that placement demoted to
    `to_delete` — the surviving replica placement becomes the shard's
    primary.  Fails if any shard would lose its last placement.
    Returns the number of placements demoted."""
    catalog = session.catalog
    node = catalog.node_by_name(dead_node_name)
    with catalog._lock:
        doomed = [p for p in catalog.placements.values()
                  if p.node_id == node.node_id
                  and p.shard_state == "active"]
        for p in doomed:
            survivors = [
                q for q in catalog.placements.values()
                if q.shard_id == p.shard_id and q.shard_state == "active"
                and q.node_id != node.node_id
                and (n := catalog.nodes.get(q.node_id)) is not None
                and n.is_active]
            if not survivors:
                raise CatalogError(
                    f"shard {p.shard_id} has no replica outside "
                    f"{dead_node_name!r} — cannot promote (add replicas "
                    "or restore the node)")
        for p in doomed:
            p.shard_state = "to_delete"
        if doomed:
            catalog._bump()
    if doomed:
        session._save_catalog()
    return len(doomed)
