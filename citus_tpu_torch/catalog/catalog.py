"""The distributed catalog: tables, shards, placements, nodes, colocation.

Structural analogue of the reference's metadata layer
(Citus src/backend/distributed/metadata/ and the pg_dist_* catalogs
in src/include/distributed/pg_dist_partition.h:22-32, pg_dist_shard.h,
pg_dist_placement.h, pg_dist_node.h, pg_dist_colocation.h).

Differences driven by the TPU architecture:

* Single-controller JAX replaces "metadata sync to all nodes via 2PC"
  (metadata_sync.c): there is one catalog, owned by the controller process,
  persisted as JSON under the data directory through the transaction layer's
  commit log (atomic rename).  "Query from any node" collapses to ordinary
  in-process access.
* "Nodes" are mesh slots (one per TPU device, or per-core group), not
  host:port pairs; placements map shards to mesh positions.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Iterable

from ..errors import CatalogError
from ..types import DataType, TableSchema
from .distribution import ShardInterval, shard_interval_bounds


class DistributionMethod(enum.Enum):
    """partmethod analogue (pg_dist_partition.h:22-32: h/r/a/n)."""

    HASH = "hash"            # 'h'
    REFERENCE = "reference"  # single shard replicated to every node
    LOCAL = "local"          # controller-only table ('n', citus local)


class ReplicationModel(enum.Enum):
    """repmodel analogue."""

    STATEMENT = "statement"
    TWO_PHASE = "2pc"


@dataclass
class NodeMetadata:
    """pg_dist_node row analogue: one mesh slot."""

    node_id: int
    name: str               # e.g. "tpu:0" or "cpu:3"
    group_id: int
    is_active: bool = True
    capacity: float = 1.0   # rebalancer weight (pg_dist_rebalance_strategy)

    def to_json(self) -> dict:
        return {"node_id": self.node_id, "name": self.name,
                "group_id": self.group_id, "is_active": self.is_active,
                "capacity": self.capacity}

    @staticmethod
    def from_json(o: dict) -> "NodeMetadata":
        return NodeMetadata(o["node_id"], o["name"], o["group_id"],
                            o.get("is_active", True), o.get("capacity", 1.0))


@dataclass
class ShardPlacement:
    """pg_dist_placement row analogue."""

    placement_id: int
    shard_id: int
    node_id: int
    shard_state: str = "active"  # active | to_delete (deferred cleanup)
    size_bytes: int = 0

    def to_json(self) -> dict:
        return {"placement_id": self.placement_id, "shard_id": self.shard_id,
                "node_id": self.node_id, "shard_state": self.shard_state,
                "size_bytes": self.size_bytes}

    @staticmethod
    def from_json(o: dict) -> "ShardPlacement":
        return ShardPlacement(o["placement_id"], o["shard_id"], o["node_id"],
                              o.get("shard_state", "active"), o.get("size_bytes", 0))


@dataclass
class ColocationGroup:
    """pg_dist_colocation row analogue."""

    colocation_id: int
    shard_count: int
    distribution_dtype: DataType | None

    def to_json(self) -> dict:
        return {"colocation_id": self.colocation_id,
                "shard_count": self.shard_count,
                "distribution_dtype":
                    self.distribution_dtype.value if self.distribution_dtype else None}

    @staticmethod
    def from_json(o: dict) -> "ColocationGroup":
        dt = o.get("distribution_dtype")
        return ColocationGroup(o["colocation_id"], o["shard_count"],
                               DataType(dt) if dt else None)


@dataclass
class TableMetadata:
    """pg_dist_partition row + schema (the reference keeps the schema in
    PostgreSQL's own catalogs; we carry it here)."""

    name: str
    schema: TableSchema
    method: DistributionMethod
    distribution_column: str | None
    colocation_id: int
    replication_model: ReplicationModel = ReplicationModel.TWO_PHASE

    def to_json(self) -> dict:
        return {"name": self.name, "schema": self.schema.to_json(),
                "method": self.method.value,
                "distribution_column": self.distribution_column,
                "colocation_id": self.colocation_id,
                "replication_model": self.replication_model.value}

    @staticmethod
    def from_json(o: dict) -> "TableMetadata":
        return TableMetadata(
            o["name"], TableSchema.from_json(o["schema"]),
            DistributionMethod(o["method"]), o.get("distribution_column"),
            o["colocation_id"], ReplicationModel(o.get("replication_model", "2pc")))


# first shard/placement id of the reserved in-memory temp-table range
# (persisted allocations grow from ~102008 and can never reach this)
TEMP_ID_BASE = 1 << 40


class Catalog:
    """In-memory catalog with JSON persistence and a version counter.

    The version counter is the invalidation analogue of the reference's
    metadata cache (metadata/metadata_cache.c:287 InitializeCaches +
    syscache invalidation callbacks): executors cache compiled plans keyed on
    (query, catalog_version) and recompile when metadata changes.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self.tables: dict[str, TableMetadata] = {}
        self.shards: dict[int, ShardInterval] = {}
        self.placements: dict[int, ShardPlacement] = {}
        self.nodes: dict[int, NodeMetadata] = {}
        self.colocation_groups: dict[int, ColocationGroup] = {}
        # name → {"next": int, "increment": int} (pg_dist_object-propagated
        # sequences analogue; single-controller, so no per-node ranges)
        self.sequences: dict[str, dict] = {}
        # name → {"sql": str, "columns": [str]} — view definitions
        # (reference propagates views to workers, commands/view.c:1-832;
        # one controller keeps one persisted definition)
        self.views: dict[str, dict] = {}
        self.version = 0
        self._disk_stat = None  # (mtime_ns, size) of the persisted file
        # shard_id → [ShardPlacement] cache (any state), rebuilt lazily
        # after a _bump: the storage integrity path resolves physical
        # copies through shard_placements several times per stripe read,
        # and a full placements scan per call is O(stripes × placements)
        self._by_shard: dict[int, list[ShardPlacement]] | None = None
        # placements the statement retry loop observed failing a shard
        # read: active_placement prefers non-suspect replicas so the
        # retry lands elsewhere (in-memory, this process only — the
        # adaptive-executor transient-failure mark, not a catalog fact)
        self._suspect_placements: set[int] = set()
        # mesh health ledger (in-memory, this process — the suspect-
        # placement pattern applied to the device dimension): nodes the
        # mesh-degrade path declared dead drop out of active_nodes()
        # and placement routing WITHOUT flipping the persisted
        # is_active flag (a lost device is this session's observation,
        # not an operator's catalog fact); _device_states tracks each
        # jax device id through active → suspect → draining → dead for
        # citus_stat_mesh()
        self._dead_nodes: set[int] = set()
        self._device_states: dict[int, str] = {}
        # mesh positions drained by citus_drain_device(): the
        # node↔device map stops assigning nodes there, so the device
        # keeps its mesh slot but feeds zero rows (without parking,
        # the round-robin fold would simply repack the surviving nodes
        # onto the drained position)
        self._parked_devices: set[int] = set()
        self._next_shard_id = 102008   # reference shard ids start ~102008
        self._next_placement_id = 1
        self._next_node_id = 1
        self._next_colocation_id = 1
        # session-private temp tables (__intermediate_*) allocate shard/
        # placement ids from a reserved high range persisted catalogs can
        # never reach: maybe_reload merges live temps over a fresh disk
        # catalog, and a colliding id would silently clobber another
        # session's committed shard (the ids are in-memory only — temps
        # are never persisted)
        self._next_temp_shard_id = TEMP_ID_BASE
        self._next_temp_placement_id = TEMP_ID_BASE

    # -- mutation helpers --------------------------------------------------
    def _bump(self):
        self.version += 1
        self._by_shard = None

    def _shard_index_locked(self) -> dict[int, list[ShardPlacement]]:
        """shard_id → placements (every state, placement_id-sorted).
        Callers hold self._lock.  Sound because EVERY placement mutation
        — adds, drops, state flips, and the maybe_reload dict swap —
        happens under the lock and ends in _bump()."""
        idx = self._by_shard
        if idx is None:
            idx = {}
            for p in self.placements.values():
                idx.setdefault(p.shard_id, []).append(p)
            for ps in idx.values():
                ps.sort(key=lambda p: p.placement_id)
            self._by_shard = idx
        return idx

    def allocate_shard_id(self) -> int:
        with self._lock:
            sid = self._next_shard_id
            self._next_shard_id += 1
            return sid

    def allocate_placement_id(self) -> int:
        with self._lock:
            pid = self._next_placement_id
            self._next_placement_id += 1
            return pid

    # -- nodes -------------------------------------------------------------
    def add_node(self, name: str, group_id: int | None = None,
                 capacity: float = 1.0) -> NodeMetadata:
        with self._lock:
            for n in self.nodes.values():
                if n.name == name:
                    raise CatalogError(f"node {name!r} already exists")
            node = NodeMetadata(self._next_node_id, name,
                                group_id if group_id is not None else self._next_node_id,
                                True, capacity)
            self.nodes[node.node_id] = node
            self._next_node_id += 1
            # Replicate reference tables to the new node (ref:
            # EnsureReferenceTablesExistOnAllNodes on node activation,
            # utils/reference_table_utils.c). Data movement is the ops
            # layer's job; the catalog records the placement.
            for meta in self.tables.values():
                if meta.method == DistributionMethod.REFERENCE:
                    for s in self.table_shards(meta.name):
                        self.placements[self._next_placement_id] = ShardPlacement(
                            self._next_placement_id, s.shard_id, node.node_id)
                        self._next_placement_id += 1
            self._bump()
            return node

    # -- sequences ---------------------------------------------------------
    def create_sequence(self, name: str, start: int = 1,
                        increment: int = 1) -> None:
        """CREATE SEQUENCE analogue (the reference propagates sequences
        to workers and hands out per-node ranges,
        commands/sequence.c:1-40; one controller needs one counter)."""
        with self._lock:
            if name in self.sequences or name in self.tables or \
                    name in self.views:
                raise CatalogError(f"relation {name!r} already exists")
            if increment == 0:
                raise CatalogError("sequence increment must be nonzero")
            self.sequences[name] = {"next": int(start),
                                    "increment": int(increment),
                                    "last": None}
            self._bump()

    def drop_sequence(self, name: str, if_exists: bool = False) -> None:
        with self._lock:
            if name not in self.sequences:
                if if_exists:
                    return
                raise CatalogError(f"sequence {name!r} does not exist")
            del self.sequences[name]
            self._bump()

    # -- views -------------------------------------------------------------
    def create_view(self, name: str, sql: str,
                    columns: tuple[str, ...] = (),
                    or_replace: bool = False) -> None:
        with self._lock:
            if name in self.tables or name in self.sequences or \
                    (name in self.views and not or_replace):
                raise CatalogError(f"relation {name!r} already exists")
            self.views[name] = {"sql": sql, "columns": list(columns)}
            self._bump()

    def drop_view(self, name: str, if_exists: bool = False) -> None:
        with self._lock:
            if name not in self.views:
                if if_exists:
                    return
                raise CatalogError(f"view {name!r} does not exist")
            del self.views[name]
            self._bump()

    def sequence_nextval(self, name: str,
                         count: int = 1) -> tuple[int, int]:
        """Allocate `count` consecutive values; returns (first,
        increment) — one atomic locked operation so callers never read
        the sequence dict unlocked.  Like PG, allocation is
        non-transactional (gaps on rollback)."""
        with self._lock:
            seq = self.sequences.get(name)
            if seq is None:
                raise CatalogError(f"sequence {name!r} does not exist")
            first = seq["next"]
            inc = seq["increment"]
            seq["next"] = first + inc * count
            seq["last"] = first + inc * (count - 1)
            self._bump()
            return first, inc

    def sequence_currval(self, name: str) -> int:
        with self._lock:
            seq = self.sequences.get(name)
            if seq is None:
                raise CatalogError(f"sequence {name!r} does not exist")
            if seq.get("last") is None:
                # PG parity: currval before any nextval is an error, not
                # a never-allocated value
                raise CatalogError(
                    f"currval of sequence {name!r} is not yet defined")
            return seq["last"]

    def remove_node(self, name: str) -> None:
        with self._lock:
            node = self.node_by_name(name)
            for p in self.placements.values():
                if p.node_id != node.node_id or p.shard_state != "active":
                    continue
                meta = self.tables.get(
                    self.shards[p.shard_id].table_name)
                if meta is not None and \
                        meta.method == DistributionMethod.REFERENCE:
                    # reference replicas exist on every other node.
                    # LOCAL tables share the single-shard shape but
                    # hold their ONLY placement — the survivor check
                    # below must protect them too (the old min_value
                    # exemption silently deleted a local table's data
                    # on node removal)
                    continue
                # removable only if every hosted shard keeps at least one
                # replica on another live node (reference semantics: a
                # node with sole placements must be rebalanced away first)
                survivors = [
                    q for q in self.placements.values()
                    if q.shard_id == p.shard_id
                    and q.placement_id != p.placement_id
                    and q.shard_state == "active"
                    and (n := self.nodes.get(q.node_id)) is not None
                    and n.is_active and q.node_id != node.node_id]
                if not survivors:
                    raise CatalogError(
                        f"cannot remove node {name!r}: it hosts the only "
                        f"active placement of shard {p.shard_id}; "
                        "rebalance or add replicas first")
            # every distributed shard has a surviving replica: drop this
            # node's placements (plus reference-table replicas and
            # to_delete leftovers) so no placement dangles on a dead node
            self.placements = {k: p for k, p in self.placements.items()
                               if p.node_id != node.node_id}
            del self.nodes[node.node_id]
            self._bump()

    def disable_node(self, name: str) -> None:
        """citus_disable_node analogue: mark unreachable; reads fail over
        to replica placements immediately, placements stay recorded."""
        with self._lock:
            node = self.node_by_name(name)
            node.is_active = False
            self._bump()

    def activate_node(self, name: str) -> None:
        """citus_activate_node analogue.  Reactivation also clears the
        node's placements from the retry loop's suspect set — an
        operator bringing a node back is declaring it healthy."""
        with self._lock:
            node = self.node_by_name(name)
            node.is_active = True
            self._dead_nodes.discard(node.node_id)
            # re-activating a node un-parks drained positions too: the
            # operator is declaring the mesh healthy, and a stale park
            # would strand the node's placements off the fold
            self._parked_devices.clear()
            self._bump()
        self.clear_placement_suspects(node.node_id)

    def node_by_name(self, name: str) -> NodeMetadata:
        for n in self.nodes.values():
            if n.name == name:
                return n
        raise CatalogError(f"node {name!r} does not exist")

    def active_nodes(self) -> list[NodeMetadata]:
        return sorted((n for n in self.nodes.values()
                       if n.is_active
                       and n.node_id not in self._dead_nodes),
                      key=lambda n: n.node_id)

    # -- mesh health ledger -------------------------------------------------
    def mark_node_dead(self, node_id: int) -> None:
        """Device-loss observation: the node's device stopped
        answering, so the node drops out of active_nodes(), the
        node↔device map and placement routing — replicated shards fail
        over to their surviving placements exactly as if the node were
        disabled, but nothing is persisted (a reopened process probes a
        healthy mesh again)."""
        with self._lock:
            self._dead_nodes.add(node_id)
            self._bump()

    def dead_nodes(self) -> set[int]:
        with self._lock:
            return set(self._dead_nodes)

    def revive_nodes(self) -> None:
        """Forget every device-loss observation (operator recovery
        declaration; citus_activate_node clears per-node)."""
        with self._lock:
            self._dead_nodes.clear()
            self._device_states.clear()
            self._parked_devices.clear()
            self._bump()

    def set_device_state(self, device_id: int, state: str) -> None:
        """Track a jax device through the health states
        active | suspect | draining | dead (citus_stat_mesh surface;
        'active' clears the entry)."""
        if state not in ("active", "suspect", "draining", "dead"):
            raise CatalogError(f"unknown device state {state!r}")
        with self._lock:
            if state == "active":
                self._device_states.pop(device_id, None)
            else:
                self._device_states[device_id] = state

    def device_states(self) -> dict[int, str]:
        """Non-active device health entries (jax device id → state)."""
        with self._lock:
            return dict(self._device_states)

    def _node_live(self, node_id: int) -> bool:
        n = self.nodes.get(node_id)
        return (n is not None and n.is_active
                and node_id not in self._dead_nodes)

    def node_device_map(self, n_devices: int) -> dict[int, int]:
        """Explicit node_id → mesh-device-index map — THE catalog fact
        feed placement, the planner and the WLM budget estimator all
        route through (planner/plan.py table_placement).

        Active nodes ranked by node_id take devices round-robin, so
        the map survives node removals and late additions without
        aliasing: the old ``(node_id - 1) % n_devices`` fold mapped a
        node added after a removal onto an already-occupied device
        while the removed node's device sat idle.  More active nodes
        than devices still folds (a mesh slot hosts several logical
        nodes — the 1-device test mesh runs every node); fewer leaves
        trailing devices empty until citus_rebalance_mesh() grows the
        node set (operations/rebalancer.py).  Positions parked by
        citus_drain_device() are skipped, so a drained device really
        idles instead of being re-occupied by the fold."""
        with self._lock:
            slots = [i for i in range(max(1, n_devices))
                     if i not in self._parked_devices]
            if not slots:  # every slot parked: parking is advisory
                slots = list(range(max(1, n_devices)))
            return {n.node_id: slots[i % len(slots)]
                    for i, n in enumerate(self.active_nodes())}

    def park_device(self, position: int) -> None:
        """Take one mesh position out of the node↔device fold
        (citus_drain_device — the device slot idles until revived)."""
        with self._lock:
            self._parked_devices.add(position)
            self._bump()

    def parked_devices(self) -> set[int]:
        with self._lock:
            return set(self._parked_devices)

    # -- colocation --------------------------------------------------------
    def get_or_create_colocation_group(
            self, shard_count: int, dtype: DataType | None) -> ColocationGroup:
        with self._lock:
            for g in self.colocation_groups.values():
                if g.shard_count == shard_count and g.distribution_dtype == dtype:
                    return g
            return self.new_colocation_group(shard_count, dtype)

    def new_colocation_group(self, shard_count: int,
                             dtype: DataType | None) -> ColocationGroup:
        with self._lock:
            g = ColocationGroup(self._next_colocation_id, shard_count, dtype)
            self.colocation_groups[g.colocation_id] = g
            self._next_colocation_id += 1
            self._bump()
            return g

    # -- tables ------------------------------------------------------------
    def register_table(self, meta: TableMetadata,
                       shards: Iterable[ShardInterval],
                       placements: Iterable[ShardPlacement]) -> None:
        with self._lock:
            if meta.name in self.tables:
                raise CatalogError(f"table {meta.name!r} already distributed")
            if meta.name in self.sequences or meta.name in self.views:
                # tables, sequences and views share one relation namespace
                raise CatalogError(
                    f"relation {meta.name!r} already exists")
            self.tables[meta.name] = meta
            for s in shards:
                self.shards[s.shard_id] = s
            for p in placements:
                self.placements[p.placement_id] = p
            self._bump()

    def drop_table(self, name: str) -> None:
        with self._lock:
            if name not in self.tables:
                raise CatalogError(f"table {name!r} does not exist")
            shard_ids = {s.shard_id for s in self.shards.values()
                         if s.table_name == name}
            self.shards = {k: v for k, v in self.shards.items()
                           if v.table_name != name}
            self.placements = {k: v for k, v in self.placements.items()
                               if v.shard_id not in shard_ids}
            del self.tables[name]
            self._bump()

    def table(self, name: str) -> TableMetadata:
        t = self.tables.get(name)
        if t is None:
            raise CatalogError(f"table {name!r} is not distributed")
        return t

    def has_table(self, name: str) -> bool:
        return name in self.tables

    def table_shards(self, name: str) -> list[ShardInterval]:
        self.table(name)
        with self._lock:  # background moves/splits mutate concurrently
            return sorted((s for s in self.shards.values()
                           if s.table_name == name),
                          key=lambda s: s.shard_index)

    def shard_mins(self, name: str):
        """Ascending token-range lower bounds per shard (index-aligned
        with table_shards) — the routing table for range-aware shard
        lookup after splits."""
        import numpy as np

        shards = self.table_shards(name)
        mins = [s.min_value for s in shards]
        if any(m is None for m in mins):
            raise CatalogError(f"table {name!r} is not hash-distributed")
        return np.asarray(mins, dtype=np.int64)

    def shard_placements(self, shard_id: int) -> list[ShardPlacement]:
        with self._lock:
            return [p for p in self._shard_index_locked().get(shard_id, ())
                    if p.shard_state == "active"]

    def all_shard_placements(self, shard_id: int) -> list[ShardPlacement]:
        """Every placement of a shard regardless of state (quarantined /
        to_delete included) — physical-copy attribution for the
        integrity path, NOT routing."""
        with self._lock:
            return list(self._shard_index_locked().get(shard_id, ()))

    def set_placement_state(self, placement_id: int, state: str) -> None:
        """Scrubber quarantine/restore: a 'quarantined' placement drops
        out of shard_placements (and so out of routing and replication
        guarantees) until re-replication verifies its copy and restores
        it to 'active'."""
        with self._lock:
            p = self.placements.get(placement_id)
            if p is None:
                raise CatalogError(
                    f"placement {placement_id} does not exist")
            p.shard_state = state
            self._bump()

    def active_placement(self, shard_id: int,
                         probe: bool = True) -> ShardPlacement:
        """Primary placement for reads: the lowest-id active placement
        whose NODE is alive.  With replicated placements this IS the
        read failover — disabling a node silently shifts every affected
        shard to its next replica (the reference interleaves failover
        into task execution instead, adaptive_executor.c:95-116).
        Placements the retry loop marked suspect are deprioritized, not
        excluded: when every replica is suspect the first live one still
        answers (a wrong routing beats an unroutable shard).
        `probe=False` skips the fault-point seam (which is also a
        cancellation point): the storage layer resolves physical copy
        paths through here several times per statement and must not
        multiply an armed probe fault."""
        if probe:
            from ..utils.faultinjection import fault_point

            fault_point("catalog.placement_probe")
        ps = self.shard_placements(shard_id)
        live = [p for p in ps if self._node_live(p.node_id)]
        if not live:
            from ..errors import PlacementLostError

            raise PlacementLostError(
                f"shard {shard_id} has no active placement on a live node")
        if self._suspect_placements:
            trusted = [p for p in live
                       if p.placement_id not in self._suspect_placements]
            if trusted:
                return trusted[0]
        return live[0]

    def mark_placement_suspect(self, placement_id: int) -> bool:
        """Record a shard-read failure against a placement so the next
        `active_placement` pick routes around it.  Returns True only
        when the shard has a live, NOT-already-suspect replica to fail
        over to — i.e. when marking actually changes the retry's
        routing (the caller counts that as a failover; re-marking a
        placement with every replica already suspect is a bare retry)."""
        with self._lock:
            self._suspect_placements.add(placement_id)
            p = self.placements.get(placement_id)
        if p is None:
            return False
        others = [q for q in self.shard_placements(p.shard_id)
                  if q.placement_id != placement_id
                  and q.placement_id not in self._suspect_placements
                  and self._node_live(q.node_id)]
        return bool(others)

    def clear_placement_suspect(self, placement_id: int) -> None:
        """Forget suspicion of ONE placement (scrubber repair verified
        its physical copy again)."""
        with self._lock:
            self._suspect_placements.discard(placement_id)

    def clear_placement_suspects(self, node_id: int | None = None) -> None:
        """Forget suspicion (all placements, or one recovered node's)."""
        with self._lock:
            if node_id is None:
                self._suspect_placements.clear()
                return
            self._suspect_placements = {
                pid for pid in self._suspect_placements
                if (p := self.placements.get(pid)) is not None
                and p.node_id != node_id}

    def colocated_tables(self, name: str) -> list[str]:
        t = self.table(name)
        return sorted(n for n, m in self.tables.items()
                      if m.colocation_id == t.colocation_id)

    def tables_colocated(self, a: str, b: str) -> bool:
        return self.table(a).colocation_id == self.table(b).colocation_id

    # -- distributed table creation (create_distributed_table analogue;
    #    ref: commands/create_distributed_table.c:222 +
    #    operations/create_shards.c:83) --------------------------------------
    def create_distributed_table(
            self, name: str, schema: TableSchema, distribution_column: str,
            shard_count: int, colocate_with: str | None = None,
            replication_factor: int = 1) -> TableMetadata:
        with self._lock:
            if not self.active_nodes():
                raise CatalogError("no active nodes; call add_node first")
            dist_col = schema.column(distribution_column)
            if colocate_with:
                other = self.table(colocate_with)
                if other.method != DistributionMethod.HASH:
                    raise CatalogError(
                        f"cannot colocate with non-hash table {colocate_with!r}")
                group = self.colocation_groups[other.colocation_id]
                if group.distribution_dtype != dist_col.dtype:
                    raise CatalogError(
                        "colocated tables need matching distribution column "
                        f"types ({group.distribution_dtype} vs {dist_col.dtype})")
                shard_count = group.shard_count
            else:
                group = self.get_or_create_colocation_group(shard_count, dist_col.dtype)
            meta = TableMetadata(name, schema, DistributionMethod.HASH,
                                 distribution_column, group.colocation_id)
            nodes = self.active_nodes()
            factor = max(1, min(replication_factor, len(nodes)))
            shards, placements = [], []
            for i, (lo, hi) in enumerate(shard_interval_bounds(shard_count)):
                sid = self.allocate_shard_id()
                shards.append(ShardInterval(sid, name, i, lo, hi))
                # round-robin placement (CreateShardsWithRoundRobinPolicy)
                # with replicas on the next distinct nodes
                # (citus.shard_replication_factor semantics); colocated
                # tables copy the sibling shard's full placement node list
                if colocate_with:
                    sibling = self.table_shards(colocate_with)[i]
                    node_ids = [p.node_id
                                for p in self.shard_placements(
                                    sibling.shard_id)]
                else:
                    node_ids = [nodes[(i + r) % len(nodes)].node_id
                                for r in range(factor)]
                for node_id in node_ids:
                    placements.append(ShardPlacement(
                        self.allocate_placement_id(), sid, node_id))
            self.register_table(meta, shards, placements)
            return meta

    def create_reference_table(self, name: str, schema: TableSchema) -> TableMetadata:
        """Single shard conceptually replicated on every node
        (ref: utils/reference_table_utils.c; README.md:86-90)."""
        with self._lock:
            if not self.active_nodes():
                raise CatalogError("no active nodes; call add_node first")
            # all reference tables share one colocation group (ref:
            # colocation_utils.c CreateReferenceTableColocationId)
            group = self.get_or_create_colocation_group(1, None)
            meta = TableMetadata(name, schema, DistributionMethod.REFERENCE,
                                 None, group.colocation_id)
            temp = name.startswith("__intermediate_")
            if temp:
                sid = self._next_temp_shard_id
                self._next_temp_shard_id += 1
            else:
                sid = self.allocate_shard_id()
            shard = ShardInterval(sid, name, 0, None, None)
            placements = []
            for n in self.active_nodes():
                if temp:
                    pid = self._next_temp_placement_id
                    self._next_temp_placement_id += 1
                else:
                    pid = self.allocate_placement_id()
                placements.append(ShardPlacement(pid, sid, n.node_id))
            self.register_table(meta, [shard], placements)
            return meta

    def create_local_table(self, name: str, schema: TableSchema) -> TableMetadata:
        with self._lock:
            group = self.new_colocation_group(1, None)
            meta = TableMetadata(name, schema, DistributionMethod.LOCAL,
                                 None, group.colocation_id)
            sid = self.allocate_shard_id()
            shard = ShardInterval(sid, name, 0, None, None)
            node = self.active_nodes()[0] if self.active_nodes() else None
            placements = ([ShardPlacement(self.allocate_placement_id(), sid,
                                          node.node_id)] if node else [])
            self.register_table(meta, [shard], placements)
            return meta

    # -- persistence -------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "version": self.version,
            "next_shard_id": self._next_shard_id,
            "next_placement_id": self._next_placement_id,
            "next_node_id": self._next_node_id,
            "next_colocation_id": self._next_colocation_id,
            "tables": {k: v.to_json() for k, v in self.tables.items()},
            "shards": {str(k): v.to_json() for k, v in self.shards.items()},
            "placements": {str(k): v.to_json() for k, v in self.placements.items()},
            "nodes": {str(k): v.to_json() for k, v in self.nodes.items()},
            "colocation_groups": {str(k): v.to_json()
                                  for k, v in self.colocation_groups.items()},
            "sequences": dict(self.sequences),
            "views": dict(self.views),
        }

    @staticmethod
    def from_json(obj: dict) -> "Catalog":
        cat = Catalog()
        cat.version = obj.get("version", 0)
        cat._next_shard_id = obj.get("next_shard_id", 102008)
        cat._next_placement_id = obj.get("next_placement_id", 1)
        cat._next_node_id = obj.get("next_node_id", 1)
        cat._next_colocation_id = obj.get("next_colocation_id", 1)
        cat.tables = {k: TableMetadata.from_json(v)
                      for k, v in obj.get("tables", {}).items()}
        cat.shards = {int(k): ShardInterval.from_json(v)
                      for k, v in obj.get("shards", {}).items()}
        cat.placements = {int(k): ShardPlacement.from_json(v)
                          for k, v in obj.get("placements", {}).items()}
        cat.nodes = {int(k): NodeMetadata.from_json(v)
                     for k, v in obj.get("nodes", {}).items()}
        cat.colocation_groups = {int(k): ColocationGroup.from_json(v)
                                 for k, v in obj.get("colocation_groups", {}).items()}
        cat.sequences = dict(obj.get("sequences", {}))
        cat.views = dict(obj.get("views", {}))
        return cat

    def save(self, path: str) -> None:
        """Atomic durable write — the catalog's durability primitive."""
        import os

        from ..utils.io import atomic_write_json_checked

        atomic_write_json_checked(path, self.to_json())
        # _disk_stat is read/written under _lock by maybe_reload (the
        # staleness probe); writing it bare here let a concurrent
        # reload adopt a stat for bytes it hadn't merged yet
        try:
            st = os.stat(path)
            stat = (st.st_mtime_ns, st.st_size, st.st_ino)
        except OSError:
            stat = None
        with self._lock:
            self._disk_stat = stat

    @staticmethod
    def load(path: str) -> "Catalog":
        import os

        from ..utils.io import read_json_checked

        cat = Catalog.from_json(read_json_checked(path))
        try:
            st = os.stat(path)
            cat._disk_stat = (st.st_mtime_ns, st.st_size, st.st_ino)
        except OSError:
            cat._disk_stat = None
        return cat

    def maybe_reload(self, path: str) -> bool:
        """Adopt another session's committed catalog when the on-disk
        file changed (one stat() per check) — the single-file analogue
        of the reference's metadata-cache invalidation callbacks
        (metadata/metadata_cache.c:287).  In-place: executors/stores
        hold references to THIS object.  Returns True on reload."""
        import os

        try:
            st = os.stat(path)
            disk = (st.st_mtime_ns, st.st_size, st.st_ino)
        except OSError:
            return False
        with self._lock:
            if getattr(self, "_disk_stat", None) == disk:
                return False
            fresh = Catalog.load(path)
            # merge, don't replace: this session's in-memory temp
            # reference tables (__intermediate_* — recursive-planning
            # materializations, never persisted) may be live MID-
            # STATEMENT; a wholesale swap would drop them and the outer
            # query's scan of its own CTE would fail (ADVICE r5).
            temps = {n: m for n, m in self.tables.items()
                     if n.startswith("__intermediate_")
                     and n not in fresh.tables}
            temp_shards = {sid: s for sid, s in self.shards.items()
                           if s.table_name in temps}
            temp_pids = {pid: p for pid, p in self.placements.items()
                         if p.shard_id in temp_shards}
            temp_colo = {m.colocation_id: self.colocation_groups[
                m.colocation_id] for m in temps.values()
                if m.colocation_id in self.colocation_groups}
            self.tables = fresh.tables
            self.shards = fresh.shards
            self.placements = fresh.placements
            self.nodes = fresh.nodes
            self.colocation_groups = fresh.colocation_groups
            self.sequences = fresh.sequences
            self.views = fresh.views
            self.tables.update(temps)
            self.shards.update(temp_shards)
            self.placements.update(temp_pids)
            for cid, grp in temp_colo.items():
                self.colocation_groups.setdefault(cid, grp)
            # id counters never move backwards: the disk catalog may be
            # older than ids our live temps already hold
            self._next_shard_id = max(fresh._next_shard_id,
                                      self._next_shard_id)
            self._next_placement_id = max(fresh._next_placement_id,
                                          self._next_placement_id)
            self._next_node_id = max(fresh._next_node_id,
                                     self._next_node_id)
            self._next_colocation_id = max(fresh._next_colocation_id,
                                           self._next_colocation_id)
            self._disk_stat = fresh._disk_stat
            self._bump()
            return True
