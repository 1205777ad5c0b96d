"""Deferred resource cleanup: crash-safe records for shard lifecycle ops.

Counterpart of citus_tpu/operations/cleanup.py, with the same registry
file (``<data_dir>/cleanup.json``), so either package resolves the
other's half-finished operations.  The reference registers every
resource a move or split creates in pg_dist_cleanup BEFORE creating it,
with a policy (on-operation-failure / deferred-on-success), and the
maintenance daemon deletes per policy (Citus
src/backend/distributed/operations/shard_cleaner.c).  Same model here:
a JSON registry under the data directory, written atomically, swept by
the maintenance daemon and by the recovery pass at session open.

Whether an operation committed is decided from the CATALOG, not from a
separate flag: a split's child shards appear in the catalog exactly when
the operation's single commit point (the catalog save) happened.

* children (policy=on_failure) present in the catalog → success →
  delete the parents (policy=deferred) and forget the child records;
* children absent → the operation died before commit → delete the
  half-written children and forget the parent records.

In-flight operations are protected by an in-memory active set (the
advisory-lock analogue; one controller process owns all operations).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

from ..utils.io import atomic_write_json

ON_FAILURE = "on_failure"   # resource created BY the operation (children)
DEFERRED = "deferred"       # superseded source, removed after success

# one registry per data_dir: the in-memory active-operation guard and the
# registry-file lock are shared by every accessor in the process
# (session recovery, UDFs, the maintenance daemon)
_registries: dict[str, "CleanupRegistry"] = {}
_registries_mu = threading.Lock()


def cleanup_registry_for(data_dir: str) -> "CleanupRegistry":
    key = os.path.abspath(data_dir)
    with _registries_mu:
        if key not in _registries:
            _registries[key] = CleanupRegistry(key)
        return _registries[key]


class CleanupRegistry:
    def __init__(self, data_dir: str):
        self.data_dir = data_dir
        self.path = os.path.join(data_dir, "cleanup.json")
        self._lock = threading.Lock()
        self._active: set[int] = set()

    def _load(self) -> dict:
        if not os.path.exists(self.path):
            return {"next_id": 1, "next_operation_id": 1, "records": []}
        with open(self.path) as f:
            return json.load(f)

    def _save(self, state: dict) -> None:
        atomic_write_json(self.path, state)

    def start_operation(self) -> int:
        with self._lock:
            state = self._load()
            op = state["next_operation_id"]
            state["next_operation_id"] = op + 1
            self._save(state)
            self._active.add(op)
            return op

    def register(self, operation_id: int, rtype: str, table: str,
                 shard_id: int, policy: str) -> int:
        """Record a resource BEFORE creating it (after a crash the
        sweeper can always see it)."""
        with self._lock:
            state = self._load()
            rid = state["next_id"]
            state["next_id"] = rid + 1
            state["records"].append({
                "id": rid, "operation_id": operation_id, "type": rtype,
                "table": table, "shard_id": shard_id, "policy": policy,
                "created_at": time.time()})
            self._save(state)
            return rid

    def finish_operation(self, operation_id: int) -> None:
        """Release the in-flight guard; the next sweep resolves the
        operation's records against the catalog."""
        with self._lock:
            self._active.discard(operation_id)

    def pending(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._load()["records"]]

    def sweep(self, store, catalog) -> int:
        """Resolve every non-active operation against the catalog and
        delete what lost; returns the resources removed."""
        removed = 0
        with self._lock:
            state = self._load()
            by_op: dict[int, list[dict]] = {}
            for r in state["records"]:
                by_op.setdefault(r["operation_id"], []).append(r)
            keep: list[dict] = []
            for op, recs in by_op.items():
                if op in self._active:
                    keep.extend(recs)
                    continue
                created = [r for r in recs if r["policy"] == ON_FAILURE]
                succeeded = any(r["shard_id"] in catalog.shards
                                for r in created) if created else True
                doomed_policy = DEFERRED if succeeded else ON_FAILURE
                for r in recs:
                    if r["policy"] != doomed_policy:
                        continue
                    if r["type"] == "shard_dir":
                        if store is not None:
                            store.remove_shard_records(r["table"],
                                                       r["shard_id"])
                        shutil.rmtree(
                            os.path.join(self.data_dir, "tables",
                                         r["table"],
                                         f"shard_{r['shard_id']}"),
                            ignore_errors=True)
                        removed += 1
            if len(keep) != len(state["records"]):
                # an idle sweep writes nothing: the daemon runs it on
                # every interval
                state["records"] = keep
                self._save(state)
        return removed
