"""Relation/shard lock manager with distributed-deadlock detection.

Counterpart of citus_tpu/transaction/locks.py.  The lock table is per
process and per package: a port session and a JAX-package session in
one process do not lock each other.

The reference builds a wait-for graph per node from PostgreSQL's lock
tables (Citus src/backend/distributed/transaction/lock_graph.c:56
BuildLocalWaitGraph, :142 BuildGlobalWaitGraph), unions the graphs on the
coordinator, DFS-detects cycles, and cancels the *youngest* transaction in
the cycle (distributed_deadlock_detection.c; checked every
citus.distributed_deadlock_detection_factor × 2s by the maintenance
daemon).

Single-controller mapping: sessions are the "nodes"; the wait-for graph
lives in one process-wide registry per data directory, edges are recorded
while a session blocks on a lock, and the same youngest-aborts rule
resolves cycles, checked synchronously at wait time (the JAX package's
maintenance daemon, which also checks, is not part of the port)."""

from __future__ import annotations

import threading
import time


class DeadlockDetectedError(Exception):
    """Raised in the transaction chosen as the deadlock victim."""


class _Lock:
    def __init__(self):
        self.owner: int | None = None   # txid
        self.depth = 0
        self.cond = threading.Condition()


class LockManager:
    """Exclusive locks on (table[, shard]) resources keyed by txid."""

    def __init__(self, deadlock_check_interval: float = 0.05):
        self._mu = threading.Lock()
        self._locks: dict[tuple, _Lock] = {}
        self._held: dict[int, set[tuple]] = {}      # txid -> resources
        self._waits_for: dict[int, int] = {}        # txid -> blocking txid
        self._victims: set[int] = set()
        self.check_interval = deadlock_check_interval

    # -- wait-for graph (BuildGlobalWaitGraph analogue) --------------------
    def wait_graph(self) -> dict[int, int]:
        with self._mu:
            return dict(self._waits_for)

    def _find_cycle(self, start: int) -> list[int] | None:
        seen = []
        node = start
        while node in self._waits_for:
            if node in seen:
                return seen[seen.index(node):]
            seen.append(node)
            node = self._waits_for[node]
        return None

    def check_deadlocks(self) -> int | None:
        """DFS for a cycle; marks the youngest member as victim
        (CheckForDistributedDeadlocks analogue).  Returns the victim."""
        with self._mu:
            for txid in list(self._waits_for):
                cycle = self._find_cycle(txid)
                if cycle:
                    # HLC txids grow with time: max = youngest transaction
                    victim = max(cycle)
                    self._victims.add(victim)
                    return victim
        return None

    # -- locking -----------------------------------------------------------
    def acquire(self, txid: int, resource: tuple,
                timeout: float = 10.0) -> None:
        with self._mu:
            lk = self._locks.setdefault(resource, _Lock())
        deadline = time.monotonic() + timeout
        with lk.cond:
            while True:
                if lk.owner is None or lk.owner == txid:
                    lk.owner = txid
                    lk.depth += 1
                    with self._mu:
                        self._held.setdefault(txid, set()).add(resource)
                        self._waits_for.pop(txid, None)
                    return
                with self._mu:
                    self._waits_for[txid] = lk.owner
                self.check_deadlocks()
                with self._mu:
                    if txid in self._victims:
                        self._victims.discard(txid)
                        self._waits_for.pop(txid, None)
                        raise DeadlockDetectedError(
                            "canceling the transaction since it was "
                            "involved in a distributed deadlock")
                if time.monotonic() >= deadline:
                    with self._mu:
                        self._waits_for.pop(txid, None)
                    raise TimeoutError(
                        f"could not acquire lock on {resource} "
                        f"within {timeout}s")
                lk.cond.wait(self.check_interval)

    def release_all(self, txid: int) -> None:
        with self._mu:
            resources = self._held.pop(txid, set())
            self._waits_for.pop(txid, None)
            self._victims.discard(txid)
            locks = [self._locks[r] for r in resources if r in self._locks]
        for lk in locks:
            with lk.cond:
                if lk.owner == txid:
                    lk.owner = None
                    lk.depth = 0
                    lk.cond.notify_all()


# process-wide registry: sessions sharing a data_dir share the lock table
_registry: dict[str, LockManager] = {}
_registry_mu = threading.Lock()


def lock_manager_for(data_dir: str) -> LockManager:
    with _registry_mu:
        if data_dir not in _registry:
            _registry[data_dir] = LockManager()
        return _registry[data_dir]
