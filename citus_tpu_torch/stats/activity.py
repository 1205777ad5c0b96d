"""Active-statement tracking — citus_stat_activity / global PID analogue.

Counterpart of citus_tpu/stats/activity.py.  The reference assigns every
backend a globally unique gpid (nodeId · 10^10 + pid, Citus
src/backend/distributed/transaction/backend_data.c) and unions per-node
pg_stat_activity into cluster views.  Single-controller equivalent:
session-scoped gpids + a live registry of executing statements, with
the retry envelope's attempts of the in-flight statement."""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from contextlib import contextmanager

GPID_NODE_FACTOR = 10_000_000_000  # reference encoding: nodeid*10^10 + pid

_PID = os.getpid()  # per-statement getpid() syscalls add up at high QPS


def make_gpid(node_id: int, pid: int | None = None) -> int:
    return node_id * GPID_NODE_FACTOR + (pid if pid is not None
                                         else _PID)


@dataclass
class ActivityEntry:
    gpid: int
    query: str
    state: str = "active"
    started_at: float = field(default_factory=time.time)
    # statement-retry-loop attempts for the in-flight statement (the
    # resilient executor bumps this so citus_stat_activity shows which
    # live statements are riding out transient failures)
    retries: int = 0
    # stripe reads this statement transparently served from a replica
    # copy after a checksum failure (storage/integrity.py fold)
    read_repairs: int = 0
    # (plan_hits, plan_misses, feed_hits, feed_misses) snapshot of the
    # session executor's cache counters when the statement started;
    # citus_stat_activity subtracts it from the live totals to show
    # the in-flight statement's own cache activity
    cache_base: tuple | None = None
    # workload-manager state of the in-flight statement:
    # queued (waiting for an admission slot) | admitted (slot granted,
    # not yet executing) | running (executing, or exempt from the gate)
    wait_state: str = "running"
    # time the in-flight statement spent in the admission queue
    queued_ms: float = 0.0


class ActivityRegistry:
    def __init__(self, node_id: int = 0):
        self.node_id = node_id
        self._lock = threading.Lock()
        self._seq = 0
        self._active: dict[int, ActivityEntry] = {}

    @contextmanager
    def track(self, query: str):
        with self._lock:
            self._seq += 1
            key = self._seq
            entry = ActivityEntry(make_gpid(self.node_id), query[:1024])
            self._active[key] = entry
        try:
            yield entry
        finally:
            with self._lock:
                self._active.pop(key, None)

    def entries(self) -> list[ActivityEntry]:
        with self._lock:
            return list(self._active.values())
