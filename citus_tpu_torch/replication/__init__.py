"""Log-shipped read replicas: leader → N followers over the durable-io
seam, bounded visible staleness, leader-death promotion (counterpart
of citus_tpu/replication/).

Every committed mutation is an immutable-stripe + manifest-flip pair
recorded in the change journal (cdc/feed.py), and every durable write
passes one io seam (utils/io.py).  So a replica is a byte-identical
journal copy plus the files it references, applied idempotently behind
a checked cursor.  The on-disk format is the JAX package's: a batch
either package ships, the other applies, and a port session reads a
follower either package keeps.

Module map:
* ``state``   — roles, epochs, history (timeline) ids, cursors
* ``shipper`` — leader-side batch staging (`ship`, `ship_all`,
  `register_follower`)
* ``applier`` — follower-side apply + staleness gate
  (`apply_pending`, `ensure_fresh`, `staleness`)
* ``promote`` — epoch-bumping promotion with zombie-leader fencing

``replication_for(data_dir)`` hands out the per-directory manager the
session layer uses: a stat-cached view of the role record, so the
per-statement follower check costs one stat() on the hot path.
"""

from __future__ import annotations

import os
import threading

from .applier import apply_pending, ensure_fresh, has_pending, staleness
from .promote import promote
from .shipper import journal_tail_lsn, register_follower, ship, ship_all
from .state import (
    ensure_leader_state,
    load_cursor,
    load_state,
    new_history_id,
    rotate_history,
    save_state,
    state_path,
)

__all__ = [
    "ReplicationManager", "replication_for", "provision_replica",
    "apply_pending", "ensure_fresh", "staleness", "has_pending",
    "promote", "ship", "ship_all", "register_follower",
    "journal_tail_lsn", "ensure_leader_state",
    "load_state", "load_cursor", "new_history_id", "rotate_history",
]


class ReplicationManager:
    """Per-data_dir view of the replication role, cached on the state
    file's stat identity — the follower hot path (every statement asks
    "am I a follower?") must not parse JSON per query."""

    def __init__(self, data_dir: str):
        self.data_dir = data_dir
        self._mu = threading.Lock()
        self._state: dict | None = None
        self._stat: tuple | None = ()

    def _identity(self) -> tuple | None:
        try:
            st = os.stat(state_path(self.data_dir))
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size, st.st_ino)

    def state(self) -> dict | None:
        ident = self._identity()
        with self._mu:
            if ident != self._stat:
                self._state = (load_state(self.data_dir)
                               if ident is not None else None)
                self._stat = ident
            return self._state

    def role(self) -> str:
        state = self.state()
        return state["role"] if state else "none"

    def is_follower(self) -> bool:
        return self.role() == "follower"

    def is_leader_with_followers(self) -> bool:
        state = self.state()
        return bool(state and state.get("role") == "leader"
                    and state.get("followers"))


_managers: dict[str, ReplicationManager] = {}
_managers_mu = threading.Lock()


def replication_for(data_dir: str) -> ReplicationManager:
    key = os.path.realpath(data_dir)
    with _managers_mu:
        mgr = _managers.get(key)
        if mgr is None:
            mgr = _managers[key] = ReplicationManager(key)
        return mgr


def provision_replica(leader_dir: str, follower_dir: str,
                      counters=None) -> dict:
    """Stand up a fresh follower: register it with the leader, write
    its role record, ship the full state (a reseed batch: stripes,
    dictionaries, manifests, catalog and journal) and apply it.
    Returns the apply status — after this call a Session opened on
    `follower_dir` serves read-only at the shipped lsn."""
    os.makedirs(follower_dir, exist_ok=True)
    leader_state = register_follower(leader_dir, follower_dir)
    save_state(follower_dir, {
        "role": "follower", "epoch": leader_state["epoch"],
        "history_id": leader_state["history_id"],
        "leader_dir": os.path.realpath(leader_dir), "followers": []})
    ship(leader_dir, follower_dir, counters=counters)
    return apply_pending(follower_dir, counters=counters)
