"""Leader-death promotion: a follower becomes the leader (counterpart
of citus_tpu/replication/promote.py).

When the leader dies, one follower rolls the shipped journal forward,
runs the recovery machinery over its own tree (2PC recovery, the same
pass every session start runs, and the cleanup sweep —
Session.promote_replica), bumps the fencing **epoch**, best-effort
stamps the old leader's data_dir so a zombie that wakes up refuses to
ship, and flips its role record to ``leader``.  Serving traffic flips by pointing sessions (or,
in-process, the existing follower sessions' next statement — the role
is re-read per statement) at the promoted directory.

Because the follower's journal is a byte-identical copy of the
leader's, the promoted journal continues the SAME lsn sequence: the
surviving followers can re-point to the new leader with plain
``register_follower`` + ship, no lsn translation.
"""

from __future__ import annotations

import os

from ..errors import ReplicationError
from ..stats import counters as sc
from ..stats.tracing import trace_span
from ..utils.faultinjection import fault_point
from ..utils.io import atomic_write_json_checked
from .applier import apply_pending
from .state import (
    fence_path,
    load_cursor,
    load_state,
    save_cursor,
    save_state,
)


def promote(data_dir: str, counters=None, store=None) -> int:
    """Promote a follower data_dir to leader.  Returns the new epoch.
    Pure state machinery — callers holding a live Session should use
    ``Session.promote_replica()`` so 2PC recovery runs through the
    session's own managers."""
    with trace_span("replication.promote"):
        fault_point("replication.promote")
        state = load_state(data_dir)
        if state is None or state.get("role") != "follower":
            raise ReplicationError(
                f"{data_dir} is not a follower (role="
                f"{(state or {}).get('role')!r}) — nothing to promote")
        # roll the shipped journal forward: every committed batch lands
        # before the role flips (a promoted leader must serve at the
        # newest shipped state, not strand batches in the spool)
        apply_pending(data_dir, counters=counters, store=store)
        cursor = load_cursor(data_dir)
        old_epoch = max(int(state["epoch"]),
                        int(cursor["epoch"]) if cursor else 0)
        new_epoch = old_epoch + 1
        # fence the old leader's data_dir (best-effort: it may be dead,
        # unmounted, or gone — the follower-side epoch check in the
        # applier is the backstop)
        old_leader = state.get("leader_dir")
        if old_leader:
            try:
                os.makedirs(os.path.dirname(fence_path(old_leader)),
                            exist_ok=True)
                atomic_write_json_checked(fence_path(old_leader),
                                          {"epoch": new_epoch})
            except OSError:
                pass
        state.update({"role": "leader", "epoch": new_epoch,
                      "leader_dir": None,
                      "followers": state.get("followers") or []})
        save_state(data_dir, state)
        if cursor is not None:
            cursor["epoch"] = new_epoch
            save_cursor(data_dir, cursor)
        if counters is not None:
            counters.increment(sc.REPLICAS_PROMOTED_TOTAL)
        return new_epoch
