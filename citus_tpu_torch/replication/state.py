"""Replication state records: roles, epochs, timelines, cursors
(counterpart of citus_tpu/replication/state.py; the same files, so
either package's follower reads the other's records).

The reference tracks replica roles and sync state in pg_dist_node +
metadata sync bookkeeping (distributed/metadata/metadata_sync.c); here
the durable analogue is two small checked-JSON files per data_dir:

* ``replication/state.json`` — who this directory IS: its role
  (``leader`` / ``follower``), its fencing **epoch**, its journal
  **history id** (timeline: regenerated whenever the journal is
  replaced wholesale, e.g. by restore_cluster), the leader it follows
  (followers) and the followers it ships to (leaders).
* ``replication/applied.json`` — the follower's apply **cursor**: the
  last committed batch applied, the byte length of the (byte-identical)
  journal copy, the max applied lsn, and the epoch/history the cursor
  was written under.  The cursor is the ONLY commit point of an apply —
  a power cut anywhere during an apply replays idempotently behind it.

Both ride ``atomic_write_json_checked`` so a torn or bit-flipped state
file refuses at read time instead of becoming adopted state.

The state deliberately does NOT live in catalog.json: the catalog ships
leader→follower verbatim (the follower must see the leader's tables and
placements), so a role stored there would be overwritten by the very
replication it describes.
"""

from __future__ import annotations

import os
import uuid

from ..utils.io import atomic_write_json_checked, read_json_checked

REPL_DIR = "replication"


def repl_dir(data_dir: str) -> str:
    return os.path.join(data_dir, REPL_DIR)


def state_path(data_dir: str) -> str:
    return os.path.join(repl_dir(data_dir), "state.json")


def cursor_path(data_dir: str) -> str:
    return os.path.join(repl_dir(data_dir), "applied.json")


def fence_path(data_dir: str) -> str:
    return os.path.join(repl_dir(data_dir), "fence.json")


def incoming_dir(data_dir: str) -> str:
    return os.path.join(repl_dir(data_dir), "incoming")


def new_history_id() -> str:
    """Journal timeline id: regenerated whenever the journal is
    REPLACED rather than appended (restore_cluster) — a follower cursor
    carrying the old history must reseed, never replay pre-restore lsns
    onto post-restore data."""
    return uuid.uuid4().hex[:16]


def load_state(data_dir: str) -> dict | None:
    """Role record, or None for an unreplicated directory."""
    path = state_path(data_dir)
    if not os.path.exists(path):
        return None
    return read_json_checked(path)


def save_state(data_dir: str, state: dict) -> None:
    os.makedirs(repl_dir(data_dir), exist_ok=True)
    atomic_write_json_checked(state_path(data_dir), state)


def load_cursor(data_dir: str) -> dict | None:
    path = cursor_path(data_dir)
    if not os.path.exists(path):
        return None
    return read_json_checked(path)


def save_cursor(data_dir: str, cursor: dict) -> None:
    os.makedirs(repl_dir(data_dir), exist_ok=True)
    atomic_write_json_checked(cursor_path(data_dir), cursor)


def load_fence(data_dir: str) -> dict | None:
    path = fence_path(data_dir)
    if not os.path.exists(path):
        return None
    return read_json_checked(path)


def ensure_leader_state(data_dir: str) -> dict:
    """Load this directory's role record, creating a fresh epoch-1
    leader record for a never-replicated directory."""
    state = load_state(data_dir)
    if state is None:
        state = {"role": "leader", "epoch": 1,
                 "history_id": new_history_id(),
                 "leader_dir": None, "followers": []}
        save_state(data_dir, state)
    return state


def rotate_history(data_dir: str) -> None:
    """The journal was just replaced wholesale (restore_cluster): start
    a new timeline so every follower cursor pinned to the old history
    reseeds on the next ship instead of replaying pre-restore lsns onto
    post-restore data."""
    state = load_state(data_dir)
    if state is None:
        return  # never replicated: nothing points at this journal
    state["history_id"] = new_history_id()
    save_state(data_dir, state)
