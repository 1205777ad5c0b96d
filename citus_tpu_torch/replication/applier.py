"""Follower-side apply: roll committed batches into the live tree
(counterpart of citus_tpu/replication/applier.py).

The apply contract is the tentpole's crash-semantics acceptance rule:
after ANY power cut (leader mid-ship or follower mid-apply), a cold
restart + cursor replay lands the follower on exactly **pre-batch XOR
post-batch** state.

* Ship crashed before ``batch.json`` → the spool holds torn debris the
  applier never reads: pre-batch.  The next ship sweeps and restages.
* Apply crashed anywhere → ``batch.json`` is durable, the cursor is
  not yet flipped, and every apply step is idempotent: data files land
  via atomic rename (re-copy is a no-op), the journal append is
  byte-offset-resumable (the follower journal is a byte-identical copy
  of the leader's, so "how much of this segment already landed" is
  pure arithmetic), and the checked-JSON cursor flip is the single
  commit point: replay finishes the batch — post-batch.

Apply ordering inside a batch makes the intermediate states safe:
plain data files (stripes / masks / dictionaries) first — invisible
until a manifest references them — then manifests, then the catalog,
then the journal segment, then the cursor.

Epoch fencing lives here too: a batch stamped with an epoch OLDER than
the cursor's is a zombie leader's late ship — rejected and counted,
never applied (the acceptance rule's "fenced ships rejected").
"""

from __future__ import annotations

import os
import shutil
import threading
import zlib

from ..errors import CorruptStripe, ReplicaTooStale, ReplicationError
from ..stats import counters as sc
from ..stats.tracing import trace_span
from ..utils.faultinjection import fault_point
from ..utils.io import append_bytes, copy_file_durable, read_json_checked
from .shipper import JOURNAL, journal_tail_lsn
from .state import incoming_dir, load_cursor, load_state, save_cursor

# per-process apply serialization (two sessions sharing a follower
# data_dir); cross-process ships/applies serialize on the batch spool's
# seq ordering + idempotence, same as crash replay
_apply_locks: dict[str, threading.Lock] = {}
_apply_locks_mu = threading.Lock()


def _apply_lock(data_dir: str) -> threading.Lock:
    key = os.path.realpath(data_dir)
    with _apply_locks_mu:
        lock = _apply_locks.get(key)
        if lock is None:
            lock = _apply_locks[key] = threading.Lock()
        return lock


def pending_batches(data_dir: str) -> list[tuple[int, str]]:
    """Committed (batch.json present) spool entries, seq order."""
    inc = incoming_dir(data_dir)
    if not os.path.isdir(inc):
        return []
    out = []
    for name in os.listdir(inc):
        if not name.startswith("batch_"):
            continue
        bdir = os.path.join(inc, name)
        if not os.path.exists(os.path.join(bdir, "batch.json")):
            continue  # torn ship: invisible
        try:
            out.append((int(name.split("_", 1)[1]), bdir))
        except ValueError:
            continue
    return sorted(out)


def has_pending(data_dir: str) -> bool:
    """Cheap per-statement probe: any committed batch in the spool?"""
    return bool(pending_batches(data_dir))


def _verify_staged(bdir: str, meta: dict) -> None:
    """Every staged file must match its shipped CRC before ANY byte
    lands in the live tree — the zero-checksum-failures acceptance
    rule (a torn or rotted spool file refuses cleanly; the next ship
    restages it)."""
    for rel, crc, size in meta["files"]:
        path = os.path.join(bdir, "files", rel)
        got = 0
        n = 0
        try:
            with open(path, "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    got = zlib.crc32(chunk, got)
                    n += len(chunk)
        except OSError as e:
            raise CorruptStripe(
                f"replication batch {meta['seq']}: staged file {rel} "
                f"unreadable ({e})") from e
        if got != crc or n != size:
            raise CorruptStripe(
                f"replication batch {meta['seq']}: staged file {rel} "
                f"fails its shipped checksum (crc {got}!={crc} or "
                f"size {n}!={size})")


def _wipe_for_reseed(data_dir: str) -> None:
    """A reseed batch replaces the follower's data wholesale (initial
    provision, or the leader's timeline changed under restore_cluster).
    Everything wiped here is re-staged in the same batch; the wipe is
    idempotent under crash replay because batch.json is already
    durable."""
    for tree in ("tables", "exec_cache"):
        shutil.rmtree(os.path.join(data_dir, tree), ignore_errors=True)
    for fname in ("catalog.json", "caps_memo.json", JOURNAL):
        try:
            os.unlink(os.path.join(data_dir, fname))
        except OSError:
            pass


def _install_files(data_dir: str, bdir: str, meta: dict) -> None:
    """Staged → live, visibility-safe order: data files before the
    manifests that reference them, catalog last.  Every landing is an
    atomic rename through the io seam (idempotent under replay)."""
    ranked = sorted(
        meta["files"],
        key=lambda ent: (2 if os.path.basename(ent[0]) == "catalog.json"
                         else 1 if os.path.basename(ent[0]) ==
                         "MANIFEST.json" else 0, ent[0]))
    for rel, _crc, _size in ranked:
        src = os.path.join(bdir, "files", rel)
        dst = os.path.join(data_dir, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        copy_file_durable(src, dst)


def _append_journal(data_dir: str, bdir: str, meta: dict) -> None:
    """Byte-exact journal catch-up, resumable mid-segment: the follower
    journal size tells exactly how much of this batch's segment already
    landed (a torn append from a previous crash included) — append only
    the remainder."""
    before, after = meta["journal_before"], meta["journal_after"]
    if after <= before:
        return
    seg_path = os.path.join(bdir, "journal.seg")
    with open(seg_path, "rb") as f:
        segment = f.read()
    jpath = os.path.join(data_dir, JOURNAL)
    try:
        have = os.path.getsize(jpath)
    except OSError:
        have = 0
    if have >= after:
        return  # fully landed on a previous (crashed) pass
    if have < before:
        raise ReplicationError(
            f"follower journal at {have} bytes but batch "
            f"{meta['seq']} starts at {before} — a prior batch's "
            "durable append is missing (corrupt spool order)")
    append_bytes(jpath, segment[have - before:])


def apply_pending(data_dir: str, counters=None, store=None) -> dict:
    """Apply every committed batch in seq order.  Returns
    ``{"applied", "fenced", "applied_lsn", "needs_reseed"}``.
    ``needs_reseed`` reports a batch from a DIFFERENT timeline that was
    not itself a reseed — the follower waits for the leader's next ship
    to restage it from scratch."""
    result = {"applied": 0, "fenced": 0, "applied_lsn": 0,
              "needs_reseed": False}
    batches = pending_batches(data_dir)
    if not batches:
        cur = load_cursor(data_dir)
        result["applied_lsn"] = int(cur["applied_lsn"]) if cur else 0
        return result
    with _apply_lock(data_dir), trace_span("replication.apply"):
        for _seq, bdir in pending_batches(data_dir):
            fault_point("replication.apply")
            try:
                meta = read_json_checked(os.path.join(bdir, "batch.json"))
            except CorruptStripe:
                # a bit-flipped commit record: refuse the batch, leave
                # the spool entry for the next ship's sweep
                continue
            cursor = load_cursor(data_dir)
            if cursor is not None and meta["seq"] <= cursor["batch_seq"]:
                shutil.rmtree(bdir, ignore_errors=True)  # replayed GC
                continue
            if cursor is not None and \
                    int(meta["epoch"]) < int(cursor["epoch"]):
                # zombie leader's late ship: REJECT and count — the
                # fencing acceptance rule
                result["fenced"] += 1
                if counters is not None:
                    counters.increment(sc.REPLICATION_FENCED_TOTAL)
                shutil.rmtree(bdir, ignore_errors=True)
                continue
            if cursor is not None and not meta.get("reseed") and \
                    meta.get("history_id") != cursor.get("history_id"):
                # a delta batch from a different timeline: applying it
                # would replay foreign lsns onto our data — wait for
                # the leader to notice and ship a reseed
                result["needs_reseed"] = True
                shutil.rmtree(bdir, ignore_errors=True)
                continue
            _verify_staged(bdir, meta)
            if meta.get("reseed"):
                _wipe_for_reseed(data_dir)
            _install_files(data_dir, bdir, meta)
            for table in meta.get("drop_tables", []):
                shutil.rmtree(os.path.join(data_dir, "tables", table),
                              ignore_errors=True)
            _append_journal(data_dir, bdir, meta)
            # THE apply commit point: everything above replays
            # idempotently behind this flip
            state = load_state(data_dir)
            save_cursor(data_dir, {
                "batch_seq": meta["seq"],
                "applied_lsn": meta["applied_lsn"],
                "journal_size": meta["journal_after"],
                "epoch": meta["epoch"],
                "history_id": meta["history_id"],
                "leader_dir": (state or {}).get("leader_dir"),
            })
            shutil.rmtree(bdir, ignore_errors=True)
            result["applied"] += 1
            result["applied_lsn"] = int(meta["applied_lsn"])
            if counters is not None:
                counters.increment(sc.LOG_BATCHES_APPLIED_TOTAL)
            if store is not None:
                # reader sessions re-stat manifests on their own; OUR
                # store should adopt the shipped manifests before the
                # statement that triggered this apply plans
                for table in _tables_touched(meta):
                    store.refresh_if_stale(table)
    if result["applied"] == 0 and result["applied_lsn"] == 0:
        cur = load_cursor(data_dir)
        result["applied_lsn"] = int(cur["applied_lsn"]) if cur else 0
    return result


def _tables_touched(meta: dict) -> set[str]:
    out = set(meta.get("drop_tables", []))
    for rel, _crc, _size in meta["files"]:
        parts = rel.split(os.sep)
        if len(parts) >= 2 and parts[0] == "tables":
            out.add(parts[1])
    return out


def staleness(data_dir: str) -> dict:
    """Visible lag, follower-side: applied lsn vs the leader journal's
    tail lsn, in lsns AND bytes (the citus_stat_replication columns).
    A dead/unreachable leader reports lag 0 beyond what was shipped —
    the follower serves what it has; promotion is the availability
    path."""
    cursor = load_cursor(data_dir)
    state = load_state(data_dir)
    applied_lsn = int(cursor["applied_lsn"]) if cursor else 0
    applied_bytes = int(cursor["journal_size"]) if cursor else 0
    leader_dir = (state or {}).get("leader_dir")
    leader_lsn, leader_bytes = applied_lsn, applied_bytes
    if leader_dir:
        try:
            leader_bytes = os.path.getsize(
                os.path.join(leader_dir, JOURNAL))
        except OSError:
            leader_bytes = applied_bytes
        if leader_bytes > applied_bytes:
            leader_lsn = max(applied_lsn, journal_tail_lsn(leader_dir))
    return {"applied_lsn": applied_lsn,
            "leader_lsn": leader_lsn,
            "lag_lsn": max(0, leader_lsn - applied_lsn),
            "lag_bytes": max(0, leader_bytes - applied_bytes),
            "leader_dir": leader_dir}


def ensure_fresh(data_dir: str, max_staleness_lsn: int,
                 counters=None, store=None) -> dict:
    """The follower read gate: drain any committed batches, then bound
    the VISIBLE staleness.  Lag beyond `max_staleness_lsn` (>= 0; -1 =
    unbounded) raises a clean ReplicaTooStale for the client to reroute
    — never silently old rows."""
    applied = 0
    if has_pending(data_dir):
        applied = apply_pending(data_dir, counters=counters,
                                store=store)["applied"]
    stale = staleness(data_dir)
    stale["applied"] = applied
    if counters is not None and stale["lag_lsn"]:
        # cumulative lag-sum sample (the wlm_queue_wait_ms idiom:
        # divide by the check count for an average)
        counters.increment(sc.REPLICA_LAG_LSN, stale["lag_lsn"])
    if max_staleness_lsn >= 0 and stale["lag_lsn"] > max_staleness_lsn:
        raise ReplicaTooStale(
            f"replica is {stale['lag_lsn']} lsns behind its leader "
            f"(applied {stale['applied_lsn']}, leader at "
            f"{stale['leader_lsn']}; replica_max_staleness_lsn="
            f"{max_staleness_lsn}) — reroute to the leader or a "
            "fresher replica")
    return stale

