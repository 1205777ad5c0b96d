"""Leader-side log shipping: stage committed state into a follower
(counterpart of citus_tpu/replication/shipper.py; a batch has the same
on-disk format in both directions).

One ship() call stages ONE batch into the follower's
``replication/incoming/batch_<seq>/`` spool through the durable-io
seam and commits it with a checked ``batch.json`` — the ship's single
commit point.  A power cut mid-ship leaves staged debris with no
batch.json: invisible to the applier (exactly pre-batch), swept and
re-staged by the next ship.  The batch carries:

* every *changed* data file (stripes, deletion bitmaps, dictionaries,
  manifests, catalog) relative to what the follower already holds —
  stripes and versioned masks are immutable-by-name so "changed" is
  "missing"; manifests/dictionaries/catalog byte-compare;
* the new CDC journal bytes ``[journal_before, journal_after)`` — the
  follower's journal is a byte-identical copy of the leader's, which
  is what makes promotion seamless (the promoted journal continues the
  SAME lsn sequence) and lets surviving followers re-point to a new
  leader without translation;
* the JAX package's exec-cache entries + caps memo alongside, when
  the leader has them (a port leader writes neither; a port follower
  lands a JAX leader's copies byte for byte and does not read them);
* the leader's epoch + history id, checked at apply time (fencing and
  the restore-timeline rule).

The Citus analogue is metadata sync + shard transfer: the coordinator
pushes pg_dist_* metadata and shard contents to a fresh node
(metadata_sync.c, shard_transfer.c); here both ride one manifest-
anchored file diff because stripes are immutable.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib

from ..errors import CorruptStripe, ReplicationError
from ..stats import counters as sc
from ..stats.tracing import trace_span
from ..utils.faultinjection import fault_point
from ..utils.io import (
    atomic_write_bytes,
    atomic_write_json_checked,
    copy_file_durable,
    is_tmp_artifact,
    read_json_checked,
)
from .state import (
    ensure_leader_state,
    incoming_dir,
    load_cursor,
    load_fence,
    load_state,
    save_state,
)

JOURNAL = "cdc_changes.jsonl"

# top-level files/dirs a batch may carry, relative to the data_dir —
# exactly the JAX package's lists, so a batch means the same in both
# directions.
# Deliberately NOT shipped: txnlog/ (2PC state is leader-local — the
# journal only ever carries committed effects), cleanup.json,
# restore_points/, replication/ itself, and PKIDX_* sidecars (derived
# lazily and validated against the manifest stripe signature).
_SHIP_FILES = ("catalog.json", "caps_memo.json")
_SHIP_TREES = ("tables", "exec_cache")


def _immutable_name(fname: str) -> bool:
    """Immutable-by-name data files: shipped once, never re-compared.
    Stripes are append-only immutable; deletion bitmaps embed a version
    in their name (``stripe_N.ctps.delNNNN.npy``); exec-cache payloads
    are content-hash named."""
    return (fname.endswith(".ctps") or ".del" in fname
            or fname.endswith(".bin"))


def _iter_ship_files(data_dir: str):
    """Yield shippable files as data_dir-relative paths."""
    for fname in _SHIP_FILES:
        if os.path.exists(os.path.join(data_dir, fname)):
            yield fname
    for tree in _SHIP_TREES:
        root = os.path.join(data_dir, tree)
        if not os.path.isdir(root):
            continue
        for dirpath, _dirnames, filenames in os.walk(root):
            rel_dir = os.path.relpath(dirpath, data_dir)
            for f in sorted(filenames):
                if is_tmp_artifact(f) or f.startswith("PKIDX_"):
                    continue
                yield os.path.join(rel_dir, f)


def _file_crc(path: str) -> tuple[int, int]:
    """(crc32, size) streamed in 1 MiB chunks."""
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return crc, size


def _changed_files(leader_dir: str, follower_dir: str,
                   reseed: bool) -> list[str]:
    out: list[str] = []
    for rel in _iter_ship_files(leader_dir):
        dst = os.path.join(follower_dir, rel)
        if reseed or not os.path.exists(dst):
            out.append(rel)
            continue
        if _immutable_name(os.path.basename(rel)):
            continue  # present ⇒ identical (immutable-by-name)
        # mutable metadata (manifests, dictionaries, catalog, memo
        # indexes): small JSON files — byte-compare beats guessing
        # from mtimes a durable copy rewrites anyway
        src = os.path.join(leader_dir, rel)
        try:
            if os.path.getsize(src) == os.path.getsize(dst):
                with open(src, "rb") as a, open(dst, "rb") as b:
                    if a.read() == b.read():
                        continue
        except OSError:
            pass
        out.append(rel)
    return out


def _dropped_tables(leader_dir: str, follower_dir: str) -> list[str]:
    """Tables the follower still holds but the leader dropped."""
    lroot = os.path.join(leader_dir, "tables")
    froot = os.path.join(follower_dir, "tables")
    if not os.path.isdir(froot):
        return []
    have = set(os.listdir(froot))
    live = set(os.listdir(lroot)) if os.path.isdir(lroot) else set()
    return sorted(have - live)


def journal_tail_lsn(data_dir: str, upto: int | None = None) -> int:
    """Max parseable lsn in the journal's last block (bounded read —
    the staleness probe runs per statement on followers)."""
    path = os.path.join(data_dir, JOURNAL)
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell() if upto is None else min(upto, f.tell())
            f.seek(max(0, size - (256 << 10)))
            block = f.read(size - max(0, size - (256 << 10)))
    except OSError:
        return 0
    top = 0
    for line in block.splitlines():
        try:
            top = max(top, int(json.loads(line)["lsn"]))
        except (ValueError, KeyError):
            continue  # torn tail / partial first line of the block
    return top


def _next_batch_seq(follower_dir: str, cursor: dict | None) -> int:
    top = cursor["batch_seq"] if cursor else 0
    inc = incoming_dir(follower_dir)
    if os.path.isdir(inc):
        for name in os.listdir(inc):
            if name.startswith("batch_"):
                try:
                    top = max(top, int(name.split("_", 1)[1]))
                except ValueError:
                    continue
    return top + 1


def _committed_journal_size(follower_dir: str, cursor: dict | None) -> int:
    """Journal byte offset the next batch must continue from: the last
    COMMITTED (shipped but possibly unapplied) batch's end, else the
    cursor's, else zero."""
    size = cursor["journal_size"] if cursor else 0
    inc = incoming_dir(follower_dir)
    if os.path.isdir(inc):
        for name in os.listdir(inc):
            meta = os.path.join(inc, name, "batch.json")
            if os.path.exists(meta):
                try:
                    size = max(size, read_json_checked(meta)
                               ["journal_after"])
                except (CorruptStripe, OSError, KeyError,
                        TypeError, ValueError):
                    continue  # damaged spool entry: applier rejects it
    return size


def register_follower(leader_dir: str, follower_dir: str) -> dict:
    state = ensure_leader_state(leader_dir)
    follower_dir = os.path.realpath(follower_dir)
    if follower_dir not in state["followers"]:
        state["followers"] = sorted(state["followers"] + [follower_dir])
        save_state(leader_dir, state)
    return state


def ship(leader_dir: str, follower_dir: str, counters=None) -> dict:
    """Stage one replication batch for `follower_dir`.  Returns a
    status dict: ``{"status": "shipped"|"noop", "batch_seq", "files",
    "bytes", "journal_after", "reseed"}``.  Raises ReplicationError
    when this leader has been fenced (a follower promoted past its
    epoch — the zombie-leader case)."""
    with trace_span("replication.ship"):
        fault_point("replication.ship")
        state = ensure_leader_state(leader_dir)
        if state.get("role") != "leader":
            raise ReplicationError(
                f"{leader_dir} is a {state.get('role')}, not a leader — "
                "only leaders ship (promote it first)")
        epoch = int(state["epoch"])
        history = state["history_id"]
        # fencing, shipper side: promotion stamps an epoch into the OLD
        # leader's fence file; a zombie leader that wakes up and tries
        # a late ship refuses HERE (the follower-side epoch check below
        # is the backstop for a zombie that never sees its fence)
        fence = load_fence(leader_dir)
        if fence is not None and int(fence["epoch"]) > epoch:
            if counters is not None:
                counters.increment(sc.REPLICATION_FENCED_TOTAL)
            raise ReplicationError(
                f"leader {leader_dir} is fenced at epoch "
                f"{fence['epoch']} (a follower was promoted); "
                "refusing to ship from the old timeline")
        cursor = load_cursor(follower_dir)
        if cursor is not None and int(cursor["epoch"]) > epoch:
            # the follower moved to a newer epoch (it, or a peer it now
            # follows, was promoted) — same zombie case seen from the
            # follower's cursor
            if counters is not None:
                counters.increment(sc.REPLICATION_FENCED_TOTAL)
            raise ReplicationError(
                f"follower {follower_dir} is at epoch "
                f"{cursor['epoch']} > ours ({epoch}); this leader is "
                "stale — refusing to ship")
        reseed = (cursor is None
                  or cursor.get("history_id") != history)
        journal_before = (0 if reseed
                          else _committed_journal_size(follower_dir,
                                                       cursor))
        jpath = os.path.join(leader_dir, JOURNAL)
        try:
            journal_after = os.path.getsize(jpath)
        except OSError:
            journal_after = 0
        if journal_after < journal_before:
            # same history but a shorter journal can only mean damage
            # (restore rotates the history id) — reseed defensively
            reseed, journal_before = True, 0
        # read the journal delta FIRST, then diff files: any commit
        # landing in between makes the file state slightly AHEAD of the
        # shipped journal — fresh data, conservative staleness (the
        # reverse order could ship events for stripes not yet staged)
        segment = b""
        if journal_after > journal_before:
            with open(jpath, "rb") as f:
                f.seek(journal_before)
                segment = f.read(journal_after - journal_before)
            journal_after = journal_before + len(segment)
        files = _changed_files(leader_dir, follower_dir, reseed)
        drops = [] if reseed else _dropped_tables(leader_dir,
                                                  follower_dir)
        if not files and not segment and not drops and not reseed:
            return {"status": "noop", "batch_seq": 0, "files": 0,
                    "bytes": 0, "journal_after": journal_before,
                    "reseed": False}
        seq = _next_batch_seq(follower_dir, cursor)
        bdir = os.path.join(incoming_dir(follower_dir), f"batch_{seq:06d}")
        # a crashed ship's torn spool (no batch.json) may occupy the
        # seq — sweep and restage
        shutil.rmtree(bdir, ignore_errors=True)
        os.makedirs(os.path.join(bdir, "files"), exist_ok=True)
        manifest: list[list] = []
        total = 0
        for rel in files:
            src = os.path.join(leader_dir, rel)
            dst = os.path.join(bdir, "files", rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            try:
                copy_file_durable(src, dst)
            except FileNotFoundError:
                continue  # deleted mid-diff (GC'd stale mask): skip
            crc, size = _file_crc(dst)
            manifest.append([rel, crc, size])
            total += size
        if segment:
            atomic_write_bytes(os.path.join(bdir, "journal.seg"), segment)
            total += len(segment)
        applied_lsn = 0 if reseed else int(cursor.get("applied_lsn", 0))
        for line in segment.splitlines():
            try:
                applied_lsn = max(applied_lsn,
                                  int(json.loads(line)["lsn"]))
            except (ValueError, KeyError):
                continue  # torn trailing line: next batch completes it
        # the ship commit point: the batch exists once this is durable
        atomic_write_json_checked(os.path.join(bdir, "batch.json"), {
            "seq": seq, "epoch": epoch, "history_id": history,
            "reseed": reseed,
            "journal_before": journal_before,
            "journal_after": journal_after,
            "applied_lsn": applied_lsn,
            "drop_tables": drops,
            "files": manifest,
        })
        if counters is not None:
            counters.increment(sc.LOG_BATCHES_SHIPPED_TOTAL)
        return {"status": "shipped", "batch_seq": seq,
                "files": len(manifest), "bytes": total,
                "journal_after": journal_after, "reseed": reseed}


def ship_all(leader_dir: str, counters=None) -> list[dict]:
    """Ship one batch to every registered follower.  Per-follower
    failures (a follower directory mid-provision or gone) are reported
    in the result rows, not raised — one dead follower must not starve
    the rest.  Fencing errors DO raise: a fenced leader must stop."""
    state = load_state(leader_dir)
    if state is None or state.get("role") != "leader":
        return []
    out = []
    for fdir in state.get("followers", []):
        try:
            res = ship(leader_dir, fdir, counters=counters)
        except ReplicationError:
            raise
        except Exception as e:  # per-follower isolation
            res = {"status": "error", "error": str(e)}
        res["follower"] = fdir
        out.append(res)
    return out
