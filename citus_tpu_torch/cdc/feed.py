"""Change data capture: a manifest-delta change feed.

Counterpart of citus_tpu/cdc/feed.py: the same journal file
(`<data_dir>/cdc_changes.jsonl`), event format and LSN sequence, so a
feed mixes the two packages' commits in one total order.

The reference implements CDC as a wrapper WAL decoder
(Citus src/backend/distributed/cdc/cdc_decoder.c): it maps
shard-level WAL changes to the distributed table they belong to and drops
changes produced by internal shard transfers (replication origin
DoNotReplicateId, distributed/README.md:2702-2720).

With immutable stripes the TPU-native equivalent is much simpler: every
logical mutation is a manifest flip (stripe committed / deletion-bitmap
advanced), so the change feed is an append-only journal written at the
same commit points, with internal data movement (shard move / split /
rebalance / cleanup) suppressed at the source — those rewrite placement,
not table contents.

Events (JSONL, one per line, monotonically increasing `lsn`):
  {"lsn", "ts", "table", "kind": "insert", "shard_id", "file", "rows"}
  {"lsn", "ts", "table", "kind": "delete", "shard_id", "file",
   "count", "positions": [...]}     # physical row positions in the stripe

Row payloads are late-materialized: `rows_for(event)` reads the referenced
stripe (insert) or the pre-image positions (delete) on demand — the
analogue of logical decoding reading row images out of the WAL.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

# deletes bigger than this store only the count (consumer re-reads the
# current bitmap); keeps journal lines bounded
MAX_INLINE_POSITIONS = 10_000


class ChangeLog:
    """Append-only change journal for one data directory."""

    def __init__(self, data_dir: str, enabled: bool = True):
        self.path = os.path.join(data_dir, "cdc_changes.jsonl")
        self.enabled = enabled
        self._mu = threading.Lock()
        self._tls = threading.local()
        self._tail_checked = False
        self.torn_lines = 0
        self._next_lsn = self._scan_next_lsn()
        # journal size as of OUR last append: a mismatch under the file
        # lock means another session appended — re-sync the lsn cursor
        # from the tail so the feed stays ONE total order (the WAL-LSN
        # property logical decoding gives the reference for free)
        self._expected_size = self._file_size()

    def _file_size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def _tail_max_lsn(self) -> int:
        """Max lsn among the last block's parseable lines (events are
        appended in lsn order, so the journal tail carries the max)."""
        try:
            with open(self.path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - (256 << 10)))
                block = f.read()
        except OSError:
            return 0
        top = 0
        for line in block.splitlines():
            try:
                top = max(top, int(json.loads(line)["lsn"]))
            except (ValueError, KeyError):
                continue  # partial first line of the block / torn tail
        return top

    def _scan_next_lsn(self) -> int:
        """Max parseable lsn + 1.  A crash mid-append can tear the LAST
        line; falling back to the highest intact lsn (never to 1 — that
        would restart the sequence and strand every subscriber's
        from_lsn cursor)."""
        if not os.path.exists(self.path):
            return 1
        top = 0
        with open(self.path, "rb") as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    top = max(top, int(json.loads(line)["lsn"]))
                except (ValueError, KeyError):
                    continue  # torn tail line
        return top + 1

    # -- suppression (the DoNotReplicateId analogue) ---------------------
    @contextlib.contextmanager
    def suppress(self):
        """Internal data movement (move/split/cleanup) must not surface
        as logical changes.  Thread-local: background jobs suppress only
        their own writes."""
        prev = getattr(self._tls, "suppressed", False)
        self._tls.suppressed = True
        try:
            yield
        finally:
            self._tls.suppressed = prev

    @property
    def suppressed(self) -> bool:
        return getattr(self._tls, "suppressed", False)

    # -- producer --------------------------------------------------------
    @staticmethod
    def insert_event(table: str, shard_id: int, record: dict) -> dict:
        return {"table": table, "kind": "insert", "shard_id": shard_id,
                "file": record["file"], "rows": record["rows"]}

    @staticmethod
    def delete_event(table: str, shard_id: int, fname: str,
                     positions) -> dict:
        import numpy as np

        pos = np.flatnonzero(np.asarray(positions))
        ev = {"table": table, "kind": "delete", "shard_id": shard_id,
              "file": fname, "count": int(len(pos))}
        if len(pos) <= MAX_INLINE_POSITIONS:
            ev["positions"] = pos.tolist()
        return ev

    def emit(self, events: list[dict]) -> None:
        """Append a commit's worth of events: one write + fsync.

        emit() runs AFTER the manifest flip made the commit visible, so
        any failure here (injected or a real OSError on the journal) is
        post-visibility: re-executing the statement would double-apply.
        Escaping exceptions are tagged `post_visibility`, so the ingest
        path keeps the committed stripes instead of discarding them."""
        try:
            self._emit(events)
        except BaseException as e:
            e.post_visibility = True
            raise

    def _emit(self, events: list[dict]) -> None:
        if not self.enabled or self.suppressed or not events:
            return
        from ..utils.faultinjection import fault_point

        import fcntl

        with self._mu:
            # named seam: a crash before the journal append must lose at
            # most the in-flight commit's events (at-most-once window),
            # never corrupt earlier lines
            fault_point("cdc.append")
            # the journal MUST hold one handle across flock + lsn
            # allocation + append, so it cannot ride an io helper; the
            # crash shim intercepts via dio.append_op below instead
            with open(self.path, "a") as f:  # graftlint: ignore[raw-durable-write] — one handle: flock + lsn + append; the crash seam is the journal append op
                # exclusive journal lock: concurrent sessions (threads or
                # processes) serialize their appends and allocate from
                # ONE lsn sequence
                fcntl.flock(f.fileno(), fcntl.LOCK_EX)
                try:
                    if self._file_size() != self._expected_size:
                        # another session appended since our last write:
                        # adopt its lsns before allocating ours
                        self._next_lsn = max(self._next_lsn,
                                             self._tail_max_lsn() + 1)
                        self._tail_checked = False
                    now = time.time()
                    payload = []
                    for ev in events:
                        ev["lsn"] = self._next_lsn
                        ev["ts"] = now
                        self._next_lsn += 1
                        payload.append(json.dumps(ev))
                    lead = ""
                    if not self._tail_checked:
                        # a crash may have torn the last line mid-append;
                        # isolate the partial tail so this commit's first
                        # event stays parseable instead of concatenating
                        # onto the garbage
                        self._tail_checked = True
                        try:
                            with open(self.path, "rb") as rf:
                                rf.seek(-1, os.SEEK_END)
                                if rf.read(1) != b"\n":
                                    lead = "\n"
                        except OSError:
                            pass  # empty file: nothing to isolate
                    data = lead + "\n".join(payload) + "\n"
                    # crash seam: the shim counts this append and can
                    # drop or tear its tail (readers tolerate torn
                    # trailing lines — see read()/_scan_next_lsn)
                    from ..utils import io as dio

                    dio.append_op(self.path, data.encode())
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())  # graftlint: ignore[raw-durable-write] — the same single-handle append as the open above
                    self._expected_size = f.tell()
                finally:
                    fcntl.flock(f.fileno(), fcntl.LOCK_UN)

    # -- consumer --------------------------------------------------------
    def read(self, table: str | None = None, from_lsn: int = 0,
             limit: int | None = None) -> list[dict]:
        """Events with lsn > from_lsn, oldest first (the subscription
        catch-up read; consumers poll with their last-seen lsn)."""
        out: list[dict] = []
        if not os.path.exists(self.path):
            return out
        with open(self.path) as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    # torn line from a crash mid-append (same tolerance
                    # as _scan_next_lsn); later appends are isolated by
                    # emit()'s tail check, so just skip it
                    self.torn_lines += 1
                    continue
                if ev["lsn"] <= from_lsn:
                    continue
                if table is not None and ev["table"] != table:
                    continue
                out.append(ev)
                if limit is not None and len(out) >= limit:
                    break
        return out

    def last_lsn(self) -> int:
        return self._next_lsn - 1


class ChangeFeedCursor:
    """Incremental, offset-tracking journal consumer — the invalidation
    subscription seam.

    Polling consumers (a result cache invalidating per table on every
    statement, as the JAX package's serving layer does) cannot afford ``ChangeLog.read``'s full-file scan;
    this cursor remembers its byte offset and the unchanged-size fast
    path is ONE ``os.path.getsize`` call.  Starts at the journal's
    CURRENT tail: a new subscriber cares about changes after it attached
    (catch-up reads ride ``ChangeLog.read`` with an lsn).

    ``poll()`` returns the new complete events, or ``None`` when the
    journal REGRESSED (a restore replaced it with a snapshot — nothing
    previously proven fresh still is; the cursor repositions to
    the new tail).  A torn trailing line (crash mid-append) is left
    unconsumed until a later append terminates it; emit()'s tail
    isolation guarantees it eventually parses or is skipped."""

    def __init__(self, path: str):
        self.path = path
        self._offset = self._size()
        self.last_lsn = 0
        self.torn_lines = 0

    def _size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def poll(self) -> list[dict] | None:
        size = self._size()
        if size == self._offset:
            return []
        if size < self._offset:
            self._offset = size  # journal replaced: resubscribe at tail
            return None
        try:
            with open(self.path, "rb") as f:
                f.seek(self._offset)
                block = f.read(size - self._offset)
        except OSError:
            return []
        # consume only up to the last newline: a partial trailing line
        # is a write in flight (or a torn crash tail) — leave it for the
        # poll that sees its terminator
        end = block.rfind(b"\n")
        if end < 0:
            return []
        consumed = block[:end + 1]
        self._offset += end + 1
        events: list[dict] = []
        for line in consumed.splitlines():
            if not line.strip():
                continue
            try:
                ev = json.loads(line)
                ev_lsn = int(ev["lsn"])
            except (ValueError, KeyError):
                self.torn_lines += 1  # isolated torn line mid-journal
                continue
            self.last_lsn = max(self.last_lsn, ev_lsn)
            events.append(ev)
        return events


def rows_for(store, event: dict):
    """Materialize an event's row payload: (values, validity) dicts for
    inserts; the deleted rows' pre-image for deletes (positions-backed
    events only).  Late materialization keeps the journal small."""
    table = event["table"]
    shard_id = event["shard_id"]
    # the journal is shared across sessions but the manifest cache is
    # per-session: an event another session just committed may reference
    # a stripe our cache predates — adopt the on-disk manifest first
    store.refresh_if_stale(table)
    vals, mask, _n, _dm = store.read_stripe_raw(table, shard_id,
                                                event["file"])
    if event["kind"] == "insert":
        return vals, mask
    positions = event.get("positions")
    if positions is None:
        raise ValueError(
            "delete event has no inline positions (bulk delete); "
            "re-read the stripe's current bitmap instead")
    import numpy as np

    idx = np.asarray(positions, dtype=np.int64)
    return ({c: a[idx] for c, a in vals.items()},
            {c: a[idx] for c, a in mask.items()})
