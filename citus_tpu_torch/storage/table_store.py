"""Per-shard stripe management: manifests, dictionaries, append/scan.

Each table has a MANIFEST.json updated by atomic rename; a stripe becomes
visible when the manifest that lists it is flipped in.  The on-disk
layout, manifest JSON (with its embedded CRC), dictionary files and
stripe format are the JAX package's, bit for bit, so either package
opens a data_dir the other wrote.

Directory layout::

    <data_dir>/
      catalog.json
      tables/<table>/
        MANIFEST.json
        dict_<column>.json
        shard_<shard_id>/stripe_<n>.ctps

      shard_<shard_id>/stripe_<n>.ctps.delNNNN.npy   (deletion bitmaps)
      replica_<node>__shard_<shard_id>/stripe_<n>.ctps (placement copies)

The write path is the JAX package's: stripes written invisible
(commit=False) and flipped in by one manifest write (`commit_pending`),
DML as versioned per-stripe deletion bitmaps plus rewritten stripes in
one flip (`apply_dml`), every flip journalled to the change feed
(cdc/feed.py), fresh stripes copied to every other placement's replica
dir before the flip (`_mirror_records`), and the named fault seams of
utils/faultinjection.py.  An open transaction's staged records and
masks (`overlay`, transaction/manager.py) fold into every read.  Reads
come from the primary shard directory; the replica-failover read
(`verified_read`) comes with the replication slice.
"""

from __future__ import annotations

import os
import shutil
import threading

import numpy as np

from ..catalog import Catalog
from ..cdc import ChangeLog
from ..utils import io as dio
from ..utils.faultinjection import fault_point
from . import integrity
from .dictionary import Dictionary
from .format import StripeReader, write_stripe


def _column_stats(columns: dict[str, np.ndarray],
                  validity: dict[str, np.ndarray] | None) -> dict:
    """Per-column [min, max, null_count] over non-NULL values (JSON-safe
    scalars)."""
    out = {}
    for name, arr in columns.items():
        nulls = 0
        v = arr
        if validity is not None and name in validity:
            val = validity[name]
            nulls = int(len(val) - val.sum())
            v = arr[val]
        if arr.dtype == object or v.size == 0:
            out[name] = [None, None, nulls]
        elif np.issubdtype(v.dtype, np.floating):
            out[name] = [float(v.min()), float(v.max()), nulls]
        else:
            out[name] = [int(v.min()), int(v.max()), nulls]
    return out


# Process-wide per-(data_dir, table) manifest write locks: every manifest
# read-modify-write serializes and re-reads disk state first.
_manifest_write_locks: dict[tuple[str, str], threading.Lock] = {}
_mwl_mu = threading.Lock()


class TableStore:
    """Host-side storage manager for all tables under one data directory."""

    def __init__(self, data_dir: str, catalog: Catalog, settings=None):
        self.data_dir = data_dir
        self.catalog = catalog
        self.settings = settings
        self._lock = threading.RLock()
        self._manifests: dict[str, dict] = {}
        self._dicts: dict[tuple[str, str], Dictionary] = {}
        # per-table data version: bumped on every visible mutation; the
        # executor's feed cache keys on it
        self._data_versions: dict[str, int] = {}
        self._manifest_stats: dict[str, tuple] = {}
        # read-your-writes overlay, set by an open transaction
        # (transaction.manager.Transaction): staged-but-uncommitted stripe
        # records and deletion masks folded into every read
        self.overlay = None
        os.makedirs(os.path.join(data_dir, "tables"), exist_ok=True)
        # change feed journal, written at the manifest flips that make
        # changes visible
        self.change_log = ChangeLog(data_dir)

    # -- paths -------------------------------------------------------------
    def table_dir(self, table: str) -> str:
        return os.path.join(self.data_dir, "tables", table)

    def shard_dir(self, table: str, shard_id: int) -> str:
        return os.path.join(self.table_dir(table), f"shard_{shard_id}")

    def replica_dir(self, table: str, shard_id: int,
                    node_id: int) -> str:
        """Physical home of a non-primary placement's stripe copies."""
        return os.path.join(self.table_dir(table),
                            f"replica_{node_id}__shard_{shard_id}")

    def _manifest_path(self, table: str) -> str:
        return os.path.join(self.table_dir(table), "MANIFEST.json")

    @staticmethod
    def _stat_identity(path: str) -> tuple | None:
        try:
            st = os.stat(path)
            return (st.st_mtime_ns, st.st_size, st.st_ino)
        except OSError:
            return None

    def _verify_enabled(self) -> bool:
        if self.settings is None:
            return True
        return bool(self.settings.get("storage_verify_checksums"))

    # -- manifest ----------------------------------------------------------
    def manifest(self, table: str) -> dict:
        with self._lock:
            if table not in self._manifests:
                path = self._manifest_path(table)
                if os.path.exists(path):
                    # identity before content: a concurrent commit can at
                    # worst cost one redundant reload
                    ident = self._stat_identity(path)
                    self._manifests[table] = dio.read_json_checked(path)
                    if ident is not None:
                        self._manifest_stats[table] = ident
                    else:
                        self._manifest_stats.pop(table, None)
                else:
                    self._manifests[table] = {"next_stripe": 1, "shards": {}}
                    self._manifest_stats.pop(table, None)
            return self._manifests[table]

    def _save_manifest(self, table: str) -> None:
        # named seam: a kill here dies before the visibility flip — the
        # stripe/mask files exist but stay invisible (clean retry)
        fault_point("storage.manifest_flip")
        os.makedirs(self.table_dir(table), exist_ok=True)
        path = self._manifest_path(table)
        try:
            prev_mtime = os.stat(path).st_mtime_ns
        except OSError:
            prev_mtime = None
        dio.atomic_write_json_checked(path, self._manifests[table])
        if prev_mtime is not None:
            # identity must change on every commit (see the JAX package's
            # table_store for the lost-visibility case this closes)
            try:
                if os.stat(path).st_mtime_ns <= prev_mtime:
                    os.utime(path, ns=(prev_mtime + 1, prev_mtime + 1))
            except OSError:
                pass
        with self._lock:
            ident = self._stat_identity(path)
            if ident is not None:
                self._manifest_stats[table] = ident
            else:
                self._manifest_stats.pop(table, None)

    def refresh_if_stale(self, table: str) -> bool:
        """Reload the cached manifest iff another session committed a
        newer one to disk.  Returns True when a reload happened."""
        with self._lock:
            if table not in self._manifests:
                return False
            disk = self._stat_identity(self._manifest_path(table))
            if self._manifest_stats.get(table) == disk:
                return False
            self._manifests.pop(table, None)
            self.bump_data_version(table)
            return True

    def refresh(self, table: str) -> None:
        """Drop the cached manifest so the next read reloads from disk —
        used after lock acquisition so a session sharing this data_dir
        sees the lock winner's committed state."""
        with self._lock:
            self._manifests.pop(table, None)
            self.bump_data_version(table)

    def _write_lock(self, table: str) -> threading.Lock:
        key = (os.path.abspath(self.data_dir), table)
        with _mwl_mu:
            if key not in _manifest_write_locks:
                _manifest_write_locks[key] = threading.Lock()
            return _manifest_write_locks[key]

    def _reload_manifest_locked(self, table: str) -> dict:
        self._manifests.pop(table, None)
        return self.manifest(table)

    def data_version(self, table: str) -> int:
        with self._lock:
            return self._data_versions.get(table, 0)

    def bump_data_version(self, table: str) -> None:
        with self._lock:
            self._data_versions[table] = self._data_versions.get(table, 0) + 1

    def drop_table_storage(self, table: str) -> None:
        with self._lock:
            self._manifests.pop(table, None)
            self._manifest_stats.pop(table, None)
            self._dicts = {k: v for k, v in self._dicts.items()
                           if k[0] != table}
            self.bump_data_version(table)
            if os.path.exists(self.table_dir(table)):
                shutil.rmtree(self.table_dir(table))

    # -- dictionaries ------------------------------------------------------
    def storage_column_name(self, table: str, column: str) -> str:
        """Current column name → on-disk stripe/dictionary name (identity
        unless the JAX package's ALTER TABLE RENAME recorded a mapping)."""
        return self.manifest(table).get("renames", {}).get(column, column)

    def rename_column(self, table: str, old: str, new: str) -> None:
        """ALTER TABLE RENAME COLUMN bookkeeping: stripes keep the old
        on-disk name and the manifest maps the new name onto it."""
        with self._write_lock(table), self._lock:
            man = self.manifest(table)
            renames = man.setdefault("renames", {})
            storage = renames.pop(old, old)
            renames[new] = storage
            self._save_manifest(table)

    def retire_column(self, table: str, column: str) -> None:
        """DROP COLUMN bookkeeping: remember the on-disk name as dead so
        a later ADD COLUMN with the same name can never resurrect the
        dropped column's stripe data."""
        with self._write_lock(table), self._lock:
            man = self.manifest(table)
            storage = man.setdefault("renames", {}).pop(column, column)
            retired = man.setdefault("retired", [])
            if storage not in retired:
                retired.append(storage)
            self._save_manifest(table)

    def register_column(self, table: str, column: str) -> None:
        """ADD COLUMN bookkeeping: if the name collides with a retired
        storage name or another column's storage target (a rename left
        the old on-disk name in place), map the new column to a fresh
        storage name instead."""
        with self._write_lock(table), self._lock:
            man = self.manifest(table)
            renames = man.setdefault("renames", {})
            used = set(man.get("retired", [])) | set(renames.values())
            if column in used:
                i = 2
                while f"{column}__{i}" in used or \
                        f"{column}__{i}" in renames.values():
                    i += 1
                renames[column] = f"{column}__{i}"
                self._save_manifest(table)

    def dictionary(self, table: str, column: str) -> Dictionary:
        column = self.storage_column_name(table, column)
        with self._lock:
            key = (table, column)
            if key not in self._dicts:
                path = os.path.join(self.table_dir(table), f"dict_{column}.json")
                self._dicts[key] = (Dictionary.load(path)
                                    if os.path.exists(path) else Dictionary())
            return self._dicts[key]

    def save_dictionaries(self, table: str) -> None:
        with self._lock:
            os.makedirs(self.table_dir(table), exist_ok=True)
            for (t, col), d in self._dicts.items():
                if t == table:
                    d.save(os.path.join(self.table_dir(table), f"dict_{col}.json"))

    # -- write path --------------------------------------------------------
    def append_stripe(self, table: str, shard_id: int,
                      columns: dict[str, np.ndarray],
                      validity: dict[str, np.ndarray] | None = None,
                      codec: str = "zstd", level: int = 3,
                      chunk_rows: int = 10_000,
                      commit: bool = True) -> dict:
        """Write one stripe for a shard.  With commit=False the stripe file
        exists on disk but is invisible until `commit_pending` flips the
        manifest.  Returns the pending-stripe record."""
        fault_point("store.append_stripe")
        meta = self.catalog.table(table)
        ren = self.manifest(table).get("renames", {})
        if ren:
            columns = {ren.get(c, c): a for c, a in columns.items()}
            if validity is not None:
                validity = {ren.get(c, c): a
                            for c, a in validity.items()}
        schema_cols = [(ren.get(c.name, c.name), c.dtype)
                       for c in meta.schema.columns]
        with self._write_lock(table), self._lock:
            # persist the bumped counter before writing the file so a
            # crash + reopen can never re-allocate this stripe number
            man = self._reload_manifest_locked(table)
            stripe_no = man["next_stripe"]
            man["next_stripe"] = stripe_no + 1
            self._save_manifest(table)
            os.makedirs(self.shard_dir(table, shard_id), exist_ok=True)
            fname = f"stripe_{stripe_no:06d}.ctps"
            path = os.path.join(self.shard_dir(table, shard_id), fname)
        footer = write_stripe(path, schema_cols, columns, validity,
                              codec=codec, level=level, chunk_rows=chunk_rows)
        record = {"file": fname, "rows": footer["row_count"],
                  "bytes": os.path.getsize(path),
                  "stats": _column_stats(columns, validity)}
        if commit:
            self.commit_pending(table, [(shard_id, record)])
        return record

    # -- placement copies (replication factor >= 2) -------------------------
    def _primary_owner(self, shard_id: int):
        """Placement whose physical copy is the plain shard dir: the
        lowest placement_id ever allocated for the shard."""
        ps = self.catalog.all_shard_placements(shard_id)
        return ps[0] if ps else None

    def _mirror_records(self, table: str,
                        pending: list[tuple[int, dict]]) -> None:
        """Copy freshly committed stripe files to every other active
        placement's replica dir — the physical half of
        shard_replication_factor.  Runs before the manifest flip: a
        committed stripe always has its replica copies on disk.
        Hash-distributed tables only; reference and local tables keep
        one shared copy, as in the JAX package."""
        from ..catalog import DistributionMethod

        meta = self.catalog.tables.get(table)
        if meta is None or meta.method != DistributionMethod.HASH:
            return
        for shard_id, rec in pending:
            ps = self.catalog.shard_placements(shard_id)
            if len(ps) < 2:
                continue
            owner = self._primary_owner(shard_id)
            src = os.path.join(self.shard_dir(table, shard_id),
                               rec["file"])
            if not os.path.exists(src):
                continue  # recovery replay after a post-flip crash
            for p in ps:
                if owner is not None and \
                        p.placement_id == owner.placement_id:
                    continue
                d = self.replica_dir(table, shard_id, p.node_id)
                dst = os.path.join(d, rec["file"])
                if os.path.exists(dst):
                    continue  # idempotent replay
                os.makedirs(d, exist_ok=True)
                dio.copy_file_durable(src, dst)

    def _copy_paths(self, table: str, shard_id: int,
                    fname: str) -> list[str]:
        """Every on-disk copy of one stripe file, primary first."""
        out = [os.path.join(self.shard_dir(table, shard_id), fname)]
        suffix = f"__shard_{shard_id}"
        try:
            entries = sorted(os.listdir(self.table_dir(table)))
        except OSError:
            return out
        for e in entries:
            if e.startswith("replica_") and e.endswith(suffix):
                p = os.path.join(self.table_dir(table), e, fname)
                if os.path.exists(p):
                    out.append(p)
        return out

    def commit_pending(self, table: str,
                       pending: list[tuple[int, dict]]) -> None:
        """Atomically make a batch of stripes visible: one manifest write.
        Dictionaries are persisted first so a committed STRING stripe can
        never reference codes missing from the on-disk dictionary."""
        # replica copies before the locks (immutable, uniquely named
        # files) yet before the flip
        self._mirror_records(table, pending)
        with self._write_lock(table), self._lock:
            self.save_dictionaries(table)
            man = self._reload_manifest_locked(table)
            for shard_id, record in pending:
                man["shards"].setdefault(str(shard_id), []).append(record)
                stripe_no = int(record["file"].split("_")[1].split(".")[0])
                man["next_stripe"] = max(man["next_stripe"], stripe_no + 1)
            self._save_manifest(table)
            self.bump_data_version(table)
            # change feed after the durable flip: a crash in between
            # loses the event (at-most-once) but never emits a phantom
            self.change_log.emit([
                self.change_log.insert_event(table, sid, rec)
                for sid, rec in pending])

    # -- DML (deletion bitmaps) -------------------------------------------
    # Every table is columnar, so DML uses per-stripe deletion bitmaps:
    # DELETE marks rows, UPDATE = delete + append, both made visible by
    # ONE manifest write.

    def _delete_mask_path(self, table: str, shard_id: int, fname: str) -> str:
        return os.path.join(self.shard_dir(table, shard_id), fname)

    def load_delete_mask(self, table: str, shard_id: int,
                         record: dict) -> np.ndarray | None:
        fname = record.get("deletes")
        if not fname:
            return None
        return integrity.read_mask(
            self._delete_mask_path(table, shard_id, fname))

    # -- transaction overlay ----------------------------------------------
    def _overlay_records(self, table: str, shard_id: int) -> list[dict]:
        if self.overlay is None:
            return []
        return self.overlay.records.get((table, shard_id), [])

    def _overlay_mask(self, table: str, shard_id: int,
                      fname: str) -> np.ndarray | None:
        if self.overlay is None:
            return None
        return self.overlay.deletes.get((table, shard_id, fname))

    def effective_delete_mask(self, table: str, shard_id: int,
                              record: dict) -> np.ndarray | None:
        """On-disk deletion bitmap OR the open transaction's staged one."""
        disk = self.load_delete_mask(table, shard_id, record)
        staged = self._overlay_mask(table, shard_id, record["file"])
        if staged is None:
            return disk
        return staged if disk is None else (disk | staged)

    def apply_dml(self, table: str,
                  deletes: dict[int, dict[str, np.ndarray]],
                  pending: list[tuple[int, dict]] = ()) -> None:
        """Atomically apply a DML effect: per-stripe delete masks (True =
        row now dead) plus newly written (commit=False) stripes, all made
        visible by a single manifest write.  Delete-mask files are
        versioned, never overwritten in place, so a crash before the
        manifest flip leaves only orphan files."""
        fault_point("store.apply_dml")
        events: list[dict] = []
        self._mirror_records(table, list(pending))
        with self._write_lock(table), self._lock:
            self.save_dictionaries(table)
            man = self._reload_manifest_locked(table)
            stale: list[str] = []
            # pending stripes first so a staged delete may target a stripe
            # committed by this very call (transactional UPDATE-after-INSERT)
            for shard_id, record in pending:
                recs = man["shards"].setdefault(str(shard_id), [])
                if any(r["file"] == record["file"] for r in recs):
                    continue  # crash-recovery replay: already applied
                recs.append(record)
                stripe_no = int(record["file"].split("_")[1].split(".")[0])
                man["next_stripe"] = max(man["next_stripe"], stripe_no + 1)
                events.append(self.change_log.insert_event(
                    table, shard_id, record))
            for shard_id, per_stripe in deletes.items():
                records = man["shards"].get(str(shard_id), [])
                by_file = {r["file"]: r for r in records}
                for fname, mask in per_stripe.items():
                    if not mask.any():
                        continue
                    rec = by_file[fname]
                    if len(mask) != rec["rows"]:
                        raise ValueError(
                            f"{table}/{fname}: delete mask length "
                            f"{len(mask)} != stripe rows {rec['rows']}")
                    old = self.load_delete_mask(table, shard_id, rec)
                    newly = mask if old is None else (mask & ~old)
                    if newly.any():
                        events.append(self.change_log.delete_event(
                            table, shard_id, fname, newly))
                    combined = mask if old is None else (old | mask)
                    version = rec.get("del_version", 0) + 1
                    delname = f"{fname}.del{version:04d}.npy"
                    path = self._delete_mask_path(table, shard_id, delname)
                    integrity.write_mask(path, combined)
                    if rec.get("deletes"):
                        stale.append(self._delete_mask_path(
                            table, shard_id, rec["deletes"]))
                    rec["deletes"] = delname
                    rec["del_version"] = version
                    rec["live_rows"] = int((~combined).sum())
            self._save_manifest(table)
            self.bump_data_version(table)
            self.change_log.emit(events)
            for path in stale:
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def remove_shard_records(self, table: str, shard_id: int) -> None:
        """Drop a shard's manifest entries (split/cleanup: the shard's
        rows now live in successor shards)."""
        with self._write_lock(table), self._lock:
            man = self._reload_manifest_locked(table)
            if str(shard_id) in man["shards"]:
                del man["shards"][str(shard_id)]
                self._save_manifest(table)
                self.bump_data_version(table)

    def read_stripe_raw(self, table: str, shard_id: int, fname: str,
                        columns: list[str] | None = None,
                        record: dict | None = None,
                        ) -> tuple[dict, dict, int, np.ndarray | None]:
        """Read one stripe WITHOUT applying its deletion bitmap; returns
        (values, validity, rows, delete_mask|None) so DML sees physical
        row positions.  Columns are keyed by the requested (current)
        names; a column added after the stripe was written reads as
        NULL.  Pass the manifest `record` (from shard_stripe_records) to
        skip the manifest rescan."""
        if record is None:
            record = next(r for r in self.shard_stripe_records(table,
                                                               shard_id)
                          if r["file"] == fname)
        meta = self.catalog.table(table)
        columns = columns or meta.schema.names
        storage_of = {c: self.storage_column_name(table, c)
                      for c in columns}
        reader = StripeReader(
            os.path.join(self.shard_dir(table, shard_id), fname),
            verify=self._verify_enabled())
        present = [c for c in columns
                   if storage_of[c] in reader._by_name]
        v, m, n = reader.read([storage_of[c] for c in present])
        vals = {c: v[storage_of[c]] for c in present}
        mask = {c: m[storage_of[c]] for c in present}
        for c in columns:
            if c not in vals:
                dt = meta.schema.column(c).dtype.numpy_dtype
                vals[c] = np.zeros(n, dtype=dt)
                mask[c] = np.zeros(n, dtype=np.bool_)
        return vals, mask, n, self.effective_delete_mask(table, shard_id,
                                                         record)

    def discard_pending(self, table: str,
                        pending: list[tuple[int, dict]]) -> None:
        with self._lock:
            for shard_id, record in pending:
                path = os.path.join(self.shard_dir(table, shard_id),
                                    record["file"])
                if os.path.exists(path):
                    os.unlink(path)

    # -- read path ---------------------------------------------------------
    def shard_stripe_records(self, table: str, shard_id: int) -> list[dict]:
        """Copies of a shard's visible stripe records, in manifest order,
        then the open transaction's staged ones."""
        man = self.manifest(table)
        return ([dict(r) for r in man["shards"].get(str(shard_id), [])]
                + [dict(r) for r in self._overlay_records(table, shard_id)])

    def _record_lists(self, table: str) -> list[list[dict]]:
        """Committed and staged stripe records of `table`, per shard."""
        rec_lists = list(self.manifest(table)["shards"].values())
        if self.overlay is not None:
            rec_lists.extend(recs for (t, _sid), recs
                             in self.overlay.records.items() if t == table)
        return rec_lists

    def column_range(self, table: str,
                     column: str) -> tuple[float, float] | None:
        """Table-wide (min, max) for a numeric/date column from manifest
        stripe stats, staged stripes included (their keys must widen a
        dense grid's extent).  None when no stripe carries stats or the
        column is all-NULL."""
        column = self.storage_column_name(table, column)
        lo = hi = None
        for recs in self._record_lists(table):
            for r in recs:
                s = (r.get("stats") or {}).get(column)
                if s is None:
                    return None
                if s[0] is None:
                    continue
                lo = s[0] if lo is None else min(lo, s[0])
                hi = s[1] if hi is None else max(hi, s[1])
        if lo is None:
            return None
        return lo, hi

    def column_has_nulls(self, table: str, column: str) -> bool | None:
        """Whether any committed or staged stripe holds a NULL in
        `column` (None = unknown).  Conservative under deletes: a deleted
        NULL still counts."""
        column = self.storage_column_name(table, column)
        for recs in self._record_lists(table):
            for r in recs:
                s = (r.get("stats") or {}).get(column)
                if s is None or len(s) < 3:
                    return None
                if s[2] > 0:
                    return True
        return False

    def shard_row_count(self, table: str, shard_id: int) -> int:
        """Live rows of one shard, the open transaction's staged rows
        and deletes included."""
        man = self.manifest(table)
        total = 0
        for r in man["shards"].get(str(shard_id), []):
            total += r.get("live_rows", r["rows"])
            staged = self._overlay_mask(table, shard_id, r["file"])
            if staged is not None:
                disk = self.load_delete_mask(table, shard_id, r)
                newly = staged if disk is None else (staged & ~disk)
                total -= int(newly.sum())
        for r in self._overlay_records(table, shard_id):
            staged = self._overlay_mask(table, shard_id, r["file"])
            total += (r["rows"] if staged is None
                      else int((~staged).sum()))
        return total

    def shard_size_bytes(self, table: str, shard_id: int) -> int:
        man = self.manifest(table)
        return sum(r["bytes"] for r in man["shards"].get(str(shard_id), []))

    def table_row_count(self, table: str) -> int:
        man = self.manifest(table)
        if self.overlay is None:
            return sum(r.get("live_rows", r["rows"])
                       for recs in man["shards"].values() for r in recs)
        return sum(self.shard_row_count(table, int(sid))
                   for sid in set(man["shards"])
                   | {str(s) for t, s in self.overlay.records if t == table})

    def iter_shard_stripes(self, table: str, shard_id: int,
                           columns: list[str] | None = None,
                           chunk_filter=None):
        """Yield (values, validity, live_rows) per visible stripe, the
        open transaction's staged stripes and masks included."""
        meta = self.catalog.table(table)
        columns = columns or meta.schema.names
        storage_of = {c: self.storage_column_name(table, c)
                      for c in columns}
        requested_of = {s: c for c, s in storage_of.items()}
        man = self.manifest(table)
        records = (list(man["shards"].get(str(shard_id), []))
                   + self._overlay_records(table, shard_id))
        verify = self._verify_enabled()
        for rec in records:
            dmask = self.effective_delete_mask(table, shard_id, rec)
            path = os.path.join(self.shard_dir(table, shard_id), rec["file"])
            reader = StripeReader(path, verify=verify)
            # columns added after this stripe was written read as NULL
            present = [storage_of[c] for c in columns
                       if storage_of[c] in reader._by_name]
            missing = [c for c in columns
                       if storage_of[c] not in reader._by_name]
            if present or not missing:
                # a stripe with deletions reads whole (positions must
                # align with the bitmap)
                v, m, n = reader.read(
                    present, None if dmask is not None else chunk_filter)
                v = {requested_of[s]: a for s, a in v.items()}
                m = {requested_of[s]: a for s, a in m.items()}
            else:
                v, m, n = {}, {}, reader.row_count
            for c in missing:
                dt = meta.schema.column(c).dtype.numpy_dtype
                v[c] = np.zeros(n, dtype=dt)
                m[c] = np.zeros(n, dtype=np.bool_)
            if dmask is not None:
                keep = ~dmask
                v = {c: a[keep] for c, a in v.items()}
                m = {c: a[keep] for c, a in m.items()}
                n = int(keep.sum())
            yield v, m, n

    def read_shard(self, table: str, shard_id: int,
                   columns: list[str] | None = None, chunk_filter=None,
                   ) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray], int]:
        """Concatenate all visible stripes of one shard (projected)."""
        meta = self.catalog.table(table)
        columns = columns or meta.schema.names
        vals: dict[str, list[np.ndarray]] = {c: [] for c in columns}
        mask: dict[str, list[np.ndarray]] = {c: [] for c in columns}
        total = 0
        for v, m, n in self.iter_shard_stripes(table, shard_id, columns,
                                               chunk_filter):
            total += n
            for c in columns:
                vals[c].append(v[c])
                mask[c].append(m[c])
        out_v = {}
        out_m = {}
        for c in columns:
            dtype = meta.schema.column(c).dtype
            out_v[c] = (np.concatenate(vals[c]) if vals[c]
                        else np.empty(0, dtype=dtype.numpy_dtype))
            out_m[c] = (np.concatenate(mask[c]) if mask[c]
                        else np.empty(0, dtype=np.bool_))
        return out_v, out_m, total
