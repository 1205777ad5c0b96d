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

This copy carries the single-writer append and scan paths only: no
transaction overlay, change feed, replica mirroring or fault seams.
Stripes read from the primary shard directory; deletion bitmaps written
by the JAX package's DML are honoured on read.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from ..catalog import Catalog
from ..utils import io as dio
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
        os.makedirs(os.path.join(data_dir, "tables"), exist_ok=True)

    # -- paths -------------------------------------------------------------
    def table_dir(self, table: str) -> str:
        return os.path.join(self.data_dir, "tables", table)

    def shard_dir(self, table: str, shard_id: int) -> str:
        return os.path.join(self.table_dir(table), f"shard_{shard_id}")

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

    # -- dictionaries ------------------------------------------------------
    def storage_column_name(self, table: str, column: str) -> str:
        """Current column name → on-disk stripe/dictionary name (identity
        unless the JAX package's ALTER TABLE RENAME recorded a mapping)."""
        return self.manifest(table).get("renames", {}).get(column, column)

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

    def commit_pending(self, table: str,
                       pending: list[tuple[int, dict]]) -> None:
        """Atomically make a batch of stripes visible: one manifest write.
        Dictionaries are persisted first so a committed STRING stripe can
        never reference codes missing from the on-disk dictionary."""
        with self._write_lock(table), self._lock:
            self.save_dictionaries(table)
            man = self._reload_manifest_locked(table)
            for shard_id, record in pending:
                man["shards"].setdefault(str(shard_id), []).append(record)
                stripe_no = int(record["file"].split("_")[1].split(".")[0])
                man["next_stripe"] = max(man["next_stripe"], stripe_no + 1)
            self._save_manifest(table)
            self.bump_data_version(table)

    def discard_pending(self, table: str,
                        pending: list[tuple[int, dict]]) -> None:
        with self._lock:
            for shard_id, record in pending:
                path = os.path.join(self.shard_dir(table, shard_id),
                                    record["file"])
                if os.path.exists(path):
                    os.unlink(path)

    # -- read path ---------------------------------------------------------
    def load_delete_mask(self, table: str, shard_id: int,
                         record: dict) -> np.ndarray | None:
        fname = record.get("deletes")
        if not fname:
            return None
        return integrity.read_mask(
            os.path.join(self.shard_dir(table, shard_id), fname))

    def column_range(self, table: str,
                     column: str) -> tuple[float, float] | None:
        """Table-wide (min, max) for a numeric/date column from manifest
        stripe stats.  None when no stripe carries stats or the column
        is all-NULL."""
        column = self.storage_column_name(table, column)
        man = self.manifest(table)
        lo = hi = None
        for recs in man["shards"].values():
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
        """Whether any committed stripe holds a NULL in `column` (None =
        unknown)."""
        column = self.storage_column_name(table, column)
        man = self.manifest(table)
        for recs in man["shards"].values():
            for r in recs:
                s = (r.get("stats") or {}).get(column)
                if s is None or len(s) < 3:
                    return None
                if s[2] > 0:
                    return True
        return False

    def table_row_count(self, table: str) -> int:
        man = self.manifest(table)
        return sum(r.get("live_rows", r["rows"])
                   for recs in man["shards"].values() for r in recs)

    def iter_shard_stripes(self, table: str, shard_id: int,
                           columns: list[str] | None = None,
                           chunk_filter=None):
        """Yield (values, validity, live_rows) per visible stripe."""
        meta = self.catalog.table(table)
        columns = columns or meta.schema.names
        storage_of = {c: self.storage_column_name(table, c)
                      for c in columns}
        requested_of = {s: c for c, s in storage_of.items()}
        man = self.manifest(table)
        verify = self._verify_enabled()
        for rec in list(man["shards"].get(str(shard_id), [])):
            dmask = self.load_delete_mask(table, shard_id, rec)
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
