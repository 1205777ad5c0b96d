"""Cluster-consistent restore points.

Counterpart of citus_tpu/operations/restore_point.py, with the same
snapshot layout (``<data_dir>/restore_points/<name>/``), so either
package restores the other's points.  The reference's
citus_create_restore_point blocks distributed commits, then creates a
named WAL restore point on every node in one distributed transaction
(Citus src/backend/distributed/operations/
citus_create_restore_point.c).

Here a restore point is a self-contained snapshot directory holding
every piece of cluster metadata (catalog, per-table manifests,
dictionaries, the txn log, the cleanup registry, the change journal)
plus HARDLINKS to the referenced stripe and deletion-bitmap files.
Stripes are immutable and every metadata write is tmp+rename, so
hardlinks freeze the bytes for free: deferred cleanup can unlink the
originals without touching the snapshot.  Consistency comes from taking
the store lock across the metadata copy — the serialization point every
manifest flip passes through.
"""

from __future__ import annotations

import os
import shutil

from ..errors import CatalogError, CorruptStripe
from ..replication import rotate_history
from ..serving.result_cache import reset_serving_state
from ..storage import integrity
from ..utils.io import is_tmp_artifact, read_json_checked


def _restore_dir(data_dir: str, name: str) -> str:
    if not name or "/" in name or name.startswith("."):
        raise CatalogError(f"invalid restore point name {name!r}")
    return os.path.join(data_dir, "restore_points", name)


def _link_or_copy(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)  # cross-device fallback


def create_restore_point(session, name: str) -> str:
    """Snapshot the whole cluster state under restore_points/<name>."""
    data_dir = session.data_dir
    dest = _restore_dir(data_dir, name)
    if os.path.exists(dest):
        raise CatalogError(f"restore point {name!r} already exists")
    tmp = dest + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    store = session.store
    with store._lock:  # the manifest-flip serialization point
        for table in list(session.catalog.tables):
            store.save_dictionaries(table)
        session.catalog.save(os.path.join(tmp, "catalog.json"))
        for fname in ("cleanup.json", "cdc_changes.jsonl"):
            src = os.path.join(data_dir, fname)
            if os.path.exists(src):
                shutil.copy2(src, os.path.join(tmp, fname))
        txnlog = os.path.join(data_dir, "txnlog")
        if os.path.isdir(txnlog):
            shutil.copytree(txnlog, os.path.join(tmp, "txnlog"))
        tables_root = os.path.join(data_dir, "tables")
        for table in (sorted(os.listdir(tables_root))
                      if os.path.isdir(tables_root) else []):
            tsrc = os.path.join(tables_root, table)
            tdst = os.path.join(tmp, "tables", table)
            os.makedirs(tdst)
            for entry in sorted(os.listdir(tsrc)):
                src = os.path.join(tsrc, entry)
                dst = os.path.join(tdst, entry)
                if os.path.isdir(src):  # shard dir: hardlink data files
                    os.makedirs(dst)
                    for f in sorted(os.listdir(src)):
                        # another session may be streaming a stripe
                        # right now: its torn tmp stays out
                        if is_tmp_artifact(f):
                            continue
                        _link_or_copy(os.path.join(src, f),
                                      os.path.join(dst, f))
                elif not is_tmp_artifact(entry):
                    shutil.copy2(src, dst)  # manifest / dict files
    os.rename(tmp, dest)
    return name


def list_restore_points(data_dir: str) -> list[str]:
    root = os.path.join(data_dir, "restore_points")
    if not os.path.isdir(root):
        return []
    return sorted(p for p in os.listdir(root) if not p.endswith(".tmp"))


def verify_restore_point(src: str) -> int:
    """Full integrity pass over a snapshot BEFORE it may replace live
    data: the catalog and every manifest parse with valid embedded CRCs,
    every stripe file a manifest references exists and passes the
    footer + chunk CRC verification, every deletion bitmap loads.
    Raises CorruptStripe naming the damage; returns the number of
    stripe files verified."""
    cat_path = os.path.join(src, "catalog.json")
    if os.path.exists(cat_path):
        read_json_checked(cat_path)
    verified = 0
    tables_root = os.path.join(src, "tables")
    for table in (sorted(os.listdir(tables_root))
                  if os.path.isdir(tables_root) else []):
        tdir = os.path.join(tables_root, table)
        man_path = os.path.join(tdir, "MANIFEST.json")
        if not os.path.exists(man_path):
            continue
        man = read_json_checked(man_path)
        for sid, records in man.get("shards", {}).items():
            sdir = os.path.join(tdir, f"shard_{sid}")
            for rec in records:
                spath = os.path.join(sdir, rec["file"])
                if not os.path.exists(spath):
                    raise CorruptStripe(
                        f"restore point is damaged: {table}/shard {sid}"
                        f"/{rec['file']} referenced by the manifest is "
                        "missing from the snapshot")
                integrity.verify_stripe_file(spath)
                verified += 1
                if rec.get("deletes"):
                    integrity.read_mask(os.path.join(sdir,
                                                     rec["deletes"]))
    return verified


def restore_cluster(data_dir: str, name: str) -> None:
    """Roll a data directory back to a restore point.

    Out-of-band like the reference's PITR: run with NO live session on
    the directory, then open a fresh Session.  Current state is replaced
    wholesale; stripes restore as hardlinks.  The snapshot is
    checksum-verified first — a damaged restore point refuses cleanly
    with live data untouched."""
    src = _restore_dir(data_dir, name)
    if not os.path.isdir(src):
        raise CatalogError(f"unknown restore point {name!r}")
    verify_restore_point(src)
    for fname in ("catalog.json", "cleanup.json", "cdc_changes.jsonl"):
        live = os.path.join(data_dir, fname)
        snap = os.path.join(src, fname)
        if os.path.exists(snap):
            shutil.copy2(snap, live)
        elif os.path.exists(live):
            os.unlink(live)
    live_txn = os.path.join(data_dir, "txnlog")
    shutil.rmtree(live_txn, ignore_errors=True)
    snap_txn = os.path.join(src, "txnlog")
    if os.path.isdir(snap_txn):
        shutil.copytree(snap_txn, live_txn)
    live_tables = os.path.join(data_dir, "tables")
    shutil.rmtree(live_tables, ignore_errors=True)
    os.makedirs(live_tables)
    snap_tables = os.path.join(src, "tables")
    if os.path.isdir(snap_tables):
        for table in sorted(os.listdir(snap_tables)):
            tsrc = os.path.join(snap_tables, table)
            tdst = os.path.join(live_tables, table)
            os.makedirs(tdst)
            for entry in sorted(os.listdir(tsrc)):
                s = os.path.join(tsrc, entry)
                d = os.path.join(tdst, entry)
                if os.path.isdir(s):
                    os.makedirs(d)
                    for f in sorted(os.listdir(s)):
                        _link_or_copy(os.path.join(s, f),
                                      os.path.join(d, f))
                else:
                    shutil.copy2(s, d)
    # the result cache holds answers keyed to the storage just replaced
    reset_serving_state(data_dir)
    # the journal just regressed wholesale: a new timeline makes every
    # next ship a reseed, so followers restage from scratch instead of
    # applying deltas from a history that no longer exists
    rotate_history(data_dir)
