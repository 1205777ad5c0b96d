"""Self-healing storage scrubber: verify, quarantine, re-replicate.

Counterpart of citus_tpu/operations/scrubber.py.  The reference's
closest analogue is running amcheck / pg_checksums over every node from
cron and re-creating broken placements by hand; here detection and
healing are built in.  One scrub pass, per table shard:

1. **verify** every physical copy of every committed stripe file (the
   primary shard dir plus each ``replica_<node>__shard_<sid>`` mirror)
   with the full CRC pass (footer + every chunk), and every deletion
   bitmap structurally;
2. **quarantine** a placement whose copy is damaged — but only while
   the shard keeps another placement (quarantining the last copy would
   make the shard unroutable; factor-1 damage is reported, and reads
   keep failing with a clean CorruptStripe);
3. **re-replicate** through `shard_transfer.repair_shard_placement`:
   rewrite the damaged copy from a verified one, verify the rewrite,
   restore the placement to ``active`` and clear its suspect mark;
4. **GC** orphan temp files older than ``scrub_temp_max_age_s`` and
   replica dirs of shards that left the catalog (splits, moves).

Runs as a background job behind ``citus_check_cluster()`` and as an
optional maintenance-daemon duty (``scrub_interval_ms``).
"""

from __future__ import annotations

import os
import shutil
import time
from dataclasses import dataclass, field

from ..errors import CorruptStripe
from ..stats import counters as sc
from ..storage import integrity
from ..utils.io import is_tmp_artifact
from .shard_transfer import repair_shard_placement


@dataclass
class ScrubReport:
    stripes_verified: int = 0
    masks_verified: int = 0
    corrupt_copies: int = 0
    quarantined: int = 0
    repaired: int = 0
    unrepairable: int = 0
    temps_removed: int = 0
    replica_dirs_removed: int = 0
    details: list[str] = field(default_factory=list)


def scrub_store(catalog, store, report: ScrubReport | None = None,
                temp_max_age_s: float = 0.0) -> ScrubReport:
    """One full scrub pass over every table, shard and copy of a store."""
    rep = report or ScrubReport()
    for table in sorted(catalog.tables):
        try:
            store.manifest(table)
        except CorruptStripe as e:
            # a corrupt manifest makes the table unscannable, but the
            # scrub still covers every other table and runs the GC
            rep.unrepairable += 1
            rep.details.append(str(e))
            continue
        for shard in catalog.table_shards(table):
            _scrub_shard(catalog, store, table, shard.shard_id, rep)
    _gc_orphans(catalog, store, rep, temp_max_age_s)
    return rep


def _scrub_shard(catalog, store, table: str, shard_id: int,
                 rep: ScrubReport) -> None:
    records = store.manifest(table)["shards"].get(str(shard_id), [])
    good_by_file: dict[str, str] = {}
    bad: list[tuple[str, str]] = []  # (fname, corrupt path)
    for rec in records:
        for path in store._copy_paths(table, shard_id, rec["file"]):
            try:
                integrity.verify_stripe_file(path)
            except CorruptStripe as e:
                integrity.note("corruption_detected")
                rep.corrupt_copies += 1
                rep.details.append(str(e))
                bad.append((rec["file"], path))
                continue
            rep.stripes_verified += 1
            good_by_file.setdefault(rec["file"], path)
        if rec.get("deletes"):
            mpath = store._delete_mask_path(table, shard_id,
                                            rec["deletes"])
            try:
                integrity.read_mask(mpath)
            except CorruptStripe as e:
                # masks have no replica copy: unrepairable, and the
                # pass goes on to the next shard
                integrity.note("corruption_detected")
                rep.corrupt_copies += 1
                rep.unrepairable += 1
                rep.details.append(str(e))
            else:
                rep.masks_verified += 1
    for fname, path in bad:
        placement = store._placement_of_copy(shard_id, path)
        source = good_by_file.get(fname)
        if source is None or placement is None:
            rep.unrepairable += 1
            rep.details.append(
                f"{table}/shard {shard_id}/{fname}: no verified copy "
                "to repair from (add replicas or restore a snapshot)")
            continue
        # quarantine only while another placement keeps the shard
        # routable; a lone placement goes straight to in-place repair
        others = [p for p in catalog.shard_placements(shard_id)
                  if p.placement_id != placement.placement_id]
        if others and placement.shard_state == "active":
            catalog.set_placement_state(placement.placement_id,
                                        "quarantined")
            rep.quarantined += 1
        try:
            repair_shard_placement(catalog, placement, source, path)
        except (OSError, CorruptStripe) as e:
            # a failed rewrite leaves the placement quarantined (the
            # shard stays routable via the healthy replica)
            rep.unrepairable += 1
            rep.details.append(f"{table}/shard {shard_id}/{fname}: "
                               f"repair failed ({e})")
            continue
        rep.repaired += 1


def _gc_orphans(catalog, store, rep: ScrubReport,
                temp_max_age_s: float) -> None:
    """Remove crash debris: aged temp files under the data dir's durable
    state, and replica dirs of shards the catalog no longer knows."""
    now = time.time()
    for root in (os.path.join(store.data_dir, "tables"),
                 os.path.join(store.data_dir, "txnlog")):
        for dpath, _dirs, files in os.walk(root):
            for f in files:
                if not is_tmp_artifact(f):
                    continue
                p = os.path.join(dpath, f)
                try:
                    if now - os.path.getmtime(p) >= temp_max_age_s:
                        os.unlink(p)
                        rep.temps_removed += 1
                except OSError:
                    continue  # a racing writer published or removed it
    tables_root = os.path.join(store.data_dir, "tables")
    if not os.path.isdir(tables_root):
        return
    live = set(catalog.shards)
    for table in sorted(os.listdir(tables_root)):
        tdir = os.path.join(tables_root, table)
        if not os.path.isdir(tdir):
            continue
        for e in sorted(os.listdir(tdir)):
            if not (e.startswith("replica_") and "__shard_" in e):
                continue
            try:
                sid = int(e.split("__shard_", 1)[1])
            except ValueError:
                continue
            if sid not in live:
                shutil.rmtree(os.path.join(tdir, e), ignore_errors=True)
                rep.replica_dirs_removed += 1


def scrub_session(session, temp_max_age_s: float | None = None,
                  background: bool = True) -> ScrubReport:
    """Session-level scrub: runs as a background job (admitted at the
    workload manager's `background` class) and folds the outcome into
    the session counters."""
    if temp_max_age_s is None:
        temp_max_age_s = session.settings.get("scrub_temp_max_age_s")
    rep = ScrubReport()

    def run():
        scrub_store(session.catalog, session.store, rep,
                    temp_max_age_s=temp_max_age_s)
        return rep

    if background:
        job_id = session.jobs.submit_job(
            "storage scrub", [(run, "verify+repair all placements", [])])
        session.jobs.wait(job_id)
        task = next(iter(session.jobs.job_status(job_id).tasks.values()))
        if task.error:
            raise CorruptStripe(f"scrub failed: {task.error}")
    else:
        run()
    if rep.quarantined or rep.repaired:
        session._save_catalog()
    c = session.stats.counters
    c.increment(sc.SCRUB_RUNS_TOTAL)
    if rep.repaired:
        c.increment(sc.SCRUB_REPAIRS_TOTAL, rep.repaired)
    return rep
