"""Coordinated transactions: staged writes, 2PC-style commit log, recovery.

Counterpart of citus_tpu/transaction/manager.py, with the same on-disk
log (`txnlog/txn_<txid>/prepare.json`, `mask_NNNN.npy`, `commit`), so
either package recovers a transaction the other left behind.

Reference semantics (Citus src/backend/distributed/transaction/):

* `transaction_management.c:311` CoordinatedTransactionCallback — writes on
  multiple nodes use PREPARE TRANSACTION on each worker, a commit record in
  `pg_dist_transaction` on the coordinator, then COMMIT PREPARED.
* `transaction_recovery.c` — the maintenance daemon finishes interrupted
  2PCs: commit record present → COMMIT PREPARED, absent → ROLLBACK.

TPU-native mapping: "workers" are per-table manifests.  A transaction
stages stripe files (written commit=False, invisible) and deletion masks
in memory + a read overlay (read-your-writes); COMMIT is the 2PC dance:

  1. PREPARE — staged masks are persisted under txnlog/ and a prepare
     record (JSON) lists every staged effect;
  2. commit record — atomic rename of `<txid>.commit` (the
     pg_dist_transaction INSERT analogue);
  3. apply — one apply_dml per table (idempotent: replay-safe);
  4. cleanup — log files removed.

`recover_transactions()` (run when a Session opens its data_dir) rolls
forward transactions with a commit record and discards the rest —
exactly the reference's recovery rule.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np

from ..errors import ExecutionError
from ..storage import integrity
from .clock import global_clock


# per-txnlog-dir commit/recovery mutex: a recovery pass (another
# session opening the data_dir) must never reap a txn directory an
# in-flight COMMIT of this process is still writing
_txnlog_locks: dict[str, threading.Lock] = {}
_txnlog_locks_mu = threading.Lock()


def _txnlog_lock(log_dir: str) -> threading.Lock:
    key = os.path.abspath(log_dir)
    with _txnlog_locks_mu:
        if key not in _txnlog_locks:
            _txnlog_locks[key] = threading.Lock()
        return _txnlog_locks[key]


class Overlay:
    """Uncommitted effects folded into TableStore reads."""

    def __init__(self):
        # (table, shard_id) -> [stripe record, ...]
        self.records: dict[tuple[str, int], list[dict]] = {}
        # (table, shard_id, fname) -> staged deletion mask
        self.deletes: dict[tuple[str, int, str], np.ndarray] = {}


class Transaction:
    def __init__(self, txid: int, log_dir: str):
        self.txid = txid
        self.log_dir = log_dir
        self.overlay = Overlay()
        self.tables: set[str] = set()

    # -- staging (the "remote write" analogue) -----------------------------
    def stage_dml(self, table: str,
                  deletes: dict[int, dict[str, np.ndarray]],
                  pending: list[tuple[int, dict]]) -> None:
        self.tables.add(table)
        for shard_id, rec in pending:
            self.overlay.records.setdefault((table, shard_id), []).append(rec)
        for shard_id, per_stripe in deletes.items():
            for fname, mask in per_stripe.items():
                key = (table, shard_id, fname)
                prev = self.overlay.deletes.get(key)
                self.overlay.deletes[key] = (mask if prev is None
                                             else (prev | mask))

    @property
    def modified(self) -> bool:
        return bool(self.overlay.records or self.overlay.deletes)


class TransactionManager:
    """Per-session coordinator (the backend's transaction state)."""

    def __init__(self, store, data_dir: str):
        self.store = store
        self.log_dir = os.path.join(data_dir, "txnlog")
        os.makedirs(self.log_dir, exist_ok=True)
        self._lock = threading.Lock()
        self.current: Transaction | None = None

    # -- SQL surface -------------------------------------------------------
    def begin(self) -> None:
        if self.current is not None:
            raise ExecutionError("there is already a transaction in progress")
        self.current = Transaction(global_clock.now(), self.log_dir)
        self.store.overlay = self.current.overlay

    def commit(self) -> None:
        txn = self.current
        if txn is None:
            raise ExecutionError("there is no transaction in progress")
        try:
            if txn.modified:
                self._commit_staged(txn)
        finally:
            self.store.overlay = None
            self.current = None

    def rollback(self) -> None:
        txn = self.current
        if txn is None:
            raise ExecutionError("there is no transaction in progress")
        self.store.overlay = None
        self.current = None
        # staged stripes are invisible files — just unlink them
        for (table, shard_id), recs in txn.overlay.records.items():
            self.store.discard_pending(table,
                                       [(shard_id, r) for r in recs])

    # -- the 2PC dance -----------------------------------------------------
    def _txn_dir(self, txid: int) -> str:
        return os.path.join(self.log_dir, f"txn_{txid}")

    def _commit_staged(self, txn: Transaction) -> None:
        with _txnlog_lock(self.log_dir):
            self._commit_staged_locked(txn)

    def _commit_staged_locked(self, txn: Transaction) -> None:
        from ..utils.faultinjection import fault_point

        from ..utils import io as dio

        tdir = self._txn_dir(txn.txid)
        os.makedirs(tdir, exist_ok=True)
        # make the txn directory's existence itself durable before any
        # record inside it claims to be
        dio.fsync_dir(self.log_dir)
        fault_point("txn.prepare")
        # 1. PREPARE: persist staged masks + the effect list
        effects: dict[str, dict] = {}
        for table in sorted(txn.tables):
            effects[table] = {"pending": [], "deletes": []}
        for (table, shard_id), recs in txn.overlay.records.items():
            for rec in recs:
                effects[table]["pending"].append([shard_id, rec])
        mask_no = 0
        for (table, shard_id, fname), mask in txn.overlay.deletes.items():
            mask_file = f"mask_{mask_no:04d}.npy"
            mask_no += 1
            # staged masks get the same CRC framing as committed ones:
            # recovery replays them into live manifests, so a rotted
            # staged mask is as dangerous as a rotted committed one
            integrity.write_mask(os.path.join(tdir, mask_file), mask)
            effects[table]["deletes"].append([shard_id, fname, mask_file])
        dio.atomic_write_json(os.path.join(tdir, "prepare.json"),
                              {"txid": txn.txid, "effects": effects},
                              indent=None)
        fault_point("txn.commit_record")  # prepared but no commit record
        # 2. commit record — the atomic commit point.  The tmp+rename+
        # dir-fsync discipline inside atomic_write_bytes makes the
        # record itself durable (the WAL-durability the reference gets
        # from the pg_dist_transaction INSERT): without it a crash could
        # lose the commit record and recovery would roll back a
        # committed transaction.
        dio.atomic_write_bytes(os.path.join(tdir, "commit"), b"")
        fault_point("txn.apply")  # commit record durable, not yet applied
        # 3. apply per table (each manifest flip is atomic; replay-safe)
        _apply_effects(self.store, tdir, effects)
        # 4. cleanup
        shutil.rmtree(tdir, ignore_errors=True)

    # -- recovery ----------------------------------------------------------
    def recover(self) -> tuple[int, int]:
        """Finish interrupted transactions; → (committed, discarded)."""
        return recover_transactions(self.store, self.log_dir)


def _apply_effects(store, tdir: str, effects: dict) -> None:
    for table, eff in effects.items():
        deletes: dict[int, dict[str, np.ndarray]] = {}
        for shard_id, fname, mask_file in eff["deletes"]:
            # CRC-verified load: failing a roll-forward loudly beats
            # applying a silently rotted mask (wrong rows forever)
            mask = integrity.read_mask(os.path.join(tdir, mask_file))
            deletes.setdefault(int(shard_id), {})[fname] = mask
        pending = [(int(s), r) for s, r in eff["pending"]]
        if deletes or pending:
            store.apply_dml(table, deletes, pending)


def recover_transactions(store, log_dir: str) -> tuple[int, int]:
    """The RecoverTwoPhaseCommits analogue: commit record present → roll
    forward (idempotent apply); absent → discard staged files.  Serialized
    against in-flight commits on the same txnlog (see _txnlog_lock)."""
    if not os.path.isdir(log_dir):
        return 0, 0
    with _txnlog_lock(log_dir):
        return _recover_locked(store, log_dir)


def _recover_locked(store, log_dir: str) -> tuple[int, int]:
    committed = discarded = 0
    for name in sorted(os.listdir(log_dir)):
        tdir = os.path.join(log_dir, name)
        if not name.startswith("txn_") or not os.path.isdir(tdir):
            continue
        prepare_path = os.path.join(tdir, "prepare.json")
        has_commit = os.path.exists(os.path.join(tdir, "commit"))
        if has_commit and os.path.exists(prepare_path):
            with open(prepare_path) as f:
                record = json.load(f)
            _apply_effects(store, tdir, record["effects"])
            committed += 1
        else:
            # no commit record (or incomplete prepare): roll back
            if os.path.exists(prepare_path):
                with open(prepare_path) as f:
                    record = json.load(f)
                for table, eff in record["effects"].items():
                    store.discard_pending(
                        table, [(int(s), r) for s, r in eff["pending"]])
            discarded += 1
        shutil.rmtree(tdir, ignore_errors=True)
    return committed, discarded
