"""Chaos soak of the port: a mixed read/write workload under random faults.

The port's counterpart of tests/test_chaos.py.  The fault engine
(citus_tpu_torch/utils/faultinjection.py) arms random named points
around a generated workload (tests/fuzzer.py chaos mode) across three
port sessions sharing one data_dir — scan_pipeline off / host / device
at 2 / 2 / 8 mesh positions, every non-exempt statement through the
shared workload manager's two-slot gate — while a device-killer actor
buries or flaps positions 2–7 of the widest session, and the port's
lock-order sanitizer watches every lock the sessions create.  The
invariant:

    every statement either agrees with the host-side oracle model or
    raises a clean CitusTpuError, and the store stays uncorrupted
    (recovery is idempotent; a full-table read agrees across the live
    sessions, a fresh session and the model).  The WLM gate and the
    serving batcher lose nothing, no prefetch charge and no span leaks,
    and the sanitizer records no inversion.

A failed write has an ambiguous outcome (the fault may have hit before
or after the visibility flip), so the harness adopts the store's
committed rows after a clean write failure; reads are never ambiguous
and must match exactly.  Every third op also reads a GROUP BY (the
dense-grid aggregate) under the op's fault.

`run_soak` is what chip_smoke.py's phase 17 runs on the card, so this
module imports nothing of the JAX package.  `-m chaos` selects these
tests; the full soaks are also `slow` (tier-1 runs the smoke slice).
"""

from __future__ import annotations

import gc
import os
import random
import time
from collections import Counter

import pytest

import citus_tpu_torch
from citus_tpu_torch.errors import CitusTpuError
from citus_tpu_torch.utils import faultinjection as fi
from fuzzer import chaos_device_kill, generate_chaos

pytestmark = pytest.mark.chaos

# the JAX soak's pool (tests/test_chaos.py), name for name: read, write,
# device, catalog, 2PC, durable-state, serving, memory, pipelined-scan,
# executable-cache, mesh and replication seams, with delay-only,
# storage-kind, delayed and probabilistic variants
FAULT_POOL = [
    dict(name="store.read_shard"),
    dict(name="store.read_shard", error="storage"),
    dict(name="store.append_stripe"),
    dict(name="store.append_stripe", after=1),
    dict(name="store.apply_dml"),
    dict(name="executor.device_put"),
    dict(name="executor.plan_cache_fill"),
    dict(name="executor.agg_bucket_fill"),
    dict(name="executor.repartition_shuffle"),
    dict(name="catalog.placement_probe"),
    dict(name="stream.prefetch"),
    dict(name="txn.prepare"),
    dict(name="txn.commit_record"),
    dict(name="txn.apply"),
    dict(name="cdc.append"),
    dict(name="store.read_shard", error=None, sleep=0.005),
    dict(name="store.read_shard", p=0.5, times=2),
    dict(name="wlm.admit"),
    dict(name="wlm.admit", p=0.5, times=2),
    dict(name="storage.stripe_torn_write"),
    dict(name="storage.manifest_flip"),
    dict(name="storage.stripe_bitflip"),
    dict(name="storage.stripe_bitflip", p=0.5, times=2),
    dict(name="serving.batch_dispatch"),
    dict(name="serving.batch_dispatch", p=0.5, times=2),
    dict(name="serving.cache_fill"),
    dict(name="executor.hbm_exhausted", error="oom"),
    dict(name="executor.hbm_exhausted", error="oom", p=0.5, times=2),
    dict(name="executor.scan_prefetch"),
    dict(name="executor.scan_prefetch", p=0.5, times=2),
    dict(name="executor.device_decode"),
    dict(name="executor.exec_cache_load"),
    dict(name="executor.exec_cache_load", p=0.5, times=2),
    dict(name="executor.exec_cache_store"),
    dict(name="mesh.collective", error="device"),
    dict(name="mesh.fetch", error="device"),
    dict(name="mesh.device_put", error="device"),
    dict(name="mesh.collective", error="device", p=0.5, times=2),
    dict(name="replication.ship"),
    dict(name="replication.apply"),
    dict(name="replication.promote"),
]

# positions the device-killer may take: the 8-position session's 2–7
# (the 2-position sessions, which reconcile and checksum, own 0 and 1)
KILL_POOL = list(range(2, 8))
PROBE = "SELECT id, v FROM kv WHERE id >= 0"
# every GROUPED_EVERY-th op also reads a GROUP BY on the op's session,
# under the op's armed fault: the generator's reads are global
# aggregates and point reads, and a grouped read is what takes the
# dense-grid aggregate (K1 on the card); it draws nothing from the rng,
# so the generated workload is the seed's
GROUPED_EVERY = 3
GROUPED = "SELECT v, count(*) FROM kv GROUP BY v"


def _require(ok: bool, what) -> None:
    """The soak's invariant check: raises where `assert` would, and
    also under `python -O` (chip_smoke.py runs the soak outside
    pytest)."""
    if not ok:
        raise AssertionError(what)


def _read_store(sess) -> dict:
    rows = sess.execute("SELECT id, v FROM kv").rows()
    return {int(i): int(v) for i, v in rows}


def run_soak(data_dir: str, n_ops: int, seed: int, fault_rate: float,
             device: str = "cpu") -> dict:
    """Run the soak over a fresh `data_dir` on `device` with the port's
    lock-order sanitizer armed; returns its counts (ops, stmts, armed,
    clean_failures, reconciled, device_kills, restarts,
    restart_exec_cache_hits, restart_same_routing, violations, and the
    sanitizer's
    locks_tracked, acquisitions and order_edges, wall_s).  Raises on any
    broken invariant."""
    import torch  # noqa: F401 — imported first: its own locks stay unwrapped

    from citus_tpu_torch.analysis import sanitizer

    fi.reset()
    sanitizer.reset()
    sanitizer.enable()
    t0 = time.perf_counter()
    try:
        stats = _soak(data_dir, n_ops, seed, fault_rate, device)
    finally:
        sanitizer.disable()
        fi.reset()
    tsan = sanitizer.stats()
    stats.update(violations=len(sanitizer.violations()),
                 locks_tracked=tsan["locks_created"],
                 acquisitions=tsan["acquisitions"],
                 order_edges=tsan["order_edges"],
                 wall_s=time.perf_counter() - t0)
    _require(sanitizer.violations() == [],
             [str(v) for v in sanitizer.violations()])
    return stats


def _soak(data_dir: str, n_ops: int, seed: int, fault_rate: float,
          device: str) -> dict:
    from citus_tpu_torch.executor.hbm import accountant_for
    from citus_tpu_torch.planner.plan import table_placement
    from citus_tpu_torch.serving.batcher import batcher_for
    from citus_tpu_torch.stats import counters as sc
    from citus_tpu_torch.stats.tracing import open_span_count

    rng = random.Random(seed)
    scratch = os.path.dirname(os.path.abspath(data_dir))

    def mk(**kw):
        return citus_tpu_torch.connect(
            data_dir=data_dir, device=device, retry_backoff_base_ms=1,
            retry_backoff_max_ms=5, max_statement_retries=2,
            shard_replication_factor=2, max_concurrent_statements=2,
            **{"n_devices": 2, **kw})

    sessions = [mk(scan_pipeline="off"), mk(scan_pipeline="host"),
                mk(scan_pipeline="device", n_devices=8)]
    s0 = sessions[0]
    s0.execute("CREATE TABLE kv (id INT, v INT)")
    s0.execute("SELECT create_distributed_table('kv', 'id', 4)")

    model: dict[int, int] = {}
    state = {"next_id": 0}
    seed_rows = [(i, 100 + i) for i in range(40)]
    state["next_id"] += 40
    s0.execute("INSERT INTO kv VALUES " + ", ".join(
        f"({i}, {v})" for i, v in seed_rows))
    model.update(seed_rows)

    stats = {"ops": 0, "stmts": 0, "armed": 0, "clean_failures": 0,
             "reconciled": 0, "device_kills": 0, "restarts": 0,
             "restart_exec_cache_hits": 0, "restart_same_routing": None}
    restart_at = n_ops // 2
    while stats["ops"] < n_ops:
        stats["ops"] += 1
        if stats["ops"] == restart_at:
            # mid-soak deploy: bounce a session under live traffic; the
            # new one resumes the probe's shape from the persisted
            # executable cache (result cache off for both probe runs, or
            # the executor would not run it)
            with sessions[0].settings.override(
                    serving_result_cache_bytes=0):
                sessions[0].execute(PROBE)
            # a plan's key holds its shard → position routing, and a
            # session that failed a read over keeps routing around the
            # suspect placement (catalog.mark_placement_suspect) where a
            # new session does not: the shape is then another key
            before = table_placement(sessions[0].catalog, "kv", 2,
                                     probe=False)
            sessions[0].close()
            sessions[0] = mk(scan_pipeline="off",
                             serving_result_cache_bytes=0)
            sessions[0].execute(PROBE)
            stats["restart_same_routing"] = before == table_placement(
                sessions[0].catalog, "kv", 2, probe=False)
            stats["restart_exec_cache_hits"] = \
                sessions[0].stats.counters.snapshot()[
                    sc.EXEC_CACHE_HITS_TOTAL]
            _require(stats["restart_exec_cache_hits"] >= 1
                     or not stats["restart_same_routing"],
                     "restarted session recomputed a persisted shape")
            stats["restarts"] += 1
        sess = sessions[stats["ops"] % len(sessions)]
        script = generate_chaos(rng, state, model)
        armed = None
        mesh_armed = False
        if rng.random() < fault_rate:
            spec = dict(rng.choice(FAULT_POOL))
            armed = spec.pop("name")
            fi.arm(armed, seed=rng.randrange(1 << 30), **spec)
            stats["armed"] += 1
        elif rng.random() < 0.12:
            # the device-killer: bury (or flap) one position of the
            # widest session for this op; it shrinks and fails over
            fi.install_mesh_sim(fi.MeshSim(
                **chaos_device_kill(rng, KILL_POOL)))
            mesh_armed = True
            stats["device_kills"] += 1
            stats["armed"] += 1
        in_txn = False
        try:
            failed = False
            for stmt in script:
                stats["stmts"] += 1
                if stmt.kind == "begin":
                    in_txn = True
                if failed:
                    break  # abandon the rest of a failed script
                sql = stmt.sql
                if stmt.kind == "copy":
                    csv = os.path.join(scratch, f"copy_{stats['ops']}.csv")
                    with open(csv, "w") as f:
                        for i, v in stmt.rows:
                            f.write(f"{i},{v}\n")
                    sql = f"COPY kv FROM '{csv}' WITH (FORMAT csv)"
                try:
                    r = sess.execute(sql)
                except Exception as e:
                    # the invariant: failures are clean framework errors
                    _require(isinstance(e, CitusTpuError),
                             f"unclean failure {type(e).__name__}: {e!r} "
                             f"running {sql!r}")
                    stats["clean_failures"] += 1
                    failed = True
                    if stmt.kind == "commit":
                        in_txn = False  # the manager tears the txn down
                    continue
                if stmt.kind == "commit":
                    in_txn = False
                if stmt.kind == "read":
                    got = [tuple(None if x is None else int(x)
                                 for x in row) for row in r.rows()]
                    want = stmt.expect(model)
                    _require(got == want, f"oracle mismatch on {sql!r}: "
                             f"{got} != {want}")
                elif stmt.effect is not None:
                    stmt.effect(model)
            if failed:
                if in_txn:
                    try:
                        sess.execute("ROLLBACK")
                    except CitusTpuError:
                        pass
                # ambiguous write outcome: adopt the store's committed
                # rows (reads above are never reconciled)
                fi.reset()
                model = _read_store(sessions[0])
                stats["reconciled"] += 1
            if stats["ops"] % GROUPED_EVERY == 0:
                stats["stmts"] += 1
                try:
                    r = sess.execute(GROUPED)
                except CitusTpuError:
                    stats["clean_failures"] += 1
                else:
                    got = sorted(tuple(int(x) for x in row)
                                 for row in r.rows())
                    want = sorted(Counter(model.values()).items())
                    _require(got == want, f"oracle mismatch on "
                             f"{GROUPED!r}: {got} != {want}")
        finally:
            if armed is not None:
                fi.disarm(armed)
            if mesh_armed:
                fi.install_mesh_sim(None)

    # -- post-soak: the store is uncorrupted ------------------------------
    for sess in sessions:
        sess.txn_manager.recover()
        # a second pass is a no-op: recovery is idempotent
        _require(sess.txn_manager.recover() == (0, 0),
                 "a second recovery pass changed the store")
    checksums = [_read_store(sess) for sess in sessions]
    fresh = citus_tpu_torch.connect(data_dir=data_dir, device=device,
                                    n_devices=2)
    checksums.append(_read_store(fresh))
    _require(all(c == checksums[0] for c in checksums[1:]),
             "sessions disagree on committed state (store corrupted)")
    _require(checksums[0] == model, "model diverged from committed state")
    # the admission gate lost nothing: every request resolved one way,
    # and no slot leaked
    wlm = sessions[0].wlm.snapshot()
    _require(wlm["requests_total"] == (
        wlm["admitted_total"] + wlm["shed_total"]
        + wlm["timedout_total"] + wlm["canceled_total"])
        and wlm["slots_in_use"] == 0 and wlm["feed_bytes_admitted"] == 0
        and wlm["admitted_total"] > 0, wlm)
    # the serving batcher lost nothing: every point lookup answered,
    # errored cleanly or fell back, and no dead batch left a waiter
    b = batcher_for(data_dir).snapshot()
    _require(b["requests_total"] == (
        b["answered_total"] + b["errored_total"] + b["fallback_total"])
        and b["queue_depth"] == 0 and not b["leader_active"], b)
    # the pipelined scan leaked no prefetch charge
    acc = accountant_for(data_dir)
    if acc.live_bytes("prefetch"):
        gc.collect()  # traceback-pinned payloads release at collection
    _require(acc.live_bytes("prefetch") == 0, acc.snapshot())
    # no statement, however it died, left a span open
    _require(open_span_count() == 0, "a span stayed open")
    for sess in sessions:
        _require(all(t.leaked == 0 for t in sess.stats.tracing.traces()),
                 "a chaos statement leaked spans inside its trace")
    for sess in sessions:
        sess.close()
    fresh.close()
    return stats


class TestChaosSoak:
    def test_smoke_slice(self, tmp_path):
        """The deterministic smoke slice, on the CPU."""
        stats = run_soak(str(tmp_path / "chaos"), n_ops=45, seed=1234,
                         fault_rate=0.35)
        assert stats["armed"] >= 8  # the soak injected chaos
        assert stats["restarts"] == 1  # the mid-soak bounce happened
        # the port's executable cache persists on the CPU too, so the
        # bounced session resumes the probe's shape from it (this seed's
        # bounced session routes as a new one does)
        assert stats["restart_same_routing"]
        assert stats["restart_exec_cache_hits"] >= 1
        assert stats["violations"] == 0

    @pytest.mark.slow
    def test_full_soak(self, tmp_path):
        """≥200 statements, ≥25% of ops fault-armed."""
        stats = run_soak(str(tmp_path / "chaos"), n_ops=160,
                         seed=20260803, fault_rate=0.4)
        assert stats["stmts"] >= 200
        assert stats["armed"] >= 0.25 * stats["ops"]

    @pytest.mark.slow
    def test_soak_second_seed(self, tmp_path):
        stats = run_soak(str(tmp_path / "chaos"), n_ops=120, seed=99,
                         fault_rate=0.3)
        assert stats["stmts"] >= 120
