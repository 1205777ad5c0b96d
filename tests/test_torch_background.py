"""The port's background services (citus_tpu_torch/background/) on CPU
torch: the job runner's DAG execution, the maintenance daemon's duties,
and the background rebalance with live progress — the 8 cases of
tests/test_background.py — plus the background class at the workload
manager, the daemon's deferred cleanup, a warm session across a split
and across a background rebalance (right answers, no retries), and no
thread left after close().
"""

import os
import threading
import time

import pytest
import torch

import citus_tpu_torch
from citus_tpu_torch.background import BackgroundJobRunner, JobStatus
from citus_tpu_torch.ingest import tpch as ptpch
from citus_tpu_torch.operations import shard_split as split_mod
from citus_tpu_torch.operations.cleanup import CleanupRegistry

torch.set_num_threads(1)

_THREADS = ("citus-maintenanced", "citus-bgworker")


def _port(d, **kw):
    kw.setdefault("compute_dtype", "float64")
    kw.setdefault("serving_result_cache_bytes", 0)
    return citus_tpu_torch.connect(str(d), device="cpu", **kw)


def _service_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(_THREADS)]


class TestJobRunner:
    def test_dependency_order(self):
        runner = BackgroundJobRunner(max_executors=4)
        order = []
        lock = threading.Lock()

        def step(n):
            def run():
                with lock:
                    order.append(n)
            return run

        job = runner.submit_job("chain", [(step(1), "a", []),
                                          (step(2), "b", [0]),
                                          (step(3), "c", [1])])
        assert runner.wait(job, timeout=10) is JobStatus.DONE
        assert order == [1, 2, 3]
        runner.shutdown()

    def test_parallel_fanout(self):
        runner = BackgroundJobRunner(max_executors=4)
        started = []
        gate = threading.Barrier(3, timeout=10)

        def fan(n):
            def run():
                started.append(n)
                gate.wait()  # needs >= 3 concurrent workers to pass
            return run

        job = runner.submit_job("fan", [(fan(i), f"t{i}", [])
                                        for i in range(3)])
        assert runner.wait(job, timeout=10) is JobStatus.DONE
        assert sorted(started) == [0, 1, 2]
        runner.shutdown()

    def test_failure_cancels_dependents(self):
        runner = BackgroundJobRunner(max_executors=2)

        def boom():
            raise ValueError("nope")

        ran = []
        job = runner.submit_job("fail", [
            (boom, "boom", []),
            (lambda: ran.append(1), "dependent", [0])])
        assert runner.wait(job, timeout=10) is JobStatus.FAILED
        tasks = list(runner.job_status(job).tasks.values())
        assert tasks[0].status is JobStatus.FAILED
        assert "nope" in tasks[0].error
        assert tasks[1].status is JobStatus.CANCELLED
        assert ran == []
        runner.shutdown()

    def test_cancel_scheduled(self):
        runner = BackgroundJobRunner(max_executors=1)
        block = threading.Event()
        job = runner.submit_job("cancellable", [
            (block.wait, "block", []),
            (lambda: None, "later", [0])])
        runner.cancel(job)
        block.set()
        assert runner.wait(job, timeout=10) is JobStatus.CANCELLED
        runner.shutdown()

    def test_idle_runner_holds_no_thread_and_shutdown_joins(self):
        runner = BackgroundJobRunner(max_executors=3)
        assert not runner._workers
        job = runner.submit_job("one", [(lambda: 7, "seven", [])])
        assert runner.wait(job, timeout=10) is JobStatus.DONE
        assert runner.job_status(job).tasks[1].result == 7
        deadline = time.monotonic() + 5
        while runner._workers and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not runner._workers  # idle workers ended
        slow = threading.Event()
        runner.submit_job("slow", [(lambda: slow.wait(0.3), "s", [])])
        workers = list(runner._workers)
        assert workers
        runner.shutdown()
        assert not any(t.is_alive() for t in workers)
        with pytest.raises(RuntimeError):
            runner.submit_job("late", [(lambda: None, "x", [])])


class TestMaintenanceDaemon:
    def test_periodic_recovery_and_cleanup(self, tmp_path):
        sess = _port(tmp_path / "d", recover_2pc_interval_ms=50,
                     defer_shard_delete_interval_ms=50)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and (
                sess.maintenance.recover_runs < 2
                or sess.maintenance.cleanup_runs < 2):
            time.sleep(0.05)
        assert sess.maintenance.recover_runs >= 2
        assert sess.maintenance.cleanup_runs >= 2
        sess.close()
        runs = sess.maintenance.recover_runs
        time.sleep(0.3)
        assert sess.maintenance.recover_runs == runs  # stopped

    def test_disabled_by_negative_interval(self, tmp_path):
        sess = _port(tmp_path / "d", recover_2pc_interval_ms=-1)
        time.sleep(0.3)
        assert sess.maintenance.recover_runs == 0
        sess.close()

    def test_defaults_fire_nothing_in_a_short_session(self, tmp_path):
        sess = _port(tmp_path / "d")
        try:
            assert sess.settings.get("recover_2pc_interval_ms") == 60_000
            assert sess.settings.get(
                "defer_shard_delete_interval_ms") == 15_000
            assert sess.settings.get("scrub_interval_ms") == -1
            assert sess.settings.get("health_check_interval_ms") == -1
            assert sess.settings.get("replication_ship_interval_ms") == 0
            time.sleep(0.3)
            m = sess.maintenance
            assert (m.recover_runs, m.cleanup_runs, m.scrub_runs,
                    m.health_sweeps, m.ship_runs) == (0, 0, 0, 0, 0)
        finally:
            sess.close()

    def test_scrub_health_and_ship_duties_run_when_set(self, tmp_path):
        from citus_tpu_torch.replication import provision_replica
        from citus_tpu_torch.replication.shipper import (
            JOURNAL,
            _committed_journal_size,
        )
        from citus_tpu_torch.replication.state import load_cursor

        sess = _port(tmp_path / "lead", scrub_interval_ms=50,
                     health_check_interval_ms=50,
                     replication_ship_interval_ms=50)
        try:
            sess.execute("create table kv (id bigint, v bigint)")
            sess.execute("select create_distributed_table('kv', 'id', 2)")
            provision_replica(sess.data_dir, str(tmp_path / "f"))
            sess.execute("insert into kv values (1, 2)")
            # the daemon's first ship can land between the provisioning
            # and the INSERT, so a non-zero ship_runs does not prove the
            # row left: wait until a ship that read the journal after
            # the INSERT committed is staged for the follower
            journal = os.path.getsize(os.path.join(sess.data_dir,
                                                   JOURNAL))
            follower = str(tmp_path / "f")
            m = sess.maintenance
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not (
                    m.scrub_runs and m.health_sweeps and m.ship_runs
                    and _committed_journal_size(
                        follower, load_cursor(follower)) >= journal):
                time.sleep(0.05)
            assert m.scrub_runs and m.health_sweeps and m.ship_runs
            assert _committed_journal_size(
                follower, load_cursor(follower)) >= journal > 0
            assert m.nodes_disabled == 0
        finally:
            sess.close()
        f = _port(tmp_path / "f")
        try:
            assert f.execute("select id, v from kv").rows() == [(1, 2)]
        finally:
            f.close()

    def test_deferred_cleanup_removes_leftover_parents(self, tmp_path,
                                                      monkeypatch):
        d = tmp_path / "d"
        sess = _port(d, defer_shard_delete_interval_ms=200)
        try:
            _make_kv(sess)
            shard = sess.catalog.table_shards("kv")[0]
            parent = d / "tables" / "kv" / f"shard_{shard.shard_id}"
            mid = (shard.min_value + shard.max_value) // 2
            # the split's own sweep does not run (as when it is cut
            # short): the parent stays on disk, its record pending
            monkeypatch.setattr(CleanupRegistry, "sweep", lambda *a: 0)
            split_mod.split_shard_by_split_points(sess, shard.shard_id,
                                                  [mid])
            monkeypatch.undo()
            assert parent.is_dir()
            assert CleanupRegistry(str(d)).pending()
            # the daemon removes the parent inside its sweep and counts
            # the run only after the sweep returns: wait for both
            m = sess.maintenance
            deadline = time.monotonic() + 10
            while (parent.is_dir() or not m.cleanup_runs) and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            assert not parent.is_dir()
            assert sess.maintenance.cleanup_runs >= 1
            assert sess.execute("select count(*), sum(v) from kv").rows() \
                == [(400, sum(range(400)))]
        finally:
            sess.close()


def _make_kv(sess, n=400, shards=8):
    sess.execute("create table kv (id bigint, v bigint)")
    sess.execute(f"select create_distributed_table('kv', 'id', {shards})")
    sess.execute("insert into kv values " + ", ".join(
        f"({i}, {i})" for i in range(n)))


class TestBackgroundRebalance:
    def test_rebalance_runs_in_background_with_progress(self, tmp_path):
        sess = _port(tmp_path / "d", rebalance_improvement_threshold=0.05)
        _make_kv(sess)
        sess.execute("select citus_add_node('extra:1')")
        sess.execute("select citus_add_node('extra:2')")
        job_id = int(sess.execute("select citus_rebalance_start()"
                                  ).rows()[0][0])
        assert job_id > 0
        # statements keep running while the job executes
        assert int(sess.execute("select sum(v) from kv").rows()[0][0]) == \
            sum(range(400))
        assert sess.execute(f"select citus_job_wait({job_id})").rows() == \
            [("done",)]
        prog = sess.execute("select get_rebalance_progress()")
        assert prog.row_count >= 1
        assert prog.columns["progress"][-1] == prog.columns["total"][-1]
        nodes = {sess.catalog.active_placement(s.shard_id).node_id
                 for s in sess.catalog.table_shards("kv")}
        assert len(nodes) >= 2
        assert int(sess.execute("select sum(v) from kv").rows()[0][0]) == \
            sum(range(400))
        jobs = sess.execute("select citus_job_list()")
        assert jobs.columns["status"] == ["done"]
        # every move task was admitted at the background class
        bg = [r for r in sess.wlm.snapshot()["tenants"]
              if r["priority"] == "background"]
        assert bg and bg[0]["admitted_total"] >= jobs.columns["tasks"][0]
        sess.close()

    def test_rebalance_start_noop_when_balanced(self, tmp_path):
        sess = _port(tmp_path / "d")
        sess.execute("create table t (id bigint)")
        sess.execute("select create_distributed_table('t', 'id', 4)")
        assert sess.execute("select citus_rebalance_start()").rows() == \
            [(0,)]
        assert sess.execute("select citus_rebalance_wait()").rows() == \
            [("done",)]
        sess.close()

    def test_background_task_waits_behind_user_statements(self, tmp_path):
        sess = _port(tmp_path / "d", max_concurrent_statements=1,
                     rebalance_improvement_threshold=0.05)
        _make_kv(sess)
        sess.execute("select citus_add_node('extra:1')")
        from citus_tpu_torch.wlm import AdmissionRequest

        held = sess.wlm.admit(AdmissionRequest(max_slots=1))
        try:
            job_id = int(sess.execute("select citus_rebalance_start()"
                                      ).rows()[0][0])
            time.sleep(0.3)
            job = sess.jobs.job_status(job_id)
            assert job.status is JobStatus.RUNNING  # queued at the gate
            assert not any(t.status is JobStatus.DONE
                           for t in job.tasks.values())
        finally:
            sess.wlm.release(held)
        assert sess.jobs.wait(job_id, timeout=30) is JobStatus.DONE
        sess.close()

    def test_job_cancel_udf(self, tmp_path):
        sess = _port(tmp_path / "d")
        block = threading.Event()
        job = sess.jobs.submit_job("blocked", [(block.wait, "b", []),
                                               (lambda: None, "x", [0])])
        sess.execute(f"select citus_job_cancel({job})")
        block.set()
        assert sess.execute(f"select citus_job_wait({job})").rows() == \
            [("cancelled",)]
        sess.close()


def test_warm_session_across_a_split(tmp_path):
    d = tmp_path / "d"
    loader = _port(d, columnar_stripe_row_limit=1000)
    ptpch.load_into_session(loader, sf=0.002, seed=5, shard_count=8)
    loader.close()
    queries = [ptpch.QUERIES["Q1"], ptpch.QUERIES["Q3"],
               "select l_orderkey, count(*), sum(l_quantity) from lineitem "
               "group by l_orderkey order by 1"]
    warm = _port(d)
    want = [warm.execute(q).rows() for q in queries]
    for q in queries:  # warm: plans, feeds and capacities cached
        warm.execute(q)
    splitter = _port(d)
    shard = splitter.catalog.table_shards("lineitem")[0]
    mid = (shard.min_value + shard.max_value) // 2
    splitter.execute(f"select citus_split_shard_by_split_points("
                     f"{shard.shard_id}, '{mid}')")
    splitter.close()
    fresh = _port(d)
    try:
        for sess in (warm, fresh):
            for q, w in zip(queries, want):
                r = sess.execute(q)
                assert r.retries == 0, q
                got = r.rows()
                assert len(got) == len(w)
                for a, b in zip(got, w):
                    assert a == pytest.approx(b, rel=1e-9)
            assert len(sess.catalog.table_shards("lineitem")) == 9
            assert len(sess.catalog.table_shards("orders")) == 9
    finally:
        warm.close()
        fresh.close()


def test_close_leaves_no_service_thread(tmp_path):
    before = _service_threads()
    sessions = [_port(tmp_path / f"d{i}",
                      rebalance_improvement_threshold=0.05)
                for i in range(3)]
    for s in sessions:
        _make_kv(s, n=100, shards=4)
        s.execute("select citus_add_node('extra:1')")
        s.execute("select citus_rebalance_start()")
        s.execute("select citus_check_cluster()")
    assert len(_service_threads()) >= len(before) + 3
    for s in sessions:
        s.execute("select citus_rebalance_wait()")
        s.close()
    assert set(_service_threads()) <= set(before)


def test_warm_session_across_a_background_rebalance(tmp_path):
    """A session warm on a colocated join keeps answering right, with no
    retries, after a background rebalance moved its placements (the feed
    cache keys on placement, the plan cache on the catalog version)."""
    d = tmp_path / "d"
    mover = _port(d, rebalance_improvement_threshold=0.05)
    _make_kv(mover, n=400, shards=8)
    mover.execute("create table kv2 (id bigint, w bigint)")
    mover.execute("select create_distributed_table('kv2', 'id', 8)")
    mover.execute("insert into kv2 values " + ", ".join(
        f"({i}, {2 * i})" for i in range(0, 400, 2)))
    q = "select count(*), sum(v), sum(w) from kv, kv2 where kv.id = kv2.id"
    warm = _port(d)
    want = warm.execute(q).rows()
    warm.execute(q)
    mover.execute("select citus_add_node('extra:1')")
    job = int(mover.execute("select citus_rebalance_start()").rows()[0][0])
    assert mover.execute(f"select citus_job_wait({job})").rows() == \
        [("done",)]
    try:
        assert len({mover.catalog.active_placement(s.shard_id).node_id
                    for s in mover.catalog.table_shards("kv")}) == 2
        r = warm.execute(q)
        assert r.rows() == want and r.retries == 0
        assert len({warm.catalog.active_placement(s.shard_id).node_id
                    for s in warm.catalog.table_shards("kv")}) == 2
    finally:
        warm.close()
        mover.close()
