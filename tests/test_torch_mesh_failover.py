"""The port's mesh fault tolerance on CPU torch: device-loss detection,
query-level failover, and the mesh's shrink and drain — the port's
counterparts of tests/test_mesh_failover.py, which fixes the semantics:

    a mid-statement kill of a mesh position either answers the right
    rows through shrink-and-failover (shard_replication_factor >= 2)
    or raises a clean DeviceLostError-derived error (replication 1); a
    hung position ends in statement_timeout — never wrong rows, never a
    hung process.

The MeshSim (citus_tpu_torch/utils/faultinjection.py) kills, hangs or
errors chosen positions at the three mesh seams.  Expected rows come
from a fresh one-position session on the same data_dir.
"""

import json

import pytest
import torch

import citus_tpu_torch
from citus_tpu_torch.errors import (
    CatalogError,
    DeviceLostError,
    ExecutionError,
    MeshDegradedError,
    StaleMeshPlan,
    StatementTimeout,
)
from citus_tpu_torch.stats import counters as sc
from citus_tpu_torch.utils import faultinjection as fi

torch.set_num_threads(1)


def _mk(data_dir, **kw):
    return citus_tpu_torch.connect(
        str(data_dir), device="cpu", retry_backoff_base_ms=1,
        retry_backoff_max_ms=5, serving_result_cache_bytes=0, **kw)


def _seed_kv(sess, n=2000, shard_count=4):
    sess.execute("CREATE TABLE kv (id INT, v INT)")
    sess.execute(
        f"SELECT create_distributed_table('kv', 'id', {shard_count})")
    sess.execute("INSERT INTO kv VALUES " + ", ".join(
        f"({i}, {i * 3})" for i in range(n)))
    return n


def _seed_q3_shape(sess):
    """A three-table join with a grouped aggregate and ORDER/LIMIT."""
    sess.execute("CREATE TABLE cust (c_key INT, c_seg INT)")
    sess.execute("SELECT create_distributed_table('cust', 'c_key', 4)")
    sess.execute("CREATE TABLE ord (o_key INT, o_cust INT, o_date INT)")
    sess.execute("SELECT create_distributed_table('ord', 'o_key', 4)")
    sess.execute("CREATE TABLE li (l_ord INT, l_price INT)")
    sess.execute("SELECT create_distributed_table('li', 'l_ord', 4)")
    sess.execute("INSERT INTO cust VALUES " + ", ".join(
        f"({i}, {i % 5})" for i in range(200)))
    sess.execute("INSERT INTO ord VALUES " + ", ".join(
        f"({i}, {(i * 7) % 200}, {i % 30})" for i in range(800)))
    sess.execute("INSERT INTO li VALUES " + ", ".join(
        f"({i % 800}, {(i * 13) % 1000})" for i in range(3000)))


Q3_SHAPE = ("select o_key, sum(l_price) as rev, o_date from cust, ord, li "
            "where c_seg = 1 and c_key = o_cust and l_ord = o_key "
            "and o_date < 20 group by o_key, o_date "
            "order by rev desc, o_key limit 10")


# ---------------------------------------------------------------------------
# MeshSim and the mesh seams


@pytest.mark.parametrize("kind", ["kill", "error"])
def test_meshsim_raises_classified_at_device_put(kind):
    from citus_tpu_torch.distributed.mesh import make_mesh, put_sharded

    mesh = make_mesh(4)
    arr = torch.zeros(4, 8)
    with fi.simulate_mesh(**{kind: {2}}) as sim:
        with pytest.raises(DeviceLostError) as ei:
            put_sharded(mesh, arr)
        assert ei.value.device_id == 2 and ei.value.seam == "mesh.device_put"
        if kind == "error":
            put_sharded(mesh, arr)  # one-shot: the position recovered
        else:
            with pytest.raises(DeviceLostError):
                put_sharded(mesh, arr)
    assert sim.trips == (1 if kind == "error" else 2)


def test_probe_finds_the_lost_position():
    from citus_tpu_torch.distributed.mesh import make_mesh, probe_mesh_devices

    mesh = make_mesh(4)
    with fi.simulate_mesh(kill={1, 3}):
        assert probe_mesh_devices(mesh) == [1, 3]
    assert probe_mesh_devices(mesh) == []


def test_is_device_loss_reads_cuda_errors():
    from citus_tpu_torch.distributed.mesh import is_device_loss

    assert is_device_loss(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    assert is_device_loss(RuntimeError("CUDA error: GPU is lost"))
    assert not is_device_loss(RuntimeError("CUDA out of memory"))


@pytest.mark.parametrize("seam", ["mesh.collective", "mesh.fetch",
                                  "mesh.device_put"])
def test_seam_device_fault_reruns_on_the_same_mesh(tmp_path, seam):
    """An armed error='device' names no lost position; the probe finds
    every position alive (a link flap) and the statement re-runs on the
    same mesh."""
    sess = _mk(tmp_path / "d", n_devices=2)
    try:
        n = _seed_kv(sess)
        sess.executor.feed_cache.clear()  # the placement seam re-fires
        with fi.inject(seam, error="device", require_fired=True):
            r = sess.execute("select count(*), sum(v) from kv")
        assert r.rows()[0] == (n, sum(i * 3 for i in range(n)))
        snap = sess.stats.counters.snapshot()
        assert snap[sc.DEVICE_LOST_TOTAL] == 1
        assert snap[sc.MESH_FAILOVERS_TOTAL] == 0
        assert sess.n_devices == 2
    finally:
        sess.close()


def test_mesh_failover_off_raises_immediately(tmp_path):
    sess = _mk(tmp_path / "d", n_devices=2, mesh_failover=False)
    try:
        _seed_kv(sess)
        with fi.inject("mesh.collective", error="device"):
            with pytest.raises(DeviceLostError):
                sess.execute("select count(*) from kv")
    finally:
        sess.close()


# ---------------------------------------------------------------------------
# query-level failover


@pytest.mark.parametrize("after", [0, 1, 3])
def test_kill_mid_query_fails_over_to_replicas(tmp_path, after):
    """Replication 2: a position killed mid-statement shrinks the mesh,
    re-routes its shards onto surviving replicas, and the statement
    answers the right rows."""
    d = tmp_path / "d"
    sess = _mk(d, n_devices=4, shard_replication_factor=2)
    try:
        _seed_q3_shape(sess)
        want = _mk(d).execute(Q3_SHAPE).rows()
        with fi.simulate_mesh(kill={2}, after=after) as sim:
            r = sess.execute(Q3_SHAPE)
        assert sim.trips >= 1
        assert r.rows() == want
        assert sess.n_devices == 3 and sess.mesh.ids == (0, 1, 3)
        snap = sess.stats.counters.snapshot()
        assert snap[sc.MESH_FAILOVERS_TOTAL] == 1
        assert snap[sc.QUERIES_RESCUED_TOTAL] == 1
        # the shrunken mesh keeps answering after the sim clears
        assert sess.execute(Q3_SHAPE).rows() == want
    finally:
        sess.close()


def test_replication_one_ends_in_clean_derived_error(tmp_path):
    sess = _mk(tmp_path / "d", n_devices=4, shard_replication_factor=1)
    try:
        _seed_kv(sess, n=800, shard_count=4)
        sess.execute("CREATE TABLE ref (k INT, lbl INT)")
        sess.execute("SELECT create_reference_table('ref')")
        sess.execute("INSERT INTO ref VALUES (1, 10), (2, 20)")
        with fi.simulate_mesh(kill={1}):
            with pytest.raises(MeshDegradedError):
                sess.execute("select count(*), sum(v) from kv")
            with pytest.raises(MeshDegradedError):
                sess.execute("select count(*) from kv")
        # a reference table keeps answering on the shrunken mesh
        assert sess.execute(
            "select count(*), sum(lbl) from ref").rows()[0] == (2, 30)
        row = dict(zip(*[(r := sess.execute(
            "select citus_stat_mesh()")).column_names, r.rows()[0]]))
        assert json.loads(row["device_states"])["1"] == "dead"
        assert row["dead_nodes"] >= 1
    finally:
        sess.close()


def test_total_mesh_loss_is_unsurvivable(tmp_path):
    sess = _mk(tmp_path / "d", n_devices=2, shard_replication_factor=2)
    try:
        _seed_kv(sess, n=200, shard_count=2)
        with fi.simulate_mesh(kill={0, 1}):
            with pytest.raises(MeshDegradedError, match="no surviving"):
                sess.execute("select count(*) from kv")
    finally:
        sess.close()


def test_hung_position_ends_in_statement_timeout(tmp_path):
    import time

    sess = _mk(tmp_path / "d", n_devices=2)
    try:
        _seed_kv(sess, n=500, shard_count=2)
        sess.execute("SET statement_timeout_ms = 60")
        t0 = time.monotonic()
        with fi.simulate_mesh(hang={1: 30.0}):
            with pytest.raises(StatementTimeout):
                sess.execute("select count(*), sum(v) from kv")
        assert time.monotonic() - t0 < 10.0  # the deadline ended the wait
        sess.execute("SET statement_timeout_ms = 0")
        assert sess.stats.counters.snapshot()[sc.TIMEOUTS_TOTAL] == 1
    finally:
        sess.close()


def test_explain_resilience_line_carries_mesh_counters(tmp_path):
    sess = _mk(tmp_path / "d", n_devices=2, shard_replication_factor=2)
    try:
        _seed_kv(sess, n=400, shard_count=2)
        r = sess.execute("EXPLAIN ANALYZE SELECT count(*) FROM kv")
        line = [x for x in r.columns["QUERY PLAN"]
                if x.startswith("Resilience:")][0]
        assert "devices_lost=0" in line and "mesh_failovers=0" in line
        assert "device_lost_total=" in line
    finally:
        sess.close()


def test_health_sweep_detects_killed_position(tmp_path):
    from citus_tpu_torch.operations.health import health_sweep

    sess = _mk(tmp_path / "d", n_devices=2, shard_replication_factor=2)
    try:
        _seed_kv(sess, n=300, shard_count=2)
        with fi.simulate_mesh(kill={1}):
            assert health_sweep(sess) == ["device:1"]
        assert int(sess.execute(
            "select count(*) from kv").rows()[0][0]) == 300
        sess.execute("select citus_activate_node('device:1')")
    finally:
        sess.close()


def test_plan_for_a_lost_width_replans(tmp_path, monkeypatch):
    """A plan made for a mesh the executor no longer has raises
    StaleMeshPlan instead of running; the envelope re-plans at the
    current width without counting a device loss or probing."""
    from citus_tpu_torch.distributed import mesh as dm
    from citus_tpu_torch.sql import parse

    sess = _mk(tmp_path / "d", n_devices=4)
    try:
        _seed_kv(sess, n=100, shard_count=4)
        plan, _cleanup = sess._plan_select(
            parse("select count(*) from kv")[0])
        sess.executor.adopt_mesh(dm.mesh_without(sess.mesh, [3]))
        with pytest.raises(StaleMeshPlan) as ei:
            sess.executor.execute_plan(plan)
        assert not isinstance(ei.value, DeviceLostError)
        sess._adopt_mesh(sess.executor.mesh)
        # the mesh narrows between planning and running, once
        run = sess.executor.execute_plan
        narrowed = []

        def narrow_then_run(p, *a, **kw):
            if not narrowed:
                narrowed.append(p.n_devices)
                sess._adopt_mesh(dm.mesh_without(sess.mesh, [2]))
            return run(p, *a, **kw)

        probes = []
        real_probe = dm.probe_mesh_devices
        monkeypatch.setattr(sess.executor, "execute_plan", narrow_then_run)
        monkeypatch.setattr(dm, "probe_mesh_devices",
                            lambda m: probes.append(m) or real_probe(m))
        res = sess.execute("select count(*), sum(v) from kv")
        assert res.rows() == [(100, 3 * sum(range(100)))]
        assert narrowed == [3] and sess.mesh.size == 2
        assert res.envelope_retries == 1 and not probes
        snap = sess.stats.counters.snapshot()
        assert snap[sc.DEVICE_LOST_TOTAL] == 0
        assert snap[sc.MESH_FAILOVERS_TOTAL] == 0
    finally:
        sess.close()


# ---------------------------------------------------------------------------
# shrink and drain


def test_rebalance_mesh_shrink_migrates_off_surplus_nodes(tmp_path):
    d = tmp_path / "d"
    s8 = _mk(d, n_devices=8)
    _seed_kv(s8, n=3000, shard_count=8)
    want = s8.execute("select count(*), sum(v) from kv").rows()[0]
    s8.close()
    s2 = _mk(d, n_devices=2)
    try:
        assert len(s2.catalog.active_nodes()) == 8
        row = dict(zip(*[(r := s2.execute(
            "select citus_rebalance_mesh()")).column_names, r.rows()[0]]))
        assert row["nodes_added"] == 0 and row["shards_moved"] > 0
        assert len(s2.catalog.active_nodes()) == 2
        assert s2.execute("select count(*), sum(v) from kv").rows()[0] == \
            want
        row2 = dict(zip(*[(r := s2.execute(
            "select citus_rebalance_mesh()")).column_names, r.rows()[0]]))
        assert row2["shards_moved"] == 0
    finally:
        s2.close()


def test_shrink_preserves_replicas_up_to_node_count(tmp_path):
    d = tmp_path / "d"
    s4 = _mk(d, n_devices=4, shard_replication_factor=2)
    _seed_kv(s4, n=1000, shard_count=4)
    s4.close()
    s2 = _mk(d, n_devices=2)
    try:
        s2.execute("select citus_rebalance_mesh()")
        kept = {nd.node_id for nd in s2.catalog.active_nodes()}
        assert len(kept) == 2
        for s in s2.catalog.table_shards("kv"):
            nodes = [p.node_id for p in
                     s2.catalog.shard_placements(s.shard_id)]
            assert len(nodes) == len(set(nodes)) and set(nodes) <= kept
        assert s2.execute("select count(*) from kv").rows()[0][0] == 1000
    finally:
        s2.close()


def test_drain_device_migrates_and_parks_the_position(tmp_path):
    from citus_tpu_torch.planner.plan import table_placement

    sess = _mk(tmp_path / "d", n_devices=4)
    try:
        _seed_kv(sess, n=1500, shard_count=4)
        want = sess.execute("select count(*), sum(v) from kv").rows()[0]
        row = dict(zip(*[(r := sess.execute(
            "select citus_drain_device(2)")).column_names, r.rows()[0]]))
        assert row["nodes_drained"] == 1 and row["placements_moved"] >= 1
        assert 2 not in set(table_placement(sess.catalog, "kv", 4))
        res = sess.execute("select count(*), sum(v) from kv")
        assert res.rows()[0] == want
        rows = sess.execute("select id from kv")
        assert rows.device_rows_in[2] == 0
        states = json.loads(dict(zip(*[(r := sess.execute(
            "select citus_stat_mesh()")).column_names,
            r.rows()[0]]))["device_states"])
        assert states["2"] == "dead"
    finally:
        sess.close()


@pytest.mark.parametrize("how", ["drain", "shrink"])
def test_drain_and_shrink_preserve_local_table_only_placement(tmp_path,
                                                              how):
    d = tmp_path / "d"
    s = _mk(d, n_devices=2 if how == "drain" else 4)
    s.execute("CREATE TABLE loc (id INT, v INT)")
    s.execute("INSERT INTO loc VALUES (1, 10), (2, 20)")
    _seed_kv(s, n=300, shard_count=2)
    if how == "drain":
        s.execute("select citus_drain_device(0)")
    else:
        s.close()
        s = _mk(d, n_devices=1)
        s.execute("select citus_rebalance_mesh()")
        assert len(s.catalog.active_nodes()) == 1
    try:
        r = s.execute("select count(*), sum(v) from loc")
        assert tuple(map(int, r.rows()[0])) == (2, 30)
    finally:
        s.close()


def test_drain_last_position_refuses(tmp_path):
    sess = _mk(tmp_path / "d", n_devices=1)
    try:
        _seed_kv(sess, n=100, shard_count=2)
        with pytest.raises(CatalogError):
            sess.execute("select citus_drain_device(0)")
    finally:
        sess.close()


def test_memsim_budget_counts_the_hot_position(tmp_path):
    """With every shard on one of 4 positions, the hot position's row
    count pads every position's slice, so the skewed feed needs ~4× the
    spread one: a budget of half the skewed peak OOMs and the ladder
    still answers; spread over the positions, the same budget fits
    without an OOM."""
    from citus_tpu_torch.executor.hbm import oom_budget

    d = tmp_path / "d"
    s1 = _mk(d, n_devices=1)
    n = _seed_kv(s1, n=20000, shard_count=8)
    s1.close()
    want = (n, sum(i * 3 for i in range(n)))
    s4 = _mk(d, n_devices=4)
    try:
        acc = s4.executor.accountant
        sql = "select count(*), sum(v) from kv"
        with oom_budget(acc):
            s4.execute(sql)
        budget = acc.peak_bytes // 2
        s4.executor.feed_cache.clear()
        snap0 = s4.stats.counters.snapshot()[sc.OOM_EVENTS_TOTAL]
        with oom_budget(acc, budget=budget):
            assert s4.execute(sql).rows()[0] == want
        assert s4.stats.counters.snapshot()[sc.OOM_EVENTS_TOTAL] > snap0
        s4.execute("select citus_rebalance_mesh()")
        s4.executor.feed_cache.clear()
        snap1 = s4.stats.counters.snapshot()[sc.OOM_EVENTS_TOTAL]
        with oom_budget(acc, budget=budget):
            assert s4.execute(sql).rows()[0] == want
        assert s4.stats.counters.snapshot()[sc.OOM_EVENTS_TOTAL] == snap1
    finally:
        s4.close()


def test_execution_error_is_not_device_loss(tmp_path):
    """A non-device failure inside a mesh run is not classified as a
    device loss (no failover, no shrink)."""
    sess = _mk(tmp_path / "d", n_devices=2, max_statement_retries=0)
    try:
        _seed_kv(sess, n=100, shard_count=2)
        with fi.inject("executor.device_put"):
            sess.executor.feed_cache.clear()
            with pytest.raises(ExecutionError):
                sess.execute("select count(*) from kv")
        assert sess.n_devices == 2
        assert sess.stats.counters.snapshot()[sc.DEVICE_LOST_TOTAL] == 0
    finally:
        sess.close()
