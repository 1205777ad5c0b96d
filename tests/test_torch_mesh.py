"""The port's mesh on CPU torch: N hash-sharded positions driven by one
controller (citus_tpu_torch/distributed/mesh.py), held to the JAX
package's shard_map execution on one data_dir.

* the collectives (all_to_all, all_reduce sum/min/max, all_gather) and
  the mesh helpers against numpy;
* parity with the JAX package at n_devices ∈ {2, 4, 8} (conftest gives
  the JAX package 8 virtual CPU devices) on a data_dir the JAX package
  wrote at width 4: a colocated aggregate, a repartition join
  (customer ⋈ orders), a broadcast join, an outer join with NULL keys,
  the psum-directory pushdown, a window, and a device-routed
  INSERT..SELECT with its per-position counts;
* each package opening the other's width-4 data_dir, a drained position
  in the catalog included;
* the port's counterparts of tests/test_multichip.py.

Tolerance: floats 1e-9 relative, with float64 on both sides (the
positions' partial sums combine in position order, so only the
summation order differs); keys and counts exact.  JAX sessions run with
exec_cache_enabled=False, as the port's other tests open them.
"""

import json
import random

import numpy as np
import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu_torch.distributed import mesh as dm
from citus_tpu_torch.executor.hbm import accountant_for
from citus_tpu_torch.planner.plan import table_placement
from citus_tpu_torch.stats import counters as psc
from oracle import compare_results

torch.set_num_threads(1)

TOL = 1e-9


def _jax(data_dir, n, **kw):
    return citus_tpu.connect(data_dir=str(data_dir), n_devices=n,
                             exec_cache_enabled=False,
                             compute_dtype="float64",
                             serving_result_cache_bytes=0, **kw)


def _port(data_dir, n, **kw):
    return citus_tpu_torch.connect(str(data_dir), device="cpu",
                                   n_devices=n, compute_dtype="float64",
                                   serving_result_cache_bytes=0, **kw)


# ---------------------------------------------------------------------------
# collectives and mesh helpers against numpy


@pytest.mark.parametrize("n", [1, 2, 4])
def test_all_to_all_matches_numpy(n):
    rng = np.random.default_rng(n)
    parts = [rng.integers(-50, 50, size=(n, 16)) for _ in range(n)]
    got = dm.all_to_all([torch.device("cpu")] * n,
                        [torch.from_numpy(p) for p in parts])
    for j in range(n):
        want = np.stack([parts[i][j] for i in range(n)])
        np.testing.assert_array_equal(got[j].numpy(), want)


@pytest.mark.parametrize("op,npop", [("sum", np.add), ("min", np.minimum),
                                     ("max", np.maximum)])
def test_all_reduce_matches_numpy(op, npop):
    rng = np.random.default_rng(3)
    parts = [rng.standard_normal(33) for _ in range(4)]
    got = dm.all_reduce([torch.device("cpu")] * 4,
                        [torch.from_numpy(p) for p in parts], op)
    want = parts[0]
    for p in parts[1:]:
        want = npop(want, p)
    for g in got:
        np.testing.assert_array_equal(g.numpy(), want)


def test_all_gather_matches_numpy():
    parts = [np.arange(5) + 10 * i for i in range(3)]
    got = dm.all_gather([torch.device("cpu")] * 3,
                        [torch.from_numpy(p) for p in parts])
    for g in got:
        np.testing.assert_array_equal(g.numpy(), np.concatenate(parts))


def test_make_mesh_positions_and_limits():
    m = dm.make_mesh(4)
    assert m.size == 4 and m.ids == (0, 1, 2, 3) and m.single_device()
    m2 = dm.make_mesh(devices=["cpu", "cpu"])
    assert m2.size == 2
    with pytest.raises(ValueError, match="only 2 available"):
        dm.make_mesh(4, devices=["cpu", "cpu"])
    survivors = dm.mesh_without(m, [1])
    assert survivors.ids == (0, 2, 3)
    assert dm.mesh_without(m, [0, 1, 2, 3]) is None


def test_put_sharded_slices_matches_put_sharded_and_checks_shape():
    from citus_tpu_torch.errors import ExecutionError

    mesh = dm.make_mesh(4)
    arr = np.random.default_rng(0).integers(0, 1 << 40, size=(4, 256))
    whole = dm.put_sharded(mesh, arr)
    sliced = dm.put_sharded_slices(mesh, [arr[d] for d in range(4)])
    for a, b in zip(whole, sliced):
        assert torch.equal(a, b)
    for t in dm.put_replicated(mesh, arr[0]):
        assert torch.equal(t, torch.from_numpy(arr[0]))
    with pytest.raises(ExecutionError, match="padded to one capacity"):
        dm.put_sharded_slices(mesh, [np.zeros(8), np.zeros(8),
                                     np.zeros(8), np.zeros(16)])


def test_slice_placement_charges_per_position(tmp_path):
    import gc

    acc = accountant_for(str(tmp_path / "acc"))
    mesh = dm.make_mesh(4)
    out = acc.place_sharded_slices(mesh, [np.zeros(1024, np.int64)
                                          for _ in range(4)], "other")
    assert tuple(out.shape) == (4, 1024)  # one plane on the shared card
    assert acc.live_bytes_by_device()[:4] == [8192] * 4
    assert acc.live_bytes("other") == 4 * 8192
    del out
    gc.collect()
    assert acc.live_bytes("other") == 0
    assert all(b == 0 for b in acc.live_bytes_by_device())


# ---------------------------------------------------------------------------
# parity with the JAX package on its width-4 data_dir

N_CUST, N_ORD = 300, 1500

QUERIES = {
    "colocated_aggregate":
        "select o_custkey % 7, count(*), sum(o_total), min(o_total), "
        "max(o_total) from orders group by o_custkey % 7",
    "repartition_join":
        "select c_nation, count(*), sum(o_total) from customer, orders "
        "where c_custkey = o_custkey group by c_nation",
    "broadcast_join":
        "select n_name, count(*) from customer, nation "
        "where c_nation = n_key group by n_name",
    "outer_join_null_keys":
        "select c_custkey, o_orderkey from customer left join orders "
        "on c_custkey = o_custkey where c_custkey < 40",
    "psum_directory":
        "select count(*), sum(o_total) from customer, orders "
        "where c_custkey = o_custkey",
    "global_minmax":
        "select count(*), min(o_total), max(o_total), sum(o_total) "
        "from orders where o_total > 100",
    "window":
        "select o_custkey, o_orderkey, rank() over (partition by "
        "o_custkey order by o_total) from orders where o_custkey < 20",
}


def _seed(sess):
    rng = np.random.default_rng(17)
    sess.execute("CREATE TABLE customer (c_custkey INT, c_nation INT, "
                 "c_bal DOUBLE PRECISION)")
    sess.execute("SELECT create_distributed_table('customer', "
                 "'c_custkey', 8)")
    sess.execute("CREATE TABLE orders (o_orderkey INT, o_custkey INT, "
                 "o_total DOUBLE PRECISION)")
    sess.execute("SELECT create_distributed_table('orders', "
                 "'o_orderkey', 8)")
    sess.execute("CREATE TABLE nation (n_key INT, n_name TEXT)")
    sess.execute("SELECT create_reference_table('nation')")
    sess.execute("INSERT INTO nation VALUES " + ", ".join(
        f"({i}, 'n{i}')" for i in range(25)))
    sess.execute("INSERT INTO customer VALUES " + ", ".join(
        f"({i}, {int(rng.integers(25))}, {rng.uniform(-100, 900):.2f})"
        for i in range(N_CUST)))
    # every 9th order has a NULL customer key (outer-join NULL keys)
    sess.execute("INSERT INTO orders VALUES " + ", ".join(
        f"({i}, {'NULL' if i % 9 == 0 else int(rng.integers(N_CUST + 20))}"
        f", {rng.uniform(1, 500):.2f})" for i in range(N_ORD)))


@pytest.fixture(scope="module")
def jax_width4(tmp_path_factory):
    """A data_dir the JAX package wrote at width 4, and its answers (the
    JAX package's rows do not depend on its width)."""
    d = tmp_path_factory.mktemp("mesh_parity")
    s = _jax(d, 4)
    _seed(s)
    want = {k: s.execute(q).rows() for k, q in QUERIES.items()}
    s.close()
    return d, want


_sessions: dict = {}


def _port_at(data_dir, n):
    key = (str(data_dir), n)
    if key not in _sessions:
        _sessions[key] = _port(data_dir, n)
    return _sessions[key]


@pytest.fixture(scope="module", autouse=True)
def _close_sessions():
    yield
    for p in _sessions.values():
        p.close()
    _sessions.clear()


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_port_matches_jax_at_width(jax_width4, n, name):
    d, want = jax_width4
    got = _port_at(d, n).execute(QUERIES[name]).rows()
    assert len(got) > 0
    compare_results(got, want[name], False, TOL)


@pytest.mark.parametrize("name", ["repartition_join", "outer_join_null_keys",
                                  "window"])
def test_positions_on_distinct_devices_match_jax(jax_width4, name):
    """Positions mapped onto distinct devices take the per-device paths
    (a tensor per position, peer copies in the collectives, the eager
    feed): torch's "cpu" and "cpu:0" are distinct devices."""
    d, want = jax_width4
    p = _port(d, None, devices=["cpu", "cpu:0", "cpu", "cpu:0"])
    assert p.n_devices == 4 and not p.mesh.single_device()
    compare_results(p.execute(QUERIES[name]).rows(), want[name], False, TOL)
    p.close()


def test_repartition_join_moves_bytes_and_pushdown_moves_none(jax_width4):
    ps = _port_at(jax_width4[0], 4)
    c = ps.stats.counters
    s0 = c.snapshot()[psc.SHUFFLE_BYTES_TOTAL]
    ps.execute(QUERIES["psum_directory"])
    s1 = c.snapshot()[psc.SHUFFLE_BYTES_TOTAL]
    assert s1 == s0, "the psum-directory pushdown must not pay an all_to_all"
    ps.execute(QUERIES["repartition_join"])
    assert c.snapshot()[psc.SHUFFLE_BYTES_TOTAL] > s1


@pytest.mark.parametrize("n", [2, 4])
def test_device_routed_insert_select_matches_jax(tmp_path, n):
    """INSERT..SELECT into a table with one shard per position: the
    port routes on the device (output_repart) and slices the result per
    position; the target's per-shard rows equal the JAX package's."""
    counts = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        s = _jax(d, n) if pkg == "jax" else _port(d, n)
        _seed(s)
        s.execute("CREATE TABLE tgt (k INT, total DOUBLE PRECISION)")
        s.execute(f"SELECT create_distributed_table('tgt', 'k', {n})")
        s.execute("INSERT INTO tgt SELECT o_custkey, o_total FROM orders "
                  "WHERE o_custkey IS NOT NULL")
        if pkg == "port":
            from citus_tpu_torch.executor.insert_select import (
                _device_shard_map,
            )
            assert _device_shard_map(s, s.catalog.table("tgt")) is not None
        counts[pkg] = [s.store.shard_row_count("tgt", sh.shard_id)
                       for sh in s.catalog.table_shards("tgt")]
        rows = s.execute("select k, total from tgt").rows()
        counts[pkg + "_rows"] = sorted((int(k), round(float(t), 6))
                                       for k, t in rows)
        s.close()
    assert counts["port"] == counts["jax"]
    assert counts["port_rows"] == counts["jax_rows"]


def test_insert_select_result_rows_per_position(tmp_path):
    s = _port(tmp_path / "d", 4)
    _seed(s)
    r = s.execute("select o_orderkey from orders")
    assert r.device_rows is not None and len(r.device_rows) == 4
    assert sum(r.device_rows) == N_ORD
    s.close()


def test_each_package_reads_the_others_width4_dir(tmp_path):
    """A data_dir written by the port at width 4 (with position 3
    drained) answers the same rows in the JAX package, and the JAX
    package's drained width-4 data_dir the same rows in the port."""
    q = ("select c_nation, count(*), sum(o_total) from customer, orders "
         "where c_custkey = o_custkey group by c_nation")
    for writer in ("port", "jax"):
        d = tmp_path / writer
        s = _port(d, 4) if writer == "port" else _jax(d, 4)
        _seed(s)
        s.execute("select citus_drain_device(3)")
        want = s.execute(q).rows()
        s.close()
        r = _jax(d, 4) if writer == "port" else _port(d, 4)
        # the drained node stays disabled in the catalog: the reopened
        # width-4 map leaves position 3 empty
        assert 3 not in set(r.catalog.node_device_map(4).values())
        compare_results(r.execute(q).rows(), want, False, TOL)
        r.close()


def test_width4_then_width2_session_on_one_data_dir(tmp_path):
    """A shape converged (and persisted) at width 4 is never adopted at
    width 2: the caps memo keys carry the width and the positions' ids,
    and each width answers the same rows."""
    d = tmp_path / "d"
    s4 = _port(d, 4, exec_cache_enabled=True)
    _seed(s4)
    q = QUERIES["repartition_join"]
    want = s4.execute(q).rows()
    s4.execute(q)
    keys4 = [k for k in s4.executor._caps_memo if k[1] == 4]
    assert keys4 and all(k[-1] == (0, 1, 2, 3) for k in keys4)
    s4.close()
    s2 = _port(d, 2, exec_cache_enabled=True)
    compare_results(s2.execute(q).rows(), want, False, TOL)
    assert any(k[1] == 2 and k[-1] == (0, 1)
               for k in s2.executor._caps_memo)
    assert s2.executor.last_dispatch() == ("eager", "mesh")
    s2.close()


# ---------------------------------------------------------------------------
# counterparts of tests/test_multichip.py


def _seed_kv(sess, n=2000, shard_count=8):
    sess.execute("CREATE TABLE kv (id INT, v INT, grp INT)")
    sess.execute(
        f"SELECT create_distributed_table('kv', 'id', {shard_count})")
    sess.execute("INSERT INTO kv VALUES " + ", ".join(
        f"({i}, {i * 3}, {i % 11})" for i in range(n)))
    return n


def test_node_map_and_five_shards_on_eight_positions(tmp_path):
    s = _port(tmp_path / "d", 8)
    # node churn before any placement: every position used exactly once
    s.catalog.remove_node("device:2")
    s.catalog.add_node("late:node")
    assert sorted(s.catalog.node_device_map(8).values()) == list(range(8))
    n = _seed_kv(s, n=1000, shard_count=5)
    placement = table_placement(s.catalog, "kv", 8)
    assert len(set(placement)) == 5
    assert s.execute("select count(*), sum(v) from kv").rows()[0] == \
        (n, sum(i * 3 for i in range(n)))
    s.close()


def test_rebalance_mesh_grows_and_spreads(tmp_path):
    d = tmp_path / "d"
    s1 = _port(d, 1)
    _seed_kv(s1, n=2000, shard_count=8)
    want = s1.execute("select count(*), sum(v) from kv").rows()[0]
    s1.close()
    s8 = _port(d, 8)
    assert set(table_placement(s8.catalog, "kv", 8)) == {0}
    r = s8.execute("select citus_rebalance_mesh()")
    row = dict(zip(r.column_names, r.rows()[0]))
    assert row["nodes_added"] == 7 and row["shards_moved"] > 0
    assert len(set(table_placement(s8.catalog, "kv", 8))) == 8
    res = s8.execute("select count(*), sum(v) from kv")
    assert res.rows()[0] == want
    assert res.device_rows_in is not None and min(res.device_rows_in) > 0
    r2 = s8.execute("select citus_rebalance_mesh()")
    assert dict(zip(r2.column_names, r2.rows()[0]))["nodes_added"] == 0
    s8.close()


def test_wlm_estimate_uses_hot_position(tmp_path):
    from citus_tpu_torch.sql import parse
    from citus_tpu_torch.wlm.admission import planned_feed_bytes

    d = tmp_path / "d"
    s1 = _port(d, 1)
    _seed_kv(s1, n=5000, shard_count=8)
    s1.close()
    s8 = _port(d, 8)
    stmt = parse("select count(*) from kv")[0]
    skewed = planned_feed_bytes(stmt, s8.catalog, s8.store, 8, s8.settings)
    total = sum(s8.store.shard_size_bytes("kv", sh.shard_id)
                for sh in s8.catalog.table_shards("kv"))
    assert skewed >= total
    s8.execute("select citus_rebalance_mesh()")
    spread = planned_feed_bytes(stmt, s8.catalog, s8.store, 8, s8.settings)
    assert spread < skewed / 4
    s8.close()


def test_mesh_explain_line_and_stat_udf(tmp_path):
    s = _port(tmp_path / "d", 2)
    n = _seed_kv(s, n=3000, shard_count=4)
    text = "\n".join(s.execute(
        "explain analyze select grp, count(*) from kv group by grp"
    ).columns["QUERY PLAN"])
    line = next(x for x in text.splitlines() if x.startswith("Mesh:"))
    assert "devices=2" in line and "all_to_all_bytes=" in line
    assert "rows_out=[" in line
    r = s.execute("select citus_stat_mesh()")
    row = dict(zip(r.column_names, r.rows()[0]))
    assert row["devices"] == 2 and row["platform"] == "cpu"
    assert sorted(json.loads(row["node_device_map"]).values()) == [0, 1]
    assert len(json.loads(row["live_bytes_by_device"])) >= 2
    rows = s.execute("select id, v from kv")
    assert sum(rows.device_rows_in) == n and min(rows.device_rows_in) > 0
    s.close()


@pytest.mark.parametrize("mode", ["host", "device"])
def test_pipelined_scan_planes_match_eager(tmp_path, mode):
    """The pipelined scan's [positions, cap] planes (one decode launch
    for every position) answer what the eager per-position slices do."""
    d = tmp_path / "d"
    s = _port(d, 4, scan_pipeline="off")
    _seed_kv(s, n=6000, shard_count=8)
    s.execute("INSERT INTO kv VALUES (99999, NULL, NULL)")
    q = "select grp, count(*), count(v), sum(v) from kv group by grp"
    want = s.execute(q).rows()
    s.close()
    p = _port(d, 4, scan_pipeline=mode)
    compare_results(p.execute(q).rows(), want, False, TOL)
    assert p.executor.scan_stats.snapshot()["feeds_pipelined"] >= 1
    p.close()


def test_streamed_statement_at_width_4(tmp_path):
    """A streamed statement hands each position its own batch slice and
    answers the resident rows."""
    d = tmp_path / "d"
    s = _port(d, 4)
    _seed_kv(s, n=4000, shard_count=8)
    q = "select grp, count(*), sum(v) from kv group by grp"
    want = s.execute(q).rows()
    s.execute("set max_feed_bytes_per_device = 1")
    s.execute("set stream_batch_rows = 256")
    r = s.execute(q)
    assert r.streamed_batches > 1
    compare_results(r.rows(), want, False, TOL)
    s.close()


@pytest.fixture
def forced_bucketed(monkeypatch):
    """Walk the bucketed probe and group-by paths (the card's K2 and K3
    kernels' plain versions) on the CPU."""
    import citus_tpu_torch.ops.join as pjoin
    import citus_tpu_torch.planner.plan as pplan

    monkeypatch.setattr(pplan, "bucketed_paths_enabled", lambda dev: True)
    monkeypatch.setattr(pjoin, "PROBE_BUCKET_MIN_EXTENT", 1 << 8)


@pytest.mark.parametrize("name", ["repartition_join"])
def test_bucketed_probe_at_width_4_matches_jax(jax_width4, forced_bucketed,
                                               monkeypatch, name):
    from citus_tpu_torch.ops import hopper_kernels as hk

    calls = []
    real = hk.bucketed_probe
    monkeypatch.setattr(hk, "bucketed_probe", lambda *a, **kw: (
        calls.append(1), real(*a, **kw))[1])
    d, want = jax_width4
    p = _port(d, 4)
    got = p.execute(QUERIES[name]).rows()
    p.close()
    assert calls
    compare_results(got, want[name], False, TOL)


def test_bucketed_groupby_at_width_4_matches_one_position(
        tmp_path, forced_bucketed, monkeypatch):
    from citus_tpu_torch.ops import hopper_kernels as hk
    from citus_tpu_torch.utils import faultinjection as fi

    calls = []
    real = hk.bucketed_groupby_sums
    monkeypatch.setattr(hk, "bucketed_groupby_sums", lambda *a, **kw: (
        calls.append(1), real(*a, **kw))[1])
    d = tmp_path / "d"
    s = _port(d, 4, max_statement_retries=0)
    _seed_kv(s, n=20000, shard_count=8)
    q = "select id, count(*), sum(v), min(grp) from kv group by id"
    with fi.inject("executor.agg_bucket_fill", require_fired=True):
        with pytest.raises(fi.InjectedFault):
            s.execute(q)
    got = s.execute(q).rows()
    assert calls
    want = _port(d, 1).execute(q).rows()
    compare_results(got, want, False, TOL)
    s.close()


@pytest.mark.parametrize("seed", [11])
def test_parity_across_device_counts(tmp_path, seed):
    """One data_dir read through the port at widths 1, 2 and 8 returns
    row-identical results while a writer session interleaves DML and
    COPY between reads."""
    d = tmp_path / "d"
    writer = _port(d, 8)
    n = _seed_kv(writer, n=3000, shard_count=8)
    readers = [_port(d, w) for w in (1, 2, 8)]
    rng = random.Random(seed)
    queries = [
        "select count(*), sum(v) from kv",
        "select grp, count(*), sum(v) from kv group by grp",
        "select id, v from kv where v % 7 = 0",
        "select a.grp, count(*) from kv a, kv b "
        "where a.v = b.id group by a.grp",
    ]
    try:
        for step in range(6):
            kind = step % 3
            if kind == 0:
                base = n + step * 100
                writer.execute("INSERT INTO kv VALUES " + ", ".join(
                    f"({base + i}, {rng.randrange(9000)}, {i % 11})"
                    for i in range(50)))
            elif kind == 1:
                writer.execute(
                    f"DELETE FROM kv WHERE id % 13 = {step % 13}")
            else:
                csv = tmp_path / f"copy_{step}.csv"
                csv.write_text("\n".join(
                    f"{n + 10_000 + step * 100 + i},{rng.randrange(9000)},"
                    f"{i % 11}" for i in range(40)) + "\n")
                writer.execute(f"COPY kv FROM '{csv}' WITH (FORMAT csv)")
            q = queries[step % len(queries)]
            got = [sorted(tuple(r) for r in rd.execute(q).rows())
                   for rd in readers]
            assert got[0] == got[1] == got[2], (step, q)
    finally:
        writer.close()
        for rd in readers:
            rd.close()
