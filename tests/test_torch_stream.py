"""The port's streamed execution (executor/stream.py) against the JAX
package's, on CPU torch.

Every shape of tests/test_stream.py at its data: TPC-H sf 0.002 seed 11,
loaded by the JAX package into 8 shards with 1,000-row stripes, opened by
both packages on one device.  Under `max_feed_bytes_per_device = 1` and
`stream_batch_rows = 512` both packages stream the same scan in the same
number of batches, and the rows equal the JAX package's and the sqlite
oracle's.  The shapes streaming must refuse (count DISTINCT, a window, a
FULL join) run resident in both.  A table whose NULLs sit only in later
stripes keeps one feed structure across batches.  The port's own
invariants: one PlanCompiler for all of a statement's batches, at most
scan_prefetch_depth + 1 batches placed at once, no producer thread and
no `stream` charge left behind.

Tolerance: 1e-9 relative on floats (float64 on both sides; the per-batch
partials merge in another order than one resident sum), exact on keys
and counts.
"""

import gc
import threading

import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu.ingest import tpch as jtpch
from citus_tpu_torch.executor.stream import _scan_width_bytes
from oracle import compare_results, make_oracle, run_oracle

torch.set_num_threads(1)

TOL = 1e-9
DATE_COLUMNS = {
    "orders": ["o_orderdate"],
    "lineitem": ["l_shipdate", "l_commitdate", "l_receiptdate"],
}
STREAM_SETUP = ("set max_feed_bytes_per_device = 1; "
                "set stream_batch_rows = 512")
STREAM_RESET = ("set max_feed_bytes_per_device = 6442450944; "
                "set stream_batch_rows = 0")

STREAMED = {
    "global_agg_scan":
        "select count(*), sum(l_quantity), min(l_shipdate), "
        "max(l_extendedprice), avg(l_discount) from lineitem",
    "grouped_agg":
        "select l_returnflag, l_linestatus, count(*), sum(l_quantity) "
        "from lineitem group by l_returnflag, l_linestatus",
    "q1": jtpch.Q1,
    "q3": jtpch.Q3,
    "colocated_join_agg":
        "select count(*), sum(l_extendedprice) "
        "from orders, lineitem where o_orderkey = l_orderkey",
    "dual_repartition_join_agg":
        "select count(*) from orders, lineitem "
        "where o_custkey = l_suppkey",
    "row_output_with_order_limit":
        "select l_orderkey, l_extendedprice from lineitem "
        "where l_quantity > 45 "
        "order by l_extendedprice desc, l_orderkey limit 25",
    "select_distinct":
        "select distinct l_linenumber from lineitem order by l_linenumber",
    "left_join_stream_preserved_side":
        "select count(*), sum(o_totalprice) from lineitem "
        "left join orders on l_suppkey = o_custkey",
    "having":
        "select l_suppkey, sum(l_quantity) as q from lineitem "
        "group by l_suppkey having sum(l_quantity) > 100 "
        "order by q desc, l_suppkey limit 10",
    "equivalence_grouped":
        "select l_returnflag, count(*), sum(l_extendedprice) "
        "from lineitem group by l_returnflag",
    "equivalence_join_filter":
        "select count(*) from lineitem, orders where l_orderkey = "
        "o_orderkey and o_totalprice > 150000",
}
RESIDENT = {
    # a nested dedupe aggregate would dedupe per batch only
    "count_distinct": "select count(distinct l_suppkey) from lineitem",
    "window":
        "select l_orderkey, sum(l_quantity) over "
        "(partition by l_orderkey) as s from lineitem "
        "where l_orderkey < 50 order by l_orderkey, s",
    # FULL JOIN preserves both sides: neither scan may batch
    "full_join":
        "select count(*), sum(o_totalprice), sum(l_quantity) "
        "from lineitem full join orders on l_suppkey = o_custkey",
}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_stream") / "tpch")
    s = citus_tpu.connect(data_dir=d, n_devices=1, compute_dtype="float64",
                          exec_cache_enabled=False,
                          serving_result_cache_bytes=0,
                          columnar_stripe_row_limit=1000)
    jtpch.load_into_session(s, sf=0.002, seed=11, shard_count=8)
    s.close()
    return d


@pytest.fixture(scope="module")
def jsess(data_dir):
    s = citus_tpu.connect(data_dir=data_dir, n_devices=1,
                          compute_dtype="float64", exec_cache_enabled=False,
                          serving_result_cache_bytes=0,
                          columnar_stripe_row_limit=1000)
    yield s
    s.close()


@pytest.fixture(scope="module")
def oracle_conn():
    return make_oracle(jtpch.generate_tables(0.002, seed=11), DATE_COLUMNS)


def _port(data_dir):
    return citus_tpu_torch.connect(data_dir, device="cpu",
                                   compute_dtype="float64",
                                   serving_result_cache_bytes=0,
                                   columnar_stripe_row_limit=1000)


def _under_budget(sess, sql):
    sess.execute(STREAM_SETUP)
    try:
        return sess.execute(sql)
    finally:
        sess.execute(STREAM_RESET)


def _producers():
    return [t for t in threading.enumerate()
            if t.name == "citus-stream-producer" and t.is_alive()]


def _assert_released(sess):
    acc = sess.executor.accountant
    if acc.transient_bytes():
        gc.collect()
    assert acc.live_bytes("stream") == 0
    assert acc.transient_bytes() == 0, acc.snapshot()
    assert _producers() == []


@pytest.mark.parametrize("name", sorted(STREAMED))
def test_streamed_shape_matches_jax_and_oracle(data_dir, jsess, oracle_conn,
                                               name):
    sql = STREAMED[name]
    ordered = "order by" in sql.lower()
    want = _under_budget(jsess, sql)
    p = _port(data_dir)
    got = _under_budget(p, sql)
    assert want.streamed_batches >= 2
    assert got.streamed_batches == want.streamed_batches
    compare_results(got.rows(), want.rows(), ordered, TOL)
    compare_results(got.rows(), run_oracle(oracle_conn, sql), ordered, TOL)
    # one PlanCompiler for every batch (the fresh session built no other)
    assert p.executor.plan_cache.misses == 1 + got.retries
    _assert_released(p)
    # the resident run of the same statement gives the same rows
    compare_results(p.execute(sql).rows(), got.rows(), ordered, TOL)


@pytest.mark.parametrize("name", sorted(RESIDENT))
def test_ineligible_shape_runs_resident(data_dir, jsess, oracle_conn, name):
    sql = RESIDENT[name]
    ordered = "order by" in sql.lower()
    want = _under_budget(jsess, sql)
    got = _under_budget(_port(data_dir), sql)
    assert want.streamed_batches == 0 and got.streamed_batches == 0
    compare_results(got.rows(), want.rows(), ordered, TOL)
    if name != "full_join":  # sqlite has no FULL JOIN
        compare_results(got.rows(), run_oracle(oracle_conn, sql), ordered,
                        TOL)


def test_prefetch_depth_bounds_placed_batches(data_dir):
    """At most scan_prefetch_depth + 1 batches are on the device at once,
    each charged to the ledger's `stream` category."""
    p = _port(data_dir)
    acc = p.executor.accountant
    sql = "select l_returnflag, sum(l_quantity) from lineitem " \
          "group by l_returnflag"
    for depth in (1, 3):
        p.execute(f"set scan_prefetch_depth = {depth}")
        acc.reset_peaks()
        r = _under_budget(p, sql)
        assert r.streamed_batches >= 4
        node = next(n for n in _scans(p, sql))
        batch_bytes = 512 * (_scan_width_bytes(node, p.catalog, "float64")
                             - len(node.columns))  # planes: none here
        peak = acc.snapshot()["peak_stream_bytes"]
        assert 0 < peak <= (depth + 1) * batch_bytes, (depth, peak)
        _assert_released(p)


def _scans(sess, sql):
    from citus_tpu_torch.executor.feed import walk_plan
    from citus_tpu_torch.planner.plan import ScanNode
    from citus_tpu_torch.sql import parse

    plan, _cleanup = sess._plan_select(parse(sql)[0])
    return [n for n in walk_plan(plan.root) if isinstance(n, ScanNode)]


def test_budget_sizes_the_batches(tmp_path):
    """Without stream_batch_rows the batch follows the byte budget: the
    stream scan gets 1/(depth + 5) of it per batch (here 4,096 rows of a
    40,960-row table), and the rows equal the resident run's."""
    n = 40960
    csv_path = tmp_path / "big.csv"
    csv_path.write_text("".join(f"{i},{i * 0.5}\n" for i in range(n)))
    p = citus_tpu_torch.connect(str(tmp_path / "d"), device="cpu",
                                compute_dtype="float64",
                                serving_result_cache_bytes=0)
    p.execute("create table big (k bigint, v double precision)")
    p.execute("select create_distributed_table('big', 'k', 4)")
    p.execute(f"copy big from '{csv_path}' with (format csv)")
    sql = "select k % 7, count(*), sum(v), min(v), max(k) from big " \
          "group by k % 7"
    resident = p.execute(sql)
    assert resident.streamed_batches == 0
    width = _scan_width_bytes(_scans(p, sql)[0], p.catalog, "float64")
    p.execute(f"set max_feed_bytes_per_device = {7 * width * 4096}")
    r = p.execute(sql)
    assert r.streamed_batches == n // 4096
    compare_results(r.rows(), resident.rows(), False, TOL)
    _assert_released(p)


def test_nulls_only_in_later_batches(tmp_path):
    """NULL presence differing across stripes must not change the feed
    structure a batch presents: the planes are decided once, from the
    stripe stats the port's own writer records."""
    rows_a = ",".join(f"({i}, {i * 1.0})" for i in range(4000))
    rows_b = ",".join(f"({i + 4000}, null)" for i in range(4000))
    got = {}
    for pkg in ("jax", "port"):
        d = str(tmp_path / pkg)
        s = (citus_tpu.connect(data_dir=d, n_devices=1,
                               compute_dtype="float64",
                               exec_cache_enabled=False,
                               columnar_stripe_row_limit=1000)
             if pkg == "jax" else
             citus_tpu_torch.connect(d, device="cpu",
                                     compute_dtype="float64",
                                     serving_result_cache_bytes=0,
                                     columnar_stripe_row_limit=1000))
        s.execute("create table t (k bigint, v double precision)")
        s.execute("select create_distributed_table('t', 'k', 2)")
        # first stripes: all non-NULL; later stripes: all NULL
        s.execute("insert into t values " + rows_a)
        s.execute("insert into t values " + rows_b)
        s.execute(STREAM_SETUP)
        r = s.execute("select count(*), count(v), sum(v) from t")
        assert r.streamed_batches >= 2
        got[pkg] = (r.streamed_batches, r.rows())
        if pkg == "port":
            stats = [rec["stats"]["v"][2]
                     for sh in s.catalog.table_shards("t")
                     for rec in s.store.shard_stripe_records("t",
                                                             sh.shard_id)]
            assert 0 in stats and max(stats) > 0
            _assert_released(s)
        s.close()
    assert got["port"] == got["jax"]
    assert got["port"][1] == [(8000, 4000, sum(range(4000)) * 1.0)]


# -- ORDER BY <aggregate> LIMIT k: no device top-k on partial aggregates ----
# The JAX package cuts each batch's (and pass's) aggregate to its top k
# before the host merge and returns wrong rows for these statements
# (ROADMAP queue C item 1): the port is held to its resident answer and
# to sqlite instead.
TOPK = {
    "suppkey_by_sum":
        "select l_suppkey, sum(l_quantity) as s from lineitem "
        "group by l_suppkey order by s desc, l_suppkey limit 5",
    "custkey_by_sum_join":
        "select o_custkey, sum(l_quantity) as s from orders, lineitem "
        "where o_orderkey = l_orderkey group by o_custkey "
        "order by s desc, o_custkey limit 5",
}


@pytest.mark.parametrize("name", sorted(TOPK))
def test_streamed_order_by_aggregate_limit_matches_resident(
        data_dir, oracle_conn, name):
    sql = TOPK[name]
    p = _port(data_dir)
    resident = p.execute(sql)
    got = _under_budget(p, sql)
    assert got.streamed_batches >= 2
    compare_results(got.rows(), resident.rows(), True, TOL)
    compare_results(got.rows(), run_oracle(oracle_conn, sql), True, TOL)
    _assert_released(p)


@pytest.mark.parametrize("force_stream", [False, True])
@pytest.mark.parametrize("name", sorted(TOPK))
def test_multipass_order_by_aggregate_limit_matches_resident(
        data_dir, oracle_conn, name, force_stream):
    from citus_tpu_torch.executor.runner import OomState

    sql = TOPK[name]
    p = _port(data_dir)
    resident = p.execute(sql)
    p.executor.oom = OomState(batch_shrink=2 if force_stream else 1,
                              force_stream=force_stream, multipass_k=4)
    got = p.execute(sql)
    assert got.spill_passes >= 2
    assert (got.streamed_batches > 0) == force_stream
    compare_results(got.rows(), resident.rows(), True, TOL)
    compare_results(got.rows(), run_oracle(oracle_conn, sql), True, TOL)
    _assert_released(p)


def test_topk_pushdown_kept_where_it_is_safe(data_dir, oracle_conn):
    """Resident plans keep their device top-k, and so do streamed plans
    that order by group keys only."""
    from citus_tpu_torch.executor.stream import partial_plan

    p = _port(data_dir)
    explain = p.execute("explain " + jtpch.Q3).columns["QUERY PLAN"]
    assert any("Device TopK: 10" in x for x in explain)
    by_key = ("select l_orderkey, sum(l_quantity) from lineitem "
              "group by l_orderkey order by l_orderkey limit 5")
    p.execute(STREAM_SETUP)
    try:
        explain = p.execute("explain " + by_key).columns["QUERY PLAN"]
        assert any("Device TopK: 5" in x for x in explain)
        plan, cleanup = p._plan_select(citus_tpu_torch.sql.parse(by_key)[0])
        assert not cleanup
        assert partial_plan(plan) is plan
        got = p.execute(by_key)
        assert got.streamed_batches >= 2
        # the per-batch top-k holds each batch's output to 5 slots
        assert got.device_rows_scanned == 5 * got.streamed_batches
        q3, _ = p._plan_select(citus_tpu_torch.sql.parse(jtpch.Q3)[0])
        assert q3.device_topk == 10 and partial_plan(q3).device_topk is None
    finally:
        p.execute(STREAM_RESET)
    compare_results(got.rows(), run_oracle(oracle_conn, by_key), True, TOL)
