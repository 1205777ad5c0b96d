"""The port's slice as a whole, on CPU torch: TPC-H Q1, Q3, the
high-cardinality GROUP BY and the colocated join, row-identical to the
JAX package and to the sqlite oracle on the same data_dir.

A JAX Session (n_devices=1, compute_dtype float64) loads TPC-H at
sf=0.002 seed=7; the port opens that data_dir on device="cpu" with the
same compute dtype.  The bucketed probe and bucketed group-by paths —
served by the bucketed_probe / bucketed_groupby_sums kernels on the card
— are forced on through the port's one gate function
(planner.plan.bucketed_paths_enabled), with the probe's size threshold
lowered so the small directory qualifies.  A second test loads the same
rows through the port's own ingest and hands that data_dir back to the
JAX package.

Tolerance: 1e-9 relative on floats (both sides sum float64; only the
summation order differs), exact on keys and counts.
"""

import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu.ingest import tpch as jtpch
from citus_tpu_torch.executor.feed import walk_plan
from citus_tpu_torch.ingest import tpch as ptpch
from citus_tpu_torch.planner.plan import AggregateNode, JoinNode
from citus_tpu_torch.sql import parse
from oracle import compare_results, make_oracle, run_oracle

torch.set_num_threads(1)

SF, SEED = 0.002, 7
DATE_COLUMNS = {
    "orders": ["o_orderdate"],
    "lineitem": ["l_shipdate", "l_commitdate", "l_receiptdate"],
}
QUERIES = {
    "q1": ptpch.QUERIES["Q1"],
    "q3": ptpch.QUERIES["Q3"],
    "high_card_groupby": "select l_orderkey, count(*), sum(l_quantity) "
                         "from lineitem group by l_orderkey",
    "colocated_join": "select count(*), sum(l_extendedprice) "
                      "from orders, lineitem where o_orderkey = l_orderkey",
}
TOL = 1e-9


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("torch_port_tpch"))
    sess = citus_tpu.connect(data_dir=data_dir, n_devices=1,
                             compute_dtype="float64",
                             serving_result_cache_bytes=0)
    jtpch.load_into_session(sess, sf=SF, seed=SEED)
    want = {k: sess.execute(q).rows() for k, q in QUERIES.items()}
    sess.close()
    return data_dir, want


@pytest.fixture(scope="module")
def oracle():
    return make_oracle(jtpch.generate_tables(SF, seed=SEED), DATE_COLUMNS)


@pytest.fixture
def forced_bucketed(monkeypatch):
    """Walk the bucketed probe and group-by paths on the CPU."""
    import citus_tpu_torch.ops.join as pjoin
    import citus_tpu_torch.planner.plan as pplan

    monkeypatch.setattr(pplan, "bucketed_paths_enabled", lambda dev: True)
    monkeypatch.setattr(pjoin, "PROBE_BUCKET_MIN_EXTENT", 1 << 10)


def _ordered(sql):
    return "order by" in sql.lower()


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_port_matches_jax_and_oracle(jax_dir, oracle, name):
    data_dir, want = jax_dir
    sess = citus_tpu_torch.connect(data_dir, device="cpu",
                                   compute_dtype="float64")
    got = sess.execute(QUERIES[name]).rows()
    assert len(got) > 0
    compare_results(got, want[name], _ordered(QUERIES[name]), TOL)
    compare_results(got, run_oracle(oracle, QUERIES[name]),
                    _ordered(QUERIES[name]), TOL)


@pytest.mark.parametrize("name", ["q3", "high_card_groupby"])
def test_bucketed_paths_match_jax(jax_dir, forced_bucketed, name):
    data_dir, want = jax_dir
    sess = citus_tpu_torch.connect(data_dir, device="cpu",
                                   compute_dtype="float64")
    plan, cleanup = sess._plan_select(parse(QUERIES[name])[0])
    assert cleanup == []
    nodes = list(walk_plan(plan.root))
    if name == "q3":
        assert any(isinstance(n, JoinNode) and n.probe_bucketed
                   for n in nodes)
    else:
        assert any(isinstance(n, AggregateNode) and n.group_bucketed
                   for n in nodes)
    got = sess.execute(QUERIES[name]).rows()
    compare_results(got, want[name], _ordered(QUERIES[name]), TOL)


@pytest.mark.parametrize("name,kernel", [("q3", "bucketed_probe"),
                                         ("high_card_groupby",
                                          "bucketed_groupby_sums")])
def test_bucketed_paths_hold_on_warm_runs(jax_dir, forced_bucketed,
                                          monkeypatch, name, kernel):
    """Warm runs in one session reuse the cached compiler with the
    capacities of the new plan: the bucketed path runs on every run,
    not only the first."""
    from citus_tpu_torch.ops import hopper_kernels as hk

    calls = []
    real = getattr(hk, kernel)

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(hk, kernel, spy)
    data_dir, want = jax_dir
    sess = citus_tpu_torch.connect(data_dir, device="cpu",
                                   compute_dtype="float64")
    per_run = []
    for _ in range(3):
        before = len(calls)
        got = sess.execute(QUERIES[name]).rows()
        per_run.append(len(calls) - before)
        compare_results(got, want[name], _ordered(QUERIES[name]), TOL)
    assert per_run[0] > 0 and per_run[1] > 0 and per_run[1] == per_run[2]


def test_port_float32_policy_close_to_jax(jax_dir):
    """The GPU default compute dtype (float32) answers Q1 within f32
    accumulation error of the float64 reference (rtol 1e-5)."""
    data_dir, want = jax_dir
    sess = citus_tpu_torch.connect(data_dir, device="cpu")
    got = sess.execute(QUERIES["q1"]).rows()
    compare_results(got, want["q1"], True, 1e-5)


NULLABLE_SQL = ("select flag, status, count(*), count(x), sum(x), sum(y) "
                "from nt where id >= 40 group by flag, status order by 1, 2")


@pytest.fixture(scope="module")
def jax_nullable_dir(tmp_path_factory):
    """A JAX data_dir holding nt: two low-cardinality text keys (the
    dense grid's shape, as in Q1) and two float measures with NULLs."""
    data_dir = str(tmp_path_factory.mktemp("torch_port_nullable"))
    sess = citus_tpu.connect(data_dir=data_dir, n_devices=1,
                             exec_cache_enabled=False,
                             compute_dtype="float64",
                             serving_result_cache_bytes=0)
    sess.execute("create table nt (id bigint, flag text, status text, "
                 "x double precision, y double precision)")
    sess.create_distributed_table("nt", "id", shard_count=4)
    sess.execute("insert into nt values " + ", ".join(
        f"({i}, '{'ANR'[i % 3]}', '{'FO'[i % 2]}', "
        + ("NULL" if i % 7 == 0 else f"{(i % 13) * 0.5}") + ", "
        + ("NULL" if i % 5 == 0 else f"{i * 0.25}") + ")"
        for i in range(3000)))
    want = sess.execute(NULLABLE_SQL).rows()
    sess.close()
    return data_dir, want


@pytest.mark.parametrize("compute_dtype,tol", [("float64", TOL),
                                               ("float32", 1e-5)])
@pytest.mark.parametrize("name", ["q1", "nullable"])
def test_dense_aggregate_is_one_kernel_call(jax_dir, jax_nullable_dir,
                                            monkeypatch, name,
                                            compute_dtype, tol):
    """The dense aggregate's per-slot sums (row count, sums, counts,
    companion counts) go into one dense_grid_sum call, as columns, with
    no stack; the answer still matches the JAX package's on the same
    data_dir.  Under float64 the sums stay on index_add_ and only the
    counts reach the kernel; float32 answers within f32 accumulation
    error (rtol 1e-5)."""
    from citus_tpu_torch.ops import hopper_kernels as hk

    data_dir, want = jax_dir if name == "q1" else jax_nullable_dir
    sql = QUERIES["q1"] if name == "q1" else NULLABLE_SQL
    want = want["q1"] if name == "q1" else want
    calls = []
    real = hk.dense_grid_sum

    def spy(slot, values, total):
        calls.append([c.dtype for c in values])
        return real(slot, values, total)

    monkeypatch.setattr(hk, "dense_grid_sum", spy)
    sess = citus_tpu_torch.connect(data_dir, device="cpu",
                                   compute_dtype=compute_dtype)
    got = sess.execute(sql).rows()
    assert len(calls) == 1, calls
    assert torch.bool in calls[0]
    assert (torch.float32 in calls[0]) == (compute_dtype == "float32")
    compare_results(got, want, True, tol)


def test_port_ingest_round_trips_with_jax(tmp_path, jax_dir):
    """The port's own DDL/distribution/ingest writes the JAX format: the
    port answers like the JAX-loaded data_dir, and the JAX package reads
    the port's data_dir back row for row."""
    _data_dir, want = jax_dir
    port_dir = str(tmp_path / "port_loaded")
    sess = citus_tpu_torch.connect(port_dir, device="cpu",
                                   compute_dtype="float64")
    counts = ptpch.load_into_session(sess, sf=SF, seed=SEED)
    assert counts["lineitem"] > 0
    for name in ("q1", "q3", "high_card_groupby"):
        compare_results(sess.execute(QUERIES[name]).rows(), want[name],
                        _ordered(QUERIES[name]), TOL)
    sess.close()
    jsess = citus_tpu.connect(data_dir=port_dir, n_devices=1,
                              compute_dtype="float64",
                              serving_result_cache_bytes=0)
    try:
        for name in ("q1", "colocated_join"):
            compare_results(jsess.execute(QUERIES[name]).rows(),
                            want[name], _ordered(QUERIES[name]), TOL)
        n = jsess.execute("select count(*) from lineitem").rows()[0][0]
        assert n == counts["lineitem"]
    finally:
        jsess.close()


def test_data_dir_from_eight_device_session_folds_onto_one(tmp_path):
    """A data_dir written by an 8-device JAX session holds 8 nodes; the
    port's one-device node map folds them all onto device 0."""
    data_dir = str(tmp_path / "eight")
    jsess = citus_tpu.connect(data_dir=data_dir, n_devices=8,
                              compute_dtype="float64",
                              serving_result_cache_bytes=0)
    jsess.execute("create table t (k bigint, v double precision)")
    jsess.create_distributed_table("t", "k")
    jsess.execute("insert into t values (1, 1.5), (2, 2.5), (3, 3.5), "
                  "(40, 4.0), (77, 0.25)")
    want = jsess.execute("select count(*), sum(v) from t").rows()
    jsess.close()
    sess = citus_tpu_torch.connect(data_dir, device="cpu",
                                   compute_dtype="float64")
    assert len(sess.catalog.nodes) == 8
    assert set(sess.catalog.node_device_map(1).values()) == {0}
    compare_results(sess.execute("select count(*), sum(v) from t").rows(),
                    want, False, TOL)


def test_port_honours_jax_deletion_bitmaps(tmp_path):
    """Rows the JAX package deleted (per-stripe deletion bitmaps) stay
    deleted when the port scans the same data_dir."""
    data_dir = str(tmp_path / "del")
    jsess = citus_tpu.connect(data_dir=data_dir, n_devices=1,
                              compute_dtype="float64",
                              serving_result_cache_bytes=0)
    jsess.execute("create table t (k bigint, v double precision)")
    jsess.create_distributed_table("t", "k", shard_count=4)
    jsess.execute("insert into t values " + ", ".join(
        f"({i}, {i * 0.5})" for i in range(200)))
    jsess.execute("delete from t where k % 3 = 0")
    want = jsess.execute("select count(*), sum(v) from t").rows()
    jsess.close()
    sess = citus_tpu_torch.connect(data_dir, device="cpu",
                                   compute_dtype="float64")
    got = sess.execute("select count(*), sum(v) from t").rows()
    assert int(got[0][0]) == 133
    compare_results(got, want, False, TOL)


def test_connect_without_device_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    with pytest.raises(citus_tpu_torch.ConfigError):
        citus_tpu_torch.connect(str(tmp_path / "d"))


def test_unsupported_statement_is_refused(jax_dir):
    data_dir, _want = jax_dir
    sess = citus_tpu_torch.connect(data_dir, device="cpu")
    # DML is answered since the write-path slice; the statement retry
    # envelope's settings are still refused
    with pytest.raises(citus_tpu_torch.UnsupportedQueryError):
        sess.execute("set statement_timeout_ms = 100")


# shapes the reference plans recursively (or rewrites) before binding
RECURSIVE_SHAPES = {
    "scalar_subquery": "select count(*) from nt "
                       "where x > (select avg(x) from nt)",
    "in_subquery": "select count(*) from nt "
                   "where id in (select id from nt where y > 100)",
    "exists_subquery": "select count(*) from nt where exists "
                       "(select 1 from nt n2 where n2.id = nt.id "
                       "and n2.x > 3)",
    "from_subquery": "select count(*), sum(s.x) from "
                     "(select x from nt where id < 100) s",
    "with": "with t as (select id, x from nt where id < 500) "
            "select count(*), sum(x) from t",
    "multi_distinct": "select count(distinct flag), count(distinct status) "
                      "from nt",
}


@pytest.mark.parametrize("shape", sorted(RECURSIVE_SHAPES))
def test_recursive_shapes_match_jax(jax_nullable_dir, shape):
    """Each shape the port once refused is answered through recursive
    planning, with the JAX package's rows on the same data_dir."""
    data_dir, _want = jax_nullable_dir
    sql = RECURSIVE_SHAPES[shape]
    sess = citus_tpu_torch.connect(data_dir, device="cpu",
                                   compute_dtype="float64")
    got = sess.execute(sql).rows()
    jsess = citus_tpu.connect(data_dir=data_dir, n_devices=1,
                              exec_cache_enabled=False,
                              compute_dtype="float64",
                              serving_result_cache_bytes=0)
    try:
        want = jsess.execute(sql).rows()
    finally:
        jsess.close()
    assert len(want) == 1 and all(v is not None for v in want[0])
    compare_results(got, want, False, TOL)


def test_text_case_is_refused(jax_nullable_dir):
    """A CASE whose result is text is refused while planning, before a
    tensor is made (the JAX package fails on it too)."""
    data_dir, _want = jax_nullable_dir
    sess = citus_tpu_torch.connect(data_dir, device="cpu")
    for sql in ["select case when x > 0 then 'pos' else 'zero' end "
                "from nt",
                "select id, case when x > 0 then 'pos' end from nt",
                "select case when y > 1 then flag else 'none' end from nt"]:
        with pytest.raises(citus_tpu_torch.UnsupportedQueryError,
                           match="CASE with a text result"):
            sess.execute(sql)
