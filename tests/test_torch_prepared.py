"""PREPARE / EXECUTE / DEALLOCATE, the fast-path router, the point-lookup
index and EXPLAIN in the port, against the JAX package on the same
data_dir.

The shapes are those of tests/test_prepared.py, test_fast_path.py,
test_point_index.py and test_golden_plans.py.  A JAX Session
(n_devices=1, exec cache off, compute_dtype float64, no serving cache)
writes the tables from a seeded generator and answers each statement;
the port (device="cpu", float64) answers it on the same data_dir.

What is held besides the rows: every EXECUTE of a prepared SELECT runs
through one cached PlanCompiler with its own argument's answer; the
fast path answers exactly where the JAX package's does; a point index
built by either package is used by the other; EXPLAIN renders the JAX
package's lines.

Tolerance: 1e-9 relative on floats, exact on keys and counts; EXPLAIN
equal line for line.
"""

import os
import re

import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu.ingest import tpch as jtpch
from citus_tpu.stats import counters as sc
from oracle import compare_results

torch.set_num_threads(1)

TOL = 1e-9
POINT_ROWS = 40_000   # pt: far above fast_path_max_rows per shard
MAX_ROWS = 4096       # fast_path_max_rows on both sides


def _jax(data_dir):
    return citus_tpu.connect(data_dir=data_dir, n_devices=1,
                             exec_cache_enabled=False,
                             compute_dtype="float64",
                             serving_result_cache_bytes=0,
                             fast_path_max_rows=MAX_ROWS)


def _port(data_dir, **settings):
    return citus_tpu_torch.connect(data_dir, device="cpu",
                                   compute_dtype="float64",
                                   serving_result_cache_bytes=0,
                                   fast_path_max_rows=MAX_ROWS, **settings)


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("torch_prepared"))
    j = _jax(data_dir)
    j.execute("create table t (k bigint, grp bigint, v double precision, "
              "d date, name text)")
    j.create_distributed_table("t", "k", shard_count=8)
    j.execute("insert into t values " + ",".join(
        f"({i},{i % 13},{i * 0.5},date '1995-{i % 12 + 1:02d}-15',"
        f"'n{i % 5}')" for i in range(3000)))
    j.execute("create table kv (k bigint, v bigint, s text)")
    j.create_distributed_table("kv", "k", shard_count=8)
    j.execute("insert into kv values " + ",".join(
        f"({i},{i * 10},'name{i % 5}')" for i in range(1, 501)))
    j.execute("create table ref (v bigint, label text)")
    j.create_reference_table("ref")
    j.execute("insert into ref values (10,'ten'), (20,'twenty'), "
              "(30,'thirty')")
    j.execute("create table pt (k bigint, g bigint, v double precision, "
              "name text)")
    j.create_distributed_table("pt", "k", shard_count=4)
    for lo in range(0, POINT_ROWS, 10_000):
        j.execute("insert into pt values " + ",".join(
            f"({i}, {i % 97}, {i}.25, 'n{i % 13}')"
            for i in range(lo, lo + 10_000)))
    j.execute("insert into pt values (50, 1, 9.0, 'dup'), "
              "(50, 2, 10.0, 'dup')")
    p = _port(data_dir)
    yield j, p, data_dir
    j.close()


# -- PREPARE / EXECUTE ------------------------------------------------------

PREPARED = {
    "agg": ("select grp, count(*), sum(v) from t where v > $1 "
            "group by grp order by grp", ["700", "100", "1400"]),
    "date_and_int": ("select count(*) from t where d >= $1 and grp = $2",
                     ["date '1995-06-15', 3", "date '1995-01-01', 12"]),
    "string_eq": ("select count(*) from t where name = $1",
                  ["'n2'", "'n4'", "'nope'"]),
    "string_range": ("select count(*) from t where name < $1",
                     ["'n2'", "'n4'"]),
    "point": ("select v from t where k = $1", ["17", "2999", "99999"]),
    "select_list_topk": ("select k, v * $1 as sv from t where v > $2 "
                         "order by sv desc limit 5", ["2, 1400", "3, 10"]),
    "in_subquery": ("select count(*) from t where grp in "
                    "(select grp from t where k = $1)", ["5", "12"]),
    "window": ("select k, rank() over (partition by grp order by v desc) "
               "from t where k < $1", ["40", "90"]),
}


@pytest.mark.parametrize("name", sorted(PREPARED))
def test_execute_matches_jax(sessions, name):
    j, p, _d = sessions
    sql, args = PREPARED[name]
    j.execute(f"prepare {name} as {sql}")
    p.execute(f"prepare {name} as {sql}")
    try:
        for a in args:
            want = j.execute(f"execute {name}({a})")
            got = p.execute(f"execute {name}({a})")
            compare_results(got.rows(), want.rows(), "order by" in sql, TOL)
            assert got.fast_path == want.fast_path
    finally:
        j.execute(f"deallocate {name}")
        p.execute(f"deallocate {name}")


def test_one_cached_plan_serves_every_execute(sessions):
    """Two EXECUTEs with different arguments: both right, one plan-cache
    entry.  A compiler that kept the first EXECUTE's value would answer
    the second with the first's rows."""
    j, _p, data_dir = sessions
    p = _port(data_dir)
    p.execute("prepare q as select grp, count(*), sum(v) from t "
              "where v > $1 group by grp order by grp")
    first = p.execute("execute q(100)").rows()
    entries, misses = len(p.executor.plan_cache), p.executor.plan_cache.misses
    second = p.execute("execute q(1200)").rows()
    assert len(p.executor.plan_cache) == entries == 1
    assert p.executor.plan_cache.misses == misses
    assert p.executor.plan_cache.hits >= 1
    for x, got in ((100, first), (1200, second)):
        want = j.execute(f"select grp, count(*), sum(v) from t where v > {x} "
                         "group by grp order by grp").rows()
        compare_results(got, want, True, TOL)
    assert first != second


def test_prepared_errors_match_jax(sessions):
    j, p, _d = sessions
    for s in (j, p):
        s.execute("prepare needs2 as select count(*) from t "
                  "where v > $1 and grp = $2")
        s.execute("prepare gone as select count(*) from t")
        s.execute("deallocate gone")
    for sql in ("execute nosuch(1)", "execute gone",
                "execute needs2(5)",
                "prepare needs2 as select 1 from t",
                "deallocate nosuch", "explain execute nosuch(1)"):
        with pytest.raises(citus_tpu.CitusTpuError) as jerr:
            j.execute(sql)
        with pytest.raises(citus_tpu_torch.CitusTpuError) as perr:
            p.execute(sql)
        assert type(perr.value).__name__ == type(jerr.value).__name__, sql
        assert str(perr.value) == str(jerr.value), sql
    for s in (j, p):
        s.execute("deallocate all")
        with pytest.raises(Exception, match="does not exist"):
            s.execute("execute needs2(1, 2)")


# -- the fast-path router ---------------------------------------------------

# statement → whether the router takes it (in both packages)
FAST = {
    "point_lookup": ("select v, s from kv where k = 42", True),
    "join_reference": ("select s, label from kv, ref where k = 1 "
                       "and kv.v = ref.v", True),
    "left_join_reference": ("select label from kv left join ref "
                            "on kv.v = ref.v where k = 5", True),
    "aggregate": ("select count(*) from kv where k = 3", False),
    "no_distcol_pruning": ("select v from kv where v = 10", False),
    "multi_shard": ("select v from kv where k in (1, 2, 3, 4, 5) "
                    "order by v", False),
    "order_limit": ("select k, v from kv where k = 7 order by v limit 1",
                    True),
    "point_index": ("select k, g, v, name from pt where k = 23456", True),
    "point_index_residual": ("select k from pt where k = 5000 and g = 53",
                             True),
    "point_index_missing_key": ("select k from pt where k = 99999999",
                                True),
    "point_index_duplicates": ("select v from pt where k = 50", True),
    "shard_above_the_ceiling": ("select k from pt where k in (5) "
                                "and g = 5", False),
    "reference_only": ("select label from ref where v = 20", False),
    "window_single_shard": ("select k, rank() over (order by v) from kv "
                            "where k = 9", False),
}


@pytest.mark.parametrize("name", sorted(FAST))
def test_fast_path_where_jax_takes_it(sessions, name):
    j, p, _d = sessions
    sql, fast = FAST[name]
    want = j.execute(sql)
    got = p.execute(sql)
    compare_results(got.rows(), want.rows(), "order by" in sql, TOL)
    assert got.fast_path == want.fast_path == fast
    if got.fast_path:
        assert got.device_rows_scanned == 0


def test_fast_path_off_runs_the_device_path(sessions):
    _j, _p, data_dir = sessions
    p = _port(data_dir, enable_fast_path_router=False)
    for sql in (FAST["point_lookup"][0], FAST["point_index"][0]):
        off = p.execute(sql)
        assert not off.fast_path
        assert off.device_rows_scanned > 0
        p.execute("set enable_fast_path_router = on")
        on = p.execute(sql)
        p.execute("set enable_fast_path_router = off")
        assert on.fast_path
        assert on.rows() == off.rows()


def _sidecars(data_dir):
    base = os.path.join(data_dir, "tables", "pt")
    return sorted(os.path.join(base, d, "PKIDX_k.npz")
                  for d in os.listdir(base)
                  if os.path.exists(os.path.join(base, d, "PKIDX_k.npz")))


def _stat(paths):
    return {q: os.stat(q).st_mtime_ns for q in paths}


def test_point_index_built_by_jax_is_used_by_the_port(sessions):
    j, _p, data_dir = sessions
    before = j.stats.counters.snapshot().get(sc.POINT_INDEX_LOOKUPS, 0)
    want = j.execute("select v from pt where k = 31337").rows()
    assert j.stats.counters.snapshot().get(sc.POINT_INDEX_LOOKUPS, 0) \
        == before + 1
    files = _sidecars(data_dir)
    assert files
    stamps = _stat(files)
    p = _port(data_dir)
    got = p.execute("select v from pt where k = 31337")
    assert got.fast_path and \
        p.stats.counters.snapshot()[sc.POINT_INDEX_LOOKUPS] == 1
    assert got.rows() == want == [(31337.25,)]
    assert _stat(files) == stamps  # loaded, not rebuilt


def test_point_index_built_by_the_port_is_used_by_jax(sessions):
    _j, _p, data_dir = sessions
    for f in _sidecars(data_dir):
        os.unlink(f)
    p = _port(data_dir)
    got = p.execute("select name from pt where k = 777").rows()
    files = _sidecars(data_dir)
    assert len(files) == 1
    stamps = _stat(files)
    j2 = _jax(data_dir)
    try:
        before = j2.stats.counters.snapshot().get(sc.POINT_INDEX_LOOKUPS, 0)
        want = j2.execute("select name from pt where k = 777").rows()
        assert j2.stats.counters.snapshot().get(
            sc.POINT_INDEX_LOOKUPS, 0) == before + 1
    finally:
        j2.close()
    assert got == want == [("n10",)]
    assert _stat(files) == stamps


# -- EXPLAIN ----------------------------------------------------------------

def _golden_plans():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "golden_plans", os.path.join(os.path.dirname(__file__),
                                     "test_golden_plans.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.PLANS


GOLDEN = _golden_plans()
# the port orders Q5's joins by matches per probe row on one device
# (planner/plan.py _plan_inner_joins), where the JAX package orders by
# size: the same scans and filters, another join tree
JOIN_ORDER_DIFFERS = {"q5_five_way_join"}


@pytest.fixture(scope="module")
def tpch_sessions(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("torch_explain"))
    j = _jax(data_dir)
    jtpch.load_into_session(j, sf=0.002, seed=7, shard_count=8)
    yield j, _port(data_dir)
    j.close()


def _explain(sess, sql):
    return [re.sub(r"__intermediate_\d+", "__intermediate_N", str(r[0]))
            for r in sess.execute(f"explain {sql}").rows()]


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_explain_lines_match_jax(tpch_sessions, name):
    j, p = tpch_sessions
    want = _explain(j, GOLDEN[name])
    got = _explain(p, GOLDEN[name])
    if name in JOIN_ORDER_DIFFERS:
        def leaves(lines):
            return sorted(x.strip() for x in lines
                          if "Columnar Scan" in x or "Filter" in x
                          or "GroupAggregate" in x)

        assert got[:3] == want[:3]
        assert leaves(got) == leaves(want)
        return
    assert got == want


EXPLAIN_CASES = {
    "point_index": "select v from pt where k = 9",
    "fast_path_join": "select s, label from kv, ref where k = 1 "
                      "and kv.v = ref.v",
    "window": "select k, rank() over (partition by grp order by v) from t",
    "sketch": "select grp, approx_count_distinct(k) from t group by grp",
    "percentile": "select approx_percentile(v, 0.5) from t",
}


@pytest.mark.parametrize("name", sorted(EXPLAIN_CASES))
def test_explain_matches_jax(sessions, name):
    j, p, _d = sessions
    sql = EXPLAIN_CASES[name]
    assert _explain(p, sql) == _explain(j, sql)


def test_explain_execute_and_settings_match_jax(sessions):
    j, p, _d = sessions
    for s in (j, p):
        s.execute("prepare ee as select count(*) from t where v > $1")
        s.execute("prepare pp as select v from kv where k = $1")
    try:
        for sql in ("execute ee(100)", "execute pp(3)"):
            got = _explain(p, sql)
            assert got == _explain(j, sql)
        assert "  Generic Plan: 1 parameter(s) as program inputs" in got
        assert any("Fast Path Router" in x for x in got)
        for s in (j, p):
            s.execute("set enable_fast_path_router = off")
            s.execute("set enable_point_lookup_index = off")
        assert _explain(p, "execute pp(3)") == _explain(j, "execute pp(3)")
        assert not any("Fast Path Router" in x
                       for x in _explain(p, "execute pp(3)"))
    finally:
        for s in (j, p):
            s.execute("set enable_fast_path_router = on")
            s.execute("set enable_point_lookup_index = on")
            s.execute("deallocate all")


def test_explain_analyze_is_refused(sessions):
    """EXPLAIN ANALYZE runs SELECTs only (answered since the
    observability slice, tests/test_torch_tracing.py): of any other
    statement it is refused as the JAX package refuses it."""
    j, p, _d = sessions
    sql = ("explain analyze insert into t values "
           "(1, 2, 3.0, date '1995-01-15', 'x')")
    with pytest.raises(citus_tpu.UnsupportedQueryError) as jerr:
        j.execute(sql)
    with pytest.raises(citus_tpu_torch.UnsupportedQueryError) as perr:
        p.execute(sql)
    assert str(perr.value) == str(jerr.value)
    got = p.execute("explain analyze select count(*) from t")
    assert any(x.startswith("Timing: ")
               for x in got.columns["QUERY PLAN"])
