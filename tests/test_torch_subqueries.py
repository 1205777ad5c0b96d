"""Recursive planning in the port, against the JAX package on the same
data_dir: decorrelated semi/anti joins and scalar aggregates, outer joins
on the expansion path, set operations, multi-DISTINCT aggregates, views
the JAX package created, and subqueries, CTEs and set operations whose
intermediate results hold no rows.

The statement shapes are those of tests/test_semi_joins.py,
test_outer_joins.py, test_setops.py, test_distinct_aggs.py and the
view-reading cases of test_views.py, plus windows and sketches under
subqueries and CTEs.  A JAX Session (n_devices=1, exec
cache off, compute_dtype float64, no serving cache) writes the tables
and views and answers each statement; the port (device="cpu", float64)
answers it on the same data_dir.  After each statement the port holds no
`__intermediate_` temp in its catalog, its data_dir or its feed cache.

Tolerance: 1e-9 relative on floats, exact on keys and counts.
"""

import os

import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu.ingest import tpch as jtpch
from oracle import compare_results

torch.set_num_threads(1)

TOL = 1e-9

SETUP = [
    "create table o (ok bigint, ck bigint, v bigint)",
    ("dist", "o", "ok"),
    "create table l (lk bigint, sk bigint, q bigint)",
    ("dist", "l", "lk"),
    "create table r (rk bigint, tag text)",
    ("ref", "r"),
    "insert into o values (1,10,100),(2,20,200),(3,30,300),(4,40,400)",
    "insert into l values (1,7,5),(1,8,6),(3,7,9),(5,9,1)",
    "insert into r values (1,'a'),(2,'b'),(9,'z')",
    "create table a (x bigint, y text)",
    ("dist", "a", "x"),
    "create table b (x bigint, y text)",
    ("dist", "b", "x"),
    "insert into a values (1,'p'),(2,'q'),(2,'q'),(3,null)",
    "insert into b values (2,'q'),(3,null),(4,'r')",
    "create table nl (id int, k int)",
    ("dist", "nl", "id"),
    "create table nr (id int, k int)",
    ("dist", "nr", "id"),
    "insert into nl values (1, 1), (2, NULL), (3, 3)",
    "insert into nr values (10, 1), (11, NULL)",
    "create table t (k int, v int)",
    ("dist", "t", "k"),
    "insert into t values (1, 10), (2, 10), (3, null), (4, 20), (5, null), "
    "(6, 20), (7, 30)",
    "create table e (k bigint, w bigint)",
    ("dist", "e", "k"),
    "create table vt (k bigint, g bigint, v double precision)",
    ("dist", "vt", "k"),
    "insert into vt values (1, 0, 1.5), (2, 0, 2.5), (3, 1, 10.0), "
    "(4, 1, 20.0), (5, 2, 7.0)",
    "create view small as select k, v from vt where v < 8.0",
    "create view gsum (grp, total) as select g, sum(v) from vt group by g",
    "create view gsum_small as select grp, total from gsum where total < 10",
    "create view rec1 as select k from vt",
    "create or replace view rec1 as select k from rec1",
]

CASES = {
    # semi / anti joins (test_semi_joins.py)
    "exists_semi": "select ok, v from o where exists "
                   "(select 1 from l where lk = ok) order by ok",
    "not_exists_anti": "select ok from o where not exists "
                       "(select 1 from l where lk = ok) order by ok",
    "semi_local_predicate": "select ok from o where exists "
                            "(select 1 from l where lk = ok and q > 5) "
                            "order by ok",
    "semi_cross_side_residual": "select ok from o where exists "
                                "(select 1 from l where lk = ok "
                                "and sk <> ck) order by ok",
    "anti_with_residual": "select ok from o where not exists "
                          "(select 1 from l where lk = ok and q >= 9) "
                          "order by ok",
    "anti_cross_side_residual": "select ok from o where not exists "
                                "(select 1 from l where lk = ok "
                                "and sk + 3 <> ck) order by ok",
    "semi_reference_table": "select ok from o where exists "
                            "(select 1 from r where rk = ok) order by ok",
    "correlated_in": "select ok from o where ck in "
                     "(select sk + 3 from l where lk = ok) order by ok",
    "semi_under_aggregate": "select count(*), sum(v) from o where exists "
                            "(select 1 from l where lk = ok)",
    "semi_and_anti": "select ok from o where exists "
                     "(select 1 from l where lk = ok) and not exists "
                     "(select 1 from l where lk = ok and q > 8) order by ok",
    "correlated_scalar_agg": "select ok from o where v > "
                             "(select 20 * sum(q) from l where lk = ok) "
                             "order by ok",
    "correlated_scalar_empty_group": "select ok from o where v >= "
                                     "(select min(q) from l where lk = ok) "
                                     "order by ok",
    "uncorrelated_in": "select count(*), sum(v) from o "
                       "where ok in (select lk from l where q > 5)",
    "uncorrelated_not_in": "select ok from o "
                           "where ok not in (select lk from l) order by ok",
    "scalar_subquery": "select ok from o where v > "
                       "(select avg(v) from o) order by ok",
    # outer joins (test_outer_joins.py)
    "colocated_left": "select o_orderkey, count(l_orderkey) from orders "
                      "left join lineitem on o_orderkey = l_orderkey "
                      "group by o_orderkey order by o_orderkey limit 50",
    "broadcast_left": "select c_custkey, n_name from customer left join "
                      "nation on c_nationkey = n_nationkey "
                      "and n_nationkey < 5 order by c_custkey limit 40",
    "repartition_left": "select c_custkey, count(o_orderkey) from customer "
                        "left join orders on c_custkey = o_custkey "
                        "group by c_custkey order by c_custkey limit 60",
    "left_is_null_anti": "select count(*) from customer left join orders "
                         "on c_custkey = o_custkey where o_orderkey is null",
    "q13_shape": "select c_count, count(*) as custdist from ("
                 "select c_custkey, count(o_orderkey) as c_count "
                 "from customer left join orders on c_custkey = o_custkey "
                 "and o_comment not like '%special%requests%' "
                 "group by c_custkey) as c_orders group by c_count "
                 "order by custdist desc, c_count desc",
    "left_where_preserved": "select c_custkey, o_orderkey from customer "
                            "left join orders on c_custkey = o_custkey "
                            "where c_custkey < 20 "
                            "order by c_custkey, o_orderkey",
    "right_join": "select o_custkey, c_name from orders right join "
                  "customer on o_custkey = c_custkey "
                  "order by c_name limit 50",
    "right_join_reference_build": "select count(*) from customer right join "
                                  "nation on c_nationkey = n_nationkey",
    "full_join": "select count(*) from customer full join orders "
                 "on c_custkey = o_custkey",
    "full_join_unmatched": "select count(*) from (select c_custkey, "
                           "o_orderkey from customer full join orders "
                           "on c_custkey = o_custkey where c_custkey is null "
                           "or o_orderkey is null) as unmatched",
    "null_keys_left": "select nl.id, nr.id from nl left join nr "
                      "on nl.k = nr.k order by nl.id",
    "null_keys_full": "select count(*) from nl full join nr on nl.k = nr.k",
    "null_keys_right": "select nl.id, nr.id from nl right join nr "
                       "on nl.k = nr.k order by nr.id",
    "nullable_group_key": "select o_orderpriority, count(*) from customer "
                          "left join orders on c_custkey = o_custkey "
                          "group by o_orderpriority order by o_orderpriority",
    # set operations (test_setops.py)
    "union_all": "select x from a union all select x from b",
    "union": "select x, y from a union select x, y from b order by x",
    "intersect_nulls": "select x, y from a intersect select x, y from b "
                       "order by x",
    "except": "select x, y from a except select x, y from b",
    "intersect_then_union": "select x from a where x > 1 intersect "
                            "select x from b union all select x from a "
                            "where x = 1 order by x",
    "setop_derived_table": "select count(*) from "
                           "(select x from a union select x from b) as u",
    "setop_cte": "with u as (select x from a except select x from b) "
                 "select * from u",
    "setop_in_subquery": "select x from a where x in (select x from a "
                         "intersect select x from b) order by x",
    "setop_order_limit": "select x from a union select x from b "
                         "order by x desc limit 2",
    "union_int_float": "select x from a where x = 1 "
                       "union select x + 0.5 from b where x = 2",
    # DISTINCT aggregates (test_distinct_aggs.py)
    "count_distinct": "select count(distinct l_suppkey) from lineitem",
    "count_distinct_grouped": "select l_returnflag, count(distinct "
                              "l_suppkey), count(*) from lineitem "
                              "group by l_returnflag order by l_returnflag",
    "distinct_mixed": "select sum(distinct l_quantity), avg(distinct "
                      "l_quantity), min(distinct l_quantity), "
                      "sum(l_quantity), count(*) from lineitem",
    "count_distinct_nulls": "select count(distinct v), count(v), count(*) "
                            "from t",
    "multi_distinct": "select count(distinct l_suppkey), "
                      "count(distinct l_partkey) from lineitem",
    "multi_distinct_grouped": "select l_linenumber, count(distinct "
                              "l_suppkey), count(distinct l_partkey) "
                              "from lineitem group by l_linenumber "
                              "order by l_linenumber",
    "multi_distinct_empty": "select count(distinct k), count(distinct v), "
                            "sum(distinct v) from t where k >= 900",
    "subquery_in_cast": "select cast((select max(v) from t) as bigint) "
                        "from t where k = 1",
    "subquery_in_is_null": "select k from t where ((select max(v) from t) "
                           "is null) = false order by k",
    # views the JAX package created (test_views.py)
    "view_select": "select k from small order by k",
    "view_column_aliases": "select grp, total from gsum order by grp",
    "view_joins_base_table": "select vt.k, gsum.total from vt, gsum "
                             "where vt.g = gsum.grp and vt.k <= 2 "
                             "order by vt.k",
    "view_over_view": "select grp, total from gsum_small order by grp",
    "view_in_scalar_subquery": "select count(*) from vt where v < "
                               "(select max(total) from gsum)",
    "with": "with w as (select k, v from vt where v > 2) "
            "select count(*), sum(v) from w",
    # intermediate results without rows
    "empty_in_list": "select count(*) from o where ok in "
                     "(select lk from l where q > 1000)",
    "empty_not_in_list": "select count(*), sum(v) from o where ok not in "
                         "(select lk from l where q > 1000)",
    "empty_derived_table": "select count(*), sum(s.x) from "
                           "(select ok as x from o where v < 0) s",
    "join_empty_derived_table": "select ok from o, (select lk from l "
                                "where q > 1000) s where s.lk = ok",
    "exists_over_nothing": "select count(*) from o where exists "
                           "(select 1 from l where q > 1000)",
    "not_exists_over_nothing": "select count(*) from o where not exists "
                               "(select 1 from l where q > 1000)",
    "semi_against_empty_table": "select ok from o where exists "
                                "(select 1 from e where k = ok) order by ok",
    "anti_against_empty_table": "select ok from o where not exists "
                                "(select 1 from e where k = ok) order by ok",
    "scalar_over_nothing": "select count(*) from o where v > "
                           "(select max(v) from o where v < 0)",
    "right_join_empty_left": "select o.ok, e.k from e right join o "
                             "on e.k = o.ok order by o.ok",
    "right_join_empty_right": "select count(*) from o right join e "
                              "on e.k = o.ok",
    "full_join_empty_left": "select o.ok, e.w from e full join o "
                            "on e.k = o.ok order by o.ok",
    "full_join_empty_right": "select o.ok, e.w from o full join e "
                             "on o.ok = e.k order by o.ok",
    "left_join_empty_derived": "select ok, s.lk from o left join "
                               "(select lk from l where q > 1000) s "
                               "on s.lk = ok order by ok",
    "empty_union": "select x from a where x > 100 "
                   "union select x from b where x > 100",
    # windows and sketches, also under a derived table or a CTE
    "window": "select ok, row_number() over (order by ok) from o",
    "window_in_derived_table": "select count(*) from (select ok, rank() "
                               "over (order by v) as rk from o) s",
    "approx_count_distinct": "select approx_count_distinct(ck) from o",
    "approx_percentile_in_cte": "with w as (select approx_percentile(v, "
                                "0.5) as p from o) select p from w",
}

# statements both packages refuse, with the same error class
REFUSED = {
    "correlated_count": "select ok from o where 0 = "
                        "(select count(*) from l where lk = ok)",
    "correlated_not_in": "select ok from o where ck not in "
                         "(select sk from l where lk = ok)",
    "setop_arity": "select x, y from a union select x from b",
    "intersect_all": "select x from a intersect all select x from b",
    "union_text_numeric": "select y from a union select x from b",
    "outer_non_equi": "select count(*) from nl left join nr "
                      "on nl.k < nr.k",
    "recursive_view": "select * from rec1",
    "multi_distinct_grouped_text_key": "select l_returnflag, count("
                                       "distinct l_suppkey), count(distinct "
                                       "l_partkey) from lineitem group by "
                                       "l_returnflag",
    "scalar_more_than_one_row": "select count(*) from o "
                                "where v > (select v from o)",
}


# shapes the port still refuses (UnsupportedQueryError), also when a
# subquery or CTE holds them
NOT_YET = {
    "text_case_in_subquery": "select count(*) from o where ok in (select "
                             "case when q > 5 then 'big' else 'small' end "
                             "from l)",
}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """One data_dir written by the JAX package; a JAX session over it
    stays open to answer each statement."""
    data_dir = str(tmp_path_factory.mktemp("torch_subqueries"))
    jsess = citus_tpu.connect(data_dir=data_dir, n_devices=1,
                              exec_cache_enabled=False,
                              compute_dtype="float64",
                              serving_result_cache_bytes=0)
    jtpch.load_into_session(jsess, sf=0.002, seed=11)
    for step in SETUP:
        if isinstance(step, str):
            jsess.execute(step)
        elif step[0] == "dist":
            jsess.create_distributed_table(step[1], step[2], shard_count=4)
        else:
            jsess.create_reference_table(step[1])
    yield data_dir, jsess
    jsess.close()


@pytest.fixture(scope="module")
def port(dirs):
    data_dir, _jsess = dirs
    return citus_tpu_torch.connect(data_dir, device="cpu",
                                   compute_dtype="float64")


def assert_no_temps(sess) -> None:
    prefix = "__intermediate_"
    assert not [t for t in sess.catalog.tables if t.startswith(prefix)]
    assert not [t for t in os.listdir(os.path.join(sess.data_dir, "tables"))
                if t.startswith(prefix)]
    assert not [k for k in sess.executor.feed_cache._entries
                if k[0].startswith(prefix)]
    assert sess.executor.accountant.snapshot()["live_prefetch_bytes"] == 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_jax(dirs, port, name):
    _data_dir, jsess = dirs
    sql = CASES[name]
    want = jsess.execute(sql).rows()
    got = port.execute(sql).rows()
    assert_no_temps(port)
    compare_results(got, want, "order by" in sql.lower(), TOL)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_port_refuses_like_jax(dirs, port, name):
    _data_dir, jsess = dirs
    sql = REFUSED[name]
    with pytest.raises(citus_tpu.CitusTpuError) as jerr:
        jsess.execute(sql)
    with pytest.raises(citus_tpu_torch.CitusTpuError) as perr:
        port.execute(sql)
    assert type(perr.value).__name__ == type(jerr.value).__name__
    assert_no_temps(port)


@pytest.mark.parametrize("name", sorted(NOT_YET))
def test_still_refused(port, name):
    with pytest.raises(citus_tpu_torch.UnsupportedQueryError,
                       match="not in this port yet"):
        port.execute(NOT_YET[name])
    assert_no_temps(port)


def test_empty_sides_are_not_vacuous(port):
    """The zero-row cases above do reach empty intermediates: the port
    answers them with the rows SQL gives over nothing."""
    rows = {name: port.execute(CASES[name]).rows() for name in (
        "empty_in_list", "empty_not_in_list", "exists_over_nothing",
        "not_exists_over_nothing", "anti_against_empty_table",
        "right_join_empty_right", "full_join_empty_left", "empty_union")}
    assert rows["empty_in_list"] == [(0,)]
    assert rows["empty_not_in_list"] == [(4, 1000)]
    assert rows["exists_over_nothing"] == [(0,)]
    assert rows["not_exists_over_nothing"] == [(4,)]
    assert rows["anti_against_empty_table"] == [(1,), (2,), (3,), (4,)]
    assert rows["right_join_empty_right"] == [(0,)]
    assert rows["full_join_empty_left"] == [(1, None), (2, None), (3, None),
                                            (4, None)]
    assert rows["empty_union"] == []
    assert_no_temps(port)


# (statement, whether it plans over base tables only): a statement with
# temps plans over fresh temp names each run, so it compiles anew
WARM = {"colocated_left": True, "full_join_empty_left": True,
        "semi_cross_side_residual": False, "with": False}


@pytest.mark.parametrize("name", sorted(WARM))
def test_warm_run_in_one_session(dirs, name):
    """A statement's second run in one session answers the same with no
    retry; over base tables it reuses the cached compiler, with the
    converged capacities keyed by the new plan's nodes."""
    data_dir, _jsess = dirs
    sess = citus_tpu_torch.connect(data_dir, device="cpu",
                                   compute_dtype="float64")
    sql = CASES[name]
    first = sess.execute(sql).rows()
    compiled = len(sess.executor.plan_cache)
    again = sess.execute(sql)
    assert again.retries == 0
    compare_results(again.rows(), first, "order by" in sql.lower(), 0.0)
    if WARM[name]:
        assert len(sess.executor.plan_cache) == compiled
