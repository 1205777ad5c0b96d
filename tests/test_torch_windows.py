"""Window functions in the port, against the JAX package on the same
data_dir.

The statement shapes are those of tests/test_window_alter.py: ranking
functions, running and whole-partition aggregates, DESC keys, one global
partition, partitions on the distribution column, a window over a join,
NULL partitions and peers, string partitions, and the same refusals.  A
JAX Session (n_devices=1, exec cache off, compute_dtype float64, no
serving cache) writes the tables from a seeded generator and answers
each statement; the port (device="cpu", float64) answers it on the same
data_dir.

Tolerance: 1e-9 relative on floats, exact on keys, counts and ranks.
"""

import numpy as np
import pytest
import torch

import citus_tpu
import citus_tpu_torch
from oracle import compare_results

torch.set_num_threads(1)

TOL = 1e-9


def _rows():
    rng = np.random.default_rng(17)
    n = 300
    k = np.arange(1, n + 1)
    g = rng.integers(0, 5, n)
    v = rng.integers(0, 100, n)
    f = np.round(rng.uniform(0.0, 50.0, n), 3)
    v[10] = v[11]  # duplicate order values: rank peers
    return list(zip(k.tolist(), g.tolist(), v.tolist(), f.tolist()))


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("torch_windows"))
    j = citus_tpu.connect(data_dir=data_dir, n_devices=1,
                          exec_cache_enabled=False, compute_dtype="float64",
                          serving_result_cache_bytes=0)
    j.execute("create table w (k bigint, g bigint, v bigint, "
              "f double precision)")
    j.create_distributed_table("w", "k", shard_count=4)
    j.execute("insert into w values " + ",".join(
        f"({a},{b},{c},{d})" for a, b, c, d in _rows()))
    j.execute("create table d (g bigint, name bigint)")
    j.create_reference_table("d")
    j.execute("insert into d values (0,100),(1,101),(2,102),(3,103),"
              "(4,104)")
    j.execute("create table ws (k bigint, name text, v bigint)")
    j.create_distributed_table("ws", "k", shard_count=4)
    j.execute("insert into ws values (1,'zeta',10),(2,'alpha',20),"
              "(3,'zeta',30),(4,'beta',40)")
    j.execute("create table c (k bigint, a bigint, b bigint, "
              "x double precision)")
    j.create_distributed_table("c", "k", shard_count=4)
    j.execute("insert into c values (1, 100, 5, -0.0), (2, 200, 7, 0.0), "
              "(3, null, 5, null), (4, null, 7, 2.5), (5, 300, null, null)")
    p = citus_tpu_torch.connect(data_dir, device="cpu",
                                compute_dtype="float64")
    yield j, p
    j.close()


CASES = {
    "row_number": "select k, row_number() over (partition by g "
                  "order by v, k) from w",
    "rank_peers": "select k, rank() over (partition by g order by v) from w",
    "dense_rank": "select k, dense_rank() over (partition by g order by v) "
                  "from w",
    "running_sum": "select k, sum(v) over (partition by g order by k) "
                   "from w",
    "whole_sum": "select k, sum(v) over (partition by g) from w",
    "running_count_peers": "select k, count(*) over (partition by g "
                           "order by v) from w",
    "running_min_max": "select k, min(f) over (partition by g order by k), "
                       "max(v) over (partition by g order by k) from w",
    "whole_avg": "select k, avg(v) over (partition by g) from w",
    "float_running_sum": "select k, sum(f) over (partition by g "
                         "order by f desc, k) from w",
    "desc_global": "select k, row_number() over (order by v desc, k) "
                   "from w",
    "global_running_sum": "select k, sum(v) over (order by k) from w",
    "dist_column_partition": "select k, count(*) over (partition by k) "
                             "from w",
    "two_order_specs": "select k, rank() over (partition by g order by v), "
                       "row_number() over (partition by g order by k desc) "
                       "from w",
    "with_filter": "select k, rank() over (partition by g order by f) "
                   "from w where v < 40",
    "empty_input": "select k, row_number() over (partition by g "
                   "order by k) from w where v < 0",
    "window_over_join": "select k, name, v + row_number() over "
                        "(partition by w.g order by k) from w, d "
                        "where w.g = d.g",
    "order_by_window": "select k, rank() over (order by v desc) as r "
                       "from w order by r, k limit 20",
    "null_partitions": "select k, count(*) over (partition by a + b) "
                       "from c",
    "null_peers": "select k, rank() over (order by a + b) from c",
    "null_peers_desc": "select k, dense_rank() over (order by a desc) "
                       "from c",
    "negative_zero_peers": "select k, rank() over (order by x) from c",
    "sum_over_nulls": "select k, sum(a) over (partition by b order by k), "
                      "count(a) over (partition by b) from c",
    "all_null_partition_sum": "select k, sum(a) over (partition by b) "
                              "from c where a is null",
    "string_partition": "select name, sum(v) over (partition by name) "
                        "from ws",
    "count_over_strings": "select k, count(name) over (partition by k) "
                          "from ws",
    "bool_keys": "select k, rank() over (partition by v > 50 "
                 "order by f > 25.0 desc, k) from w",
    "window_over_empty_temp": "with e as (select k, v from w where v < 0) "
                              "select k, row_number() over (order by v) "
                              "from e",
    "window_in_cte": "with r as (select k, g, rank() over (partition by g "
                     "order by v desc, k) as rk from w) "
                     "select g, count(*) from r where rk <= 3 group by g "
                     "order by g",
}

REFUSED = {
    "two_partitions": "select row_number() over (partition by g order by "
                      "k), row_number() over (partition by v order by k) "
                      "from w",
    "ranking_without_over": "select row_number() from w",
    "window_over_group_by": "select g, sum(count(*)) over (partition by g) "
                            "from w group by g",
    "rank_over_strings": "select rank() over (order by name) from ws",
    "min_over_strings": "select min(name) over (partition by k) from ws",
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_matches_jax(sessions, name):
    j, p = sessions
    sql = CASES[name]
    want = j.execute(sql).rows()
    got = p.execute(sql).rows()
    compare_results(got, want, "order by" in sql.split(")")[-1].lower(),
                    TOL)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_window_refusals_match_jax(sessions, name):
    j, p = sessions
    sql = REFUSED[name]
    with pytest.raises(citus_tpu.CitusTpuError) as jerr:
        j.execute(sql)
    with pytest.raises(citus_tpu_torch.CitusTpuError) as perr:
        p.execute(sql)
    assert type(perr.value).__name__ == type(jerr.value).__name__


def test_ranks_against_numpy(sessions):
    """rank() over (partition by g order by v desc, k) against a plain
    numpy rank over the generated rows."""
    _j, p = sessions
    rows = np.asarray(_rows(), dtype=np.float64)
    k, g, v = rows[:, 0], rows[:, 1], rows[:, 2]
    got = dict(p.execute("select k, rank() over (partition by g order by "
                         "v desc, k) from w").rows())
    for gi in np.unique(g):
        m = g == gi
        order = np.lexsort((k[m], -v[m]))
        for pos, kk in enumerate(k[m][order]):
            assert got[int(kk)] == pos + 1


def test_window_runs_in_one_compiler_when_warm(sessions):
    """A second run of a window statement reuses its PlanCompiler."""
    _j, p = sessions
    sql = CASES["two_order_specs"]
    first = p.execute(sql).rows()
    compiled = len(p.executor.plan_cache)
    again = p.execute(sql)
    assert again.retries == 0
    assert len(p.executor.plan_cache) == compiled
    compare_results(again.rows(), first, False, 0.0)
