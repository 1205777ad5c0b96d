"""approx_count_distinct (HyperLogLog) and approx_percentile (DDSketch)
in the port, against the JAX package on the same data_dir.

The statement shapes are those of tests/test_approx_aggs.py: global and
grouped estimates, sketches beside plain aggregates, WHERE filters,
empty inputs, heavy tails, negative and zero values, all-NULL groups,
string and NULL group keys, and sketches under EXISTS.  A JAX Session
(n_devices=1, exec cache off, compute_dtype float64, no serving cache)
writes the tables from a seeded generator and answers each statement;
the port (device="cpu", float64) answers it on the same data_dir.

Tolerance: HLL estimates, keys and counts exact (the registers are
integer maxima of a bit-exact hash, so the estimate is the same function
of the same integers); percentiles and other floats 1e-9 relative.  The
estimates are also held to their error bounds against numpy.
"""

import numpy as np
import pytest
import torch

import citus_tpu
import citus_tpu_torch
from oracle import compare_results

torch.set_num_threads(1)

TOL = 1e-9
N = 6000


def _data():
    rng = np.random.default_rng(11)
    k = np.arange(N)
    return {"k": k, "g": k % 4, "u": rng.integers(0, 3000, N),
            "w": rng.integers(0, 40, N),
            "x": np.round(rng.uniform(0.0, 1000.0, N), 4)}


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("torch_sketches"))
    j = citus_tpu.connect(data_dir=data_dir, n_devices=1,
                          exec_cache_enabled=False, compute_dtype="float64",
                          serving_result_cache_bytes=0)
    d = _data()
    j.execute("create table ev (k bigint, g bigint, u bigint, w bigint, "
              "x double precision)")
    j.create_distributed_table("ev", "k", shard_count=4)
    j.execute("insert into ev values " + ",".join(
        f"({a},{b},{c},{e},{f})" for a, b, c, e, f in zip(
            d["k"], d["g"], d["u"], d["w"], d["x"])))
    rng = np.random.default_rng(3)
    v = rng.lognormal(3.0, 2.0, 1200)
    v[::300] = 1e15  # catastrophic outliers
    j.execute("create table ht (k bigint, g bigint, v double precision)")
    j.create_distributed_table("ht", "k", shard_count=4)
    j.execute("insert into ht values " + ",".join(
        f"({i}, {i % 3}, {float(x):.6f})" for i, x in enumerate(v)))
    j.execute("create table nz (k bigint, v double precision)")
    j.create_distributed_table("nz", "k", shard_count=2)
    j.execute("insert into nz values " + ",".join(
        f"({i}, {x})" for i, x in enumerate(
            [-1000.0, -10.0, -0.5, 0.0, 0.5, 10.0, 1000.0])))
    j.execute("create table an (k bigint, g bigint, v double precision)")
    j.create_distributed_table("an", "k", shard_count=2)
    j.execute("insert into an values (1, 1, 5.0), (2, 1, 7.0), "
              "(3, 2, null), (4, 2, null), (5, null, 9.0), (6, null, 7.0)")
    j.execute("create table sg (k bigint, seg text, v double precision)")
    j.create_distributed_table("sg", "k", shard_count=2)
    j.execute("insert into sg values " + ",".join(
        f"({i}, '{'ABC'[i % 3]}', {float(i)})" for i in range(300)))
    j.execute("create table f (k bigint)")
    j.create_distributed_table("f", "k", shard_count=4)
    j.execute("insert into f values (1), (2), (7), (4000)")
    p = citus_tpu_torch.connect(data_dir, device="cpu",
                                compute_dtype="float64")
    yield j, p, d
    j.close()


CASES = {
    "acd_global": "select approx_count_distinct(u) from ev",
    "acd_grouped": "select g, approx_count_distinct(u) from ev group by g "
                   "order by g",
    "acd_with_plain": "select g, count(*), approx_count_distinct(w), "
                      "sum(w) from ev group by g order by g",
    "acd_small_cardinality": "select approx_count_distinct(g) from ev",
    "acd_where": "select approx_count_distinct(u) from ev where w < 10",
    "acd_empty": "select approx_count_distinct(u) from ev where w < 0",
    "acd_float_column": "select approx_count_distinct(x) from ev",
    "acd_expression": "select approx_count_distinct(u % 100) from ev",
    "acd_having": "select g, approx_count_distinct(u) as n from ev "
                  "group by g having count(*) > 100 order by g",
    "acd_under_exists": "select approx_count_distinct(u) from ev where "
                        "exists (select 1 from f where f.k = ev.k)",
    "pct_median": "select approx_percentile(x, 0.5) from ev",
    "pct_tail_with_filter": "select approx_percentile(x, 0.95) from ev "
                            "where g = 1",
    "pct_beside_count": "select count(*), approx_percentile(w, 0.5) "
                        "from ev",
    "pct_grouped": "select g, approx_percentile(x, 0.5) from ev group by g "
                   "order by g",
    "pct_grouped_two_quantiles": "select g, count(*), "
                                 "approx_percentile(x, 0.25), "
                                 "approx_percentile(x, 0.9), sum(w) from ev "
                                 "group by g order by g",
    "pct_heavy_tail": "select approx_percentile(v, 0.5) from ht",
    "pct_heavy_tail_grouped": "select g, approx_percentile(v, 0.99) from ht "
                              "group by g order by g",
    "pct_negative_zero": "select approx_percentile(v, 0.5), "
                         "approx_percentile(v, 0.0), "
                         "approx_percentile(v, 1.0) from nz",
    "pct_all_null_group": "select g, count(*), approx_percentile(v, 0.5) "
                          "from an group by g order by g",
    "pct_string_key": "select seg, approx_percentile(v, 0.5), count(*) "
                      "from sg group by seg order by seg",
    "pct_under_exists": "select approx_percentile(x, 1.0) from ev where "
                        "exists (select 1 from f where f.k = ev.k)",
    "pct_empty": "select approx_percentile(x, 0.5) from ev where w < 0",
    "pct_in_subquery": "select count(*) from ev where x > "
                       "(select approx_percentile(x, 0.9) from ev)",
}

REFUSED = {
    "acd_two_arguments": "select approx_count_distinct(u), "
                         "approx_count_distinct(w) from ev",
    "acd_with_exact_distinct": "select approx_count_distinct(u), "
                               "count(distinct w) from ev",
    "pct_expression_argument": "select approx_percentile(x + 1, 0.5) "
                               "from ev",
    "pct_quantile_out_of_range": "select approx_percentile(x, 1.5) from ev",
    "pct_with_distinct": "select distinct approx_percentile(x, 0.5) "
                         "from ev",
    "pct_in_having": "select g from ev group by g "
                     "having approx_percentile(x, 0.5) > 10",
    "pct_expression_key": "select g + 1, approx_percentile(x, 0.5) from ev "
                          "group by g + 1",
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sketch_matches_jax(sessions, name):
    j, p, _d = sessions
    sql = CASES[name]
    want = j.execute(sql).rows()
    got = p.execute(sql).rows()
    compare_results(got, want, "order by" in sql, TOL)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_sketch_refusals_match_jax(sessions, name):
    j, p, _d = sessions
    sql = REFUSED[name]
    with pytest.raises(citus_tpu.CitusTpuError) as jerr:
        j.execute(sql)
    with pytest.raises(citus_tpu_torch.CitusTpuError) as perr:
        p.execute(sql)
    assert type(perr.value).__name__ == type(jerr.value).__name__


def test_hll_within_its_error_against_numpy(sessions):
    """Grouped and global estimates within 6% of the exact distinct
    count (HLL standard error 1.6% at p = 12)."""
    _j, p, d = sessions
    got = p.execute(CASES["acd_global"]).rows()[0][0]
    exact = len(np.unique(d["u"]))
    assert abs(got - exact) <= 0.06 * exact, (got, exact)
    for g, est in p.execute(CASES["acd_grouped"]).rows():
        exact = len(np.unique(d["u"][d["g"] == g]))
        assert abs(est - exact) <= 0.06 * exact, (g, est, exact)
    assert p.execute(CASES["acd_small_cardinality"]).rows() == [(4,)]
    assert p.execute(CASES["acd_empty"]).rows() == [(0,)]


def test_ddsketch_within_its_error_against_numpy(sessions):
    """|x̂ - x_q| ≤ 1.5% of x_q (α ≈ 1% plus nearest-rank slack)."""
    _j, p, d = sessions
    for g, got in p.execute(CASES["pct_grouped"]).rows():
        exact = float(np.quantile(d["x"][d["g"] == g], 0.5))
        assert abs(got - exact) <= 0.015 * exact, (g, got, exact)
    rows = dict((g, (c, v)) for g, c, v in
                p.execute(CASES["pct_all_null_group"]).rows())
    assert rows[2] == (2, None)
