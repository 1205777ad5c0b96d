"""All 22 TPC-H queries through the port, row-identical to the JAX
package and to the sqlite oracle on the same data_dir.

A JAX Session (n_devices=1, exec cache off, compute_dtype float64, no
serving cache) loads TPC-H at seed 7 and answers every query; the port
opens that data_dir on device="cpu" with the same compute dtype.  Most
queries run at sf 0.002.  Q11, Q13, Q15, Q16 and Q22 run at sf 0.01 (as
tests/test_tpch_extra.py does), where every one of them returns rows.
dbgen-lite draws o_custkey uniformly over ten orders per customer, so a
customer without orders has probability about e^-10 and Q22's NOT
EXISTS finds none at any scale a CPU test loads: the sf 0.01 data_dir
also holds eight customers without orders, inserted through the JAX
package and given to the oracle, which gives Q22 rows and Q13's LEFT
JOIN unmatched customers.

Q9, Q18 and Q21 run again with the bucketed probe and group-by paths
forced on (the paths the bucketed_probe and bucketed_groupby_sums
kernels serve on the card).  After every statement no `__intermediate_`
temp is left in the catalog, the data_dir or the feed cache, and the
accountant holds no prefetch bytes.

Tolerance: 1e-9 relative on floats, exact on keys and counts.
"""

import os

import numpy as np
import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu.ingest import tpch as jtpch
from citus_tpu_torch.ingest import tpch as ptpch
from oracle import compare_results, make_oracle, run_oracle

torch.set_num_threads(1)

SEED = 7
SMALL_SF, WIDE_SF = 0.002, 0.01
WIDE = {"Q11", "Q13", "Q15", "Q16", "Q22"}
ALL = sorted(ptpch.QUERIES, key=lambda q: int(q[1:]))
TOL = 1e-9
DATE_COLUMNS = {
    "orders": ["o_orderdate"],
    "lineitem": ["l_shipdate", "l_commitdate", "l_receiptdate"],
}
# customers without orders, phone prefixes inside Q22's list and
# balances above its average
ORPHANS = 8


def _orphan_customers(first_key: int) -> dict:
    keys = np.arange(first_key, first_key + ORPHANS, dtype=np.int64)
    prefixes = ["13", "31", "23", "29", "30", "18", "17", "13"]
    return {
        "c_custkey": keys,
        "c_name": np.array([f"Customer#{k:09d}" for k in keys],
                           dtype=object),
        "c_address": np.array([f"addr orphan {k}" for k in keys],
                              dtype=object),
        "c_nationkey": (keys % 25).astype(np.int32),
        "c_phone": np.array([f"{p}-{i:03d}" for i, p in enumerate(prefixes)],
                            dtype=object),
        "c_acctbal": np.round(9000.0 + 111.25 * np.arange(ORPHANS), 2),
        "c_mktsegment": np.array(["BUILDING"] * ORPHANS, dtype=object),
        "c_comment": np.array([f"orphan {k}" for k in keys], dtype=object),
    }


def _load(data_dir: str, sf: float, queries, orphans: bool):
    """Load TPC-H through the JAX package; → (JAX answers, oracle)."""
    tables = jtpch.generate_tables(sf, seed=SEED)
    sess = citus_tpu.connect(data_dir=data_dir, n_devices=1,
                             exec_cache_enabled=False,
                             compute_dtype="float64",
                             serving_result_cache_bytes=0)
    try:
        jtpch.load_into_session(sess, sf=sf, seed=SEED)
        if orphans:
            cust = tables["customer"]
            extra = _orphan_customers(int(cust["c_custkey"].max()) + 1)
            sess.execute("insert into customer values " + ", ".join(
                "({}, '{}', '{}', {}, '{}', {}, '{}', '{}')".format(
                    *(extra[c][i] for c in cust)) for i in range(ORPHANS)))
            for c in cust:
                cust[c] = np.concatenate([cust[c], extra[c]])
        want = {q: sess.execute(ptpch.QUERIES[q]).rows() for q in queries}
    finally:
        sess.close()
    return want, make_oracle(tables, DATE_COLUMNS)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("tpch22_small"))
    want, oracle = _load(data_dir, SMALL_SF,
                         [q for q in ALL if q not in WIDE], orphans=False)
    return data_dir, want, oracle


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("tpch22_wide"))
    want, oracle = _load(data_dir, WIDE_SF, sorted(WIDE), orphans=True)
    return data_dir, want, oracle


@pytest.fixture
def forced_bucketed(monkeypatch):
    """Walk the bucketed probe and group-by paths on the CPU."""
    import citus_tpu_torch.ops.join as pjoin
    import citus_tpu_torch.planner.plan as pplan

    monkeypatch.setattr(pplan, "bucketed_paths_enabled", lambda dev: True)
    monkeypatch.setattr(pjoin, "PROBE_BUCKET_MIN_EXTENT", 1 << 10)


def assert_no_temps(sess) -> None:
    """No intermediate result outlives its statement: not in the
    catalog, the data_dir or the feed cache, and no prefetch bytes."""
    prefix = "__intermediate_"
    assert not [t for t in sess.catalog.tables if t.startswith(prefix)]
    assert not [t for t in os.listdir(os.path.join(sess.data_dir, "tables"))
                if t.startswith(prefix)]
    fc = sess.executor.feed_cache
    assert not [k for k in fc._entries if k[0].startswith(prefix)]
    assert sess.executor.accountant.snapshot()["live_prefetch_bytes"] == 0


def _run_port(data_dir: str, q: str):
    sess = citus_tpu_torch.connect(data_dir, device="cpu",
                                   compute_dtype="float64",
                                   serving_result_cache_bytes=0)
    result = sess.execute(ptpch.QUERIES[q])
    assert_no_temps(sess)
    return result.rows()


@pytest.mark.parametrize("q", ALL)
def test_query_matches_jax_and_oracle(request, q):
    data_dir, want, oracle = request.getfixturevalue(
        "wide" if q in WIDE else "small")
    sql = ptpch.QUERIES[q]
    ordered = "order by" in sql.lower()
    got = _run_port(data_dir, q)
    assert len(got) > 0
    compare_results(got, want[q], ordered, TOL)
    compare_results(got, run_oracle(oracle, sql), ordered, TOL)


# Q21's probe streams stay under a quarter of the orders directory at
# sf 0.002, so the planner's size rule keeps the single gather there
BUCKETED = {"Q9": True, "Q18": True, "Q21": False}


@pytest.mark.parametrize("q", sorted(BUCKETED))
def test_bucketed_paths_match_jax(small, forced_bucketed, monkeypatch, q):
    from citus_tpu_torch.ops import hopper_kernels as hk

    calls = []
    for name in ("bucketed_probe", "bucketed_groupby_sums"):
        real = getattr(hk, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(hk, name, spy)
    data_dir, want, _oracle = small
    got = _run_port(data_dir, q)
    assert bool(calls) == BUCKETED[q], calls
    compare_results(got, want[q], "order by" in ptpch.QUERIES[q].lower(),
                    TOL)
