"""The port's slab-streamed TPC-H loader (citus_tpu_torch/ingest/
tpch_slab.py) against the JAX package's.

Both packages' `load_slabbed` at SF 0.01 over three order slabs, with
the same seed and shard count, into data_dirs of their own: the same
row counts (customer and orders at `table_rows`), the same answers to
Q1, Q3 and a GROUP BY count from the JAX session, the port on the CPU
(float64 on both) and the sqlite oracle over the batches the port
ingested, and each package reads the other's data_dir with the same
rows.
"""

import numpy as np
import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu.ingest import tpch_slab as jslab
from citus_tpu_torch.ingest import tpch as ptpch
from citus_tpu_torch.ingest import tpch_slab as pslab
from oracle import compare_results, make_oracle, run_oracle

torch.set_num_threads(1)

SF, SLAB, SEED, SHARDS = 0.01, 5000, 11, 4
TOL = 1e-9
DATE_COLUMNS = {
    "orders": ["o_orderdate"],
    "lineitem": ["l_shipdate", "l_commitdate", "l_receiptdate"],
}
SQL = {"Q1": ptpch.QUERIES["Q1"], "Q3": ptpch.QUERIES["Q3"],
       "flags": "select l_returnflag, count(*) from lineitem group by 1 "
                "order by 1"}
TABLES = ("customer", "orders", "lineitem")
COUNT = {t: f"select count(*) from {t}" for t in TABLES}
_JAX = dict(n_devices=1, exec_cache_enabled=False, compute_dtype="float64",
            serving_result_cache_bytes=0, recover_2pc_interval_ms=-1,
            defer_shard_delete_interval_ms=-1, health_check_interval_ms=-1)


def _port(data_dir):
    return citus_tpu_torch.connect(data_dir, device="cpu",
                                   compute_dtype="float64",
                                   serving_result_cache_bytes=0,
                                   exec_cache_enabled=False)


def _jax(data_dir):
    return citus_tpu.connect(data_dir=data_dir, **_JAX)


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    root = tmp_path_factory.mktemp("slab")
    jdir, pdir = str(root / "jax"), str(root / "port")
    batches: dict[str, list] = {}
    real = pslab._ingest_batch

    def record(session, table, columns, batch, pre_typed=False):
        batches.setdefault(table, []).append(dict(zip(columns, batch)))
        return real(session, table, columns, batch, pre_typed=pre_typed)

    slabs = {"jax": [], "port": []}
    j = _jax(jdir)
    jcounts = jslab.load_slabbed(
        j, SF, seed=SEED, shard_count=SHARDS, slab_orders=SLAB,
        progress=lambda *a: slabs["jax"].append(a))
    pslab._ingest_batch = record
    try:
        p = _port(pdir)
        pcounts = pslab.load_slabbed(
            p, SF, seed=SEED, shard_count=SHARDS, slab_orders=SLAB,
            progress=lambda *a: slabs["port"].append(a))
    finally:
        pslab._ingest_batch = real
    tables = {t: {c: np.concatenate([np.asarray(b[c]) for b in bs])
                  for c in bs[0]} for t, bs in batches.items()}
    yield {"jdir": jdir, "pdir": pdir, "j": j, "p": p,
           "counts": (jcounts, pcounts), "slabs": slabs,
           "oracle": make_oracle(tables, DATE_COLUMNS)}
    j.close()
    p.close()


def _rows(sess, sql):
    return [tuple(x.item() if hasattr(x, "item") else x for x in r)
            for r in sess.execute(sql).rows()]


def test_same_counts_over_three_slabs(loaded):
    jcounts, pcounts = loaded["counts"]
    assert jcounts == pcounts
    want = ptpch.table_rows(SF)
    assert pcounts["customer"] == want["customer"]
    assert pcounts["orders"] == want["orders"]
    # three order slabs, each reported once in both packages
    assert loaded["slabs"]["port"] == loaded["slabs"]["jax"]
    assert sum(1 for s in loaded["slabs"]["port"]
               if s[0] == "orders+lineitem") == 3
    for t in TABLES:
        assert _rows(loaded["p"], COUNT[t]) == [(pcounts[t],)]
        assert _rows(loaded["j"], COUNT[t]) == [(jcounts[t],)]


@pytest.mark.parametrize("table, sql", [
    ("customer", "select c_custkey, c_name, c_address, c_nationkey, "
                 "c_phone, c_acctbal, c_mktsegment, c_comment from "
                 "customer order by 1"),
    ("orders", "select o_orderkey, o_custkey, o_orderstatus, o_totalprice, "
               "o_orderdate, o_orderpriority, o_clerk, o_comment from "
               "orders order by 1"),
    ("lineitem", "select l_orderkey, l_linenumber, l_partkey, l_suppkey, "
                 "l_quantity, l_extendedprice, l_discount, l_tax, "
                 "l_returnflag, l_linestatus, l_shipdate, l_commitdate, "
                 "l_receiptdate, l_shipinstruct, l_shipmode, l_comment "
                 "from lineitem order by 1, 2"),
])
def test_same_seed_gives_the_same_rows(loaded, table, sql):
    got = _rows(loaded["p"], sql)
    assert len(got) == loaded["counts"][1][table]
    assert got == _rows(loaded["j"], sql)


@pytest.mark.parametrize("q", sorted(SQL))
def test_answers_match_jax_and_the_oracle(loaded, q):
    sql = SQL[q]
    ordered = "order by" in sql.lower()
    got = _rows(loaded["p"], sql)
    assert got, q
    compare_results(got, _rows(loaded["j"], sql), ordered, TOL)
    compare_results(got, run_oracle(loaded["oracle"], sql), ordered, TOL)


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_each_package_reads_the_others_data_dir(loaded, reader):
    # the port reads what the JAX package loaded, and the reverse
    other = loaded["jdir"] if reader == "port" else loaded["pdir"]
    sess = _port(other) if reader == "port" else _jax(other)
    try:
        for sql in (SQL["Q1"], SQL["flags"], COUNT["customer"]):
            compare_results(_rows(sess, sql), _rows(loaded["p"], sql),
                            "order by" in sql.lower(), TOL)
    finally:
        sess.close()
