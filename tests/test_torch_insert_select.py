"""The port's INSERT … SELECT, against the JAX package on two copies of
one data_dir: the colocated and the host-routed repartition modes (each
asserting the mode both packages chose), a set-operation source, the
pull fallback for a source the raw path refuses, and a STRING column
whose codes are translated from the source's dictionary into the
target's.

The base data_dir holds TPC-H at sf 0.002 (seed 7, the port's
dbgen-lite) and a table with NULLs.  Row counts, keys, strings, dates,
NULL patterns and the target dictionaries are held exact; sums that the
source's GROUP BY computes on the device path at rtol 1e-9.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu.executor import insert_select as jis
from citus_tpu_torch.catalog.distribution import hash_token
from citus_tpu_torch.executor import insert_select as pis
from citus_tpu_torch.ingest import tpch as ptpch
from citus_tpu_torch.sql import parse as pparse
from citus_tpu.sql import parse as jparse
from oracle import compare_results

torch.set_num_threads(1)

TOL = 1e-9

ORDERS_COLS = ("o_orderkey bigint, o_custkey bigint, o_orderstatus text, "
               "o_totalprice double precision, o_orderdate date, "
               "o_orderpriority text, o_clerk text, o_shippriority int, "
               "o_comment text")
SETUP = f"""
create table nt (id bigint, x double precision, y bigint, flag text);
select create_distributed_table('nt', 'id', 4);
insert into nt values (1, 1.5, 10, 'a'), (2, null, 20, 'b'),
  (3, 3.5, null, null), (4, 4.5, 40, 'a'), (5, null, null, 'c'),
  (6, 6.5, 60, 'b');
create table orders_w ({ORDERS_COLS});
create table orders_by_cust ({ORDERS_COLS});
create table li_agg (l_orderkey bigint, qty double precision, n bigint);
create table flags (flag text, id bigint, x double precision);
select create_reference_table('flags');
insert into flags values ('zz', 100, 0.5);
"""


def _jax(data_dir):
    return citus_tpu.connect(data_dir=data_dir, n_devices=1,
                             exec_cache_enabled=False,
                             compute_dtype="float64",
                             serving_result_cache_bytes=0)


def _port(data_dir):
    return citus_tpu_torch.connect(data_dir, device="cpu",
                                   compute_dtype="float64")


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("torch_insert_select") / "base")
    p = _port(data_dir)
    ptpch.load_into_session(p, sf=0.002, seed=7)
    p.execute(SETUP)
    p.create_distributed_table("orders_w", "o_orderkey", 8,
                               colocate_with="orders")
    p.create_distributed_table("orders_by_cust", "o_custkey", 8)
    p.create_distributed_table("li_agg", "l_orderkey", 8)
    p.close()
    return data_dir


@pytest.fixture()
def pair(base, tmp_path):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(base, jdir)
    shutil.copytree(base, pdir)
    j = _jax(jdir)
    yield j, _port(pdir)
    j.close()


def insert_select_both(j, p, sql):
    """→ (mode, inserted count) — the same in both packages."""
    jres, jmode = jis.execute_insert_select(j, jparse(sql)[0])
    pres, pmode = pis.execute_insert_select(p, pparse(sql)[0])
    assert pmode == jmode, sql
    assert pres.rows() == jres.rows(), sql
    return pmode, int(pres.rows()[0][0])


def same_rows(j, p, sql, tol=0.0):
    got = p.execute(sql).rows()
    compare_results(got, j.execute(sql).rows(), "order by" in sql, tol)
    return got


def routed_by(sess, table, column):
    """Every row sits in the shard its key's token routes to."""
    for sh in sess.catalog.table_shards(table):
        vals, _m, n = sess.store.read_shard(table, sh.shard_id, [column])
        if n:
            toks = hash_token(np.asarray(vals[column], dtype=np.int64))
            assert all(sh.contains_token(int(t)) for t in toks)


ORDERS_READ = ("select o_orderkey, o_custkey, o_orderstatus, o_totalprice, "
               "o_orderdate, o_orderpriority, o_clerk, o_shippriority, "
               "o_comment from {t}")


def test_colocated_mode(pair):
    j, p = pair
    mode, n = insert_select_both(j, p,
                                 "insert into orders_w select * from orders")
    assert mode == "colocated"
    assert n == p.store.table_row_count("orders")
    same_rows(j, p, ORDERS_READ.format(t="orders_w"))
    same_rows(j, p, "select o_orderpriority, count(*), "
                    "sum(o_totalprice) from orders_w group by "
                    "o_orderpriority order by o_orderpriority", TOL)
    routed_by(p, "orders_w", "o_orderkey")


def test_host_routed_repartition_mode(pair):
    j, p = pair
    mode, n = insert_select_both(
        j, p, "insert into orders_by_cust select * from orders "
              "where o_orderdate < date '1995-01-01'")
    assert mode == "repartition"
    assert n > 0
    same_rows(j, p, ORDERS_READ.format(t="orders_by_cust"))
    routed_by(p, "orders_by_cust", "o_custkey")


def test_group_by_source(pair):
    """A GROUP BY source: the sums come off the device path, and the
    aggregate's output routes on the host."""
    j, p = pair
    mode, n = insert_select_both(
        j, p, "insert into li_agg select l_orderkey, sum(l_quantity), "
              "count(*) from lineitem group by l_orderkey")
    assert mode == "repartition"
    assert n == p.execute("select count(distinct l_orderkey) "
                          "from lineitem").rows()[0][0]
    same_rows(j, p, "select l_orderkey, qty, n from li_agg", TOL)


def test_set_operation_source(pair):
    j, p = pair
    sql = ("insert into flags (flag, id, x) "
           "select flag, id, x from nt where x > 2 "
           "union select flag, id + 10, x from nt where y is null")
    assert j.execute(sql).rows() == p.execute(sql).rows()
    same_rows(j, p, "select flag, id, x from flags")


def test_string_codes_translate_between_dictionaries(pair):
    """flags has its own dictionary ('zz' first): nt's codes for 'a',
    'b', 'c' are translated, only the codes present are interned, and
    the target dictionary file is the JAX package's byte for byte."""
    j, p = pair
    mode, n = insert_select_both(
        j, p, "insert into flags select flag, id, x from nt "
              "where flag <> 'b'")
    assert n == 3
    same_rows(j, p, "select flag, id, x from flags")
    jd = os.path.join(j.data_dir, "tables", "flags", "dict_flag.json")
    pd = os.path.join(p.data_dir, "tables", "flags", "dict_flag.json")
    with open(jd, "rb") as a, open(pd, "rb") as b:
        assert a.read() == b.read()
    assert p.store.dictionary("flags", "flag").values == ["zz", "a", "c"]


def test_pull_fallback(pair, monkeypatch):
    """When the raw path refuses the source (PlanningError or
    UnsupportedQueryError), both packages run it as a plain SELECT and
    insert its rows (the reference's pull-to-coordinator mode).  The
    refusal is forced at the mode choice, in both packages alike."""
    j, p = pair
    refused = []
    for mod, err in ((jis, citus_tpu.UnsupportedQueryError),
                     (pis, citus_tpu_torch.UnsupportedQueryError)):
        def refuse(*_a, _err=err, **_kw):
            refused.append(_err.__module__.split(".")[0])
            raise _err("raw path refused")

        monkeypatch.setattr(mod, "choose_mode", refuse)
    sql = ("insert into orders_by_cust select * from orders "
           "where o_orderstatus = 'O' order by o_orderkey limit 50")
    assert j.execute(sql).rows() == p.execute(sql).rows() == [(50,)]
    assert refused == ["citus_tpu", "citus_tpu_torch"]
    same_rows(j, p, ORDERS_READ.format(t="orders_by_cust"))
    routed_by(p, "orders_by_cust", "o_custkey")
