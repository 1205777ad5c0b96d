"""The port's INSERT … VALUES, UPDATE, DELETE, MERGE and COPY … FROM,
against the JAX package on two copies of one data_dir.

The base data_dir holds TPC-H at sf 0.002 (seed 7, loaded by the port's
dbgen-lite), the accounts / payments / closures tables of the JAX
package's tests/test_dml.py, a table with NULLs and a reference table.
Each case copies it twice, runs the same statements through a JAX
session on one copy and a port session on the other, and holds every
affected count, every row of the written tables, the manifests' delete
bookkeeping (`deletes`, `del_version`, `live_rows` per stripe) and the
change feed to each other, exactly.  Both sides compute UPDATE values
in numpy float64, so those are exact too; aggregates read back through
the device path are held at rtol 1e-9.
"""

import json
import os
import shutil

import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu_torch.ingest import tpch as ptpch
from oracle import compare_results

torch.set_num_threads(1)

TOL = 1e-9

SETUP = """
create table accounts (id int, tenant int, balance double precision,
                       status text);
select create_distributed_table('accounts', 'tenant', 8);
insert into accounts values
  (1, 10, 100.0, 'open'), (2, 10, 250.0, 'open'),
  (3, 20, 50.0, 'frozen'), (4, 30, 75.0, 'open'),
  (5, 30, 0.0, 'closed'), (6, 40, 500.0, 'open'),
  (7, 55, 20.0, 'frozen'), (8, 60, 10.0, 'open');
create table payments (tenant int, amount double precision);
select create_distributed_table('payments', 'tenant', 8);
insert into payments values (10, 5.0), (20, 7.0), (99, 42.0);
create table closures (tenant int);
select create_distributed_table('closures', 'tenant', 8);
insert into closures values (30), (40), (77);
create table src (k int, v int);
select create_reference_table('src');
insert into src values (10, 5), (null, 7), (20, 1);
create table cfg (k text, v int);
select create_reference_table('cfg');
insert into cfg values ('a', 1), ('b', 2), ('c', 3);
create table nt (id bigint, x double precision, y bigint, flag text);
select create_distributed_table('nt', 'id', 4);
insert into nt values (1, 1.5, 10, 'a'), (2, null, 20, 'b'),
  (3, 3.5, null, null), (4, 4.5, 40, 'a'), (5, null, null, 'c'),
  (6, 6.5, 60, 'b');
create sequence acct_seq start 100;
"""

# read-backs per written table
READS = {
    "accounts": "select id, tenant, balance, status from accounts",
    "payments": "select tenant, amount from payments",
    "cfg": "select k, v from cfg",
    "nt": "select id, x, y, flag from nt",
    "orders": "select o_orderkey, o_custkey, o_orderstatus, o_totalprice, "
              "o_orderdate, o_orderpriority from orders",
    "lineitem": "select l_orderkey, l_linenumber, l_quantity, l_discount, "
                "l_shipdate, l_returnflag from lineitem",
}
AGGREGATES = {
    "orders": "select o_orderpriority, count(*), count(o_totalprice), "
              "sum(o_totalprice) from orders group by o_orderpriority "
              "order by o_orderpriority",
    "lineitem": "select l_returnflag, count(*), sum(l_quantity), "
                "sum(l_discount) from lineitem group by l_returnflag "
                "order by l_returnflag",
}


def _jax(data_dir):
    return citus_tpu.connect(data_dir=data_dir, n_devices=1,
                             exec_cache_enabled=False,
                             compute_dtype="float64",
                             serving_result_cache_bytes=0)


def _port(data_dir, **settings):
    return citus_tpu_torch.connect(data_dir, device="cpu",
                                   compute_dtype="float64", **settings)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("torch_dml") / "base")
    p = _port(data_dir)
    ptpch.load_into_session(p, sf=0.002, seed=7)
    p.execute(SETUP)
    p.close()
    return data_dir


@pytest.fixture()
def pair(base, tmp_path):
    """A JAX session and a port session, each on its own copy of base."""
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(base, jdir)
    shutil.copytree(base, pdir)
    j = _jax(jdir)
    yield j, _port(pdir)
    j.close()


def manifest_state(data_dir, table):
    """Per shard, per stripe: (file, rows, deletes, del_version,
    live_rows) — the delete bookkeeping both packages must write."""
    with open(os.path.join(data_dir, "tables", table,
                           "MANIFEST.json")) as f:
        man = json.load(f)
    return {sid: [(r["file"], r["rows"], r.get("deletes"),
                   r.get("del_version"), r.get("live_rows"))
                  for r in recs]
            for sid, recs in man["shards"].items()}


def feed(sess):
    return [tuple(int(x) if isinstance(x, int) or hasattr(x, "item")
                  else x for x in r)
            for r in sess.execute("select citus_change_feed()").rows()]


def assert_same_state(j, p, tables):
    for t in tables:
        compare_results(p.execute(READS[t]).rows(),
                        j.execute(READS[t]).rows(), False, 0.0)
        if t in AGGREGATES:
            compare_results(p.execute(AGGREGATES[t]).rows(),
                            j.execute(AGGREGATES[t]).rows(), True, TOL)
        assert manifest_state(p.data_dir, t) == \
            manifest_state(j.data_dir, t), t
    assert feed(p) == feed(j)


def run_both(j, p, statements):
    """Each statement through both packages; affected counts equal."""
    for sql in statements:
        want = j.execute(sql)
        got = p.execute(sql)
        if want is None:
            assert got is None, sql
            continue
        assert got.rows() == want.rows(), sql


CASES = {
    "insert_values_nextval": (
        ["insert into accounts values (nextval('acct_seq'), 70, 1.0, "
         "'new'), (nextval('acct_seq'), 80, null, null)",
         "insert into accounts (id, tenant) values (nextval('acct_seq'), "
         "10)",
         "insert into cfg values ('d', 4)"],
        ["accounts", "cfg"]),
    "delete_router_single_shard": (
        ["delete from accounts where tenant = 10"], ["accounts"]),
    "delete_multi_shard_and_string": (
        ["delete from accounts where balance < 60",
         "delete from accounts where status = 'frozen'"], ["accounts"]),
    "update_arithmetic_and_router": (
        ["update accounts set balance = balance * 2 where status = 'open'",
         "update accounts set balance = balance + 1, status = 'touched' "
         "where tenant = 30"], ["accounts"]),
    "update_null_then_string": (
        ["update accounts set status = null where id = 1",
         "update accounts set status = 'gone' where status is null",
         "update nt set x = null where y > 30",
         "update nt set flag = 'z' where x is null"], ["accounts", "nt"]),
    "update_after_delete_chain": (
        ["delete from accounts where tenant = 10",
         "update accounts set balance = 0 where status = 'frozen'",
         "delete from accounts where balance = 0",
         "delete from accounts"], ["accounts"]),
    "where_subqueries": (
        ["delete from accounts where tenant in "
         "(select tenant from closures)",
         "update accounts set balance = balance + 1 where tenant = "
         "(select min(tenant) from payments)",
         "delete from accounts where exists "
         "(select 1 from payments where amount > 40) and balance < 30",
         "update nt set y = 0 where id not in (select id from nt "
         "where flag = 'a')"], ["accounts", "nt"]),
    "reference_table": (
        ["update cfg set v = v * 10 where k <> 'a'",
         "delete from cfg where v = 30"], ["cfg"]),
    "tpch_orders_lineitem": (
        ["update orders set o_totalprice = o_totalprice * 1.1 "
         "where o_orderdate < date '1993-01-01'",
         "update orders set o_totalprice = null where o_custkey in "
         "(select c_custkey from customer where c_nationkey = 3)",
         "delete from orders where o_orderstatus = 'F' "
         "and o_orderdate >= date '1994-01-01'",
         "delete from lineitem where l_orderkey in (select o_orderkey "
         "from orders where o_orderpriority = '1-URGENT')",
         "update lineitem set l_discount = l_discount + 0.01 "
         "where l_shipdate < date '1993-06-01'"],
        ["orders", "lineitem"]),
    "merge_update_insert": (
        ["merge into accounts a using payments p on a.tenant = p.tenant "
         "when matched then update set balance = a.balance + p.amount "
         "when not matched then insert (id, tenant, balance, status) "
         "values (100, p.tenant, p.amount, 'new')"], ["accounts"]),
    "merge_delete_conditions": (
        ["merge into accounts a using closures c on a.tenant = c.tenant "
         "when matched and a.balance > 100 then update set status = "
         "'review' when matched then delete "
         "when not matched then do nothing"], ["accounts"]),
    "merge_subquery_source": (
        ["merge into accounts a using (select tenant, count(*) as n "
         "from accounts where status = 'open' group by tenant) s "
         "on a.tenant = s.tenant when matched then update set "
         "balance = a.balance + s.n when not matched then do nothing"],
        ["accounts"]),
    "merge_null_key_reference_source": (
        ["merge into payments t using src on t.tenant = src.k "
         "when matched then update set amount = src.v "
         "when not matched and src.v > 3 then insert (tenant, amount) "
         "values (src.v, src.v)"], ["payments"]),
    "merge_condition_per_target_row": (
        ["merge into accounts a using payments p on a.tenant = p.tenant "
         "when matched and a.balance > 200 then delete"], ["accounts"]),
    "merge_not_over_null_condition": (
        ["update accounts set status = null where id = 1",
         "merge into accounts a using payments p on a.tenant = p.tenant "
         "when matched and not (a.status = 'open' or a.status = 'x') "
         "then delete"], ["accounts"]),
    "merge_into_reference_table": (
        ["merge into cfg using (select k, v from cfg where v > 1) s "
         "on cfg.k = s.k when matched and s.v = 2 then delete "
         "when matched then update set v = cfg.v + 100"], ["cfg"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dml_matches_jax(pair, name):
    j, p = pair
    statements, tables = CASES[name]
    run_both(j, p, statements)
    assert_same_state(j, p, tables)


def test_dist_column_dml_touches_one_shard(pair):
    """A DML statement constrained on the distribution column locks and
    rewrites one shard: only that shard's manifest records change."""
    j, p = pair
    before = manifest_state(p.data_dir, "orders")
    key = int(p.execute("select min(o_orderkey) from orders").rows()[0][0])
    held = []
    acquire = p.locks.acquire

    def spy(txid, resource, timeout=10.0):
        held.append(resource)
        return acquire(txid, resource, timeout)

    p.locks.acquire = spy
    run_both(j, p, [
        f"update orders set o_totalprice = 1.0 where o_orderkey = {key}",
        f"delete from orders where o_orderkey = {key} "
        "and o_totalprice = 1.0"])
    after = manifest_state(p.data_dir, "orders")
    changed = [sid for sid in after if after[sid] != before[sid]]
    assert len(changed) == 1
    assert held == [("orders", int(changed[0]))] * 2
    assert len(p.catalog.table_shards("orders")) > 1
    assert_same_state(j, p, ["orders"])


def test_copy_from_header_delimiter_nulls(pair, tmp_path):
    j, p = pair
    csv_path = tmp_path / "rows.csv"
    csv_path.write_text("id|tenant|balance|status\n"
                        "11|10|1.25|open\n12|20|\\N|\\N\n"
                        "13|99|3.5|closed\n14|30||x\n")
    tbl_path = tmp_path / "rows.tbl"
    tbl_path.write_text("a|7|\nq|8|\n|9|\n")
    run_both(j, p, [
        f"copy accounts from '{csv_path}' with (format csv, header true, "
        "delimiter '|', null '\\N')",
        f"copy cfg from '{tbl_path}' with (delimiter '|')"])
    assert_same_state(j, p, ["accounts", "cfg"])


def test_cancel_stops_copy_cleanly(pair, tmp_path):
    """Session.cancel() from another thread while the COPY sits in a
    delayed seam: the COPY raises QueryCanceled at its next seam, its
    invisible stripes are discarded, and the session runs the next
    statement."""
    import threading
    import time

    from citus_tpu_torch.utils.faultinjection import fired_count, inject

    _j, p = pair
    path = tmp_path / "rows.csv"
    path.write_text("".join(f"{100 + i},{i},1.0,open\n" for i in range(50)))
    before = manifest_state(p.data_dir, "accounts")
    fired = fired_count("store.append_stripe")

    def cancel_in_the_delay():
        deadline = time.monotonic() + 30
        while fired_count("store.append_stripe") == fired and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        p.cancel()

    canceller = threading.Thread(target=cancel_in_the_delay)
    with inject("store.append_stripe", sleep=0.5, error=None,
                require_fired=True):
        canceller.start()
        with pytest.raises(citus_tpu_torch.QueryCanceled):
            p.execute(f"copy accounts from '{path}' with (format csv)")
    canceller.join()
    assert manifest_state(p.data_dir, "accounts") == before
    stripes = {f for sid in before for f in os.listdir(
        os.path.join(p.data_dir, "tables", "accounts", f"shard_{sid}"))}
    assert all(f.startswith("stripe_") for f in stripes)
    assert len(stripes) == sum(len(v) for v in before.values())
    assert p.execute("select count(*) from accounts").rows() == [(8,)]


def test_dml_errors_match_jax(pair):
    """The refusals both packages raise, with the same error class and
    no partial effect."""
    j, p = pair
    run_both(j, p, ["insert into src values (10, 9)"])
    for sql in ["update accounts set tenant = 99 where id = 1",
                # two source rows match tenant 10's target rows
                "merge into accounts using src on accounts.tenant = src.k "
                "when matched then update set balance = 1",
                "merge into accounts a using payments o on a.id = o.tenant "
                "when matched then delete",
                "merge into accounts using src on accounts.tenant = src.k "
                "when matched then update set balance = 1 "
                "when not matched then insert (id, tenant) "
                "values (src.v, src.k)",
                "insert into accounts values (1, 2)"]:
        with pytest.raises(citus_tpu.CitusTpuError) as jerr:
            j.execute(sql)
        with pytest.raises(citus_tpu_torch.CitusTpuError) as perr:
            p.execute(sql)
        assert type(perr.value).__name__ == type(jerr.value).__name__, sql
    assert_same_state(j, p, ["accounts"])


# what the write-path slice left for later, refused until then naming its
# ROADMAP item: the mesh UDFs, answered since the mesh slice as the JAX
# package answers them (citus_drain_device() without its argument fails
# the same way in both)
LATER = {
    "select citus_stat_mesh()": "queue A item 9",
    "select citus_drain_device()": "queue A item 9",
    "select citus_rebalance_mesh()": "queue A item 9",
}


def _outcome(sess, sql):
    try:
        r = sess.execute(sql)
    except Exception as e:  # the error's kind is the outcome compared
        return type(e).__name__
    return r.column_names, r.rows()[0][:5]


@pytest.mark.parametrize("sql", sorted(LATER))
def test_later_shapes_are_refused(pair, sql):
    j, p = pair
    assert _outcome(p, sql) == _outcome(j, sql)


