"""The port's transactions, 2PC commit log, recovery, shard locks, fault
seams and change feed, against the JAX package.

* BEGIN … COMMIT / ROLLBACK: a SELECT in the open transaction sees its
  staged rows (the overlay), ROLLBACK unlinks the staged stripe files,
  COMMIT makes them durable for a fresh session;
* two threads that deadlock on two shards: one gets
  DeadlockDetectedError and its transaction rolls back;
* every named fault point of the port (utils/faultinjection.py), armed
  in the port and, at the same point, in the JAX package on a copy of
  the same data_dir: the statement fails in both, and after reopening
  both hold the same rows, manifests and change feed;
* a crash at `txn.apply` in one package recovered by the other;
* a replication factor of 2: the port mirrors every new stripe to the
  replica dirs, file for file as the JAX package does;
* citus_change_feed and citus_get_node_clock against the JAX package;
* a power-cut sweep (utils/crashsim.py) over every durable write of an
  autocommit UPDATE and of a transaction's COMMIT: the reopened port
  session sees the old state or the new one, never a mix;
* the round trip: each package opens what the other wrote after DML and
  answers a fixed list of SELECTs alike.

Both packages' sessions run without their statement retry envelope
(max_statement_retries=0), and the JAX ones without background daemons,
so a failure is the statement's own and the next session recovers it
(tests/test_torch_resilience.py holds the envelope's outcomes).  Rows, manifests and feeds are held
exact; sums at rtol 1e-9.
"""

import glob
import json
import os
import shutil
import threading

import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu.utils import faultinjection as jfi
from citus_tpu_torch.ingest import tpch as ptpch
from citus_tpu_torch.ingest.copy_from import _ingest_batch
from citus_tpu_torch.transaction.locks import DeadlockDetectedError
from citus_tpu_torch.utils import faultinjection as pfi
from citus_tpu_torch.utils.crashsim import PowerCut, power_cut_at
from oracle import compare_results

torch.set_num_threads(1)

TOL = 1e-9

SEED = {i: 100 + i for i in range(40)}

SETUP = """
create table kv (id bigint, v bigint);
select create_distributed_table('kv', 'id', 4);
insert into kv values {rows};
create table kv_by_v (id bigint, v bigint);
select create_distributed_table('kv_by_v', 'v', 4);
""".format(rows=", ".join(f"({i}, {v})" for i, v in SEED.items()))

READS = ["select id, v from kv", "select id, v from kv_by_v"]

_QUIET = dict(n_devices=1, exec_cache_enabled=False,
              compute_dtype="float64", serving_result_cache_bytes=0,
              max_statement_retries=0, recover_2pc_interval_ms=-1,
              defer_shard_delete_interval_ms=-1,
              health_check_interval_ms=-1)


def _jax(data_dir, **kw):
    return citus_tpu.connect(data_dir=str(data_dir), **{**_QUIET, **kw})


def _port(data_dir, **settings):
    # crash semantics, as the JAX sessions: no statement retry envelope
    return citus_tpu_torch.connect(str(data_dir), device="cpu",
                                   **{"compute_dtype": "float64",
                                      "max_statement_retries": 0,
                                      **settings})


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("torch_txn") / "base")
    p = _port(data_dir)
    p.execute(SETUP)
    p.close()
    return data_dir


def _copy(base, tmp_path, name):
    d = str(tmp_path / name)
    shutil.copytree(base, d)
    return d


def kv_state(sess, table="kv"):
    return {int(r[0]): int(r[1])
            for r in sess.execute(f"select id, v from {table}").rows()}


def manifest_state(data_dir, table):
    path = os.path.join(data_dir, "tables", table, "MANIFEST.json")
    if not os.path.exists(path):
        return {}  # never written
    with open(path) as f:
        man = json.load(f)
    return {sid: [(r["file"], r["rows"], r.get("deletes"),
                   r.get("del_version"), r.get("live_rows"))
                  for r in recs]
            for sid, recs in man["shards"].items()}


def feed(sess):
    return [tuple(x.item() if hasattr(x, "item") else x for x in r)
            for r in sess.execute("select citus_change_feed()").rows()]


def assert_same_state(j, p, tables=("kv", "kv_by_v")):
    for t in tables:
        compare_results(p.execute(f"select * from {t}").rows(),
                        j.execute(f"select * from {t}").rows(), False, 0.0)
        assert manifest_state(p.data_dir, t) == \
            manifest_state(j.data_dir, t), t
    assert feed(p) == feed(j)


# -- BEGIN / COMMIT / ROLLBACK ---------------------------------------------

def test_overlay_visibility_rollback_and_commit(base, tmp_path):
    d = _copy(base, tmp_path, "d")
    p = _port(d)
    p.execute("begin")
    p.execute("delete from kv where id < 10")
    p.execute("insert into kv values (500, 1), (501, 2)")
    p.execute("update kv set v = 0 where id = 500")
    assert p.store.overlay is not None
    inside = kv_state(p)
    assert 3 not in inside and inside[500] == 0 and inside[501] == 2
    assert p.execute("select count(*), sum(v) from kv").rows() == \
        [(len(inside), sum(inside.values()))]
    # the staged stripes are files on disk, invisible to other sessions
    staged = [os.path.join(p.store.shard_dir("kv", sid), r["file"])
              for (_t, sid), recs in p.store.overlay.records.items()
              for r in recs]
    assert staged and all(os.path.exists(f) for f in staged)
    assert kv_state(_port(d)) == SEED
    p.execute("rollback")
    assert p.store.overlay is None
    assert not any(os.path.exists(f) for f in staged)
    assert kv_state(p) == SEED
    p.execute("begin")
    p.execute("insert into kv values (600, 6), (601, 7), (602, 8)")
    p.execute("update kv set v = 66 where id = 600")
    p.execute("commit")
    want = {**SEED, 600: 66, 601: 7, 602: 8}
    assert kv_state(p) == want
    assert kv_state(_port(d)) == want
    assert kv_state(_jax(d)) == want
    assert not os.listdir(os.path.join(d, "txnlog"))


def test_transaction_matches_jax(base, tmp_path):
    """The same transaction in both packages: the same rows inside it,
    the same rows, manifests and change feed after COMMIT."""
    j = _jax(_copy(base, tmp_path, "j"))
    p = _port(_copy(base, tmp_path, "p"))
    script = ["begin",
              "update kv set v = v * 2 where id < 5",
              "insert into kv values (700, 1), (701, 2)",
              "delete from kv where id = 701 or id = 30",
              "insert into kv_by_v select id, v from kv where id < 8",
              "select id, v from kv", "select id, v from kv_by_v",
              "commit"]
    for sql in script:
        want, got = j.execute(sql), p.execute(sql)
        if want is not None:
            compare_results(got.rows(), want.rows(), False, 0.0)
    assert_same_state(j, p)


def test_statements_outside_a_transaction_are_refused(base, tmp_path):
    p = _port(_copy(base, tmp_path, "d"))
    for sql in ("commit", "rollback"):
        with pytest.raises(citus_tpu_torch.ExecutionError,
                           match="no transaction in progress"):
            p.execute(sql)
    p.execute("begin")
    with pytest.raises(citus_tpu_torch.ExecutionError,
                       match="already a transaction"):
        p.execute("begin")
    p.execute("rollback")


def test_deadlock_victim_rolls_back(base, tmp_path):
    """Two sessions lock two shards in opposite orders: the youngest
    transaction of the cycle gets DeadlockDetectedError, its
    transaction is rolled back, and the other commits."""
    d = _copy(base, tmp_path, "d")
    a, b = _port(d), _port(d)
    # ids 0 and 1 must sit on different shards
    shard_of = {}
    for sh in a.catalog.table_shards("kv"):
        vals, _m, _n = a.store.read_shard("kv", sh.shard_id, ["id"])
        for i in vals["id"]:
            shard_of[int(i)] = sh.shard_id
    k1 = 0
    k2 = next(i for i in SEED if shard_of[i] != shard_of[k1])
    gate = threading.Barrier(2)
    outcome = {}

    def run(sess, name, first, second):
        try:
            sess.execute("begin")
            sess.execute(f"update kv set v = -1 where id = {first}")
            gate.wait(timeout=10)
            sess.execute(f"update kv set v = -2 where id = {second}")
            sess.execute("commit")
            outcome[name] = "committed"
        except DeadlockDetectedError:
            outcome[name] = ("victim", sess.txn_manager.current)

    ta = threading.Thread(target=run, args=(a, "a", k1, k2))
    tb = threading.Thread(target=run, args=(b, "b", k2, k1))
    ta.start()
    tb.start()
    ta.join(20)
    tb.join(20)
    assert sorted(v if isinstance(v, str) else v[0]
                  for v in outcome.values()) == ["committed", "victim"]
    victim = next(k for k, v in outcome.items() if v != "committed")
    assert outcome[victim][1] is None  # its transaction rolled back
    state = kv_state(_port(d))
    # the winner set its first key to -1, then its second to -2
    assert (state[k1], state[k2]) == ((-1, -2) if victim == "b"
                                      else (-2, -1))
    assert sorted(state) == sorted(SEED)
    assert not a.locks.wait_graph()


# -- fault points ------------------------------------------------------------

# point → (statements before the fault, the failing statement, inject
# kwargs, whether the failing statement's effect is visible after)
FAULTS = {
    "store.append_stripe": ([], "insert into kv values (800, 1)", {},
                            False),
    "storage.manifest_flip": ([], "insert into kv values (800, 1)", {},
                              False),
    "store.apply_dml": ([], "update kv set v = 0 where id < 20", {},
                        False),
    "executor.repartition_shuffle": (
        [], "insert into kv_by_v select id, v from kv", {}, False),
    "cdc.append": ([], "insert into kv values (800, 1)", {}, True),
    "txn.prepare": (["begin", "update kv set v = 1 where id < 6",
                     "insert into kv values (801, 2)"], "commit", {},
                    False),
    "txn.commit_record": (["begin", "update kv set v = 1 where id < 6",
                           "insert into kv values (801, 2)"], "commit",
                          {}, False),
    "txn.apply": (["begin", "update kv set v = 1 where id < 6",
                   "insert into kv values (801, 2)"], "commit", {}, True),
}


@pytest.mark.parametrize("point", sorted(FAULTS))
def test_fault_point_outcome_matches_jax(base, tmp_path, point):
    before, failing, kw, visible = FAULTS[point]
    jdir = _copy(base, tmp_path, "j")
    pdir = _copy(base, tmp_path, "p")
    j, p = _jax(jdir), _port(pdir)
    for sql in before:
        j.execute(sql)
        p.execute(sql)
    with jfi.inject(point, require_fired=True, **kw):
        with pytest.raises(citus_tpu.CitusTpuError):
            j.execute(failing)
    with pfi.inject(point, require_fired=True, **kw):
        with pytest.raises(pfi.InjectedFault):
            p.execute(failing)
    assert p.txn_manager.current is None
    # a fresh session of each package recovers its own data_dir
    j2, p2 = _jax(jdir), _port(pdir)
    assert_same_state(j2, p2)
    changed = kv_state(p2) != SEED or kv_state(p2, "kv_by_v") != {}
    assert changed == visible


def test_every_fault_point_is_armed_by_a_port_test():
    src = ""
    for path in glob.glob(os.path.join(os.path.dirname(__file__),
                                       "test_torch_*.py")):
        with open(path) as f:
            src += f.read()
    unarmed = [n for n in pfi.registered_points()
               if f'"{n}"' not in src]
    assert not unarmed
    assert set(pfi.registered_points()) <= set(jfi.registered_points())


# -- fault 1: a crash at txn.apply, recovered by the other package ---------

@pytest.mark.parametrize("crasher", ["jax", "port"])
def test_crash_at_txn_apply_recovers_across_packages(base, tmp_path,
                                                     crasher):
    d = _copy(base, tmp_path, "d")
    sess, fi = ((_jax(d), jfi) if crasher == "jax" else (_port(d), pfi))
    sess.execute("begin")
    sess.execute("update kv set v = 1000 + v where id < 10")
    sess.execute("delete from kv where id = 39")
    sess.execute("insert into kv values (900, 9)")
    with fi.inject("txn.apply", require_fired=True):
        with pytest.raises(Exception, match="txn.apply"):
            sess.execute("commit")
    assert os.listdir(os.path.join(d, "txnlog"))  # commit record durable
    want = {**{i: (1000 + v if i < 10 else v) for i, v in SEED.items()
               if i != 39}, 900: 9}
    other = _port(d) if crasher == "jax" else _jax(d)
    assert kv_state(other) == want
    assert not os.listdir(os.path.join(d, "txnlog"))


# -- fault 2: replica placements ---------------------------------------------

def test_replication_factor_two_mirrors_like_jax(tmp_path):
    """A port ingest and a port UPDATE into a table with a replication
    factor of 2 leave the replica dirs holding the files the JAX
    package's same statements leave."""
    bdir = str(tmp_path / "base")
    p0 = _port(bdir)
    p0.execute("select citus_add_node('device:1')")
    p0.execute("set shard_replication_factor = 2")
    p0.execute("create table rt (id bigint, v double precision)")
    p0.execute("select create_distributed_table('rt', 'id', 4)")
    p0.close()
    assert all(len(p0.catalog.shard_placements(s.shard_id)) == 2
               for s in p0.catalog.table_shards("rt"))
    jdir, pdir = _copy(bdir, tmp_path, "j"), _copy(bdir, tmp_path, "p")
    j, p = _jax(jdir), _port(pdir)
    import numpy as np
    ids = np.arange(200, dtype=np.int64)
    batch = [ids, ids * 0.5]
    from citus_tpu.ingest.copy_from import _ingest_batch as j_ingest
    j_ingest(j, "rt", ["id", "v"], batch, pre_typed=True)
    _ingest_batch(p, "rt", ["id", "v"], batch, pre_typed=True)
    for sql in ["update rt set v = v + 1 where id < 50",
                "insert into rt values (1000, 1.0)"]:
        assert j.execute(sql).rows() == p.execute(sql).rows()

    def replica_files(d):
        out = {}
        tdir = os.path.join(d, "tables", "rt")
        for e in sorted(os.listdir(tdir)):
            if e.startswith("replica_"):
                for f in sorted(os.listdir(os.path.join(tdir, e))):
                    with open(os.path.join(tdir, e, f), "rb") as fh:
                        out[(e, f)] = len(fh.read())
        return out

    got = replica_files(pdir)
    assert got and got == replica_files(jdir)
    # every committed stripe has its copy in each replica placement's dir
    for sh in p.catalog.table_shards("rt"):
        for rec in p.store.shard_stripe_records("rt", sh.shard_id):
            assert len(p.store._copy_paths("rt", sh.shard_id,
                                           rec["file"])) == 2
    compare_results(p.execute("select id, v from rt").rows(),
                    j.execute("select id, v from rt").rows(), False, 0.0)


# -- UDFs ---------------------------------------------------------------------

def test_change_feed_and_node_clock_match_jax(base, tmp_path):
    j = _jax(_copy(base, tmp_path, "j"))
    p = _port(_copy(base, tmp_path, "p"))
    for sql in ["insert into kv values (1000, 1)",
                "update kv set v = 5 where id = 1000",
                "delete from kv where id < 3"]:
        j.execute(sql)
        p.execute(sql)
    for sql in ["select citus_change_feed()",
                "select citus_change_feed('kv', 2)",
                "select citus_change_feed('kv_by_v')"]:
        pr, jr = p.execute(sql), j.execute(sql)
        assert pr.column_names == jr.column_names
        assert pr.rows() == jr.rows()
    kinds = [r[1] for r in p.execute("select citus_change_feed()").rows()]
    assert {"insert", "delete"} <= set(kinds)
    pc = p.execute("select citus_get_node_clock()")
    jc = j.execute("select citus_get_node_clock()")
    assert pc.column_names == jc.column_names == ["clock"]
    t_p, t_j = int(pc.rows()[0][0]), int(jc.rows()[0][0])
    # hybrid logical clocks: 42-bit milliseconds over a 22-bit counter,
    # both read from this host's wall clock
    assert abs((t_p >> 22) - (t_j >> 22)) < 60_000
    assert int(p.execute("select citus_get_node_clock()").rows()[0][0]) \
        > t_p


def test_change_rows_and_cursor_match_jax(base, tmp_path):
    """The tailer (ChangeFeedCursor) sees each commit's events once, and
    each event's rows materialise as the JAX package materialises them
    (inserts: the stripe; deletes: the pre-image of the positions)."""
    from citus_tpu_torch.cdc.feed import ChangeFeedCursor

    j = _jax(_copy(base, tmp_path, "j"))
    p = _port(_copy(base, tmp_path, "p"))
    cursor = ChangeFeedCursor(p.store.change_log.path)
    assert cursor.poll() == []
    for sql in ["insert into kv values (1000, 1), (1001, 2)",
                "delete from kv where id < 4"]:
        j.execute(sql)
        p.execute(sql)
    polled = cursor.poll()
    assert [e["lsn"] for e in polled] == \
        [e["lsn"] for e in p.change_events("kv", len(SEED) and
                                           polled[0]["lsn"] - 1)]
    assert {e["kind"] for e in polled} == {"insert", "delete"}
    assert cursor.poll() == []
    jevents = j.change_events("kv", polled[0]["lsn"] - 1)
    for pe, je in zip(polled, jevents):
        assert {k: v for k, v in pe.items() if k != "ts"} == \
            {k: v for k, v in je.items() if k != "ts"}
        pv, pm = p.change_rows(pe)
        jv, jm = j.change_rows(je)
        for c in ("id", "v"):
            assert pv[c].tolist() == jv[c].tolist()
            assert pm[c].tolist() == jm[c].tolist()


def test_remove_shard_records_matches_jax(base, tmp_path):
    """Dropping one shard's manifest entries (the split and cleanup
    primitive) drops its rows for both packages."""
    d = _copy(base, tmp_path, "d")
    p = _port(d)
    shard = p.catalog.table_shards("kv")[1].shard_id
    gone = p.store.shard_row_count("kv", shard)
    assert gone > 0
    p.store.remove_shard_records("kv", shard)
    assert p.store.table_row_count("kv") == len(SEED) - gone
    assert kv_state(_jax(d)) == kv_state(_port(d))
    assert len(kv_state(_port(d))) == len(SEED) - gone


# -- power-cut sweep ---------------------------------------------------------

UPDATE_UNIT = ["update kv set v = v + 1000 where id < 25"]
TXN_UNIT = ["begin", "update kv set v = 7 where id < 12",
            "delete from kv where id >= 35",
            "insert into kv values (950, 1), (951, 2)", "commit"]
UNIT_STATES = {
    "update": {i: (v + 1000 if i < 25 else v) for i, v in SEED.items()},
    "txn": {**{i: (7 if i < 12 else v) for i, v in SEED.items()
                if i < 35}, 950: 1, 951: 2},
}


@pytest.mark.parametrize("unit", ["update", "txn"])
def test_power_cut_sweep(base, tmp_path, unit):
    statements = UPDATE_UNIT if unit == "update" else TXN_UNIT
    rehearsal = _port(_copy(base, tmp_path, "rehearsal"))
    with power_cut_at(None) as sim:
        for sql in statements:
            rehearsal.execute(sql)
    assert kv_state(rehearsal) == UNIT_STATES[unit]
    total = sim.ops
    assert total >= 10
    seen = set()
    for n in range(1, total + 1):
        d = _copy(base, tmp_path, f"cut{n:03d}")
        sess = _port(d)
        with power_cut_at(n) as cut:
            with pytest.raises(PowerCut):
                for sql in statements:
                    sess.execute(sql)
        state = kv_state(_port(d))  # recovery runs at open
        assert state in (SEED, UNIT_STATES[unit]), (n, cut.tear_applied)
        seen.add(state == SEED)
        shutil.rmtree(d, ignore_errors=True)
    assert seen == {True, False}


# -- round trip ---------------------------------------------------------------

ROUND_TRIP = [
    "select count(*), sum(o_totalprice) from orders",
    "select o_orderstatus, count(*), count(o_totalprice) from orders "
    "group by o_orderstatus order by o_orderstatus",
    "select l_returnflag, sum(l_quantity), sum(l_discount) from lineitem "
    "group by l_returnflag order by l_returnflag",
    "select o_orderkey, o_totalprice from orders where o_orderkey < 200 "
    "order by o_orderkey",
    "select count(*) from orders, lineitem where o_orderkey = l_orderkey "
    "and o_orderdate < date '1994-01-01'",
]
WRITES = [
    "update orders set o_totalprice = o_totalprice + 1 "
    "where o_orderdate < date '1993-06-01'",
    "update orders set o_totalprice = null where o_custkey < 20",
    "delete from lineitem where l_shipdate >= date '1997-06-01'",
    "begin",
    "delete from orders where o_orderstatus = 'P'",
    "insert into orders select o_orderkey + 100000, o_custkey, "
    "o_orderstatus, o_totalprice, o_orderdate, o_orderpriority, o_clerk, "
    "o_shippriority, o_comment from orders where o_orderkey < 100",
    "commit",
]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_round_trip_after_dml(tmp_path, writer):
    d = str(tmp_path / "d")
    p0 = _port(d)
    ptpch.load_into_session(p0, sf=0.002, seed=9,
                            tables={"orders", "lineitem"})
    p0.close()
    w = _port(d) if writer == "port" else _jax(d)
    for sql in WRITES:
        w.execute(sql)
    want = [w.execute(sql).rows() for sql in ROUND_TRIP]
    r = _jax(d) if writer == "port" else _port(d)
    for sql, rows in zip(ROUND_TRIP, want):
        compare_results(r.execute(sql).rows(), rows, "order by" in sql, TOL)


# -- stale dictionaries: a second session's strings -------------------------
# Both packages cache a table's dictionaries past another session's
# commit: the stale session reads the new string as NULL and interns its
# own string at the same code, overwriting the other's on disk (ROADMAP
# queue C item 2).  The port reloads a dictionary whenever its manifest
# reloads and interns under the table's write lock against the on-disk
# copy; the JAX package differs, so the port is held to fresh sessions.
ACCOUNTS = """
create table accounts (id bigint, tenant bigint, balance double precision,
                       status text);
select create_distributed_table('accounts', 'id', 4);
insert into accounts values (1, 10, 5.0, 'open'), (2, 20, 6.0, 'closed'),
                            (3, 30, 7.0, 'open');
"""


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_stale_dictionary_is_reloaded_and_appended_to(tmp_path, writer):
    d = str(tmp_path / "d")
    a = _port(d)
    a.execute(ACCOUNTS)
    by_status = "select status, count(*) from accounts group by status"
    assert sorted(a.execute(by_status).rows()) == [("closed", 1),
                                                   ("open", 2)]
    b = _port(d) if writer == "port" else _jax(d)
    b.execute("insert into accounts values (60, 10, 1.0, 'wb')")
    b.execute("update accounts set status = 'Z' where tenant = 20")
    # A reads B's committed strings, not NULL
    assert a.execute("select status from accounts where id = 60").rows() \
        == [("wb",)]
    assert sorted(a.execute(by_status).rows()) == [
        ("Z", 1), ("open", 2), ("wb", 1)]
    # A's own new string gets a new code: it overwrites nothing
    a.execute("insert into accounts values (61, 20, 2.0, 'qa')")
    if writer == "jax":
        b.close()
    want = [(1, "open"), (2, "Z"), (3, "open"), (60, "wb"), (61, "qa")]
    for fresh in (_port(d), _jax(d)):
        assert sorted(fresh.execute(
            "select id, status from accounts").rows()) == want
        if isinstance(fresh, citus_tpu.session.Session):
            fresh.close()
    # a string literal binds through the reloaded dictionary
    assert a.execute("select id from accounts where status = 'wb'").rows() \
        == [(60,)]
