"""The port's stats/ (counters, statement and tenant statistics, activity,
progress) against the JAX package's, on CPU torch.

One data_dir written by the JAX package (TPC-H sf 0.005, seed 3, 8
shards, 1,000-row stripes); each package runs one fixed script on its
own copy of it (JAX: n_devices=1, exec_cache_enabled=False; port:
device="cpu"; both float64 and scan_pipeline=host).  The script reads
(resident, fast-path point lookups, subqueries, a set operation, a CTE,
a streamed statement), writes (INSERT VALUES, INSERT..SELECT, UPDATE,
DELETE, DDL), retries an injected storage fault, times out one
statement, walks the OOM ladder once, fills and hits the result cache
once, and provisions a follower and ships a write to it; every
non-exempt statement passes the admission gate and every point lookup
rides the micro-batcher.  Afterwards:

* every statement's fingerprint equals the JAX package's;
* citus_stat_counters lists the JAX package's names, and every counter
  the port bumps has the JAX package's value; the counters of modules
  the port does not have yet are listed below with their ROADMAP item
  and read 0 in the port;
* citus_stat_statements (query, calls, rows) and citus_stat_tenants
  (table, tenant, query count) equal the JAX package's — except the
  rows of EXPLAIN ANALYZE, whose output has the JAX package's lines
  minus the ones of unported modules;
* citus_stat_activity shows the running statement and its retries;
  the progress registry keeps its history bound.

Exact on every count.
"""

import os
import shutil

import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu_torch import replication as prepl
from citus_tpu import replication as jrepl
from citus_tpu.ingest import tpch as jtpch
from citus_tpu.stats import counters as jsc
from citus_tpu.stats.query_stats import fingerprint as jfingerprint
from citus_tpu.utils import faultinjection as jfi
from citus_tpu_torch.stats import counters as psc
from citus_tpu_torch.stats.progress import ProgressRegistry
from citus_tpu_torch.stats.query_stats import QueryStats
from citus_tpu_torch.stats.query_stats import fingerprint as pfingerprint
from citus_tpu_torch.stats.tenants import TenantStats
from citus_tpu_torch.utils import faultinjection as pfi

torch.set_num_threads(1)

# counters a one-position port session never bumps, by the ROADMAP queue
# A item whose module bumps them (the mesh's: tests/test_torch_mesh.py and
# _mesh_failover.py bump them at width N)
NOT_BUMPED = {
    **dict.fromkeys(
        ("device_lost_total", "mesh_failovers_total",
         "queries_rescued_total", "shuffle_bytes_total"), 9),
}
# the persisted plan cache's counters: the script runs both packages
# with it off (equal at 0); test_exec_cache_counters_bump_where_they_should
# runs the statements that bump each one
EXEC_CACHE_COUNTERS = ("exec_cache_hits_total", "exec_cache_misses_total",
                       "exec_cache_rejects_total", "compiles_deduped_total",
                       "warmup_compiles_total")

STREAM_ON = "set max_feed_bytes_per_device = 1; set stream_batch_rows = 512"
STREAM_OFF = ("set max_feed_bytes_per_device = 6442450944; "
              "set stream_batch_rows = 0")

# (sql, how): "ok" runs it; "retry" runs it with store.read_shard armed
# once (the envelope retries it); "timeout" with a slow read under a
# statement timeout; "oom" with one injected device OOM (the ladder)
SCRIPT = [
    (jtpch.Q1, "ok"),
    (jtpch.Q3, "ok"),
    ("select l_orderkey, count(*), sum(l_quantity) from lineitem "
     "group by l_orderkey order by 3 desc, 1 limit 5", "ok"),
    ("select o_orderkey, o_totalprice from orders where o_orderkey = 7",
     "ok"),
    ("select count(*) from orders where o_orderkey = 32", "ok"),
    ("select count(*) from lineitem where l_shipdate < date '1992-03-01'",
     "ok"),
    # a pipelined scan sheds a placement OOM by itself: the eager feed
    # path sends it to the statement's ladder.  Before the first temp:
    # the JAX package keeps a dropped temp's feeds cached (the port
    # drops them with the temp), so its evictions would count those
    ("set scan_pipeline = off", "ok"),
    ("select c_nationkey, count(*) from customer group by c_nationkey",
     "oom"),
    ("set scan_pipeline = host", "ok"),
    ("select count(*) from orders where o_custkey in "
     "(select c_custkey from customer where c_nationkey = 3)", "ok"),
    ("select o_orderpriority from orders where o_orderkey < 10 union "
     "select o_orderpriority from orders where o_orderkey > 5990", "ok"),
    ("with big as (select o_custkey, sum(o_totalprice) as t from orders "
     "group by o_custkey) select count(*) from big where t > 100000", "ok"),
    (STREAM_ON, "ok"),
    ("select l_returnflag, count(*), sum(l_quantity) from lineitem "
     "group by l_returnflag", "ok"),
    (STREAM_OFF, "ok"),
    ("select count(*), sum(o_totalprice) from orders", "retry"),
    ("select sum(c_acctbal) from customer", "timeout"),
    ("create table acc (id bigint, tenant bigint, v double precision, "
     "s text)", "ok"),
    ("select create_distributed_table('acc', 'id', 4)", "ok"),
    ("insert into acc values (1, 10, 1.0, 'a'), (2, 20, 2.0, 'b'), "
     "(3, 10, 3.0, null)", "ok"),
    ("insert into acc select o_orderkey + 100, o_custkey, o_totalprice, "
     "o_orderpriority from orders where o_orderkey < 200", "ok"),
    ("update acc set v = v + 1 where tenant = 10", "ok"),
    ("update acc set s = 'zz' where id = 2", "ok"),
    ("delete from acc where id = 3", "ok"),
    ("alter table acc add column w bigint", "ok"),
    ("select id, v from acc where id = 1", "ok"),
    ("select count(*), sum(v) from acc", "ok"),
    ("explain analyze select l_returnflag, sum(l_quantity) from lineitem "
     "group by l_returnflag", "ok"),
    ("drop table acc", "ok"),
    # the serving result cache, on for two runs of one statement: a
    # miss that fills, then a hit
    ("set serving_result_cache_bytes = 1048576", "ok"),
    ("select count(*), sum(o_totalprice) from orders "
     "where o_orderkey < 100", "ok"),
    ("select count(*), sum(o_totalprice) from orders "
     "where o_orderkey < 100", "ok"),
    ("set serving_result_cache_bytes = 0", "ok"),
    # a follower provisioned (one reseed batch shipped and applied),
    # then a write shipped by the UDF
    ("provision", "ship"),
    ("insert into region values (9, 'NOWHERE', 'x')", "ok"),
    ("select citus_replication_ship()", "ok"),
]

_COMMON = dict(compute_dtype="float64", columnar_stripe_row_limit=1000,
               scan_pipeline="host", retry_backoff_base_ms=1,
               retry_backoff_max_ms=2)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_stats") / "base")
    s = citus_tpu.connect(data_dir=d, n_devices=1, exec_cache_enabled=False,
                          serving_result_cache_bytes=0,
                          compute_dtype="float64",
                          columnar_stripe_row_limit=1000)
    jtpch.load_into_session(s, sf=0.005, seed=3, shard_count=8)
    s.close()
    return d


def _jax(d):
    return citus_tpu.connect(data_dir=d, n_devices=1,
                             exec_cache_enabled=False,
                             serving_result_cache_bytes=0,
                             recover_2pc_interval_ms=-1,
                             defer_shard_delete_interval_ms=-1,
                             health_check_interval_ms=-1, **_COMMON)


def _port(d):
    return citus_tpu_torch.connect(d, device="cpu",
                                   serving_result_cache_bytes=0,
                                   exec_cache_enabled=False, **_COMMON)


def _run(sess, fi, err_timeout, repl):
    for sql, how in SCRIPT:
        if how == "ok":
            sess.execute(sql)
        elif how == "ship":
            repl.provision_replica(sess.data_dir, sess.data_dir + "_replica",
                                   counters=sess.stats.counters)
        elif how == "retry":
            with fi.inject("store.read_shard", error="storage",
                           require_fired=True):
                sess.execute(sql)
        elif how == "timeout":
            sess.execute("set statement_timeout_ms = 20")
            try:
                with fi.inject("store.read_shard", sleep=0.2, error=None):
                    with pytest.raises(err_timeout):
                        sess.execute(sql)
            finally:
                sess.execute("set statement_timeout_ms = 0")
        else:  # oom
            with fi.inject("executor.hbm_exhausted", error="oom",
                           require_fired=True):
                sess.execute(sql)


@pytest.fixture(scope="module")
def ran(base, tmp_path_factory):
    """Both packages after the script: {pkg: (session, counters,
    statements, tenants)}."""
    out = {}
    root = tmp_path_factory.mktemp("torch_stats_runs")
    for pkg in ("jax", "port"):
        d = str(root / pkg)
        shutil.copytree(base, d)
        if pkg == "jax":
            s, fi, repl = _jax(d), jfi, jrepl
            err = citus_tpu.errors.StatementTimeout
        else:
            s, fi, repl = _port(d), pfi, prepl
            err = citus_tpu_torch.errors.StatementTimeout
        _run(s, fi, err, repl)
        counters = dict(s.execute("select citus_stat_counters()").rows())
        statements = {q: (c, r) for q, c, _t, r in
                      s.execute("select citus_stat_statements()").rows()}
        tenants = sorted((t, te, c) for t, te, c, _ms in
                         s.execute("select citus_stat_tenants()").rows())
        out[pkg] = (s, counters, statements, tenants)
    yield out
    out["jax"][0].close()


def test_fingerprints_match_jax():
    for sql, _how in SCRIPT + [("select 'it''s', 1.5e3, -2 from t", "")]:
        assert pfingerprint(sql) == jfingerprint(sql), sql


def test_counter_names_are_the_jax_packages():
    assert psc.ALL_COUNTERS == jsc.ALL_COUNTERS
    assert set(NOT_BUMPED) <= set(psc.ALL_COUNTERS)


def test_counters_match_jax_over_the_script(ran):
    _s, jc, _st, _t = ran["jax"]
    _s, pc, _st, _t = ran["port"]
    assert sorted(pc) == sorted(jc)
    for name in psc.ALL_COUNTERS:
        if name in NOT_BUMPED:
            assert pc[name] == 0, (name, NOT_BUMPED[name])
        else:
            assert pc[name] == jc[name], (name, pc[name], jc[name])
    # the script reaches every counter family the port bumps
    for name in ("queries_single_shard", "queries_multi_shard",
                 "queries_fast_path", "point_index_lookups",
                 "subplans_executed", "rows_ingested", "rows_returned",
                 "dml_update_count", "dml_delete_count", "ddl_commands",
                 "device_rows_scanned", "insert_select_repartition",
                 "chunks_skipped", "queries_streamed",
                 "chunks_prefetched_total", "retries_total",
                 "timeouts_total", "faults_injected_total",
                 "oom_events_total", "wlm_admitted_total",
                 "serving_batched_lookups_total",
                 "serving_batch_dispatch_total", "serving_cache_hits_total",
                 "serving_cache_misses_total", "log_batches_shipped_total",
                 "log_batches_applied_total"):
        assert pc[name] > 0, name


def test_exec_cache_counters_bump_where_they_should(base, tmp_path,
                                                    monkeypatch):
    """Each of the persisted plan cache's counters, bumped by the
    statement that should bump it: a plan-cache miss on a key never
    persisted (misses), the same key in a fresh session (hits), a
    rotten entry (rejects), a session joining another's capture of one
    key (compiles_deduped_total, with a stand-in for the CUDA graph:
    tests/test_torch_graphs.py) and the warmup arming an entry
    (warmup_compiles_total)."""
    import threading

    from citus_tpu_torch.executor import graphs
    from citus_tpu_torch.executor import runner as prunner

    assert set(EXEC_CACHE_COUNTERS) <= set(psc.ALL_COUNTERS)
    d = str(tmp_path / "d")
    shutil.copytree(base, d)
    sql = "select o_orderpriority, count(*) from orders group by 1"

    def port(**kw):
        return citus_tpu_torch.connect(d, device="cpu",
                                       serving_result_cache_bytes=0,
                                       **dict(_COMMON, **kw))

    def delta(s, before):
        now = s.stats.counters.snapshot()
        return {k: now.get(k, 0) - before.get(k, 0)
                for k in EXEC_CACHE_COUNTERS}

    s = port()
    b = s.stats.counters.snapshot()
    s.execute(sql)
    assert delta(s, b)["exec_cache_misses_total"] >= 1
    assert delta(s, b)["exec_cache_hits_total"] == 0
    s.close()
    s = port()
    b = s.stats.counters.snapshot()
    s.execute(sql)
    assert delta(s, b) == dict.fromkeys(EXEC_CACHE_COUNTERS, 0) | {
        "exec_cache_hits_total": 1}
    s.close()
    ec = os.path.join(d, "exec_cache")
    for f in os.listdir(ec):
        if f.endswith(".bin"):
            with open(os.path.join(ec, f), "r+b") as fh:
                fh.truncate(4)
    s = port()
    b = s.stats.counters.snapshot()
    s.execute(sql)
    assert delta(s, b)["exec_cache_rejects_total"] == 1
    s.close()
    s = port(warmup_budget_ms=30_000)
    s._warmup_thread.join(30)
    assert delta(s, {})["warmup_compiles_total"] >= 1
    s.close()

    captured = threading.Event()

    def capture(key, compiler, plan, feeds, caps, feed_keys, accountant):
        class G:
            def replay(self):
                pass

        with compiler._run_lock:
            compiler.plan, compiler.caps = plan, caps
            try:
                out = compiler._dispatch(plan, feeds)
            finally:
                compiler.plan = compiler.caps = None
                compiler._forget_run()
        g = graphs.CapturedPlan(key, G(), out[0], out[1], out[2],
                                out[3], feed_keys, [], {}, {}, {}, 0,
                                accountant)
        captured.set()
        return g

    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(prunner.Executor, "_graphs_on", lambda self: True)
    a, b2 = port(), port()
    for _ in range(2):
        a.execute(sql)  # settles, then captures (at once when armed)
    assert captured.is_set()
    for _ in range(2):
        b2.execute(sql)  # adopts a's capture
    assert delta(a, {})["compiles_deduped_total"] == 0
    assert delta(b2, {})["compiles_deduped_total"] == 1
    assert b2.executor.last_dispatch()[0] == "replayed"
    a.close()
    b2.close()


def test_statements_and_tenants_match_jax(ran):
    _s, _c, jst, jten = ran["jax"]
    _s, _c, pst, pten = ran["port"]
    assert sorted(pst) == sorted(jst)
    for q, (calls, rows) in pst.items():
        jcalls, jrows = jst[q]
        assert calls == jcalls, q
        assert rows == jrows, q
    assert pten == jten
    assert ("orders", "7", 1) in pten and ("acc", "1", 1) in pten


def test_stat_resets_answer_like_jax(ran):
    for pkg in ("jax", "port"):
        s = ran[pkg][0]
        for udf in ("citus_stat_counters_reset",
                    "citus_stat_statements_reset",
                    "citus_stat_latency_reset"):
            assert s.execute(f"select {udf}()").rows() == [(True,)]
        assert all(v == 0 for _n, v in
                   s.execute("select citus_stat_counters()").rows())
        # only what ran after the reset is left in the histograms
        classes = [r[0] for r in
                   s.execute("select citus_stat_latency()").rows()]
        assert sorted(classes) == sorted(
            ["select citus_stat_latency_reset ( )",
             "select citus_stat_counters ( )"]), pkg


def test_activity_shows_the_running_statement_and_its_retries(base,
                                                             tmp_path):
    d = str(tmp_path / "p")
    shutil.copytree(base, d)
    p = _port(d)
    # the UDF run as a statement sees itself
    rows = p.execute("select citus_stat_activity()")
    assert rows.row_count == 1
    assert rows.columns["query"][0] == "select citus_stat_activity()"
    assert rows.columns["state"][0] == "active"
    assert rows.columns["global_pid"][0] == \
        citus_tpu_torch.stats.activity.make_gpid(0)
    # a retried statement's entry carries its attempts while it runs
    seen = []
    orig = p._execute_statement

    def spy(stmt):
        seen.append([e.retries for e in p.stats.activity.entries()])
        return orig(stmt)

    p._execute_statement = spy
    with pfi.inject("store.read_shard", error="storage",
                    require_fired=True):
        p.execute("select sum(o_totalprice) from orders")
    assert seen == [[0], [1]]
    assert p.stats.activity.entries() == []


def test_stat_memory_reads_the_ledger_and_the_ladder(base, tmp_path):
    d = str(tmp_path / "p")
    shutil.copytree(base, d)
    p = _port(d)
    # the eager feed path: a pipelined scan sheds a placement OOM itself
    p.execute("set scan_pipeline = off")
    p.execute("select count(*) from lineitem")
    with pfi.inject("executor.hbm_exhausted", error="oom",
                    require_fired=True):
        p.execute("select c_nationkey, count(*) from customer "
                  "group by c_nationkey")
    r = p.execute("select citus_stat_memory()")
    row = dict(zip(r.column_names, r.rows()[0]))
    snap = p.executor.accountant.snapshot()
    assert row["live_bytes"] == snap["live_bytes"]
    assert row["oom_events_total"] == 1
    assert row["cache_evictions_total"] >= 1
    assert row["device_bytes_in_use"] is None  # a CPU session
    assert p.executor.accountant.transient_bytes() == 0


def test_query_and_tenant_tables_stay_bounded():
    q = QueryStats(max_entries=3)
    for i in range(5):
        for _ in range(i + 1):
            q.record(f"select {i} from t{i}", 1.0, 1)
    assert len(q.entries()) == 3
    t = TenantStats(limit=2)
    for tenant, n in ((1, 3), (2, 1), (3, 2)):
        for _ in range(n):
            t.record("orders", tenant, 1.0)
    assert [(s.tenant, s.query_count) for s in t.entries()] == \
        [("1", 3), ("3", 2)]


def test_progress_registry_keeps_a_short_history():
    reg = ProgressRegistry()
    mons = [reg.create("rebalance", f"t{i}", 2) for i in range(60)]
    for m in mons[:-1]:
        m.advance(2)
        m.finish()
    assert reg.active() == [mons[-1]]
    assert len(reg.all()) <= 51
