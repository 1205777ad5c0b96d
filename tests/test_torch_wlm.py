"""The port's workload manager (citus_tpu_torch/wlm/) against the JAX
package's, on CPU torch.

* The manager alone: weights parse as the JAX package parses them; for
  scripted request sequences (weighted tenants, equal weights, priority
  classes, a slot bound, a byte budget, shedding) the port's manager
  dispatches in exactly the JAX package's order; timeouts, the measured
  pressure hook and the per-data_dir registry behave alike.
* Over one data_dir the JAX package wrote (TPC-H sf 0.002, 4 shards):
  `statement_exempt` and `planned_feed_bytes` equal the JAX package's
  for a list of statements, both at n_devices = 1.
* The session: exemption classes, the open-transaction bypass, the
  activity wait states, cancel / timeout / shedding while queued, the
  `wlm.admit` fault point, EXPLAIN ANALYZE's Workload line, and eight
  sessions in threads under two slots with at most two statements in
  execution at once.
* Concurrency: two sessions × two threads on cached plans
  (`test_cached_plan_hits_thread_safe_across_sessions`), and the
  kernel launch counter under eight threads.
"""

import sys
import threading
import time

import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu import wlm as jwlm
from citus_tpu.ingest import tpch as jtpch
from citus_tpu.session import _UDFS as JUDFS
from citus_tpu.sql import parse as jparse
from citus_tpu_torch import wlm as pwlm
from citus_tpu_torch.errors import (
    AdmissionRejected,
    ConfigError,
    QueryCanceled,
    StatementTimeout,
)
from citus_tpu_torch.ops import hopper_kernels as hk
from citus_tpu_torch.session import _UDFS as PUDFS
from citus_tpu_torch.sql import parse as pparse
from citus_tpu_torch.utils import faultinjection as pfi
from citus_tpu_torch.utils.cancellation import deadline_scope

torch.set_num_threads(1)

PKG = {"jax": jwlm, "port": pwlm}


def _ledger_ok(snap) -> bool:
    return snap["requests_total"] == (
        snap["admitted_total"] + snap["shed_total"]
        + snap["timedout_total"] + snap["canceled_total"])


def _wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.002)


# -- the manager alone ------------------------------------------------------

@pytest.mark.parametrize("spec", ["", "a:3, b:1", "solo", "x:2,y,z:5",
                                  "a:x", "a:0", ":3"])
def test_parse_tenant_weights_matches_jax(spec):
    def run(mod):
        try:
            return ("ok", mod.parse_tenant_weights(spec))
        except Exception as e:  # noqa: BLE001 — compared by class name
            return ("err", type(e).__name__)

    got, want = run(pwlm), run(jwlm)
    assert got == want
    if got[0] == "err":
        with pytest.raises(ConfigError):
            pwlm.parse_tenant_weights(spec)


def _drain_order(mod, tenants_weights, per_tenant, priority=None):
    """Block the single slot, enqueue `per_tenant` waiters per tenant in
    a fixed order, release, and record the dispatch order."""
    mgr = mod.WorkloadManager()
    blocker = mgr.admit(mod.AdmissionRequest(tenant="_b", max_slots=1))
    order: list[str] = []
    threads = []

    def worker(tenant, weight, cls):
        t = mgr.admit(mod.AdmissionRequest(
            tenant=tenant, weight=weight, max_slots=1, priority=cls))
        order.append(tenant)
        mgr.release(t)

    for _i in range(per_tenant):
        for j, (ten, w) in enumerate(tenants_weights):
            cls = priority[j] if priority else "interactive"
            th = threading.Thread(target=worker, args=(ten, w, cls))
            th.start()
            threads.append(th)
            n = len(threads)
            _wait_for(lambda: mgr.snapshot()["queued_total"] >= n)
    mgr.release(blocker)
    for th in threads:
        th.join(timeout=10)
    assert _ledger_ok(mgr.snapshot())
    return order


DISPATCH = {
    "weighted_3_1": ([("a", 3), ("b", 1)], 12, None, "aaab" * 4),
    "equal_weights": ([("x", 1), ("y", 1)], 4, None, "xyxyxyxy"),
    "three_tenants": ([("p", 2), ("q", 1), ("r", 1)], 4, None,
                      "ppqrppqrqrqr"),
    "priority_classes": ([("bg", 1), ("it", 1), ("bt", 1)], 2,
                         ["background", "interactive", "batch"],
                         "it it bt bt bg bg"),
}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_dispatch_order_matches_jax(case):
    tw, per, prio, want = DISPATCH[case]
    got = {pkg: _drain_order(mod, tw, per, prio)
           for pkg, mod in PKG.items()}
    assert got["port"] == got["jax"]
    joined = " ".join(got["port"]) if " " in want else "".join(got["port"])
    assert joined.startswith(want)


@pytest.mark.parametrize("pkg", sorted(PKG))
def test_slots_bound_then_release_dispatches(pkg):
    mod = PKG[pkg]
    mgr = mod.WorkloadManager()
    t1 = mgr.admit(mod.AdmissionRequest(max_slots=2))
    t2 = mgr.admit(mod.AdmissionRequest(max_slots=2))
    got = []
    th = threading.Thread(target=lambda: got.append(
        mgr.admit(mod.AdmissionRequest(max_slots=2))))
    th.start()
    _wait_for(lambda: mgr.snapshot()["queued_total"] == 1)
    assert not got, "the third statement queues behind two slots"
    mgr.release(t1)
    th.join(timeout=5)
    assert len(got) == 1 and got[0].was_queued and got[0].queued_ms > 0
    mgr.release(t2)
    mgr.release(got[0])
    mgr.release(got[0])  # a second release is a no-op
    snap = mgr.snapshot()
    assert snap["slots_in_use"] == 0
    assert snap["admitted_total"] == 3 and snap["queued_total"] == 1
    assert _ledger_ok(snap)


def test_shed_and_budget_sequence_matches_jax():
    """One scripted sequence through both managers: a byte budget that
    holds the second request, a statement over the whole budget that
    admits alone, and shedding at queue depth 0 — the same outcomes
    and the same snapshot totals."""
    def run(mod):
        mgr = mod.WorkloadManager()
        out = []
        big = mgr.admit(mod.AdmissionRequest(
            feed_bytes=100, max_slots=8, max_feed_bytes=150))
        got = []
        th = threading.Thread(target=lambda: got.append(mgr.admit(
            mod.AdmissionRequest(feed_bytes=80, max_slots=8,
                                 max_feed_bytes=150))))
        th.start()
        _wait_for(lambda: mgr.snapshot()["queued_total"] == 1)
        out.append(("held", not got))
        try:
            mgr.admit(mod.AdmissionRequest(
                feed_bytes=10, max_slots=8, max_feed_bytes=150,
                queue_depth=0))
            out.append("admitted")
        except Exception as e:  # noqa: BLE001 — compared by class name
            out.append(type(e).__name__)
        mgr.release(big)
        th.join(timeout=5)
        out.append(("second", len(got)))
        mgr.release(got[0])
        solo = mgr.admit(mod.AdmissionRequest(
            feed_bytes=10 ** 12, max_slots=8, max_feed_bytes=150))
        out.append(("solo", solo.feed_bytes))
        mgr.release(solo)
        snap = mgr.snapshot()
        out.append({k: v for k, v in snap.items()
                    if k not in ("queue_wait_ms_total", "warming")})
        return out

    assert run(pwlm) == run(jwlm)
    assert run(pwlm)[1] == "AdmissionRejected"


def test_timeout_while_queued():
    mgr = pwlm.WorkloadManager()
    blocker = mgr.admit(pwlm.AdmissionRequest(max_slots=1))
    with deadline_scope(80):
        with pytest.raises(StatementTimeout):
            mgr.admit(pwlm.AdmissionRequest(max_slots=1))
    snap = mgr.snapshot()
    assert snap["timedout_total"] == 1 and _ledger_ok(snap)
    mgr.release(blocker)  # the timed-out waiter left: nobody admitted
    assert mgr.snapshot()["slots_in_use"] == 0


def test_gate_consults_measured_pressure():
    mgr = pwlm.WorkloadManager()
    measured = {"v": 0}
    mgr.attach_measured(lambda: measured["v"])
    a = mgr.admit(pwlm.AdmissionRequest(feed_bytes=10, max_slots=8,
                                        max_feed_bytes=100))
    req = pwlm.AdmissionRequest(feed_bytes=10, max_slots=8,
                                max_feed_bytes=100)
    measured["v"] = 95  # a regrow blew past the declared 10 bytes
    assert not mgr._fits(req)
    measured["v"] = 0
    assert mgr._fits(req)
    mgr.release(a)


def test_registry_shared_per_data_dir(tmp_path):
    a = pwlm.workload_manager_for(str(tmp_path / "d"))
    b = pwlm.workload_manager_for(str(tmp_path / "d" / ".." / "d"))
    c = pwlm.workload_manager_for(str(tmp_path / "e"))
    assert a is b and a is not c


# -- the estimate and the exemption against the JAX package ------------------

@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_wlm") / "base")
    s = citus_tpu.connect(data_dir=d, n_devices=1, exec_cache_enabled=False,
                          serving_result_cache_bytes=0,
                          compute_dtype="float64",
                          columnar_stripe_row_limit=1000)
    jtpch.load_into_session(s, sf=0.002, seed=11, shard_count=4)
    s.execute("create view cheap as select o_orderkey from orders "
              "where o_totalprice < 1000")
    s.close()
    return d


ESTIMATED = [
    jtpch.Q1,
    jtpch.Q3,
    "select count(*) from lineitem",
    "select o_orderkey, o_totalprice from orders where o_orderkey = 7",
    "select c_nationkey, count(*) from customer group by c_nationkey",
    "select count(*) from orders x, orders y where x.o_custkey = "
    "y.o_custkey",
    "select count(*) from orders where o_custkey in "
    "(select c_custkey from customer)",
    "with b as (select o_custkey from orders) select count(*) from b",
    "select o_orderpriority from orders union "
    "select o_orderpriority from orders",
    "insert into nation values (99, 'X', 1, 'c')",
    "insert into orders select * from orders where o_orderkey < 5",
    "update orders set o_totalprice = 0 where o_orderkey = 3",
    "delete from lineitem where l_orderkey = 3",
    "explain analyze select count(*) from lineitem",
    "explain select count(*) from lineitem",
    "select count(*) from cheap",
    "begin",
    "set wlm_queue_depth = 3",
    "select citus_stat_wlm()",
    "select citus_tables()",
    "create table t9 (a bigint)",
]


def test_estimate_and_exemption_match_jax(tpch_dir):
    j = citus_tpu.connect(data_dir=tpch_dir, n_devices=1,
                          exec_cache_enabled=False,
                          recover_2pc_interval_ms=-1,
                          defer_shard_delete_interval_ms=-1,
                          health_check_interval_ms=-1)
    p = citus_tpu_torch.connect(tpch_dir, device="cpu")
    try:
        charged = 0
        for sql in ESTIMATED:
            js, ps = jparse(sql)[0], pparse(sql)[0]
            want = jwlm.planned_feed_bytes(js, j.catalog, j.store, 1,
                                           j.settings)
            got = pwlm.planned_feed_bytes(ps, p.catalog, p.store, 1,
                                          p.settings)
            assert got == want, sql
            assert pwlm.planned_intermediate_bytes(
                ps, p.catalog, p.store, 1, p.settings) == \
                jwlm.planned_intermediate_bytes(
                    js, j.catalog, j.store, 1, j.settings), sql
            assert pwlm.statement_exempt(ps, p.catalog, p.settings,
                                         PUDFS) == \
                jwlm.statement_exempt(js, j.catalog, j.settings,
                                      JUDFS), sql
            assert pwlm.statement_tenant(ps, p.catalog, p.settings) == \
                jwlm.statement_tenant(js, j.catalog, j.settings), sql
            charged += got > 0
        assert charged >= 10
    finally:
        j.close()
        p.close()


# -- the session -------------------------------------------------------------

@pytest.fixture()
def sess(tmp_path):
    s = citus_tpu_torch.connect(str(tmp_path / "d"), device="cpu",
                                compute_dtype="float64",
                                retry_backoff_base_ms=1,
                                retry_backoff_max_ms=2)
    s.execute("create table kv (id bigint, v bigint)")
    s.execute("select create_distributed_table('kv', 'id', 4)")
    s.execute("insert into kv values " + ", ".join(
        f"({i}, {i * 2})" for i in range(60)))
    yield s
    s.close()


def _requests(s):
    return s.wlm.snapshot()["requests_total"]


def test_exemption_classes(sess):
    before = _requests(sess)
    for sql in ("set wlm_queue_depth = 32", "show wlm_queue_depth",
                "begin", "commit", "select citus_stat_counters()",
                "select v from kv where id = 7",
                "explain select count(*) from kv"):
        sess.execute(sql)
    assert _requests(sess) == before
    sess.execute("select count(*) from kv")
    sess.execute("update kv set v = v + 1 where id >= 0")
    sess.execute("explain analyze select count(*) from kv")
    assert _requests(sess) == before + 3


def test_open_transaction_statements_bypass_gate(sess):
    sess.execute("select count(*) from kv")
    before = _requests(sess)
    sess.execute("begin")
    sess.execute("update kv set v = v + 1 where id = 3")
    sess.execute("select count(*) from kv")
    sess.execute("commit")
    assert _requests(sess) == before
    sess.execute("select count(*) from kv")
    assert _requests(sess) == before + 1


def test_wlm_disabled_bypasses_gate(sess):
    before = _requests(sess)
    with sess.settings.override(wlm_enabled=False):
        sess.execute("select count(*) from kv")
    assert _requests(sess) == before


def test_counters_and_stat_wlm(sess):
    sess.execute("select count(*) from kv")
    counters = dict(sess.execute("select citus_stat_counters()").rows())
    assert counters["wlm_admitted_total"] >= 1
    r = sess.execute("select citus_stat_wlm()")
    jcols = ["priority", "tenant", "queued", "running", "admitted_total",
             "shed_total", "weight", "slots_in_use", "slots_total",
             "feed_bytes_admitted", "requests_total", "timedout_total",
             "canceled_total", "queue_wait_ms_total"]
    assert r.column_names == jcols
    row = dict(zip(r.column_names, r.rows()[0]))
    assert row["admitted_total"] >= 1 and row["priority"] == "interactive"
    assert row["slots_total"] == 8
    assert _ledger_ok(sess.wlm.snapshot())


def test_activity_wait_states_and_queue_wait(sess):
    sess.execute("set serving_result_cache_bytes = 0")
    sess.settings.set("max_concurrent_statements", 1)
    blocker = sess.wlm.admit(pwlm.AdmissionRequest(max_slots=1))
    done = []
    th = threading.Thread(target=lambda: done.append(
        sess.execute("select count(*) from kv")))
    th.start()
    states = {}

    def queued():
        r = sess.execute("select citus_stat_activity()")
        states.update(zip(r.columns["query"], r.columns["wait_state"]))
        return states.get("select count(*) from kv") == "queued"

    _wait_for(queued)
    _wait_for(lambda: any(r["queued"]
                          for r in sess.wlm.snapshot()["tenants"]))
    time.sleep(0.03)  # a measurable wait
    sess.wlm.release(blocker)
    th.join(timeout=10)
    assert done and int(done[0].rows()[0][0]) == 60
    counters = dict(sess.execute("select citus_stat_counters()").rows())
    assert counters["wlm_queued_total"] >= 1
    assert counters["wlm_queue_wait_ms"] >= 1


def test_cancel_while_queued(sess):
    sess.settings.set("max_concurrent_statements", 1)
    blocker = sess.wlm.admit(pwlm.AdmissionRequest(max_slots=1))
    errs = []

    def run():
        try:
            sess.execute("select count(*) from kv")
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    th = threading.Thread(target=run)
    th.start()
    _wait_for(lambda: sess.wlm.snapshot()["queued_total"] >= 1)
    sess.cancel()
    th.join(timeout=10)
    sess.wlm.release(blocker)
    assert errs and isinstance(errs[0], QueryCanceled)
    snap = sess.wlm.snapshot()
    assert snap["canceled_total"] == 1 and _ledger_ok(snap)


def test_statement_timeout_bounds_queue_wait(sess):
    sess.settings.set("max_concurrent_statements", 1)
    sess.settings.set("statement_timeout_ms", 120)
    blocker = sess.wlm.admit(pwlm.AdmissionRequest(max_slots=1))
    t0 = time.monotonic()
    try:
        with pytest.raises(StatementTimeout):
            sess.execute("select count(*) from kv")
    finally:
        sess.wlm.release(blocker)
        sess.settings.set("statement_timeout_ms", 0)
    assert time.monotonic() - t0 < 5
    counters = dict(sess.execute("select citus_stat_counters()").rows())
    assert counters["timeouts_total"] == 1
    assert sess.wlm.snapshot()["timedout_total"] == 1


def test_queue_wait_comes_out_of_the_timeout(sess, monkeypatch):
    """One deadline over queue wait and execution: the envelope gets
    what the wait left of statement_timeout_ms."""
    seen = []
    orig = sess._execute_resilient

    def spy(stmt, activity=None, timeout_ms=None):
        seen.append(timeout_ms)
        return orig(stmt, activity, timeout_ms=timeout_ms)

    monkeypatch.setattr(sess, "_execute_resilient", spy)
    sess.settings.set("max_concurrent_statements", 1)
    sess.settings.set("statement_timeout_ms", 5000)
    blocker = sess.wlm.admit(pwlm.AdmissionRequest(max_slots=1))
    th = threading.Thread(target=lambda: sess.execute(
        "select count(*) from kv"))
    th.start()
    _wait_for(lambda: sess.wlm.snapshot()["queued_total"] >= 1)
    time.sleep(0.1)
    sess.wlm.release(blocker)
    th.join(timeout=10)
    sess.settings.set("statement_timeout_ms", 0)
    assert len(seen) == 1 and seen[0] is not None
    assert 1.0 <= seen[0] <= 4910


def test_shed_surfaces_as_admission_rejected(sess):
    sess.settings.set("max_concurrent_statements", 1)
    sess.settings.set("wlm_queue_depth", 0)
    blocker = sess.wlm.admit(pwlm.AdmissionRequest(max_slots=1))
    try:
        with pytest.raises(AdmissionRejected):
            sess.execute("select count(*) from kv")
    finally:
        sess.wlm.release(blocker)
    counters = dict(sess.execute("select citus_stat_counters()").rows())
    assert counters["wlm_shed_total"] == 1
    assert _ledger_ok(sess.wlm.snapshot())


def test_wlm_admit_fault_point_directed(sess):
    sess.execute("set max_statement_retries = 0")
    with pfi.inject("wlm.admit", require_fired=True):
        sess.execute("set wlm_queue_depth = 64")  # exempt: no trigger
        with pytest.raises(pfi.InjectedFault):
            sess.execute("select count(*) from kv")
    snap = sess.wlm.snapshot()
    assert snap["slots_in_use"] == 0 and _ledger_ok(snap)
    assert int(sess.execute("select count(*) from kv").rows()[0][0]) == 60


def test_explain_analyze_workload_line(sess):
    r = sess.execute("explain analyze select count(*) from kv")
    lines = [x for x in r.columns["QUERY PLAN"]
             if x.startswith("Workload:")]
    assert len(lines) == 1
    assert "class=interactive tenant=default" in lines[0]
    assert "slots=1/8" in lines[0] and "wlm_admitted_total=" in lines[0]
    with sess.settings.override(wlm_enabled=False):
        r = sess.execute("explain analyze select count(*) from kv")
    assert any(x.startswith("Workload: exempt")
               for x in r.columns["QUERY PLAN"])


def test_tenant_from_pinned_key_and_session_identity(sess):
    sess.execute("select count(*) from kv where id = 5 and v >= 0")
    sess.execute("set wlm_tenant = 'acme'")
    sess.execute("select count(*) from kv")
    tenants = {r["tenant"] for r in sess.wlm.snapshot()["tenants"]}
    assert {"5", "acme"} <= tenants


def test_eight_sessions_two_slots(tmp_path):
    """Eight sessions in threads, two tenants weighted a:3,b:1, two
    slots: every answer exact, at most two statements executing at
    once, every statement admitted, some queued, the ledger whole."""
    d = str(tmp_path / "d")
    setup = citus_tpu_torch.connect(d, device="cpu",
                                    compute_dtype="float64")
    setup.execute("create table kv (id bigint, v bigint)")
    setup.execute("select create_distributed_table('kv', 'id', 4)")
    setup.execute("insert into kv values " + ", ".join(
        f"({i}, {i * 3})" for i in range(120)))
    want_sum = sum(i * 3 for i in range(120))
    sessions = [citus_tpu_torch.connect(
        d, device="cpu", compute_dtype="float64",
        max_concurrent_statements=2, serving_result_cache_bytes=0,
        wlm_tenant="a" if i % 2 else "b", wlm_tenant_weights="a:3,b:1")
        for i in range(8)]
    mu = threading.Lock()
    live = {"now": 0, "max": 0}
    bad: list = []

    def counted(s):
        orig = s._execute_resilient

        def run(stmt, activity=None, timeout_ms=None):
            with mu:
                live["now"] += 1
                live["max"] = max(live["max"], live["now"])
            try:
                time.sleep(0.005)  # hold the slot long enough to overlap
                return orig(stmt, activity, timeout_ms=timeout_ms)
            finally:
                with mu:
                    live["now"] -= 1
        s._execute_resilient = run

    for s in sessions:
        counted(s)

    def worker(s, idx):
        try:
            for _ in range(3):
                c, sm = s.execute("select count(*), sum(v) from kv").rows()[0]
                if int(c) != 120 or int(sm) != want_sum:
                    bad.append((idx, c, sm))
                g = s.execute("select id % 3, count(*) from kv "
                              "group by id % 3").rows()
                if sorted((int(a), int(b)) for a, b in g) != \
                        [(0, 40), (1, 40), (2, 40)]:
                    bad.append((idx, g))
        except Exception as e:  # noqa: BLE001 — asserted below
            bad.append((idx, repr(e)))

    threads = [threading.Thread(target=worker, args=(s, i))
               for i, s in enumerate(sessions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not bad, bad[:3]
    snap = sessions[0].wlm.snapshot()
    assert _ledger_ok(snap) and snap["slots_in_use"] == 0
    assert live["max"] == 2
    admitted = sum(dict(s.execute("select citus_stat_counters()").rows())
                   ["wlm_admitted_total"] for s in sessions)
    assert admitted == 8 * 6
    assert snap["queued_total"] > 0
    rows = {r["tenant"]: r for r in snap["tenants"]}
    assert rows["a"]["admitted_total"] == rows["b"]["admitted_total"] == 24
    assert rows["a"]["weight"] == 3 and rows["b"]["weight"] == 1
    for s in sessions:
        assert s.executor.accountant.transient_bytes() == 0
        s.close()
    setup.close()


# -- concurrency -------------------------------------------------------------

def test_cached_plan_hits_thread_safe_across_sessions(tmp_path):
    """The port's counterpart of the JAX package's
    tests/test_concurrency.py::test_cached_plan_hits_thread_safe_across_
    sessions: two sessions sharing a data_dir, two threads inside each,
    hammering cached-plan hits.  The JAX package fails its version of
    this test (its capacity memo is iterated while written).  The port's
    runner takes `_caps_lock` around every memo read and write, its plan
    and feed caches lock their own entries, and a cached PlanCompiler,
    which keeps a run's plan, capacities and stage counters on itself,
    runs one thread at a time (`PlanCompiler._run_lock`: two threads of
    one session on one shape used to read each other's capacities)."""
    d = str(tmp_path / "d")
    s1 = citus_tpu_torch.connect(d, device="cpu", compute_dtype="float64",
                                 serving_result_cache_bytes=0)
    s1.execute("create table cq (id bigint, g bigint, v bigint)")
    s1.execute("select create_distributed_table('cq', 'id', 4)")
    s1.execute("insert into cq values " + ", ".join(
        f"({i}, {i % 7}, {i})" for i in range(1200)))
    want = sum(range(1200))
    s2 = citus_tpu_torch.connect(d, device="cpu", compute_dtype="float64",
                                 serving_result_cache_bytes=0)
    for s in (s1, s2):  # warm both plan caches
        s.execute("select sum(v), count(*) from cq")
        s.execute("select g, count(*) from cq group by g")
    errors: list = []

    def hammer(s):
        try:
            for _ in range(16):
                r = s.execute("select sum(v), count(*) from cq")
                assert int(r.rows()[0][0]) == want
                r2 = s.execute("select g, count(*) from cq group by g")
                assert sum(int(x[1]) for x in r2.rows()) == 1200
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(s,))
               for s in (s1, s2) for _ in range(2)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads finely
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    for s in (s1, s2):
        assert s.executor.plan_cache.hits >= 32
        assert s.executor.plan_cache.misses == 2
        assert s.executor.accountant.transient_bytes() == 0
    s1.close()
    s2.close()


def test_launch_counts_are_exact_under_threads():
    """Sixteen threads (more than this machine's cores) count launches
    with the interpreter switching threads every microsecond: a lost
    read-modify-write of `LAUNCHES[name] += 1` would show in the sums."""
    hk.reset_launch_counts()
    names = list(hk.KERNELS)
    n_threads, per_thread = 16, 2000

    def bump():
        for i in range(per_thread):
            hk.count_launch(names[i % len(names)])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert sum(hk.LAUNCHES.values()) == n_threads * per_thread
    assert all(v == n_threads * per_thread // len(names)
               for v in hk.LAUNCHES.values())
    hk.reset_launch_counts()
    assert sum(hk.LAUNCHES.values()) == 0

