"""The port's serving layer (citus_tpu_torch/serving/) against the JAX
package's, on CPU torch.

* The one point-read classifier: the JAX package's corpus classifies
  identically through both packages and both call sites (serving and
  the WLM exemption), and agrees with the bound-plan router.
* The micro-batcher: single flight, coalescing across sessions, a
  `serving.batch_dispatch` fault erroring the whole batch cleanly (the
  answered + errored + fallback = requests ledger), an index miss
  falling back to the scan, a session with an open overlay going solo,
  the requester-side counters.
* `pkindex.read_rows_multi`: equal to the solo reader and to the JAX
  package's for the same keys, deleted rows included.
* The result cache: hits, misses and invalidations equal the JAX
  package's over one script of reads and writes from two sessions;
  exact cross-session invalidation (DML, COPY, COMMIT), the open
  transaction rule, the manifest backstop, the byte bound, the fill
  token, the `serving.cache_fill` fault point, view reads, the evict
  rung, and EXPLAIN ANALYZE's Serving line.
"""

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu.serving import classify_point_read as j_classify
from citus_tpu.sql import parse as jparse
from citus_tpu.storage import pkindex as jpkindex
from citus_tpu_torch.errors import CitusTpuError
from citus_tpu_torch.executor.fastpath import fast_path_shape, point_lookup_const
from citus_tpu_torch.executor.feed import walk_plan
from citus_tpu_torch.executor.hbm import oom_budget
from citus_tpu_torch.executor.runner import ResultSet
from citus_tpu_torch.planner.plan import ScanNode
from citus_tpu_torch.serving import batcher_for, classify_point_read
from citus_tpu_torch.serving.result_cache import (
    ResultCache,
    cache_key,
    result_cache_for,
)
from citus_tpu_torch.session import _UDFS
from citus_tpu_torch.sql import parse
from citus_tpu_torch.stats import counters as sc
from citus_tpu_torch.storage import pkindex
from citus_tpu_torch.utils import faultinjection as pfi
from citus_tpu_torch.wlm import fastpath_exempt_shape

torch.set_num_threads(1)

SETUP = [
    "create table kv (k bigint, v bigint, s text)",
    "select create_distributed_table('kv', 'k', 4)",
    "insert into kv values " + ", ".join(
        f"({i}, {i * 10}, 'n{i % 5}')" for i in range(200)),
    "create table ref (v bigint)",
    "select create_reference_table('ref')",
    "insert into ref values (10), (20)",
]


def _port(d, **kw):
    kw.setdefault("retry_backoff_base_ms", 1)
    kw.setdefault("retry_backoff_max_ms", 2)
    return citus_tpu_torch.connect(d, device="cpu", compute_dtype="float64",
                                   **kw)


def _jax(d, **kw):
    return citus_tpu.connect(data_dir=d, n_devices=1,
                             exec_cache_enabled=False,
                             compute_dtype="float64",
                             recover_2pc_interval_ms=-1,
                             defer_shard_delete_interval_ms=-1,
                             health_check_interval_ms=-1,
                             retry_backoff_base_ms=1, **kw)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """kv + ref written by the JAX package (one stripe per insert)."""
    d = str(tmp_path_factory.mktemp("torch_serving") / "base")
    s = _jax(d, serving_result_cache_bytes=0)
    for sql in SETUP:
        s.execute(sql)
    s.close()
    return d


def _copy(base, tmp_path, name="d"):
    d = str(tmp_path / name)
    shutil.copytree(base, d)
    return d


@pytest.fixture()
def sess(base, tmp_path):
    s = _port(_copy(base, tmp_path))
    yield s
    s.close()


def _counter(s, name):
    return s.stats.counters.snapshot().get(name, 0)


def _stat_serving(s) -> dict:
    r = s.execute("select citus_stat_serving()")
    return dict(zip(r.column_names, r.rows()[0]))


# -- one classifier ----------------------------------------------------------

CLASSIFIER_CORPUS = [
    ("select v from kv where k = 5", True),
    ("select v, s from kv where k = 5 and v > 2", True),
    ("select v from kv where 5 = k", True),
    ("select v from kv as t where t.k = 7", True),
    ("select * from kv", False),
    ("select v from kv where v = 5", False),
    ("select count(*) from kv where k = 5", False),
    ("select v from kv where k = 5 or v = 1", False),
    ("select v from kv, ref where k = 1", False),
    ("select v from kv where k = 5 group by v", False),
    ("select distinct v from kv where k = 5", False),
    ("select v from ref where v = 10", False),
    ("select v from nope where k = 1", False),
    ("select v from kv where k in (1, 2)", False),
    ("select v from kv where k = 1 limit 1", True),
    ("with c as (select 1) select v from kv where k = 1", False),
]


@pytest.mark.parametrize("sql,want", CLASSIFIER_CORPUS)
def test_classifier_matches_jax_at_both_call_sites(base, sql, want):
    p = _port(base)
    j = _jax(base, serving_result_cache_bytes=0)
    try:
        got = classify_point_read(parse(sql)[0], p.catalog, p.settings)
        jgot = j_classify(jparse(sql)[0], j.catalog, j.settings)
        assert (got is not None) == (jgot is not None) == want
        if got is not None:
            assert (got.table, got.column, got.value) == \
                (jgot.table, jgot.column, jgot.value)
        assert fastpath_exempt_shape(parse(sql)[0], p.catalog,
                                     p.settings) == want
    finally:
        j.close()


def test_classifier_agrees_with_bound_plan_router(sess):
    for sql, want in CLASSIFIER_CORPUS:
        if not want:
            continue
        plan, cleanup = sess._plan_select(parse(sql)[0], ())
        assert cleanup == []
        assert fast_path_shape(plan, sess.catalog), sql
        consts = [point_lookup_const(n, sess.catalog, sess.settings)
                  for n in walk_plan(plan.root) if isinstance(n, ScanNode)]
        assert consts and all(c is not None for c in consts), sql
    pr = classify_point_read(parse("select v from kv where s = 'x' and "
                                   "k = 42")[0], sess.catalog,
                             sess.settings)
    assert (pr.table, pr.column, pr.value) == ("kv", "k", 42)
    with sess.settings.override(enable_fast_path_router=False):
        stmt = parse("select v from kv where k = 5")[0]
        assert classify_point_read(stmt, sess.catalog,
                                   sess.settings) is None
        assert not fastpath_exempt_shape(stmt, sess.catalog, sess.settings)


def test_point_reads_exempt_from_admission(sess):
    before = sess.wlm.snapshot()["requests_total"]
    assert sess.execute("select v from kv where k = 11").rows() == [(110,)]
    assert sess.wlm.snapshot()["requests_total"] == before


# -- the micro-batcher -------------------------------------------------------

def _ledger_ok(snap, base=None):
    base = base or {k: 0 for k in snap}
    return snap["requests_total"] - base["requests_total"] == (
        snap["answered_total"] - base["answered_total"]
        + snap["errored_total"] - base["errored_total"]
        + snap["fallback_total"] - base["fallback_total"])


def test_single_flight(sess):
    b = batcher_for(sess.data_dir)
    before = b.snapshot()
    assert sess.execute("select v from kv where k = 17").rows() == [(170,)]
    snap = b.snapshot()
    assert snap["requests_total"] == before["requests_total"] + 1
    assert snap["answered_total"] == before["answered_total"] + 1
    assert snap["batch_dispatch_total"] == \
        before["batch_dispatch_total"] + 1
    assert snap["queue_depth"] == 0 and not snap["leader_active"]


def test_concurrent_lookups_coalesce(sess, monkeypatch):
    """8 threads over 2 sessions, 3 lookups each: every answer exact,
    and with the leader's read slowed at least one batch carries more
    than one lookup, so dispatches < requests."""
    sess.execute("set serving_result_cache_bytes = 0")
    s2 = _port(sess.data_dir, serving_result_cache_bytes=0)
    real = pkindex.read_rows_multi

    def slowed(*a, **kw):
        time.sleep(0.02)  # arrivals pile up behind the leader
        return real(*a, **kw)

    monkeypatch.setattr(pkindex, "read_rows_multi", slowed)
    b = batcher_for(sess.data_dir)
    base = b.snapshot()
    barrier = threading.Barrier(8)
    errors: list = []

    def worker(s, key):
        try:
            barrier.wait(timeout=60)
            for _ in range(3):
                assert s.execute(f"select v from kv where k = {key}"
                                 ).rows() == [(key * 10,)]
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=worker,
                                args=((sess, s2)[i % 2], 20 + i))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    snap = b.snapshot()
    s2.close()
    assert not errors, errors[0]
    assert snap["requests_total"] - base["requests_total"] == 24
    assert snap["answered_total"] - base["answered_total"] == 24
    assert snap["max_batch_seen"] >= 2
    assert snap["batch_dispatch_total"] - base["batch_dispatch_total"] < 24
    assert snap["queue_depth"] == 0 and not snap["leader_active"]


def test_batch_dispatch_fault_errors_whole_batch_cleanly(sess):
    s2 = _port(sess.data_dir, max_statement_retries=0)
    sess.execute("set max_statement_retries = 0")
    b = batcher_for(sess.data_dir)
    base = b.snapshot()
    outcomes: list = []
    lock = threading.Lock()

    def worker(s, key):
        try:
            r = s.execute(f"select v from kv where k = {key}")
            with lock:
                outcomes.append(("ok", r.rows()))
        except Exception as e:  # noqa: BLE001 — asserted below
            with lock:
                outcomes.append(("err", e))

    with pfi.inject("serving.batch_dispatch", times=2,
                    require_fired=True):
        threads = [threading.Thread(target=worker,
                                    args=((sess, s2)[i % 2], 30 + i))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    try:
        assert len(outcomes) == 6
        assert any(k == "err" for k, _ in outcomes)
        for kind, payload in outcomes:
            if kind == "err":
                assert isinstance(payload, CitusTpuError), payload
        snap = b.snapshot()
        assert _ledger_ok(snap, base)
        assert snap["errored_total"] > base["errored_total"]
        assert snap["queue_depth"] == 0 and not snap["leader_active"]
        assert sess.execute("select v from kv where k = 3").rows() == \
            [(30,)]
    finally:
        s2.close()


def test_batch_dispatch_fault_is_retried_transparently(sess):
    with pfi.inject("serving.batch_dispatch", require_fired=True):
        assert sess.execute("select v from kv where k = 77").rows() == \
            [(770,)]
    assert _counter(sess, sc.RETRIES_TOTAL) == 1
    assert _counter(sess, sc.FAULTS_INJECTED_TOTAL) == 1


def test_index_miss_falls_back_to_scan(sess, monkeypatch):
    monkeypatch.setattr(pkindex, "lookup", lambda *a, **kw: None)
    b = batcher_for(sess.data_dir)
    base = b.snapshot()["fallback_total"]
    assert sess.execute("select v from kv where k = 19").rows() == [(190,)]
    assert b.snapshot()["fallback_total"] == base + 1
    assert _counter(sess, sc.SERVING_BATCHED_LOOKUPS_TOTAL) == 0


def test_open_overlay_session_goes_solo(sess):
    s2 = _port(sess.data_dir)
    try:
        b = batcher_for(sess.data_dir)
        sess.execute("begin")
        sess.execute("delete from kv where k = 33")
        base = b.snapshot()["requests_total"]
        # read-your-writes: the staged delete is visible, solo
        assert sess.execute("select v from kv where k = 33").rows() == []
        assert b.snapshot()["requests_total"] == base
        # no dirty read: the other session sees the committed row
        assert s2.execute("select v from kv where k = 33").rows() == \
            [(330,)]
        assert b.snapshot()["requests_total"] == base + 1
        sess.execute("rollback")
        assert sess.execute("select v from kv where k = 33").rows() == \
            [(330,)]
    finally:
        s2.close()


def test_serving_disabled_solo_path(sess):
    b = batcher_for(sess.data_dir)
    base = b.snapshot()["requests_total"]
    with sess.settings.override(serving_enabled=False):
        assert sess.execute("select v from kv where k = 21").rows() == \
            [(210,)]
    assert b.snapshot()["requests_total"] == base
    assert _counter(sess, sc.POINT_INDEX_LOOKUPS) == 1
    assert _counter(sess, sc.SERVING_BATCHED_LOOKUPS_TOTAL) == 0


def test_requester_side_counters_fold(sess):
    sess.execute("select v from kv where k = 23")
    assert _counter(sess, sc.SERVING_BATCHED_LOOKUPS_TOTAL) == 1
    assert _counter(sess, sc.SERVING_BATCH_DISPATCH_TOTAL) == 1
    assert _counter(sess, sc.POINT_INDEX_LOOKUPS) == 1


# -- the batched index reader ------------------------------------------------

def _hits_by_shard(mod, store, keys):
    out: dict[int, list] = {}
    for shard in store.catalog.table_shards("kv"):
        for k in keys:
            hits = mod.lookup(store, "kv", shard.shard_id, "k", k)
            if hits:
                out.setdefault(shard.shard_id, []).append((k, hits))
    return out


@pytest.mark.parametrize("deleted", [False, True])
def test_read_rows_multi_matches_solo_and_jax(base, tmp_path, deleted):
    d = _copy(base, tmp_path)
    p = _port(d)
    keys = list(range(1, 40)) + [7, 7, 1000]
    if deleted:
        p.execute("delete from kv where k in (3, 8, 13, 14)")
    j = _jax(d, serving_result_cache_bytes=0)
    try:
        pb = _hits_by_shard(pkindex, p.store, keys)
        jb = _hits_by_shard(jpkindex, j.store, keys)
        assert sorted(pb) == sorted(jb)
        cols = ["v", "s", "k"]
        for sid, pairs in pb.items():
            jpairs = jb[sid]
            assert [k for k, _h in pairs] == [k for k, _h in jpairs]
            multi = pkindex.read_rows_multi(p.store, "kv", sid, cols,
                                            [h for _k, h in pairs])
            jmulti = jpkindex.read_rows_multi(j.store, "kv", sid, cols,
                                              [h for _k, h in jpairs])
            for (k, hits), (mv, mm, mn), (jv, jm, jn) in zip(
                    pairs, multi, jmulti):
                sv, sm, sn = pkindex.read_rows(p.store, "kv", sid, cols,
                                               hits)
                assert mn == sn == jn
                assert mn == (0 if deleted and k in (3, 8, 13, 14) else 1)
                for c in cols:
                    np.testing.assert_array_equal(mv[c], sv[c])
                    np.testing.assert_array_equal(mm[c], sm[c])
                    np.testing.assert_array_equal(mv[c], jv[c])
                    np.testing.assert_array_equal(mm[c], jm[c])
    finally:
        j.close()
        p.close()


# -- the result cache --------------------------------------------------------

CACHE_SCRIPT = [
    ("a", "select v, s from kv where k = 9"),
    ("a", "select v, s from kv where k = 9"),
    ("a", "select count(*) from ref"),
    ("a", "select count(*), sum(v) from kv where v >= 0"),
    ("b", "select count(*), sum(v) from kv where v >= 0"),
    ("b", "update kv set v = 1 where k = 12"),
    ("a", "select count(*), sum(v) from kv where v >= 0"),
    ("a", "select count(*) from ref"),
    ("b", "insert into ref values (30)"),
    ("a", "select count(*) from ref"),
    ("a", "select v, s from kv where k = 9"),
    ("b", "begin"),
    ("b", "delete from kv where k = 9"),
    ("b", "select v, s from kv where k = 9"),
    ("a", "select v, s from kv where k = 9"),
    ("b", "commit"),
    ("a", "select v, s from kv where k = 9"),
    ("b", "select count(*) from ref"),
    ("a", "select s, count(*) from kv group by s order by s"),
    ("b", "select s, count(*) from kv group by s order by s"),
]

CACHE_COUNTERS = (sc.SERVING_CACHE_HITS_TOTAL, sc.SERVING_CACHE_MISSES_TOTAL,
                  sc.SERVING_CACHE_INVALIDATIONS_TOTAL)


def test_cache_counters_match_jax_over_two_sessions(base, tmp_path):
    out = {}
    for pkg in ("jax", "port"):
        d = _copy(base, tmp_path, pkg)
        conn = _jax if pkg == "jax" else _port
        a, b = conn(d), conn(d)
        rows = []
        for who, sql in CACHE_SCRIPT:
            r = (a if who == "a" else b).execute(sql)
            if r is not None:
                rows.append(sorted(tuple(str(x) for x in t)
                                   for t in r.rows()))
        counters = [tuple(s.stats.counters.snapshot()[c]
                          for c in CACHE_COUNTERS) for s in (a, b)]
        out[pkg] = (rows, counters)
        a.close()
        b.close()
    assert out["port"] == out["jax"]
    (ha, ma, _ia), (hb, mb, _ib) = out["port"][1]
    assert ha >= 3 and hb >= 1 and ma >= 4


def test_repeat_hits_and_stat_serving(sess):
    q = "select v, s from kv where k = 9"
    sess.execute(q)
    pc = sess.executor.plan_cache
    before = (pc.hits, pc.misses)
    r = sess.execute(q)
    assert r.rows() == [(90, "n4")] and r.device_rows_scanned == 0
    assert (pc.hits, pc.misses) == before  # nothing planned or run
    assert _counter(sess, sc.SERVING_CACHE_HITS_TOTAL) == 1
    stat = _stat_serving(sess)
    assert list(stat) == [
        "requests_total", "answered_total", "errored_total",
        "fallback_total", "batch_dispatch_total", "batched_lookups_total",
        "max_batch_seen", "avg_batch_occupancy", "queue_depth",
        "cache_entries", "cache_bytes", "cache_hits_total",
        "cache_misses_total", "cache_invalidations_total",
        "cache_last_lsn"]
    assert stat["cache_hits_total"] == 1 and stat["cache_entries"] >= 1


def test_copy_and_commit_invalidate(sess, tmp_path):
    s2 = _port(sess.data_dir)
    try:
        q = "select count(*) from kv"
        n0 = int(sess.execute(q).rows()[0][0])
        csv = str(tmp_path / "more.csv")
        with open(csv, "w") as f:
            f.write("9001,1,x\n9002,2,y\n")
        s2.execute(f"copy kv from '{csv}' with (format csv)")
        assert int(sess.execute(q).rows()[0][0]) == n0 + 2
        s2.execute("begin")
        s2.execute("delete from kv where k = 9001")
        assert int(sess.execute(q).rows()[0][0]) == n0 + 2
        s2.execute("commit")
        assert int(sess.execute(q).rows()[0][0]) == n0 + 1
    finally:
        s2.close()


def test_open_transaction_bypasses_cache(sess):
    q = "select v from kv where k = 31"
    assert sess.execute(q).rows() == [(310,)]
    sess.execute("begin")
    sess.execute("update kv set v = 7 where k = 31")
    m0 = _counter(sess, sc.SERVING_CACHE_MISSES_TOTAL)
    h0 = _counter(sess, sc.SERVING_CACHE_HITS_TOTAL)
    assert sess.execute(q).rows() == [(7,)]
    assert _counter(sess, sc.SERVING_CACHE_MISSES_TOTAL) == m0
    assert _counter(sess, sc.SERVING_CACHE_HITS_TOTAL) == h0
    sess.execute("rollback")
    assert sess.execute(q).rows() == [(310,)]


def test_manifest_backstop_catches_journal_missed_write(sess):
    s2 = _port(sess.data_dir)
    try:
        q = "select v from kv where k = 44"
        assert sess.execute(q).rows() == [(440,)]
        with s2.store.change_log.suppress():
            s2.execute("update kv set v = 4 where k = 44")
        assert sess.execute(q).rows() == [(4,)]
    finally:
        s2.close()


def test_lru_byte_bound_and_oversized_refusal(sess):
    cache = result_cache_for(sess.data_dir)
    cache.clear()
    sess.execute("set serving_result_cache_bytes = 4096")
    for k in range(60, 90):
        sess.execute(f"select v from kv where k = {k}")
    assert 0 < cache.total_bytes <= 4096
    assert 0 < len(cache) < 30
    sess.execute("set serving_result_cache_bytes = 1000")
    cache.clear()
    sess.execute("select k, v, s from kv where v >= 0")
    assert len(cache) == 0


def test_cache_fill_fault_is_clean_and_retried(sess):
    with pfi.inject("serving.cache_fill", require_fired=True):
        r = sess.execute("select count(*) from kv where v >= -5")
    assert int(r.rows()[0][0]) == 200
    assert _counter(sess, sc.RETRIES_TOTAL) == 1
    sess.execute("set max_statement_retries = 0")
    with pfi.inject("serving.cache_fill", require_fired=True):
        with pytest.raises(pfi.InjectedFault):
            sess.execute("select count(*) from kv where v >= -6")
    assert len(result_cache_for(sess.data_dir)) == 1


def test_uncacheable_statements_skip_the_cache(sess):
    assert cache_key(parse("select nextval('s1')")[0], (), sess.catalog,
                     sess.settings, _UDFS) is None
    assert cache_key(parse("update kv set v = 1")[0], (), sess.catalog,
                     sess.settings, _UDFS) is None
    sess.execute("select citus_stat_counters()")
    assert _counter(sess, sc.SERVING_CACHE_MISSES_TOTAL) == 0


def test_view_reads_subscribe_to_base_tables(sess):
    sess.execute("create view big as select k, v from kv where v >= 1000")
    q = "select count(*) from big"
    n0 = int(sess.execute(q).rows()[0][0])
    sess.execute("update kv set v = v + 10000 where k = 5")
    assert int(sess.execute(q).rows()[0][0]) == n0 + 1


def test_evict_rung_clears_the_result_cache(sess):
    sess.execute("set scan_pipeline = off")
    sess.execute("select count(*) from ref")
    cache = result_cache_for(sess.data_dir)
    assert len(cache) == 1
    with oom_budget(sess.executor.accountant, fail_at=1):
        r = sess.execute("select s, count(*) from kv group by s")
    assert r.row_count == 5
    assert sess.last_oom_rungs[0] == "evict_caches"
    assert len(cache) == 1  # only the new fill: the old entry is gone
    assert sess.executor.accountant.transient_bytes() == 0


def test_explain_analyze_serving_line(sess):
    sess.execute("select v from kv where k = 8")  # fill the cache
    r = sess.execute("explain analyze select v from kv where k = 8")
    text = "\n".join(r.columns["QUERY PLAN"])
    assert "Serving: batched lookups=1 dispatches led=1 " \
           "result-cache=cached" in text
    with sess.settings.override(serving_enabled=False):
        r = sess.execute("explain analyze select v from kv where k = 8")
    assert "Serving: off" in r.columns["QUERY PLAN"]


class TestResultCacheUnit:
    def _mk(self, tmp_path):
        d = str(tmp_path / "rc")
        os.makedirs(d, exist_ok=True)
        return d, ResultCache(d)

    def _emit(self, d, lsn, table):
        with open(os.path.join(d, "cdc_changes.jsonl"), "a") as f:
            f.write(json.dumps({"lsn": lsn, "table": table,
                                "kind": "insert", "shard_id": 1,
                                "file": "x", "rows": 1}) + "\n")

    def _res(self, n=3):
        return ResultSet(["a"], {"a": np.arange(n)}, n)

    def test_fill_token_refuses_mid_execution_write(self, tmp_path):
        d, c = self._mk(tmp_path)
        token = c.fill_token()
        self._emit(d, 1, "t")
        assert not c.put(("k",), self._res(), ["t"], {}, token, 1 << 20)
        assert c.put(("k",), self._res(), ["t"], {}, c.fill_token(),
                     1 << 20)

    def test_table_indexed_invalidation(self, tmp_path):
        d, c = self._mk(tmp_path)
        t = c.fill_token()
        c.put(("ka",), self._res(), ["a"], {}, t, 1 << 20)
        c.put(("kb",), self._res(), ["b"], {}, t, 1 << 20)
        c.put(("kab",), self._res(), ["a", "b"], {}, t, 1 << 20)
        self._emit(d, 1, "a")
        assert c.get(("kb",)) is not None
        assert c.get(("ka",)) is None and c.get(("kab",)) is None
        assert c.invalidations == 2

    def test_journal_regression_drops_everything(self, tmp_path):
        d, c = self._mk(tmp_path)
        self._emit(d, 1, "a")
        c.fill_token()
        c.put(("ka",), self._res(), ["a"], {}, c.fill_token(), 1 << 20)
        with open(os.path.join(d, "cdc_changes.jsonl"), "w"):
            pass  # the journal was replaced
        assert c.get(("ka",)) is None and len(c) == 0
