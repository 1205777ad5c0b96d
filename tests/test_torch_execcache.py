"""The port's persisted plan cache, capture gate, caps memo and
warm-before-admit (citus_tpu_torch/executor/execcache.py, the persisted
memo of executor/runner.py, wlm/manager.py's admission hold and the
session's warmup thread), on CPU torch, held to the JAX package's
invariants and to the JAX package's own files on one data_dir.

* CompileGate: one build per key across 8 threads; a follower cancelled
  or timed out while it waits; a dying leader hands leadership on; a
  leader's error reaches each follower as its own clone.
* ExecutableCache: store and load, a flipped byte, a torn payload, a
  payload missing under its meta, version and stamp skew, the fault
  points, pruning past the bound, `top_hashes` order.
* Across packages: each package misses or skips the other's entries by
  their stamp, with no crash and the same rows; pruning may remove the
  other package's coldest entries, and that package then recompiles.
* The caps memo: a fresh session starts converged (no capacity retry);
  the two packages' fingerprints never match each other's entries, and
  each keeps the other's entries when it rewrites the file.
* Warm-before-admit: admissions wait while a hold is active, pass at
  its deadline or release, and a cancel ends the wait; close() during a
  warmup leaves no thread; a `wlm.warmup` fault releases the hold.

JAX sessions open with n_devices=1 (ROADMAP, Context).
"""

import json
import os
import threading
import time

import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu.executor import execcache as jexec
from citus_tpu_torch.errors import QueryCanceled, StatementTimeout
from citus_tpu_torch.executor import execcache as pexec
from citus_tpu_torch.executor.execcache import (
    CompileGate,
    ExecutableCache,
    exec_cache_for,
    key_from_json,
    key_to_json,
)
from citus_tpu_torch.stats import counters as psc
from citus_tpu_torch.utils import cancellation
from citus_tpu_torch.utils import faultinjection as pfi
from citus_tpu_torch.wlm.manager import AdmissionRequest, WorkloadManager

torch.set_num_threads(1)

SQL = "select b, count(*), sum(a) from t group by b order by b"
EXPECTED = [(b, len([a for a in range(200) if a % 7 == b]),
             sum(a for a in range(200) if a % 7 == b)) for b in range(7)]
SQL2 = "select a % 3, count(*) from t where a > 50 group by a % 3 order by 1"
EXPECTED2 = [(r, len([a for a in range(51, 200) if a % 3 == r]))
             for r in range(3)]

_DAEMON_OFF = dict(recover_2pc_interval_ms=-1,
                   defer_shard_delete_interval_ms=-1,
                   health_check_interval_ms=-1)


def _port(d, **kw):
    kw.setdefault("serving_result_cache_bytes", 0)
    return citus_tpu_torch.connect(str(d), device="cpu", **kw)


def _jax(d, **kw):
    return citus_tpu.connect(data_dir=str(d), n_devices=1,
                             serving_result_cache_bytes=0, **_DAEMON_OFF,
                             **kw)


def _seed(d):
    s = _port(d)
    s.execute("create table t (a bigint, b bigint)")
    s.execute("select create_distributed_table('t', 'a', 4)")
    s.execute("insert into t values " + ", ".join(
        f"({i}, {i % 7})" for i in range(200)))
    s.close()


def _rows(res):
    return [tuple(int(x) for x in r) for r in res.rows()]


def _counter(sess, name):
    return sess.stats.counters.snapshot().get(name, 0)


def _metas(d):
    ed = os.path.join(str(d), pexec.EXEC_CACHE_DIR)
    return sorted(f[:-len(".meta.json")] for f in os.listdir(ed)
                  if f.endswith(".meta.json"))


# -- CompileGate ---------------------------------------------------------------

class _Waiters:
    """Counts the threads a gate's followers park in (each wait slice
    runs check_cancel), so a test releases its leader only once every
    follower is waiting."""

    def __init__(self, monkeypatch):
        self.idents = set()
        self.mu = threading.Lock()
        self.changed = threading.Condition(self.mu)
        real = cancellation.check_cancel

        def counting():
            with self.mu:
                self.idents.add(threading.get_ident())
                self.changed.notify_all()
            real()

        monkeypatch.setattr(cancellation, "check_cancel", counting)

    def wait_for(self, n, timeout=30.0):
        with self.mu:
            assert self.changed.wait_for(lambda: len(self.idents) >= n,
                                         timeout), len(self.idents)


def test_gate_eight_threads_one_build(monkeypatch):
    gate = CompileGate()
    waiters = _Waiters(monkeypatch)
    go = threading.Event()
    builds = []

    def build():
        builds.append(threading.get_ident())
        assert go.wait(30)
        return ("entry",)

    out = [None] * 8

    def worker(i):
        out[i] = gate.run("k", build)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    waiters.wait_for(7)
    go.set()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert len(builds) == 1
    assert sorted(d for _e, d in out) == [False] + [True] * 7
    assert {e for e, _d in out} == {("entry",)}
    snap = gate.snapshot()
    assert (snap["flights_led_total"], snap["deduped_total"],
            snap["in_flight"]) == (1, 7, 0)


@pytest.mark.parametrize("how", ["cancel", "timeout"])
def test_gate_follower_cancelled_or_timed_out(monkeypatch, how):
    gate = CompileGate()
    waiters = _Waiters(monkeypatch)
    go = threading.Event()
    leader_out, follower_err = [], []

    def leader():
        leader_out.append(gate.run("k", lambda: go.wait(30) and "entry"))

    cancel = threading.Event()

    def follower():
        timeout_ms = 50 if how == "timeout" else None
        with cancellation.deadline_scope(timeout_ms, cancel):
            try:
                gate.run("k", lambda: "never")
            except (QueryCanceled, StatementTimeout) as e:
                follower_err.append(e)

    t1 = threading.Thread(target=leader)
    t1.start()
    while not gate.snapshot()["in_flight"]:
        time.sleep(0.001)
    t2 = threading.Thread(target=follower)
    t2.start()
    waiters.wait_for(1)
    if how == "cancel":
        cancel.set()
    t2.join(30)
    assert not t2.is_alive()
    assert len(follower_err) == 1
    assert isinstance(follower_err[0], QueryCanceled if how == "cancel"
                      else StatementTimeout)
    go.set()
    t1.join(30)
    assert leader_out == [("entry", False)]
    assert gate.snapshot()["in_flight"] == 0


def test_gate_dying_leader_hands_leadership_on(monkeypatch):
    gate = CompileGate()
    waiters = _Waiters(monkeypatch)
    die = threading.Event()

    class Death(BaseException):
        pass

    def dying():
        assert die.wait(30)
        raise Death()

    out, deaths = [], []

    def leader():
        try:
            gate.run("k", dying)
        except Death:
            deaths.append(1)

    t1 = threading.Thread(target=leader)
    t1.start()
    while not gate.snapshot()["in_flight"]:
        time.sleep(0.001)
    t2 = threading.Thread(target=lambda: out.append(
        gate.run("k", lambda: "built by the follower")))
    t2.start()
    waiters.wait_for(1)
    die.set()
    t1.join(30)
    t2.join(30)
    assert deaths == [1]
    assert out == [("built by the follower", False)]
    snap = gate.snapshot()
    assert (snap["promoted_total"], snap["flights_led_total"],
            snap["in_flight"]) == (1, 1, 0)


def test_gate_leader_error_reaches_each_follower_as_a_clone(monkeypatch):
    gate = CompileGate()
    waiters = _Waiters(monkeypatch)
    fail = threading.Event()
    boom = RuntimeError("capture failed")
    boom.injected_fault = True

    def failing():
        assert fail.wait(30)
        raise boom

    caught = []

    def follower():
        try:
            gate.run("k", lambda: "never")
        except RuntimeError as e:
            caught.append(e)

    t1 = threading.Thread(target=lambda: pytest.raises(
        RuntimeError, gate.run, "k", failing))
    t1.start()
    while not gate.snapshot()["in_flight"]:
        time.sleep(0.001)
    followers = [threading.Thread(target=follower) for _ in range(3)]
    for t in followers:
        t.start()
    waiters.wait_for(3)
    fail.set()
    for t in [t1] + followers:
        t.join(30)
    assert len(caught) == 3
    assert all(e is not boom and e.injected_fault for e in caught)
    assert len({id(e) for e in caught}) == 3
    assert gate.snapshot()["errored_followers_total"] == 3


# -- ExecutableCache -------------------------------------------------------------

KEY = (("S(0;t;...)", 1, "float64"), ("cpu",), ((0, 256),))
CAPS = ({}, {0: 256}, {2: 128}, False, {}, None, {}, {})
META = [("col", "t.b", "int64"), ("valid", "", "bool")]


def _store(ec, key=KEY):
    import numpy as np

    assert ec.store(key, "cpu", CAPS,
                    [(k, c, np.dtype(d)) for k, c, d in META],
                    [(1, "agg_out", 128)])
    return pexec.entry_hash(key, ec.stamp("cpu"))


def test_store_and_load_round_trip(tmp_path):
    ec = ExecutableCache(str(tmp_path))
    h = _store(ec)
    entry, status = ec.load(KEY, "cpu")
    assert status == "hit"
    assert entry["caps"] == CAPS
    assert [(k, c, str(d)) for k, c, d in entry["out_meta"]] == META
    assert entry["stage_keys"] == [(1, "agg_out", 128)]
    assert ec.load_hash(h, "cpu") == (KEY, entry)
    assert ec.load(KEY + (1,), "cpu") == (None, "miss")
    # the payload is JSON, framed; nothing is pickled
    with open(ec._bin_path(h), "rb") as f:
        payload = pexec._unframe(f.read(), 1)[0]
    assert key_from_json(json.loads(payload)["caps"]) == CAPS
    snap = ec.snapshot()
    assert (snap["hits_total"], snap["misses_total"],
            snap["stores_total"]) == (2, 1, 1)


def _flip(path, at):
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0x10]))


@pytest.mark.parametrize("damage", ["bin_byte", "meta_byte", "torn_bin",
                                    "bin_missing", "version", "stamp"])
def test_damaged_entry_is_a_counted_reject_and_dropped(tmp_path, damage):
    from citus_tpu_torch.utils.io import (
        atomic_write_json_checked,
        read_json_checked,
    )

    ec = ExecutableCache(str(tmp_path))
    h = _store(ec)
    meta, bin_ = ec._meta_path(h), ec._bin_path(h)
    if damage == "bin_byte":
        _flip(bin_, os.path.getsize(bin_) - 3)
    elif damage == "meta_byte":
        _flip(meta, os.path.getsize(meta) // 2)
    elif damage == "torn_bin":
        with open(bin_, "r+b") as f:
            f.truncate(os.path.getsize(bin_) // 2)
    elif damage == "bin_missing":
        os.unlink(bin_)
    else:
        m = read_json_checked(meta)
        if damage == "version":
            m["version"] = pexec.EXEC_CACHE_VERSION + 1
        else:
            m["stamp"] = dict(m["stamp"], torch="0.0.0")
        atomic_write_json_checked(meta, m)
    assert ec.load(KEY, "cpu") == (None, "reject")
    assert ec.snapshot()["rejects_total"] == 1
    assert not os.path.exists(meta)  # verified rot: the entry is gone
    assert ec.load(KEY, "cpu") == (None, "miss")


def test_fault_points_load_rejects_and_store_raises(tmp_path):
    ec = ExecutableCache(str(tmp_path))
    _store(ec)
    with pfi.inject("executor.exec_cache_load", require_fired=True):
        assert ec.load(KEY, "cpu") == (None, "reject")
    with pfi.inject("executor.exec_cache_store", require_fired=True):
        with pytest.raises(pfi.InjectedFault):
            _store(ec, KEY + ("other",))
    assert ec.load(KEY + ("other",), "cpu") == (None, "miss")


def test_prune_and_top_hashes_order(tmp_path, monkeypatch):
    monkeypatch.setattr(pexec, "EXEC_CACHE_MAX_ENTRIES", 3)
    ec = ExecutableCache(str(tmp_path))
    hs = [_store(ec, KEY + (i,)) for i in range(3)]
    for _ in range(3):
        ec.load(KEY + (0,), "cpu")   # the hottest
    ec.load(KEY + (2,), "cpu")       # then the most recent
    assert ec.top_hashes(10) == [hs[0], hs[2], hs[1]]
    assert ec.top_hashes(1) == [hs[0]]
    h3 = _store(ec, KEY + (3,))      # past the bound: the coldest goes
    assert sorted(_metas(tmp_path)) == sorted([hs[0], hs[2], h3])
    ec.flush_index()
    # a fresh instance reads the ordering back from index.json
    assert ExecutableCache(str(tmp_path)).top_hashes(10)[0] == hs[0]


def test_key_codec_round_trips_numpy_scalars():
    import numpy as np

    key = ("x", np.int64(7), (np.float32(1.5), {np.int32(2): True}),
           None, (np.bool_(True),))
    back = key_from_json(json.loads(json.dumps(key_to_json(key))))
    assert back == ("x", 7, (1.5, {2: True}), None, (True,))


# -- across packages -------------------------------------------------------------

def test_jax_filled_exec_cache_misses_and_warmup_skips(tmp_path):
    d = tmp_path / "d"
    _seed(d)
    j = _jax(d, exec_cache_enabled=True)
    assert _rows(j.execute(SQL)) == EXPECTED
    assert _rows(j.execute(SQL2)) == EXPECTED2
    j.close()
    jax_entries = _metas(d)
    assert jax_entries
    p = _port(d, warmup_budget_ms=30_000)
    p._warmup_thread.join(30)
    assert not p._warmup_thread.is_alive()
    assert _counter(p, psc.WARMUP_COMPILES_TOTAL) == 0  # all skipped
    assert exec_cache_for(str(d)).snapshot()["rejects_total"] >= \
        len(jax_entries)
    assert _rows(p.execute(SQL)) == EXPECTED
    assert _rows(p.execute(SQL2)) == EXPECTED2
    assert _counter(p, psc.EXEC_CACHE_HITS_TOTAL) == 0
    assert _counter(p, psc.EXEC_CACHE_MISSES_TOTAL) >= 2
    p.close()
    # the port never deletes or rewrites the JAX package's entries
    assert set(jax_entries) <= set(_metas(d))


def test_port_filled_exec_cache_is_skipped_by_jax(tmp_path):
    d = tmp_path / "d"
    _seed(d)
    p = _port(d)
    assert _rows(p.execute(SQL)) == EXPECTED
    assert _rows(p.execute(SQL2)) == EXPECTED2
    p.close()
    port_entries = _metas(d)
    assert port_entries
    j = _jax(d, exec_cache_enabled=True, warmup_budget_ms=30_000)
    if j._warmup_thread is not None:
        j._warmup_thread.join(60)
    assert jexec.exec_cache_for(str(d)).snapshot()["rejects_total"] >= \
        len(port_entries)
    assert _rows(j.execute(SQL)) == EXPECTED
    assert _rows(j.execute(SQL2)) == EXPECTED2
    j.close()
    assert set(port_entries) <= set(_metas(d))


def test_pruning_may_remove_the_other_packages_coldest(tmp_path,
                                                      monkeypatch):
    """The bound counts every entry in the directory: the port's
    pruning removes the coldest by the shared index, the JAX package's
    among them; that package then misses and compiles again, with the
    same rows."""
    d = tmp_path / "d"
    _seed(d)
    j = _jax(d, exec_cache_enabled=True)
    assert _rows(j.execute(SQL)) == EXPECTED
    j.close()
    jax_entries = set(_metas(d))
    monkeypatch.setattr(pexec, "EXEC_CACHE_MAX_ENTRIES", 1)
    p = _port(d)
    assert _rows(p.execute(SQL)) == EXPECTED
    assert _rows(p.execute(SQL2)) == EXPECTED2
    p.close()
    left = set(_metas(d))
    assert len(left) == 1 and not (left & jax_entries)
    j = _jax(d, exec_cache_enabled=True)
    ec = jexec.exec_cache_for(str(d))
    before = ec.snapshot()["compiles_total"]
    assert _rows(j.execute(SQL)) == EXPECTED
    assert ec.snapshot()["compiles_total"] > before
    j.close()


# -- the caps memo -----------------------------------------------------------------

def _memo(d):
    with open(os.path.join(str(d), "caps_memo.json")) as f:
        obj = json.load(f)
    return obj["version"], [key_from_json(k) for k, _v in obj["memo"]]


# a many-to-many join whose pair buffer, sized at a tenth of the usual
# factor, overflows on its first run: one capacity retry, then memoized
JOIN_SQL = "select t1.a, t2.a from t t1, t t2 where t1.b = t2.b"
JOIN_ROWS = sum(len([a for a in range(200) if a % 7 == b]) ** 2
                for b in range(7))
_NARROW = dict(join_output_capacity_factor=0.1, exec_cache_enabled=False)


def test_memo_round_trips_and_a_fresh_session_starts_converged(tmp_path):
    d = tmp_path / "d"
    _seed(d)
    p = _port(d, **_NARROW)
    r = p.execute(JOIN_SQL)
    assert (r.row_count, r.retries) == (JOIN_ROWS, 1)
    assert p.executor.plan_cache.misses == 2
    p.close()  # flushes the debounced memo
    version, keys = _memo(d)
    assert version == 6 and keys and all(k[-1] == "cpu" for k in keys)
    q = _port(d, **_NARROW)
    r = q.execute(JOIN_SQL)
    assert (r.row_count, r.retries) == (JOIN_ROWS, 0)
    assert q.executor.plan_cache.misses == 1
    q.close()


def test_memo_entries_of_the_other_package_never_match(tmp_path):
    """Both packages write caps_memo.json (version 6, one JSON codec);
    the port's fingerprint ends with its torch device and names torch
    dtypes in its feed signature, the JAX package's ends with
    group_by_kernel, so neither ever matches the other's entries: each
    package's first run is cold (one retry), the rows equal, and each
    rewrite keeps the other package's entries."""
    d = tmp_path / "d"
    _seed(d)
    j = _jax(d, **_NARROW)
    jr = j.execute(JOIN_SQL)
    j.close()
    assert (jr.row_count, jr.retries) == (JOIN_ROWS, 1)
    _v, jax_keys = _memo(d)
    p = _port(d, **_NARROW)
    pr = p.execute(JOIN_SQL)
    assert (pr.row_count, pr.retries) == (JOIN_ROWS, 1)
    assert sorted(pr.rows()) == sorted(jr.rows())
    p.close()
    _v, both = _memo(d)
    port_keys = [k for k in both if k not in jax_keys]
    assert set(jax_keys) <= set(both) and port_keys
    assert all(k[-1] == "cpu" for k in port_keys)
    j = _jax(d, **_NARROW)
    assert j.execute(JOIN_SQL).retries == 0  # its own entry, kept
    j.close()
    _v, after = _memo(d)
    assert set(port_keys) <= set(after)


def test_fingerprints_serialize_alike(tmp_path):
    """The same SQL's fingerprint in each package: the same plan-tree
    string, device count and compute dtype, and one JSON codec."""
    from citus_tpu.executor.cache import node_fingerprint as jfp
    from citus_tpu.sql.parser import parse as jparse
    from citus_tpu_torch.executor.cache import node_fingerprint as pfp
    from citus_tpu_torch.sql.parser import parse as pparse

    d = tmp_path / "d"
    _seed(d)
    j = _jax(d, exec_cache_enabled=False)
    p = _port(d, exec_cache_enabled=False)
    jplan, _c = j._plan_select(jparse(SQL)[0])
    pplan, _c = p._plan_select(pparse(SQL)[0])
    assert pfp(pplan.root) == jfp(jplan.root)
    fp = (pfp(pplan.root), pplan.n_devices, "float64")
    assert key_from_json(json.loads(json.dumps(key_to_json(fp)))) == fp
    assert jexec.key_to_json(fp) == key_to_json(fp)
    j.close()
    p.close()


# -- warm-before-admit -------------------------------------------------------------

def _admit_in_thread(mgr, out, timeout_ms=None, cancel=None):
    def run():
        with cancellation.deadline_scope(timeout_ms, cancel):
            try:
                out.append(mgr.admit(AdmissionRequest()))
            except (QueryCanceled, StatementTimeout) as e:
                out.append(e)

    t = threading.Thread(target=run)
    t.start()
    return t


def test_admissions_wait_while_held_and_pass_on_release():
    mgr = WorkloadManager()
    mgr.hold_admissions(time.monotonic() + 60)
    assert mgr.warming() and mgr.snapshot()["warming"]
    out = []
    t = _admit_in_thread(mgr, out)
    t.join(0.2)
    assert t.is_alive() and not out  # held
    mgr.release_admissions()
    t.join(30)
    assert not t.is_alive() and len(out) == 1
    mgr.release(out[0])
    assert not mgr.warming()


def test_admissions_pass_at_the_holds_deadline():
    mgr = WorkloadManager()
    t0 = time.monotonic()
    mgr.hold_admissions(t0 + 0.3)
    out = []
    t = _admit_in_thread(mgr, out)
    t.join(30)
    assert not t.is_alive() and len(out) == 1
    assert time.monotonic() - t0 >= 0.3
    assert not mgr.warming()  # expired, though never released
    mgr.release(out[0])
    mgr.release_admissions()


def test_a_cancel_ends_the_wait_for_a_hold():
    mgr = WorkloadManager()
    mgr.hold_admissions(time.monotonic() + 60)
    cancel = threading.Event()
    out = []
    t = _admit_in_thread(mgr, out, cancel=cancel)
    cancel.set()
    t.join(30)
    assert not t.is_alive() and isinstance(out[0], QueryCanceled)
    assert mgr.snapshot()["requests_total"] == 0  # never entered
    mgr.release_admissions()


def _warm_dir(tmp_path):
    d = tmp_path / "d"
    _seed(d)
    s = _port(d)
    assert _rows(s.execute(SQL)) == EXPECTED
    assert _rows(s.execute(SQL2)) == EXPECTED2
    s.close()
    return d


def test_warmup_arms_the_hottest_entries_before_admission(tmp_path):
    d = _warm_dir(tmp_path)
    s = _port(d, warmup_budget_ms=30_000, warmup_top_shapes=8)
    assert _rows(s.execute(SQL)) == EXPECTED  # admitted after the warmup
    assert not s.wlm.warming()
    assert _counter(s, psc.WARMUP_COMPILES_TOTAL) == len(_metas(d))
    assert s.execute(SQL).retries == 0
    # an armed key resolves without a second disk probe
    assert _counter(s, psc.EXEC_CACHE_MISSES_TOTAL) == 0
    s.close()
    assert s._warmup_thread is None


def test_close_during_warmup_leaves_no_thread(tmp_path, monkeypatch):
    from citus_tpu_torch.executor import runner

    d = _warm_dir(tmp_path)
    entered = threading.Event()

    def slow_warmup(self, deadline, top_n, stop=None):
        entered.set()
        assert stop.wait(30)  # until close() asks it to stop
        return 0

    monkeypatch.setattr(runner.Executor, "warmup_from_cache", slow_warmup)
    s = _port(d, warmup_budget_ms=60_000)
    assert entered.wait(30)
    assert s.wlm.warming()
    t = s._warmup_thread
    s.close()
    assert not t.is_alive()
    assert not any(x.name == "citus-warmup" for x in threading.enumerate())
    assert not s.wlm.warming()


def test_warmup_fault_releases_the_hold(tmp_path):
    d = _warm_dir(tmp_path)
    with pfi.inject("wlm.warmup", require_fired=True):
        s = _port(d, warmup_budget_ms=60_000)
        s._warmup_thread.join(30)
    assert not s.wlm.warming()
    assert _counter(s, psc.WARMUP_COMPILES_TOTAL) == 0
    assert _rows(s.execute(SQL)) == EXPECTED  # resolved lazily
    assert _counter(s, psc.EXEC_CACHE_HITS_TOTAL) == 1
    s.close()


def test_no_warmup_without_entries_or_budget(tmp_path):
    d = tmp_path / "d"
    _seed(d)
    s = _port(d, warmup_budget_ms=10_000)
    assert s._warmup_thread is None and not s.wlm.warming()
    s.close()
    d = _warm_dir(tmp_path / "x")
    s = _port(d)
    assert s._warmup_thread is None
    s.close()
