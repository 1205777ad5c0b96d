"""The compiled form's logic on CPU torch (citus_tpu_torch/executor/
graphs.py and its use in executor/runner.py), and the capture-safety
changes it needed, held to the JAX package.

A CUDA graph exists only on the card (the `cuda`-marked cases of
tests/test_torch_cuda.py capture real ones).  Here a stand-in takes the
captured object's place: it keeps the feeds and static outputs the
capture would, and its replay re-runs the captured dispatch over those
feeds into those outputs — what a replay of a real graph computes.
Everything around it is the port's own code: when a key captures, the
feed-identity check, the gate across sessions, the drop on DML and
eviction, the accountant's `graph` charge and its release, the OOM
ladder, the launch counts of a replay, the reason an uncapturable run
stays eager, and the `$n` parameters refilled before each replay.

The capture-safety changes (constants as device fills, list constants
kept, IN lists without torch.isin, fixed-size counts in place of
bincount) are held to the JAX package at float64: the same rows, and
the same overflow and per-stage counts from the ops they touch.
"""

import gc
import threading

import numpy as np
import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu.ingest import tpch as jtpch
from citus_tpu.ops import join as jjoin
from citus_tpu.ops import partition as jpartition
from citus_tpu_torch.executor import graphs
from citus_tpu_torch.executor import runner as prunner
from citus_tpu_torch.executor.graphs import CapturedPlan
from citus_tpu_torch.executor.hbm import accountant_for
from citus_tpu_torch.ops import hopper_kernels as hk
from citus_tpu_torch.ops import join as pjoin
from citus_tpu_torch.ops import partition as ppartition
from citus_tpu_torch.stats import counters as psc

torch.set_num_threads(1)

POOL = 4096  # the stand-in's pool bytes, charged per graph

GROUPED = ("select l_returnflag, l_linestatus, count(*), sum(l_quantity), "
           "avg(l_discount) from lineitem group by l_returnflag, "
           "l_linestatus order by 1, 2")
QUERIES = {"q1": jtpch.Q1, "q3": jtpch.Q3, "grouped": GROUPED,
           "in_list": "select count(*), sum(o_totalprice) from orders "
                      "where o_custkey in (" + ", ".join(
                          str(k) for k in range(1, 300, 7)) + ")",
           "short_in": "select o_orderpriority, count(*) from orders "
                       "where o_orderstatus in ('O', 'P') group by 1 "
                       "order by 1"}


class _StandInGraph:
    """Replays the captured dispatch over the feeds it was captured
    with, into the captured static outputs."""

    def __init__(self, compiler, plan, feeds, caps, params, packed,
                 counters):
        self.compiler, self.plan, self.feeds = compiler, plan, feeds
        self.caps, self.params = caps, params
        self.packed, self.counters = packed, counters

    def replay(self):
        c = self.compiler
        c.plan, c.caps, c._params = self.plan, self.caps, self.params
        try:
            p, k, _m, _s = c._dispatch(self.plan, self.feeds)
        finally:
            c.plan = c.caps = c._params = None
            c._forget_run()
        self.packed.copy_(p)
        self.counters.copy_(k)


class StandIn:
    """Installs the stand-in capture and turns the graph path on."""

    def __init__(self, monkeypatch, launches=None, fail=None):
        self.calls = []
        self.launches = launches or {}
        self.fail = fail
        monkeypatch.setattr(graphs, "capture", self.capture)
        monkeypatch.setattr(prunner.Executor, "_graphs_on",
                            lambda self: True)

    def capture(self, key, compiler, plan, feeds, caps, feed_keys,
                accountant):
        self.calls.append(key)
        if self.fail is not None:
            raise self.fail
        with compiler._run_lock:
            params = graphs._param_tensors(plan, compiler)
            compiler.plan, compiler.caps = plan, caps
            compiler._params = params
            try:
                packed, counters, meta, stage_keys = compiler._dispatch(
                    plan, feeds)
            finally:
                compiler.plan = compiler.caps = compiler._params = None
                compiler._forget_run()
            held = graphs.held_inputs(compiler, feeds)
        if int(counters[0]) or int(counters[1]):
            return None
        g = _StandInGraph(compiler, plan, dict(feeds), caps, params,
                          packed.clone(), counters.clone())
        return CapturedPlan(key, g, g.packed, g.counters, meta, stage_keys,
                            feed_keys, *held, params, self.launches,
                            POOL, accountant)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_graphs") / "base")
    s = citus_tpu.connect(data_dir=d, n_devices=1, exec_cache_enabled=False,
                          serving_result_cache_bytes=0,
                          compute_dtype="float64",
                          columnar_stripe_row_limit=1000)
    jtpch.load_into_session(s, sf=0.005, seed=11, shard_count=8)
    s.close()
    return d


def _copy(base, tmp_path, name="d"):
    import shutil

    d = str(tmp_path / name)
    shutil.copytree(base, d)
    return d


def _port(d, **kw):
    kw.setdefault("serving_result_cache_bytes", 0)
    kw.setdefault("compute_dtype", "float64")
    return citus_tpu_torch.connect(d, device="cpu", **kw)


def _jax(d):
    return citus_tpu.connect(data_dir=d, n_devices=1,
                             exec_cache_enabled=False,
                             serving_result_cache_bytes=0,
                             compute_dtype="float64",
                             recover_2pc_interval_ms=-1,
                             defer_shard_delete_interval_ms=-1,
                             health_check_interval_ms=-1)


def _same(a, b, rtol=1e-9):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            if isinstance(x, float) or isinstance(y, float):
                assert x == pytest.approx(y, rel=rtol, abs=1e-9), (ra, rb)
            else:
                assert x == y, (ra, rb)


# -- the compiled form with a stand-in ----------------------------------------

def test_replay_equals_eager_and_jax(base, tmp_path, monkeypatch):
    d = _copy(base, tmp_path)
    j = _jax(_copy(base, tmp_path, "j"))
    eager = _port(_copy(base, tmp_path, "e"))
    stand = StandIn(monkeypatch)
    s = _port(d)
    for name, sql in QUERIES.items():
        want = j.execute(sql).rows()
        _same(eager.execute(sql).rows(), want)
        seen = []
        for _ in range(3):
            _same(s.execute(sql).rows(), want)
            seen.append(s.executor.last_dispatch()[0])
        # settled by the first run, captured by the second
        assert seen == ["eager", "captured", "replayed"], (name, seen)
    assert len(stand.calls) == len(QUERIES)
    acc = accountant_for(d)
    assert acc.live_bytes("graph") == POOL * len(QUERIES)
    assert acc.transient_bytes() == 0
    j.close()
    eager.close()
    s.close()


def test_insert_between_replays_gives_the_new_answer(base, tmp_path,
                                                     monkeypatch):
    d = _copy(base, tmp_path)
    StandIn(monkeypatch)
    s = _port(d)
    sql = ("select o_orderpriority, count(*), sum(o_totalprice) from "
           "orders group by 1 order by 1")
    for _ in range(3):
        before = s.execute(sql).rows()
    g = s.executor.plan_cache._graphs and next(
        iter(s.executor.plan_cache._graphs.values()))
    assert s.executor.last_dispatch()[0] == "replayed" and g.live
    s.execute("insert into orders values (9000001, 1, 'O', 1000.5, "
              "date '1998-01-01', '1-URGENT', 'Clerk#1', 0, 'x')")
    after = s.execute(sql).rows()
    # the next feed build met the new data version: the old feeds left
    # the cache, and the graph reading them with them
    assert not g.live
    fresh = _port(_copy(d, tmp_path, "after")).execute(sql).rows()
    _same(after, fresh)
    assert after[0][1] == before[0][1] + 1
    # the new feed keys run eager once, as a new key does, then capture
    assert s.executor.last_dispatch()[0] == "eager"
    _same(s.execute(sql).rows(), after)
    assert s.executor.last_dispatch()[0] == "captured"  # over new feeds
    s.close()


def test_new_feed_keys_run_eager_once_before_they_capture(base, tmp_path,
                                                         monkeypatch):
    """A bare `col < $1` keys the feeds by its value: a new value runs
    eager once and captures at its next run, and an old value that comes
    back does the same — no capture without a clean eager run over the
    same feed keys."""
    d = _copy(base, tmp_path)
    stand = StandIn(monkeypatch)
    s = _port(d)
    eager = _port(_copy(base, tmp_path, "e"))
    eager.executor._graph_for = lambda *a, **k: None  # always eager
    prep = ("prepare p as select l_returnflag, count(*), "
            "sum(l_extendedprice) from lineitem where l_shipdate < $1 "
            "group by l_returnflag order by 1")
    s.execute(prep)
    eager.execute(prep)
    seen = []
    for day in ["1993-01-01"] * 2 + ["1996-06-01"] * 3 + ["1993-01-01"]:
        sql = f"execute p (date '{day}')"
        _same(s.execute(sql).rows(), eager.execute(sql).rows())
        seen.append(s.executor.last_dispatch()[0])
    assert seen == ["eager", "captured", "eager", "captured", "replayed",
                    "eager"], seen
    assert len(stand.calls) == 2
    s.close()
    eager.close()


def test_an_adopted_graph_keeps_the_capturers_list_constants(
        base, tmp_path, monkeypatch):
    """The list constants a graph reads were uploaded by the capturing
    session's compiler: the graph holds them, so another session that
    adopted it still reads them after the capturer closed."""
    import weakref

    d = _copy(base, tmp_path)
    stand = StandIn(monkeypatch)
    a, b = _port(d), _port(d)
    sql = QUERIES["in_list"]
    for _ in range(2):
        a.execute(sql)
    assert a.executor.last_dispatch()[0] == "captured"
    compiler = next(c for c in a.executor.plan_cache._entries.values()
                    if c._consts)
    consts = [weakref.ref(t) for t in compiler._consts.values()]
    b.execute(sql)
    b.execute(sql)
    assert b.executor.last_dispatch()[0] == "replayed"  # adopted
    assert len(stand.calls) == 1
    g = next(iter(b.executor.plan_cache._graphs.values()))
    assert {id(t) for t in g._consts.values()} == \
        {id(r()) for r in consts}
    del compiler
    a.close()
    gc.collect()
    assert all(r() is not None for r in consts)
    want = _jax(_copy(base, tmp_path, "j")).execute(sql).rows()
    _same(b.execute(sql).rows(), want)
    g.release()
    assert g._consts == {}
    b.close()


@pytest.mark.parametrize("how", ["invalidate_table", "evict_coldest",
                                 "clear", "lru"])
def test_dropping_a_feed_releases_the_graphs_reading_it(base, tmp_path,
                                                        monkeypatch, how):
    d = _copy(base, tmp_path)
    StandIn(monkeypatch)
    s = _port(d)
    acc = accountant_for(d)
    sql = QUERIES["q3"]
    for _ in range(2):
        s.execute(sql)
    g = next(iter(s.executor.plan_cache._graphs.values()))
    assert g.live and acc.live_bytes("graph") == POOL
    fc = s.executor.feed_cache
    if how == "invalidate_table":
        fc.invalidate_table("customer")
    elif how == "evict_coldest":
        fc.evict_coldest(1)
    elif how == "clear":
        fc.clear()
    else:
        fc.max_bytes = 1  # the next put pushes every older entry out
        s.execute("select count(*) from part")
    assert not g.live and acc.live_bytes("graph") == 0
    assert s.executor.plan_cache.graph(
        next(iter(s.executor.plan_cache._graphs))) is None
    s.execute(sql)
    assert s.executor.last_dispatch()[0] in ("captured", "eager")
    s.close()


def test_oom_ladder_releases_graphs_before_feeds(base, tmp_path,
                                                 monkeypatch):
    d = _copy(base, tmp_path)
    StandIn(monkeypatch)
    s = _port(d)
    acc = accountant_for(d)
    for sql in (QUERIES["q1"], QUERIES["q3"]):
        for _ in range(2):
            s.execute(sql)
    assert acc.graph_count() == 2 and acc.live_bytes("graph") == 2 * POOL
    order = []
    real_release = acc.release_graphs
    real_evict = acc.evict_evictable
    monkeypatch.setattr(acc, "release_graphs", lambda *a: (
        order.append("graphs"), real_release(*a))[1])
    monkeypatch.setattr(acc, "evict_evictable", lambda *a: (
        order.append("feeds"), real_evict(*a))[1])
    assert s.executor.degrade_for_oom(1) == "evict_caches"
    assert order[:2] == ["graphs", "feeds"]
    assert acc.graph_count() == 0 and acc.live_bytes("graph") == 0
    _same(s.execute(QUERIES["q1"]).rows(),
          _jax(_copy(base, tmp_path, "j")).execute(QUERIES["q1"]).rows())
    s.close()


def test_eight_sessions_capture_one_cold_key_once(base, tmp_path,
                                                  monkeypatch):
    d = _copy(base, tmp_path)
    stand = StandIn(monkeypatch)
    sessions = [_port(d) for _ in range(8)]
    sql = QUERIES["grouped"]
    want = _jax(_copy(base, tmp_path, "j")).execute(sql).rows()
    start = threading.Barrier(8)
    got, errors = [], []

    def run(s):
        try:
            for _ in range(3):
                start.wait(60)
                got.append(s.execute(sql).rows())
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)
            start.abort()

    threads = [threading.Thread(target=run, args=(s,)) for s in sessions]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert not errors
    assert len(got) == 24
    for rows in got:
        _same(rows, want)
    assert len(stand.calls) == 1
    deduped = sum(s.stats.counters.snapshot()[psc.COMPILES_DEDUPED_TOTAL]
                  for s in sessions)
    assert deduped == 7
    for s in sessions:
        s.close()


def test_uncapturable_run_is_eager_with_its_reason(base, tmp_path,
                                                   monkeypatch):
    d = _copy(base, tmp_path)
    stand = StandIn(monkeypatch)
    s = _port(d, max_cached_feed_bytes=0, trace_fast_statement_ms=0)
    sql = QUERIES["q1"]
    for _ in range(3):
        s.execute(sql)
        doc = s.stats.tracing.last_trace()
        compiles = [c for c in _spans(doc["root"]) if c["name"] == "compile"]
        assert s.executor.last_dispatch() == ("eager", None) or \
            s.executor.last_dispatch() == ("uncapturable",
                                           graphs.NOT_RESIDENT)
    assert stand.calls == []  # never attempted, never retried in a loop
    assert any(c.get("meta", {}).get("cache") == "uncapturable"
               and c["meta"].get("reason") == graphs.NOT_RESIDENT
               for c in compiles)
    lines = [r[0] for r in s.execute("explain analyze " + sql).rows()]
    caches = next(x for x in lines if x.startswith("Caches:"))
    assert caches.endswith(f"graph=uncapturable ({graphs.NOT_RESIDENT})")
    assert "exec-cache hits=" in caches and "deduped=" in caches
    s.close()


def _spans(span):
    yield span
    for c in span.get("children", ()):
        yield from _spans(c)


def test_capture_failure_raises(base, tmp_path, monkeypatch):
    d = _copy(base, tmp_path)
    StandIn(monkeypatch, fail=RuntimeError(
        "CUDA error: operation not permitted when stream is capturing"))
    s = _port(d, max_statement_retries=0)
    s.execute(QUERIES["q1"])  # eager: settles the key
    with pytest.raises(Exception, match="stream is capturing"):
        s.execute(QUERIES["q1"])
    s.close()


def test_prepared_parameters_refill_before_each_replay(base, tmp_path,
                                                       monkeypatch):
    d = _copy(base, tmp_path)
    StandIn(monkeypatch)
    s = _port(d)
    eager = _port(_copy(base, tmp_path, "e"))
    # `$1 + 0` is no chunk-skip test, so every value reads the same
    # cached feeds (a bare `col <= $1` keys the feeds by its value)
    prep = ("prepare p as select l_returnflag, count(*), "
            "sum(l_extendedprice) from lineitem where l_quantity < $1 + 0 "
            "group by l_returnflag order by 1")
    s.execute(prep)
    eager.execute(prep)
    seen = []
    for q in [10, 25, 40, 5] * 3:
        sql = f"execute p ({q})"
        _same(s.execute(sql).rows(), eager.execute(sql).rows())
        seen.append(s.executor.last_dispatch()[0])
    # once the key has converged (a larger value overflows sizes a
    # smaller one tightened: the replay's overflow drops the graph and
    # regrows), every value replays one graph
    assert "captured" in seen and seen[-4:] == ["replayed"] * 4, seen
    s.close()
    eager.close()


def test_two_replays_with_other_parameters_hand_back_each_answer(
        base, tmp_path, monkeypatch):
    """One captured grouped plan, replayed twice in a row with different
    `$n`: each replay's compacted rows come back through the session's
    staging, and the first answer survives the second replay."""
    d = _copy(base, tmp_path)
    StandIn(monkeypatch)
    s = _port(d)
    eager = _port(_copy(base, tmp_path, "e"))
    prep = ("prepare g as select l_orderkey, count(*), sum(l_quantity) "
            "from lineitem where l_quantity < $1 + 0 group by l_orderkey "
            "order by 1")
    s.execute(prep)
    eager.execute(prep)
    for q in (50, 50, 50):  # settle, capture, replay at the larger size
        s.execute(f"execute g ({q})")
    got = []
    for q in (12, 45, 12):
        got.append(s.execute(f"execute g ({q})"))
        assert s.executor.last_dispatch()[0] == "replayed", q
    low, high, low_again = got
    low_rows = low.rows()
    assert low.row_count < high.row_count
    _same(low_rows, eager.execute("execute g (12)").rows())
    _same(high.rows(), eager.execute("execute g (45)").rows())
    _same(low_again.rows(), low_rows)
    s.close()
    eager.close()


def test_replays_add_the_captured_launches(base, tmp_path, monkeypatch):
    d = _copy(base, tmp_path)
    StandIn(monkeypatch, launches={"dense_grid_sum": 1})
    s = _port(d)
    for _ in range(2):
        s.execute(QUERIES["q1"])
    hk.reset_launch_counts()
    for _ in range(3):
        s.execute(QUERIES["q1"])
    assert hk.LAUNCHES["dense_grid_sum"] == 3
    s.close()


def test_launches_under_capture_are_recorded_not_counted():
    hk.reset_launch_counts()
    with hk.recording_launches() as rec:
        hk.count_launch("bucketed_probe")
        hk.count_launch("bucketed_probe")
    hk.count_launch("bit_unpack")
    assert rec == {"bucketed_probe": 2}
    assert hk.LAUNCHES["bucketed_probe"] == 0
    assert hk.LAUNCHES["bit_unpack"] == 1
    hk.count_replay(rec)
    assert hk.LAUNCHES["bucketed_probe"] == 2


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    packed = torch.tensor([[0b10110000]], dtype=torch.uint8)
    assert hk.bit_unpack(packed, 4).tolist() == [[True, False, True, True]]
    with pytest.raises(ValueError):
        hk.bit_unpack(packed.to("meta"), 4)
    with pytest.raises(ValueError):
        hk.dict_decode(torch.zeros(3, dtype=torch.uint8),
                       torch.zeros(2, device="meta"))


def test_released_graph_is_absent_and_its_charge_returns(tmp_path):
    acc = accountant_for(str(tmp_path))
    t = torch.zeros(4)

    class G:
        def replay(self):
            pass

    g = CapturedPlan(("k",), G(), t, t, [], [], ("f",), [t], {}, {}, {},
                     1000, acc)
    assert acc.live_bytes("graph") == 1000 and acc.transient_bytes() == 0
    assert acc.find_graph(("k",), ("f",)) is g
    assert acc.find_graph(("k",), ("other",)) is None
    assert g.reads_any({id(t)}) and not g.reads_any({id(g)})
    g.release()
    g.release()
    assert acc.live_bytes("graph") == 0 and not g.valid_for(("f",))
    g2 = CapturedPlan(("k",), G(), t, t, [], [], ("f",), [t], {}, {}, {},
                      500, acc)
    assert acc.live_bytes("graph") == 500
    del g2
    gc.collect()
    assert acc.live_bytes("graph") == 0  # a dropped graph gives it back


# -- capture safety, held to the JAX package at float64 ------------------------

@pytest.mark.parametrize("n_targets,capacity", [(4, 64), (40, 16),
                                                (40, 4)])
def test_fixed_size_pack_counts_match_jax(n_targets, capacity):
    rng = np.random.default_rng(n_targets * 100 + capacity)
    n = 500
    target = rng.integers(0, n_targets, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    col = rng.integers(0, 1 << 40, n)
    pc, pv, po = ppartition.pack_by_target(
        {"c": torch.from_numpy(col)}, torch.from_numpy(valid),
        torch.from_numpy(target), n_targets, capacity)
    jc, jv, jo = jpartition.pack_by_target(
        {"c": col}, valid, target, n_targets, capacity)
    assert int(po) == int(jo)
    assert np.array_equal(pv.numpy(), np.asarray(jv))
    assert np.array_equal(pc["c"].numpy()[pv.numpy()],
                          np.asarray(jc["c"])[np.asarray(jv)])


def test_fixed_size_directory_counts_match_jax():
    rng = np.random.default_rng(7)
    build = rng.integers(90, 160, 300)
    matchable = rng.random(300) < 0.9
    probe = rng.integers(80, 170, 400)
    po, plo, phi, poob = pjoin._dense_bounds(
        torch.from_numpy(build), torch.from_numpy(matchable),
        torch.from_numpy(probe), 100, 50)
    jo, jlo, jhi, joob = jjoin._dense_bounds(build, matchable, probe,
                                             100, 50)
    assert int(poob) == int(joob)
    assert np.array_equal(plo.numpy(), np.asarray(jlo))
    assert np.array_equal(phi.numpy(), np.asarray(jhi))
    n = int(np.asarray(jhi).max())
    assert np.array_equal(po.numpy()[:n], np.asarray(jo)[:n])


@pytest.mark.parametrize("dtype", ["int64", "int32", "float32", "float64",
                                   "bool"])
@pytest.mark.parametrize("k", [0, 1, 3, 30])
def test_in_list_membership_matches_numpy(dtype, k):
    """IN-list membership by a search of the sorted list (no
    torch.isin, which waits on the device for long lists), against
    numpy's isin, NaN and -0.0 included."""
    from citus_tpu_torch.executor.exprs import ColumnSource, _in_list

    rng = np.random.default_rng(k)
    if dtype == "bool":
        v = rng.random(200) < 0.5
        values = list(rng.random(k) < 0.5) or [True]
    else:
        v = rng.integers(0, 50, 200).astype(dtype)
        values = [x for x in range(0, 60, 2)][:k]
        if dtype.startswith("float"):
            v[::7] = np.nan
            v[::11] = -0.0
            values = [float(x) for x in values] + [float("nan")]
    got = _in_list(torch.from_numpy(v), values,
                   ColumnSource({}, device=torch.device("cpu")))
    assert np.array_equal(got.numpy(),
                          np.isin(v, np.asarray(values, dtype=dtype)))


@pytest.mark.parametrize("values", [[False, True, False],
                                    [True, False, True], [False, False],
                                    [True, True], [True, False, False]])
def test_in_list_of_bools_with_repeats_matches_numpy(values):
    from citus_tpu_torch.executor.exprs import ColumnSource, _in_list

    v = np.array([True, False, True, True, False])
    got = _in_list(torch.from_numpy(v), values,
                   ColumnSource({}, device=torch.device("cpu")))
    assert np.array_equal(got.numpy(), np.isin(v, np.asarray(values)))


def test_bool_in_lists_match_jax(tmp_path):
    """Unsorted boolean IN lists with repeats, against the JAX
    package on the same data_dir."""
    d = str(tmp_path / "b")
    j = _jax(d)
    j.execute("create table bt (k bigint, b boolean, v double precision)")
    j.execute("select create_distributed_table('bt', 'k', 4)")
    j.execute("insert into bt values " + ", ".join(
        f"({i}, {'null' if i % 7 == 0 else ('true' if i % 3 else 'false')},"
        f" {i * 0.25})" for i in range(60)))
    sqls = [f"select count(*), sum(v) from bt where b in ({lst})"
            for lst in ("false, true, false", "true, false, true",
                        "false, false", "true", "true, true, false")]
    want = [j.execute(sql).rows() for sql in sqls]
    j.close()
    p = _port(d)
    for sql, w in zip(sqls, want):
        _same(p.execute(sql).rows(), w)
    assert want[0] == want[1] and want[2] != want[3]
    p.close()


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_capture_safe_evaluation_matches_jax(base, tmp_path, name):
    """The eager path with the capture-safe constants, IN lists and
    counts: the JAX package's rows, and on the bucketed probe path the
    same capacity retries."""
    sql = QUERIES[name]
    j = _jax(_copy(base, tmp_path, "j"))
    p = _port(_copy(base, tmp_path, "p"))
    jr, pr = j.execute(sql), p.execute(sql)
    _same(pr.rows(), jr.rows())
    assert pr.retries == jr.retries
    j.close()
    p.close()


def test_bucketed_probe_path_matches_jax(base, tmp_path, monkeypatch):
    """Q3 on the bucketed probe, whose probe pack counts rows per bucket
    with the fixed-size count: the JAX package's rows and retries."""
    from citus_tpu.ops import join as jj
    from citus_tpu_torch.planner import plan as pplan

    monkeypatch.setattr(pplan, "bucketed_paths_enabled",
                        lambda *a, **k: True)
    monkeypatch.setattr(pjoin, "PROBE_BUCKET_MIN_EXTENT", 1 << 10)
    monkeypatch.setattr(jj, "PROBE_BUCKET_MIN_EXTENT", 1 << 10)
    sql = QUERIES["q3"]
    p = _port(_copy(base, tmp_path, "p"))
    pr = p.execute(sql)
    want = _jax(_copy(base, tmp_path, "j")).execute(sql).rows()
    _same(pr.rows(), want)
    p.close()
