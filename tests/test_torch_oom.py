"""Allocator-OOM torture for the port: device-memory exhaustion at every
allocation, against the JAX package's ladder.

The tier-1 cases of tests/test_oom_torture.py, on CPU torch.  A MemSim
armed on the data_dir's accountant (citus_tpu_torch/executor/hbm.py)
refuses allocations deterministically — at allocation N, or whenever a
byte budget would be exceeded — and the workload replays under every
armed point holding THE invariant:

    every statement lands on the correct answer (through the ladder:
    cache eviction → stream-batch shrink → forced streaming →
    multi-pass execution) XOR raises a clean ResourceExhausted — no
    other error, no wrong rows, and no ledger leak (the transient
    bytes are back at 0 after every statement).

The correct answer is the JAX package's un-simulated rows on its own
copy of the same data (the port's un-simulated rows equal them).  Where
the JAX test passes, the directed cases also compare the ladder's state
(`Executor.oom`), the rungs and the spill passes with the JAX package's.
Four of the JAX tests fail in the reference (the regrow guard, the
plan-buffer guard, the ledger after eviction, and citus_stat_memory
with EXPLAIN ANALYZE's Memory line): their counterparts here hold the
port to the oracle and to the design instead, as each docstring says.
"""

import gc

import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu.executor.hbm import oom_budget as j_oom_budget
from citus_tpu.executor.runner import OomState as JOomState
from citus_tpu.utils import faultinjection as jfi
from citus_tpu_torch.errors import (
    CitusTpuError,
    DeviceMemoryExhausted,
    PlanningError,
    ResourceExhausted,
)
from citus_tpu_torch.executor.hbm import oom_budget
from citus_tpu_torch.executor.runner import OomState
from citus_tpu_torch.session import Session
from citus_tpu_torch.utils import faultinjection as pfi

torch.set_num_threads(1)

WORKLOAD = [
    "SELECT grp, count(*), sum(v) FROM a GROUP BY grp ORDER BY grp",
    "SELECT count(*), sum(a.v + b.w) FROM a, b WHERE a.id = b.id",
    "SELECT count(*) FROM a, b WHERE a.v = b.id",
    "SELECT id, v FROM a ORDER BY id LIMIT 7",
]
N_ROWS = 1200
# its expansion join overflows a 0.1 join_output_capacity_factor
REGROW_SQL = ("SELECT count(*) FROM a x, a y "
              "WHERE x.grp = y.grp AND x.id < y.id")
SETUP = [
    "CREATE TABLE a (id INT, grp INT, v INT)",
    "CREATE TABLE b (id INT, w INT)",
    "SELECT create_distributed_table('a', 'id', 4)",
    "SELECT create_distributed_table('b', 'id', 4)",
    "INSERT INTO a VALUES " + ", ".join(
        f"({i}, {i % 10}, {i})" for i in range(N_ROWS)),
    "INSERT INTO b VALUES " + ", ".join(
        f"({i}, {i * 3})" for i in range(N_ROWS)),
]
_FAST_RETRY = dict(retry_backoff_base_ms=1, retry_backoff_max_ms=5)


@pytest.fixture(scope="module")
def jsess(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_oom") / "jax")
    s = citus_tpu.connect(data_dir=d, n_devices=1, exec_cache_enabled=False,
                          serving_result_cache_bytes=0, **_FAST_RETRY)
    for sql in SETUP:
        s.execute(sql)
    yield s
    s.close()


@pytest.fixture(scope="module")
def sess(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_oom") / "port")
    s = citus_tpu_torch.connect(d, device="cpu", serving_result_cache_bytes=0,
                                **_FAST_RETRY)
    for sql in SETUP:
        s.execute(sql)
    yield s
    s.close()


@pytest.fixture(scope="module")
def oracle(jsess, sess):
    want = [jsess.execute(sql).rows() for sql in WORKLOAD]
    assert [sess.execute(sql).rows() for sql in WORKLOAD] == want
    return want


def _reset(s):
    """Each armed point starts from a fresh ladder (sticky state from a
    previous point would hide whether THIS point degrades)."""
    s.executor.oom = (OomState() if isinstance(s, Session)
                      else JOomState())
    s.executor.feed_cache.clear()


def _oom_state(s) -> tuple:
    o = s.executor.oom
    return (o.batch_shrink, o.force_stream, o.multipass_k)


def _assert_no_leak(s):
    acc = s.executor.accountant
    if acc.transient_bytes():
        gc.collect()
    assert acc.transient_bytes() == 0, (
        f"accountant leak: {acc.transient_bytes()} transient bytes live "
        f"after the statement ({acc.snapshot()})")


def _run_workload(s, oracle, expect_answer: bool = False) -> dict:
    """One replay under whatever MemSim the caller armed: correct answer
    XOR clean ResourceExhausted per statement, no leak after each.  The
    leak check runs after the try/except has exited: inside a handler
    the raising frames (and the failed attempt's feeds) are pinned."""
    stats = {"answered": 0, "clean_errors": 0}
    for sql, want in zip(WORKLOAD, oracle):
        got = None
        try:
            got = s.execute(sql).rows()
        except ResourceExhausted:
            assert not expect_answer, f"expected the ladder to answer {sql!r}"
            stats["clean_errors"] += 1
        except Exception as e:
            assert isinstance(e, CitusTpuError), (
                f"UNCLEAN failure {type(e).__name__}: {e!r} running {sql!r}")
            raise AssertionError(
                f"non-OOM error under memory torture running {sql!r}: "
                f"{type(e).__name__}: {e}")
        if got is not None:
            assert got == want, f"WRONG ROWS under OOM for {sql!r}"
            stats["answered"] += 1
        _assert_no_leak(s)
    return stats


def _rehearse(s, oracle) -> tuple[int, int]:
    """An un-failing MemSim pass: (allocations, peak live bytes)."""
    _reset(s)
    acc = s.executor.accountant
    acc.reset_peaks()
    with oom_budget(acc) as sim:
        _run_workload(s, oracle, expect_answer=True)
        peak = max((n for _i, _c, n in sim.journal), default=0)
    return sim.allocs, max(acc.peak_bytes, peak)


def test_allocation_sweep_tier1(sess, oracle):
    """A strided slice of the every-allocation sweep: one deterministic
    OOM at allocation n, which the ladder absorbs — every statement
    still answers."""
    total, _peak = _rehearse(sess, oracle)
    assert total > 0, "the workload placed nothing through the seam"
    acc = sess.executor.accountant
    for n in range(1, total + 1, max(1, total // 8)):
        _reset(sess)
        with oom_budget(acc, fail_at=n) as sim:
            stats = _run_workload(sess, oracle, expect_answer=True)
        assert sim.oom_raised == 1
        assert stats["answered"] == len(WORKLOAD)


def test_budget_sweep(sess, oracle):
    """Budgets from hopeless to roomy: answer XOR clean error; at least
    one constrained budget completes BY degrading, and a roomy budget
    completes without any OOM."""
    _total, peak = _rehearse(sess, oracle)
    acc = sess.executor.accountant
    degraded_success = False
    for budget in [peak // 8, peak // 4, peak // 2, (peak * 3) // 4,
                   (peak * 7) // 8, peak, peak * 2]:
        _reset(sess)
        with oom_budget(acc, budget=max(1, budget)) as sim:
            stats = _run_workload(sess, oracle)
        if stats["answered"] == len(WORKLOAD) and sim.oom_raised:
            degraded_success = True
    assert degraded_success, "no budget completed through the ladder"
    _reset(sess)
    with oom_budget(acc, budget=peak * 2) as sim:
        _run_workload(sess, oracle, expect_answer=True)
    assert sim.oom_raised == 0


@pytest.mark.parametrize("force_stream", [False, True])
def test_multipass_matches_oracle(sess, jsess, oracle, force_stream):
    """Forced multi-pass execution (the ladder's last functional rung),
    alone and composed with forced streaming: every answer equals the
    oracle, with the JAX package's spill passes and batches."""
    try:
        for s, state in ((sess, OomState), (jsess, JOomState)):
            _reset(s)
            s.executor.oom = state(batch_shrink=2 if force_stream else 1,
                                   force_stream=force_stream, multipass_k=4)
        for sql, want in zip(WORKLOAD, oracle):
            got = sess.execute(sql)
            ref = jsess.execute(sql)
            assert got.rows() == want, sql
            assert (got.spill_passes, got.streamed_batches) == \
                (ref.spill_passes, ref.streamed_batches), sql
            _assert_no_leak(sess)
    finally:
        _reset(sess)
        _reset(jsess)


def test_multipass_counts_spill_passes(sess, jsess, oracle):
    """A forced multi-pass join stamps its passes on the result, as the
    JAX package does."""
    try:
        for s, state in ((sess, OomState), (jsess, JOomState)):
            _reset(s)
            s.executor.oom = state(multipass_k=4)
        r = sess.execute(WORKLOAD[1])
        assert r.spill_passes >= 2
        assert r.spill_passes == jsess.execute(WORKLOAD[1]).spill_passes
        assert r.rows() == oracle[1]
    finally:
        _reset(sess)
        _reset(jsess)


def test_oom_fault_injection_directed(sess, jsess, oracle):
    """executor.hbm_exhausted armed with error='oom' raises the
    classified DeviceMemoryExhausted at the placement seam; the ladder
    absorbs it, the statement answers, and the ladder's state is the
    JAX package's."""
    try:
        for s, fi in ((sess, pfi), (jsess, jfi)):
            _reset(s)
            with fi.inject("executor.hbm_exhausted", error="oom",
                           require_fired=True):
                assert s.execute(WORKLOAD[1]).rows() == oracle[1]
        assert _oom_state(sess) == _oom_state(jsess)
        assert sess.last_oom_rungs == ["shrink_stream_batch"]
        _assert_no_leak(sess)
    finally:
        _reset(sess)
        _reset(jsess)


def test_first_allocation_oom_walks_the_same_rungs(sess, jsess, oracle):
    """A budget below any feed: the statement walks the whole ladder to
    a clean ResourceExhausted in both packages, leaving the same sticky
    state (the batch quartered, forced streaming, 16 passes)."""
    try:
        for s, arm in ((sess, oom_budget), (jsess, j_oom_budget)):
            _reset(s)
            with arm(s.executor.accountant, budget=64):
                with pytest.raises(Exception) as err:
                    s.execute(WORKLOAD[1])
            assert "does not fit device memory" in str(err.value)
        assert isinstance(err.value, citus_tpu.CitusTpuError)
        assert _oom_state(sess) == _oom_state(jsess) == (4, True, 16)
        assert sess.last_oom_rungs == [
            "shrink_stream_batch", "shrink_stream_batch", "force_stream",
            "multipass", "multipass", "multipass", "multipass"]
        _assert_no_leak(sess)
    finally:
        _reset(sess)
        _reset(jsess)


def test_oom_degradation_off_is_a_clean_error(sess, jsess, oracle):
    """oom_degradation=off: the first OOM surfaces as a clean
    ResourceExhausted at once — no rung, in both packages."""
    for s, fi in ((sess, pfi), (jsess, jfi)):
        _reset(s)
        with s.settings.override(oom_degradation=False):
            with fi.inject("executor.hbm_exhausted", error="oom"):
                with pytest.raises(Exception) as err:
                    s.execute(WORKLOAD[1])
        assert type(err.value).__name__ == "DeviceMemoryExhausted"
        assert _oom_state(s) == (1, False, 1)
    assert isinstance(err.value, citus_tpu.errors.ResourceExhausted)
    _assert_no_leak(sess)
    assert sess.execute(WORKLOAD[1]).rows() == oracle[1]


def test_capacity_regrow_bounded_by_budget(sess, oracle):
    """An overflow regrow that can no longer fit the device budget
    degrades instead of retrying into an OOM.  Tiny capacity factors
    force the overflows.  (The JAX test fails in the reference; this one
    holds the port to the oracle and to the design.)  Under a MemSim
    budget of the rehearsed peak the statement answers or ends in a
    clean ResourceExhausted.  Under an `hbm_budget_bytes` the regrown
    buffers cannot fit, with no MemSim armed, only the regrow guard can
    raise DeviceMemoryExhausted: the ladder must take a rung, and the
    statement again answers or ends cleanly."""
    _total, peak = _rehearse(sess, oracle)
    acc = sess.executor.accountant
    tight = dict(join_output_capacity_factor=0.1,
                 enable_capacity_feedback=False)
    for arm in ("memsim", "hbm_budget_bytes"):
        _reset(sess)
        sess.executor.plan_cache.clear()
        with sess.settings.override(**tight):
            try:
                if arm == "memsim":
                    with oom_budget(acc, budget=peak):
                        got = sess.execute(WORKLOAD[2]).rows()
                    assert got == oracle[2]
                else:
                    # an expanding self-join: its pair buffer overflows
                    with sess.settings.override(hbm_budget_bytes=4096):
                        got = sess.execute(REGROW_SQL).rows()
                    assert got == [(10 * 120 * 119 // 2,)]
            except ResourceExhausted:
                pass
        if arm == "hbm_budget_bytes":
            assert sess.last_oom_rungs, \
                "the regrow guard never routed into the ladder"
        _assert_no_leak(sess)
    _reset(sess)


def test_plan_buffer_limit_routes_to_ladder(sess, oracle):
    """An over-limit plan whose shape the ladder can help (a streamable
    join) degrades instead of raising PlanningError.  (The JAX test fails
    in the reference; held to the design here: the guard raises
    DeviceMemoryExhausted, a rung is taken, and the statement answers
    correctly or ends in a clean ResourceExhausted.)"""
    _reset(sess)
    sess.executor.plan_cache.clear()
    with sess.settings.override(max_plan_buffer_bytes=1 << 15):
        try:
            got = sess.execute(WORKLOAD[1]).rows()
            assert got == oracle[1]
        except ResourceExhausted:
            pass
        except PlanningError as e:
            raise AssertionError(
                f"eligible over-limit plan rejected, not degraded: {e}")
    assert sess.last_oom_rungs, "the guard never routed into the ladder"
    _assert_no_leak(sess)
    _reset(sess)


def test_plan_buffer_limit_clean_reject_for_cartesian(sess, jsess, oracle):
    """Ineligible shapes (a cartesian product) keep the clean immediate
    PlanningError in both packages — no rung can shrink a keyless
    product."""
    for s in (sess, jsess):
        _reset(s)
        with s.settings.override(max_plan_buffer_bytes=1 << 16):
            with pytest.raises(Exception) as err:
                s.execute("SELECT a.id, b.id FROM a, b LIMIT 5")
        assert type(err.value).__name__ == "PlanningError"
        assert _oom_state(s) == (1, False, 1)
    assert sess.last_oom_rungs == []


def test_ledger_tracks_cache_and_releases_on_evict(sess, oracle):
    """Cached feeds appear under `cache`; the ladder's eviction
    (`evict_evictable`, across every registered cache) returns the
    bytes.  (The JAX test fails in the reference; held to the design.)"""
    acc = sess.executor.accountant
    _reset(sess)
    gc.collect()
    sess.execute(WORKLOAD[1])
    assert acc.live_bytes("cache") > 0
    assert acc.evict_evictable() > 0
    assert len(sess.executor.feed_cache) == 0
    gc.collect()
    assert acc.live_bytes("cache") == 0
    _assert_no_leak(sess)


def test_real_allocator_oom_is_classified(sess, oracle, monkeypatch):
    """A torch.OutOfMemoryError raised inside a plan's run (what the CUDA
    caching allocator raises on the card) is classified as
    DeviceMemoryExhausted under the plan lease and the ladder answers."""
    from citus_tpu_torch.executor import compiler

    real = compiler.PlanCompiler.run
    calls = {"n": 0}

    def failing_once(self, plan, feeds, caps, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (simulated)")
        return real(self, plan, feeds, caps, **kw)

    monkeypatch.setattr(compiler.PlanCompiler, "run", failing_once)
    _reset(sess)
    acc = sess.executor.accountant
    ooms = acc.oom_total
    assert sess.execute(WORKLOAD[0]).rows() == oracle[0]
    assert acc.oom_total == ooms + 1
    assert sess.last_oom_rungs and calls["n"] >= 2
    _assert_no_leak(sess)
    # with the ladder off it surfaces as the classified error
    calls["n"] = 0
    with sess.settings.override(oom_degradation=False):
        with pytest.raises(DeviceMemoryExhausted):
            sess.execute(WORKLOAD[0])
    _assert_no_leak(sess)
    _reset(sess)


@pytest.mark.parametrize("force_stream", [False, True])
def test_multipass_order_by_aggregate_limit(sess, force_stream):
    """ORDER BY an aggregate with LIMIT under forced multi-pass (alone
    and with forced streaming): each pass runs without the device top-k
    that would cut its partial sums, so the answer is the resident one
    and numpy's.  The JAX package cuts them and differs here (ROADMAP
    queue C item 1)."""
    sql = ("SELECT a.grp, sum(b.w) AS s FROM a, b WHERE a.id = b.id "
           "GROUP BY a.grp ORDER BY s DESC, a.grp LIMIT 3")
    totals = {}
    for i in range(N_ROWS):
        totals[i % 10] = totals.get(i % 10, 0) + i * 3
    want = sorted(totals.items(), key=lambda kv: (-kv[1], kv[0]))[:3]
    try:
        _reset(sess)
        assert sess.execute(sql).rows() == want
        sess.executor.oom = OomState(batch_shrink=2 if force_stream else 1,
                                     force_stream=force_stream,
                                     multipass_k=4)
        got = sess.execute(sql)
        assert got.spill_passes >= 2
        assert got.rows() == want
        _assert_no_leak(sess)
    finally:
        _reset(sess)


def test_stat_memory_udf_and_explain_line(sess, oracle):
    """citus_stat_memory() exposes the ledger and the ladder's state, and
    EXPLAIN ANALYZE renders the Memory line (the JAX package's test of
    the same name fails in the reference: the port is held to the
    design)."""
    r = sess.execute("SELECT citus_stat_memory()")
    row = {n: r.columns[n][0] for n in r.column_names}
    for key in ("live_bytes", "peak_bytes", "oom_events_total",
                "cache_evictions_total", "spill_passes_total",
                "degradation_multipass_k", "memsim_armed",
                "budget_bytes"):
        assert key in row
    assert row["peak_bytes"] >= row["live_bytes"]
    plan = sess.execute("EXPLAIN ANALYZE " + WORKLOAD[1])
    text = "\n".join(plan.columns["QUERY PLAN"])
    assert "Memory:" in text
    assert "oom_events=" in text and "peak=" in text
    _assert_no_leak(sess)


def test_activity_exposes_hbm_columns(sess, oracle):
    r = sess.execute("SELECT citus_stat_activity()")
    assert "hbm_live_bytes" in r.column_names
    assert "hbm_peak_bytes" in r.column_names
    assert r.columns["hbm_live_bytes"][0] == \
        sess.executor.accountant.live_bytes()
