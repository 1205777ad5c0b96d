"""The port's statement envelope (Session._execute_resilient) against
the JAX package's, on CPU torch.

* a statement timeout and a cross-thread cancel at a stream batch
  boundary, at a fault point and at a COPY batch boundary: the statement
  raises StatementTimeout / QueryCanceled, no producer thread and no
  ledger charge stays behind, and the next statement answers;
* a transient `store.read_shard` storage fault on a table with a
  replication factor of 2: the retry marks the placement it read
  suspect and reads the replica's copy, with the JAX package's rows and
  suspect set;
* a COPY is never re-run, and the post-visibility `cdc.append` fault is
  not retried;
* every write-path fault point, the three of the 2PC among them, with
  the default `max_statement_retries` on both sides: the outcome (raise,
  retried write, or a COMMIT resolved by its commit record) and the
  resulting state equal the JAX package's;
* SET of max_statement_retries, statement_timeout_ms and the two
  backoff settings takes effect.

Both packages' sessions open their own copy of one data_dir (TPC-H sf
0.002 seed 5 plus a small kv table) on one device.  Rows are held exact,
sums at rtol 1e-9.
"""

import gc
import shutil
import threading
import time

import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu.ingest import tpch as jtpch
from citus_tpu.utils import faultinjection as jfi
from citus_tpu_torch.errors import QueryCanceled, StatementTimeout
from citus_tpu_torch.utils import faultinjection as pfi
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
STREAM_SQL = ("select l_returnflag, count(*), sum(l_quantity) "
              "from lineitem group by l_returnflag")
STREAM_SETUP = ("set max_feed_bytes_per_device = 1; "
                "set stream_batch_rows = 512")
_JAX = dict(n_devices=1, exec_cache_enabled=False, compute_dtype="float64",
            serving_result_cache_bytes=0, recover_2pc_interval_ms=-1,
            defer_shard_delete_interval_ms=-1, health_check_interval_ms=-1,
            retry_backoff_base_ms=1, retry_backoff_max_ms=5)


def _jax(data_dir, **kw):
    return citus_tpu.connect(data_dir=str(data_dir), **{**_JAX, **kw})


def _port(data_dir, **kw):
    return citus_tpu_torch.connect(str(data_dir), device="cpu",
                                   **{"compute_dtype": "float64",
                                      "retry_backoff_base_ms": 1,
                                      "retry_backoff_max_ms": 5, **kw})


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_resilience") / "base")
    s = _jax(d)
    jtpch.load_into_session(s, sf=0.002, seed=5, shard_count=4)
    s.execute(SETUP)
    s.close()
    return d


def _copy(base, tmp_path, name):
    d = str(tmp_path / name)
    shutil.copytree(base, d)
    return d


def kv_state(sess, table="kv"):
    return {int(r[0]): int(r[1])
            for r in sess.execute(f"select id, v from {table}").rows()}


def _producers():
    return [t for t in threading.enumerate() if t.is_alive()
            and t.name in ("citus-stream-producer", "scan-prefetch")]


def _assert_clean(sess):
    acc = sess.executor.accountant
    if acc.transient_bytes():
        gc.collect()
    assert acc.transient_bytes() == 0, acc.snapshot()
    assert _producers() == []


# -- deadlines and cancels ---------------------------------------------------

def test_timeout_at_stream_batch_boundary(base, tmp_path):
    """A slow batch producer outlives statement_timeout_ms: the consumer
    raises StatementTimeout at its next batch boundary, in both
    packages; the producer is joined and the ledger is clean."""
    outcomes = {}
    for pkg, connect, fi in (("jax", _jax, jfi), ("port", _port, pfi)):
        s = connect(_copy(base, tmp_path, pkg))
        s.execute(STREAM_SETUP)
        s.execute("set statement_timeout_ms = 150")
        with fi.inject("stream.prefetch", sleep=0.1, error=None,
                       times=1000):
            t0 = time.monotonic()
            with pytest.raises(Exception) as err:
                s.execute(STREAM_SQL)
            outcomes[pkg] = type(err.value).__name__
        assert time.monotonic() - t0 < 5.0
        s.execute("set statement_timeout_ms = 0")
        r = s.execute(STREAM_SQL)
        assert r.streamed_batches >= 2
        outcomes[pkg + "_rows"] = sorted(r.rows())
        if pkg == "port":
            _assert_clean(s)
    assert outcomes["port"] == outcomes["jax"] == "StatementTimeout"
    compare_results(outcomes["port_rows"], outcomes["jax_rows"], True, TOL)


def test_cancel_at_stream_batch_boundary(base, tmp_path):
    """Session.cancel() from a second thread after the first batch of a
    streamed GROUP BY: QueryCanceled before the last batch."""
    s = _port(_copy(base, tmp_path, "p"))
    s.execute(STREAM_SETUP)
    first_done, cancelled = threading.Event(), threading.Event()
    real = s.executor.run_with_retry
    runs = []

    def run_with_retry(*a, **kw):
        out = real(*a, **kw)
        runs.append(1)
        if len(runs) == 1:
            first_done.set()
            cancelled.wait(5)
        return out

    def canceller():
        first_done.wait(5)
        s.cancel()
        cancelled.set()

    s.executor.run_with_retry = run_with_retry
    t = threading.Thread(target=canceller)
    t.start()
    with pytest.raises(QueryCanceled):
        s.execute(STREAM_SQL)
    t.join()
    del s.executor.run_with_retry
    assert len(runs) == 1
    _assert_clean(s)
    assert s.execute(STREAM_SQL).streamed_batches >= 2
    _assert_clean(s)


def test_cancel_at_a_fault_point(base, tmp_path):
    """A cancel while a shard read is delayed: the next fault point (the
    next shard's read) raises QueryCanceled, in both packages."""
    outcomes = {}
    for pkg, connect, fi in (("jax", _jax, jfi), ("port", _port, pfi)):
        s = connect(_copy(base, tmp_path, pkg))
        with fi.inject("store.read_shard", sleep=0.3, error=None,
                       times=100):
            t = threading.Timer(0.1, s.cancel)
            t.start()
            with pytest.raises(Exception) as err:
                s.execute("select count(*), sum(v) from kv")
            t.join()
        outcomes[pkg] = type(err.value).__name__
        # the next statement clears the cancel and answers
        assert s.execute("select count(*) from kv").rows() == [(40,)]
    assert outcomes == {"jax": "QueryCanceled", "port": "QueryCanceled"}


def test_cancel_at_a_copy_batch_boundary(base, tmp_path, monkeypatch):
    """A cancel after COPY's first batch: QueryCanceled at the next batch
    boundary; the first batch stays committed (COPY commits per batch)
    and nothing is re-run."""
    from citus_tpu_torch.ingest import copy_from

    monkeypatch.setattr(copy_from, "COPY_BATCH_ROWS", 10)
    s = _port(_copy(base, tmp_path, "p"))
    csv_path = tmp_path / "rows.csv"
    csv_path.write_text("".join(f"{1000 + i},{i}\n" for i in range(50)))
    first_done, cancelled = threading.Event(), threading.Event()
    real = copy_from._ingest_batch
    batches = []

    def ingest(*a, **kw):
        out = real(*a, **kw)
        batches.append(1)
        if len(batches) == 1:
            first_done.set()
            cancelled.wait(5)
        return out

    def canceller():
        first_done.wait(5)
        s.cancel()
        cancelled.set()

    monkeypatch.setattr(copy_from, "_ingest_batch", ingest)
    t = threading.Thread(target=canceller)
    t.start()
    with pytest.raises(QueryCanceled):
        s.execute(f"copy kv from '{csv_path}' with (format csv)")
    t.join()
    assert len(batches) == 1
    assert len(kv_state(s)) == len(SEED) + 10


# -- replica failover --------------------------------------------------------

def test_storage_fault_fails_over_to_the_replica(base, tmp_path):
    """A transient storage fault on a factor-2 table's shard read: the
    retry marks the placement it read suspect and reads the replica's
    copy — the JAX package's rows and suspect set."""
    bdir = _copy(base, tmp_path, "rbase")
    p0 = _port(bdir)
    p0.execute("select citus_add_node('device:1')")
    p0.execute("set shard_replication_factor = 2")
    p0.execute("create table rt (id bigint, v double precision)")
    p0.execute("select create_distributed_table('rt', 'id', 4)")
    p0.execute("insert into rt values " + ", ".join(
        f"({i}, {i * 0.25})" for i in range(300)))
    p0.close()
    sql = "select count(*), sum(v), min(id), max(id) from rt"
    got = {}
    for pkg, connect, fi in (("jax", _jax, jfi), ("port", _port, pfi)):
        s = connect(_copy(bdir, tmp_path, pkg))
        paths = []
        if pkg == "port":
            real = s.store.stripe_read_path

            def spy(*a):
                paths.append(real(*a))
                return paths[-1]

            s.store.stripe_read_path = spy
        with fi.inject("store.read_shard", error="storage",
                       require_fired=True):
            r = s.execute(sql)
        got[pkg] = (r.rows(), sorted(s.catalog._suspect_placements))
        if pkg == "port":
            assert any("replica_" in p for p in paths)
            assert r.retries == 1
    assert got["port"][1] and got["port"][1] == got["jax"][1]
    compare_results(got["port"][0], got["jax"][0], False, TOL)
    assert got["port"][0][0][0] == 300


# -- what is never retried ---------------------------------------------------

def test_copy_is_never_re_run(base, tmp_path):
    """COPY commits each batch on its own: a failure is surfaced, never
    re-run (a re-run would succeed here, the fault fires once), in both
    packages alike."""
    csv_path = tmp_path / "rows.csv"
    csv_path.write_text("".join(f"{1000 + i},{i}\n" for i in range(50)))
    states = {}
    for pkg, connect, fi in (("jax", _jax, jfi), ("port", _port, pfi)):
        s = connect(_copy(base, tmp_path, pkg))
        with fi.inject("store.append_stripe", require_fired=True):
            with pytest.raises(Exception, match="store.append_stripe"):
                s.execute(f"copy kv from '{csv_path}' with (format csv)")
        states[pkg] = kv_state(s)
    assert states["port"] == states["jax"] == SEED


# -- write-path fault points under the default retries -----------------------

# point → (statements before, the failing statement, its effect visible
# after).  cdc.append fires after the visibility flip: not retried, the
# write stands.  txn.prepare / txn.commit_record fail a COMMIT without a
# commit record: recovery discards it and the error stands.  txn.apply
# fails after the record: the envelope rolls the COMMIT forward and
# returns.  The rest are retried and succeed.
FAULTS = {
    "store.append_stripe": ([], "insert into kv values (800, 1)", True),
    "storage.manifest_flip": ([], "insert into kv values (800, 1)", True),
    "store.apply_dml": ([], "update kv set v = 0 where id < 20", True),
    "executor.repartition_shuffle": (
        [], "insert into kv_by_v select id, v from kv", True),
    "cdc.append": ([], "insert into kv values (800, 1)", True),
    "txn.prepare": (["begin", "update kv set v = 1 where id < 6",
                     "insert into kv values (801, 2)"], "commit", False),
    "txn.commit_record": (["begin", "update kv set v = 1 where id < 6",
                           "insert into kv values (801, 2)"], "commit",
                          False),
    "txn.apply": (["begin", "update kv set v = 1 where id < 6",
                   "insert into kv values (801, 2)"], "commit", True),
}


@pytest.mark.parametrize("point", sorted(FAULTS))
def test_fault_point_under_default_retries_matches_jax(base, tmp_path,
                                                       point):
    before, failing, visible = FAULTS[point]
    outcome, states = {}, {}
    for pkg, connect, fi in (("jax", _jax, jfi), ("port", _port, pfi)):
        d = _copy(base, tmp_path, pkg)
        s = connect(d)
        for sql in before:
            s.execute(sql)
        with fi.inject(point, require_fired=True):
            try:
                s.execute(failing)
                outcome[pkg] = "answered"
            except citus_tpu.CitusTpuError as e:
                outcome[pkg] = f"raised {type(e).__name__}"
            except citus_tpu_torch.CitusTpuError as e:
                outcome[pkg] = f"raised {type(e).__name__}"
        assert s.txn_manager.current is None
        states[pkg] = (kv_state(s), kv_state(s, "kv_by_v"))
        # a fresh session of the same package agrees (nothing left for
        # recovery to change)
        again = connect(d)
        assert (kv_state(again), kv_state(again, "kv_by_v")) == states[pkg]
    assert outcome["port"] == outcome["jax"], outcome
    assert states["port"] == states["jax"]
    assert (states["port"] != (SEED, {})) == visible
    want = "raised InjectedFault" if point in (
        "cdc.append", "txn.prepare", "txn.commit_record") else "answered"
    assert outcome["port"] == want


# -- the settings take effect ------------------------------------------------

def test_max_statement_retries_takes_effect(base, tmp_path):
    s = _port(_copy(base, tmp_path, "p"))
    s.execute("set max_statement_retries = 0")
    with pfi.inject("store.append_stripe", require_fired=True):
        with pytest.raises(pfi.InjectedFault):
            s.execute("insert into kv values (800, 1)")
    s.execute("set max_statement_retries = 2")
    with pfi.inject("store.append_stripe", times=2, require_fired=True):
        s.execute("insert into kv values (800, 1)")
    with pfi.inject("store.append_stripe", times=3, require_fired=True):
        with pytest.raises(pfi.InjectedFault):
            s.execute("insert into kv values (801, 1)")
    assert kv_state(s) == {**SEED, 800: 1}


def test_statement_timeout_ms_takes_effect(base, tmp_path):
    s = _port(_copy(base, tmp_path, "p"))
    s.execute("set statement_timeout_ms = 100")
    with pfi.inject("store.read_shard", sleep=0.15, error=None, times=100):
        with pytest.raises(StatementTimeout):
            s.execute("select count(*) from kv")
    s.execute("set statement_timeout_ms = 0")
    with pfi.inject("store.read_shard", sleep=0.05, error=None, times=100):
        assert s.execute("select count(*) from kv").rows() == [(40,)]


@pytest.mark.parametrize("base_ms,max_ms,lo,hi", [(400.0, 1000.0, 0.2, 2.0),
                                                 (2000.0, 10.0, 0.0, 0.5)])
def test_retry_backoff_settings_take_effect(base, tmp_path, base_ms, max_ms,
                                            lo, hi):
    """One retry waits base × [0.5, 1.5), capped at max."""
    s = _port(_copy(base, tmp_path, "p"))
    s.execute(f"set retry_backoff_base_ms = {base_ms}")
    s.execute(f"set retry_backoff_max_ms = {max_ms}")
    with pfi.inject("store.append_stripe", require_fired=True):
        t0 = time.monotonic()
        s.execute("insert into kv values (800, 1)")
        dt = time.monotonic() - t0
    assert lo <= dt < hi, dt


def test_oom_max_spill_passes_takes_effect(base, tmp_path):
    """The ladder stops splitting at oom_max_spill_passes."""
    from citus_tpu_torch.executor.hbm import oom_budget

    s = _port(_copy(base, tmp_path, "p"))
    s.execute("set oom_max_spill_passes = 2")
    with oom_budget(s.executor.accountant, budget=64):
        with pytest.raises(citus_tpu_torch.errors.ResourceExhausted):
            s.execute("select count(*), sum(o_totalprice) from orders, "
                      "lineitem where o_orderkey = l_orderkey")
    assert s.executor.oom.multipass_k == 2
    assert s.last_oom_rungs.count("multipass") == 1
    _assert_clean(s)


# point → the statement that reaches it (overflow_retry needs a join
# whose 0.1 capacity factor overflows)
EXECUTOR_FAULTS = {
    "executor.plan_cache_fill": ("select count(*), sum(v) from kv",
                                 [(40, sum(SEED.values()))]),
    "executor.overflow_retry": (
        "select count(*) from kv x, kv y "
        "where x.v % 4 = y.v % 4 and x.id < y.id", [(180,)]),
}


@pytest.mark.parametrize("retries", [0, 2])
@pytest.mark.parametrize("point", sorted(EXECUTOR_FAULTS))
def test_executor_fault_point_matches_jax(base, tmp_path, point, retries):
    """An injected fault while the plan cache fills or capacities regrow:
    retried into the right answer under the default retries, raised
    with none — in both packages."""
    sql, want = EXECUTOR_FAULTS[point]
    got = {}
    for pkg, connect, fi in (("jax", _jax, jfi), ("port", _port, pfi)):
        s = connect(_copy(base, tmp_path, pkg),
                    max_statement_retries=retries,
                    join_output_capacity_factor=0.1,
                    enable_capacity_feedback=False)
        with fi.inject(point, require_fired=True):
            try:
                got[pkg] = s.execute(sql).rows()
            except (citus_tpu.CitusTpuError,
                    citus_tpu_torch.CitusTpuError) as e:
                got[pkg] = type(e).__name__
    if retries:
        compare_results(got["port"], got["jax"], False, TOL)
        assert got["port"] == want
    else:
        assert got["port"] == got["jax"] == "InjectedFault"
