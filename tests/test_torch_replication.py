"""The port's log-shipped replicas (citus_tpu_torch/replication/) against
the JAX package's, on CPU torch.

* Provision, ship and apply between port data_dirs: the follower
  answers the leader's rows, its journal is a byte-exact copy, writes
  are refused (`ReadOnlyReplica`), a read drains the spool, a caught-up
  ship is a noop, a dropped table ships, `replica_max_staleness_lsn`
  raises `ReplicaTooStale`, citus_stat_replication and EXPLAIN
  ANALYZE's Replication line report both roles.
* Promotion and fencing: the promoted follower takes writes on the same
  lsn line, the old leader's late ship is refused and counted, a zombie
  batch in the spool is rejected by the applier, an interrupted
  promotion completes on retry.
* The fault points `replication.ship` / `replication.apply`, and a
  power cut at every durable write of one ship + apply through the
  port's utils/crashsim.py: the follower is pre- XOR post-batch, and a
  redo converges with a byte-identical journal.
* Across packages: a JAX leader's batch (its exec_cache/ included)
  applies on a port follower and lands the
  same files as the JAX package's own apply; a port leader's batch
  applies on a JAX follower; a port session reads the JAX-shipped
  follower and its rows equal the JAX follower session's.
"""

import os
import shutil

import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu import replication as jrepl
from citus_tpu.replication import state as jstate
from citus_tpu_torch.catalog import Catalog
from citus_tpu_torch.errors import (
    ReadOnlyReplica,
    ReplicaTooStale,
    ReplicationError,
)
from citus_tpu_torch.replication import (
    apply_pending,
    journal_tail_lsn,
    load_cursor,
    load_state,
    promote,
    provision_replica,
    register_follower,
    ship,
    ship_all,
    staleness,
)
from citus_tpu_torch.replication import state as pstate
from citus_tpu_torch.stats import counters as sc
from citus_tpu_torch.storage import TableStore
from citus_tpu_torch.utils import faultinjection as pfi
from citus_tpu_torch.utils.crashsim import PowerCut, power_cut_at

torch.set_num_threads(1)

JOURNAL = "cdc_changes.jsonl"


def _port(path, **kw):
    kw.setdefault("retry_backoff_base_ms", 1)
    kw.setdefault("retry_backoff_max_ms", 2)
    return citus_tpu_torch.connect(str(path), device="cpu",
                                   compute_dtype="float64", **kw)


def _jax(path, **kw):
    return citus_tpu.connect(data_dir=str(path), n_devices=1,
                             compute_dtype="float64",
                             recover_2pc_interval_ms=-1,
                             defer_shard_delete_interval_ms=-1,
                             health_check_interval_ms=-1,
                             retry_backoff_base_ms=1, **kw)


def _seed(sess, rows=30):
    sess.execute("create table kv (id bigint, v bigint)")
    sess.execute("select create_distributed_table('kv', 'id', 4)")
    sess.execute("insert into kv values " + ", ".join(
        f"({i}, {i * 3})" for i in range(rows)))
    return sess


def _rows(sess, sql="select id, v from kv order by id"):
    return [(int(a), int(b)) for a, b in sess.execute(sql).rows()]


def _rows_cold(data_dir, table="kv"):
    """Read a data_dir without a Session (a crashed follower's view)."""
    cat = Catalog.load(os.path.join(data_dir, "catalog.json"))
    store = TableStore(str(data_dir), cat)
    out = {}
    for shard in cat.table_shards(table):
        vals, _mask, n = store.read_shard(table, shard.shard_id,
                                          ["id", "v"])
        for i in range(n):
            out[int(vals["id"][i])] = int(vals["v"][i])
    return sorted(out.items())


def _journal(d):
    with open(os.path.join(d, JOURNAL), "rb") as f:
        return f.read()


@pytest.fixture
def pair(tmp_path):
    """A port leader with seeded rows and a provisioned follower."""
    lead, foll = str(tmp_path / "leader"), str(tmp_path / "replica")
    s = _seed(_port(lead))
    res = provision_replica(lead, foll, counters=s.stats.counters)
    assert res["applied"] == 1
    yield s, lead, foll
    s.close()


# -- provision, ship, apply --------------------------------------------------

def test_provisioned_replica_serves_rows(pair):
    s, lead, foll = pair
    r = _port(foll)
    try:
        assert _rows(r) == _rows(s) and len(_rows(r)) == 30
        st = staleness(foll)
        assert st["lag_lsn"] == 0 and st["lag_bytes"] == 0
        assert st["leader_dir"] == os.path.realpath(lead)
    finally:
        r.close()


def test_follower_journal_is_byte_identical(pair):
    s, lead, foll = pair
    s.execute("insert into kv values (900, 1), (901, 2)")
    s.execute("delete from kv where id = 901")
    ship(lead, foll, counters=s.stats.counters)
    apply_pending(foll)
    lj, fj = _journal(lead), _journal(foll)
    assert fj == lj and len(fj) > 0
    cur = load_cursor(foll)
    assert cur["journal_size"] == len(fj)
    assert cur["applied_lsn"] == journal_tail_lsn(foll)


@pytest.mark.parametrize("sql", [
    "insert into kv values (999, 1)",
    "update kv set v = 0 where id = 1",
    "delete from kv where id = 2",
    "create table t2 (a bigint)",
    "drop table kv",
    "create view vv as select id from kv",
    "select nextval('s1')",
    "select create_reference_table('kv')",
])
def test_read_only_replica_rejects_writes(pair, sql):
    s, lead, foll = pair
    r = _port(foll)
    try:
        with pytest.raises(ReadOnlyReplica):
            r.execute(sql)
        assert _rows(r) == _rows(s)  # reads keep answering
    finally:
        r.close()


def test_incremental_ship_and_apply_on_read(pair):
    s, lead, foll = pair
    r = _port(foll)
    try:
        before = _rows(r)
        s.execute("insert into kv values (500, 7)")
        s.execute("update kv set v = v + 1 where id < 3")
        res = ship(lead, foll, counters=s.stats.counters)
        assert res["status"] == "shipped" and not res["reseed"]
        after = _rows(r)  # the read drains the spool, no restart
        assert after == _rows(s) and after != before
        assert r.stats.counters.snapshot()[sc.LOG_BATCHES_APPLIED_TOTAL] \
            == 1
    finally:
        r.close()


def test_ship_is_noop_when_caught_up(pair):
    _s, lead, foll = pair
    assert ship(lead, foll)["status"] == "noop"


def test_dropped_table_ships(pair):
    s, lead, foll = pair
    s.execute("create table gone (a bigint)")
    s.execute("select create_distributed_table('gone', 'a', 2)")
    s.execute("insert into gone values (1)")
    ship(lead, foll)
    apply_pending(foll)
    assert os.path.isdir(os.path.join(foll, "tables", "gone"))
    s.execute("drop table gone")
    ship(lead, foll)
    apply_pending(foll)
    assert not os.path.isdir(os.path.join(foll, "tables", "gone"))
    r = _port(foll)
    try:
        assert "gone" not in r.catalog.tables
    finally:
        r.close()


def test_staleness_gate_raises_replica_too_stale(pair):
    s, lead, foll = pair
    r = _port(foll)
    try:
        s.execute("insert into kv values (600, 1)")
        with r.settings.override(replica_max_staleness_lsn=0):
            with pytest.raises(ReplicaTooStale):
                r.execute("select count(*) from kv")
        assert r.stats.counters.snapshot()[sc.REPLICA_LAG_LSN] >= 1
        assert (600, 1) not in _rows(r)  # unbounded: the old rows
        ship(lead, foll)
        with r.settings.override(replica_max_staleness_lsn=0):
            assert _rows(r) == _rows(s)
    finally:
        r.close()


def test_stat_replication_udf_both_roles(pair):
    s, lead, foll = pair
    s.execute("insert into kv values (700, 1)")
    r0 = s.execute("select citus_stat_replication()")
    assert r0.column_names == ["peer", "peer_role", "applied_lsn",
                               "leader_lsn", "lag_lsn", "lag_bytes",
                               "epoch"]
    (peer, role, applied, leader_lsn, lag_lsn, lag_bytes, epoch), = \
        r0.rows()
    assert peer == os.path.realpath(foll) and role == "follower"
    assert lag_lsn >= 1 and lag_bytes >= 1 and epoch == 1
    assert leader_lsn == applied + lag_lsn
    r = _port(foll)
    try:
        fr = r.execute("select citus_stat_replication()").rows()[0]
        assert fr[1] == "leader" and fr[4] >= 1
    finally:
        r.close()


def test_explain_analyze_replication_line(pair):
    s, lead, foll = pair
    r = _port(foll)
    try:
        text = "\n".join(r.execute(
            "explain analyze select count(*) from kv").columns["QUERY PLAN"])
        assert "Replication: role=follower epoch=1" in text
        assert "lag_lsn=0" in text
        ltext = "\n".join(s.execute(
            "explain analyze select count(*) from kv").columns["QUERY PLAN"])
        assert "Replication: role=leader epoch=1 followers=1" in ltext
    finally:
        r.close()


def test_replication_ship_udf_and_open_time_apply(pair):
    s, lead, foll = pair
    s.execute("insert into kv values (750, 5)")
    r = s.execute("select citus_replication_ship()")
    assert r.column_names == ["follower", "status", "batch_seq", "files",
                              "bytes"]
    (follower, status, seq, files, nbytes), = r.rows()
    assert follower == os.path.realpath(foll) and status == "shipped"
    assert seq == 2 and files >= 1 and nbytes > 0
    # a session opening on the follower applies the spool before serving
    f = _port(foll)
    try:
        assert load_cursor(foll)["batch_seq"] == 2
        assert (750, 5) in _rows(f)
    finally:
        f.close()


# -- promotion and fencing ---------------------------------------------------

def test_promote_serves_writes_and_fences_old_leader(pair):
    s, lead, foll = pair
    s.execute("insert into kv values (800, 8)")
    ship_all(lead, counters=s.stats.counters)
    r = _port(foll)
    try:
        assert r.execute("select citus_promote_replica()").rows() == [(2,)]
        assert load_state(foll)["role"] == "leader"
        pre = journal_tail_lsn(foll)
        r.execute("insert into kv values (801, 9)")
        assert journal_tail_lsn(foll) > pre
        assert (800, 8) in _rows(r) and (801, 9) in _rows(r)
        with pytest.raises(ReplicationError, match="fenced"):
            ship(lead, foll, counters=s.stats.counters)
        assert s.stats.counters.snapshot()[
            sc.REPLICATION_FENCED_TOTAL] == 1
        assert r.stats.counters.snapshot()[
            sc.REPLICAS_PROMOTED_TOTAL] == 1
    finally:
        r.close()


def test_promoted_follower_opens_with_its_memo_and_cache_warm(pair):
    """The leader's caps_memo.json and exec_cache/ ship with its data: a
    follower promoted later opens warm — its first run of a statement
    the leader converged starts at the memoized sizes (no capacity
    retry, one plan-cache key) and resolves from the persisted cache."""
    s, lead, foll = pair
    join = "select a.id, b.id from kv a, kv b where a.v % 2 = b.v % 2"
    s.execute("set join_output_capacity_factor = 0.1")
    first = s.execute(join)
    assert first.retries == 1
    s.executor.flush_persistent()
    ship_all(lead, counters=s.stats.counters)
    promote(foll)
    assert os.path.exists(os.path.join(foll, "caps_memo.json"))
    assert any(f.endswith(".meta.json")
               for f in os.listdir(os.path.join(foll, "exec_cache")))
    r = _port(foll, join_output_capacity_factor=0.1)
    try:
        again = r.execute(join)
        assert again.retries == 0 and r.executor.plan_cache.misses == 1
        assert sorted(again.rows()) == sorted(first.rows())
        assert r.stats.counters.snapshot()[
            sc.EXEC_CACHE_HITS_TOTAL] == 1
    finally:
        r.close()


def test_zombie_batch_in_spool_rejected_by_applier(pair):
    s, lead, foll = pair
    promote(foll)
    os.unlink(os.path.join(lead, "replication", "fence.json"))
    s.execute("insert into kv values (802, 1)")
    with pytest.raises(ReplicationError, match="stale"):
        ship(lead, foll)
    cur = load_cursor(foll)
    pstate.save_cursor(foll, dict(cur, epoch=1))
    ship(lead, foll)
    pstate.save_cursor(foll, cur)
    counters = s.stats.counters
    res = apply_pending(foll, counters=counters)
    assert res["fenced"] == 1 and res["applied"] == 0
    assert counters.snapshot()[sc.REPLICATION_FENCED_TOTAL] == 1
    assert (802, 1) not in _rows_cold(foll)


def test_promote_is_idempotent_under_directed_fault(pair):
    _s, lead, foll = pair
    with pytest.raises(pfi.InjectedFault):
        with pfi.inject("replication.promote", require_fired=True):
            promote(foll)
    assert load_state(foll)["role"] == "follower"
    assert promote(foll) == 2
    assert load_state(foll)["role"] == "leader"
    with pytest.raises(ReplicationError, match="not a follower"):
        promote(foll)


# -- directed faults and power cuts ------------------------------------------

def test_ship_fault_fires_and_is_clean(pair):
    s, lead, foll = pair
    s.execute("insert into kv values (810, 1)")
    with pytest.raises(pfi.InjectedFault):
        with pfi.inject("replication.ship", require_fired=True):
            ship(lead, foll)
    assert apply_pending(foll)["applied"] == 0
    ship(lead, foll)
    apply_pending(foll)
    assert (810, 1) in _rows_cold(foll)


def test_apply_fault_fires_and_retry_lands(pair):
    s, lead, foll = pair
    s.execute("insert into kv values (811, 1)")
    ship(lead, foll)
    with pytest.raises(pfi.InjectedFault):
        with pfi.inject("replication.apply", require_fired=True):
            apply_pending(foll)
    assert apply_pending(foll)["applied"] == 1
    assert (811, 1) in _rows_cold(foll)


@pytest.fixture(scope="module")
def repl_base(tmp_path_factory):
    """A frozen port leader + follower pair with one unshipped
    increment (an insert, an update and a delete)."""
    base = tmp_path_factory.mktemp("torch_repl_torture")
    lead, foll = str(base / "leader"), str(base / "replica")
    s = _seed(_port(lead), rows=20)
    provision_replica(lead, foll, counters=s.stats.counters)
    pre = _rows_cold(foll)
    s.execute("insert into kv values (100, 1), (101, 2), (102, 3)")
    s.execute("update kv set v = 999 where id < 4")
    s.execute("delete from kv where id = 7")
    post = _rows_cold(lead)
    s.close()
    assert pre != post
    return lead, foll, pre, post


def _ship_apply(lead, foll):
    ship(lead, foll)
    return apply_pending(foll)


def test_power_cut_at_every_write_of_ship_and_apply(repl_base, tmp_path):
    """Every durable write op of one ship + apply, its tear mode cycled
    by op index (the smallest tier of the JAX package's sweep)."""
    lead, foll, pre, post = repl_base
    wl, wf = str(tmp_path / "rl"), str(tmp_path / "rf")
    shutil.copytree(lead, wl)
    shutil.copytree(foll, wf)
    with power_cut_at(None) as sim:
        _ship_apply(wl, wf)
    assert _rows_cold(wf) == post
    total = sim.ops
    assert total >= 8
    modes = set()
    for n in range(1, total + 1):
        wl, wf = str(tmp_path / f"l{n:03d}"), str(tmp_path / f"f{n:03d}")
        shutil.copytree(lead, wl)
        shutil.copytree(foll, wf)
        with power_cut_at(n) as sim:
            with pytest.raises(PowerCut):
                _ship_apply(wl, wf)
        modes.add(sim.tear_applied)
        got = _rows_cold(wf)
        assert got in (pre, post), f"op {n} ({sim.tear_applied})"
        _ship_apply(wl, wf)  # the follower restarts: redo converges
        assert _rows_cold(wf) == post, f"redo after op {n}"
        assert _journal(wf) == _journal(wl), f"journal after op {n}"
        assert not apply_pending(wf)["applied"]
        shutil.rmtree(wl)
        shutil.rmtree(wf)
    assert modes >= {"lost", "torn", "complete"}


# -- across packages ---------------------------------------------------------

def _tree(d, skip=("replication",)):
    """{relative path: bytes} of a data_dir, minus `skip` top dirs."""
    out = {}
    for root, _dirs, files in os.walk(d):
        rel = os.path.relpath(root, d)
        if rel.split(os.sep)[0] in skip:
            continue
        for f in files:
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                out[os.path.normpath(os.path.join(rel, f))] = fh.read()
    return out


@pytest.fixture
def jax_leader(tmp_path):
    """A JAX-package leader at n_devices=1 with its executable cache on,
    so its data_dir holds exec_cache/.  Every later JAX session runs
    with the cache off: the JAX package's executable cache can load an
    executable built for another mesh width (ROADMAP, queue C context),
    and these tests are about the files, not about loading them."""
    lead = str(tmp_path / "jleader")
    j = _seed(_jax(lead, serving_result_cache_bytes=0))
    j.execute("select count(*), sum(v) from kv")
    j.execute("select v % 3, count(*) from kv group by v % 3")
    j.close()  # flushes the caps memo and the exec-cache index
    return lead


def test_jax_batch_applies_on_a_port_follower(jax_leader, tmp_path):
    lead = jax_leader
    assert os.listdir(os.path.join(lead, "exec_cache"))
    f_jax, f_port = str(tmp_path / "fj"), str(tmp_path / "fp")
    # the JAX package provisions one follower and applies it itself
    jrepl.provision_replica(lead, f_jax)
    # and stages the other, which the port applies
    state = jrepl.register_follower(lead, f_port)
    jstate.save_state(f_port, {
        "role": "follower", "epoch": state["epoch"],
        "history_id": state["history_id"],
        "leader_dir": os.path.realpath(lead), "followers": []})
    assert jrepl.ship(lead, f_port)["reseed"]
    assert apply_pending(f_port)["applied"] == 1
    assert _tree(f_port) == _tree(f_jax)  # exec_cache/ included
    assert os.path.isdir(os.path.join(f_port, "exec_cache"))
    assert _journal(f_port) == _journal(lead)
    # an increment: the JAX leader writes and ships, a port follower
    # session drains it on its next read
    j = _jax(lead, serving_result_cache_bytes=0, exec_cache_enabled=False)
    j.execute("insert into kv values (400, 4)")
    j.execute("update kv set v = 0 where id = 2")
    want = _rows(j)
    j.close()
    jrepl.ship(lead, f_jax)
    jrepl.apply_pending(f_jax)
    jrepl.ship(lead, f_port)
    p = _port(f_port)
    jf = _jax(f_jax, serving_result_cache_bytes=0, exec_cache_enabled=False)
    try:
        assert _rows(p) == _rows(jf) == want
        assert p.execute("select count(*), sum(v) from kv").rows() == \
            jf.execute("select count(*), sum(v) from kv").rows()
    finally:
        jf.close()
        p.close()
    assert _journal(f_port) == _journal(f_jax) == _journal(lead)


def test_port_session_reads_a_jax_shipped_follower(jax_leader, tmp_path):
    foll = str(tmp_path / "f")
    jrepl.provision_replica(jax_leader, foll)
    jf = _jax(foll, serving_result_cache_bytes=0, exec_cache_enabled=False)
    want = {sql: jf.execute(sql).rows() for sql in (
        "select id, v from kv order by id",
        "select count(*), sum(v) from kv",
        "select v from kv where id = 11")}
    jf.close()
    p = _port(foll)
    try:
        for sql, rows in want.items():
            assert p.execute(sql).rows() == rows, sql
        with pytest.raises(ReadOnlyReplica):
            p.execute("insert into kv values (1000, 1)")
    finally:
        p.close()


def test_port_batch_applies_on_a_jax_follower(pair, tmp_path):
    s, lead, _foll = pair
    f_jax = str(tmp_path / "fj")
    state = register_follower(lead, f_jax)
    pstate.save_state(f_jax, {
        "role": "follower", "epoch": state["epoch"],
        "history_id": state["history_id"],
        "leader_dir": os.path.realpath(lead), "followers": []})
    s.execute("insert into kv values (555, 5)")
    assert ship(lead, f_jax, counters=s.stats.counters)["reseed"]
    assert jrepl.apply_pending(f_jax)["applied"] == 1
    assert _journal(f_jax) == _journal(lead)
    assert not os.path.exists(os.path.join(f_jax, "exec_cache"))
    jf = _jax(f_jax, serving_result_cache_bytes=0, exec_cache_enabled=False)
    try:
        assert _rows(jf) == _rows(s)
        assert (555, 5) in _rows(jf)
    finally:
        jf.close()
