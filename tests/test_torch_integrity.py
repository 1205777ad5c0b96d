"""The port's storage integrity (citus_tpu_torch/storage/integrity.py and
the store's read-repair seam) against the JAX package's, on CPU torch
in float64.

* The repair first: a replication-factor-2 table with one flipped bit,
  where the JAX package answers, and the port answers the same rows in
  every scan mode (before the repair it raised CorruptStripe).
* Each of the port's read sites (the pipelined and eager scans, DML's
  raw stripe read, the point index, the stream) × each scan mode reads
  through a flipped bit: right answer, a read repair counted, the bad
  copy healed in place.
* `verify_stripe_file` and `flip_one_bit`; the scrubber's quarantine
  and re-replication, and its factor-1 report; the torn-write and
  bitflip fault points; EXPLAIN ANALYZE's Integrity line equal to the
  JAX package's; citus_stat_activity's read_repairs; restore-point
  validation.  These mirror the cases of tests/test_integrity.py.
* Factor 1: a clean CorruptStripe in every mode, never wrong rows, and
  the device-memory ledger's transient bytes back at 0.
"""

import gc
import os
import shutil

import numpy as np
import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu.storage import integrity as jintegrity
from citus_tpu_torch.catalog import Catalog
from citus_tpu_torch.errors import CorruptStripe, StorageError
from citus_tpu_torch.operations import restore_point as prestore
from citus_tpu_torch.operations.scrubber import ScrubReport, scrub_store
from citus_tpu_torch.storage import (
    StripeReader,
    TableStore,
    integrity,
    write_stripe,
)
from citus_tpu_torch.types import ColumnDef, DataType, TableSchema
from citus_tpu_torch.utils import faultinjection as pfi

torch.set_num_threads(1)

MODES = ["off", "host", "device"]
ROWS = 300
_COMMON = dict(compute_dtype="float64", serving_result_cache_bytes=0,
               retry_backoff_base_ms=1, retry_backoff_max_ms=2)


def _jax(d, **kw):
    return citus_tpu.connect(data_dir=str(d), n_devices=1,
                             exec_cache_enabled=False,
                             recover_2pc_interval_ms=-1,
                             defer_shard_delete_interval_ms=-1,
                             health_check_interval_ms=-1,
                             **{**_COMMON, **kw})


def _port(d, **kw):
    return citus_tpu_torch.connect(str(d), device="cpu",
                                   **{**_COMMON, **kw})


def _seed(s, factor=2, rows=ROWS):
    if factor > 1:
        s.execute("select citus_add_node('device:1')")
    s.execute(f"set shard_replication_factor = {factor}")
    s.execute("create table kv (id bigint, v bigint, w double precision)")
    s.execute("select create_distributed_table('kv', 'id', 4)")
    s.execute("insert into kv values " + ", ".join(
        f"({i}, {i * 10}, {i / 4})" for i in range(rows)))
    return s


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    """JAX-written data_dirs: {factor: dir} for factors 1 and 2."""
    root = tmp_path_factory.mktemp("torch_integrity")
    out = {}
    for factor in (1, 2):
        d = str(root / f"f{factor}")
        _seed(_jax(d), factor).close()
        out[factor] = d
    return out


def _copy(base, tmp_path, name):
    d = str(tmp_path / name)
    shutil.copytree(base, d)
    return d


def _primaries(d, table="kv", shard_index=None):
    """Primary stripe paths of `table` (one shard's, or every shard's)."""
    cat = Catalog.load(os.path.join(d, "catalog.json"))
    store = TableStore(d, cat)
    shards = cat.table_shards(table)
    if shard_index is not None:
        shards = [shards[shard_index]]
    return [os.path.join(store.shard_dir(table, s.shard_id), r["file"])
            for s in shards
            for r in store.manifest(table)["shards"].get(str(s.shard_id),
                                                         [])]


def _counter(s, name):
    return dict(s.execute("select citus_stat_counters()").rows())[name]


def _kv(s):
    return {int(i): (int(v), float(w))
            for i, v, w in s.execute("select id, v, w from kv").rows()}


WANT = {i: (i * 10, i / 4) for i in range(ROWS)}


# -- the repair: JAX answers, the port must too ------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_factor_two_bitflip_port_answers_like_jax(bases, tmp_path, mode):
    """The read itself repairs: with statement retries off, both packages
    answer in one attempt (before the repair the port raised
    CorruptStripe here, and with retries on it answered only through
    the envelope's failover retry, leaving the bad copy in place)."""
    jd = _copy(bases[2], tmp_path, "j")
    pd = _copy(bases[2], tmp_path, "p")
    for d in (jd, pd):
        integrity.flip_one_bit(_primaries(d, shard_index=1)[0])
    j = _jax(jd, scan_pipeline=mode, max_statement_retries=0)
    want = _kv(j)
    j.close()
    p = _port(pd, scan_pipeline=mode, max_statement_retries=0)
    try:
        assert want == WANT
        r = p.execute("select id, v, w from kv")
        assert r.retries == 0
        assert {int(i): (int(v), float(w)) for i, v, w in r.rows()} == want
        assert _counter(p, "read_repairs_total") >= 1
        assert _counter(p, "corruption_detected_total") >= 1
        integrity.verify_stripe_file(_primaries(pd, shard_index=1)[0])
    finally:
        p.close()


# -- every read site × every scan mode --------------------------------------

def _scan(s):
    assert _kv(s) == WANT


def _stream(s):
    s.execute("set max_feed_bytes_per_device = 1")
    s.execute("set stream_batch_rows = 64")
    r = s.execute("select count(*), sum(id), sum(v), sum(w) from kv")
    assert r.streamed_batches > 1
    assert r.rows() == [(ROWS, sum(WANT), sum(v for v, _w in WANT.values()),
                         sum(w for _v, w in WANT.values()))]


def _dml(s):
    s.execute("update kv set v = v + 1 where id >= 0")
    assert {i: v for i, (v, _w) in _kv(s).items()} == \
        {i: v + 1 for i, (v, _w) in WANT.items()}


def _point(s):
    # shard index 1 holds key `k`: the fast path builds its point index
    # from the shard's stripes, then reads the row's chunk
    r = s.execute(f"select v, w from kv where id = {_key_of_shard(s)}")
    k = _key_of_shard(s)
    assert r.fast_path and r.rows() == [WANT[k]]


def _key_of_shard(s, index=1):
    from citus_tpu_torch.catalog.distribution import hash_token

    sh = s.catalog.table_shards("kv")[index]
    toks = hash_token(np.arange(ROWS, dtype=np.int64))
    return int(np.flatnonzero((toks >= sh.min_value)
                              & (toks <= sh.max_value))[0])


SITES = {"scan": _scan, "stream": _stream, "dml": _dml, "point": _point}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("site", sorted(SITES))
def test_every_read_site_repairs(bases, tmp_path, site, mode):
    d = _copy(bases[2], tmp_path, "d")
    bad = _primaries(d, shard_index=1)
    for path in bad:
        integrity.flip_one_bit(path)
    # retries off: the read repairs within the statement's one attempt
    s = _port(d, scan_pipeline=mode, max_statement_retries=0)
    try:
        base = integrity.snapshot()
        SITES[site](s)
        delta = integrity.delta(base)
        assert delta["read_repairs"] >= 1
        assert delta["corruption_detected"] >= 1
        for path in bad:
            integrity.verify_stripe_file(path)  # healed in place
        # the healed placement is trusted again, and a re-read repairs
        # nothing
        assert not s.catalog._suspect_placements
        base = integrity.snapshot()
        s.execute("set max_feed_bytes_per_device = 6442450944")
        assert len(_kv(s)) == ROWS
        assert integrity.delta(base)["read_repairs"] == 0
    finally:
        s.close()


@pytest.mark.parametrize("mode", MODES)
def test_factor_one_bitflip_is_a_clean_error(bases, tmp_path, mode):
    d = _copy(bases[1], tmp_path, "d")
    integrity.flip_one_bit(_primaries(d, shard_index=1)[0])
    s = _port(d, scan_pipeline=mode, max_statement_retries=1)
    try:
        for sql in ("select id, v, w from kv",
                    "select sum(id), sum(v), sum(w) from kv"):
            with pytest.raises(CorruptStripe):
                s.execute(sql)
        gc.collect()
        assert s.executor.accountant.transient_bytes() == 0
        # the other shards still answer
        n = s.execute(f"select count(*) from kv where id = "
                      f"{_key_of_shard(s, 0)}").rows()
        assert n == [(1,)]
    finally:
        s.close()


# -- format-level checks ----------------------------------------------------

SCHEMA_COLS = [("k", DataType.INT64), ("v", DataType.FLOAT64)]


def _cols(n, rng):
    return {"k": rng.integers(0, 1 << 20, size=n).astype(np.int64),
            "v": rng.normal(size=n)}


def test_verify_stripe_file_and_flip_one_bit(tmp_path, rng):
    path = str(tmp_path / "s.ctps")
    write_stripe(path, SCHEMA_COLS, _cols(5000, rng), codec="zlib")
    integrity.verify_stripe_file(path)
    # the JAX package's verifier agrees on the same bytes
    jintegrity.verify_stripe_file(path)
    snap = str(tmp_path / "snap.ctps")
    os.link(path, snap)
    integrity.flip_one_bit(path)
    with pytest.raises(CorruptStripe):
        integrity.verify_stripe_file(path)
    with pytest.raises(Exception, match="checksum|CRC|corrupt|mismatch"):
        jintegrity.verify_stripe_file(path)
    # a new inode: a hardlinked snapshot keeps the good bytes
    integrity.verify_stripe_file(snap)
    assert os.stat(snap).st_ino != os.stat(path).st_ino
    tiny = str(tmp_path / "tiny")
    with open(tiny, "wb") as f:
        f.write(b"x" * 8)
    with pytest.raises(CorruptStripe):
        integrity.flip_one_bit(tiny)
    assert issubclass(CorruptStripe, StorageError)


def test_flip_is_the_jax_packages_flip(tmp_path, rng):
    a, b = str(tmp_path / "a.ctps"), str(tmp_path / "b.ctps")
    write_stripe(a, SCHEMA_COLS, _cols(3000, rng))
    shutil.copy(a, b)
    integrity.flip_one_bit(a)
    jintegrity.flip_one_bit(b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_truncated_stripe_fails_verification(tmp_path, rng):
    path = str(tmp_path / "s.ctps")
    write_stripe(path, SCHEMA_COLS, _cols(1000, rng))
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(CorruptStripe):
        integrity.verify_stripe_file(path)


# -- the scrubber -----------------------------------------------------------

def _store_with_replicas(tmp_path, rng, factor=2):
    cat = Catalog()
    cat.add_node("device:0")
    cat.add_node("device:1")
    schema = TableSchema(tuple(ColumnDef(n, t) for n, t in SCHEMA_COLS))
    cat.create_distributed_table("t", schema, "k", 2,
                                 replication_factor=factor)
    store = TableStore(str(tmp_path / "data"), cat)
    sid = cat.table_shards("t")[0].shard_id
    store.append_stripe("t", sid, _cols(3000, rng))
    rec = store.manifest("t")["shards"][str(sid)][0]
    return cat, store, sid, os.path.join(store.shard_dir("t", sid),
                                         rec["file"])


def test_store_read_repairs_and_heals(tmp_path, rng):
    cat, store, sid, primary = _store_with_replicas(tmp_path, rng)
    assert len(store._copy_paths("t", sid, os.path.basename(primary))) == 2
    integrity.flip_one_bit(primary)
    base = integrity.snapshot()
    _vals, _valid, n = store.read_shard("t", sid)
    assert n == 3000
    d = integrity.delta(base)
    assert d["corruption_detected"] >= 1 and d["read_repairs"] >= 1
    integrity.verify_stripe_file(primary)
    assert store._primary_owner(sid).placement_id \
        not in cat._suspect_placements


def test_scrubber_quarantines_and_rereplicates(tmp_path, rng):
    cat, store, sid, primary = _store_with_replicas(tmp_path, rng)
    integrity.flip_one_bit(primary)
    rep = scrub_store(cat, store, ScrubReport())
    assert (rep.corrupt_copies, rep.quarantined, rep.repaired,
            rep.unrepairable) == (1, 1, 1, 0)
    integrity.verify_stripe_file(primary)
    owner = store._primary_owner(sid)
    assert owner.shard_state == "active"
    assert owner.placement_id not in cat._suspect_placements
    rep2 = scrub_store(cat, store, ScrubReport())
    assert rep2.corrupt_copies == 0 and rep2.repaired == 0


def test_scrubber_factor_one_reports_unrepairable(tmp_path, rng):
    cat, store, _sid, primary = _store_with_replicas(tmp_path, rng, 1)
    integrity.flip_one_bit(primary)
    rep = scrub_store(cat, store, ScrubReport())
    assert rep.corrupt_copies == 1
    assert rep.unrepairable == 1 and rep.repaired == 0
    assert rep.quarantined == 0  # the last copy stays routable


def test_scrubber_gc_removes_aged_temps_and_orphan_replicas(tmp_path, rng):
    cat, store, sid, _primary = _store_with_replicas(tmp_path, rng)
    tmp = os.path.join(store.shard_dir("t", sid), "x.ctps.tmp.1.2")
    with open(tmp, "wb") as f:
        f.write(b"torn")
    orphan = store.replica_dir("t", 999999, 1)
    os.makedirs(orphan)
    rep = scrub_store(cat, store, ScrubReport(), temp_max_age_s=0.0)
    assert rep.temps_removed == 1 and rep.replica_dirs_removed == 1
    assert not os.path.exists(tmp) and not os.path.exists(orphan)


def test_check_cluster_udf_quarantines_like_jax(bases, tmp_path):
    out = {}
    for pkg, mk in (("jax", _jax), ("port", _port)):
        d = _copy(bases[2], tmp_path, pkg)
        primary = _primaries(d, shard_index=2)[0]
        integrity.flip_one_bit(primary)
        s = mk(d)
        r = s.execute("select citus_check_cluster(0)")
        again = s.execute("select citus_check_cluster(0)").rows()
        integrity.verify_stripe_file(primary)
        counters = dict(s.execute("select citus_stat_counters()").rows())
        out[pkg] = (r.column_names, r.rows(), again,
                    counters["scrub_runs_total"],
                    counters["scrub_repairs_total"], _kv(s))
        s.close()
    assert out["port"] == out["jax"]
    assert out["port"][1][0][4] == 1  # repaired
    assert out["port"][5] == WANT


# -- fault points -----------------------------------------------------------

def test_stripe_torn_write_retries_clean(tmp_path):
    s = _port(tmp_path / "d", max_statement_retries=2)
    try:
        s.execute("create table kv (id bigint, v bigint)")
        s.execute("select create_distributed_table('kv', 'id', 2)")
        with pfi.inject("storage.stripe_torn_write", require_fired=True):
            s.execute("insert into kv values (1, 1)")  # retried
        assert s.execute("select count(*) from kv").rows() == [(1,)]
        leftovers = [f for _r, _d, fs in os.walk(s.data_dir) for f in fs
                     if ".tmp" in f]
        assert leftovers == []
    finally:
        s.close()


@pytest.mark.parametrize("mode", MODES)
def test_stripe_bitflip_point_is_repaired(bases, tmp_path, mode):
    s = _port(_copy(bases[2], tmp_path, "d"), scan_pipeline=mode,
              max_statement_retries=0)
    try:
        base = integrity.snapshot()
        # injected corruption raises nothing: require_fired is the
        # proof that the seam was reached and the CRC path tested
        with pfi.inject("storage.stripe_bitflip", require_fired=True):
            assert _kv(s) == WANT
        assert integrity.delta(base)["read_repairs"] == 1
        assert _counter(s, "read_repairs_total") == 1
    finally:
        s.close()


# -- observability ----------------------------------------------------------

def _integrity_line(s, sql):
    lines = [r[0] for r in s.execute("explain analyze " + sql).rows()]
    return next(x for x in lines if x.startswith("Integrity:"))


@pytest.mark.parametrize("mode", ["host", "off"])
def test_explain_analyze_integrity_line_matches_jax(bases, tmp_path, mode):
    got = {}
    for pkg, mk in (("jax", _jax), ("port", _port)):
        d = _copy(bases[2], tmp_path, pkg)
        integrity.flip_one_bit(_primaries(d, shard_index=0)[0])
        s = mk(d, scan_pipeline=mode)
        got[pkg] = _integrity_line(s, "select sum(v), sum(w) from kv")
        s.close()
    assert got["port"] == got["jax"]
    assert "read repairs=1" in got["port"]


def test_stat_activity_counts_the_statements_read_repairs(bases, tmp_path,
                                                         monkeypatch):
    d = _copy(bases[2], tmp_path, "d")
    integrity.flip_one_bit(_primaries(d, shard_index=3)[0])
    s = _port(d)
    seen = []
    orig = type(s)._count_statement

    def spy(self, stmt, result):
        # runs after the statement's integrity fold, while its activity
        # row is still live
        act = self._stat_activity()
        seen.append(act.columns["read_repairs"])
        return orig(self, stmt, result)

    monkeypatch.setattr(type(s), "_count_statement", spy)
    try:
        assert _kv(s) == WANT
        assert seen[-1] == [1]
        s.execute("select count(*) from kv")
        assert seen[-1] == [0]  # per statement
    finally:
        s.close()
    j = _jax(bases[2])
    try:
        assert "read_repairs" in j.execute(
            "select citus_stat_activity()").column_names
    finally:
        j.close()


# -- restore-point validation -----------------------------------------------

def test_damaged_restore_point_refuses_and_keeps_live_data(tmp_path):
    d = str(tmp_path / "d")
    s = _port(d)
    s.execute("create table kv (id bigint, v bigint)")
    s.execute("select create_distributed_table('kv', 'id', 2)")
    s.execute("insert into kv values (1, 10), (2, 20)")
    s.execute("select citus_create_restore_point('rp1')")
    s.execute("insert into kv values (3, 30)")
    s.close()
    snap = os.path.join(d, "restore_points", "rp1", "tables", "kv")
    stripe = next(os.path.join(dp, f) for dp, _ds, fs in os.walk(snap)
                  for f in fs if f.endswith(".ctps"))
    payload = open(stripe, "rb").read()
    os.unlink(stripe)  # break the hardlink before corrupting
    with open(stripe, "wb") as f:
        f.write(payload[: len(payload) // 2])
    with pytest.raises(CorruptStripe):
        prestore.restore_cluster(d, "rp1")
    s2 = _port(d)
    try:
        assert dict(s2.execute("select id, v from kv").rows()) == \
            {1: 10, 2: 20, 3: 30}
    finally:
        s2.close()


def test_intact_restore_point_restores(tmp_path):
    d = str(tmp_path / "d")
    s = _port(d)
    s.execute("create table kv (id bigint, v bigint)")
    s.execute("select create_distributed_table('kv', 'id', 2)")
    s.execute("insert into kv values (1, 10)")
    s.execute("select citus_create_restore_point('rp1')")
    s.execute("insert into kv values (2, 20)")
    s.close()
    assert prestore.verify_restore_point(
        os.path.join(d, "restore_points", "rp1")) >= 1
    prestore.restore_cluster(d, "rp1")
    s2 = _port(d)
    try:
        assert dict(s2.execute("select id, v from kv").rows()) == {1: 10}
    finally:
        s2.close()
