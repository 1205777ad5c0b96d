"""The port's pipelined columnar scan (citus_tpu_torch/executor/scanpipe.py)
and its accounted placement seam (executor/hbm.py), on CPU torch.

* Encoder parity: the port's wire encodings are byte-identical to the
  JAX package's on seeded buffers, and the frame-of-reference expand
  inverts them for every wire width.
* Directed parity: a data_dir written by a JAX session with NULLs,
  DELETE, UPDATE, RENAME COLUMN and ADD COLUMN (the cases of
  tests/test_scan_pipeline.py) answers identically in the port's
  `off`, `host`, `device` and `auto` scan modes, and like the JAX
  session (floats within 1e-9; both sides sum float64).
* TPC-H parity: Q1, Q3 and the high-cardinality GROUP BY in `device`
  mode match the JAX package.
* Accounting: a producer failure ends the statement with its own error,
  leaves no producer thread and no prefetch bytes; a prefetch OOM sheds
  to the eager path with the same answer; device mode shrinks the wire;
  the feed cache hits pipelined feeds and releases its charge on
  eviction.

The JAX sessions run with n_devices=1, exec_cache_enabled=False and
serving_result_cache_bytes=0: the persistent executable cache can load
an executable built for another mesh width in the same process.
"""

import gc
import threading

import numpy as np
import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu.executor.scanpipe import encode_column as jax_encode_column
from citus_tpu.ingest import tpch as jtpch
from citus_tpu_torch.errors import DeviceMemoryExhausted
from citus_tpu_torch.executor import scanpipe
from citus_tpu_torch.executor.hbm import (
    DeviceMemoryAccountant,
    accountant_for,
    is_resource_exhausted,
    oom_budget,
)
from citus_tpu_torch.ingest import tpch as ptpch
from oracle import compare_results

torch.set_num_threads(1)

TOL = 1e-9
JAX_OPTS = dict(n_devices=1, exec_cache_enabled=False,
                serving_result_cache_bytes=0, compute_dtype="float64")

DIRECTED = [
    "SELECT count(*), sum(val) FROM kv",
    "SELECT name, count(*), min(val) FROM kv GROUP BY name",
    "SELECT count(*) FROM kv WHERE val >= 15000",
    "SELECT count(*) FROM kv WHERE extra IS NULL",
    "SELECT sum(extra) FROM kv",
    "SELECT count(*) FROM kv WHERE id = 9001",
    "SELECT count(f), sum(f), count(*) FROM kv",
    "SELECT name, sum(f), count(val) FROM kv WHERE val >= 100 GROUP BY name",
]


def _prefetch_bytes(data_dir) -> int:
    """Live prefetch-category bytes, read with no gc: a failed
    statement's traceback must not pin any prefetch charge."""
    return accountant_for(data_dir).live_bytes("prefetch")


def _port(data_dir, mode, **kw):
    return citus_tpu_torch.connect(data_dir, device="cpu",
                                   compute_dtype="float64",
                                   serving_result_cache_bytes=0,
                                   scan_pipeline=mode, **kw)


def _producers():
    return [t for t in threading.enumerate()
            if t.name == "scan-prefetch" and t.is_alive()]


# ---------------------------------------------------------------------------
# wire encodings

def _buffers():
    rng = np.random.default_rng(11)
    lut32 = np.array([0.02, 0.05, 1.5, 900.0], dtype=np.float32)
    return {
        "int32_u8": rng.integers(-100, 100, 5000).astype(np.int32),
        "int32_u16": rng.integers(8000, 11000, 5000).astype(np.int32),
        "int64_u8": rng.integers(0, 200, 5000).astype(np.int64),
        "int64_u16": np.arange(1000, 1500, dtype=np.int64),
        "int64_u32": rng.integers(-(1 << 30), 1 << 30, 5000)
        .astype(np.int64),
        "int64_wide_span": np.array([0, 1 << 40], dtype=np.int64),
        "int32_full_span": np.array([-(1 << 31), (1 << 31) - 1],
                                    dtype=np.int32),
        "f32_low_ndv": lut32[rng.integers(0, 4, 8192)],
        "f64_low_ndv": np.round(rng.integers(0, 11, 8192) * 0.01, 2),
        "f64_1000_values": rng.integers(0, 1000, 20000) * 0.5,
        "f32_nan": np.array([1.0, np.nan] * 100, dtype=np.float32),
        "f32_distinct": np.arange(70000, dtype=np.float32) * 1.5,
        "f64_sampled_distinct": rng.standard_normal(300_000),
        "bool": rng.random(300) < 0.5,
        "empty_int64": np.zeros(0, dtype=np.int64),
    }


@pytest.mark.parametrize("name", sorted(_buffers()))
def test_encode_column_matches_jax(name):
    buf = _buffers()[name]
    kind, wire, extra = scanpipe.encode_column(buf)
    jkind, jwire, jextra = jax_encode_column(buf)
    assert kind == jkind
    assert wire.dtype == jwire.dtype
    assert wire.tobytes() == jwire.tobytes()
    if extra is None:
        assert jextra is None
    else:
        assert extra.dtype == jextra.dtype
        assert extra.tobytes() == jextra.tobytes()


@pytest.mark.parametrize("name,wire_dtype", [("int32_u8", np.uint8),
                                             ("int32_u16", np.uint16),
                                             ("int64_u16", np.uint16),
                                             ("int64_u32", np.uint32)])
def test_for_expand_inverts_the_encoding(name, wire_dtype):
    buf = _buffers()[name]
    kind, wire, base = scanpipe.encode_column(buf)
    assert kind == "for" and wire.dtype == wire_dtype
    got = scanpipe.for_expand(torch.from_numpy(wire), base)
    assert got.dtype == torch.from_numpy(buf).dtype
    np.testing.assert_array_equal(got.numpy(), buf)


@pytest.mark.parametrize("setting,device,want", [
    ("auto", "cpu", "host"), ("auto", "cuda", "device"),
    ("off", "cuda", "off"), ("host", "cuda", "host"),
    ("device", "cpu", "device")])
def test_auto_resolves_by_the_session_device(setting, device, want):
    from citus_tpu_torch.config import Settings

    assert scanpipe.resolve_scan_mode(Settings({"scan_pipeline": setting}),
                                      torch.device(device)) == want


# ---------------------------------------------------------------------------
# directed parity against the JAX package

@pytest.fixture(scope="module")
def directed_dir(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("scanpipe_directed"))
    sess = citus_tpu.connect(data_dir=data_dir, scan_pipeline="off",
                             **JAX_OPTS)
    sess.execute("CREATE TABLE kv (id INT, v INT, name TEXT, "
                 "f DOUBLE PRECISION)")
    sess.execute("SELECT create_distributed_table('kv', 'id', 4)")
    sess.execute("INSERT INTO kv VALUES " + ", ".join(
        f"({i}, {i * 10}, "
        + ("NULL" if i % 3 == 0 else f"'n{i % 7}'") + ", "
        + ("NULL" if i % 5 == 0 else f"{(i % 11) * 0.25}") + ")"
        for i in range(6000)))
    sess.execute("DELETE FROM kv WHERE id < 300")
    sess.execute("UPDATE kv SET v = v + 1 WHERE id >= 1500")
    sess.execute("ALTER TABLE kv RENAME COLUMN v TO val")
    sess.execute("ALTER TABLE kv ADD COLUMN extra INT")
    sess.execute("INSERT INTO kv VALUES (9001, 7, 'zz', 1.5, 42)")
    want = {q: sess.execute(q).rows() for q in DIRECTED}
    sess.close()
    return data_dir, want


@pytest.mark.parametrize("mode", ["off", "host", "device", "auto"])
def test_directed_parity(directed_dir, mode):
    data_dir, want = directed_dir
    eager = _port(data_dir, "off")
    sess = _port(data_dir, mode)
    for q in DIRECTED:
        got = sess.execute(q).rows()
        compare_results(got, want[q], False, TOL)
        assert sorted(got, key=repr) == sorted(eager.execute(q).rows(),
                                               key=repr), q
    snap = sess.executor.scan_stats.snapshot()
    assert (snap["feeds_pipelined"] > 0) == (mode != "off")
    assert _prefetch_bytes(data_dir) == 0


def test_device_mode_shrinks_wire_bytes(directed_dir):
    data_dir, _want = directed_dir
    sess = _port(data_dir, "device")
    sess.execute("SELECT count(f), sum(f), count(*), sum(val) FROM kv")
    snap = sess.executor.scan_stats.snapshot()
    assert snap["feeds_pipelined"] == 1
    assert 0 < snap["bytes_on_wire"] < snap["bytes_decoded"]
    assert snap["chunks_prefetched"] > 0
    host = _port(data_dir, "host")
    host.execute("SELECT count(f), sum(f), count(*), sum(val) FROM kv")
    hsnap = host.executor.scan_stats.snapshot()
    assert hsnap["bytes_on_wire"] == hsnap["bytes_decoded"] \
        == snap["bytes_decoded"]


def test_auto_keeps_small_tables_eager(tmp_path):
    data_dir = str(tmp_path / "small")
    jsess = citus_tpu.connect(data_dir=data_dir, **JAX_OPTS)
    jsess.execute("CREATE TABLE t (k BIGINT, v DOUBLE PRECISION)")
    jsess.execute("SELECT create_distributed_table('t', 'k', 2)")
    jsess.execute("INSERT INTO t VALUES " + ", ".join(
        f"({i}, {i * 0.5})" for i in range(100)))
    jsess.close()
    auto = _port(data_dir, "auto")
    host = _port(data_dir, "host")
    q = "SELECT count(*), sum(v) FROM t"
    assert auto.execute(q).rows() == host.execute(q).rows()
    assert auto.executor.scan_stats.snapshot()["feeds_pipelined"] == 0
    assert host.executor.scan_stats.snapshot()["feeds_pipelined"] == 1


# ---------------------------------------------------------------------------
# TPC-H parity in device mode

TPCH = {
    "q1": ptpch.QUERIES["Q1"],
    "q3": ptpch.QUERIES["Q3"],
    "high_card_groupby": "select l_orderkey, count(*), sum(l_quantity) "
                         "from lineitem group by l_orderkey",
}


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("scanpipe_tpch"))
    sess = citus_tpu.connect(data_dir=data_dir, **JAX_OPTS)
    jtpch.load_into_session(sess, sf=0.002, seed=7)
    want = {k: sess.execute(q).rows() for k, q in TPCH.items()}
    sess.close()
    return data_dir, want


@pytest.mark.parametrize("name", sorted(TPCH))
def test_tpch_device_mode_matches_jax(tpch_dir, name):
    data_dir, want = tpch_dir
    sess = _port(data_dir, "device")
    got = sess.execute(TPCH[name]).rows()
    assert len(got) > 0
    compare_results(got, want[name], "order by" in TPCH[name].lower(), TOL)
    snap = sess.executor.scan_stats.snapshot()
    assert snap["feeds_pipelined"] >= 1
    assert snap["bytes_on_wire"] < snap["bytes_decoded"]


def test_tpch_q1_device_mode_decodes_dictionaries(tpch_dir, monkeypatch):
    """Q1's l_quantity, l_discount and l_tax cross the wire as uint8
    dictionary codes and expand through the dict_decode wrapper (at this
    scale l_extendedprice is low-NDV enough for uint16 codes too)."""
    from citus_tpu_torch.ops import hopper_kernels as hk

    data_dir, want = tpch_dir
    seen = []
    real = hk.dict_decode

    def spy(codes, lut):
        seen.append((codes.dtype, lut.numel()))
        return real(codes, lut)

    monkeypatch.setattr(hk, "dict_decode", spy)
    sess = _port(data_dir, "device")
    compare_results(sess.execute(TPCH["q1"]).rows(), want["q1"], True, TOL)
    assert sorted(n for dt, n in seen if dt == torch.uint8) == [9, 11, 51]


# ---------------------------------------------------------------------------
# accounting: failures, OOM shedding, the feed cache

@pytest.mark.parametrize("where", ["first_pass", "later_column"])
def test_producer_failure_drains_cleanly(directed_dir, monkeypatch, where):
    """A stripe-column read raises: in the first pass, or while a later
    column assembles with earlier ones placed and queued."""
    data_dir, want = directed_dir
    monkeypatch.setattr(scanpipe, "PREFETCH_DEPTH", 4)
    # no statement retry: the read failure must reach the caller
    sess = _port(data_dir, "device", max_statement_retries=0)
    n_tasks = sum(len(sess.store.shard_stripe_records("kv", s.shard_id))
                  for s in sess.catalog.table_shards("kv"))
    fail_on = 1 if where == "first_pass" else n_tasks + 2
    real = scanpipe._ScanPipeline._read_stripe_column
    calls = {"n": 0}

    def flaky(self, ti, cname, first):
        calls["n"] += 1
        if calls["n"] == fail_on:
            raise OSError(f"injected read failure at read {fail_on}")
        return real(self, ti, cname, first)

    monkeypatch.setattr(scanpipe._ScanPipeline, "_read_stripe_column",
                        flaky)
    q = "SELECT count(f), sum(f), count(val), sum(val) FROM kv"
    with pytest.raises(OSError, match=f"at read {fail_on}"):
        sess.execute(q)
    assert calls["n"] == fail_on
    assert _producers() == []
    assert _prefetch_bytes(data_dir) == 0
    assert sess.executor.scan_stats.snapshot()["feeds_pipelined"] == 0
    monkeypatch.setattr(scanpipe._ScanPipeline, "_read_stripe_column", real)
    compare_results(sess.execute(q).rows(),
                    _port(data_dir, "off").execute(q).rows(), False, 0.0)


@pytest.mark.parametrize("mode", ["host", "device"])
def test_prefetch_oom_sheds_to_eager(directed_dir, mode):
    """The first charge through the seam (the producer's first
    placement) OOMs: the pipeline drains and the eager path answers."""
    data_dir, want = directed_dir
    q = DIRECTED[-1]
    sess = _port(data_dir, mode, max_cached_feed_bytes=0)
    with oom_budget(sess.executor.accountant, fail_at=1) as sim:
        got = sess.execute(q).rows()
    assert sim.oom_raised == 1
    assert sim.journal[0][1] == "prefetch"
    compare_results(got, want[q], False, TOL)
    assert sess.executor.scan_stats.snapshot()["feeds_pipelined"] == 0
    assert _producers() == []
    assert _prefetch_bytes(data_dir) == 0


def test_placement_oom_once_sheds_to_eager(directed_dir, monkeypatch):
    data_dir, want = directed_dir
    q = DIRECTED[0]
    sess = _port(data_dir, "host", max_cached_feed_bytes=0)
    real = DeviceMemoryAccountant.place_tracked
    raised = []

    def once(self, host, device, category="feed"):
        if category == "prefetch" and not raised:
            raised.append(category)
            raise DeviceMemoryExhausted("injected allocator OOM")
        return real(self, host, device, category)

    monkeypatch.setattr(DeviceMemoryAccountant, "place_tracked", once)
    compare_results(sess.execute(q).rows(), want[q], False, TOL)
    assert raised == ["prefetch"]
    assert sess.executor.scan_stats.snapshot()["feeds_pipelined"] == 0
    assert _prefetch_bytes(data_dir) == 0


def test_feed_cache_hits_pipelined_feeds_and_releases_on_evict(
        directed_dir):
    data_dir, want = directed_dir
    sess = _port(data_dir, "device")
    acc = sess.executor.accountant
    gc.collect()  # earlier tests' sessions (and their caches) are garbage
    cache_before = acc.live_bytes("cache")
    q = "SELECT sum(f) FROM kv WHERE val >= 0"
    first = sess.execute(q).rows()
    hits = sess.executor.feed_cache.hits
    assert sess.execute(q).rows() == first
    assert sess.executor.feed_cache.hits == hits + 1
    assert sess.executor.scan_stats.snapshot()["feeds_pipelined"] == 1
    assert acc.live_bytes("cache") > cache_before
    assert acc.live_bytes("feed") == 0
    sess.executor.feed_cache.clear()
    gc.collect()
    assert acc.live_bytes("cache") == cache_before


def test_accountant_ledger():
    acc = DeviceMemoryAccountant("/nonexistent")
    t, h = acc.place_tracked(np.zeros(100, np.int32), "cpu", "prefetch")
    assert acc.live_bytes("prefetch") == 400
    acc.recharge(h, "feed")
    assert acc.live_bytes("prefetch") == 0 and acc.live_bytes("feed") == 400
    out = torch.ones(10, dtype=torch.float64)
    acc.adopt(out, "cache")
    assert acc.live_bytes() == 480
    del t, out
    gc.collect()
    assert acc.live_bytes() == 0
    snap = acc.snapshot()
    assert snap["charges_total"] == 2 and snap["releases_total"] == 2
    assert snap["peak_bytes"] == 480
    with oom_budget(acc, budget=1000) as sim:
        keep = acc.place(np.zeros(200, np.int32), "cpu")
        with pytest.raises(DeviceMemoryExhausted):
            acc.place(np.zeros(100, np.int32), "cpu")
        assert sim.oom_raised == 1
        assert acc.budget_bytes() == 1000
    assert acc.budget_bytes("cpu") == 0
    del keep
    assert acc.live_bytes() == 0
    assert is_resource_exhausted(torch.cuda.OutOfMemoryError("x"))
    assert not is_resource_exhausted(ValueError("x"))


@pytest.mark.parametrize("fail_at", [1, 3])
def test_consumer_failure_releases_prefetch(directed_dir, monkeypatch,
                                            fail_at):
    """Adopting the fail_at-th payload raises on the statement thread:
    the producer places nothing more, and neither the queue nor the
    failed statement's traceback keeps a prefetch charge alive."""
    data_dir, want = directed_dir
    monkeypatch.setattr(scanpipe, "PREFETCH_DEPTH", 4)
    sess = _port(data_dir, "device", max_cached_feed_bytes=0)
    real = scanpipe._ScanPipeline._finish_col
    calls = {"n": 0}

    def failing(self, payload):
        calls["n"] += 1
        if calls["n"] == fail_at:
            raise RuntimeError(f"injected decode failure at {fail_at}")
        return real(self, payload)

    monkeypatch.setattr(scanpipe._ScanPipeline, "_finish_col", failing)
    q = "SELECT count(f), sum(f), count(val), sum(val), count(name) FROM kv"
    with pytest.raises(RuntimeError, match=f"failure at {fail_at}") as err:
        sess.execute(q)
    assert _producers() == []
    assert _prefetch_bytes(data_dir) == 0
    del err
    monkeypatch.setattr(scanpipe._ScanPipeline, "_finish_col", real)
    compare_results(sess.execute(q).rows(),
                    _port(data_dir, "off").execute(q).rows(), False, 0.0)
