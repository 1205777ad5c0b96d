"""The port's CUDA kernels and its GPU path, on the card.

Every test here needs an NVIDIA GPU and nvcc: each carries the `cuda`
marker and skips (inside the `cuda` fixture) where no GPU is visible.
The module imports neither JAX nor the JAX package, so it also runs on
the GPU machine, which has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against a numpy oracle (np.add.at in float64 / take
/ unpackbits) and the wrapper's launch count, on the shapes and data the
main path gives it (a few hot slots, slot runs, half-garbage buckets,
0.0 and -0.0 lanes) and on the edges its loads treat apart (views not
16-byte aligned, lengths not a multiple of 4, every shared-memory
layout of the dense grid, split and single-owner buckets); the
end-to-end tests hold the GPU answers to the port's own CPU answers on
the same data_dir.  Float32
sums: rtol 1e-4, atol 1e-2 (atomics add in run-dependent order); gathers,
bit unpacks and dictionary decodes exact.
"""

import numpy as np
import pytest
import torch

from citus_tpu_torch.ops import hopper_kernels as hk

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    hk.build_all()
    return torch.device("cuda")


def _to(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _k1_slots(rng, n, total, dist):
    if dist == "hot4":  # TPC-H Q1: 4 non-empty groups
        return rng.choice(rng.choice(total, 4, replace=False), n).astype(
            np.int32)
    return rng.integers(0, total + 1, n).astype(np.int32)  # incl. trash


def _k1_columns(rng, n, a, form):
    """`form` stack: one [N, A] float32 array; columns: float32, int32
    and bool columns in turn."""
    if form == "stack":
        return [rng.uniform(-50, 50, (n, a)).astype(np.float32)]
    return [rng.uniform(-50, 50, n).astype(np.float32) if j % 3 == 0
            else rng.integers(-1000, 1000, n).astype(np.int32) if j % 3 == 1
            else rng.random(n) < 0.5 for j in range(a)]


@pytest.mark.parametrize("n,total,a,form,offset,dist", [
    (100, 5, 3, "stack", 0, "uniform"),
    (200_000, 6, 7, "stack", 0, "uniform"),
    (5000, 513, 3, "stack", 0, "uniform"),
    (50_000, 20_000, 2, "stack", 0, "uniform"),  # one grid per block
    (70_001, 12, 6, "columns", 0, "hot4"),  # per-thread grids, N % 4 = 1
    (70_003, 12, 6, "columns", 1, "hot4"),     # views not 16-byte aligned
    (70_001, 64, 3, "columns", 0, "hot4"),     # per-warp grids
    (70_002, 64, 3, "columns", 1, "uniform"),
    (70_001, 293, 6, "columns", 0, "hot4"),  # the largest per-warp grid
    (70_001, 294, 6, "columns", 0, "hot4"),  # the smallest per-block grid
    (9_999, 5000, 2, "columns", 0, "uniform"),  # one grid per block
    (30_002, 70_000, 1, "columns", 1, "uniform"),  # global atomics
    (4_097, 12, 20, "columns", 0, "uniform"),  # 20 columns: two launches
    (6_001_520, 12, 6, "columns", 0, "hot4"),  # the SF1 Q1 call's shape
    (6_001_520, 12, 6, "stack", 0, "hot4"),
])
def test_dense_grid_sum_kernel(rng, cuda, n, total, a, form, offset, dist):
    slot = _k1_slots(rng, n, total, dist)
    cols = _k1_columns(rng, n, a, form)
    vals = cols[0] if form == "stack" else np.stack(
        [c.astype(np.float64) for c in cols], axis=1)
    want = np.zeros((total, a), np.float64)
    keep = slot < total
    np.add.at(want, slot[keep], vals[keep].astype(np.float64))
    args = _view_at(cols[0], offset, cuda) if form == "stack" else \
        [_view_at(c, offset, cuda) for c in cols]
    before = hk.LAUNCHES["dense_grid_sum"]
    got = hk.dense_grid_sum(_view_at(slot, offset, cuda), args, total)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["dense_grid_sum"] == before + -(-a // 16)
    got = got.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
    if form == "columns":  # int32 and bool counts are exact
        ints = [j for j in range(a) if j % 3]
        np.testing.assert_array_equal(got[:, ints], want[:, ints])


def _view_at(a, offset, dev):
    """`a` on the card as a contiguous view `offset` elements into a
    larger buffer (offset 1: not 16-byte aligned)."""
    if not offset:
        return _to(a, dev)
    flat = np.concatenate([np.zeros(offset, a.dtype), a.reshape(-1)])
    return _to(flat, dev)[offset:].view(a.shape)


@pytest.mark.parametrize("nb,tile,cap,offset", [
    (4, 256, 700, 0), (5, 1 << 15, 3333, 0), (3, 1022, 100, 0),
    (3, 1022, 101, 0),      # tile·4 not a multiple of 16, cap not of 4
    (5, 256, 1023, 0),      # cap not a multiple of 4: rows mid-vector
    (3, 256, 700, 1),       # dir2d and loc2d views, not 16-byte aligned
    (1, 1 << 15, 5, 0),     # fewer probes than a vector per thread
    (184, 1 << 15, 65280, 0),  # the SF1 main path's shapes
])
def test_bucketed_probe_kernel(rng, cuda, nb, tile, cap, offset):
    dir2d = rng.integers(-5, 10_000, (nb, tile)).astype(np.int32)
    loc2d = rng.integers(0, tile, (nb, cap)).astype(np.int32)
    before = hk.LAUNCHES["bucketed_probe"]
    got = hk.bucketed_probe(_view_at(dir2d, offset, cuda),
                            _view_at(loc2d, offset, cuda))
    torch.cuda.synchronize()
    assert hk.LAUNCHES["bucketed_probe"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.take_along_axis(dir2d, loc2d, axis=1))


@pytest.mark.parametrize("nb,cap,tile,a,layout,offset", [
    (7, 333, 128, 1, "ragged", 0),
    (30, 5000, 4096, 3, "ragged", 0),   # split buckets: zeroed output
    (2, 700, 4096, 15, "ragged", 0),    # 15 columns: split by column
    (300, 1001, 4096, 2, "half_garbage", 0),  # nb >= 264: one owner
    (300, 1003, 4096, 1, "runs", 0),    # cap % 4 != 0: rows mid-vector
    (40, 2000, 512, 2, "signed_zeros", 0),
    (280, 999, 1024, 3, "half_garbage", 1),   # views not 16-byte aligned
    (265, 4100, 4096, 5, "runs", 0),    # 5 columns: column-wise loads
    (1465, 12_288, 4096, 3, "runs", 0),  # the SF1 GROUP BY's shape
])
def test_bucketed_groupby_sums_kernel(rng, cuda, nb, cap, tile, a, layout,
                                      offset):
    loc2d = rng.integers(0, tile, (nb, cap)).astype(np.int32)
    stack = rng.uniform(-20, 20, (nb, cap, a)).astype(np.float32)
    fill = rng.integers(cap // 2, cap + 1, nb)
    if layout == "half_garbage":  # the runner's 2x capacity
        fill = rng.integers(0, cap // 2 + 1, nb)
    elif layout == "runs":  # l_orderkey order: runs of equal slots
        loc2d = np.sort(loc2d, axis=1)
    elif layout == "signed_zeros":  # valid lanes of 0.0 and -0.0
        stack[:, ::3] = 0.0
        stack[:, 1::5] = -0.0
    fill[0] = 0  # an all-garbage bucket
    for b in range(nb):  # garbage lanes: slot 0, zeroed values
        loc2d[b, fill[b]:] = 0
        stack[b, fill[b]:] = 0
    want = np.zeros((nb, tile, a), np.float64)
    for b in range(nb):
        np.add.at(want[b], loc2d[b], stack[b].astype(np.float64))
    before = hk.LAUNCHES["bucketed_groupby_sums"]
    got = hk.bucketed_groupby_sums(_view_at(loc2d, offset, cuda),
                                   _view_at(stack, offset, cuda), tile)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["bucketed_groupby_sums"] == before + -(-a // 14)
    got = got.cpu().numpy()
    assert not np.isnan(got).any()  # every cell written
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
    assert not got[0].any()


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    slot = torch.zeros(10, dtype=torch.int64, device=cuda)
    vals = torch.zeros(10, 2, device=cuda)
    with pytest.raises(TypeError):
        hk.dense_grid_sum(slot, vals, 3)
    with pytest.raises(ValueError):
        hk.dense_grid_sum(slot.to(torch.int32).cpu(), vals, 3)
    slot32 = slot.to(torch.int32)
    with pytest.raises(TypeError):  # int64 columns stay on index_add_
        hk.dense_grid_sum(slot32, [vals[:, 0], slot], 3)
    with pytest.raises(ValueError):
        hk.dense_grid_sum(slot32, [vals[:5, 0]], 3)


def test_gpu_session_matches_cpu_session(tmp_path, cuda):
    """The slice's queries on the GPU agree with the port's CPU path on
    one data_dir (small SF; the bucketed paths are forced on)."""
    import citus_tpu_torch
    import citus_tpu_torch.ops.join as pjoin
    from citus_tpu_torch.ingest import tpch

    data_dir = str(tmp_path / "d")
    cpu = citus_tpu_torch.connect(data_dir, device="cpu")
    tpch.load_into_session(cpu, sf=0.01, seed=7,
                           tables={"customer", "orders", "lineitem"})
    gpu = citus_tpu_torch.connect(data_dir)
    queries = [tpch.QUERIES["Q1"], tpch.QUERIES["Q3"],
               "select l_orderkey, count(*), sum(l_quantity) from lineitem "
               "group by l_orderkey"]
    saved = pjoin.PROBE_BUCKET_MIN_EXTENT
    pjoin.PROBE_BUCKET_MIN_EXTENT = 1 << 10
    try:
        hk.reset_launch_counts()
        for sql in queries:
            want = sorted(cpu.execute(sql).rows(), key=repr)
            got = sorted(gpu.execute(sql).rows(), key=repr)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for x, y in zip(g, w):
                    if isinstance(y, (float, np.floating)):
                        assert abs(float(x) - float(y)) <= \
                            1e-4 * max(1.0, abs(float(y)))
                    else:
                        assert x == y
    finally:
        pjoin.PROBE_BUCKET_MIN_EXTENT = saved
    # every kernel of the path: TPC-H has no NULLs, so bit_unpack is
    # held by test_device_scan_matches_cpu_session instead
    assert all(hk.LAUNCHES[k] > 0 for k in hk.KERNELS
               if k != "bit_unpack"), hk.LAUNCHES


@pytest.mark.parametrize("shape,cap,offset", [
    pytest.param((16,), 128, 0, id="shape0-128"),
    pytest.param((3, 16), 128, 0, id="shape1-128"),
    pytest.param((768,), 6144, 0, id="shape2-6144"),
    pytest.param((2, 768), 6144, 0, id="shape3-6144"),
    pytest.param((2, 768), 6100, 0, id="shape4-6100"),
    # the SF1 main path: one plane of a 6,001,520-row column
    pytest.param((750_192,), 6_001_536, 0, id="main_path"),
    pytest.param((6145,), 49_160, 1, id="odd_view"),  # packed[1:]
    pytest.param((3, 1001), 8001, 0, id="ragged_rows"),
    pytest.param((4096, 3), 17, 0, id="many_short_rows"),
    # rows starting 8 but not 16 bytes apart: every other row's first
    # packed byte is written alone
    pytest.param((5, 1001), 8008, 0, id="ragged_cap_8_mod_16"),
    pytest.param((1001,), 8008, 0, id="cap_8_mod_16"),
    pytest.param((1001,), 8005, 0, id="cap_not_8k"),
    pytest.param((1,), 1, 0, id="one_bit"),
    pytest.param((16,), 0, 0, id="cap_0"),
])
def test_bit_unpack_kernel(rng, cuda, shape, cap, offset):
    """Exact against np.unpackbits, one launch per call (none for cap
    0), and nothing written past rows·cap: the entry point, run into a
    buffer with guard bytes after it, leaves them as they were."""
    bits = rng.random(shape[:-1] + (shape[-1] * 8,)) < 0.3
    packed = np.packbits(bits, axis=-1)
    want = np.unpackbits(packed, axis=-1)[..., :cap].astype(bool)
    dev_packed = _view_at(packed, offset, cuda)
    before = hk.LAUNCHES["bit_unpack"]
    got = hk.bit_unpack(dev_packed, cap)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["bit_unpack"] == before + (1 if cap else 0)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    rows = packed.shape[0] if packed.ndim == 2 else 1
    guarded = torch.full((rows * cap + 64,), 0xAA, dtype=torch.uint8,
                         device=cuda)
    if cap:
        hk._launch("bit_unpack", dev_packed.data_ptr(), rows,
                   packed.shape[-1], cap, guarded.data_ptr())
    torch.cuda.synchronize()
    guarded = guarded.cpu().numpy()
    np.testing.assert_array_equal(guarded[:rows * cap], want.reshape(-1))
    assert (guarded[rows * cap:] == 0xAA).all()


@pytest.mark.parametrize("code_dtype,nv", [(np.uint8, 1), (np.uint8, 37),
                                           (np.uint8, 51),
                                           (np.uint16, 37),
                                           (np.uint16, 65536)])
@pytest.mark.parametrize("value_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,offset", [
    ((128,), 0), ((3, 6144), 0),
    ((1001,), 0),           # n not a multiple of 16
    ((7,), 0),              # fewer codes than one vector
    ((6145,), 1),           # codes[1:]: a view at an odd offset
    ((6_001_536,), 0),      # the SF1 main path's l_quantity column
])
def test_dict_decode_kernel(rng, cuda, nv, code_dtype, value_dtype, shape,
                            offset):
    lut = rng.uniform(-1e3, 1e3, nv).astype(value_dtype)
    codes = rng.integers(0, nv, shape).astype(code_dtype)
    before = hk.LAUNCHES["dict_decode"]
    got = hk.dict_decode(_view_at(codes, offset, cuda), _to(lut, cuda))
    torch.cuda.synchronize()
    assert hk.LAUNCHES["dict_decode"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  lut[codes.astype(np.int64)])


def _write_deletion(store, table, shard_id, record, mask):
    """Leave a stripe as a DELETE of the JAX package leaves it: a
    deletion bitmap beside the stripe and the manifest record pointing
    at it (the port reads such bitmaps; it has no DML of its own)."""
    import os

    name = f"{record['file']}.del0001.npy"
    np.save(os.path.join(store.shard_dir(table, shard_id), name), mask)
    man = store.manifest(table)
    for rec in man["shards"][str(shard_id)]:
        if rec["file"] == record["file"]:
            rec.update(deletes=name, del_version=1,
                       live_rows=int((~mask).sum()))
    store._save_manifest(table)
    store.bump_data_version(table)


def test_device_scan_matches_cpu_session(tmp_path, cuda, rng):
    """A scan_pipeline=device session on the GPU answers like the port's
    eager CPU path on one data_dir: NULLs in an int, a text and a float
    column, several stripes per shard, deleted rows and chunk-skippable
    filters.  Renamed and added columns are held against the JAX package
    on the CPU (tests/test_torch_scanpipe.py)."""
    import citus_tpu_torch
    from citus_tpu_torch.ingest.copy_from import _ingest_batch

    data_dir = str(tmp_path / "d")
    cpu = citus_tpu_torch.connect(data_dir, device="cpu",
                                  scan_pipeline="off",
                                  columnar_stripe_row_limit=1000,
                                  columnar_chunk_group_row_limit=256,
                                  columnar_compression="zlib")
    cpu.execute("create table kv (id int, v int, name text, "
                "f double precision)")
    cpu.create_distributed_table("kv", "id", shard_count=4)
    n = 6000
    ids = np.arange(n)
    cols = [ids, [None if i % 3 == 0 else int(i * 10) for i in ids],
            [None if i % 4 == 0 else f"n{i % 7}" for i in ids],
            [None if i % 5 == 0 else (i % 11) * 0.25 for i in ids]]
    _ingest_batch(cpu, "kv", ["id", "v", "name", "f"], cols, pre_typed=True)
    shard = cpu.catalog.table_shards("kv")[1].shard_id
    rec = cpu.store.shard_stripe_records("kv", shard)[0]
    _write_deletion(cpu.store, "kv", shard, rec, rng.random(rec["rows"]) < 0.4)
    gpu = citus_tpu_torch.connect(data_dir, scan_pipeline="device")
    hk.reset_launch_counts()
    for q in ["select count(*), sum(v) from kv",
              "select name, count(*), min(v) from kv group by name",
              "select count(*) from kv where v >= 15000",
              "select count(*) from kv where v is null",
              "select count(f), sum(f), count(*) from kv",
              "select count(*) from kv where id = 5999"]:
        want = sorted(cpu.execute(q).rows(), key=repr)
        got = sorted(gpu.execute(q).rows(), key=repr)
        assert len(got) == len(want), q
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                if isinstance(y, (float, np.floating)):
                    assert abs(float(x) - float(y)) <= \
                        1e-5 * max(1.0, abs(float(y))), (q, g, w)
                else:
                    assert x == y, (q, g, w)
    assert hk.LAUNCHES["bit_unpack"] > 0 and hk.LAUNCHES["dict_decode"] > 0
    assert gpu.executor.scan_stats.snapshot()["feeds_pipelined"] > 0
    assert gpu.executor.accountant.live_bytes("prefetch") == 0


def test_gpu_update_matches_cpu_session(tmp_path, cuda):
    """UPDATEs through a GPU session (a value and a NULL), then the
    read-back on the card in scan_pipeline=device, equal to the port's
    CPU session on the same data_dir.  The UPDATE arithmetic runs on the
    host in float64 in both, so the stored values are the same; the
    read-back sums are float32 on the card."""
    import citus_tpu_torch
    from citus_tpu_torch.ingest import tpch

    data_dir = str(tmp_path / "d")
    cpu = citus_tpu_torch.connect(data_dir, device="cpu",
                                  scan_pipeline="off")
    tpch.load_into_session(cpu, sf=0.01, seed=7, tables={"orders"})
    want_n = [cpu.execute(q).rows()[0][0] for q in (
        "select count(*) from orders where o_orderdate < date '1994-01-01'",
        "select count(*) from orders where o_custkey < 100")]
    gpu = citus_tpu_torch.connect(data_dir, scan_pipeline="device")
    got_n = [gpu.execute(
        "update orders set o_totalprice = o_totalprice * 1.1 "
        "where o_orderdate < date '1994-01-01'").rows()[0][0],
        gpu.execute("update orders set o_totalprice = null "
                    "where o_custkey < 100").rows()[0][0]]
    assert got_n == want_n
    hk.reset_launch_counts()
    q = ("select o_orderpriority, count(*), count(o_totalprice), "
         "sum(o_totalprice) from orders group by o_orderpriority")
    got = sorted(gpu.execute(q).rows(), key=repr)
    cpu2 = citus_tpu_torch.connect(data_dir, device="cpu",
                                   scan_pipeline="off")
    want = sorted(cpu2.execute(q).rows(), key=repr)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:3] == w[:3]
        assert abs(float(g[3]) - float(w[3])) <= 1e-4 * abs(float(w[3]))
    assert hk.LAUNCHES["bit_unpack"] > 0
    assert hk.LAUNCHES["dense_grid_sum"] > 0



def _close_rows(got, want, rtol=1e-4):
    got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if isinstance(y, (float, np.floating)):
                assert abs(float(x) - float(y)) <= \
                    rtol * max(1.0, abs(float(y)))
            else:
                assert x == y


def test_streamed_q1_launches_k1_once_per_batch(tmp_path, cuda):
    """Q1 streamed on the card in fixed 8,192-row batches: the dense-grid
    sum (K1) runs once per batch on the batch's padded rows, one
    PlanCompiler serves every batch, the answer equals the CPU session's
    and the `stream` ledger is back at 0."""
    import citus_tpu_torch
    from citus_tpu_torch.ingest import tpch

    data_dir = str(tmp_path / "d")
    cpu = citus_tpu_torch.connect(data_dir, device="cpu")
    tpch.load_into_session(cpu, sf=0.01, seed=7, tables={"lineitem"})
    want = cpu.execute(tpch.QUERIES["Q1"]).rows()
    gpu = citus_tpu_torch.connect(data_dir, scan_pipeline="device")
    gpu.execute("set max_feed_bytes_per_device = 1; "
                "set stream_batch_rows = 8192")
    hk.reset_launch_counts()
    r = gpu.execute(tpch.QUERIES["Q1"])
    assert r.streamed_batches >= 4
    assert hk.LAUNCHES["dense_grid_sum"] == r.streamed_batches
    assert gpu.executor.plan_cache.misses == 1 + r.retries
    _close_rows(r.rows(), want)
    torch.cuda.synchronize()
    assert gpu.executor.accountant.live_bytes("stream") == 0


def test_real_allocator_oom_answers_through_the_ladder(tmp_path, cuda):
    """With the caching allocator capped below Q3's resident peak, the
    card itself refuses an allocation: the torch.OutOfMemoryError is
    classified and the ladder answers, equal to the CPU session."""
    import gc

    import citus_tpu_torch
    from citus_tpu_torch.ingest import tpch

    data_dir = str(tmp_path / "d")
    cpu = citus_tpu_torch.connect(data_dir, device="cpu")
    # large enough that the plan's fixed-size buffers (tens of MiB) sit
    # well under the cap
    tpch.load_into_session(cpu, sf=0.2, seed=7,
                           tables={"customer", "orders", "lineitem"})
    q3 = tpch.QUERIES["Q3"]
    want = cpu.execute(q3).rows()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    base_alloc = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gpu = citus_tpu_torch.connect(data_dir, scan_pipeline="device",
                                  serving_result_cache_bytes=0)
    gpu.execute(q3)
    peak = torch.cuda.max_memory_allocated() - base_alloc
    gpu.executor.feed_cache.clear()
    del gpu
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    try:
        torch.cuda.set_per_process_memory_fraction(
            (base + 0.5 * peak) / total)
        gpu = citus_tpu_torch.connect(data_dir, scan_pipeline="device",
                                      serving_result_cache_bytes=0)
        acc = gpu.executor.accountant
        ooms = acc.oom_total
        r = gpu.execute(q3)
        assert acc.oom_total > ooms
        assert gpu.last_oom_rungs
        _close_rows(r.rows(), want)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)


def test_traced_statements_carry_device_legs(tmp_path, cuda):
    """On the card each dispatch span carries its CUDA event pair's
    device_ms: positive, and within the device phase (dispatch + fetch)
    of the same trace; a pipelined scan's transfers carry theirs, and a
    streamed statement's batches each one pair.  The recorder leaves no
    span open."""
    import citus_tpu_torch
    from citus_tpu_torch.ingest import tpch
    from citus_tpu_torch.stats import tracing

    data_dir = str(tmp_path / "d")
    cpu = citus_tpu_torch.connect(data_dir, device="cpu")
    tpch.load_into_session(cpu, sf=0.01, seed=7, tables={"lineitem"})
    want = cpu.execute(tpch.QUERIES["Q1"]).rows()
    gpu = citus_tpu_torch.connect(data_dir, scan_pipeline="device",
                                  trace_fast_statement_ms=0,
                                  serving_result_cache_bytes=0)
    for streamed in (False, True):
        if streamed:
            gpu.execute("set max_feed_bytes_per_device = 1; "
                        "set stream_batch_rows = 8192")
        r = gpu.execute(tpch.QUERIES["Q1"])
        _close_rows(r.rows(), want)
        doc = gpu.stats.tracing.last_trace()
        root = doc["root"]
        dispatch = []

        def walk(s):
            if s["name"] == "mesh.dispatch":
                dispatch.append(s)
            for c in s.get("children", ()):
                walk(c)

        walk(root)
        assert len(dispatch) == max(1, r.streamed_batches)
        assert all(s["meta"]["device_ms"] > 0 for s in dispatch)
        device_wall = tracing.span_seconds(root, "mesh.dispatch",
                                           "mesh.fetch") * 1e3
        assert tracing.device_ms(root) <= device_wall + 0.1
        transfers = ("stream.transfer" if streamed else "scan.transfer")
        assert tracing.device_ms(root, transfers) > 0
        assert tracing.open_span_count() == 0


def test_concurrent_sessions_under_admission(tmp_path, cuda):
    """Phase 13's W1 at sf 0.05: eight sessions in threads on the card,
    two tenants weighted a:3,b:1, two admission slots, the result cache
    off.  Each thread runs Q1, Q3 and the high-cardinality GROUP BY
    twice, the first round in device scan mode.  Every answer equals
    the port's CPU session; at most two statements execute at once;
    every statement is admitted, some queue; K1, K2, K3 and K5 launch;
    the device-memory ledger holds no transient bytes at the end."""
    import threading
    import time

    import citus_tpu_torch
    import citus_tpu_torch.ops.join as pjoin
    from citus_tpu_torch.ingest import tpch

    data_dir = str(tmp_path / "d")
    cpu = citus_tpu_torch.connect(data_dir, device="cpu",
                                  serving_result_cache_bytes=0)
    tpch.load_into_session(cpu, sf=0.05, seed=7,
                           tables={"customer", "orders", "lineitem"})
    queries = [tpch.QUERIES["Q1"], tpch.QUERIES["Q3"],
               "select l_orderkey, count(*), sum(l_quantity) from lineitem "
               "group by l_orderkey"]
    want = [cpu.execute(q).rows() for q in queries]
    sessions = [citus_tpu_torch.connect(
        data_dir, serving_result_cache_bytes=0, max_concurrent_statements=2,
        wlm_tenant="a" if i % 2 else "b", wlm_tenant_weights="a:3,b:1")
        for i in range(8)]
    mu = threading.Lock()
    live = {"now": 0, "max": 0}
    for s in sessions:
        orig = s._execute_resilient

        def counted(stmt, activity=None, timeout_ms=None, _orig=orig,
                    _s=s):
            # admitted statements only (an exempt SET runs here too)
            admitted = getattr(_s._wlm_tls, "last", None) is not None
            with mu:
                live["now"] += admitted
                live["max"] = max(live["max"], live["now"])
            try:
                return _orig(stmt, activity, timeout_ms=timeout_ms)
            finally:
                with mu:
                    live["now"] -= admitted
        s._execute_resilient = counted
    bad: list = []

    def worker(s):
        try:
            for rnd in range(2):
                s.execute("set scan_pipeline = "
                          + ("device" if rnd == 0 else "auto"))
                for q, w in zip(queries, want):
                    _close_rows(s.execute(q).rows(), w)
        except Exception as e:  # noqa: BLE001 — asserted below
            bad.append(repr(e))

    saved = pjoin.PROBE_BUCKET_MIN_EXTENT
    pjoin.PROBE_BUCKET_MIN_EXTENT = 1 << 10
    hk.reset_launch_counts()
    # the data_dir's one manager also counted the CPU session's queries
    base = sessions[0].wlm.snapshot()
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=worker, args=(s,))
                   for s in sessions]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        pjoin.PROBE_BUCKET_MIN_EXTENT = saved
    torch.cuda.synchronize()
    assert not bad, bad[:3]
    assert time.perf_counter() - t0 < 600
    assert live["max"] <= 2
    snap = sessions[0].wlm.snapshot()
    assert snap["admitted_total"] - base["admitted_total"] == \
        8 * 2 * len(queries)
    assert snap["queued_total"] > base["queued_total"]
    assert snap["slots_in_use"] == 0
    assert {"a", "b"} <= {r["tenant"] for r in snap["tenants"]}
    for k in ("dense_grid_sum", "bucketed_probe", "bucketed_groupby_sums",
              "dict_decode"):
        assert hk.LAUNCHES[k] > 0, hk.LAUNCHES
    import gc

    gc.collect()
    assert sessions[0].executor.accountant.transient_bytes() == 0


def test_result_cache_hit_launches_no_kernel(tmp_path, cuda):
    """Phase 13's C1 at sf 0.01: Q1 twice in one cuda session with the
    result cache on — the second run is a hit that launches no kernel;
    an INSERT from a second session invalidates it, and the next Q1 runs
    on the card and sees the row."""
    import citus_tpu_torch
    from citus_tpu_torch.ingest import tpch

    data_dir = str(tmp_path / "d")
    cpu = citus_tpu_torch.connect(data_dir, device="cpu")
    tpch.load_into_session(cpu, sf=0.01, seed=7, tables={"lineitem"})
    gpu = citus_tpu_torch.connect(data_dir)
    q1 = tpch.QUERIES["Q1"]
    hk.reset_launch_counts()
    first = gpu.execute(q1).rows()
    launched = dict(hk.LAUNCHES)
    assert launched["dense_grid_sum"] >= 1
    second = gpu.execute(q1).rows()
    assert second == first and hk.LAUNCHES == launched
    writer = citus_tpu_torch.connect(data_dir, device="cpu")
    writer.execute(
        "insert into lineitem select * from lineitem where l_orderkey = 1")
    third = gpu.execute(q1).rows()
    assert hk.LAUNCHES["dense_grid_sum"] > launched["dense_grid_sum"]
    _close_rows(third, cpu.execute(q1).rows())
    assert sum(int(r[-1]) for r in third) > sum(int(r[-1]) for r in first)
    counters = gpu.stats.counters.snapshot()
    assert counters["serving_cache_hits_total"] == 1
    assert counters["serving_cache_misses_total"] == 2


def test_split_on_a_warm_cuda_session(tmp_path, cuda):
    """Phase 14's O1 at sf 0.05: a cuda session warm on Q1, Q3 and the
    high-cardinality GROUP BY (device scan mode) answers them again
    after another session splits lineitem's first shard (and orders'
    with it), as does a fresh one: equal to the port's CPU session, no
    retries, K1, K2, K3 and K5 launched; the parents' directories are
    gone and the ledger holds no transient bytes."""
    import gc
    import os

    import citus_tpu_torch
    import citus_tpu_torch.ops.join as pjoin
    from citus_tpu_torch.ingest import tpch

    data_dir = str(tmp_path / "d")
    cpu = citus_tpu_torch.connect(data_dir, device="cpu",
                                  serving_result_cache_bytes=0)
    tpch.load_into_session(cpu, sf=0.05, seed=7,
                           tables={"customer", "orders", "lineitem"})
    queries = [tpch.QUERIES["Q1"], tpch.QUERIES["Q3"],
               "select l_orderkey, count(*), sum(l_quantity) from lineitem "
               "group by l_orderkey"]
    want = [cpu.execute(q).rows() for q in queries]
    saved = pjoin.PROBE_BUCKET_MIN_EXTENT
    pjoin.PROBE_BUCKET_MIN_EXTENT = 1 << 10
    try:
        warm = citus_tpu_torch.connect(data_dir, scan_pipeline="device",
                                       serving_result_cache_bytes=0)
        for _ in range(2):
            for q, w in zip(queries, want):
                _close_rows(warm.execute(q).rows(), w)
        shard = cpu.catalog.table_shards("lineitem")[0]
        parent = os.path.join(data_dir, "tables", "lineitem",
                              f"shard_{shard.shard_id}")
        mid = (shard.min_value + shard.max_value) // 2
        cpu.execute(f"select citus_split_shard_by_split_points("
                    f"{shard.shard_id}, '{mid}')")
        assert not os.path.isdir(parent)
        fresh = citus_tpu_torch.connect(data_dir, scan_pipeline="device",
                                        serving_result_cache_bytes=0)
        hk.reset_launch_counts()
        for sess in (warm, fresh):
            for q, w in zip(queries, want):
                r = sess.execute(q)
                assert r.retries == 0, q
                _close_rows(r.rows(), w)
            assert len(sess.catalog.table_shards("orders")) == 9
    finally:
        pjoin.PROBE_BUCKET_MIN_EXTENT = saved
    for k in ("dense_grid_sum", "bucketed_probe", "bucketed_groupby_sums",
              "dict_decode"):
        assert hk.LAUNCHES[k] > 0, hk.LAUNCHES
    for s in (warm, fresh, cpu):
        s.close()
    gc.collect()
    assert warm.executor.accountant.transient_bytes() == 0


def test_read_repair_in_device_scan_mode(tmp_path, cuda):
    """Phase 14's O3 at sf 0.05: a replication-factor-2 copy of the
    nullable columns, the bitflip fault point armed once, the nullable
    aggregate in device scan mode: the CPU session's answer, one read
    repair, every copy verifying after, K4 and K5 launched, and EXPLAIN
    ANALYZE's Integrity line counting the repair.  A flip in a
    factor-1 table gives a clean CorruptStripe, with no transient
    ledger bytes left."""
    import gc

    import citus_tpu_torch
    from citus_tpu_torch.errors import CorruptStripe
    from citus_tpu_torch.storage import integrity
    from citus_tpu_torch.utils.faultinjection import inject

    data_dir = str(tmp_path / "d")
    cpu = citus_tpu_torch.connect(data_dir, device="cpu",
                                  serving_result_cache_bytes=0)
    cpu.execute("select citus_add_node('extra:1')")
    cpu.execute("set shard_replication_factor = 2")
    cpu.execute("create table r2 (d date, flag text, disc double "
                "precision, tax double precision)")
    cpu.create_distributed_table("r2", "d", shard_count=8)
    cpu.execute("set shard_replication_factor = 1")
    cpu.execute("create table r1 (d date, flag text, disc double "
                "precision, tax double precision)")
    cpu.create_distributed_table("r1", "d", shard_count=8)
    from citus_tpu_torch.ingest.copy_from import _ingest_batch

    rng = np.random.default_rng(5)
    n = 300_000
    cols = [rng.integers(8000, 10500, n).astype(np.int32),
            [("A", "N", "R")[i] for i in rng.integers(0, 3, n)],
            [None if x < 0.1 else round(x, 2) for x in rng.random(n)],
            [None if x < 0.1 else round(x / 10, 2) for x in rng.random(n)]]
    for t in ("r1", "r2"):
        _ingest_batch(cpu, t, ["d", "flag", "disc", "tax"], cols,
                      pre_typed=True)
    # every column read, so the flipped bit lies in a chunk the
    # statement verifies
    sql = ("select flag, count(*), count(disc), sum(disc), sum(tax), "
           "min(d) from {} group by flag order by 1")
    want = cpu.execute(sql.format("r2")).rows()
    gpu = citus_tpu_torch.connect(data_dir, scan_pipeline="device",
                                  serving_result_cache_bytes=0,
                                  max_statement_retries=0)
    hk.reset_launch_counts()
    with inject("storage.stripe_bitflip", require_fired=True):
        got = gpu.execute(sql.format("r2")).rows()
    _close_rows(got, want)
    counters = gpu.stats.counters.snapshot()
    assert counters["read_repairs_total"] == 1
    for s in gpu.catalog.table_shards("r2"):
        for rec in gpu.store.manifest("r2")["shards"][str(s.shard_id)]:
            for p in gpu.store._copy_paths("r2", s.shard_id, rec["file"]):
                integrity.verify_stripe_file(p)
    assert hk.LAUNCHES["bit_unpack"] > 0 and hk.LAUNCHES["dict_decode"] > 0
    fresh = citus_tpu_torch.connect(data_dir, scan_pipeline="device",
                                    serving_result_cache_bytes=0)
    with inject("storage.stripe_bitflip", require_fired=True):
        lines = [r[0] for r in fresh.execute(
            "explain analyze " + sql.format("r2")).rows()]
    assert any(x.startswith("Integrity:") and "read repairs=1" in x
               for x in lines), lines
    with inject("storage.stripe_bitflip", require_fired=True):
        with pytest.raises(CorruptStripe):
            fresh.execute(sql.format("r1"))
    for s in (gpu, fresh, cpu):
        s.close()
    gc.collect()
    assert gpu.executor.accountant.transient_bytes() == 0


# -- the compiled form: CUDA graphs (executor/graphs.py) ------------------------

NN_SQL = ("select g, count(*), count(v), sum(v) from nn group by g "
          "order by g")


def _graph_dir(tmp_path):
    """A small TPC-H data_dir plus a table with NULLs, the CPU session's
    answers, and the four main-path statements."""
    import citus_tpu_torch
    from citus_tpu_torch.ingest import tpch

    data_dir = str(tmp_path / "d")
    cpu = citus_tpu_torch.connect(data_dir, device="cpu",
                                  serving_result_cache_bytes=0)
    tpch.load_into_session(cpu, sf=0.01, seed=7,
                           tables={"customer", "orders", "lineitem"})
    cpu.execute("create table nn (k bigint, g int, v double precision)")
    cpu.execute("select create_distributed_table('nn', 'k', 4)")
    cpu.execute("insert into nn values " + ", ".join(
        f"({i}, {i % 5}, {'null' if i % 3 == 0 else i * 0.5})"
        for i in range(3000)))
    queries = {"Q1": tpch.QUERIES["Q1"], "Q3": tpch.QUERIES["Q3"],
               "groupby": "select l_orderkey, count(*), sum(l_quantity) "
                          "from lineitem group by l_orderkey",
               "nullable": NN_SQL}
    want = {q: cpu.execute(sql).rows() for q, sql in queries.items()}
    cpu.close()
    return data_dir, queries, want


class _Eager:
    """Inside the block a session runs its plans through the compiler's
    own eager dispatch."""

    def __init__(self, sess):
        self.ex = sess.executor

    def __enter__(self):
        self.ex._graph_for = lambda *a, **k: None

    def __exit__(self, *exc):
        del self.ex._graph_for


@pytest.fixture
def bucketed():
    import citus_tpu_torch.ops.join as pjoin

    saved = pjoin.PROBE_BUCKET_MIN_EXTENT
    pjoin.PROBE_BUCKET_MIN_EXTENT = 1 << 10
    yield
    pjoin.PROBE_BUCKET_MIN_EXTENT = saved


def test_replay_equals_eager_for_the_main_path(tmp_path, cuda, bucketed):
    """Q1, Q3, the GROUP BY and a nullable aggregate: the first run
    settles, the second captures, later runs replay; replayed rows equal
    the eager run's and the CPU session's, and each replay counts the
    launches its graph makes."""
    import citus_tpu_torch

    data_dir, queries, want = _graph_dir(tmp_path)
    gpu = citus_tpu_torch.connect(data_dir, serving_result_cache_bytes=0)
    for q, sql in queries.items():
        seen = []
        for _ in range(3):
            _close_rows(gpu.execute(sql).rows(), want[q])
            seen.append(gpu.executor.last_dispatch()[0])
        assert seen == ["eager", "captured", "replayed"], (q, seen)
        with _Eager(gpu):
            eager = gpu.execute(sql).rows()
            assert gpu.executor.last_dispatch()[0] == "eager"
        hk.reset_launch_counts()
        _close_rows(gpu.execute(sql).rows(), eager)
        torch.cuda.synchronize()
        carried = {"Q1": ["dense_grid_sum"], "Q3": ["bucketed_probe"],
                   "groupby": ["bucketed_groupby_sums"],
                   "nullable": ["dense_grid_sum"]}[q]
        for k in carried:
            assert hk.LAUNCHES[k] >= 1, (q, hk.LAUNCHES)
    acc = gpu.executor.accountant
    assert acc.graph_count() == 4 and acc.live_bytes("graph") > 0
    assert acc.transient_bytes() == 0
    gpu.close()


def test_insert_between_replays_gives_the_new_answer(tmp_path, cuda):
    import citus_tpu_torch

    data_dir, _queries, _want = _graph_dir(tmp_path)
    gpu = citus_tpu_torch.connect(data_dir, serving_result_cache_bytes=0)
    for _ in range(3):
        before = gpu.execute(NN_SQL).rows()
    assert gpu.executor.last_dispatch()[0] == "replayed"
    g = next(iter(gpu.executor.plan_cache._graphs.values()))
    gpu.execute("insert into nn values (9001, 0, 1000.0)")
    after = gpu.execute(NN_SQL).rows()
    assert not g.live
    with _Eager(gpu):
        eager = gpu.execute(NN_SQL).rows()
    _close_rows(after, eager)
    assert after[0][1] == before[0][1] + 1
    gpu.close()


def test_oom_ladder_frees_the_graph_pools(tmp_path, cuda):
    import citus_tpu_torch

    data_dir, queries, want = _graph_dir(tmp_path)
    gpu = citus_tpu_torch.connect(data_dir, serving_result_cache_bytes=0)
    acc = gpu.executor.accountant
    acc.release_graphs()
    before = acc.live_bytes("graph")
    for sql in (queries["Q1"], queries["groupby"]):
        for _ in range(2):
            gpu.execute(sql)
    assert acc.live_bytes("graph") > before and acc.graph_count() == 2
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    assert gpu.executor._evict_for_oom() >= 2
    torch.cuda.synchronize()
    assert acc.live_bytes("graph") == before and acc.graph_count() == 0
    assert torch.cuda.memory_reserved() < reserved
    _close_rows(gpu.execute(queries["Q1"]).rows(), want["Q1"])
    gpu.close()


def test_two_threads_replaying_one_key_get_their_rows(tmp_path, cuda):
    import threading

    import citus_tpu_torch

    data_dir, queries, want = _graph_dir(tmp_path)
    sessions = [citus_tpu_torch.connect(data_dir,
                                        serving_result_cache_bytes=0)
                for _ in range(2)]
    for s in sessions:
        for _ in range(2):
            s.execute(queries["Q1"])
    errors = []

    def run(s):
        try:
            for _ in range(20):
                _close_rows(s.execute(queries["Q1"]).rows(), want["Q1"])
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(s,))
               for s in sessions + sessions]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        assert not t.is_alive()
    assert not errors, errors
    # one capture served both sessions
    assert sessions[0].executor.accountant.graph_count() == 1
    for s in sessions:
        s.close()


def test_an_adopted_graph_outlives_its_capturer(tmp_path, cuda):
    """Session A captures a plan with IN lists (list constants its
    compiler uploaded outside the graph's pool), session B adopts the
    graph, A closes and fresh allocations take whatever memory was
    freed: B's replays still equal its eager run and the CPU session."""
    import gc

    import citus_tpu_torch

    data_dir, _queries, _want = _graph_dir(tmp_path)
    sql = ("select o_orderstatus, count(*), sum(o_totalprice) from orders "
           "where o_custkey in (" + ", ".join(
               str(k) for k in range(1, 1500, 7)) + ") and "
           "o_orderpriority in ('1-URGENT', '3-MEDIUM', '5-LOW') "
           "group by 1 order by 1")
    cpu = citus_tpu_torch.connect(data_dir, device="cpu",
                                  serving_result_cache_bytes=0)
    want = cpu.execute(sql).rows()
    cpu.close()
    a = citus_tpu_torch.connect(data_dir, serving_result_cache_bytes=0)
    b = citus_tpu_torch.connect(data_dir, serving_result_cache_bytes=0)
    for _ in range(2):
        _close_rows(a.execute(sql).rows(), want)
    assert a.executor.last_dispatch()[0] == "captured"
    for _ in range(2):
        _close_rows(b.execute(sql).rows(), want)
    assert b.executor.last_dispatch()[0] == "replayed"  # adopted
    g = next(iter(b.executor.plan_cache._graphs.values()))
    assert g._consts  # the IN lists it reads
    a.close()
    del a
    gc.collect()
    torch.cuda.synchronize()
    scribble = [torch.full((n,), -7, dtype=torch.int64, device="cuda")
                for n in (64, 128, 256, 512, 1024) for _ in range(64)]
    for _ in range(3):
        got = b.execute(sql).rows()
        assert b.executor.last_dispatch()[0] == "replayed"
        _close_rows(got, want)
    with _Eager(b):
        _close_rows(b.execute(sql).rows(), got)
    del scribble
    b.close()


def test_a_capture_that_fails_on_cuda_raises(tmp_path, cuda, monkeypatch):
    """A host synchronization inside the dispatch is illegal under
    capture: the statement raises, it does not fall back to eager."""
    import citus_tpu_torch
    from citus_tpu_torch.executor.compiler import PlanCompiler

    data_dir, queries, _want = _graph_dir(tmp_path)
    gpu = citus_tpu_torch.connect(data_dir, serving_result_cache_bytes=0,
                                  max_statement_retries=0)
    gpu.execute(NN_SQL)  # settles the key
    real = PlanCompiler._dispatch

    def syncing(self, plan, feeds):
        out = real(self, plan, feeds)
        out[1].sum().item()  # a host read of a device value
        return out

    monkeypatch.setattr(PlanCompiler, "_dispatch", syncing)
    with pytest.raises(Exception, match="captur"):
        gpu.execute(NN_SQL)
    monkeypatch.setattr(PlanCompiler, "_dispatch", real)
    torch.cuda.synchronize()
    gpu.close()


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_positions_on_one_card_match_the_cpu_session(tmp_path, cuda,
                                                          bucketed, n):
    """N mesh positions on cuda:0 after citus_rebalance_mesh: the four
    main-path statements answer the CPU session's rows, the hand kernels
    launch (K1, K2, K3 once per position, K4 and K5 once per column for
    every position), every plan runs eager, and no transient ledger
    bytes stay."""
    import citus_tpu_torch

    data_dir, queries, want = _graph_dir(tmp_path)
    gpu = citus_tpu_torch.connect(data_dir, n_devices=n,
                                  serving_result_cache_bytes=0,
                                  scan_pipeline="device")
    gpu.execute("select citus_rebalance_mesh()")
    assert gpu.mesh.single_device() and gpu.n_devices == n
    hk.reset_launch_counts()
    for q, sql in queries.items():
        for _ in range(2):
            _close_rows(gpu.execute(sql).rows(), want[q])
            assert gpu.executor.last_dispatch() == ("eager", "mesh")
    torch.cuda.synchronize()
    for k in ("dense_grid_sum", "bucketed_probe", "bucketed_groupby_sums",
              "bit_unpack", "dict_decode"):
        assert hk.LAUNCHES[k] >= 1, (k, hk.LAUNCHES)
    r = gpu.execute(queries["Q1"])
    assert len(r.device_rows_in) == n and min(r.device_rows_in) > 0
    assert gpu.executor.accountant.transient_bytes() == 0
    gpu.close()
