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

