"""The port's CUDA kernels and its GPU path, on the card.

Every test here needs an NVIDIA GPU and nvcc: each carries the `cuda`
marker and skips (inside the `cuda` fixture) where no GPU is visible.
The module imports neither JAX nor the JAX package, so it also runs on
the GPU machine, which has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against a numpy oracle (np.add.at / take /
unpackbits) and the wrapper's launch count; the end-to-end tests hold the
GPU answers to the port's own CPU answers on the same data_dir.  Float32
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


@pytest.mark.parametrize("n,total,a", [(100, 5, 3), (200_000, 6, 7),
                                       (5000, 513, 3), (50_000, 20_000, 2)])
def test_dense_grid_sum_kernel(rng, cuda, n, total, a):
    slot = rng.integers(0, total + 1, n).astype(np.int32)  # incl. trash
    vals = rng.uniform(-50, 50, (n, a)).astype(np.float32)
    want = np.zeros((total, a), np.float64)
    keep = slot < total
    np.add.at(want, slot[keep], vals[keep].astype(np.float64))
    before = hk.LAUNCHES["dense_grid_sum"]
    got = hk.dense_grid_sum(_to(slot, cuda), _to(vals, cuda), total)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["dense_grid_sum"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-4,
                               atol=1e-2)


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


@pytest.mark.parametrize("nb,cap,tile,a", [(7, 333, 128, 1),
                                           (30, 5000, 4096, 3),
                                           (2, 700, 4096, 15)])
def test_bucketed_groupby_sums_kernel(rng, cuda, nb, cap, tile, a):
    loc2d = rng.integers(0, tile, (nb, cap)).astype(np.int32)
    stack = rng.uniform(-20, 20, (nb, cap, a)).astype(np.float32)
    loc2d[0, cap // 2:] = 0  # garbage lanes: slot 0, zeroed values
    stack[0, cap // 2:] = 0
    want = np.zeros((nb, tile, a), np.float64)
    for b in range(nb):
        np.add.at(want[b], loc2d[b], stack[b].astype(np.float64))
    got = hk.bucketed_groupby_sums(_to(loc2d, cuda), _to(stack, cuda), tile)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-4,
                               atol=1e-2)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    slot = torch.zeros(10, dtype=torch.int64, device=cuda)
    vals = torch.zeros(10, 2, device=cuda)
    with pytest.raises(TypeError):
        hk.dense_grid_sum(slot, vals, 3)
    with pytest.raises(ValueError):
        hk.dense_grid_sum(slot.to(torch.int32).cpu(), vals, 3)


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


@pytest.mark.parametrize("shape,cap", [((16,), 128), ((3, 16), 128),
                                       ((768,), 6144), ((2, 768), 6144),
                                       ((2, 768), 6100)])
def test_bit_unpack_kernel(rng, cuda, shape, cap):
    bits = rng.random(shape[:-1] + (shape[-1] * 8,)) < 0.3
    packed = np.packbits(bits, axis=-1)
    before = hk.LAUNCHES["bit_unpack"]
    got = hk.bit_unpack(_to(packed, cuda), cap)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["bit_unpack"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.unpackbits(packed, axis=-1)[..., :cap]
                                  .astype(bool))


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
