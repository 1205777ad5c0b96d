"""The port's CUDA kernels and its GPU path, on the card.

Every test here needs an NVIDIA GPU and nvcc: each carries the `cuda`
marker and skips (inside the `cuda` fixture) where no GPU is visible.
The module imports neither JAX nor the JAX package, so it also runs on
the GPU machine, which has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against a numpy oracle (np.add.at / take) and the
wrapper's launch count; the end-to-end test holds the GPU answers to the
port's own CPU answers on the same data_dir.  Float32 sums: rtol 1e-4,
atol 1e-2 (atomics add in run-dependent order); gathers exact.
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


@pytest.mark.parametrize("nb,tile,cap", [(4, 256, 700), (5, 1 << 15, 3333),
                                         (3, 1022, 100)])
def test_bucketed_probe_kernel(rng, cuda, nb, tile, cap):
    dir2d = rng.integers(-5, 10_000, (nb, tile)).astype(np.int32)
    loc2d = rng.integers(0, tile, (nb, cap)).astype(np.int32)
    got = hk.bucketed_probe(_to(dir2d, cuda), _to(loc2d, cuda))
    torch.cuda.synchronize()
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
    assert all(v > 0 for v in hk.LAUNCHES.values()), hk.LAUNCHES
