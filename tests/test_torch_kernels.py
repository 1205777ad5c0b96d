"""The three Hopper kernels' plain versions vs the JAX Pallas kernels.

On the CPU each wrapper in citus_tpu_torch/ops/hopper_kernels.py runs
its plain PyTorch version (the tensor lies on the CPU); that version is
held here against the Pallas kernel it replaces, run with
interpret=True exactly as tests/test_pallas_kernels.py runs it, and
against the numpy oracles in citus_tpu/ops/pallas_kernels.py.
Tolerances: float32 sums at rtol 1e-5, atol 1e-3 (another summation
order); the probe gather exact.  Shapes cover the padding edges: cap not
a multiple of 512, total + 1 crossing 512, empty buckets and garbage
lanes.

The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from citus_tpu.ops.pallas_kernels import (
    bucketed_groupby_sums_pallas,
    bucketed_probe_pallas,
    dense_grid_aggregate_pallas,
    groupby_sums_reference,
    pallas_available,
    probe_gather_reference,
    segment_sum_reference,
)
from citus_tpu_torch.ops import hopper_kernels as hk

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-3


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pallas():
    if not pallas_available():
        pytest.skip("pallas unavailable")


def _k1_inputs(rng, n, total, a):
    slot = rng.integers(0, total + 1, n).astype(np.int32)  # incl. trash
    vals = rng.uniform(-50, 50, (n, a)).astype(np.float32)
    return slot, vals


def _k2_inputs(rng, nb, tile, cap):
    dir2d = rng.integers(-5, 10_000, (nb, tile)).astype(np.int32)
    loc2d = rng.integers(0, tile, (nb, cap)).astype(np.int32)
    if nb > 2:
        loc2d[1] = 0  # an empty bucket: garbage lanes only
    return dir2d, loc2d


def _k3_inputs(rng, nb, cap, tile, a):
    loc2d = rng.integers(0, tile, (nb, cap)).astype(np.int32)
    stack = rng.uniform(-20, 20, (nb, cap, a)).astype(np.float32)
    # garbage lanes: slot 0 with zeroed values, as pack_by_target emits
    fill = rng.integers(0, cap + 1, nb)
    if nb > 1:
        fill[0] = 0  # an empty bucket
    for b in range(nb):
        loc2d[b, fill[b]:] = 0
        stack[b, fill[b]:] = 0
    return loc2d, stack


@pytest.mark.parametrize("n,total,a", [
    (100, 5, 3),        # tiny, sub-tile
    (3000, 16, 2),      # multi-tile rows
    (5000, 513, 3),     # total + 1 crosses a 512 chunk
    (2048, 1023, 1),    # total + 1 exactly 1024
])
def test_dense_grid_sum_plain_matches_pallas(rng, n, total, a):
    _pallas()
    slot, vals = _k1_inputs(rng, n, total, a)
    got = hk.dense_grid_sum(T(slot), T(vals), total).numpy()
    np.testing.assert_allclose(got, segment_sum_reference(slot, vals, total),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(dense_grid_aggregate_pallas(
        slot, vals, total, interpret=True)), rtol=RTOL, atol=ATOL)


def test_dense_grid_sum_plain_large_uses_scatter(rng):
    # past the one-hot size bound the plain version scatters; same sums
    slot, vals = _k1_inputs(rng, 40_000, 2000, 2)
    np.testing.assert_allclose(
        hk.dense_grid_sum_plain(T(slot), T(vals), 2000).numpy(),
        segment_sum_reference(slot, vals, 2000), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nb,tile,cap", [
    (1, 128, 100),      # cap below one probe chunk
    (4, 256, 700),      # ragged cap, an empty bucket
    (3, 1024, 1536),    # cap a multiple of the chunk
])
def test_bucketed_probe_plain_matches_pallas(rng, nb, tile, cap):
    _pallas()
    dir2d, loc2d = _k2_inputs(rng, nb, tile, cap)
    got = hk.bucketed_probe(T(dir2d), T(loc2d)).numpy()
    np.testing.assert_array_equal(got, probe_gather_reference(dir2d, loc2d))
    np.testing.assert_array_equal(got, np.asarray(bucketed_probe_pallas(
        dir2d, loc2d, interpret=True)))


@pytest.mark.parametrize("nb,cap,tile,a", [
    (1, 100, 64, 3),      # single bucket, tile below one chunk
    (7, 333, 128, 1),     # ragged cap, empty + partly filled buckets
    (3, 1100, 512, 5),    # cap crosses a row tile
])
def test_bucketed_groupby_sums_plain_matches_pallas(rng, nb, cap, tile, a):
    _pallas()
    loc2d, stack = _k3_inputs(rng, nb, cap, tile, a)
    got = hk.bucketed_groupby_sums(T(loc2d), T(stack), tile).numpy()
    np.testing.assert_allclose(got, groupby_sums_reference(loc2d, stack,
                                                           tile),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(bucketed_groupby_sums_pallas(
        loc2d, stack, tile, interpret=True)), rtol=RTOL, atol=ATOL)


def test_cpu_tensors_take_the_plain_version_without_counting(rng):
    hk.reset_launch_counts()
    slot, vals = _k1_inputs(rng, 64, 3, 2)
    hk.dense_grid_sum(T(slot), T(vals), 3)
    dir2d, loc2d = _k2_inputs(rng, 2, 64, 10)
    hk.bucketed_probe(T(dir2d), T(loc2d))
    loc, stack = _k3_inputs(rng, 2, 10, 64, 1)
    hk.bucketed_groupby_sums(T(loc), T(stack), 64)
    assert hk.LAUNCHES == {n: 0 for n in hk.KERNELS}


def test_every_kernel_has_a_source_with_its_note():
    import os

    for name, (src, entry, sig) in hk.KERNELS.items():
        path = os.path.join(hk._CSRC, src)
        with open(path) as f:
            text = f.read()
        assert f'extern "C" int {entry}(' in text
        head = text.split(f'extern "C" int {entry}(')[1].split(")")[0]
        assert head.count(",") == len(sig)  # sig + the stream
        assert "Replaces: citus_tpu/ops/pallas_kernels.py" in text
        assert "Bound on H100" in text and "Design:" in text
