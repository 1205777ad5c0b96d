"""The five Hopper kernels' plain versions vs the JAX Pallas kernels.

On the CPU each wrapper in citus_tpu_torch/ops/hopper_kernels.py runs
its plain PyTorch version (the tensor lies on the CPU); that version is
held here against the Pallas kernel it replaces, run with
interpret=True exactly as tests/test_pallas_kernels.py runs it, and
against the numpy oracles in citus_tpu/ops/pallas_kernels.py.
Tolerances: float32 sums at rtol 1e-5, atol 1e-3 (another summation
order); the probe gather, the bit unpack and the dictionary decode
exact.  Shapes cover the padding edges: cap not a multiple of 512,
total + 1 crossing 512, empty buckets and garbage lanes, 1-D and 2-D
planes, and luts of 1 to 65,536 values; the edges the CUDA kernels
treat apart: a probe cap not a multiple of 4 and a tile of 1022 slots
(not 16-byte sized), codes whose count is not a multiple of 16 and a
contiguous view of codes at an odd offset; and the data the main path
gives the two sums: a few hot slots, one slot, ascending runs and only
trash rows for the dense grid, whose columns may also come as float32,
int32 and bool vectors; half-garbage buckets, slot runs and valid lanes
of 0.0 and -0.0 for the bucketed sums.

The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from citus_tpu.ops.pallas_kernels import (
    bit_unpack_pallas,
    bit_unpack_reference,
    bucketed_groupby_sums_pallas,
    bucketed_probe_pallas,
    dense_grid_aggregate_pallas,
    dict_decode_pallas,
    dict_decode_reference,
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


def _k1_slots(rng, n, total, dist):
    """Slot columns of the shapes the main path gives K1."""
    if dist == "hot4":  # TPC-H Q1: 4 non-empty groups in a wider grid
        return rng.choice(rng.choice(total, 4, replace=False), n).astype(
            np.int32)
    if dist == "one_slot":
        return np.full(n, total // 2, np.int32)
    if dist == "runs":  # ascending runs of equal slots
        return np.sort(rng.integers(0, total, n)).astype(np.int32)
    if dist == "all_trash":  # every row invalid (parked at slot total)
        return np.full(n, total, np.int32)
    return rng.integers(0, total + 1, n).astype(np.int32)  # incl. trash


def _k1_inputs(rng, n, total, a, dist="uniform"):
    slot = _k1_slots(rng, n, total, dist)
    vals = rng.uniform(-50, 50, (n, a)).astype(np.float32)
    return slot, vals


def _k1_columns(rng, n, a):
    """A float32, int32 and bool columns in turn, as the dense aggregate
    passes its sums, counts and row masks."""
    cols = []
    for j in range(a):
        if j % 3 == 0:
            cols.append(rng.uniform(-50, 50, n).astype(np.float32))
        elif j % 3 == 1:
            cols.append(rng.integers(-1000, 1000, n).astype(np.int32))
        else:
            cols.append(rng.random(n) < 0.5)
    return cols


def _k2_inputs(rng, nb, tile, cap):
    dir2d = rng.integers(-5, 10_000, (nb, tile)).astype(np.int32)
    loc2d = rng.integers(0, tile, (nb, cap)).astype(np.int32)
    if nb > 2:
        loc2d[1] = 0  # an empty bucket: garbage lanes only
    return dir2d, loc2d


def _k3_inputs(rng, nb, cap, tile, a, layout="ragged"):
    loc2d = rng.integers(0, tile, (nb, cap)).astype(np.int32)
    stack = rng.uniform(-20, 20, (nb, cap, a)).astype(np.float32)
    # garbage lanes: slot 0 with zeroed values, as pack_by_target emits
    fill = rng.integers(0, cap + 1, nb)
    if layout == "half_garbage":  # the runner's 2x capacity: tails >= 1/2
        fill = rng.integers(0, cap // 2 + 1, nb)
    elif layout == "runs":  # l_orderkey order: runs of 1-7 equal slots
        loc2d = np.sort(loc2d, axis=1)
    elif layout == "signed_zeros":  # valid lanes holding 0.0 and -0.0
        stack[:, ::3] = 0.0
        stack[:, 1::5] = -0.0
    if nb > 1:
        fill[0] = 0  # an empty bucket
    for b in range(nb):
        loc2d[b, fill[b]:] = 0
        stack[b, fill[b]:] = 0
    return loc2d, stack


@pytest.mark.parametrize("n,total,a,dist", [
    pytest.param(100, 5, 3, "uniform", id="100-5-3"),    # tiny, sub-tile
    pytest.param(3000, 16, 2, "uniform", id="3000-16-2"),  # multi-tile
    pytest.param(5000, 513, 3, "uniform", id="5000-513-3"),  # crosses 512
    pytest.param(2048, 1023, 1, "uniform", id="2048-1023-1"),  # 1024 exactly
    pytest.param(4099, 64, 6, "hot4", id="hot4"),       # 4 hot slots of 64
    pytest.param(1001, 12, 3, "one_slot", id="one_slot"),
    pytest.param(2050, 300, 2, "runs", id="runs"),
    pytest.param(777, 12, 2, "all_trash", id="all_trash"),
])
def test_dense_grid_sum_plain_matches_pallas(rng, n, total, a, dist):
    _pallas()
    slot, vals = _k1_inputs(rng, n, total, a, dist)
    got = hk.dense_grid_sum(T(slot), T(vals), total).numpy()
    np.testing.assert_allclose(got, segment_sum_reference(slot, vals, total),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(dense_grid_aggregate_pallas(
        slot, vals, total, interpret=True)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dist", ["uniform", "hot4", "one_slot", "runs",
                                  "all_trash"])
def test_dense_grid_sum_columns_match_stack(rng, dist):
    """The column form (float32, int32 and bool columns, some of them
    strided views) sums what the [N, A] float32 stack of the same values
    sums, and what the Pallas kernel and the numpy oracle sum; integer
    columns exactly."""
    _pallas()
    n, total, a = 2051, 64, 6
    slot = _k1_slots(rng, n, total, dist)
    cols = _k1_columns(rng, n, a)
    stack = np.stack([c.astype(np.float32) for c in cols], axis=1)
    tcols = [T(c) for c in cols]
    tcols[0] = T(np.repeat(cols[0], 2))[::2]  # a view of stride 2
    got = hk.dense_grid_sum(T(slot), tcols, total).numpy()
    np.testing.assert_array_equal(
        got, hk.dense_grid_sum(T(slot), T(stack), total).numpy())
    want = segment_sum_reference(slot, stack, total)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ints = [j for j in range(a) if j % 3]  # int32 and bool: exact
    np.testing.assert_array_equal(got[:, ints], want[:, ints])
    np.testing.assert_allclose(got, np.asarray(dense_grid_aggregate_pallas(
        slot, stack, total, interpret=True)), rtol=RTOL, atol=ATOL)


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
    (3, 1022, 101),     # tile·4 not a multiple of 16, cap not of 4
    (5, 256, 1023),     # cap not a multiple of 4: rows start mid-vector
])
def test_bucketed_probe_plain_matches_pallas(rng, nb, tile, cap):
    _pallas()
    dir2d, loc2d = _k2_inputs(rng, nb, tile, cap)
    got = hk.bucketed_probe(T(dir2d), T(loc2d)).numpy()
    np.testing.assert_array_equal(got, probe_gather_reference(dir2d, loc2d))
    np.testing.assert_array_equal(got, np.asarray(bucketed_probe_pallas(
        dir2d, loc2d, interpret=True)))


@pytest.mark.parametrize("nb,cap,tile,a,layout", [
    pytest.param(1, 100, 64, 3, "ragged", id="1-100-64-3"),  # one bucket
    pytest.param(7, 333, 128, 1, "ragged", id="7-333-128-1"),  # ragged cap
    pytest.param(3, 1100, 512, 5, "ragged", id="3-1100-512-5"),  # row tiles
    pytest.param(5, 1001, 256, 2, "half_garbage", id="half_garbage"),
    pytest.param(4, 700, 128, 2, "runs", id="runs"),
    pytest.param(3, 999, 64, 3, "signed_zeros", id="signed_zeros"),
])
def test_bucketed_groupby_sums_plain_matches_pallas(rng, nb, cap, tile, a,
                                                    layout):
    _pallas()
    loc2d, stack = _k3_inputs(rng, nb, cap, tile, a, layout)
    got = hk.bucketed_groupby_sums(T(loc2d), T(stack), tile).numpy()
    np.testing.assert_allclose(got, groupby_sums_reference(loc2d, stack,
                                                           tile),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(bucketed_groupby_sums_pallas(
        loc2d, stack, tile, interpret=True)), rtol=RTOL, atol=ATOL)
    if nb > 1:
        assert not got[0].any()  # the all-garbage bucket sums to zero


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
    pytest.param((5, 1001), 8008, 0, id="ragged_cap_8_mod_16"),
    pytest.param((1001,), 8008, 0, id="cap_8_mod_16"),
    pytest.param((1001,), 8005, 0, id="cap_not_8k"),
    pytest.param((1,), 1, 0, id="one_bit"),
    pytest.param((16,), 0, 0, id="cap_0"),
])
def test_bit_unpack_plain_matches_pallas(rng, shape, cap, offset):
    _pallas()
    bits = rng.random(shape[:-1] + (shape[-1] * 8,)) < 0.3
    packed = np.packbits(bits, axis=-1)
    # a contiguous view `offset` bytes into a larger buffer
    view = T(np.concatenate([np.zeros(offset, np.uint8),
                             packed.reshape(-1)]))[offset:].view(shape)
    got = hk.bit_unpack(view, cap).numpy()
    assert got.dtype == np.bool_ and got.shape == shape[:-1] + (cap,)
    np.testing.assert_array_equal(got, bit_unpack_reference(packed, cap))
    p2 = packed.reshape(1, -1) if packed.ndim == 1 else packed
    want = np.asarray(bit_unpack_pallas(p2, cap, interpret=True))
    np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("code_dtype,nv", [(np.uint8, 1), (np.uint8, 37),
                                           (np.uint16, 37),
                                           (np.uint16, 65536)])
@pytest.mark.parametrize("value_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,offset", [
    pytest.param((128,), 0, id="shape0"),
    pytest.param((2, 6144), 0, id="shape1"),
    pytest.param((1001,), 0, id="n_not_16k"),    # n not a multiple of 16
    pytest.param((6145,), 1, id="odd_view"),     # codes[1:]: odd offset
])
def test_dict_decode_plain_matches_pallas(rng, code_dtype, nv, value_dtype,
                                          shape, offset):
    _pallas()
    lut = rng.uniform(-1e3, 1e3, nv).astype(value_dtype)
    full = rng.integers(0, nv, offset + int(np.prod(shape))).astype(
        code_dtype)
    codes = full[offset:].reshape(shape)
    view = T(full)[offset:].view(shape)  # a contiguous view, like codes[1:]
    assert view.is_contiguous() and view.storage_offset() == offset
    got = hk.dict_decode(view, T(lut)).numpy()
    assert got.dtype == value_dtype
    np.testing.assert_array_equal(got, dict_decode_reference(codes, lut))
    c2 = codes.reshape(1, -1) if codes.ndim == 1 else codes
    want = np.asarray(dict_decode_pallas(c2, lut, interpret=True))
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_cpu_tensors_take_the_plain_version_without_counting(rng):
    hk.reset_launch_counts()
    slot, vals = _k1_inputs(rng, 64, 3, 2)
    hk.dense_grid_sum(T(slot), T(vals), 3)
    dir2d, loc2d = _k2_inputs(rng, 2, 64, 10)
    hk.bucketed_probe(T(dir2d), T(loc2d))
    loc, stack = _k3_inputs(rng, 2, 10, 64, 1)
    hk.bucketed_groupby_sums(T(loc), T(stack), 64)
    hk.bit_unpack(T(np.packbits(rng.random(128) < 0.5)), 128)
    hk.dict_decode(T(np.zeros(10, np.uint8)), T(np.ones(3, np.float32)))
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
