"""Port device ops vs the JAX package's, on CPU torch.

Same inputs (numpy, fixed seed) through citus_tpu.ops.* and
citus_tpu_torch.ops.*:

* hashing — bit-exact against catalog.distribution.hash_token and
  hash_token_jax on int32/int64/float32/float64/bool, including
  negatives, extremes and NaN bit patterns;
* partition.pack_by_target — exact (counting-rank and sort packs);
* join — dense_unique_lookup, bucketed_unique_lookup and
  expand_join_pairs, exact;
* aggregate.segment_aggregate and groupby.bucketed_grid_aggregate (JAX
  side kernel='xla') — float64 at rtol 1e-12 (same sums, other order),
  float32 at rtol 1e-5 (f32 accumulation in another order); integers
  exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from citus_tpu.catalog.distribution import hash_token as np_hash_token
from citus_tpu.ops import aggregate as jagg
from citus_tpu.ops import groupby as jgroupby
from citus_tpu.ops import hashing as jhash
from citus_tpu.ops import join as jjoin
from citus_tpu.ops import partition as jpart
from citus_tpu_torch.ops import aggregate as pagg
from citus_tpu_torch.ops import groupby as pgroupby
from citus_tpu_torch.ops import hashing as phash
from citus_tpu_torch.ops import join as pjoin
from citus_tpu_torch.ops import partition as ppart

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jcall(fn, *arrays, **static):
    """Run a JAX op under one jit (static keyword arguments): one
    compilation instead of one per eager primitive keeps the suite
    fast."""
    return jax.jit(functools.partial(fn, **static))(*arrays)


def N(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- hashing ----------------------------------------------------------------

def _hash_inputs(rng):
    i32 = np.iinfo(np.int32)
    i64 = np.iinfo(np.int64)
    nan_bits = np.array([0x7FC00000, 0xFFC00001, 0x7F800001],
                        dtype=np.uint32).view(np.float32)
    nan64 = np.array([0x7FF8000000000000, 0xFFF0000000000001],
                     dtype=np.uint64).view(np.float64)
    return {
        "int32": np.concatenate([
            rng.integers(i32.min, i32.max, 500, dtype=np.int32),
            np.array([0, -1, 1, i32.min, i32.max], np.int32)]),
        "int64": np.concatenate([
            rng.integers(i64.min, i64.max, 500, dtype=np.int64),
            rng.integers(-1000, 1000, 100).astype(np.int64),
            np.array([0, -1, 1, i64.min, i64.max, i32.min, i32.max,
                      1 << 32, -(1 << 32)], np.int64)]),
        "float32": np.concatenate([
            rng.standard_normal(300).astype(np.float32),
            np.array([0.0, -0.0, np.inf, -np.inf], np.float32), nan_bits]),
        "float64": np.concatenate([
            rng.standard_normal(300) * 1e6,
            np.array([0.0, -0.0, np.inf, -np.inf]), nan64]),
        "bool": rng.integers(0, 2, 64).astype(bool),
    }


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64",
                                   "bool"])
def test_hash_token_bit_exact(rng, dtype):
    v = _hash_inputs(rng)[dtype]
    got = N(phash.hash_token(T(v)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np_hash_token(v))
    np.testing.assert_array_equal(got, np.asarray(
        jhash.hash_token_jax(jnp.asarray(v))))


def test_shard_index_and_tile_buckets(rng):
    tok = rng.integers(-(1 << 31), (1 << 31) - 1, 1000, dtype=np.int64) \
        .astype(np.int32)
    for shards in (1, 3, 8, 32):
        np.testing.assert_array_equal(
            N(phash.shard_index_from_token(T(tok), shards)),
            np.asarray(jhash.shard_index_from_token(jnp.asarray(tok),
                                                    shards)))
    slots = rng.integers(0, 1 << 20, 1000).astype(np.int64)
    b, loc = phash.tile_buckets(T(slots), 4096)
    jb, jl = jhash.tile_buckets(jnp.asarray(slots), 4096)
    np.testing.assert_array_equal(N(b), np.asarray(jb))
    np.testing.assert_array_equal(N(loc), np.asarray(jl))


# -- partition --------------------------------------------------------------

@pytest.mark.parametrize("n,n_targets,capacity", [
    (1000, 8, 160),     # counting-rank pack, some targets overflow
    (1000, 8, 400),     # counting-rank pack, all fit
    (3000, 100, 40),    # sort pack
    (777, 33, 64),      # just past the counting bound
])
def test_pack_by_target_exact(rng, n, n_targets, capacity):
    target = rng.integers(0, n_targets, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    cols = {"a": rng.integers(-50, 50, n).astype(np.int64),
            "b": rng.standard_normal(n).astype(np.float32)}
    jp, jv, jo = jcall(jpart.pack_by_target,
                       {k: jnp.asarray(v) for k, v in cols.items()},
                       jnp.asarray(valid), jnp.asarray(target),
                       n_targets=n_targets, capacity=capacity)
    pp, pv, po = ppart.pack_by_target(
        {k: T(v) for k, v in cols.items()}, T(valid), T(target), n_targets,
        capacity)
    np.testing.assert_array_equal(N(pv), np.asarray(jv))
    assert int(po) == int(jo)
    for k in cols:
        np.testing.assert_array_equal(N(pp[k]), np.asarray(jp[k]))


# -- join -------------------------------------------------------------------

def _unique_build(rng, m, extent, base):
    keys = rng.permutation(extent)[:m].astype(np.int64) + base
    matchable = rng.random(m) < 0.95
    return keys, matchable


@pytest.mark.parametrize("dup", [False, True])
def test_dense_unique_lookup_exact(rng, dup):
    base, extent, m, n = 100, 5000, 1200, 3000
    bkey, bmatch = _unique_build(rng, m, extent, base)
    if dup:
        bkey[5] = bkey[7]  # stale uniqueness: must surface as oob
    pkey = rng.integers(base - 50, base + extent + 50, n).astype(np.int64)
    jb, jc, jo = jcall(jjoin.dense_unique_lookup, jnp.asarray(bkey),
                       jnp.asarray(bmatch), jnp.asarray(pkey), base=base,
                       extent=extent)
    pb, pc, po = pjoin.dense_unique_lookup(T(bkey), T(bmatch), T(pkey),
                                           base, extent)
    assert int(po) == int(jo)
    assert (int(po) > 0) == dup
    np.testing.assert_array_equal(N(pc), np.asarray(jc))
    hit = N(pc) > 0
    if not dup:
        np.testing.assert_array_equal(N(pb)[hit], np.asarray(jb)[hit])


@pytest.mark.parametrize("extent,cap", [
    ((1 << 15) * 3 + 17, 700),   # ragged last tile, roomy buckets
    ((1 << 15) * 2, 150),        # buckets overflow → reported, not lost
])
def test_bucketed_unique_lookup_exact(rng, extent, cap):
    base, m, n = -20, 20000, 1200
    bkey, bmatch = _unique_build(rng, m, extent, base)
    pkey = rng.integers(base - 10, base + extent + 10, n).astype(np.int64)
    pkey[:200] = pkey[0]  # a hot key: skew in one bucket
    jres = jcall(jjoin.bucketed_unique_lookup, jnp.asarray(bkey),
                 jnp.asarray(bmatch), jnp.asarray(pkey), base=base,
                 extent=extent, bucket_cap=cap, kernel="xla")
    pres = pjoin.bucketed_unique_lookup(T(bkey), T(bmatch), T(pkey), base,
                                        extent, cap)
    jb, jc, jo, jov, jfill = (np.asarray(x) for x in jres)
    pb, pc, po, pov, pfill = (N(x) for x in pres)
    assert int(po) == int(jo)
    assert int(pov) == int(jov)
    assert int(pfill) == int(jfill)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pb[pc > 0], jb[jc > 0])
    # and against the single-gather lookup where nothing overflowed
    if int(pov) == 0:
        db, dc, _ = pjoin.dense_unique_lookup(T(bkey), T(bmatch), T(pkey),
                                              base, extent)
        np.testing.assert_array_equal(pc, N(dc))


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("capacity", [4000, 900])
def test_expand_join_pairs_exact(rng, dense, capacity):
    m, n = 600, 700
    bkey = rng.integers(0, 300, m).astype(np.int64)
    pkey = rng.integers(-10, 310, n).astype(np.int64)
    bmatch = rng.random(m) < 0.9
    pvalid = rng.random(n) < 0.9
    d = (0, 300) if dense else None
    jres = jcall(jjoin.expand_join_pairs, [jnp.asarray(bkey)],
                 jnp.asarray(bmatch), [jnp.asarray(pkey)],
                 jnp.asarray(pvalid), jnp.asarray(pvalid),
                 capacity=capacity, probe_outer=False, dense=d)
    pres = pjoin.expand_join_pairs([T(bkey)], T(bmatch), [T(pkey)],
                                   T(pvalid), T(pvalid), capacity, False,
                                   dense=d)
    jb, jp, jv, _jm, jov, _jd = (np.asarray(x) for x in jres)
    pb, pp, pv, _pm, pov, _pd = (N(x) for x in pres)
    assert int(pov) == int(jov)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pp[pv], jp[jv])
    np.testing.assert_array_equal(pb[pv], jb[jv])


def test_multi_key_binary_search_join(rng):
    m, n = 400, 500
    bk = [rng.integers(0, 20, m).astype(np.int64),
          rng.integers(0, 20, m).astype(np.int32)]
    pk = [rng.integers(0, 21, n).astype(np.int64),
          rng.integers(0, 21, n).astype(np.int32)]
    bvalid = rng.random(m) < 0.9
    jres = jcall(jjoin.expand_join, [jnp.asarray(k) for k in bk],
                 jnp.asarray(bvalid), [jnp.asarray(k) for k in pk],
                 jnp.ones(n, bool), capacity=4096)
    pres = pjoin.expand_join([T(k) for k in bk], T(bvalid),
                             [T(k) for k in pk], torch.ones(n, dtype=bool),
                             4096)
    jv, pv = np.asarray(jres[2]), N(pres[2])
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(N(pres[1])[pv], np.asarray(jres[1])[jv])
    assert int(pres[3]) == int(jres[3])


# -- aggregation ------------------------------------------------------------

def _agg_values(rng, n, fdt):
    return [
        (rng.standard_normal(n).astype(fdt) * 100, "sum",
         rng.random(n) < 0.9),
        (rng.integers(-1000, 1000, n).astype(np.int64), "sum", None),
        (np.ones(n, np.int64), "count", rng.random(n) < 0.8),
        (rng.standard_normal(n).astype(fdt), "min", rng.random(n) < 0.9),
        (rng.integers(-1000, 1000, n).astype(np.int32), "max", None),
    ]


def _assert_agg_close(got, want, fdt):
    rtol = 1e-12 if fdt == np.float64 else 1e-5
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fdt", [np.float64, np.float32])
@pytest.mark.parametrize("packed", [False, True])
def test_segment_aggregate_matches_jax(rng, fdt, packed):
    n = 2000
    keys = [rng.integers(0, 40, n).astype(np.int64),
            rng.integers(0, 5, n).astype(np.int32)]
    valid = rng.random(n) < 0.85
    values = _agg_values(rng, n, fdt)
    kinds = [k for _a, k, _m in values]

    def jagg_fn(arrs, masks, valid, keys, out_keys=None):
        return jagg.segment_aggregate(keys, list(zip(arrs, kinds, masks)),
                                      valid, out_keys=out_keys)

    arrs = [jnp.asarray(a) for a, _k, _m in values]
    masks = [None if m is None else jnp.asarray(m) for _a, _k, m in values]
    pv = [(T(a), k, None if m is None else T(m)) for a, k, m in values]
    if packed:
        pk = np.where(valid, keys[0] * 5 + keys[1], np.iinfo(np.int64).max)
        jres = jax.jit(jagg_fn)(arrs, masks, jnp.asarray(valid),
                                [jnp.asarray(pk)],
                                [jnp.asarray(k) for k in keys])
        pres = pagg.segment_aggregate([T(pk)], pv, T(valid),
                                      out_keys=[T(k) for k in keys])
    else:
        jres = jax.jit(jagg_fn)(arrs, masks, jnp.asarray(valid),
                                [jnp.asarray(k) for k in keys])
        pres = pagg.segment_aggregate([T(k) for k in keys], pv, T(valid))
    jgk, jr, jgv, jn = jres
    pgk, pr, pgv, pn = pres
    assert int(pn) == int(jn)
    np.testing.assert_array_equal(N(pgv), np.asarray(jgv))
    for a, b in zip(pgk, jgk):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    for a, b in zip(pr, jr):
        _assert_agg_close(N(a), np.asarray(b), fdt)


@pytest.mark.parametrize("fdt", [np.float64, np.float32])
@pytest.mark.parametrize("total,cap", [(3 * 4096 + 5, 900), (4096, 200)])
def test_bucketed_grid_aggregate_matches_jax(rng, fdt, total, cap):
    n = 3000
    slot = rng.integers(0, total, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    raw = _agg_values(rng, n, fdt)
    values = []
    for a, kind, m in raw:
        contrib = valid if m is None else valid & m
        if kind == "count":
            values.append((contrib.astype(np.int32), "count"))
        elif kind == "sum":
            values.append((np.where(contrib, a, 0).astype(a.dtype), kind))
        else:
            ident = (np.inf if np.issubdtype(a.dtype, np.floating)
                     else np.iinfo(a.dtype).max)
            if kind == "max":
                ident = (-np.inf if np.issubdtype(a.dtype, np.floating)
                         else np.iinfo(a.dtype).min)
            values.append((np.where(contrib, a, ident).astype(a.dtype),
                           kind))
    kinds = [k for _a, k in values]
    jres = jax.jit(lambda sl, va, arrs: jgroupby.bucketed_grid_aggregate(
        sl, va, list(zip(arrs, kinds)), total, cap, kernel="xla"))(
        jnp.asarray(slot), jnp.asarray(valid),
        [jnp.asarray(a) for a, _k in values])
    pres = pgroupby.bucketed_grid_aggregate(
        T(slot), T(valid), [(T(a), k) for a, k in values], total, cap)
    jr, jrows, jov, jfill = jres
    pr, prows, pov, pfill = pres
    assert int(pov) == int(jov)
    assert int(pfill) == int(jfill)
    np.testing.assert_array_equal(N(prows), np.asarray(jrows))
    for a, b in zip(pr, jr):
        _assert_agg_close(N(a), np.asarray(b), fdt)


def test_lookup_join_and_match_counts_exact(rng):
    m, n = 300, 400
    bk = [rng.permutation(1000)[:m].astype(np.int64)]
    pk = [rng.integers(0, 1000, n).astype(np.int64)]
    bvalid = rng.random(m) < 0.9
    pvalid = rng.random(n) < 0.9
    jb, jf = jcall(jjoin.lookup_join, [jnp.asarray(bk[0])],
                   jnp.asarray(bvalid), [jnp.asarray(pk[0])],
                   jnp.asarray(pvalid))
    pb, pf = pjoin.lookup_join([T(bk[0])], T(bvalid), [T(pk[0])], T(pvalid))
    np.testing.assert_array_equal(N(pf), np.asarray(jf))
    np.testing.assert_array_equal(N(pb)[N(pf)], np.asarray(jb)[N(pf)])
    dup = [np.concatenate([bk[0], bk[0][:50]])]
    dvalid = np.concatenate([bvalid, np.ones(50, bool)])
    np.testing.assert_array_equal(
        N(pjoin.match_counts([T(dup[0])], T(dvalid), [T(pk[0])],
                             T(pvalid))),
        np.asarray(jcall(jjoin.match_counts, [jnp.asarray(dup[0])],
                         jnp.asarray(dvalid), [jnp.asarray(pk[0])],
                         jnp.asarray(pvalid))))


def test_block_numpy_round_trip_matches_jax(rng):
    from citus_tpu.executor import batch as jbatch
    from citus_tpu_torch.executor import batch as pbatch

    n = 50
    values = {"a": rng.integers(0, 9, n).astype(np.int64),
              "b": rng.standard_normal(n)}
    validity = {"b": rng.random(n) < 0.7}
    jblk = jbatch.block_from_numpy(values, validity, capacity=64,
                                   compute_dtype=np.float32)
    pblk = pbatch.block_from_numpy(values, validity, capacity=64,
                                   compute_dtype=np.float32)
    jc, jv, jn = jbatch.block_to_numpy(jblk)
    pc, pv, pn = pbatch.block_to_numpy(pblk)
    np.testing.assert_array_equal(pv, jv)
    assert sorted(pn) == sorted(jn) == ["b"]
    for k in values:
        assert pc[k].dtype == jc[k].dtype
        np.testing.assert_array_equal(pc[k], jc[k])
        if k in jn:
            np.testing.assert_array_equal(pn[k], jn[k])
    pcols, _ = pbatch.compact_to_numpy(pblk)
    assert len(pcols["a"]) == n
