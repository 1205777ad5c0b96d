"""Hash-distribution math: token space, shard intervals, row→shard routing.

Mirrors the semantics of the reference's shard creation
(Citus src/backend/distributed/operations/create_shards.c:83
CreateShardsWithRoundRobinPolicy, :144 hashTokenIncrement = HASH_TOKEN_COUNT /
shardCount): the signed 32-bit hash-token space is split into `shard_count`
contiguous ranges; a row belongs to the shard whose [min,max] token range
contains hash(distribution_column).

The hash function itself differs from PostgreSQL's hash_uint32 (no need for
wire compatibility); we use the murmur3 32-bit finalizer (fmix32), which is
cheap on the TPU VPU (shifts/xors/multiplies) — see citus_tpu.ops.hashing for
the device-side twin.  Host and device MUST agree bit-for-bit; tests assert
this.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

HASH_TOKEN_COUNT = 1 << 32
INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1


def shard_interval_bounds(shard_count: int) -> list[tuple[int, int]]:
    """[(minvalue, maxvalue)] per shard index, covering the int32 space."""
    if shard_count < 1:
        raise ValueError("shard_count must be >= 1")
    increment = HASH_TOKEN_COUNT // shard_count
    bounds = []
    for i in range(shard_count):
        lo = INT32_MIN + i * increment
        hi = INT32_MIN + (i + 1) * increment - 1 if i < shard_count - 1 else INT32_MAX
        bounds.append((lo, hi))
    return bounds


def fmix32(x: np.ndarray) -> np.ndarray:
    """murmur3 32-bit finalizer over uint32 (vectorized, numpy host side)."""
    x = np.atleast_1d(np.asarray(x, dtype=np.uint32)).copy()
    with np.errstate(over="ignore"):  # uint32 wraparound is the algorithm
        x ^= x >> 16
        x = (x * np.uint32(0x85EBCA6B)).astype(np.uint32)
        x ^= x >> 13
        x = (x * np.uint32(0xC2B2AE35)).astype(np.uint32)
        x ^= x >> 16
    return x


def hash_token(values: np.ndarray) -> np.ndarray:
    """Column values → signed int32 hash tokens.

    int64 values mix both halves; int32/date use the value directly; floats
    hash their bit pattern; string columns must be pre-converted to their
    dictionary hash (see storage.dictionary).
    """
    values = np.asarray(values)
    if values.dtype == np.int64 or values.dtype == np.uint64:
        v = values.view(np.uint64) if values.dtype == np.uint64 else values.astype(np.uint64)
        lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (v >> np.uint64(32)).astype(np.uint32)
        # PG hashint8-style width fold: for values that fit in int32 the
        # folded word equals the int32 word, so int64 and int32 columns
        # hash identically for equal values — required for repartition
        # routing when join-key widths differ (executor casts keys to i64)
        nonneg = hi < np.uint32(0x80000000)
        folded = lo ^ np.where(nonneg, hi, ~hi)
        return fmix32(folded).view(np.int32)
    if values.dtype == np.float64:
        return hash_token(values.view(np.int64))
    if values.dtype == np.float32:
        return fmix32(values.view(np.uint32)).view(np.int32)
    if values.dtype == np.bool_:
        values = values.astype(np.int32)
    return fmix32(values.astype(np.int32).view(np.uint32)).view(np.int32)


def shard_index_for_token(tokens: np.ndarray, shard_count: int) -> np.ndarray:
    """Vectorized token → shard index using the uniform-increment layout.

    Because intervals are contiguous and uniform, the owner is computable
    directly (no binary search): (token - INT32_MIN) // increment, clamped.
    This is the same closed form the device-side partition kernel uses.
    """
    increment = HASH_TOKEN_COUNT // shard_count
    offset = tokens.astype(np.int64) - INT32_MIN
    idx = offset // increment
    return np.minimum(idx, shard_count - 1).astype(np.int32)


def shard_index_for_values(values: np.ndarray, shard_count: int) -> np.ndarray:
    return shard_index_for_token(hash_token(values), shard_count)


def shard_index_for_token_ranges(tokens: np.ndarray,
                                 mins: np.ndarray) -> np.ndarray:
    """Token → shard index over EXPLICIT contiguous ranges (mins ascending,
    shard i covering [mins[i], mins[i+1]-1]).  The range-aware twin of
    shard_index_for_token for tables whose shards have been split
    (operations/shard_split.c analogue) and no longer sit on the uniform
    increment grid."""
    mins = np.asarray(mins, dtype=np.int64)
    idx = np.searchsorted(mins, np.asarray(tokens, dtype=np.int64),
                          side="right") - 1
    return np.clip(idx, 0, len(mins) - 1).astype(np.int32)


@dataclass(frozen=True)
class ShardInterval:
    """One shard of a distributed table (pg_dist_shard row analogue;
    ref: src/include/distributed/pg_dist_shard.h)."""

    shard_id: int
    table_name: str
    shard_index: int
    min_value: int | None  # None for reference/local tables (single shard)
    max_value: int | None

    def contains_token(self, token: int) -> bool:
        if self.min_value is None:
            return True
        return self.min_value <= token <= self.max_value

    def to_json(self) -> dict:
        return {
            "shard_id": self.shard_id,
            "table_name": self.table_name,
            "shard_index": self.shard_index,
            "min_value": self.min_value,
            "max_value": self.max_value,
        }

    @staticmethod
    def from_json(obj: dict) -> "ShardInterval":
        return ShardInterval(
            obj["shard_id"], obj["table_name"], obj["shard_index"],
            obj["min_value"], obj["max_value"])
