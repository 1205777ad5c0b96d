"""Device-side hashing: the bit-exact torch twin of catalog.distribution.

Counterpart of citus_tpu/ops/hashing.py.  The routing contract: host
ingest (numpy) and device shuffles MUST compute identical hash tokens, or
rows land on the wrong shard and joins silently lose rows.  Tests assert
bit-equality with catalog.distribution.hash_token and with the JAX
package's hash_token_jax.

torch's uint32 arithmetic is partial, so every 32-bit word here lives in
an int64 tensor holding a value in [0, 2^32).  The murmur3 multiplies
split the constant into 16-bit halves so no intermediate product leaves
the int64 range (signed overflow is never relied on).
"""

from __future__ import annotations

import torch

from ..catalog.distribution import HASH_TOKEN_COUNT, INT32_MIN

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64."""
    lo = x * (c & 0xFFFF)                           # < 2^48
    hi = ((x * (c >> 16)) & 0xFFFF) << 16           # < 2^32
    return (lo + hi) & _MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer over 32-bit words held in int64 [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _word_to_int32(x: torch.Tensor) -> torch.Tensor:
    """[0, 2^32) word in int64 → the same bits as signed int32."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _words(values: torch.Tensor) -> torch.Tensor:
    """The 32-bit word each value hashes, as int64 in [0, 2^32)."""
    dt = values.dtype
    if dt == torch.int64:
        lo = values & _MASK32
        hi = (values >> 32) & _MASK32
        # PG hashint8-style width fold (see distribution.hash_token):
        # int64 and int32 columns hash identically for in-range values
        nonneg = hi < 0x80000000
        return lo ^ torch.where(nonneg, hi, hi ^ _MASK32)
    if dt == torch.float64:
        # bit pattern, not value
        return _words(values.contiguous().view(torch.int64))
    if dt == torch.float32:
        return values.contiguous().view(torch.int32).to(torch.int64) \
            & _MASK32
    if dt == torch.bool:
        values = values.to(torch.int32)
    return values.to(torch.int32).to(torch.int64) & _MASK32


def hash_token(values: torch.Tensor) -> torch.Tensor:
    """Column → signed int32 hash tokens (matches distribution.hash_token
    bit for bit, on any device)."""
    return _word_to_int32(fmix32(_words(values)))


def shard_index_from_token(tokens: torch.Tensor,
                           shard_count: int) -> torch.Tensor:
    """Uniform-increment owner lookup (matches
    distribution.shard_index_for_token)."""
    increment = HASH_TOKEN_COUNT // shard_count
    idx = (tokens.to(torch.int64) - INT32_MIN) // increment
    return torch.clamp(idx, max=shard_count - 1).to(torch.int32)


def tile_buckets(slots: torch.Tensor, tile_slots: int,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense slot → (bucket, tile-local slot) for the tiled probe and
    group-by packs: buckets are contiguous slot ranges, so every row
    landing in bucket b touches only tile b."""
    bucket = torch.div(slots, tile_slots, rounding_mode="floor")
    return bucket, slots - bucket * tile_slots

