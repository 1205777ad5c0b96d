"""Equi-join kernels: dense-directory lookup + sorted binary-search join.

Counterpart of citus_tpu/ops/join.py, same algorithms on torch tensors.
No pointer-chasing hash tables: the build side is arranged once (sort or
counting directory) and probes resolve to a contiguous run of matches.

* **Dense directory**: when the build key's value range [base,
  base+extent) is known from table statistics, a directory maps each key
  value straight to its sorted run; build rows outside the declared range
  are counted into `dense_oob` so the host retries with the directory
  disabled (stale statistics cost one retry, never wrong answers).
* **Lexicographic binary search** for multi-column or unbounded keys.
* **Bucketed unique lookup** for large directories: probes pack by
  directory tile and the inner gather is the tile-resident kernel
  (ops.hopper_kernels.bucketed_probe) on the card.

Pair emission is sort-free: probe start offsets scatter into the output
slot space and a running max fills each probe's run.  Static output
capacity + overflow counts answer data-dependent cardinalities.
"""

from __future__ import annotations

import math

import torch

DENSE_MAX_SLOTS = 1 << 26
# directory slots per bucket tile: 2^15 int32 = 128 KB, one tile per
# block in shared memory on the card
PROBE_TILE_SLOTS = 1 << 15
# below this extent the whole directory is cache-sized and the single
# random gather is already cheap
PROBE_BUCKET_MIN_EXTENT = 1 << 22


def probe_bucket_count(extent: int) -> int:
    """Number of directory tiles covering [0, extent)."""
    return max(1, -(-extent // PROBE_TILE_SLOTS))


def probe_bucket_eligible(extent: int, probe_rows: int) -> bool:
    """Planner size threshold for the bucketed probe path (the JAX
    package's rule): a directory past the cache knee and a probe stream
    dense enough to amortize streaming every tile once."""
    return extent >= PROBE_BUCKET_MIN_EXTENT and probe_rows * 4 >= extent


def dense_directory_ok(extent: int, build_size: int) -> bool:
    return (0 < extent <= DENSE_MAX_SLOTS
            and extent <= max(8 * max(build_size, 1), 1 << 20))


def lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """numpy.lexsort order (LAST key primary) by successive stable sorts."""
    n = keys[0].shape[0]
    order = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    for k in keys:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def _lex_less(a: list[torch.Tensor], b: list[torch.Tensor]) -> torch.Tensor:
    out = torch.zeros(torch.broadcast_shapes(a[0].shape, b[0].shape),
                      dtype=torch.bool, device=a[0].device)
    tie = torch.ones_like(out)
    for x, y in zip(a, b):
        out = out | (tie & (x < y))
        tie = tie & (x == y)
    return out


def _lex_eq(a: list[torch.Tensor], b: list[torch.Tensor]) -> torch.Tensor:
    out = torch.ones(torch.broadcast_shapes(a[0].shape, b[0].shape),
                     dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):
        out = out & (x == y)
    return out


def _lex_leq(a, b):
    return ~_lex_less(b, a)


def sort_build_side(build_keys: list[torch.Tensor],
                    build_valid: torch.Tensor):
    """Sort build rows by key, invalid rows last.
    Returns (sorted_keys, order, n_valid)."""
    invalid = (~build_valid).to(torch.int32)
    order = lexsort(list(reversed(build_keys)) + [invalid])
    sorted_keys = [k[order] for k in build_keys]
    n_valid = build_valid.sum()
    return sorted_keys, order, n_valid


def _search(sorted_keys, n_valid, probe_keys, cmp) -> torch.Tensor:
    """Vectorized binary search: first index in [0, n_valid] where
    cmp(build_key, probe_key) is False; ceil(log2(M))+1 fixed steps."""
    m = sorted_keys[0].shape[0]
    n = probe_keys[0].shape[0]
    dev = probe_keys[0].device
    steps = max(1, math.ceil(math.log2(m + 1)))
    lo = torch.zeros(n, dtype=torch.int64, device=dev)
    hi = n_valid.to(torch.int64).expand(n).clone()
    for _ in range(steps):
        active = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        mid_c = torch.clamp(mid, 0, m - 1)
        take = cmp([k[mid_c] for k in sorted_keys], probe_keys)
        lo = torch.where(active & take, mid + 1, lo)
        hi = torch.where(active & ~take, mid, hi)
    return lo


def lower_bound(sorted_keys, n_valid, probe_keys) -> torch.Tensor:
    """First index with key >= probe (lexicographic, exact)."""
    return _search(sorted_keys, n_valid, probe_keys, _lex_less)


def _upper_bound(sorted_keys, n_valid, probe_keys) -> torch.Tensor:
    """First index with key > probe."""
    return _search(sorted_keys, n_valid, probe_keys, _lex_leq)


def _probe_slots(probe_key: torch.Tensor, base: int, extent: int):
    """(pin [n], pc [n] int64): in-range mask + clipped slot per probe."""
    pidx = probe_key.to(torch.int64) - base
    pin = (pidx >= 0) & (pidx < extent)
    return pin, torch.clamp(pidx, 0, extent - 1)


def _dense_bounds(build_key, build_matchable, probe_key, base: int,
                  extent: int):
    """Counting directory over [base, base+extent): (order, lo, hi, oob)
    — `order` arranges matchable in-range build rows first, sorted by key;
    lo/hi bound each probe's run in that order."""
    idx = build_key.to(torch.int64) - base
    inb = build_matchable & (idx >= 0) & (idx < extent)
    oob = (build_matchable & ~inb).sum()
    slot = torch.where(inb, idx, torch.full_like(idx, extent))
    per_slot = torch.bincount(slot, minlength=extent + 1)[:extent]
    starts = torch.cat([torch.zeros(1, dtype=torch.int64,
                                    device=idx.device),
                        torch.cumsum(per_slot, 0)])
    order = torch.sort(slot, stable=True).indices
    pin, pc = _probe_slots(probe_key, base, extent)
    zero = torch.zeros((), dtype=torch.int64, device=idx.device)
    lo = torch.where(pin, starts[pc], zero)
    hi = torch.where(pin, starts[pc + 1], zero)
    return order, lo, hi, oob


def _unique_directory(build_key, build_matchable, base: int, extent: int,
                      slots: int):
    """Directory [slots] int32 → build row (m where empty) plus the
    oob + duplicate count (the stale-uniqueness retry signal, detected
    build-side by scatter-then-read-back)."""
    m = build_key.shape[0]
    dev = build_key.device
    idx = build_key.to(torch.int64) - base
    inb = build_matchable & (idx >= 0) & (idx < extent)
    oob = (build_matchable & ~inb).sum()
    slot = torch.where(inb, idx, torch.full_like(idx, slots))
    iota = torch.arange(m, dtype=torch.int32, device=dev)
    directory = torch.full((slots + 1,), m, dtype=torch.int32, device=dev)
    directory[slot] = iota
    directory = directory[:slots]
    back = directory[torch.clamp(slot, max=slots - 1)]
    dup = (inb & (torch.clamp(back, max=m) != iota)).sum()
    return directory, oob + dup


def dense_unique_lookup(build_key, build_matchable, probe_key, base: int,
                        extent: int):
    """Sort-free dense lookup for a UNIQUE-keyed build side: one scatter
    builds directory[slot] → build row, one gather probes it.
    Returns (bidx [N] int64, counts [N] int32, oob_count)."""
    m = build_key.shape[0]
    directory, oob = _unique_directory(build_key, build_matchable, base,
                                       extent, extent)
    pin, pc = _probe_slots(probe_key, base, extent)
    raw = directory[pc]
    found = pin & (raw != m)
    bidx = torch.clamp(raw, max=m - 1).to(torch.int64)
    return bidx, found.to(torch.int32), oob


def bucketed_unique_lookup(build_key, build_matchable, probe_key, base: int,
                           extent: int, bucket_cap: int):
    """Tile-bucketed variant of dense_unique_lookup.

      1. build the dense directory (duplicates detected build-side, like
         dense_unique_lookup),
      2. pack probe rows by bucket = slot // PROBE_TILE_SLOTS into a
         [n_buckets, bucket_cap] buffer (pack_by_target),
      3. gather bucket by bucket from the resident tile — the
         bucketed_probe kernel on the card, its plain version on the CPU,
      4. scatter hits back to original probe positions.

    Returns (bidx [N], counts [N], oob_count, bucket_overflow,
    bucket_max_fill) with the JAX function's contract."""
    from .hashing import tile_buckets
    from .hopper_kernels import bucketed_probe
    from .partition import pack_by_target

    tile = PROBE_TILE_SLOTS
    m = build_key.shape[0]
    n = probe_key.shape[0]
    dev = probe_key.device
    n_buckets = probe_bucket_count(extent)
    ext_pad = n_buckets * tile
    directory, oob = _unique_directory(build_key, build_matchable, base,
                                       extent, ext_pad)
    pin, pc = _probe_slots(probe_key, base, extent)
    bucket, local = tile_buckets(pc, tile)
    packed, pvalid, overflow = pack_by_target(
        {"local": local.to(torch.int32),
         "pos": torch.arange(n, dtype=torch.int64, device=dev)},
        pin, bucket, n_buckets, bucket_cap)
    bucket_max_fill = pvalid.sum(dim=1).max()
    dir2d = directory.reshape(n_buckets, tile)
    raw2d = bucketed_probe(dir2d, packed["local"].contiguous())
    pos = torch.where(pvalid, packed["pos"],
                      torch.full_like(packed["pos"], n)).reshape(-1)
    raw = torch.full((n + 1,), m, dtype=torch.int32, device=dev)
    raw[pos] = raw2d.reshape(-1)
    raw = raw[:n]
    found = pin & (raw != m)
    bidx = torch.clamp(raw, max=m - 1).to(torch.int64)
    return bidx, found.to(torch.int32), oob, overflow, bucket_max_fill


def _bounds(build_keys, build_matchable, probe_keys, dense):
    """(order, lo, hi, dense_oob) via directory or binary search."""
    if dense is not None and len(build_keys) == 1:
        return _dense_bounds(build_keys[0], build_matchable, probe_keys[0],
                             dense[0], dense[1])
    sorted_keys, order, n_valid = sort_build_side(build_keys,
                                                  build_matchable)
    lo = lower_bound(sorted_keys, n_valid, probe_keys)
    hi = _upper_bound(sorted_keys, n_valid, probe_keys)
    return order, lo, hi, torch.zeros((), dtype=torch.int64,
                                      device=lo.device)


def match_counts(build_keys, build_valid, probe_keys, probe_valid):
    """Number of build matches per probe row."""
    _, lo, hi, _ = _bounds(build_keys, build_valid, probe_keys, None)
    return torch.where(probe_valid, hi - lo, torch.zeros_like(lo))


def lookup_join(build_keys, build_valid, probe_keys, probe_valid):
    """One-match-per-probe equi-join (build side unique on key).
    Returns (build_row_idx [N], found [N])."""
    sorted_keys, order, n_valid = sort_build_side(build_keys, build_valid)
    pos = lower_bound(sorted_keys, n_valid, probe_keys)
    m = sorted_keys[0].shape[0]
    pos_c = torch.clamp(pos, 0, m - 1)
    hit_keys = [k[pos_c] for k in sorted_keys]
    found = probe_valid & (pos < n_valid) & _lex_eq(hit_keys, probe_keys)
    return order[pos_c], found


def expand_join(build_keys, build_valid, probe_keys, probe_valid,
                capacity: int, dense=None):
    """General many-to-many equi-join with static output capacity:
    (build_idx [C], probe_idx [C], out_valid [C], overflow_count)."""
    build_idx, probe_idx, out_valid, _missing, overflow, dense_oob = \
        expand_join_pairs(build_keys, build_valid, probe_keys, probe_valid,
                          probe_valid, capacity, probe_outer=False,
                          dense=dense)
    return build_idx, probe_idx, out_valid, overflow + dense_oob


def expand_join_pairs(build_keys, build_matchable, probe_keys, probe_valid,
                      probe_matchable, capacity: int, probe_outer: bool,
                      dense=None):
    """Pair emission core; returns (build_idx, probe_idx, out_valid,
    build_missing, capacity_overflow, dense_oob)."""
    order, lo, hi, dense_oob = _bounds(build_keys, build_matchable,
                                       probe_keys, dense)
    m = build_keys[0].shape[0]
    n = probe_keys[0].shape[0]
    dev = lo.device
    counts = torch.where(probe_matchable, hi - lo, torch.zeros_like(lo))
    if probe_outer:
        emit = torch.where(probe_valid & (counts == 0),
                           torch.ones_like(counts), counts)
    else:
        emit = counts
    total = emit.sum()
    starts64 = torch.cumsum(emit, 0) - emit
    starts = torch.clamp(starts64, max=capacity)
    # probe id per output slot: each emitting probe marks its start
    # slot; a running max fills the run
    marker = torch.full((capacity + 1,), -1, dtype=torch.int64, device=dev)
    tgt = torch.where(emit > 0, starts, torch.full_like(starts, capacity))
    marker.scatter_reduce_(0, tgt, torch.arange(n, dtype=torch.int64,
                                                device=dev),
                           reduce="amax", include_self=True)
    marker = marker[:capacity]
    probe_idx = torch.clamp(torch.cummax(marker, 0).values, min=0)
    slots = torch.arange(capacity, dtype=torch.int64, device=dev)
    offset = slots - starts[probe_idx]
    out_valid = (slots < total) & (offset >= 0) & (offset < emit[probe_idx])
    sorted_pos = torch.clamp(lo[probe_idx] + offset, 0, m - 1)
    build_idx = order[sorted_pos]
    build_missing = out_valid & (counts[probe_idx] == 0)
    build_idx = torch.where(build_missing, torch.zeros_like(build_idx),
                            build_idx)
    overflow = torch.clamp(total - capacity, min=0)
    return build_idx, probe_idx, out_valid, build_missing, overflow, \
        dense_oob
