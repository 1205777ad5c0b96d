"""Persistent per-shard point-lookup index (key → stripe/row).

Counterpart of citus_tpu/storage/pkindex.py, with the same sidecar file:
either package uses an index the other built.  The reference's columnar
tables support btree/hash indexes for point lookups (Citus
src/backend/columnar/README.md:176).  The analogue here: a sorted-key
sidecar per (shard, column) that the fast-path router consults for
``WHERE distcol = const`` — the lookup becomes one binary search + a
read of ONLY the chunks holding the matching rows, instead of scanning
the shard.

Layout (``shard_dir/PKIDX_<col>.npz``, atomic-rename writes):
  keys       sorted int64 key values
  stripe_idx index into the signature's stripe list, per key
  row_pos    physical row within that stripe, per key
  sig        the manifest stripe list (file, rows) the index was built
             from — any mismatch (DML appended/rewrote stripes) makes
             the index stale and it rebuilds lazily on next use

Deletion bitmaps don't invalidate the index: positions are physical,
and the lookup re-applies the CURRENT delete mask, the open
transaction's staged one included (effective_delete_mask).  Rows staged
by an open transaction are not in the index, so the fast path never
asks it while the overlay holds records for the table
(executor/fastpath.index_probe) and scans the shard instead.  Stripe
reads go through the store's read-repair seam (`verified_read`).
"""

from __future__ import annotations

import io as pyio
import os

import numpy as np

from ..utils import io as dio
from .format import StripeReader


def _sig(records) -> list[tuple[str, int]]:
    return [(r["file"], int(r["rows"])) for r in records]


def _idx_path(store, table: str, shard_id: int, column: str) -> str:
    return os.path.join(store.shard_dir(table, shard_id),
                        f"PKIDX_{column}.npz")


def _load(path: str):
    try:
        # allow_pickle stays False (numpy default): the sidecar sits in
        # a possibly-shared data_dir and must never execute code on load
        with np.load(path) as z:
            sig = [(str(f), int(r))
                   for f, r in zip(z["sig_files"], z["sig_rows"])]
            return (z["keys"], z["stripe_idx"], z["row_pos"], sig)
    except Exception:
        return None


def _build(store, table: str, shard_id: int, column: str, records):
    storage_col = store.storage_column_name(table, column)
    keys_parts, sidx_parts, pos_parts = [], [], []
    for i, rec in enumerate(records):
        def read_one(path):
            reader = StripeReader(path, verify=store._verify_enabled())
            if storage_col not in reader._by_name:
                return None  # pre-ALTER stripe: column reads all-NULL
            return reader.read([storage_col])

        got = store.verified_read(table, shard_id, rec["file"], read_one)
        if got is None:
            continue
        vals, mask, _n = got
        v = np.asarray(vals[storage_col]).astype(np.int64)
        m = np.asarray(mask[storage_col])  # validity: NULL keys excluded
        pos = np.flatnonzero(m)
        keys_parts.append(v[pos])
        sidx_parts.append(np.full(pos.size, i, dtype=np.int32))
        pos_parts.append(pos.astype(np.int64))
    if keys_parts:
        keys = np.concatenate(keys_parts)
        sidx = np.concatenate(sidx_parts)
        rpos = np.concatenate(pos_parts)
        order = np.argsort(keys, kind="stable")
        keys, sidx, rpos = keys[order], sidx[order], rpos[order]
    else:
        keys = np.zeros(0, np.int64)
        sidx = np.zeros(0, np.int32)
        rpos = np.zeros(0, np.int64)
    return keys, sidx, rpos


def _cache(store) -> dict:
    c = getattr(store, "_pkidx_cache", None)
    if c is None:
        c = store._pkidx_cache = {}
    return c


def lookup(store, table: str, shard_id: int, column: str,
           value: int) -> list[tuple[dict, int]] | None:
    """Positions of rows where column == value, as
    [(stripe_record, row_pos)]; None while the store's open transaction
    holds staged records for the table (the caller scans instead).
    Builds/rebuilds the sidecar lazily.

    Warm lookups come from an in-memory cache validated against the
    manifest stripe signature — re-decompressing the sidecar per query
    would cost more than the binary search it enables."""
    if store.overlay is not None and (
            store._overlay_records(table, shard_id)
            or any(t == table for (t, _s) in store.overlay.records)):
        return None  # staged rows are not in the index
    records = store.manifest(table)["shards"].get(str(shard_id), [])
    sig = _sig(records)
    ckey = (table, shard_id, column)
    cached = _cache(store).get(ckey)
    if cached is not None and cached[3] == sig:
        keys, sidx, rpos = cached[:3]
    else:
        path = _idx_path(store, table, shard_id, column)
        loaded = _load(path)
        if loaded is not None and loaded[3] == sig:
            keys, sidx, rpos = loaded[:3]
        else:
            keys, sidx, rpos = _build(store, table, shard_id, column,
                                      records)
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                buf = pyio.BytesIO()
                files = np.asarray([f for f, _r in sig])
                rows = np.asarray([r for _f, r in sig], dtype=np.int64)
                np.savez(buf, keys=keys, stripe_idx=sidx, row_pos=rpos,
                         sig_files=files, sig_rows=rows)
                dio.atomic_write_bytes(path, buf.getvalue())
            except OSError:
                pass  # persistence is best-effort; memory result valid
        _cache(store)[ckey] = (keys, sidx, rpos, sig)
    lo = int(np.searchsorted(keys, value, side="left"))
    hi = int(np.searchsorted(keys, value, side="right"))
    return [(records[int(sidx[i])], int(rpos[i])) for i in range(lo, hi)]


def read_rows(store, table: str, shard_id: int, columns: list[str],
              hits) -> tuple[dict, dict, int]:
    """Materialize the hit rows (values, validity, n), reading only the
    chunks that contain them and honoring current deletion bitmaps.
    Rows come back stripe by stripe in manifest order.  The one-request
    form of `read_rows_multi`."""
    return read_rows_multi(store, table, shard_id, columns, [hits])[0]


def read_rows_multi(store, table: str, shard_id: int, columns: list[str],
                    hit_lists) -> list[tuple[dict, dict, int]]:
    """Batched `read_rows`: ONE stripe/chunk pass over the union of many
    keys' hits, demuxed back per request — the serving micro-batcher's
    gather (a chunk holding rows for several sessions is opened,
    CRC-verified and decompressed once).  Returns [(values, validity,
    n)] aligned with `hit_lists`; each request's rows come back in the
    order `read_rows` gives it alone."""
    meta = store.catalog.table(table)
    storage_of = {c: store.storage_column_name(table, c) for c in columns}
    n_req = len(hit_lists)
    by_stripe: dict[str, list[tuple[int, int]]] = {}
    rec_of: dict[str, dict] = {}
    for ri, hits in enumerate(hit_lists):
        for rec, pos in hits:
            by_stripe.setdefault(rec["file"], []).append((ri, pos))
            rec_of[rec["file"]] = rec
    manifest_order = {r["file"]: i for i, r in enumerate(
        store.manifest(table)["shards"].get(str(shard_id), []))}
    vals_out = [{c: [] for c in columns} for _ in range(n_req)]
    mask_out = [{c: [] for c in columns} for _ in range(n_req)]
    counts = [0] * n_req
    for fname in sorted(by_stripe,
                        key=lambda f: manifest_order.get(f, 1 << 30)):
        dmask = store.effective_delete_mask(table, shard_id, rec_of[fname])
        live = [(ri, p) for ri, p in by_stripe[fname]
                if dmask is None or not bool(dmask[p])]
        if not live:
            continue
        pos_arr = np.asarray([p for _ri, p in live], dtype=np.int64)
        req_ids = np.asarray([ri for ri, _p in live], dtype=np.int64)

        def read_one(path, pos_arr=pos_arr):
            reader = StripeReader(path, verify=store._verify_enabled())
            # chunk index per live position; read ONLY those chunks
            bounds = np.cumsum(np.asarray(reader.footer["chunk_rows"]))
            chunk_of = np.searchsorted(bounds, pos_arr, side="right")
            starts = np.concatenate([[0], bounds[:-1]])
            sel = sorted(set(int(c) for c in chunk_of))
            # stripe position → position within the concatenated read
            offset_of = {}
            acc = 0
            for ci in sel:
                offset_of[ci] = acc - int(starts[ci])
                acc += int(bounds[ci] - starts[ci])
            present = [storage_of[c] for c in columns
                       if storage_of[c] in reader._by_name]
            v, m = ({}, {}) if not present else \
                reader.read(present, chunks=sel)[:2]
            return v, m, chunk_of, offset_of

        v, m, chunk_of, offset_of = store.verified_read(
            table, shard_id, fname, read_one)
        local = pos_arr + np.asarray([offset_of[int(c)] for c in chunk_of],
                                     dtype=np.int64)
        for ri in np.unique(req_ids):
            rl = local[req_ids == ri]
            ri = int(ri)
            for c in columns:
                s = storage_of[c]
                if s in v:
                    vals_out[ri][c].append(np.asarray(v[s])[rl])
                    mask_out[ri][c].append(np.asarray(m[s])[rl])
                else:  # post-ALTER column: NULL for old stripes
                    dt = meta.schema.column(c).dtype.numpy_dtype
                    vals_out[ri][c].append(np.zeros(rl.size, dtype=dt))
                    mask_out[ri][c].append(np.zeros(rl.size, dtype=bool))
            counts[ri] += int(rl.size)
    out = []
    for ri in range(n_req):
        out_v, out_m = {}, {}
        for c in columns:
            if vals_out[ri][c]:
                out_v[c] = np.concatenate(vals_out[ri][c])
                out_m[c] = np.concatenate(mask_out[ri][c])
            else:
                dt = meta.schema.column(c).dtype.numpy_dtype
                out_v[c] = np.zeros(0, dtype=dt)
                out_m[c] = np.zeros(0, dtype=bool)
        out.append((out_v, out_m, counts[ri]))
    return out
