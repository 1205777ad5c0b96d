"""Bulk ingest: typed column batch → hash-route → per-shard stripes.

Rows arrive as numpy columns (or python lists for strings), route
vectorized by hash token, and append as per-shard stripes; the whole
batch becomes visible atomically via one commit_pending manifest flip.
This copy keeps the `_ingest_batch` path that the TPC-H load drives;
COPY-from-file, INSERT and transactional staging stay in the JAX
package.
"""

from __future__ import annotations

import numpy as np

from ..catalog import DistributionMethod
from ..catalog.distribution import hash_token, shard_index_for_token_ranges
from ..errors import IngestError
from ..types import DataType, date_to_days


def _ingest_batch(session, table: str, columns: list[str],
                  batch: list[list], pre_typed: bool = False,
                  commit: bool = True) -> tuple[int, list]:
    """batch: per-column numpy array or list of python values.
    Returns (row_count, pending); pending is non-empty only when
    commit=False."""
    meta = session.catalog.table(table)
    n = len(batch[0])
    if n == 0:
        return 0, []
    typed: dict[str, np.ndarray] = {}
    validity: dict[str, np.ndarray] = {}
    for name, cells in zip(columns, batch):
        col = meta.schema.column(name)
        arr, valid = _convert_column(session, table, name, col.dtype, cells,
                                     pre_typed)
        if not col.nullable and not valid.all():
            raise IngestError(
                f"NULL in non-nullable column {name!r} of {table!r}")
        typed[name] = arr
        validity[name] = valid

    codec = session.settings.get("columnar_compression")
    level = session.settings.get("columnar_compression_level")
    chunk_rows = session.settings.get("columnar_chunk_group_row_limit")
    # rows per stripe file: an ingest batch larger than the limit splits
    # into several stripes
    stripe_limit = max(1, int(session.settings.get(
        "columnar_stripe_row_limit")))

    if meta.method == DistributionMethod.HASH:
        dist_col = meta.distribution_column
        if not validity[dist_col].all():
            raise IngestError(
                f"NULL distribution column value in {table!r}")
        tokens = _routing_tokens(session, table, dist_col,
                                 meta.schema.column(dist_col).dtype,
                                 typed[dist_col])
        shards = session.catalog.table_shards(table)
        shard_idx = shard_index_for_token_ranges(
            tokens, session.catalog.shard_mins(table))
        targets = [(i, s) for i, s in enumerate(shards)]
    else:
        shard_idx = np.zeros(n, dtype=np.int64)
        targets = [(0, session.catalog.table_shards(table)[0])]

    pending: list = []

    def write_one(i: int, s):
        mask = shard_idx == i
        if not bool(mask.any()):
            return None
        sub = {c: typed[c][mask] for c in typed}
        subv = {c: validity[c][mask] for c in validity}
        n_sub = int(mask.sum())
        recs = []
        try:
            for lo in range(0, n_sub, stripe_limit):
                hi = min(n_sub, lo + stripe_limit)
                rec = session.store.append_stripe(
                    table, s.shard_id,
                    {c: a[lo:hi] for c, a in sub.items()},
                    {c: a[lo:hi] for c, a in subv.items()},
                    codec=codec, level=level,
                    chunk_rows=chunk_rows, commit=False)
                recs.append((s.shard_id, rec))
        except BaseException:
            # already-written (invisible) stripes go to discard_pending
            pending.extend(recs)
            raise
        return recs

    try:
        if n >= 65_536 and len(targets) > 1:
            # per-shard stripe writes in parallel: compression and fsync
            # release the GIL
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(8, len(targets))) as pool:
                futs = [pool.submit(write_one, i, s) for i, s in targets]
                err = None
                for f in futs:
                    try:
                        r = f.result()
                        if r is not None:
                            pending.extend(r)
                    except Exception as e:  # keep draining the pool
                        err = err if err is not None else e
                if err is not None:
                    raise err
        else:
            for i, s in targets:
                r = write_one(i, s)
                if r is not None:
                    pending.extend(r)
        if commit:
            session.store.commit_pending(table, pending)
            pending = []
    except Exception:
        session.store.discard_pending(table, pending)
        raise
    return n, pending


def _routing_tokens(session, table, column, dtype, values: np.ndarray):
    if dtype == DataType.STRING:
        # codes → per-code routing token via the dictionary's token table
        d = session.store.dictionary(table, column)
        return d.hash_tokens()[values]
    return hash_token(values)


def _convert_column(session, table, name, dtype: DataType, cells,
                    pre_typed: bool):
    n = len(cells)
    # bulk-load fast path: a numeric numpy column has no Nones
    if pre_typed and isinstance(cells, np.ndarray) \
            and cells.dtype != object:
        if dtype == DataType.STRING:
            raise IngestError(
                f"column {name!r}: string column fed a numeric array")
        return (cells.astype(dtype.numpy_dtype, copy=False),
                np.ones(n, dtype=bool))
    if pre_typed and isinstance(cells, list) and cells.count(None) == 0:
        valid = np.ones(n, dtype=bool)
    else:
        valid = np.array(
            [c is not None and not (isinstance(c, str) and c == "")
             if not pre_typed else c is not None
             for c in cells], dtype=bool)
    if dtype == DataType.STRING:
        d = session.store.dictionary(table, name)
        if valid.all():
            codes = d.intern_array(cells)
        else:
            codes = d.intern_array([c if v else None
                                    for c, v in zip(cells, valid)])
        return codes, valid
    np_dtype = dtype.numpy_dtype
    out = np.zeros(n, dtype=np_dtype)
    if pre_typed:
        for i, (c, v) in enumerate(zip(cells, valid)):
            if v:
                out[i] = c
        return out, valid
    try:
        if dtype == DataType.DATE:
            for i, (c, v) in enumerate(zip(cells, valid)):
                if v:
                    out[i] = date_to_days(c)
        elif dtype == DataType.BOOL:
            for i, (c, v) in enumerate(zip(cells, valid)):
                if v:
                    out[i] = c.strip().lower() in ("t", "true", "1", "yes")
        elif dtype.type_class.value == "int":
            vals = np.array([c if v else "0" for c, v in zip(cells, valid)])
            out = vals.astype(np.int64).astype(np_dtype)
        else:
            vals = np.array([c if v else "0" for c, v in zip(cells, valid)])
            out = vals.astype(np.float64).astype(np_dtype)
    except ValueError as exc:
        raise IngestError(f"column {name!r}: {exc}") from exc
    return out, valid
