"""COPY FROM / INSERT ingest: parse → hash-route → per-shard stripes.

Counterpart of citus_tpu/ingest/copy_from.py.  The multi_copy.c analogue
(Citus src/backend/distributed/commands/multi_copy.c:315
CitusSendTupleToPlacements): instead of a per-tuple
parse→hash→route loop feeding per-shard COPY connections, rows batch into
numpy columns, route vectorized by hash token, and append as per-shard
stripes; the whole batch becomes visible atomically via commit_pending
(the COPY-transaction analogue).  Inside an open transaction the
stripes stage into the overlay instead (visible to this session, durable
at COMMIT); autocommit ingest into a hash table holds the target
shards' locks across routing and the flip.
"""

from __future__ import annotations

import numpy as np

from ..catalog import DistributionMethod
from ..catalog.distribution import hash_token, shard_index_for_token_ranges
from ..errors import IngestError
from ..sql import ast
from ..types import DataType, date_to_days


# rows parsed per ingest batch before routing (the JAX package's
# copy_batch_rows default; per-shard COPY buffering, multi_copy.c)
COPY_BATCH_ROWS = 65_536


def copy_from(session, stmt: ast.CopyFrom):
    from ..executor.runner import ResultSet

    meta = session.catalog.table(stmt.table)
    delimiter = stmt.delimiter if stmt.format != "csv" else (
        stmt.delimiter or ",")
    total = 0
    columns = meta.schema.names

    from .parse import iter_text_batches

    batches = iter_text_batches(stmt.path, delimiter, stmt.header,
                                stmt.null_string, len(columns),
                                COPY_BATCH_ROWS)
    from ..utils.cancellation import check_cancel

    # pipelined ingest: a producer thread PARSES batch N+1 while this
    # thread converts/routes/compresses/writes batch N (the per-shard
    # stream overlap of the reference's COPY, commands/multi_copy.c:315).
    # The bounded queue caps memory at two parsed batches; zstd releases
    # the GIL, so on a multi-core host the parse leg hides entirely
    # behind compression.
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()  # consumer error → producer exits promptly

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in batches:
                if not _put(("batch", batch)):
                    return
            _put(("done", None))
        except Exception as e:  # surfaced on the consumer side
            _put(("err", e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            check_cancel()  # COPY batch boundaries are cancel seams
            try:
                kind, payload = q.get(timeout=0.25)
            except queue.Empty:
                continue
            if kind == "err":
                raise payload
            if kind == "done":
                break
            total += _ingest_batch(session, stmt.table, columns,
                                   payload)[0]
    finally:
        stop.set()  # a mid-parse producer stops at its next put attempt
        t.join(timeout=10.0)
        if t.is_alive():
            # the producer only checks `stop` between put attempts, so a
            # parse wedged inside one batch (e.g. a blocking read on a
            # pipe) outlives the statement as a daemon thread still
            # holding the input file — say so instead of returning (or
            # propagating the consumer's error) silently
            import logging

            logging.getLogger(__name__).warning(
                "COPY producer thread for %r still parsing 10 s after "
                "consumer shutdown; abandoning it as a daemon thread "
                "(input file handle stays open until it exits)",
                stmt.path)
    return ResultSet(["copied"], {"copied": [total]}, 1)


def insert_rows(session, table: str, columns: list[str],
                rows: list[list]) -> object:
    from ..executor.runner import ResultSet

    n, _pending = prepare_rows(session, table, columns, rows, commit=True)
    return ResultSet(["inserted"], {"inserted": [n]}, 1)


def prepare_rows(session, table: str, columns: list[str], rows: list[list],
                 commit: bool = True) -> tuple[int, list]:
    """Type-convert + route + write per-shard stripes.  With commit=False
    the stripes stay invisible and the (shard_id, record) list is returned
    for the caller to fold into one atomic apply_dml/commit_pending (MERGE
    uses this so its inserts land in the same manifest flip as its
    updates/deletes)."""
    meta = session.catalog.table(table)
    if set(columns) != set(meta.schema.names):
        missing = [c for c in meta.schema.names if c not in columns]
        # unspecified columns become NULL
        for r in rows:
            r.extend([None] * len(missing))
        columns = columns + missing
    cells = {c: [r[i] for r in rows] for i, c in enumerate(columns)}
    text_cells = {}
    for c in columns:
        col_def = meta.schema.column(c)
        vals = []
        for v in cells[c]:
            if v is None:
                vals.append(None)
            elif col_def.dtype == DataType.DATE and isinstance(v, str):
                vals.append(date_to_days(v))
            else:
                vals.append(v)
        text_cells[c] = vals
    return _ingest_batch(session, table, meta.schema.names,
                         [text_cells[c] for c in meta.schema.names],
                         pre_typed=True, commit=commit)


def _ingest_batch(session, table: str, columns: list[str],
                  batch: list[list], pre_typed: bool = False,
                  commit: bool = True) -> tuple[int, list]:
    """batch: per-column list of python values (str|None from COPY).
    Returns (row_count, pending); pending is non-empty only when
    commit=False."""
    meta = session.catalog.table(table)
    n = len(batch[0])
    if n == 0:
        return 0, []
    # inside an open transaction, commits stage into the overlay instead
    # (visible to this session, durable at COMMIT)
    in_txn = getattr(session, "txn_manager", None) is not None and \
        session.txn_manager.current is not None
    stage_txn = commit and in_txn
    if stage_txn:
        commit = False
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
    # rows per stripe file (ref default 150000): an ingest batch larger
    # than the limit splits into several stripes
    stripe_limit = max(1, int(session.settings.get(
        "columnar_stripe_row_limit")))

    if meta.method == DistributionMethod.HASH:
        dist_col = meta.distribution_column
        shards = session.catalog.table_shards(table)
        if not validity[dist_col].all():
            raise IngestError(
                f"NULL distribution column value in {table!r}")
        tokens = _routing_tokens(session, table, dist_col,
                                 meta.schema.column(dist_col).dtype,
                                 typed[dist_col])
        pending = []
        # exclusive target-shard locks for autocommit ingest: a concurrent
        # shard split must not flip the catalog between our routing and
        # our manifest commit (in-transaction staging skips this; the
        # DML paths hold their own locks).  Routing re-derives under the
        # locks if the catalog moved while we waited.
        lock_txid = None
        if commit and getattr(session, "locks", None) is not None:
            from ..transaction.clock import global_clock

            lock_txid = global_clock.now()
        while True:
            version = session.catalog.version
            shards = session.catalog.table_shards(table)
            shard_idx = shard_index_for_token_ranges(
                tokens, session.catalog.shard_mins(table))
            if lock_txid is None:
                break
            for sid in sorted(s.shard_id for i, s in enumerate(shards)
                              if bool((shard_idx == i).any())):
                session.locks.acquire(lock_txid, (table, sid))
            # a split in ANOTHER session commits catalog.json while we
            # wait on its shard lock — without adopting it here the
            # write would land in the dropped parent shard and vanish
            import os as _os

            session.catalog.maybe_reload(
                _os.path.join(session.data_dir, "catalog.json"))
            if session.catalog.version == version:
                break
            session.locks.release_all(lock_txid)
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
                # a failure mid-loop must still hand the already-written
                # (invisible) stripes to the error path's
                # discard_pending, or their files leak forever
                # (list.append/extend are GIL-atomic — safe from the
                # thread pool)
                pending.extend(recs)
                raise
            return recs

        try:
            if n >= 65_536 and len(shards) > 1:
                # per-shard stripe writes in parallel: compression and
                # fsync release the GIL (the pipelined fan-out of the
                # reference's per-shard COPY connections, multi_copy.c)
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(
                        max_workers=min(8, len(shards))) as pool:
                    futs = [pool.submit(write_one, i, s)
                            for i, s in enumerate(shards)]
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
                for i, s in enumerate(shards):
                    r = write_one(i, s)
                    if r is not None:
                        pending.extend(r)
            if commit:
                session.store.commit_pending(table, pending)
                pending = []
        except Exception as e:
            # a failed later shard must not leak the earlier shards'
            # already-written (invisible) stripe files.  But a
            # POST-VISIBILITY failure (change-log emit runs after
            # commit_pending's manifest flip, cdc/feed.py tags it)
            # leaves the stripes COMMITTED — discarding would unlink
            # files the manifest references, i.e. silent data loss the
            # next reader trips over as a missing-stripe read error
            if not getattr(e, "post_visibility", False):
                session.store.discard_pending(table, pending)
            raise
        finally:
            if lock_txid is not None:
                session.locks.release_all(lock_txid)
    else:
        shard = session.catalog.table_shards(table)[0]
        # write every stripe invisible, flip the manifest ONCE: a
        # failure on stripe k must not leave stripes 1..k-1 committed
        # (the same atomic protocol as the hash path above)
        pending = []
        try:
            for lo in range(0, n, stripe_limit):
                hi = min(n, lo + stripe_limit)
                rec = session.store.append_stripe(
                    table, shard.shard_id,
                    {c: a[lo:hi] for c, a in typed.items()},
                    {c: a[lo:hi] for c, a in validity.items()},
                    codec=codec, level=level, chunk_rows=chunk_rows,
                    commit=False)
                pending.append((shard.shard_id, rec))
            if commit:
                session.store.commit_pending(table, pending)
                pending = []
        except Exception as e:
            # post-visibility failures leave the batch committed: the
            # discard would delete manifest-referenced stripe files
            # (same rule as the hash path above)
            if not getattr(e, "post_visibility", False):
                session.store.discard_pending(table, pending)
            raise
    if stage_txn:
        session.txn_manager.current.stage_dml(table, {}, pending)
        pending = []
    return n, pending


def _routing_tokens(session, table, column, dtype, values: np.ndarray):
    if dtype == DataType.STRING:
        # codes → per-code routing token via the dictionary's token table
        d = session.store.dictionary(table, column)
        token_table = d.hash_tokens()
        return token_table[values]
    return hash_token(values)


def _convert_column(session, table, name, dtype: DataType, cells,
                    pre_typed: bool):
    n = len(cells)
    # bulk-load fast path: a numeric numpy column has no Nones by
    # construction — skip the per-value validity scan entirely
    if pre_typed and isinstance(cells, np.ndarray) \
            and cells.dtype != object:
        if dtype == DataType.STRING:
            raise IngestError(
                f"column {name!r}: string column fed a numeric array")
        return (cells.astype(dtype.numpy_dtype, copy=False),
                np.ones(n, dtype=bool))
    # list.count(None) is a C-level scan: the common bulk case (no NULLs
    # at all) skips the per-value Python validity comprehension entirely
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
            # vectorized int parse
            vals = np.array([c if v else "0" for c, v in zip(cells, valid)])
            out = vals.astype(np.int64).astype(np_dtype)
        else:
            vals = np.array([c if v else "0" for c, v in zip(cells, valid)])
            out = vals.astype(np.float64).astype(np_dtype)
    except ValueError as exc:
        raise IngestError(f"column {name!r}: {exc}") from exc
    return out, valid
