"""Pipelined columnar scan: overlapped prefetch/decode/transfer with
optional on-device decode of compressed column payloads.

Counterpart of citus_tpu/executor/scanpipe.py.  The
eager feed path (executor/feed.py `_feed_scan`) reads and decodes every
stripe, assembles every column, then copies them one after another.
Here one producer thread and a bounded queue overlap the three:

* **prefetch + decode** (producer thread): columns are read one at a
  time across all visible stripes through the native codec, with the
  chunk-group skip set computed ONCE per stripe over the full
  projection's stats and pinned for every column so rows stay aligned.
  Stripes with deletions read whole and drop their deleted rows.
* **asynchronous transfer**: on a CUDA session the producer assembles
  each column straight into a pinned host buffer (its numpy view) and
  places it through the accounted seam (`DeviceMemoryAccountant`,
  category ``prefetch``) with a non-blocking copy on its own CUDA
  stream, then records an event.  The consumer (the statement thread)
  makes its stream wait on that event and `record_stream`s the adopted
  tensor, so the caching allocator never hands the memory out while the
  statement stream still reads it.  Prefetch charges graduate to their
  final category on adoption; an allocator OOM while prefetching sheds
  the pipeline (the queue drains, every prefetch charge releases) and
  the feed retries eagerly.
* **on-device decode** (``scan_pipeline=device``): integer/date/string-
  code columns cross the link frame-of-reference packed to the
  narrowest unsigned width, low-NDV float columns as dictionary codes
  plus a small value table (expanded by the `dict_decode` kernel),
  null planes bit-packed 8:1 (expanded by `bit_unpack`), and the valid
  prefix of a sharded feed as one row count.

At one position a HASH table's buffer is the concatenation of its
shards in shard order, exactly where the eager path puts each row, so
the `off`, `host` and `device` modes answer identically.  On a mesh
whose positions share one card the buffer is an [n_positions, cap]
plane, row i holding position i's shards in shard order (the eager
path's device-owned slices): the wire encodings, `bit_unpack` and
`dict_decode` run over the whole plane, so one launch serves every
position.  A mesh over several cards takes the eager path.  On the CPU
`host` mode uses `torch.from_numpy` (no pinning) and `device` mode runs
the same encodings through the kernels' plain versions.

Observability, as in the reference: the producer adopts the statement's
trace context, so its `scan.prefetch` / `scan.wire_encode` /
`scan.transfer` spans nest under the feed span on their own track (a
transfer carries a CUDA event pair on the side stream: its device_ms);
the consumer records `scan.device_decode`.  Chunk tallies fold into the
session's counters on the statement thread; the consumer's queue pops
are cancellation seams; `executor.scan_prefetch` (a producer column
read) and `executor.device_decode` (a wire payload's expansion) are
named fault points.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
import traceback

import numpy as np
import torch

from ..errors import CorruptStripe, DeviceMemoryExhausted
from ..stats import counters as sc
from ..stats.tracing import (
    adopt_context,
    capture_context,
    device_timeline,
    trace_span,
)
from ..storage.table_store import tag_failed_read
from ..utils.cancellation import check_cancel
from ..utils.faultinjection import fault_point

# below this many table rows 'auto' keeps the eager path: a producer
# thread + per-column reads cost more than they hide on tiny feeds
AUTO_MIN_ROWS = 4096

# dictionary encoding applies up to this many distinct values (uint16
# codes); the NDV probe samples this many rows before paying a full
# np.unique over the column
_DICT_MAX_NDV = 65536
_NDV_SAMPLE = 65536

# columns in flight between the producer and the consumer; each holds
# its prefetch-category device bytes until the consumer adopts it
PREFETCH_DEPTH = 2


class ScanPhaseStats:
    """Per-executor accumulator for the scan pipeline's phase walls and
    wire/decoded byte totals, and the stream's (executor/stream.py):
    the producer's host decode and copy enqueue, the host merge of the
    per-batch parts.  The walls are host-clock seconds: on a
    CUDA session `transfer_seconds` and `device_decode_seconds` time the
    enqueue of asynchronous copies and kernels, not their run on the
    card."""

    FIELDS = ("prefetch_seconds", "decode_seconds", "transfer_seconds",
              "device_decode_seconds", "bytes_on_wire", "bytes_decoded",
              "prefetch_stalls", "chunks_prefetched", "feeds_pipelined",
              "stream_decode_seconds", "stream_transfer_seconds",
              "stream_merge_seconds")

    def __init__(self):
        self._mu = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._mu:
            for f in self.FIELDS:
                setattr(self, f, 0.0 if "seconds" in f else 0)

    def add(self, **kw) -> None:
        with self._mu:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + v)

    def snapshot(self) -> dict:
        with self._mu:
            return {f: getattr(self, f) for f in self.FIELDS}

    def merge(self, other: "ScanPhaseStats") -> None:
        """Fold a completed pipeline's local tallies in (discarded
        attempts never fold, so the published walls describe only
        builds whose feeds were used)."""
        self.add(**other.snapshot())


def resolve_scan_mode(settings, device) -> str:
    """The scan_pipeline mode a session on `device` runs: 'off', 'host'
    or 'device' ('auto' resolves by the session's device — device
    decode where a link separates host and card, host on the CPU)."""
    if settings is None:
        return "off"
    raw = settings.get("scan_pipeline")
    if raw != "auto":
        return raw
    return "device" if torch.device(device).type == "cuda" else "host"


class _Shed(Exception):
    """Internal: an OOM while prefetching — drain and retry eagerly."""


class _Stopped(Exception):
    """Internal: the consumer ended the statement — place nothing more."""


# ---------------------------------------------------------------------------
# wire encodings (host side; byte-identical to the JAX package's)

def _encode_for(buf: np.ndarray):
    """Frame-of-reference pack an integer buffer to the narrowest
    unsigned width; None when no narrower width exists."""
    if buf.size == 0:
        return None
    mn = int(buf.min())
    span = int(buf.max()) - mn
    for limit, wdt in ((1 << 8, np.uint8), (1 << 16, np.uint16),
                       (1 << 32, np.uint32)):
        if span < limit:
            if np.dtype(wdt).itemsize >= buf.dtype.itemsize:
                return None
            wire = (buf.astype(np.int64) - mn).astype(wdt)
            return wire, np.asarray(mn, dtype=buf.dtype)
    return None


def _encode_dict(buf: np.ndarray):
    """Dictionary-code a low-NDV float buffer (codes + LUT); None when
    the column is too distinct (or carries NaN) to pay for itself."""
    if buf.size == 0 or np.isnan(buf).any():
        return None
    flat = buf.reshape(-1)
    if flat.size > 4 * _NDV_SAMPLE:
        step = max(1, flat.size // _NDV_SAMPLE)
        if len(np.unique(flat[::step])) > _DICT_MAX_NDV // 4:
            return None  # sample already too distinct: skip the full sort
    lut = np.unique(flat)
    if len(lut) > _DICT_MAX_NDV:
        return None
    wdt = np.uint8 if len(lut) <= 256 else np.uint16
    codes = np.searchsorted(lut, buf).astype(wdt)
    if codes.nbytes + lut.nbytes >= buf.nbytes:
        return None
    return codes, lut.astype(buf.dtype)


def encode_column(buf: np.ndarray):
    """(kind, wire, extra) for one assembled feed buffer: 'for' (wire =
    offsets, extra = base scalar), 'dict' (wire = codes, extra = LUT)
    or 'plain' (wire = buf)."""
    if np.issubdtype(buf.dtype, np.integer) and \
            buf.dtype.itemsize > 1:
        packed = _encode_for(buf)
        if packed is not None:
            return "for", packed[0], packed[1]
    if np.issubdtype(buf.dtype, np.floating):
        packed = _encode_dict(buf)
        if packed is not None:
            return "dict", packed[0], packed[1]
    return "plain", buf, None


# ---------------------------------------------------------------------------
# on-device decode

def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def for_expand(wire: torch.Tensor, base: np.ndarray) -> torch.Tensor:
    """Inverse of `_encode_for`: offsets of any unsigned width + base, in
    the base's dtype."""
    return wire.to(_torch_dtype(base.dtype)) + int(base)


def _valid_expand(rows: torch.Tensor, cap: int) -> torch.Tensor:
    return torch.arange(cap, dtype=torch.int32, device=rows.device) < rows


# ---------------------------------------------------------------------------
# the pipeline

def maybe_pipelined_feed(node, catalog, store, device, compute_dtype,
                         accountant, category: str, stats, counters=None,
                         mesh=None):
    """Build `node`'s feed through the pipelined path, or return None
    (caller proceeds on the eager path): scan_pipeline off / too small
    under 'auto' / open-transaction overlay on the table / the pipeline
    shed itself after a prefetch OOM."""
    from .feed import _overlay_touches

    settings = store.settings
    mode = resolve_scan_mode(settings, device)
    if mode == "off":
        return None
    if _overlay_touches(store, node.rel.table):
        return None  # session-private visibility: eager reads it exactly
    if settings.get("scan_pipeline") == "auto" and \
            store.table_row_count(node.rel.table) < AUTO_MIN_ROWS:
        return None
    if mesh is not None and mesh.size > 1 and not mesh.single_device():
        return None  # per-card slices: the eager path places them
    pipe = _ScanPipeline(node, catalog, store, torch.device(device),
                         compute_dtype, mode, accountant, category, stats,
                         counters, mesh)
    try:
        return pipe.run()
    except _Shed:
        # prefetch OOM: the pipeline drained (every prefetch charge
        # released) — the eager retry is the cheapest rung of all
        return None


class _ScanPipeline:
    def __init__(self, node, catalog, store, device, compute_dtype, mode,
                 accountant, category, stats, counters=None, mesh=None):
        from ..catalog import DistributionMethod
        from ..errors import ExecutionError
        from ..planner.plan import table_placement
        from .feed import make_chunk_filter

        self.node = node
        self.store = store
        self.device = device
        self.cuda = device.type == "cuda"
        self.mode = mode
        self.acc = accountant
        self.category = category
        # tallies accumulate LOCALLY and fold into the executor-wide
        # accumulator only when the pipeline completes — a shed/failed
        # build's phase walls must not skew the published stats
        self.stats_out = stats
        self.stats = ScanPhaseStats()
        # the session's StatCounters; the producer's chunk tallies fold
        # into it on the statement thread (a producer-thread increment
        # would leak a counter slot per feed)
        self.counters = counters
        self.chunks_prefetched = 0
        self.chunks_skipped = 0
        self.table = node.rel.table
        meta = catalog.table(self.table)
        self.sharded = meta.method == DistributionMethod.HASH
        self.colnames = [cid.split(".", 1)[1] for cid in node.columns]
        self.dtypes = []
        for cname in self.colnames:
            dt = meta.schema.column(cname).dtype.numpy_dtype
            if dt == np.float64 and compute_dtype is not None:
                dt = np.dtype(compute_dtype)
            self.dtypes.append(np.dtype(dt))
        self.storage_of = {c: store.storage_column_name(self.table, c)
                           for c in self.colnames}
        name_map = {c.name: store.storage_column_name(self.table, c.name)
                    for c in meta.schema.columns}
        # no counters: the filter runs on the producer thread; skips
        # are tallied from the selection result and folded later
        self.chunk_filter = (make_chunk_filter(node.filter, name_map)
                             if node.filter is not None else None)
        # read units: (shard_id, record) in shard order — the order the
        # eager path concatenates, so rows land identically
        shards = catalog.table_shards(self.table)
        # positions of the plane (1: a flat [cap] buffer)
        self.n_pos = (mesh.size if self.sharded and mesh is not None
                      else 1)
        pos_of = ((0,) * len(shards) if self.n_pos == 1 else
                  table_placement(catalog, self.table, self.n_pos))
        if self.sharded:
            keep = [i for i, s in enumerate(shards)
                    if node.pruned_shards is None
                    or s.shard_index in node.pruned_shards]
            shards = [shards[i] for i in keep]
            pos_of = [pos_of[i] for i in keep]
        elif len(shards) != 1:
            raise ExecutionError(f"table {self.table}: expected single "
                                 "shard")
        self.tasks = []
        self.task_pos = []
        for s, pos in zip(shards, pos_of):
            for rec in store.shard_stripe_records(self.table, s.shard_id):
                self.tasks.append((s.shard_id, rec))
                self.task_pos.append(pos)
        self.rows_by_pos = [0] * self.n_pos
        # per-task layout, filled by the first column pass:
        # [dest_offset, selected_chunks|None, keep_mask|None, n_chunks]
        self.layout: list[list] = [[0, None, None, 0] for _ in self.tasks]
        self.rows = 0
        self.cap = 0
        self._readers: dict[str, object] = {}
        self.q: queue.Queue = queue.Queue(maxsize=PREFETCH_DEPTH)
        self.stop_evt = threading.Event()
        self.side = None  # the producer's CUDA stream

    # -- producer ----------------------------------------------------------
    def _reader(self, path: str):
        r = self._readers.get(path)
        if r is None:
            from ..storage.format import StripeReader

            r = StripeReader(path, verify=self.store._verify_enabled())
            self._readers[path] = r
        return r

    def _verified(self, ti: int, fn):
        """`fn(reader)` over stripe `ti` through the store's read-repair
        seam (`verified_read`).  A copy that fails verification loses
        its cached reader, and verified_read answers from a copy that
        verifies (healing the bad one in place), so the remaining
        columns of the stripe read verified bytes — all on the host,
        before the wire encode, so a flipped byte never reaches the
        card's decode."""
        sid, rec = self.tasks[ti]

        def read_one(path):
            try:
                return fn(self._reader(path))
            except CorruptStripe:
                self._readers.pop(path, None)
                raise

        return self.store.verified_read(self.table, sid, rec["file"],
                                        read_one)

    def _read_stripe_column(self, ti: int, cname: str, first: bool):
        """One (stripe, column) read.  Returns (values, validity, n)
        AFTER delete-mask filtering; the first column's pass records the
        chunk selection + keep mask the later columns are pinned to."""
        sid, rec = self.tasks[ti]
        try:
            return self._read_stripe_column_at(ti, sid, rec, cname, first)
        except Exception as e:
            # the eager path's failover contract: a failed read carries
            # (table, shard_id), so the statement retry loop routes the
            # next attempt to a surviving replica
            tag_failed_read(e, self.table, sid)
            raise

    def _read_stripe_column_at(self, ti, sid, rec, cname, first):
        if first:
            fault_point("store.read_shard")
        lay = self.layout[ti]
        storage = self.storage_of[cname]
        # the stripe's deletion bitmap (an overlay never reaches here:
        # such tables take the eager path)
        dmask = (self.store.effective_delete_mask(self.table, sid, rec)
                 if first else None)

        def read_one(reader):
            present_all = [self.storage_of[c] for c in self.colnames
                           if self.storage_of[c] in reader._by_name]
            if first:
                # chunk selection over the FULL projection's stats,
                # computed once and pinned for every column; stripes
                # with deletions read whole (positions must align with
                # the bitmap).  Slot writes only: a failover re-runs
                # this closure on another copy
                if dmask is None and self.chunk_filter is not None \
                        and present_all:
                    lay[1] = reader.selected_chunks(present_all,
                                                    self.chunk_filter)
                lay[2] = (None if dmask is None or not dmask.any()
                          else ~dmask)
                lay[3] = reader.n_chunks
            sel = lay[1]
            if storage in reader._by_name:
                rv, rm, n = reader.read([storage], chunks=sel)
                return rv[storage], rm[storage], n
            # column added by ALTER TABLE after this stripe was written:
            # reads as all-NULL (eager-path contract)
            n = (reader.row_count if sel is None
                 else sum(reader.footer["chunk_rows"][i] for i in sel))
            return (np.zeros(n, dtype=self.dtypes[
                self.colnames.index(cname)]),
                np.zeros(n, dtype=np.bool_), n)

        v, m, n = self._verified(ti, read_one)
        if first:
            n_ch = len(lay[1]) if lay[1] is not None else lay[3]
            self.chunks_prefetched += n_ch
            self.chunks_skipped += lay[3] - n_ch
            self._stat(chunks_prefetched=n_ch)
        keep = lay[2]
        if keep is not None:
            v, m = v[keep], m[keep]
            n = int(keep.sum())
        return v, m, n

    def _host_buffer(self, dtype):
        """A [n_pos · cap] host staging buffer as (tensor, numpy view):
        pinned on a CUDA session, so its copy runs asynchronously and
        the caching host allocator keeps it until the copy is done."""
        size = self.n_pos * self.cap
        if self.cuda:
            t = torch.empty(size, dtype=_torch_dtype(dtype),
                            pin_memory=True)
            return t, t.numpy()
        a = np.empty(size, dtype=dtype)
        return torch.from_numpy(a), a

    def _staged(self, arr: np.ndarray) -> torch.Tensor:
        """A host array the encoder produced, as a tensor the seam can
        copy asynchronously (pinned on a CUDA session)."""
        t = torch.from_numpy(arr)
        return t.pin_memory() if self.cuda else t

    def _assemble(self, ci: int, pieces=None):
        """[cap] buffer + nulls plane for column ci (each as (tensor,
        numpy view), nulls None when the column has none) — from the
        first pass's saved pieces, or by re-reading at the recorded
        offsets."""
        cname = self.colnames[ci]
        buf_t, buf = self._host_buffer(self.dtypes[ci])
        # [0, rows) is written piece by piece below; the padding must be
        # zero, as the eager path's np.zeros buffer is (the FOR encoding
        # reads the padding's minimum too)
        if self.n_pos == 1:
            buf[self.rows:] = 0
        else:
            buf[:] = 0
        nulls = None
        for ti in range(len(self.tasks)):
            if pieces is not None:
                v, m, n = pieces[ti]
            else:
                fault_point("executor.scan_prefetch")
                v, m, n = self._read_stripe_column(ti, cname, first=False)
            off = self.layout[ti][0] + self.task_pos[ti] * self.cap
            if n == 0:
                continue
            buf[off:off + n] = v
            if not m.all():
                if nulls is None:
                    nulls = self._host_buffer(np.bool_)
                    nulls[1][:] = False
                nulls[1][off:off + n] = ~m
        return (buf_t, buf), nulls

    def _first_pass(self):
        """Read column 0 across every stripe, recording the layout every
        later column is pinned to.  A zero-column projection (bare
        count(*)) needs only row counts: footers + delete masks."""
        pieces = []
        for ti, (sid, rec) in enumerate(self.tasks):
            if self.colnames:
                v, m, n = self._read_stripe_column(ti, self.colnames[0],
                                                   first=True)
                pieces.append((v, m, n))
            else:
                dmask = self.store.effective_delete_mask(self.table, sid,
                                                         rec)
                n = self._verified(ti, lambda r: r.row_count)
                if dmask is not None and dmask.any():
                    n = int((~dmask).sum())
            pos = self.task_pos[ti]
            self.layout[ti][0] = self.rows_by_pos[pos]
            self.rows_by_pos[pos] += n
            self.rows += n
        from .compiler import _round_cap

        self.cap = _round_cap(max(max(self.rows_by_pos), 1))
        return pieces

    def _copies(self):
        """Context for the producer's copies: its own CUDA stream."""
        if self.side is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.side)

    def _place(self, host_t: torch.Tensor):
        """Accounted placement from the producer thread under the
        sheddable prefetch category — the copy is in flight while the
        next column decodes.  Once the consumer has ended the statement
        nothing more is placed."""
        if self.stop_evt.is_set():
            raise _Stopped()
        return self.acc.place_tracked(host_t, self.device, "prefetch")

    def _done_copying(self, payload: dict) -> dict:
        if self.side is not None:
            payload["event"] = self.side.record_event()
        return payload

    def _transfer(self):
        """The scan.transfer span of one placement, with its CUDA event
        pair on the producer's stream (entered inside _copies())."""
        sp = trace_span("scan.transfer")
        return sp, device_timeline(sp, self.device)

    def _encode_and_place(self, ci: int, buf, nulls) -> dict:
        """Wire-encode (device mode) + place one column; returns the
        queue payload the consumer finishes."""
        buf_t, buf_a = buf
        t0 = time.perf_counter()
        if self.mode != "device":
            sp, leg = self._transfer()
            with self._copies(), sp, leg:
                arr, h = self._place(buf_t)
                payload = {"kind": "plain", "arr": arr, "handle": h,
                           "wire": buf_a.nbytes, "decoded": buf_a.nbytes}
                if nulls is not None:
                    narr, nh = self._place(nulls[0])
                    payload.update(
                        nulls=narr, nulls_handle=nh,
                        wire=payload["wire"] + nulls[1].nbytes,
                        decoded=payload["decoded"] + nulls[1].nbytes)
            self._stat(transfer_seconds=time.perf_counter() - t0)
            return self._done_copying(payload)
        with trace_span("scan.wire_encode"):
            kind, wire, extra = encode_column(buf_a)
            packed = (np.packbits(nulls[1], axis=-1)
                      if nulls is not None else None)
            wire_t = buf_t if wire is buf_a else self._staged(wire)
            lut_t = self._staged(extra) if kind == "dict" else None
            packed_t = (self._staged(packed) if packed is not None
                        else None)
        t1 = time.perf_counter()
        sp, leg = self._transfer()
        with self._copies(), sp, leg:
            arr, h = self._place(wire_t)
            payload = {"kind": kind, "arr": arr, "handle": h,
                       "wire": wire.nbytes, "decoded": buf_a.nbytes}
            if kind == "for":
                payload["base"] = extra
            elif kind == "dict":
                lut, lh = self._place(lut_t)
                payload.update(lut=lut, lut_handle=lh,
                               wire=payload["wire"] + extra.nbytes)
            if packed_t is not None:
                narr, nh = self._place(packed_t)
                payload.update(nulls=narr, nulls_handle=nh,
                               nulls_packed=True,
                               wire=payload["wire"] + packed.nbytes,
                               decoded=payload["decoded"] + nulls[1].nbytes)
        self._stat(decode_seconds=t1 - t0,
                   transfer_seconds=time.perf_counter() - t1)
        return self._done_copying(payload)

    def _valid_payload(self) -> dict:
        t0 = time.perf_counter()
        sp, leg = self._transfer()
        with self._copies(), sp, leg:
            if self.mode == "device" and self.sharded:
                rows = np.asarray(self.rows_by_pos, dtype=np.int32)
                arr, h = self._place(self._staged(rows))
                payload = {"kind": "rows", "arr": arr, "handle": h,
                           "wire": rows.nbytes,
                           "decoded": self.n_pos * self.cap}
            else:
                valid_t, valid = self._host_buffer(np.bool_)
                valid[:] = False
                for pos, r in enumerate(self.rows_by_pos):
                    valid[pos * self.cap:pos * self.cap + r] = True
                arr, h = self._place(valid_t)
                payload = {"kind": "plain", "arr": arr, "handle": h,
                           "wire": valid.nbytes, "decoded": valid.nbytes}
        self._stat(transfer_seconds=time.perf_counter() - t0)
        return self._done_copying(payload)

    def _stat(self, **kw):
        self.stats.add(**kw)

    def _put(self, item) -> bool:
        while not self.stop_evt.is_set():
            try:
                self.q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        # the producer adopts the statement's trace context: its
        # prefetch/encode/transfer spans nest under the span open when
        # run() captured the token (the feed build), on the producer's
        # own track; anything it leaves open is force-closed and counted
        with adopt_context(self._trace_ctx):
            self._produce_columns()

    def _produce_columns(self):
        try:
            if self.cuda:
                torch.cuda.set_device(self.device)
                self.side = torch.cuda.Stream(device=self.device)
            t0 = time.perf_counter()
            with trace_span("scan.prefetch"):
                pieces = self._first_pass()
            self._stat(prefetch_seconds=time.perf_counter() - t0)
            if self.colnames:
                buf, nulls = self._assemble(0, pieces)
                del pieces
                if not self._put(("col", self.node.columns[0],
                                  self._encode_and_place(0, buf, nulls))):
                    return
                del buf, nulls
            for ci in range(1, len(self.colnames)):
                t0 = time.perf_counter()
                with trace_span("scan.prefetch"):
                    buf, nulls = self._assemble(ci)
                self._stat(prefetch_seconds=time.perf_counter() - t0)
                if not self._put(("col", self.node.columns[ci],
                                  self._encode_and_place(ci, buf, nulls))):
                    return
                del buf, nulls
            if not self._put(("valid", None, self._valid_payload())):
                return
            self._put(("done", None, None))
        except _Stopped:
            return
        except DeviceMemoryExhausted as e:
            # the traceback's finished frames may hold placed prefetch
            # tensors: clear them so those charges release now
            traceback.clear_frames(e.__traceback__)
            self._put(("shed", None, e))
        except BaseException as e:  # noqa: BLE001 — not swallowed: forwarded over the queue and re-raised on the consumer thread
            traceback.clear_frames(e.__traceback__)
            self._put(("err", None, e))

    # -- consumer ----------------------------------------------------------
    def _drain(self):
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                return

    def _finish_col(self, payload):
        """Adopt one placed column on the statement thread: wait for its
        copies, recharge a plain placement to its final category, or
        expand a wire payload on the device and adopt the output."""
        from ..ops import hopper_kernels as hk

        if "event" in payload:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(payload["event"])
            for key in ("arr", "lut", "nulls"):
                if payload.get(key) is not None:
                    payload[key].record_stream(cur)
        cat = self.category
        self._stat(bytes_on_wire=payload["wire"],
                   bytes_decoded=payload["decoded"])
        kind = payload["kind"]
        decoded_nulls = None
        if payload.get("nulls") is not None:
            if payload.get("nulls_packed"):
                fault_point("executor.device_decode")
                t0 = time.perf_counter()
                with trace_span("scan.device_decode"):
                    decoded_nulls = hk.bit_unpack(payload["nulls"],
                                                  self.n_pos * self.cap)
                    self.acc.adopt(decoded_nulls, cat)
                self._stat(device_decode_seconds=time.perf_counter() - t0)
                self._count_decoded(decoded_nulls)
            else:
                self.acc.recharge(payload["nulls_handle"], cat)
                decoded_nulls = payload["nulls"]
        if kind == "plain":
            self.acc.recharge(payload["handle"], cat)
            return payload["arr"], decoded_nulls
        # named seam: a failure while expanding a wire payload must
        # surface as a clean statement error with the charge released
        fault_point("executor.device_decode")
        t0 = time.perf_counter()
        with trace_span("scan.device_decode"):
            if kind == "for":
                decoded = for_expand(payload["arr"], payload["base"])
            elif kind == "dict":
                decoded = hk.dict_decode(payload["arr"], payload["lut"])
            else:  # rows → each position's valid prefix
                decoded = _valid_expand(payload["arr"][:, None],
                                        self.cap).reshape(-1)
            self.acc.adopt(decoded, cat)
        self._stat(device_decode_seconds=time.perf_counter() - t0)
        self._count_decoded(decoded)
        return decoded, decoded_nulls

    def _count_decoded(self, arr: torch.Tensor) -> None:
        if self.counters is not None:
            self.counters.increment(sc.DEVICE_DECODED_BYTES_TOTAL,
                                    arr.numel() * arr.element_size())

    def run(self):
        from .feed import FeedSpec

        # hand the statement's trace context to the producer thread
        # (None when nothing is traced — adoption then no-ops)
        self._trace_ctx = capture_context()
        t = threading.Thread(target=self._produce, daemon=True,
                             name="scan-prefetch")
        t.start()
        arrays: dict = {}
        nulls: dict = {}
        valid = None
        payload = None
        waiting = False
        got_first = False
        try:
            while True:
                # queue pops are the consumer's cancellation seams (the
                # finally below unwinds the producer cleanly)
                check_cancel()
                try:
                    kind, cid, payload = self.q.get(timeout=0.25)
                except queue.Empty:
                    # the initial fill is not an underrun: the first
                    # column's full read can never be hidden behind a
                    # previous one
                    if not waiting and got_first:
                        waiting = True
                        self._stat(prefetch_stalls=1)
                        if self.counters is not None:
                            self.counters.increment(
                                sc.PREFETCH_STALLS_TOTAL)
                    continue
                waiting = False
                got_first = True
                if kind == "err":
                    raise payload
                if kind == "shed":
                    # the same attempt redoes this feed eagerly (its
                    # chunk filter counts skips afresh): this build's
                    # tallies must not fold too
                    self.chunks_prefetched = self.chunks_skipped = 0
                    raise _Shed()
                if kind == "done":
                    break
                if kind == "col":
                    a, nb = self._finish_col(payload)
                    arrays[cid] = a
                    if nb is not None:
                        nulls[cid] = nb
                else:  # valid
                    valid, _ = self._finish_col(payload)
                payload = None
        except BaseException as e:
            # the traceback keeps the frames it passed through (this
            # one's and the decode's) and with them the in-flight
            # payload: clear the finished ones so its prefetch charges
            # release now, not when the error is collected
            traceback.clear_frames(e.__traceback__)
            raise
        finally:
            payload = None
            self.stop_evt.set()
            self._drain()  # so a blocked put wakes immediately
            # the producer stops at its next placement or put; a put
            # that won the race with the drain is dropped after the join
            t.join()
            self._drain()
            # producer tallies fold on THIS (statement) thread
            if self.counters is not None:
                if self.chunks_prefetched:
                    self.counters.increment(sc.CHUNKS_PREFETCHED_TOTAL,
                                            self.chunks_prefetched)
                if self.chunks_skipped:
                    self.counters.increment(sc.CHUNKS_SKIPPED,
                                            self.chunks_skipped)
        self._stat(feeds_pipelined=1)
        self.stats_out.merge(self.stats)
        if self.n_pos > 1:
            # position i's column is row i of the plane (views: the
            # plane's accounting finalizer fires when the last one dies)
            def plane(t):
                return t.view(self.n_pos, self.cap)

            arrays = {c: plane(t) for c, t in arrays.items()}
            nulls = {c: plane(t) for c, t in nulls.items()}
            valid = plane(valid)
        return FeedSpec(node=self.node, sharded=self.sharded,
                        arrays=arrays, nulls=nulls, valid=valid,
                        capacity=self.cap,
                        dev_rows=(list(self.rows_by_pos) if self.sharded
                                  else None))
