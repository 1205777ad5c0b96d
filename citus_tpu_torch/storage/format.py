"""Binary stripe format: chunked, compressed, min/max-indexed columnar files.

Structural analogue of the reference's columnar serialization
(Citus src/backend/columnar/columnar_writer.c:252 SerializeChunkData,
:293 FlushStripe; reader: columnar_reader.c:839 DeserializeChunkData) and its
skip-node metadata (src/include/columnar/columnar.h:85-111
ColumnChunkSkipNode: min/max, offsets, compressed sizes).

Key differences, driven by the TPU target:

* The reference maps stripes onto PostgreSQL pages through a logical-offset
  storage layer (columnar_storage.c) so they ride WAL/replication.  Here a
  stripe is a self-contained file (footer-at-end, ORC/Parquet style); + the
  manifest in table_store.py provides atomic visibility (the columnar.stripe
  catalog analogue).
* Values are fixed-width little-endian numpy buffers (strings are dict
  codes), so a decompressed chunk IS the device-ready array — no per-row
  datum materialization loop (reference hot loop, SURVEY §3.4).

Layout (version 2)::

    [magic "CTPS1\\0"][u16 version]
    [compressed buffers ... (values + validity bitmap per column-chunk)]
    [zlib-compressed JSON footer]
    [u32 footer_clen][u32 footer_rlen][u32 footer_crc][magic "CTPSEND\\0"]

End-to-end integrity (v2): every compressed chunk buffer carries a
CRC32 in its skip-node entry (``crc``/``ncrc``) and the footer itself is
covered by ``footer_crc`` — the data_checksums analogue.  Readers verify
on every read (gate: ``storage_verify_checksums``) and raise
``CorruptStripe`` instead of returning flipped bits as data; version-1
stripes (no CRCs) still read, verified structurally only.
"""

from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass

import numpy as np

from ..errors import CorruptStripe, StorageError
from ..types import DataType
from ..utils import io as dio
from ..utils.faultinjection import fault_point
from . import compression

MAGIC = b"CTPS1\x00"
END_MAGIC = b"CTPSEND\x00"
VERSION = 2


@dataclass(frozen=True)
class ChunkStats:
    """Skip-node statistics for one (column, chunk)."""

    min_value: float | int | None
    max_value: float | int | None
    null_count: int


def _stats_for(values: np.ndarray, valid: np.ndarray, dtype: DataType) -> ChunkStats:
    null_count = int((~valid).sum())
    if null_count == len(values):
        return ChunkStats(None, None, null_count)
    vv = values[valid]
    if dtype == DataType.STRING:
        # dictionary CODE range: insertion order isn't value order, but
        # containment checks (equality/IN over codes) are still exact —
        # a chunk whose code range excludes the target can be skipped
        return ChunkStats(int(vv.min()), int(vv.max()), null_count)
    if dtype == DataType.BOOL:
        return ChunkStats(int(vv.min()), int(vv.max()), null_count)
    mn, mx = vv.min(), vv.max()
    if dtype in (DataType.FLOAT32, DataType.FLOAT64):
        if np.isnan(mn) or np.isnan(mx):
            return ChunkStats(None, None, null_count)
        return ChunkStats(float(mn), float(mx), null_count)
    return ChunkStats(int(mn), int(mx), null_count)


def write_stripe(path: str,
                 schema_cols: list[tuple[str, DataType]],
                 columns: dict[str, np.ndarray],
                 validity: dict[str, np.ndarray] | None = None,
                 codec: str = "zstd",
                 level: int = 3,
                 chunk_rows: int = 10_000) -> dict:
    """Write one stripe; returns the footer dict (for manifest bookkeeping)."""
    if not schema_cols:
        raise StorageError("stripe needs at least one column")
    validity = validity or {}
    n = None
    for name, _ in schema_cols:
        if name not in columns:
            raise StorageError(f"missing column {name!r}")
        if n is None:
            n = len(columns[name])
        elif len(columns[name]) != n:
            raise StorageError("column length mismatch")
    if n == 0:
        raise StorageError("empty stripe")
    cid = compression.codec_id(codec)

    chunk_bounds = [(i, min(i + chunk_rows, n)) for i in range(0, n, chunk_rows)]
    footer: dict = {
        "version": VERSION,
        "row_count": n,
        "codec": cid,
        "chunk_rows": [hi - lo for lo, hi in chunk_bounds],
        "columns": [],
    }

    with dio.atomic_stream_writer(path) as f:
        f.write(MAGIC)
        f.write(np.uint16(VERSION).tobytes())
        for name, dtype in schema_cols:
            arr = np.ascontiguousarray(
                columns[name], dtype=dtype.numpy_dtype)
            valid = validity.get(name)
            if valid is None:
                valid = np.ones(n, dtype=np.bool_)
            else:
                valid = np.asarray(valid, dtype=np.bool_)
                if len(valid) != n:
                    raise StorageError("validity length mismatch")
            col_meta = {"name": name, "dtype": dtype.value, "chunks": []}
            for lo, hi in chunk_bounds:
                cvals, cvalid = arr[lo:hi], valid[lo:hi]
                stats = _stats_for(cvals, cvalid, dtype)
                raw_v = cvals.tobytes()
                comp_v = compression.compress(raw_v, cid, level)
                voff = f.tell()
                f.write(comp_v)
                if stats.null_count:
                    raw_n = np.packbits(cvalid).tobytes()
                    comp_n = compression.compress(raw_n, cid, level)
                    noff, nclen, nrlen = f.tell(), len(comp_n), len(raw_n)
                    f.write(comp_n)
                    ncrc = zlib.crc32(comp_n)
                else:
                    noff = nclen = nrlen = ncrc = 0  # all-valid: elided
                col_meta["chunks"].append({
                    "voff": voff, "vclen": len(comp_v), "vrlen": len(raw_v),
                    "noff": noff, "nclen": nclen, "nrlen": nrlen,
                    "crc": zlib.crc32(comp_v), "ncrc": ncrc,
                    "min": stats.min_value, "max": stats.max_value,
                    "nulls": stats.null_count,
                })
            footer["columns"].append(col_meta)
        raw_footer = json.dumps(footer).encode("utf-8")
        comp_footer = zlib.compress(raw_footer, 6)
        f.write(comp_footer)
        f.write(np.uint32(len(comp_footer)).tobytes())
        f.write(np.uint32(len(raw_footer)).tobytes())
        f.write(np.uint32(zlib.crc32(comp_footer)).tobytes())
        f.write(END_MAGIC)
        # named seam: a kill here leaves the streamed tmp torn and no
        # visible stripe (the atomic_stream_writer discipline)
        fault_point("storage.stripe_torn_write")
    return footer


def read_stripe_footer(path: str, verify: bool = True) -> dict:
    """Parse (and, for v2 stripes, CRC-verify) the footer.  Structural
    damage and checksum mismatches raise CorruptStripe so the read path
    can attempt repair from a replica copy."""
    with open(path, "rb") as f:
        head = f.read(len(MAGIC) + 2)
        if len(head) < len(MAGIC) + 2:
            raise CorruptStripe(f"{path}: truncated stripe file")
        if head[:len(MAGIC)] != MAGIC:
            raise CorruptStripe(f"{path}: bad magic")
        version = int(np.frombuffer(head[len(MAGIC):], np.uint16)[0])
        tail_len = (4 + 4 + len(END_MAGIC) if version < 2
                    else 4 + 4 + 4 + len(END_MAGIC))
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size < len(MAGIC) + 2 + tail_len:
            raise CorruptStripe(f"{path}: truncated stripe file")
        f.seek(size - tail_len)
        tail = f.read(tail_len)
        if tail[-len(END_MAGIC):] != END_MAGIC:
            raise CorruptStripe(
                f"{path}: bad end magic (corrupt or partial write)")
        clen = int(np.frombuffer(tail[0:4], dtype=np.uint32)[0])
        rlen = int(np.frombuffer(tail[4:8], dtype=np.uint32)[0])
        fcrc = (int(np.frombuffer(tail[8:12], dtype=np.uint32)[0])
                if version >= 2 else None)
        if clen > size - tail_len - len(MAGIC) - 2:
            raise CorruptStripe(f"{path}: footer length out of range")
        f.seek(size - tail_len - clen)
        comp = f.read(clen)
        if verify and fcrc is not None and zlib.crc32(comp) != fcrc:
            raise CorruptStripe(f"{path}: footer checksum mismatch")
        try:
            raw = zlib.decompress(comp)
        except zlib.error as e:
            raise CorruptStripe(f"{path}: footer undecodable ({e})") from e
        if len(raw) != rlen:
            raise CorruptStripe(f"{path}: footer length mismatch")
    return json.loads(raw)


class StripeReader:
    """Projection + chunk-skipping reader for one stripe file.

    `chunk_filter(stats_by_column) -> bool` receives, per chunk,
    ``{column: (min, max, null_count)}`` for the *projected* columns and
    returns False to skip the chunk — the PruneShards/skip-node analogue at
    chunk granularity (reference: columnar_reader.c chunk-group filtering).
    """

    def __init__(self, path: str, verify: bool = True):
        self.path = path
        self.verify = verify
        self.footer = read_stripe_footer(path, verify=verify)
        self._by_name = {c["name"]: c for c in self.footer["columns"]}

    @staticmethod
    def _check_crc(path: str, buf: bytes, ch: dict, key: str) -> None:
        want = ch.get(key)
        if want is not None and zlib.crc32(buf) != want:
            raise CorruptStripe(
                f"{path}: chunk checksum mismatch "
                f"(voff={ch['voff']}, {key})")

    def verify_all_chunks(self, columns: list[str] | None = None) -> None:
        """CRC every compressed buffer of the given (default: all)
        columns — the scrubber's full-file pass; decode is skipped, so
        this costs one sequential read of the compressed bytes."""
        columns = columns or self.column_names
        with open(self.path, "rb") as f:
            self._verify_chunks(f, columns,
                                list(range(self.n_chunks)))

    def _verify_chunks(self, f, columns: list[str],
                       chunks: list[int]) -> None:
        import mmap

        # one mmap + CRC over slices: page-cached, zero-copy — the
        # whole verify pass costs ~crc32 of the compressed bytes
        # (PERF_NOTES round 10), not a seek/read pair per chunk
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError) as e:  # empty/special file
            raise CorruptStripe(f"{self.path}: unmappable stripe "
                                f"({e})") from e
        try:
            size = len(mm)
            with memoryview(mm) as view:
                # CRCs computed on unnamed temporary slices only: a
                # slice bound to a local would outlive the `with` via
                # the exception traceback and make mm.close() raise
                # BufferError ("exported pointers exist")
                for name in columns:
                    col = self._by_name[name]
                    for i in chunks:
                        ch = col["chunks"][i]
                        if ch.get("crc") is None:
                            return  # v1 stripe: no chunk CRCs anywhere
                        bad = None
                        if ch["voff"] + ch["vclen"] > size:
                            bad = "chunk extends past EOF"
                        elif zlib.crc32(view[ch["voff"]:ch["voff"]
                                             + ch["vclen"]]) \
                                != ch["crc"]:
                            bad = "chunk checksum mismatch"
                        elif ch["nclen"]:
                            if ch["noff"] + ch["nclen"] > size:
                                bad = "validity bitmap past EOF"
                            elif zlib.crc32(
                                    view[ch["noff"]:ch["noff"]
                                         + ch["nclen"]]) != ch["ncrc"]:
                                bad = "validity checksum mismatch"
                        if bad is not None:
                            raise CorruptStripe(
                                f"{self.path}: {bad} "
                                f"(voff={ch['voff']})")
        finally:
            mm.close()

    @property
    def row_count(self) -> int:
        return self.footer["row_count"]

    @property
    def n_chunks(self) -> int:
        return len(self.footer["chunk_rows"])

    @property
    def column_names(self) -> list[str]:
        return [c["name"] for c in self.footer["columns"]]

    def column_dtype(self, name: str) -> DataType:
        return DataType(self._by_name[name]["dtype"])

    def chunk_stats(self, chunk_idx: int, columns: list[str]) -> dict:
        out = {}
        for name in columns:
            ch = self._by_name[name]["chunks"][chunk_idx]
            out[name] = (ch["min"], ch["max"], ch["nulls"])
        return out

    def selected_chunks(self, columns: list[str], chunk_filter=None) -> list[int]:
        if chunk_filter is None:
            return list(range(self.n_chunks))
        return [i for i in range(self.n_chunks)
                if chunk_filter(self.chunk_stats(i, columns))]

    def read(self, columns: list[str] | None = None, chunk_filter=None,
             chunks: list[int] | None = None,
             ) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray], int]:
        """Read (and concatenate) selected chunks of the projected columns.

        Returns (values, validity, row_count_read).

        `chunks` overrides skip-node selection with an explicit chunk
        list — the pipelined scan path (executor/scanpipe.py) reads one
        column at a time and must pin every column of a stripe to the
        chunk set selected ONCE over the full projection's stats (a
        per-column re-selection could disagree and misalign rows).

        The hot path is the native C++ codec (native/stripecodec.cpp):
        each chunk decompresses straight into its row offset of ONE
        preallocated output array per column — no Python per-chunk loop,
        no concatenate copy (reference: columnar_reader.c:839 is C
        end-to-end for the same reason).  Any native failure falls back
        to the pure-Python loop below.
        """
        columns = columns or self.column_names
        for name in columns:
            if name not in self._by_name:
                raise StorageError(f"{self.path}: no column {name!r}")
        cid = self.footer["codec"]
        if chunks is None:
            chunks = self.selected_chunks(columns, chunk_filter)
        native = self._read_native(columns, chunks, cid)
        if native is not None:
            return native
        values: dict[str, list[np.ndarray]] = {c: [] for c in columns}
        validity: dict[str, list[np.ndarray]] = {c: [] for c in columns}
        rows_read = 0
        with open(self.path, "rb") as f:
            for i in chunks:
                nrows = self.footer["chunk_rows"][i]
                rows_read += nrows
                for name in columns:
                    col = self._by_name[name]
                    ch = col["chunks"][i]
                    dtype = DataType(col["dtype"])
                    f.seek(ch["voff"])
                    comp = f.read(ch["vclen"])
                    if self.verify:
                        self._check_crc(self.path, comp, ch, "crc")
                    raw = compression.decompress(comp, cid,
                                                 ch["vrlen"])
                    arr = np.frombuffer(raw, dtype=dtype.numpy_dtype)
                    values[name].append(arr)
                    if ch["nulls"]:
                        f.seek(ch["noff"])
                        compn = f.read(ch["nclen"])
                        if self.verify:
                            self._check_crc(self.path, compn, ch,
                                            "ncrc")
                        rawn = compression.decompress(
                            compn, cid, ch["nrlen"])
                        bits = np.unpackbits(
                            np.frombuffer(rawn, dtype=np.uint8))[:nrows]
                        validity[name].append(bits.astype(np.bool_))
                    else:
                        validity[name].append(np.ones(nrows, dtype=np.bool_))
        out_v = {c: (np.concatenate(values[c]) if values[c]
                     else np.empty(0, dtype=self.column_dtype(c).numpy_dtype))
                 for c in columns}
        out_m = {c: (np.concatenate(validity[c]) if validity[c]
                     else np.empty(0, dtype=np.bool_))
                 for c in columns}
        return out_v, out_m, rows_read

    # codec ids the native library reported unsupported (-DNO_ZSTD
    # builds): skip the doomed task-list + thread spawn on every read
    _native_unsupported: set = set()

    def _read_native(self, columns: list[str], chunks: list[int],
                     cid: int):
        """C++ decode of the selected chunks, or None (caller falls back).
        One ct_decode_column call per column decompresses every chunk
        into a single preallocated array; validity bitmaps unpack in C."""
        from ..native import get_lib

        lib = get_lib()
        if lib is None or not chunks or \
                cid in StripeReader._native_unsupported:
            return None
        if self.verify:
            # the C++ decoder reads raw buffers itself: CRC the
            # compressed bytes in a cheap page-cached pre-pass so the
            # native fast path keeps the same integrity guarantee
            with open(self.path, "rb") as f:
                self._verify_chunks(f, columns, chunks)
        chunk_rows = self.footer["chunk_rows"]
        rows = np.asarray([chunk_rows[i] for i in chunks], dtype=np.int64)
        total = int(rows.sum())
        row_off = np.zeros(len(chunks), dtype=np.int64)
        np.cumsum(rows[:-1], out=row_off[1:])
        path = self.path.encode()
        out_v: dict[str, np.ndarray] = {}
        out_m: dict[str, np.ndarray] = {}
        for name in columns:
            col = self._by_name[name]
            dtype = DataType(col["dtype"]).numpy_dtype
            itemsize = np.dtype(dtype).itemsize
            ch = [col["chunks"][i] for i in chunks]
            voff = np.asarray([c["voff"] for c in ch], dtype=np.int64)
            vclen = np.asarray([c["vclen"] for c in ch], dtype=np.int64)
            vrlen = np.asarray([c["vrlen"] for c in ch], dtype=np.int64)
            arr = np.empty(total, dtype=dtype)
            rc = lib.ct_decode_column(
                path, np.int32(cid), voff, vclen, vrlen,
                row_off * itemsize, len(chunks),
                arr.view(np.uint8), total * itemsize, np.int32(0))
            if rc != 0:
                if rc == -5:  # codec not compiled in: never retry it
                    StripeReader._native_unsupported.add(cid)
                return None
            noff = np.asarray([c["noff"] for c in ch], dtype=np.int64)
            nclen = np.asarray([c["nclen"] for c in ch], dtype=np.int64)
            nrlen = np.asarray([c["nrlen"] for c in ch], dtype=np.int64)
            mask = np.empty(total, dtype=np.uint8)
            rc = lib.ct_decode_validity(
                path, np.int32(cid), noff, nclen, nrlen, rows, row_off,
                len(chunks), mask, total, np.int32(0))
            if rc != 0:
                return None
            out_v[name] = arr
            out_m[name] = mask.view(np.bool_)
        return out_v, out_m, total
