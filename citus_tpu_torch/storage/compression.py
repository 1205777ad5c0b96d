"""Per-chunk buffer compression.

Mirrors the reference's codec layer
(Citus src/backend/columnar/columnar_compression.c:63 CompressBuffer,
:166 DecompressBuffer — none/pglz/lz4/zstd).  Here: none/zlib/zstd.  zstd uses
the python-zstandard binding when present; the native C++ runtime (native/)
links libzstd directly for the hot ingest path.
"""

from __future__ import annotations

import zlib

from ..errors import StorageError

try:
    import zstandard as _zstd

    _HAVE_ZSTD = True
except ImportError:  # pragma: no cover
    _zstd = None
    _HAVE_ZSTD = False

CODEC_NONE = 0
CODEC_ZLIB = 1
CODEC_ZSTD = 2

_NAME_TO_ID = {"none": CODEC_NONE, "zlib": CODEC_ZLIB, "zstd": CODEC_ZSTD}
_ID_TO_NAME = {v: k for k, v in _NAME_TO_ID.items()}


def codec_id(name: str) -> int:
    if name not in _NAME_TO_ID:
        raise StorageError(f"unknown compression codec {name!r}")
    if name == "zstd" and not _HAVE_ZSTD:
        # degrade WRITES to zlib on hosts without the binding (stripes
        # record their codec id, so files stay self-describing and
        # readable anywhere); reads of existing zstd stripes still
        # raise — silently wrong bytes are never an option
        global _warned_no_zstd
        if not _warned_no_zstd:
            import logging

            logging.getLogger(__name__).warning(
                "zstandard not installed; writing zlib stripes instead")
            _warned_no_zstd = True
        return CODEC_ZLIB
    return _NAME_TO_ID[name]


_warned_no_zstd = False


def codec_name(cid: int) -> str:
    if cid not in _ID_TO_NAME:
        raise StorageError(f"unknown codec id {cid}")
    return _ID_TO_NAME[cid]


def compress(data: bytes, cid: int, level: int = 3) -> bytes:
    if cid == CODEC_NONE:
        return data
    if cid == CODEC_ZLIB:
        return zlib.compress(data, min(level, 9))
    if cid == CODEC_ZSTD:
        if not _HAVE_ZSTD:
            raise StorageError("zstd codec unavailable")
        return _zstd.ZstdCompressor(level=level).compress(data)
    raise StorageError(f"unknown codec id {cid}")


def decompress(data: bytes, cid: int, raw_size: int) -> bytes:
    if cid == CODEC_NONE:
        return data
    if cid == CODEC_ZLIB:
        # bufsize hint: chunk sizes are known exactly (vrlen/nrlen in
        # the skip node), so the decompressor allocates once instead of
        # growing through doubling reallocs — the Python fallback leg
        # of the scan pipeline's hot decode loop
        out = zlib.decompress(data, bufsize=max(raw_size, 64))
    elif cid == CODEC_ZSTD:
        if not _HAVE_ZSTD:
            raise StorageError("zstd codec unavailable")
        out = _zstd.ZstdDecompressor().decompress(data, max_output_size=raw_size)
    else:
        raise StorageError(f"unknown codec id {cid}")
    if len(out) != raw_size:
        raise StorageError(
            f"decompressed size mismatch: expected {raw_size}, got {len(out)}")
    return out
