"""Deletion-bitmap framing: the writer and reader of delete masks.

A copy of the mask part of citus_tpu/storage/integrity.py.  Deletion
bitmaps (committed ones under the shard dirs, staged ones in the 2PC
log) carry magic + CRC32 in front of a serialized ``.npy`` (a rotted
byte would silently resurrect deleted rows), byte for byte as the JAX
package writes them.
"""

from __future__ import annotations

import io as pyio
import zlib

import numpy as np

from ..errors import CorruptStripe

_MASK_MAGIC = b"CMK1"


def frame_mask(npy: bytes) -> bytes:
    """Wrap a serialized ``.npy`` deletion bitmap with magic + CRC32."""
    return _MASK_MAGIC + zlib.crc32(npy).to_bytes(4, "little") + npy


def write_mask(path: str, mask) -> None:
    """Serialize + frame + atomically persist one deletion bitmap: the
    single writer of committed (table_store) and staged (2PC log)
    masks."""
    from ..utils import io as dio

    buf = pyio.BytesIO()
    np.save(buf, mask)
    dio.atomic_write_bytes(path, frame_mask(buf.getvalue()))


def read_mask(path: str):
    """Load + verify a framed deletion bitmap.  Unframed files (pre-CRC
    masks) load unverified for upgrade compatibility.  Raises
    CorruptStripe on a CRC mismatch or a structurally unreadable file."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] == _MASK_MAGIC:
        crc = int.from_bytes(raw[4:8], "little")
        raw = raw[8:]
        if zlib.crc32(raw) != crc:
            raise CorruptStripe(
                f"{path}: deletion bitmap checksum mismatch")
    try:
        return np.load(pyio.BytesIO(raw))
    except Exception as e:
        raise CorruptStripe(f"{path}: deletion bitmap unreadable "
                            f"({e})") from e
