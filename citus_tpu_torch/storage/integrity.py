"""Deletion-bitmap framing: the reader of the JAX package's masks.

A copy of the part of citus_tpu/storage/integrity.py the port reads.
Deletion bitmaps written by the JAX package's DML carry magic + CRC32 in
front of a serialized ``.npy`` (a rotted byte would silently resurrect
deleted rows), and the port's scans apply them.
"""

from __future__ import annotations

import io as pyio
import zlib

import numpy as np

from ..errors import CorruptStripe

_MASK_MAGIC = b"CMK1"


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
