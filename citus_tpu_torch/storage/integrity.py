"""End-to-end storage integrity: verification accounting, file checks
and the deletion-bitmap framing.

Counterpart of citus_tpu/storage/integrity.py.  Stripes carry CRC32s in
their footers (storage/format.py v2) and JSON state files embed one
(utils/io ``*_checked``).  This module is the process-wide accounting
seam the read paths report into (`note`): module-global, like the fault
engine's trigger count, because TableStore has no per-session counter
handle; Session folds per-statement deltas (`snapshot` / `delta`) into
its own counters for citus_stat_counters, citus_stat_activity and
EXPLAIN ANALYZE's Integrity line.

Deletion bitmaps (committed ones under the shard dirs, staged ones in
the 2PC log) carry magic + CRC32 in front of a serialized ``.npy`` (a
rotted byte would silently resurrect deleted rows), byte for byte as
the JAX package writes them.
"""

from __future__ import annotations

import io as pyio
import os
import threading
import zlib

import numpy as np

from ..errors import CorruptStripe

_mu = threading.Lock()
_stats = {"stripes_verified": 0, "corruption_detected": 0,
          "read_repairs": 0}


def note(name: str, by: int = 1) -> None:
    with _mu:
        _stats[name] += by


def snapshot() -> dict[str, int]:
    with _mu:
        return dict(_stats)


def delta(base: dict[str, int]) -> dict[str, int]:
    now = snapshot()
    return {k: now[k] - base.get(k, 0) for k in now}


def verify_stripe_file(path: str) -> None:
    """Full structural + checksum verification of one stripe file:
    footer parse (tail magic, length, footer CRC) plus the CRC of every
    compressed chunk buffer of every column.  Raises CorruptStripe on
    any damage; returns None on a fully verified stripe.  v1 stripes
    (pre-CRC) verify structurally only."""
    from .format import StripeReader

    StripeReader(path, verify=True).verify_all_chunks()


def flip_one_bit(path: str) -> None:
    """Deliberately corrupt one payload byte mid-file: the directed
    bit-rot injection behind the ``storage.stripe_bitflip`` fault point
    and the integrity tests.  The byte lies after the header and before
    the tail, so the chunk CRCs are what must catch it.  Rewrites
    through a private copy (a new inode): restore points freeze stripes
    via hardlinks, and injected rot must corrupt only the live path,
    never a snapshot sharing the inode."""
    size = os.path.getsize(path)
    if size < 32:
        raise CorruptStripe(f"{path}: too small to bit-flip")
    pos = max(8, size // 2)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[pos] ^= 0x01
    tmp = f"{path}.bitflip.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(bytes(data))
    os.replace(tmp, path)


# -- deletion bitmaps -------------------------------------------------------
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
