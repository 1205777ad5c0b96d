"""Shared durable-write helpers (single home for the atomic-write pattern).

Every durable mutation of a data directory — manifests, stripes,
deletion bitmaps, point-index sidecars, 2PC log records, the change
journal, the catalog — goes through THIS module.  That buys three
things at one seam:

* one audited implementation of the tmp + fsync + rename + dir-fsync
  durability discipline (graftlint's ``raw-durable-write`` rule rejects
  bypasses);
* end-to-end integrity for JSON state files (``*_checked`` variants
  embed a CRC32 the readers verify — the data_checksums analogue);
* the power-cut torture harness (``utils/crashsim.py``) intercepts
  every write here, so a simulated crash at write-op *N* exercises the
  real recovery paths with real torn-file semantics.
"""

from __future__ import annotations

import json
import os
import zlib

# Active crash simulator (utils/crashsim.CrashSim) or None.  Installed
# by the torture harness only; the unarmed cost is one None check.
_SIM = None


def install_sim(sim) -> None:
    global _SIM
    _SIM = sim


def current_sim():
    return _SIM


def _sim_op(kind: str, path: str, payload: bytes | None = None,
            tmp: str | None = None) -> None:
    """Crash-simulation seam: counts one durable write op and, at the
    armed crashpoint, applies the configured tear and raises PowerCut."""
    if _SIM is not None:
        _SIM.op(kind, path, payload=payload, tmp=tmp)


def fsync_dir(path: str) -> None:
    dir_fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def _raw_atomic_write_bytes(path: str, payload: bytes) -> None:
    import tempfile

    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".aw.")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except Exception:
        # PowerCut (BaseException) skips this on purpose: a dying
        # process doesn't get to tidy its torn tmp file
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    fsync_dir(d)


def atomic_write_bytes(path: str, payload: bytes) -> None:
    """tmp + fsync + rename + dir fsync: the durability primitive under
    the catalog, manifests, masks, sidecars and 2PC records."""
    _sim_op("atomic_write", path, payload=payload)
    _raw_atomic_write_bytes(path, payload)


def atomic_write_json(path: str, obj, indent: int | None = 1) -> None:
    atomic_write_bytes(path, json.dumps(obj, indent=indent).encode())


# -- checksummed JSON state files -------------------------------------------
_CRC_KEY = "_crc32"


def _json_crc(obj) -> int:
    """CRC32 of the canonical (sorted-keys, no-space) encoding, so the
    checksum is stable across indent styles."""
    return zlib.crc32(json.dumps(obj, sort_keys=True,
                                 separators=(",", ":")).encode())


def atomic_write_json_checked(path: str, obj: dict,
                              indent: int | None = 1) -> None:
    """Atomic JSON write with an embedded CRC32 over the payload —
    readers (`read_json_checked`) refuse a flipped bit instead of
    adopting it as state."""
    payload = dict(obj)
    payload.pop(_CRC_KEY, None)
    payload[_CRC_KEY] = _json_crc(payload)
    atomic_write_json(path, payload, indent=indent)


def read_json_checked(path: str) -> dict:
    """Parse + verify a `atomic_write_json_checked` file.  Files written
    before checksumming (no `_crc32` key) load unverified — upgrade
    compatibility.  Raises CorruptStripe on a mismatch."""
    from ..errors import CorruptStripe

    with open(path) as f:
        try:
            obj = json.load(f)
        except ValueError as e:
            raise CorruptStripe(f"{path}: unparseable JSON state file "
                                f"({e})") from e
    if not isinstance(obj, dict):
        return obj
    crc = obj.pop(_CRC_KEY, None)
    if crc is not None and crc != _json_crc(obj):
        raise CorruptStripe(f"{path}: checksum mismatch (expected "
                            f"{crc}, state file is corrupt)")
    return obj


# -- streaming atomic writes (stripe files) ---------------------------------
class atomic_stream_writer:
    """Context manager for writers that stream content (stripes): yields
    a binary file opened on a private tmp path; a clean exit finalizes
    with fsync + rename + dir fsync, an exception leaves no visible
    file.  The crash shim counts the FINALIZE as the durable op — the
    torn-tail tear truncates the streamed tmp, exactly what a power cut
    mid-stripe leaves behind."""

    def __init__(self, path: str):
        self.path = path
        # per-writer tmp name: two sessions rebuilding the same file
        # concurrently each publish their own complete tmp atomically
        import threading

        self.tmp = (f"{path}.tmp.{os.getpid()}."
                    f"{threading.get_ident()}")
        self._f = None

    def __enter__(self):
        self._f = open(self.tmp, "wb")
        return self._f

    def __exit__(self, exc_type, exc, tb):
        f, self._f = self._f, None
        if exc_type is not None:
            f.close()
            if isinstance(exc, Exception):  # PowerCut keeps its tear
                try:
                    os.unlink(self.tmp)
                except OSError:
                    pass
            return False
        f.flush()
        os.fsync(f.fileno())
        f.close()
        _sim_op("stream_finalize", self.path, tmp=self.tmp)
        _raw_finalize_stream(self.tmp, self.path)
        return False


def _raw_finalize_stream(tmp: str, path: str) -> None:
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def _raw_append_bytes(path: str, payload: bytes) -> None:
    with open(path, "ab") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())


def append_op(path: str, payload: bytes) -> None:
    """Crash seam for append-journal writers (the CDC change log keeps
    its own file handle for flock + lsn allocation; it reports the
    append here so the torture harness can drop or tear the tail)."""
    _sim_op("append", path, payload=payload)


def append_bytes(path: str, payload: bytes) -> None:
    """Durable append (write + fsync) through the crash seam — the
    replication applier's journal catch-up primitive.  Append-only by
    contract: a torn tail from a power cut is resumed byte-exactly by
    the caller (the applier knows the expected offsets), never
    truncated."""
    _sim_op("append", path, payload=payload)
    _raw_append_bytes(path, payload)


def is_tmp_artifact(fname: str) -> bool:
    """True for any in-flight/abandoned temp this module's writers can
    leave behind: ``.aw.*`` tempfiles and ``*.tmp[.<pid>.<tid>]``
    stream tmps.  The one predicate restore-point snapshots and the
    scrubber's orphan GC both match — debris is never frozen into a
    snapshot and always eligible for GC."""
    return fname.startswith(".aw.") or ".tmp" in fname


def copy_file_durable(src: str, dst: str) -> None:
    """Durable whole-file copy (replica mirroring, read repair): the
    destination appears atomically with its full verified content or
    not at all.  Streams in 1 MiB chunks — mirroring a large stripe
    must not buffer the whole file in RAM."""
    import shutil

    with open(src, "rb") as fsrc, atomic_stream_writer(dst) as fdst:
        shutil.copyfileobj(fsrc, fdst, 1 << 20)
