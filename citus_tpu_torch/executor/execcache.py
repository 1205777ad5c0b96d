"""Persistent compiled-plan cache + single-flight capture dedup.

Counterpart of citus_tpu/executor/execcache.py.  The JAX package
serializes each plan's AOT executable so that a fresh process loads
instead of compiling.  What the port compiles is a CUDA graph
(executor/graphs.py), and a CUDA graph cannot be serialized across
processes.  So the port persists what a fresh process lacks before it
can build and capture at once — the plan-cache key, the converged
capacities, the unpack metadata — as JSON, and nothing is pickled:

* **ExecutableCache** — one per data_dir (the lock_manager_for
  pattern): the same ``<data_dir>/exec_cache/`` directory, framing and
  commit order as the JAX package's.  Each entry is a checksummed meta
  JSON (version, environment stamp, the plan-cache key, unpack
  metadata, payload CRC) plus a framed payload holding one JSON
  document (the converged capacities); the payload lands first and the
  meta is the commit point.  The stamp names torch on its device, the
  torch version, the card and a digest of the kernel sources, and it is
  part of the entry hash: a lookup never finds the JAX package's
  entries (a miss), and the warmup's walk over ``top_hashes`` rejects
  them by their stamp without reading their payload — as the JAX
  package treats the port's.  Corrupt, torn or skewed entries are
  detected (CRC + stamp) and resolve as a counted reject.

* **CompileGate** — single-flight dedup per key per data_dir: N
  sessions racing one cold key produce ONE capture; followers wait in
  cancellation-aware slices under their own ``statement_timeout_ms``.
  Every follower resolves answered XOR cleanly errored XOR promoted (a
  leader dying on a BaseException or its own cancel hands leadership to
  a waiting follower).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import zlib

from ..errors import StorageError

EXEC_CACHE_VERSION = 1
EXEC_CACHE_DIR = "exec_cache"
# on-disk entry bound per data_dir: retry/tightening intermediates and
# dead shapes age out coldest-first (hits, then insertion sequence)
EXEC_CACHE_MAX_ENTRIES = 512
# coalesce index rewrites: the hit/seq index is advisory (warmup
# ordering) — rebuildable from entry mtimes — so it flushes debounced
INDEX_FLUSH_EVERY = 16

_MAGIC = b"CTEX1\n"
_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")


# -- key / metadata serialization -------------------------------------------
# The plan-cache key is a nested tuple of strings, ints, floats, bools
# and Nones (plan fingerprint, n_devices, dtype, feed signature, topk
# signature, device, caps signature) — the same JSON-safe shape as the
# caps memo, encoded the same way (tuples tagged so they round-trip).
def key_to_json(obj):
    if isinstance(obj, tuple):
        return {"t": [key_to_json(x) for x in obj]}
    if isinstance(obj, dict):
        return {"d": [[key_to_json(k), key_to_json(v)]
                      for k, v in obj.items()]}
    # numpy scalars ride in some fingerprints (key extents): coerce to
    # python scalars — hash/equality agree, so a key reconstructed from
    # JSON still hits the in-memory plan cache
    if isinstance(obj, bool) or obj is None or \
            isinstance(obj, (int, float, str)):
        return obj
    import numpy as _np

    if isinstance(obj, _np.bool_):
        return bool(obj)
    if isinstance(obj, _np.integer):
        return int(obj)
    if isinstance(obj, _np.floating):
        return float(obj)
    return obj


def key_from_json(obj):
    if isinstance(obj, dict) and "t" in obj:
        return tuple(key_from_json(x) for x in obj["t"])
    if isinstance(obj, dict) and "d" in obj:
        return {key_from_json(k): key_from_json(v) for k, v in obj["d"]}
    return obj


def kernel_sources_digest() -> str:
    """sha256 prefix over the CUDA sources (csrc/*.cu, *.cuh): an entry
    captured against other kernels is a skew."""
    h = hashlib.sha256()
    for name in sorted(f for f in os.listdir(_CSRC)
                       if f.endswith((".cu", ".cuh"))):
        h.update(name.encode())
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def env_stamp(device) -> dict:
    """The environment an entry is valid in: cache format version, the
    backend (torch), its version, the device type and card, and the
    kernel sources.  Part of the entry hash — a skewed entry is never
    even looked up — AND re-verified from the meta on load."""
    import torch

    dev = torch.device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    return {
        "cache_version": EXEC_CACHE_VERSION,
        "backend": "torch",
        "torch": torch.__version__,
        "platform": dev.type,
        "device_kind": kind,
        "kernels": kernel_sources_digest(),
    }


def _canonical(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def entry_hash(key, stamp: dict) -> str:
    h = hashlib.sha256()
    h.update(_canonical(key_to_json(key)))
    h.update(b"\0")
    h.update(_canonical(stamp))
    return h.hexdigest()[:40]


def _frame(blobs: list[bytes]) -> bytes:
    out = [_MAGIC]
    for b in blobs:
        out.append(len(b).to_bytes(8, "little"))
        out.append(b)
    return b"".join(out)


def _unframe(data: bytes, n: int) -> list[bytes]:
    if not data.startswith(_MAGIC):
        raise ValueError("exec-cache payload: bad magic")
    off = len(_MAGIC)
    blobs = []
    for _ in range(n):
        if off + 8 > len(data):
            raise ValueError("exec-cache payload: truncated length")
        ln = int.from_bytes(data[off:off + 8], "little")
        off += 8
        if off + ln > len(data):
            raise ValueError("exec-cache payload: truncated blob")
        blobs.append(data[off:off + ln])
        off += ln
    return blobs


def _clone_error(e: Exception) -> Exception:
    """Per-follower copy of a leader's failure (sharing one exception
    object across raising threads would share tracebacks); classifier
    markers ride along so each session's retry envelope treats it
    exactly like a solo failure."""
    try:
        clone = type(e)(*e.args)
    except Exception:
        clone = StorageError(f"deduped capture failed: {e}")
    for attr in ("injected_fault", "fault_point", "post_visibility"):
        if hasattr(e, attr):
            try:
                setattr(clone, attr, getattr(e, attr))
            except Exception:  # graftlint: ignore[silent-exception] — best-effort marker copy: a clone type refusing ONE attr must not drop the rest or the error
                continue
    return clone


class _Flight:
    __slots__ = ("evt", "entry", "error", "promote")

    def __init__(self):
        self.evt = threading.Event()
        self.entry = None
        self.error: Exception | None = None
        self.promote = False


class CompileGate:
    """Single-flight dedup: one in-flight build per key.

    ``run(key, build_fn)`` either leads (runs ``build_fn`` and publishes
    the entry to every waiter) or follows (waits, in cancellation-aware
    slices, for the leader's entry).  Ledger: every caller resolves
    answered XOR cleanly errored XOR promoted — a leader that dies on a
    BaseException or on its own cancel/timeout hands leadership to a
    self-promoting follower instead of erroring innocents."""

    def __init__(self):
        self._mu = threading.Lock()
        self._flights: dict = {}
        self.flights_led_total = 0
        self.deduped_total = 0
        self.promoted_total = 0
        self.errored_followers_total = 0

    def run(self, key, build_fn):
        """Returns ``(entry, deduped)``; raises the build's failure
        (leaders raise their own, followers a per-waiter clone)."""
        from ..errors import QueryCanceled, StatementTimeout
        from ..stats.tracing import trace_span
        from ..utils.cancellation import check_cancel

        while True:
            with self._mu:
                fl = self._flights.get(key)
                lead = fl is None
                if lead:
                    fl = self._flights[key] = _Flight()
            if lead:
                try:
                    entry = build_fn()
                except BaseException as e:
                    with self._mu:
                        self._flights.pop(key, None)
                        if isinstance(e, Exception) and \
                                not isinstance(e, (QueryCanceled,
                                                   StatementTimeout)):
                            # a real failure: followers raise a clone
                            # and their own envelopes classify it
                            fl.error = e
                        else:
                            # leader death / leader-local cancel:
                            # innocent followers self-promote
                            fl.promote = True
                    fl.evt.set()
                    raise
                with self._mu:
                    fl.entry = entry
                    self._flights.pop(key, None)
                    self.flights_led_total += 1
                fl.evt.set()
                return entry, False
            with trace_span("compile.single_flight_wait"):
                while not fl.evt.wait(0.005):
                    check_cancel()  # deadline / Session.cancel() seam
            if fl.promote:
                with self._mu:
                    self.promoted_total += 1
                continue  # self-promote: the next loop may lead
            if fl.error is not None:
                with self._mu:
                    self.errored_followers_total += 1
                raise _clone_error(fl.error)
            with self._mu:
                self.deduped_total += 1
            return fl.entry, True

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "in_flight": len(self._flights),
                "flights_led_total": self.flights_led_total,
                "deduped_total": self.deduped_total,
                "promoted_total": self.promoted_total,
                "errored_followers_total": self.errored_followers_total,
            }


class ExecutableCache:
    """Per-data_dir on-disk cache of converged plan entries (JSON)."""

    def __init__(self, data_dir: str):
        self.dir = os.path.join(data_dir, EXEC_CACHE_DIR)
        self.gate = CompileGate()
        self._mu = threading.Lock()
        # hash → {"hits": n, "seq": m}: the warmup ordering source.
        # Advisory — corrupt/absent index rebuilds from entry mtimes
        self._index: dict[str, dict] = {}
        self._seq = 0
        self._index_loaded = False
        self._index_dirty = 0
        # shared-layer totals; per-session counters fold requester-side
        # in the runner.  compiles_total counts ACTUAL graph captures
        self.hits_total = 0
        self.misses_total = 0
        self.rejects_total = 0
        self.stores_total = 0
        self.compiles_total = 0
        # device → its environment stamp (the kernel digest reads the
        # sources once per process and device)
        self._stamps: dict = {}

    def stamp(self, device) -> dict:
        key = str(device)
        st = self._stamps.get(key)
        if st is None:
            st = self._stamps[key] = env_stamp(device)
        return st

    def note_compile(self) -> None:
        with self._mu:
            self.compiles_total += 1

    # -- paths ---------------------------------------------------------------
    def _meta_path(self, h: str) -> str:
        return os.path.join(self.dir, f"{h}.meta.json")

    def _bin_path(self, h: str) -> str:
        return os.path.join(self.dir, f"{h}.bin")

    def _index_path(self) -> str:
        return os.path.join(self.dir, "index.json")

    def has_entries(self) -> bool:
        try:
            return any(f.endswith(".meta.json")
                       for f in os.listdir(self.dir))
        except OSError:
            return False

    # -- load ----------------------------------------------------------------
    def load(self, key, device):
        """Resolve `key` from disk.  Returns ``(entry, status)``: entry
        is ``{"caps", "out_meta", "stage_keys"}`` or None, status
        ``'hit' | 'miss' | 'reject'``.  Every failure mode — torn or
        bit-flipped payload, corrupt meta, version/backend skew — is
        detected and reported as a reject; nothing here raises except
        an armed fault or the statement's own cancel."""
        stamp = self.stamp(device)
        h = entry_hash(key, stamp)
        meta_path = self._meta_path(h)
        if not os.path.exists(meta_path):
            with self._mu:
                self.misses_total += 1
            return None, "miss"
        from ..errors import QueryCanceled, StatementTimeout
        from ..utils.faultinjection import fault_point

        try:
            # named seam INSIDE the guard: an injected failure while
            # adopting a persisted entry ends in a counted reject, as
            # real rot does
            fault_point("executor.exec_cache_load")
            entry = self._load_verified(h, meta_path, stamp)
        except (QueryCanceled, StatementTimeout):
            raise  # the statement's own deadline/cancel, not rot
        except Exception as e:  # graftlint: ignore[swallowed-fault-seam] — the seam's contract: rot (injected or real) downgrades to a counted reject, never a crash or a stale entry
            with self._mu:
                self.rejects_total += 1
            if self._is_verified_rot(e):
                # only VERIFIED rot deletes the entry; a transient
                # EMFILE/EIO must not destroy an intact payload
                self._drop_entry(h)
            return None, "reject"
        self._touch(h)
        with self._mu:
            self.hits_total += 1
        return entry, "hit"

    def load_hash(self, h: str, device):
        """Warmup path: adopt entry `h` by its hash, returning
        ``(key, entry)`` — or ``(None, None)`` when the entry is gone,
        skewed (the JAX package's entries among them) or corrupt."""
        stamp = self.stamp(device)
        meta_path = self._meta_path(h)
        if not os.path.exists(meta_path):
            # pruned/dropped since top_hashes ranked it: not rot
            return None, None
        try:
            meta = self._read_meta(meta_path, stamp)
            key = key_from_json(meta["key"])
            if entry_hash(key, stamp) != h:
                raise ValueError("exec-cache entry hash mismatch")
            entry = self._load_verified(h, meta_path, stamp, meta=meta)
        except Exception:
            with self._mu:
                self.rejects_total += 1
            return None, None
        self._touch(h)
        with self._mu:
            self.hits_total += 1
        return key, entry

    @staticmethod
    def _is_verified_rot(e: Exception) -> bool:
        """True when the failure PROVES the entry is bad (corrupt
        meta/payload, version or environment skew, a payload missing
        under a present meta = torn commit, malformed fields) rather
        than a transient IO condition."""
        from ..errors import CorruptStripe

        return isinstance(e, (CorruptStripe, ValueError, KeyError,
                              TypeError, FileNotFoundError, EOFError))

    def _read_meta(self, meta_path: str, stamp: dict) -> dict:
        from ..utils.io import read_json_checked

        meta = read_json_checked(meta_path)  # raises CorruptStripe on rot
        if meta.get("version") != EXEC_CACHE_VERSION:
            raise ValueError("exec-cache entry version skew")
        if meta.get("stamp") != stamp:
            # backend / version / card / kernel skew: never served
            raise ValueError("exec-cache entry environment skew")
        return meta

    def _load_verified(self, h: str, meta_path: str, stamp: dict,
                       meta: dict | None = None) -> dict:
        import numpy as np

        if meta is None:
            meta = self._read_meta(meta_path, stamp)
        with open(self._bin_path(h), "rb") as f:
            data = f.read()
        if zlib.crc32(data) != meta["payload_crc32"]:
            raise ValueError("exec-cache payload checksum mismatch")
        (payload,) = _unframe(data, 1)
        body = json.loads(payload.decode())
        return {
            "caps": key_from_json(body["caps"]),
            "out_meta": [(kind, cid, np.dtype(dt))
                         for kind, cid, dt in meta["out_meta"]],
            "stage_keys": [tuple(sk) for sk in meta["stage_keys"]],
        }

    # -- store ---------------------------------------------------------------
    def store(self, key, device, caps_order, out_meta,
              stage_keys) -> bool:
        """Persist one converged entry.  Best-effort for REAL IO errors
        (the statement already has its answer; persistence is a warm
        start, like the caps memo) — but the named fault seam fires
        before the catch, so an injected fault propagates.  Returns
        True when the entry landed."""
        from ..utils.faultinjection import fault_point
        from ..utils.io import atomic_write_bytes, atomic_write_json_checked

        fault_point("executor.exec_cache_store")
        stamp = self.stamp(device)
        h = entry_hash(key, stamp)
        try:
            payload = _canonical({"caps": key_to_json(caps_order)})
            data = _frame([payload])
            os.makedirs(self.dir, exist_ok=True)
            # payload first, checksummed meta LAST (the commit point): a
            # power cut between the two leaves an invisible orphan the
            # next store overwrites
            atomic_write_bytes(self._bin_path(h), data)
            atomic_write_json_checked(self._meta_path(h), {
                "version": EXEC_CACHE_VERSION,
                "stamp": stamp,
                "key": key_to_json(key),
                "out_meta": [[kind, cid, str(dt)]
                             for kind, cid, dt in out_meta],
                "stage_keys": [list(sk) for sk in stage_keys],
                "shuffle_bytes": 0,
                "payload_crc32": zlib.crc32(data),
                "payload_bytes": len(data),
            })
        except (OSError, TypeError, ValueError):
            # a full or read-only disk, or a key JSON cannot carry: the
            # statement keeps its answer, a restart just stays cold
            return False
        with self._mu:
            self.stores_total += 1
        self._touch(h)
        self._prune()
        return True

    def contains(self, key, device) -> bool:
        return os.path.exists(self._meta_path(
            entry_hash(key, self.stamp(device))))

    # -- hotness index / warmup ordering -------------------------------------
    def _load_index_locked(self) -> None:
        if self._index_loaded:
            return
        self._index_loaded = True
        from ..utils.io import read_json_checked

        try:
            obj = read_json_checked(self._index_path())
            idx = {h: {"hits": int(v["hits"]), "seq": int(v["seq"])}
                   for h, v in obj["entries"].items()}
        except Exception:
            # absent/corrupt index: rebuild advisory ordering from
            # entry mtimes (the entries themselves stay verified)
            idx = {}
            try:
                metas = [f for f in os.listdir(self.dir)
                         if f.endswith(".meta.json")]
            except OSError:
                metas = []
            stats = []
            for f in metas:
                try:
                    stats.append((os.stat(
                        os.path.join(self.dir, f)).st_mtime, f))
                except OSError:
                    continue
            for i, (_, f) in enumerate(sorted(stats)):
                idx[f[:-len(".meta.json")]] = {"hits": 0, "seq": i}
        self._index = idx
        self._seq = max((v["seq"] for v in idx.values()), default=-1) + 1

    def _touch(self, h: str) -> None:
        flush = False
        with self._mu:
            self._load_index_locked()
            ent = self._index.get(h)
            if ent is None:
                ent = self._index[h] = {"hits": 0, "seq": 0}
            ent["hits"] += 1
            ent["seq"] = self._seq
            self._seq += 1
            self._index_dirty += 1
            if self._index_dirty >= INDEX_FLUSH_EVERY:
                self._index_dirty = 0
                flush = True
        if flush:
            self.flush_index()

    def flush_index(self) -> None:
        from ..utils.io import atomic_write_json_checked

        with self._mu:
            if not self._index_loaded:
                return  # never read or touched: nothing to rewrite
            payload = {"entries": dict(self._index)}
            self._index_dirty = 0
        try:
            os.makedirs(self.dir, exist_ok=True)
            atomic_write_json_checked(self._index_path(), payload)
        except OSError:
            pass  # advisory: warmup ordering degrades to mtimes

    def top_hashes(self, limit: int) -> list[str]:
        """Entry hashes hottest-first (hits desc, then recency desc) —
        the warmup phase's work list."""
        with self._mu:
            self._load_index_locked()
            ranked = sorted(self._index.items(),
                            key=lambda kv: (-kv[1]["hits"],
                                            -kv[1]["seq"]))
        out = []
        for h, _ in ranked:
            if len(out) >= max(0, limit):
                break
            if os.path.exists(self._meta_path(h)):
                out.append(h)
        return out

    # -- hygiene -------------------------------------------------------------
    def _drop_entry(self, h: str) -> None:
        for p in (self._meta_path(h), self._bin_path(h)):
            try:
                os.unlink(p)
            except OSError:
                pass
        with self._mu:
            self._load_index_locked()
            self._index.pop(h, None)

    def _prune(self) -> None:
        """Age out coldest entries beyond EXEC_CACHE_MAX_ENTRIES — the
        index ranks every entry in the directory, the JAX package's
        among them, and so does the JAX package's own pruning."""
        with self._mu:
            self._load_index_locked()
            if len(self._index) <= EXEC_CACHE_MAX_ENTRIES:
                return
            ranked = sorted(self._index.items(),
                            key=lambda kv: (kv[1]["hits"], kv[1]["seq"]))
            doomed = [h for h, _ in
                      ranked[:len(self._index) - EXEC_CACHE_MAX_ENTRIES]]
        for h in doomed:
            self._drop_entry(h)

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "hits_total": self.hits_total,
                "misses_total": self.misses_total,
                "rejects_total": self.rejects_total,
                "stores_total": self.stores_total,
                "compiles_total": self.compiles_total,
                "entries": len(self._index) if self._index_loaded
                else None,
                **{f"gate_{k}": v for k, v in
                   self.gate.snapshot().items()},
            }


# process-wide registry: sessions sharing a data_dir share the cache
# AND the gate (the lock_manager_for pattern)
_registry: dict[str, ExecutableCache] = {}
_registry_mu = threading.Lock()


def exec_cache_for(data_dir: str) -> ExecutableCache:
    key = os.path.realpath(data_dir)
    with _registry_mu:
        if key not in _registry:
            _registry[key] = ExecutableCache(key)
        return _registry[key]
