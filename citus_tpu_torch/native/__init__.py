"""Native host-kernel library (C++, loaded via ctypes).

A copy of citus_tpu/native with its sources: the *host* native layer for
per-value work that stays Python-bound otherwise — bulk string interning
and string hash tokens (the reference's equivalents live in C:
multi_copy.c ingest loop, hashfunc uses).  The library compiles itself on
first use with g++ (no network, no pip); every caller has a pure-Python
fallback, so a missing/failed toolchain only costs speed, never
correctness.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_SEP = 0x1F  # unit separator — joins packed strings
_lock = threading.Lock()
_lib: object = None
_tried = False

_I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")


def _build_and_load():
    here = os.path.dirname(os.path.abspath(__file__))
    srcs = [os.path.join(here, "hashdict.cpp"),
            os.path.join(here, "stripecodec.cpp")]
    so = os.path.join(here, "_native.so")
    if not os.path.exists(so) or any(
            os.path.getmtime(so) < os.path.getmtime(s) for s in srcs):
        tmp = so + ".tmp"
        base = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", *srcs,
                "-o", tmp, "-pthread", "-lz"]
        try:
            subprocess.run(base + ["-lzstd"], check=True,
                           capture_output=True, timeout=120)
        except subprocess.CalledProcessError:
            # no libzstd on this host: zstd chunks fall back to Python
            subprocess.run(base + ["-DNO_ZSTD"], check=True,
                           capture_output=True, timeout=120)
        os.replace(tmp, so)  # graftlint: ignore[raw-durable-write] — compiler build artifact beside the sources, not data-dir state
    lib = ctypes.CDLL(so)
    lib.ct_string_hash_tokens.restype = None
    lib.ct_string_hash_tokens.argtypes = [
        ctypes.c_char_p, _I64P, _I64P, ctypes.c_int64, _I32P]
    lib.ct_dict_new.restype = ctypes.c_void_p
    lib.ct_dict_new.argtypes = []
    lib.ct_dict_free.restype = None
    lib.ct_dict_free.argtypes = [ctypes.c_void_p]
    lib.ct_dict_size.restype = ctypes.c_int64
    lib.ct_dict_size.argtypes = [ctypes.c_void_p]
    lib.ct_dict_intern.restype = ctypes.c_int64
    lib.ct_dict_intern.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, _I64P, _I64P, ctypes.c_int64,
        _I32P, _I64P]
    _U8P = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
    lib.ct_decode_column.restype = ctypes.c_int64
    lib.ct_decode_column.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, _I64P, _I64P, _I64P, _I64P,
        ctypes.c_int64, _U8P, ctypes.c_int64, ctypes.c_int32]
    lib.ct_decode_validity.restype = ctypes.c_int64
    lib.ct_decode_validity.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, _I64P, _I64P, _I64P, _I64P,
        _I64P, ctypes.c_int64, _U8P, ctypes.c_int64, ctypes.c_int32]
    return lib


def get_lib():
    """The loaded native library, or None (pure-Python fallback)."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            try:
                _lib = _build_and_load()
            except Exception:
                _lib = None
            _tried = True
    return _lib


def pack_strings(values) -> tuple[bytes, np.ndarray, np.ndarray] | None:
    """list[str] → (utf8 buffer, starts, ends) byte offsets, or None when
    a value contains the separator byte (caller falls back)."""
    n = len(values)
    if n == 0:
        return b"", np.empty(0, np.int64), np.empty(0, np.int64)
    buf = "\x1f".join(values).encode("utf-8")
    arr = np.frombuffer(buf, dtype=np.uint8)
    seps = np.flatnonzero(arr == _SEP)
    if len(seps) != n - 1:
        return None  # some value contains the separator itself
    starts = np.empty(n, np.int64)
    ends = np.empty(n, np.int64)
    starts[0] = 0
    starts[1:] = seps + 1
    ends[:-1] = seps
    ends[-1] = len(buf)
    return buf, starts, ends


class DictHandle:
    """Owns one persistent C++ intern table (arena-backed); the table
    survives across ingest batches so interning stays O(new values)."""

    def __init__(self):
        lib = get_lib()
        assert lib is not None
        self._lib = lib
        self._h = lib.ct_dict_new()

    def __del__(self):
        h, self._h = self._h, None
        if h and self._lib is not None:
            self._lib.ct_dict_free(h)

    def size(self) -> int:
        return int(self._lib.ct_dict_size(self._h))

    def intern(self, pack):
        buf, starts, ends = pack
        n = len(starts)
        codes = np.empty(n, np.int32)
        new_idx = np.empty(max(n, 1), np.int64)
        k = self._lib.ct_dict_intern(self._h, buf, starts, ends, n,
                                     codes, new_idx)
        return codes, new_idx[:k]


def string_hash_tokens_packed(pack) -> np.ndarray:
    lib = get_lib()
    assert lib is not None
    buf, starts, ends = pack
    out = np.empty(len(starts), np.int32)
    lib.ct_string_hash_tokens(buf, starts, ends, len(starts), out)
    return out
