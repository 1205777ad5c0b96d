"""String dictionary encoding.

TPU arrays must be fixed-width, so STRING columns are dictionary-encoded: the
device sees int32 codes; raw bytes live here, host-side, per (table, column)
— late materialization, the TPU-native answer to the reference's per-chunk
variable-width value streams (columnar_writer.c SerializeChunkData).

Codes are append-only and therefore stable for the table's lifetime, making
them safe join/group-by keys *within* one column.  Cross-column string joins
translate codes at plan time via the dictionaries (both small, host-side).

Distribution hashing for string columns uses `string_hash_token`, a
bytes-level hash that every node/ingest path computes identically (the
cluster-wide routing contract; analogue of PG's hashtext).

Bulk interning runs through the native C++ kernel (citus_tpu/native) when
available — the multi_copy.c-style C hot loop — with a pure-Python inline
loop as fallback.  The code↔value map is rebuilt lazily after native bulk
appends so multi-million-entry ingests never pay per-value Python dict
inserts.
"""

from __future__ import annotations

import json
import zlib

import numpy as np

from ..errors import StorageError
from ..catalog.distribution import fmix32

NULL_CODE = -1

# below this many values the packing overhead beats the native kernel
_NATIVE_MIN_BATCH = 4096


def string_hash_token(value: str) -> int:
    """Stable int32 hash token of a string's utf-8 bytes (crc32 + fmix32)."""
    crc = zlib.crc32(value.encode("utf-8")) & 0xFFFFFFFF
    return int(fmix32(np.uint32(crc)).view(np.int32)[0])


# decode-map sentinel: a (table, column) decode entry whose "table" is
# EXPR_DICT carries the value list itself in the "column" slot — used for
# string-expression outputs (BStrRemap) that have no backing table column
EXPR_DICT = "__expr__"


class ValuesDictionary:
    """Read-only dictionary view over a literal value list (the output
    dictionary of a string-expression remap)."""

    def __init__(self, values):
        self.values = list(values)

    def __len__(self) -> int:
        return len(self.values)

    def code_of(self, value: str):
        try:
            return self.values.index(value)
        except ValueError:
            return None


def resolve_decode(store, entry):
    """Decode-map entry → dictionary-like object with .values."""
    table, column = entry
    if table == EXPR_DICT:
        return ValuesDictionary(column)
    return store.dictionary(table, column)


def string_hash_tokens(values: list[str]) -> np.ndarray:
    if len(values) >= _NATIVE_MIN_BATCH:
        from ..native import get_lib, pack_strings, string_hash_tokens_packed

        if get_lib() is not None:
            pack = pack_strings(values)
            if pack is not None:
                return string_hash_tokens_packed(pack)
    return np.array([string_hash_token(v) for v in values], dtype=np.int32)


class Dictionary:
    """Append-only value↔code mapping for one STRING column."""

    def __init__(self, values: list[str] | None = None):
        import threading

        self._values: list[str] = []
        # value → code; None after a native bulk append (rebuilt lazily —
        # near-unique text columns are interned by the millions but
        # probed almost never)
        self._codes: dict[str, int] | None = {}
        # packed (utf8 buffer, starts, ends) of _values for save();
        # invalidated on append
        self._pack: tuple | None = None
        # persistent native intern table; synced to the first
        # _native_n entries of _values.  None until first bulk use;
        # False = permanently unusable (a value contains the separator)
        self._handle = None
        self._native_n = 0
        # guards mutation: concurrent ingests intern into the same
        # dictionary, and native calls release the GIL
        self._mu = threading.Lock()
        if values:
            self._values = list(values)
            self._codes = None

    def __len__(self) -> int:
        return len(self._values)

    def _codes_map(self) -> dict[str, int]:
        if self._codes is None:
            self._codes = {v: i for i, v in enumerate(self._values)}
        return self._codes

    def intern(self, value: str) -> int:
        with self._mu:
            codes = self._codes_map()
            code = codes.get(value)
            if code is None:
                code = len(self._values)
                self._values.append(value)
                codes[value] = code
                self._pack = None
            return code

    def intern_array(self, values) -> np.ndarray:
        """Encode a sequence of str|None → int32 codes (None → NULL_CODE)."""
        with self._mu:
            if len(values) >= _NATIVE_MIN_BATCH:
                out = self._intern_array_native(values)
                if out is not None:
                    return out
            # fallback: inlined per-value dict upsert (no method dispatch)
            out = np.empty(len(values), dtype=np.int32)
            codes = self._codes_map()
            vals = self._values
            get = codes.get
            appended = False
            for i, v in enumerate(values):
                if v is None:
                    out[i] = NULL_CODE
                    continue
                c = get(v)
                if c is None:
                    c = len(vals)
                    vals.append(v)
                    codes[v] = c
                    appended = True
                out[i] = c
            if appended:
                self._pack = None
            return out

    def _intern_array_native(self, values) -> np.ndarray | None:
        """C++ bulk intern via the persistent handle; None ⇒ caller falls
        back (no toolchain, NULLs present, or separator collision).
        Caller holds self._mu."""
        from ..native import get_lib, pack_strings

        if self._handle is False or get_lib() is None:
            return None
        if isinstance(values, list):
            if values.count(None):
                return None
        elif any(v is None for v in values):
            return None
        in_pack = pack_strings(values)
        if in_pack is None:
            return None
        if not self._sync_handle():
            return None
        base = len(self._values)
        codes, new_idx = self._handle.intern(in_pack)
        if len(new_idx):
            if len(new_idx) == len(values):
                newvals = list(values)
            else:  # .tolist(): indexing lists by np scalars is slow
                newvals = [values[i] for i in new_idx.tolist()]
            self._values.extend(newvals)
            self._pack = None
            if self._codes is not None:
                if len(newvals) > 100_000:
                    self._codes = None  # rebuild lazily if ever probed
                else:
                    for j, v in enumerate(newvals):
                        self._codes[v] = base + j
        self._native_n = len(self._values)
        return codes

    def _sync_handle(self) -> bool:
        """Bring the native table up to date with _values (entries added
        via the Python paths, or a freshly loaded dictionary)."""
        from ..native import DictHandle, pack_strings

        if self._handle is None:
            self._handle = DictHandle()
            self._native_n = 0
        if self._native_n < len(self._values):
            suffix = self._values[self._native_n:]
            pack = pack_strings(suffix)
            if pack is None:
                self._handle = False  # separator inside a value
                return False
            codes, new_idx = self._handle.intern(pack)
            if len(new_idx) != len(suffix) or \
                    self._handle.size() != len(self._values):
                # duplicate values reached _values through a fallback
                # path — the native table can't represent that; disable
                self._handle = False
                return False
            self._native_n = len(self._values)
        return True

    def _dict_pack(self):
        """(pack, count) snapshot; caller must hold self._mu."""
        if self._pack is None:
            from ..native import pack_strings

            self._pack = pack_strings(self._values)
        return self._pack

    def code_of(self, value: str) -> int | None:
        # must hold _mu: _codes_map() may rebuild+assign self._codes, and
        # doing that unlocked races intern_array (one string, two codes)
        with self._mu:
            return self._codes_map().get(value)

    def value_of(self, code: int) -> str:
        if not 0 <= code < len(self._values):
            raise StorageError(f"dictionary code {code} out of range")
        return self._values[code]

    def decode_array(self, codes: np.ndarray) -> list:
        out = []
        for c in codes:
            if c == NULL_CODE:
                out.append(None)
            elif 0 <= c < len(self._values):
                out.append(self._values[c])
            else:
                raise StorageError(f"dictionary code {int(c)} out of range")
        return out

    @property
    def values(self) -> list[str]:
        return list(self._values)

    def hash_tokens(self) -> np.ndarray:
        """int32 routing token per code (index-aligned lookup table).

        Device-side shuffles gather this table by code to route rows of
        string-distributed tables without touching bytes.
        """
        with self._mu:
            snapshot = list(self._values)
        return string_hash_tokens(snapshot)

    # -- persistence (atomic; append-only so rewrites are safe) ------------
    # Format: unit-separator-joined utf-8 ("CDICT1 <count>\n" header) —
    # JSON-encoding multi-million-entry dictionaries (near-unique text
    # columns) was the ingest commit's hottest host loop.  Values that
    # contain the separator fall back to a JSON file (detected on load
    # by its leading '[').
    def save(self, path: str) -> None:
        # snapshot under the intern lock: a concurrent intern between
        # packing and len() would write a count ≠ packed values and
        # poison every future load
        with self._mu:
            pack = self._dict_pack()
            count = len(self._values)
            payload = (None if pack is None
                       else f"CDICT1 {count}\n".encode() + pack[0])
            values_copy = list(self._values) if pack is None else None
        if payload is None:  # a value contains the separator byte
            from ..utils.io import atomic_write_json

            atomic_write_json(path, values_copy, indent=None)
            return
        from ..utils.io import atomic_write_bytes

        atomic_write_bytes(path, payload)

    @staticmethod
    def load(path: str) -> "Dictionary":
        with open(path, "rb") as f:
            raw = f.read()
        if raw.startswith(b"CDICT1 "):
            header, _, body = raw.partition(b"\n")
            count = int(header.split()[1])
            values = body.decode("utf-8").split("\x1f") if count else []
            if len(values) != count:
                raise StorageError(
                    f"dictionary {path}: expected {count} values, "
                    f"found {len(values)}")
        else:
            values = json.loads(raw.decode("utf-8"))
        return Dictionary(values)
