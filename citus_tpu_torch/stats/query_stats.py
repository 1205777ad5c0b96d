"""Per-statement execution statistics — citus_stat_statements analogue
(Citus src/backend/distributed/stats/query_stats.c).

Counterpart of citus_tpu/stats/query_stats.py: statements are
fingerprinted by their normalized text (literals → '?'), keyed like
queryId, and accumulate calls / time / rows.  Entry count is bounded;
the least-called entries are evicted (pg_stat_statements-style
dealloc)."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from ..sql.lexer import tokenize


_fp_memo: dict[str, str] = {}


def fingerprint(sql: str) -> str:
    """Normalized statement text: literals replaced with '?'.
    Memoized — the serving workload records the same hot texts at high
    QPS, and re-lexing each one is pure overhead (dict ops only,
    GIL-atomic; reset wholesale when full)."""
    fp = _fp_memo.get(sql)
    if fp is not None:
        return fp
    try:
        toks = tokenize(sql)
    except Exception:
        return " ".join(sql.split())
    out = []
    for t in toks:
        if t.kind in ("number", "string"):
            out.append("?")
        elif t.kind == "eof":
            break
        else:
            out.append(t.value)
    fp = " ".join(out)
    if len(_fp_memo) >= 4096:
        _fp_memo.clear()
    _fp_memo[sql] = fp
    return fp


@dataclass
class QueryStat:
    query: str
    calls: int = 0
    total_time_ms: float = 0.0
    min_time_ms: float = field(default=float("inf"))
    max_time_ms: float = 0.0
    rows: int = 0
    # executor attribution, like the reference's citus_stat_statements
    # executor column (adaptive / router / insert-select ...)
    executors: dict = field(default_factory=dict)


class QueryStats:
    def __init__(self, max_entries: int = 1000):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._stats: dict[str, QueryStat] = {}

    def record(self, sql: str, elapsed_ms: float, rows: int,
               executor: str = "adaptive") -> None:
        fp = fingerprint(sql)
        with self._lock:
            st = self._stats.get(fp)
            if st is None:
                if len(self._stats) >= self.max_entries:
                    victim = min(self._stats, key=lambda k:
                                 self._stats[k].calls)
                    del self._stats[victim]
                st = self._stats[fp] = QueryStat(query=fp)
            st.calls += 1
            st.total_time_ms += elapsed_ms
            st.min_time_ms = min(st.min_time_ms, elapsed_ms)
            st.max_time_ms = max(st.max_time_ms, elapsed_ms)
            st.rows += rows
            st.executors[executor] = st.executors.get(executor, 0) + 1

    def entries(self) -> list[QueryStat]:
        with self._lock:
            return sorted(self._stats.values(),
                          key=lambda s: -s.total_time_ms)

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
