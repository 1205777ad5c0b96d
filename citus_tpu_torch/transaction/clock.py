"""Hybrid logical clock (HLC).

Counterpart of citus_tpu/transaction/clock.py, the same values.  Port of the reference's cluster clock semantics
(Citus src/backend/distributed/clock/causal_clock.c:59: 42-bit
millisecond wall clock + 22-bit logical counter, monotonic, adjusted to the
max observed remote value at commit — clock/README.md:27-40).
"""

from __future__ import annotations

import threading
import time

COUNTER_BITS = 22
MAX_COUNTER = (1 << COUNTER_BITS) - 1
MAX_LOGICAL = (1 << 42) - 1


class HybridLogicalClock:
    def __init__(self):
        self._lock = threading.Lock()
        self._wall_ms = 0
        self._counter = 0

    def _tick_locked(self) -> tuple[int, int]:
        now_ms = int(time.time() * 1000) & MAX_LOGICAL
        if now_ms > self._wall_ms:
            self._wall_ms = now_ms
            self._counter = 0
        else:
            self._counter += 1
            if self._counter > MAX_COUNTER:
                self._wall_ms += 1
                self._counter = 0
        return self._wall_ms, self._counter

    def now(self) -> int:
        """Monotonic 64-bit value: (wall_ms << 22) | counter."""
        with self._lock:
            w, c = self._tick_locked()
            return (w << COUNTER_BITS) | c

    def observe(self, remote: int) -> int:
        """Adjust to a remote clock (max rule) and return the new local
        value — the commit-time exchange in the reference."""
        with self._lock:
            rw, rc = remote >> COUNTER_BITS, remote & MAX_COUNTER
            if rw > self._wall_ms or (rw == self._wall_ms
                                      and rc > self._counter):
                self._wall_ms, self._counter = rw, rc
            w, c = self._tick_locked()
            return (w << COUNTER_BITS) | c

    @staticmethod
    def parts(value: int) -> tuple[int, int]:
        return value >> COUNTER_BITS, value & MAX_COUNTER


global_clock = HybridLogicalClock()
