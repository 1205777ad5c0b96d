"""Power-cut simulation over the utils/io durable-write seam.

Counterpart of citus_tpu/utils/crashsim.py, over the port's utils/io.

SQLite proves its crash safety by replaying a logged workload against a
simulated disk and yanking the power at every IO; this is the same idea
sized to our write discipline.  Every durable primitive in ``utils/io``
(atomic JSON/bytes writes, streamed stripe finalizes, journal appends)
reports to the installed ``CrashSim`` which

* journals the op (index, kind, path) for the harness to enumerate;
* at the armed crashpoint applies a *tear* — the physically possible
  post-crash state of that op — and raises :class:`PowerCut`;
* afterwards freezes the disk: every further write from the "dying
  process" raises PowerCut too (a dead process writes nothing, and in
  particular its exception handlers cannot tidy torn tmp files).

Tear modes (cycled deterministically by crashpoint index, or forced):

* ``lost`` — the op left no trace (no page of it reached the platter);
* ``torn`` — half the payload is on disk: an orphan ``.aw.``/.tmp file
  for atomic writes, a truncated tmp for streamed stripes, a torn tail
  line for journal appends;
* ``complete`` — the op is fully durable and the crash hits just after.

PowerCut deliberately subclasses BaseException: the resilience envelope
retries Exceptions, but a power cut is process death — nothing in the
dying session may catch it, the harness alone handles it.
"""

from __future__ import annotations

import os
import threading

from . import io as _io

TEAR_MODES = ("lost", "torn", "complete")


class PowerCut(BaseException):
    """Simulated power cut: the process is dead from this point on."""


class CrashSim:
    """One simulated disk lifetime: arm with ``crash_at=N`` to cut
    power at the N-th durable write op (1-based)."""

    def __init__(self, crash_at: int | None = None,
                 mode: str | None = None):
        if mode is not None and mode not in TEAR_MODES:
            raise ValueError(f"unknown tear mode {mode!r}")
        self.crash_at = crash_at
        self.forced_mode = mode
        self.ops = 0
        self.dead = False
        self.journal: list[tuple[int, str, str]] = []
        self.tear_applied: str | None = None
        self._mu = threading.Lock()

    # -- the seam (called from utils/io) ------------------------------------
    def op(self, kind: str, path: str, payload: bytes | None = None,
           tmp: str | None = None) -> None:
        with self._mu:
            if self.dead:
                raise PowerCut(f"disk frozen (crashed at op "
                               f"{self.crash_at}); dropped {kind} "
                               f"of {path}")
            self.ops += 1
            n = self.ops
            self.journal.append((n, kind, path))
            if self.crash_at is None or n != self.crash_at:
                return
            self.dead = True
            mode = (self.forced_mode if self.forced_mode is not None
                    else TEAR_MODES[n % len(TEAR_MODES)])
            self.tear_applied = mode
        self._tear(mode, kind, path, payload, tmp)
        raise PowerCut(f"power cut at write op {n} ({kind} {path}, "
                       f"tear={mode})")

    # -- tear application ----------------------------------------------------
    def _tear(self, mode: str, kind: str, path: str,
              payload: bytes | None, tmp: str | None) -> None:
        if mode == "lost":
            if kind == "stream_finalize" and tmp and os.path.exists(tmp):
                os.unlink(tmp)  # none of the streamed pages survived
            return
        if mode == "complete":
            if kind == "atomic_write":
                _io._raw_atomic_write_bytes(path, payload or b"")
            elif kind == "stream_finalize":
                _io._raw_finalize_stream(tmp, path)
            elif kind == "append":
                _io._raw_append_bytes(path, payload or b"")
            return
        # torn: half the bytes hit the platter
        if kind == "atomic_write":
            half = (payload or b"")[: max(1, len(payload or b"") // 2)]
            torn = os.path.join(os.path.dirname(os.path.abspath(path)),
                                f".aw.torn{self.ops}")
            with open(torn, "wb") as f:
                f.write(half)
        elif kind == "stream_finalize" and tmp and os.path.exists(tmp):
            size = os.path.getsize(tmp)
            with open(tmp, "r+b") as f:
                f.truncate(max(1, size // 2))
        elif kind == "append":
            half = (payload or b"")[: max(1, len(payload or b"") // 2)]
            _io._raw_append_bytes(path, half)


class power_cut_at:
    """``with power_cut_at(n) as sim:`` — install a CrashSim armed at op
    *n* for the duration of the block.  ``n=None`` counts ops without
    crashing (the rehearsal run that sizes the sweep)."""

    def __init__(self, crash_at: int | None, mode: str | None = None):
        self.sim = CrashSim(crash_at, mode)

    def __enter__(self) -> CrashSim:
        _io.install_sim(self.sim)
        return self.sim

    def __exit__(self, *exc) -> bool:
        _io.install_sim(None)
        return False
