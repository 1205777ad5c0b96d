"""Cooperative statement deadlines and cross-thread cancel.

Counterpart of citus_tpu/utils/cancellation.py.  The reference relays
PostgreSQL's statement_timeout and cancel interrupts into the adaptive
executor's wait loops (adaptive_executor.c event processing).  Here each
executing statement installs one thread-local `Deadline`
(`Session._execute_resilient`); the seams — named fault points,
stream/COPY batch boundaries, multi-pass passes, the overflow-retry loop
and statement retry iterations — call `check_cancel()`, which raises
`StatementTimeout` once the deadline passed or `QueryCanceled` once
another thread called `Session.cancel()`.

The check is a thread-local read plus one clock read: cheap enough to
sit on every seam, and a no-op on threads with no statement in flight
(prefetch producers).
"""

from __future__ import annotations

import contextlib
import threading
import time

from ..errors import QueryCanceled, StatementTimeout

_tls = threading.local()


class Deadline:
    """One statement's cancellation state: an optional wall-clock expiry
    plus an optional cross-thread cancel event."""

    __slots__ = ("expires_at", "cancel_evt")

    def __init__(self, timeout_ms: float | None,
                 cancel_evt: threading.Event | None = None):
        self.expires_at = (time.monotonic() + timeout_ms / 1000.0
                           if timeout_ms else None)
        self.cancel_evt = cancel_evt

    def remaining(self) -> float | None:
        """Seconds until expiry; None = no deadline."""
        if self.expires_at is None:
            return None
        return self.expires_at - time.monotonic()


def current_deadline() -> Deadline | None:
    return getattr(_tls, "deadline", None)


@contextlib.contextmanager
def deadline_scope(timeout_ms: float | None,
                   cancel_evt: threading.Event | None = None):
    """Install a per-statement deadline on this thread (nestable: an
    inner scope shadows, the outer one is restored on exit)."""
    prev = getattr(_tls, "deadline", None)
    _tls.deadline = Deadline(timeout_ms, cancel_evt)
    try:
        yield _tls.deadline
    finally:
        _tls.deadline = prev


def check_cancel() -> None:
    """Raise if the current statement was canceled or timed out; no-op
    on threads without an installed deadline."""
    d = getattr(_tls, "deadline", None)
    if d is None:
        return
    if d.cancel_evt is not None and d.cancel_evt.is_set():
        raise QueryCanceled("canceling statement due to user request")
    if d.expires_at is not None and time.monotonic() > d.expires_at:
        raise StatementTimeout(
            "canceling statement due to statement timeout")
