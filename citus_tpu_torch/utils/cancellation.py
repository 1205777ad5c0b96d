"""Cooperative statement cancel: a thread-local cross-thread cancel event.

Counterpart of citus_tpu/utils/cancellation.py.  The reference relays
PostgreSQL's cancel interrupts into the adaptive executor's wait loops
(adaptive_executor.c event processing).  Here each executing statement
installs its session's cancel event on its thread (`Session.execute`);
the seams — named fault points and COPY batch boundaries — call
`check_cancel()` and raise `QueryCanceled` once another thread called
`Session.cancel()`.  Statement timeouts come with the retry envelope
(ROADMAP queue A item 13).

The check is one thread-local read: cheap enough to sit on every seam,
and a no-op on threads with no statement in flight (prefetch producers).
"""

from __future__ import annotations

import contextlib
import threading

from ..errors import QueryCanceled

_tls = threading.local()


@contextlib.contextmanager
def deadline_scope(cancel_evt: threading.Event):
    """Install a statement's cancel event on this thread (nestable: an
    inner scope shadows, the outer one is restored on exit)."""
    prev = getattr(_tls, "cancel_evt", None)
    _tls.cancel_evt = cancel_evt
    try:
        yield
    finally:
        _tls.cancel_evt = prev


def check_cancel() -> None:
    """Raise QueryCanceled if the current statement was canceled; no-op
    on threads without an installed cancel event."""
    evt = getattr(_tls, "cancel_evt", None)
    if evt is not None and evt.is_set():
        raise QueryCanceled("canceling statement due to user request")
