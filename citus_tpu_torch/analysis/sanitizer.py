"""Runtime lock-order sanitizer (the TSAN half of the port's graftlint).

The static lock graph (`lockgraph.py`) sees only acquisitions it can
resolve; this module checks the orders that actually happen.  While
enabled, ``threading.Lock`` / ``threading.RLock`` construction returns
a thin wrapper that records per-thread acquisition stacks and
maintains one global lock-order graph, lockdep-style: locks are
grouped into *order classes* by their creation site (file:line), so
two ``WorkloadManager`` instances contribute to one class and an ABBA
inversion between any two classes is caught the FIRST time both orders
are observed — no actual deadlock (or even a second thread) required.

Enable with ``CITUS_TPU_TORCH_TSAN=1`` in the environment (checked at
``import citus_tpu_torch``; the variable is the port's own, so a
process that imports both packages never wraps the factories twice)
or programmatically::

    from citus_tpu_torch.analysis import sanitizer
    with sanitizer.enabled():
        sess = citus_tpu_torch.connect(...)  # locks created now are tracked
        ...
    assert sanitizer.violations() == []

On an inversion the acquiring thread raises ``LockOrderViolation``
carrying both acquisition stacks; the violation is also recorded in
``violations()`` for harnesses that prefer to assert at the end (the
chaos soak does both).

Scope and caveats:

* only locks *created while enabled* are tracked — enable before
  ``connect()`` so the per-data_dir managers' locks are wrapped;
* ``threading.Condition()``'s implicit RLock resolves through the
  patched factory, and ``Condition(wrapped_lock)`` works because the
  wrapper exposes acquire/release/__enter__/__exit__;
* same-class nesting (two instances of one creation site) is ignored
  by default — per-resource locks (one ``_Lock.cond`` per 2PL
  resource) legitimately interleave; instance-level self-deadlock
  (re-acquiring the very same non-reentrant lock) is always an error;
* the wrappers hold the interpreter's own primitives (``_thread``), so
  they stay real whatever ``threading.Lock`` is bound to when this
  module is imported; ``disable()`` restores exactly the factories
  ``enable()`` replaced.
"""

from __future__ import annotations

import _thread
import os
import threading
import traceback
from dataclasses import dataclass

_real_lock = _thread.allocate_lock
_real_rlock = _thread.RLock
# the factories enable() replaced, restored by disable()
_replaced: tuple | None = None


class LockOrderViolation(AssertionError):
    """Two lock order classes were acquired in both orders."""


@dataclass
class Violation:
    first: str          # order class acquired first (held)
    second: str         # order class acquired second
    stack: str          # acquisition stack of the inverting acquire
    prior_stack: str    # stack that established the opposite edge
    thread: str = ""

    def __str__(self) -> str:
        return (f"lock-order inversion: {self.first} -> {self.second} "
                f"contradicts an earlier {self.second} -> {self.first} "
                f"(thread {self.thread})\n--- inverting acquisition:\n"
                f"{self.stack}\n--- earlier opposite order:\n"
                f"{self.prior_stack}")


class _State:
    def __init__(self):
        self.mu = _real_lock()
        # order-class digraph: edges[(a, b)] = stack that recorded a→b
        self.edges: dict[tuple[str, str], str] = {}
        self.graph: dict[str, set[str]] = {}
        # (a, b) pairs already reported as violations: report an
        # inversion ONCE, and let the fast path skip it afterwards (the
        # pair is deliberately never added to the order graph)
        self.reported: set[tuple[str, str]] = set()
        self.violations: list[Violation] = []
        self.tls = threading.local()
        self.enabled = False
        self.raise_on_violation = True
        self.locks_created = 0
        self.acquisitions = 0

    def held(self) -> list:
        h = getattr(self.tls, "held", None)
        if h is None:
            h = self.tls.held = []
        return h

    def _path_exists(self, src: str, dst: str) -> bool:
        seen = {src}
        work = [src]
        while work:
            n = work.pop()
            if n == dst:
                return True
            for nxt in self.graph.get(n, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    work.append(nxt)
        return False

    def on_acquired(self, lock: "_TsanLockBase") -> None:
        held = self.held()
        self.acquisitions += 1
        if held:
            # steady-state fast path: every (held, lock) edge already
            # recorded → no global mutex (dict reads are GIL-atomic and
            # the edge set only grows)
            if all(h.order_class == lock.order_class
                   or (h.order_class, lock.order_class) in self.edges
                   or (h.order_class, lock.order_class) in self.reported
                   for h in held):
                held.append(lock)
                return
            stack = None
            with self.mu:
                for prior in held:
                    a, b = prior.order_class, lock.order_class
                    if a == b:
                        continue
                    if (a, b) in self.edges or (a, b) in self.reported:
                        continue
                    # would a→b close a cycle with the existing graph?
                    if self._path_exists(b, a):
                        if stack is None:
                            stack = "".join(traceback.format_stack(
                                limit=16)[:-2])
                        prior_stack = self.edges.get(
                            (b, a), "(transitive: no direct edge)")
                        v = Violation(a, b, stack, prior_stack,
                                      threading.current_thread().name)
                        self.reported.add((a, b))
                        self.violations.append(v)
                        if self.raise_on_violation:
                            raise LockOrderViolation(str(v))
                        continue
                    if stack is None:
                        stack = "".join(traceback.format_stack(
                            limit=16)[:-2])
                    self.edges[(a, b)] = stack
                    self.graph.setdefault(a, set()).add(b)
        held.append(lock)

    def on_released(self, lock: "_TsanLockBase") -> None:
        held = self.held()
        # release order need not be LIFO (Condition.wait releases out
        # of order); drop the most recent entry for this lock
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                return


_state = _State()


def _creation_site() -> str:
    """file:line of the frame that called threading.Lock()/RLock(),
    skipping sanitizer and threading internals."""
    for frame in reversed(traceback.extract_stack(limit=12)[:-2]):
        fn = frame.filename
        if fn.endswith("threading.py") or fn.endswith("sanitizer.py"):
            continue
        short = os.sep.join(fn.split(os.sep)[-3:])
        return f"{short}:{frame.lineno}"
    return "<unknown>"


class _TsanLockBase:
    _reentrant = False

    def __init__(self, inner):
        self._inner = inner
        self._site = _creation_site()
        self._depth_tls = threading.local()
        _state.locks_created += 1

    @property
    def order_class(self) -> str:
        return self._site

    def _depth(self) -> int:
        return getattr(self._depth_tls, "d", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if self._reentrant and self._depth() > 0:
            ok = self._inner.acquire(blocking, timeout)
            if ok:
                self._depth_tls.d = self._depth() + 1
            return ok
        if not self._reentrant and _state.enabled and blocking and \
                any(h is self for h in _state.held()):
            # blocking re-acquire of the same non-reentrant instance
            # would deadlock this thread right here (a non-blocking
            # probe — Condition._is_owned — is fine)
            v = Violation(self.order_class, self.order_class,
                          "".join(traceback.format_stack(limit=16)[:-1]),
                          "(same lock instance already held)",
                          threading.current_thread().name)
            with _state.mu:
                _state.violations.append(v)
            if _state.raise_on_violation:
                raise LockOrderViolation(
                    f"self-deadlock: non-reentrant lock "
                    f"{self.order_class} re-acquired while held\n"
                    f"{v.stack}")
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._depth_tls.d = self._depth() + 1
            if _state.enabled:
                try:
                    _state.on_acquired(self)
                except LockOrderViolation:
                    # don't leak the lock out of a failed acquire: the
                    # `with` statement's __exit__ will never run
                    self._depth_tls.d = self._depth() - 1
                    self._inner.release()
                    raise
        return ok

    def release(self):
        d = self._depth()
        self._depth_tls.d = max(0, d - 1)
        if not self._reentrant or d <= 1:
            # unconditional (even when disabled): a lock acquired while
            # enabled and released after disable() must not stay
            # phantom-held on this thread's stack, where it would
            # fabricate order edges on the next enable()
            _state.on_released(self)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def _at_fork_reinit(self):
        # os.register_at_fork hooks (concurrent.futures.thread, logging)
        # reinitialize module locks in a forked child
        self._inner._at_fork_reinit()
        self._depth_tls = threading.local()
        _state.on_released(self)  # released: not held on this thread

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return (f"<tsan {type(self).__name__} {self._site} "
                f"wrapping {self._inner!r}>")


class TsanLock(_TsanLockBase):
    def __init__(self):
        super().__init__(_real_lock())


class TsanRLock(_TsanLockBase):
    _reentrant = True

    def __init__(self):
        super().__init__(_real_rlock())

    # threading.Condition probes these to integrate with RLocks
    def _is_owned(self):
        return self._inner._is_owned()

    def _recursion_count(self):
        return self._inner._recursion_count()

    def _release_save(self):
        # drop ALL recursion levels (Condition.wait); unconditional for
        # the same phantom-held reason as release()
        d = self._depth()
        self._depth_tls.d = 0
        _state.on_released(self)
        return (self._inner._release_save(), d)

    def _acquire_restore(self, saved):
        inner_state, d = saved
        self._inner._acquire_restore(inner_state)
        self._depth_tls.d = d
        if _state.enabled:
            _state.on_acquired(self)


def enable(raise_on_violation: bool = True) -> None:
    """Patch the threading lock factories; locks created from now on
    are order-tracked.  Idempotent."""
    global _replaced
    if _replaced is None:
        _replaced = (threading.Lock, threading.RLock)
    _state.enabled = True
    _state.raise_on_violation = raise_on_violation
    threading.Lock = TsanLock
    threading.RLock = TsanRLock


def disable() -> None:
    """Restore the factories enable() replaced and stop tracking
    (wrappers created while enabled keep delegating, untracked)."""
    global _replaced
    if _replaced is not None:
        threading.Lock, threading.RLock = _replaced
        _replaced = None
    _state.enabled = False


def reset() -> None:
    """Clear the recorded order graph and violations (fresh harness)."""
    with _state.mu:
        _state.edges.clear()
        _state.graph.clear()
        _state.reported.clear()
        _state.violations.clear()
    _state.locks_created = 0
    _state.acquisitions = 0


def violations() -> list[Violation]:
    with _state.mu:
        return list(_state.violations)


def stats() -> dict:
    return {"enabled": _state.enabled,
            "locks_created": _state.locks_created,
            "acquisitions": _state.acquisitions,
            "order_edges": len(_state.edges),
            "violations": len(_state.violations)}


class enabled:
    """Context manager: enable on entry, disable on exit (state — the
    recorded order graph — is kept for the caller to assert on)."""

    def __init__(self, raise_on_violation: bool = True):
        self.raise_on_violation = raise_on_violation

    def __enter__(self):
        enable(self.raise_on_violation)
        return self

    def __exit__(self, *exc):
        disable()
        return False


def maybe_enable_from_env() -> bool:
    """CITUS_TPU_TORCH_TSAN=1 arms the sanitizer at citus_tpu_torch
    import."""
    if os.environ.get("CITUS_TPU_TORCH_TSAN") == "1":
        enable()
        return True
    return False
