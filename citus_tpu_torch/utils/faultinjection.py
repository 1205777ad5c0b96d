"""Fault-injection points for the storage and transaction seams.

Counterpart of citus_tpu/utils/faultinjection.py, carrying the named
points that the port's write path calls.  The reference injects failures
by interposing mitmproxy between coordinator and worker and killing
traffic at named moments (`citus.mitmproxy('conn.onQuery(query="COMMIT")
.kill()')`, Citus src/test/regress/mitmscripts/README.md).  Here the
boundaries to break are the storage writes and the 2PC steps, so named
fault points sit at those seams and tests arm them:

    with inject("txn.commit_record"):
        session.execute("COMMIT")      # dies right before the record

An armed point fires once: ``error="injected"`` (the default) raises
InjectedFault; ``error=None`` with ``sleep`` is a delay only.  (The JAX package's multi-shot, delayed-start
and probabilistic faults serve its chaos soak, which is not ported.)

The unarmed cost is a dict emptiness check.  Every `fault_point()` call
is also a cooperative cancellation seam (utils/cancellation).

The port's points are the JAX package's points of the same names at the
same seams; `tests/test_torch_transactions.py` asserts that each point
of `FAULT_POINTS` is armed by at least one port test.
"""

from __future__ import annotations

import contextlib
import threading
import time

from ..errors import ExecutionError
from .cancellation import check_cancel


class InjectedFault(ExecutionError):
    """Raised at an armed fault point (the 'connection killed' analogue).
    Subclasses ExecutionError, so a surfaced injection is a clean
    CitusTpuError."""


# every named seam of the port, with the module that hosts it
FAULT_POINTS: dict[str, str] = {
    "store.append_stripe": "storage/table_store.py — shard stripe write",
    "store.apply_dml": "storage/table_store.py — DML manifest flip",
    "storage.manifest_flip":
        "storage/table_store.py — manifest visibility flip",
    "executor.repartition_shuffle":
        "executor/insert_select.py — INSERT..SELECT repartition write",
    "txn.prepare": "transaction/manager.py — before PREPARE",
    "txn.commit_record": "transaction/manager.py — prepared, no record",
    "txn.apply": "transaction/manager.py — record durable, not applied",
    "cdc.append": "cdc/feed.py — change-journal append",
}

_lock = threading.Lock()
_armed: dict[str, dict] = {}
_fired: dict[str, int] = {}  # per-point trigger counts


def registered_points() -> dict[str, str]:
    return dict(FAULT_POINTS)


def fired_count(name: str) -> int:
    """How many times the armed point `name` triggered."""
    with _lock:
        return _fired.get(name, 0)


def fault_point(name: str) -> None:
    """Called at instrumented seams; triggers (once) when armed.  Also a
    cooperative cancellation point for the executing statement."""
    check_cancel()
    if not _armed:
        return
    with _lock:
        spec = _armed.pop(name, None)
        if spec is None:
            return
        _fired[name] = _fired.get(name, 0) + 1
    if spec["sleep"]:
        time.sleep(spec["sleep"])  # delay fault (outside the lock)
    if spec["error"] is None:
        return  # delay-only
    exc = InjectedFault(f"injected fault at {name!r}")
    exc.fault_point = name
    exc.injected_fault = True
    raise exc


@contextlib.contextmanager
def inject(name: str, sleep: float = 0.0, error: str | None = "injected",
           require_fired: bool = False):
    """Arm `name` for the duration of the block.  ``require_fired=True``
    asserts on clean exit that the point triggered inside the block."""
    if error not in (None, "injected"):
        raise ValueError(f"unknown fault error kind {error!r}")
    base = fired_count(name)
    with _lock:
        _armed[name] = {"sleep": sleep, "error": error}
    try:
        yield
    finally:
        with _lock:
            _armed.pop(name, None)
    if require_fired and fired_count(name) - base < 1:
        raise AssertionError(
            f"armed fault point {name!r} never fired inside the "
            "inject() block")
