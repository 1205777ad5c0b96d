"""Fault-injection points for the storage, executor and transaction seams.

Counterpart of citus_tpu/utils/faultinjection.py, carrying the named
points that the port's read, write and memory paths call.  The reference injects failures
by interposing mitmproxy between coordinator and worker and killing
traffic at named moments (`citus.mitmproxy('conn.onQuery(query="COMMIT")
.kill()')`, Citus src/test/regress/mitmscripts/README.md).  Here the
boundaries to break are the storage reads and writes, the device
placement and execute steps, and the 2PC steps, so named
fault points sit at those seams and tests arm them:

    with inject("txn.commit_record"):
        session.execute("COMMIT")      # dies right before the record

An armed point fires once, or ``times=N`` times: ``error="injected"``
(the default) raises InjectedFault, ``error="storage"`` StorageError and
``error="oom"`` DeviceMemoryExhausted — the "connection lost" vs "disk
error" vs "allocator OOM" distinctions the statement retry envelope
classifies by; ``error=None`` with ``sleep`` is a delay only.  (The JAX
package's delayed-start and probabilistic faults serve its chaos soak,
which is not ported.)

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

from ..errors import DeviceMemoryExhausted, ExecutionError, StorageError
from .cancellation import check_cancel


class InjectedFault(ExecutionError):
    """Raised at an armed fault point (the 'connection killed' analogue).
    Subclasses ExecutionError, so a surfaced injection is a clean
    CitusTpuError."""


# every named seam of the port, with the module that hosts it
FAULT_POINTS: dict[str, str] = {
    "store.append_stripe": "storage/table_store.py — shard stripe write",
    "store.apply_dml": "storage/table_store.py — DML manifest flip",
    "store.read_shard": "storage/table_store.py — shard stripe read",
    "storage.stripe_torn_write":
        "storage/format.py — stripe streamed, not yet renamed in",
    "storage.stripe_bitflip":
        "storage/table_store.py — one flipped bit in the stripe about "
        "to be read (verified_read)",
    "storage.manifest_flip":
        "storage/table_store.py — manifest visibility flip",
    "executor.overflow_retry": "executor/runner.py — capacity regrow",
    "executor.plan_cache_fill": "executor/runner.py — compiled-plan insert",
    "executor.hbm_exhausted":
        "executor/hbm.py — accounted placement seam (arm with "
        "error='oom' for a synthetic allocator OOM)",
    "executor.exec_cache_load":
        "executor/execcache.py — persisted plan adoption (an injected "
        "fault models rot: a counted reject, never a crash)",
    "executor.exec_cache_store":
        "executor/execcache.py — persisted plan write (fires before the "
        "best-effort catch, so an injected fault errors the statement "
        "cleanly)",
    "wlm.warmup":
        "executor/runner.py — warm-before-admit arming (a fault "
        "degrades the warmup to lazy resolution; the admission hold "
        "always releases)",
    "executor.repartition_shuffle":
        "executor/insert_select.py — INSERT..SELECT repartition write",
    "executor.scan_prefetch":
        "executor/scanpipe.py — producer column read (pipelined scan)",
    "executor.agg_bucket_fill":
        "executor/compiler.py — bucketed group-by pack",
    "executor.device_put":
        "executor/feed.py — eager feed placement of a scan's columns",
    "mesh.device_put":
        "distributed/mesh.py — per-position host→device transfer (arm "
        "with error='device' for a synthetic device loss; MeshSim kills "
        "chosen positions here)",
    "mesh.collective":
        "executor/compiler.py — a collective exchange across the mesh "
        "(a position dying mid-all_to_all kills the statement)",
    "mesh.fetch":
        "executor/compiler.py — device→host result fetch (the last seam "
        "a dying position can poison)",
    "executor.device_decode":
        "executor/scanpipe.py — on-device expand of a wire payload",
    "stream.prefetch": "executor/stream.py — batch prefetch thread",
    "txn.prepare": "transaction/manager.py — before PREPARE",
    "txn.commit_record": "transaction/manager.py — prepared, no record",
    "txn.apply": "transaction/manager.py — record durable, not applied",
    "cdc.append": "cdc/feed.py — change-journal append",
    "operations.shard_move": "operations/shard_transfer.py — mid-move",
    "operations.shard_split":
        "operations/shard_split.py — children written, catalog not "
        "committed",
    "wlm.admit": "wlm/manager.py — admission gate entry",
    "serving.batch_dispatch":
        "serving/batcher.py — one coalesced point-lookup batch",
    "serving.cache_fill": "serving/result_cache.py — result insert",
    "replication.ship": "replication/shipper.py — batch staging",
    "replication.apply": "replication/applier.py — batch roll-forward",
    "replication.promote": "replication/promote.py — follower promotion",
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
        spec = _armed.get(name)
        if spec is None:
            return
        spec["times"] -= 1
        if spec["times"] <= 0:
            del _armed[name]
        _fired[name] = _fired.get(name, 0) + 1
    if spec["sleep"]:
        time.sleep(spec["sleep"])  # delay fault (outside the lock)
    kind = spec["error"]
    if kind is None:
        return  # delay-only
    if kind == "storage":
        exc: Exception = StorageError(f"injected storage fault at {name!r}")
    elif kind == "device":
        # an opaque device loss (device_id None): the session's probe
        # pass has to find the lost position
        from ..errors import DeviceLostError

        exc = DeviceLostError(f"injected device loss at {name!r}",
                              seam=name)
    elif kind == "oom":
        # classified by the session's retry envelope as retryable after
        # degradation: an armed memory fault walks the OOM ladder
        exc = DeviceMemoryExhausted(
            f"injected device OOM (RESOURCE_EXHAUSTED) at {name!r}")
    else:
        exc = InjectedFault(f"injected fault at {name!r}")
    exc.fault_point = name
    exc.injected_fault = True
    raise exc


@contextlib.contextmanager
def inject(name: str, sleep: float = 0.0, error: str | None = "injected",
           require_fired: bool = False, times: int = 1):
    """Arm `name` for the duration of the block, to fire `times` times
    ('injected' | 'storage' | 'oom' | 'device', or None for a delay
    only).
    ``require_fired=True`` asserts on clean exit that the point
    triggered inside the block."""
    if error not in (None, "injected", "storage", "oom", "device"):
        raise ValueError(f"unknown fault error kind {error!r}")
    base = fired_count(name)
    with _lock:
        _armed[name] = {"sleep": sleep, "error": error,
                        "times": max(1, int(times))}
    try:
        yield
    finally:
        with _lock:
            _armed.pop(name, None)
    if require_fired and fired_count(name) - base < 1:
        raise AssertionError(
            f"armed fault point {name!r} never fired inside the "
            "inject() block")


class MeshSim:
    """One simulated mesh-failure lifetime (the JAX package's MeshSim):
    the mesh seams (``mesh.device_put`` / ``mesh.collective`` /
    ``mesh.fetch``) consult the armed sim through `mesh_device_check`.

    * ``kill``  — sticky lost positions (by position id): every seam that
      touches one raises DeviceLostError until the sim is uninstalled;
    * ``error`` — one-shot: the first touch raises, then the position
      recovers (a transient link flap);
    * ``hang``  — position id → seconds the seam waits first (pair with
      statement_timeout_ms: the deadline, not the sim, ends the
      statement, because the wait is a cancellation seam);
    * ``after`` — skip the first N seam checks, so a kill lands in the
      middle of a statement instead of on its first touch.
    """

    def __init__(self, kill=(), error=(), hang=None, after: int = 0):
        self.kill = set(kill)
        self.error = set(error)
        self.hang = dict(hang or {})
        self.after = after
        self.checks = 0
        self.trips = 0


_mesh_sim: MeshSim | None = None


def install_mesh_sim(sim: MeshSim | None) -> None:
    global _mesh_sim
    with _lock:
        _mesh_sim = sim


@contextlib.contextmanager
def simulate_mesh(kill=(), error=(), hang=None, after: int = 0):
    """Arm a MeshSim for the duration of the block (`kill` / `error`
    take position ids)."""
    sim = MeshSim(kill=kill, error=error, hang=hang, after=after)
    install_mesh_sim(sim)
    try:
        yield sim
    finally:
        install_mesh_sim(None)


def mesh_device_check(seam: str, device_ids) -> None:
    """Called at the mesh seams with the position ids the operation
    touches; raises DeviceLostError for the first killed or erroring
    position the armed MeshSim names.  Unarmed cost: one None check."""
    sim = _mesh_sim
    if sim is None:
        return
    with _lock:
        if _mesh_sim is not sim:
            return
        sim.checks += 1
        if sim.checks <= sim.after:
            return
        hang = max((sim.hang.get(d, 0.0) for d in device_ids),
                   default=0.0)
        victim = next((d for d in device_ids if d in sim.kill), None)
        transient = None
        if victim is None:
            transient = next((d for d in device_ids if d in sim.error),
                             None)
            if transient is not None:
                sim.error.discard(transient)
        if victim is not None or transient is not None:
            sim.trips += 1
    if hang:
        # a hung position: wait in short slices at a cancellation seam,
        # so the statement's deadline ends the wait
        end = time.monotonic() + hang
        while True:
            check_cancel()
            left = end - time.monotonic()
            if left <= 0:
                break
            time.sleep(min(0.01, left))
    dead = victim if victim is not None else transient
    if dead is None:
        return
    from ..errors import DeviceLostError

    exc = DeviceLostError(
        f"device {dead} lost at {seam!r} "
        f"({'killed' if victim is not None else 'transient error'}, "
        "MeshSim)", device_id=dead, seam=seam)
    exc.injected_fault = True
    raise exc
