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

The engine keeps the JAX package's vocabulary (mitmproxy's, there):

* ``kill`` — the default: raise at the seam (``error="injected"``
  raises InjectedFault, ``error="storage"`` StorageError,
  ``error="oom"`` DeviceMemoryExhausted, ``error="device"``
  DeviceLostError — the "connection lost" vs "disk error" vs "allocator
  OOM" vs "device lost" distinctions the statement retry envelope
  classifies by);
* ``delay`` — ``sleep=0.05`` sleeps at the seam first; with
  ``error=None`` the fault is a delay only;
* ``after=N`` — trigger only after N passes through the seam;
* ``times=N`` / ``once=False`` — trigger N times (or forever) before
  disarming;
* ``p=0.3, seed=…`` — probabilistic faults with a deterministic
  per-spec RNG (the chaos soak, tests/test_torch_chaos.py, arms these).

The unarmed cost is a dict emptiness check.  Every `fault_point()` call
is also a cooperative cancellation seam (utils/cancellation).

The port's points are the JAX package's points of the same names at the
same seams; `tests/test_torch_transactions.py` asserts that each point
of `FAULT_POINTS` is armed by at least one port test.
``python -m citus_tpu_torch.utils.faultinjection --list`` prints them.
"""

from __future__ import annotations

import contextlib
import random
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
    "catalog.placement_probe": "catalog/catalog.py — active-placement pick",
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
_injected_total = 0  # module-wide trigger count
_fired: dict[str, int] = {}  # per-point trigger counts since reset()


def registered_points() -> dict[str, str]:
    return dict(FAULT_POINTS)


def injected_total() -> int:
    return _injected_total


def fired_count(name: str) -> int:
    """How many times the armed point `name` triggered since reset()."""
    with _lock:
        return _fired.get(name, 0)


def fault_point(name: str) -> None:
    """Called at instrumented seams; triggers when armed.  Also a
    cooperative cancellation point for the executing statement."""
    check_cancel()
    if not _armed:
        return
    with _lock:
        spec = _armed.get(name)
        if spec is None:
            return
        if spec["after"] > 0:
            spec["after"] -= 1
            return
        if spec["p"] < 1.0 and spec["rng"].random() >= spec["p"]:
            return
        times = spec["times"]
        if times is not None:
            if times <= 1:
                del _armed[name]
            else:
                spec["times"] = times - 1
        global _injected_total
        _injected_total += 1
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


def arm(name: str, after: int = 0, once: bool = True,
        times: int | None = None, p: float = 1.0, sleep: float = 0.0,
        error: str | None = "injected", seed: int | None = None) -> None:
    """Arm `name`.  `times` (trigger count before disarm) overrides
    `once`; `once=False, times=None` stays armed until disarmed.
    `error` picks the raised kind ('injected' | 'storage' | 'oom' |
    'device') or None for a delay only."""
    if error not in (None, "injected", "storage", "oom", "device"):
        raise ValueError(f"unknown fault error kind {error!r}")
    with _lock:
        _armed[name] = {
            "after": after,
            "times": times if times is not None else (1 if once else None),
            "p": p, "sleep": sleep, "error": error,
            "rng": random.Random(seed),
        }


def disarm(name: str) -> None:
    with _lock:
        _armed.pop(name, None)


def armed_points() -> list[str]:
    with _lock:
        return sorted(_armed)


@contextlib.contextmanager
def inject(name: str, after: int = 0, once: bool = True,
           times: int | None = None, p: float = 1.0, sleep: float = 0.0,
           error: str | None = "injected", seed: int | None = None,
           require_fired: bool = False):
    """Arm `name` for the duration of the block (see `arm`).
    ``require_fired=True`` asserts on clean exit that the point
    triggered inside the block: a result-cache hit or a pruned path
    that never reaches the seam then fails the test instead of passing
    it."""
    base = fired_count(name)
    arm(name, after=after, once=once, times=times, p=p, sleep=sleep,
        error=error, seed=seed)
    try:
        yield
    finally:
        disarm(name)
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


def mesh_sim() -> MeshSim | None:
    return _mesh_sim


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


def reset() -> None:
    """Disarm every point and the MeshSim; clear the per-point counts."""
    global _mesh_sim
    with _lock:
        _armed.clear()
        _fired.clear()
        _mesh_sim = None


def main(argv: list[str] | None = None) -> int:
    """`python -m citus_tpu_torch.utils.faultinjection --list`."""
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("--list", "list"):
        for name in sorted(FAULT_POINTS):
            print(f"{name:32s} {FAULT_POINTS[name]}")
        return 0
    print("usage: python -m citus_tpu_torch.utils.faultinjection --list",
          file=sys.stderr)
    return 2


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
