"""Workload manager: admission control, per-tenant fair queueing and
overload shedding for concurrent sessions.

Counterpart of citus_tpu/wlm/manager.py.  The reference stands a
governor between clients and the workers: ``citus.max_shared_pool_size``
/ ``max_adaptive_executor_pool_size`` bound how much concurrent work
reaches the cluster (shared_library_init.c).  Here it sits between parse
and execution: every non-exempt statement passes through ONE
process-wide manager per data_dir (the lock_manager_for pattern —
sessions sharing a data directory share the card, its caching allocator
and the device-memory ledger of executor/hbm.py).

Three gates compose:

* **slots** — at most ``max_concurrent_statements`` admitted at once.
* **device-memory budget** — a statement is admitted only while the sum
  of admitted statements' planned feed bytes (or, when larger, the
  accountant's measured non-evictable bytes) fits
  ``max_feed_bytes_per_device``.  A statement whose own estimate exceeds
  the whole budget admits alone (streaming bounds its residency).
* **per-tenant fair queue** — waiters queue per (priority class,
  tenant); classes dispatch in strict ``interactive > batch >
  background`` order, and within a class tenants dispatch by weighted
  round-robin (credit/deficit over ``wlm_tenant_weights``).

Overload sheds instead of queueing without bound: each priority class
holds at most ``wlm_queue_depth`` waiters; beyond that the statement
fails fast with a clean ``AdmissionRejected``.  Queue waits run
``check_cancel`` every slice, so ``statement_timeout_ms`` and
``Session.cancel()`` abort a queued statement promptly.

Invariant: every admission request resolves to exactly one of admitted /
shed / timed-out / canceled.

Warm-before-admit: while a fresh session's warmup arms the persisted
plan cache (executor/runner.py `warmup_from_cache`), `hold_admissions`
makes non-exempt admissions wait until `release_admissions` or the
hold's deadline, whichever comes first; the wait runs `check_cancel`
every slice, and the deadline means an overrun never blocks admission
for good.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..errors import AdmissionRejected, ConfigError

PRIORITIES = ("interactive", "batch", "background")


def parse_tenant_weights(spec: str) -> dict[str, int]:
    """``"alice:3,bob:1"`` → ``{"alice": 3, "bob": 1}``; unlisted
    tenants weigh 1.  Raises ConfigError on malformed entries (the
    ``wlm_tenant_weights`` validator)."""
    out: dict[str, int] = {}
    if not spec:
        return out
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, w = part.partition(":")
        name = name.strip()
        if not name:
            raise ConfigError(
                f"wlm_tenant_weights: empty tenant name in {spec!r}")
        try:
            weight = int(w.strip()) if sep else 1
        except ValueError:
            raise ConfigError(
                f"wlm_tenant_weights: weight for {name!r} must be an "
                f"integer, got {w.strip()!r}") from None
        if weight < 1:
            raise ConfigError(
                f"wlm_tenant_weights: weight for {name!r} must be >= 1")
        out[name] = weight
    return out


@dataclass
class AdmissionRequest:
    """One statement's admission parameters, captured from the calling
    session's settings at request time."""

    tenant: str = "default"
    priority: str = "interactive"
    feed_bytes: int = 0        # planned device feed estimate
    weight: int = 1
    max_slots: int = 8
    max_feed_bytes: int = 0    # 0 disables the memory gate
    queue_depth: int = 64      # per-priority-class bound; 0 ⇒ shed now


@dataclass
class Ticket:
    """Proof of admission; release() takes it back exactly once."""

    tenant: str
    priority: str
    feed_bytes: int
    queued_ms: float = 0.0
    was_queued: bool = False   # waited in the fair queue (vs immediate)
    slots_in_use: int = 0      # snapshot at admission (EXPLAIN display)
    slots_total: int = 0
    _released: bool = field(default=False, repr=False)


class _Waiter:
    __slots__ = ("req", "evt", "admitted", "ticket")

    def __init__(self, req: AdmissionRequest):
        self.req = req
        self.evt = threading.Event()
        self.admitted = False
        self.ticket: Ticket | None = None


class WorkloadManager:
    """Process-wide admission gate shared by sessions on one data_dir."""

    def __init__(self):
        self._cv = threading.Condition(threading.Lock())
        self._running = 0
        self._feed_inflight = 0
        # priority class → tenant → FIFO of waiters
        self._queues: dict[str, dict[str, deque]] = {
            p: {} for p in PRIORITIES}
        self._queued_count: dict[str, int] = {p: 0 for p in PRIORITIES}
        # weighted round-robin credits per class (deficit scheme)
        self._credits: dict[str, dict[str, int]] = {
            p: {} for p in PRIORITIES}
        # per-(priority, tenant) cumulative stats for citus_stat_wlm()
        self._tenant_stats: dict[tuple[str, str], dict] = {}
        # requests == admitted + shed + timedout + canceled at every
        # quiescent point
        self.requests_total = 0
        self.admitted_total = 0
        self.queued_total = 0
        self.shed_total = 0
        self.timedout_total = 0
        self.canceled_total = 0
        self.queue_wait_ms_total = 0.0
        # last-seen gate limits (display only — limits ride each request)
        self._last_max_slots = 0
        self._last_max_feed = 0
        # warm-before-admit hold: while > 0 holds are active AND the
        # deadline has not passed, non-exempt admissions wait.  The
        # deadline is the graceful-degradation valve: an overrun never
        # blocks admission for good (it expires even if the holder dies)
        self._warm_holds = 0
        self._warm_deadline = 0.0
        # measured device-byte pressure: workload_manager_for attaches
        # the data_dir's DeviceMemoryAccountant.pressure_bytes, so the
        # gate admits against max(planned, measured)
        self._measured_cb = None

    def attach_measured(self, cb) -> None:
        self._measured_cb = cb

    # -- warm-before-admit -------------------------------------------------
    def hold_admissions(self, deadline: float) -> None:
        """Gate non-exempt admissions behind a warmup until
        release_admissions() or the monotonic `deadline`, whichever
        comes first (warmup_budget_ms caps the hold)."""
        with self._cv:
            self._warm_holds += 1
            self._warm_deadline = max(self._warm_deadline, deadline)

    def release_admissions(self) -> None:
        with self._cv:
            self._warm_holds = max(0, self._warm_holds - 1)
            if not self._warm_holds:
                # the deadline resets with the last hold: a later hold
                # must not inherit a stale larger one through max()
                self._warm_deadline = 0.0
                self._cv.notify_all()

    def warming(self) -> bool:
        with self._cv:
            return bool(self._warm_holds and
                        time.monotonic() < self._warm_deadline)

    def _wait_warm(self) -> None:
        """Block while a warmup hold is active (deadline- and
        cancel-aware: check_cancel runs every slice, and the hold
        expires at its deadline)."""
        from ..utils.cancellation import check_cancel

        while True:
            with self._cv:
                if not self._warm_holds or \
                        time.monotonic() >= self._warm_deadline:
                    return
                self._cv.wait(0.02)
            check_cancel()

    # -- admission ---------------------------------------------------------
    def admit(self, req: AdmissionRequest) -> Ticket:
        """Block until admitted; raises AdmissionRejected (shed),
        StatementTimeout or QueryCanceled (through the caller thread's
        deadline).  Always resolves: admitted XOR raised."""
        from ..utils.cancellation import check_cancel
        from ..utils.faultinjection import fault_point

        # the named seam, BEFORE any manager state changes: an injected
        # fault leaks neither a slot nor a queue entry
        fault_point("wlm.admit")
        # warm-before-admit: a fresh session arms its persisted plans
        # before non-exempt traffic lands on cold caches (exempt
        # statements never reach admit(), so point reads flow)
        self._wait_warm()
        with self._cv:
            self.requests_total += 1
            self._last_max_slots = req.max_slots
            self._last_max_feed = req.max_feed_bytes
            st = self._stat(req.priority, req.tenant, req.weight)
            if not self._queue_blocks(req.priority) and self._fits(req):
                return self._grant(req, st)
            if self._queued_count[req.priority] >= max(0, req.queue_depth):
                self.shed_total += 1
                st["shed"] += 1
                raise AdmissionRejected(
                    f"admission queue for class {req.priority!r} is "
                    f"full ({self._queued_count[req.priority]} waiting, "
                    f"wlm_queue_depth = {req.queue_depth}); shedding "
                    f"statement for tenant {req.tenant!r}")
            w = _Waiter(req)
            self._queues[req.priority].setdefault(
                req.tenant, deque()).append(w)
            self._queued_count[req.priority] += 1
            self.queued_total += 1
            st["queued"] += 1
        t0 = time.monotonic()
        try:
            while not w.evt.wait(0.02):
                check_cancel()  # deadline / Session.cancel() seam
        except BaseException as e:
            from ..errors import StatementTimeout

            with self._cv:
                if w.admitted:
                    # granted just as we gave up: hand the slot straight
                    # back (still resolves as timed-out/canceled)
                    self._release_locked(w.ticket)
                    self.admitted_total -= 1
                    st["admitted"] -= 1
                else:
                    self._remove_waiter(w)
                st["queued"] -= 1
                if isinstance(e, StatementTimeout):
                    self.timedout_total += 1
                else:
                    self.canceled_total += 1
                self._dispatch()
            raise
        queued_ms = (time.monotonic() - t0) * 1000.0
        with self._cv:
            st["queued"] -= 1
            w.ticket.queued_ms = queued_ms
            w.ticket.was_queued = True
            self.queue_wait_ms_total += queued_ms
        return w.ticket

    def release(self, ticket: Ticket) -> None:
        with self._cv:
            if ticket._released:
                return
            self._release_locked(ticket)
            self._dispatch()

    # -- internals (all under self._cv) ------------------------------------
    def _stat(self, priority: str, tenant: str,
              weight: int | None = None) -> dict:
        key = (priority, tenant)
        st = self._tenant_stats.get(key)
        if st is None:
            st = self._tenant_stats[key] = {
                "queued": 0, "running": 0, "admitted": 0, "shed": 0,
                "weight": 1}
        if weight is not None:
            st["weight"] = weight  # last configured weight seen
        return st

    def _fits(self, req: AdmissionRequest) -> bool:
        if self._running >= max(1, req.max_slots):
            return False
        if req.max_feed_bytes <= 0 or self._running == 0:
            # gate off, or nothing running: a statement bigger than the
            # whole budget runs alone
            return True
        pressure = self._feed_inflight
        if self._measured_cb is not None:
            # cache-resident bytes are excluded at the source
            # (accountant.pressure_bytes): the OOM ladder's evict rung
            # reclaims them on demand
            pressure = max(pressure, int(self._measured_cb()))
        return pressure + req.feed_bytes <= req.max_feed_bytes

    def _queue_blocks(self, priority: str) -> bool:
        """No barging: a new arrival queues behind waiters of its own
        or any higher class."""
        idx = PRIORITIES.index(priority)
        return any(self._queued_count[p] > 0
                   for p in PRIORITIES[:idx + 1])

    def _grant(self, req: AdmissionRequest, st: dict) -> Ticket:
        self._running += 1
        self._feed_inflight += req.feed_bytes
        self.admitted_total += 1
        st["admitted"] += 1
        st["running"] += 1
        return Ticket(req.tenant, req.priority, req.feed_bytes,
                      slots_in_use=self._running,
                      slots_total=req.max_slots)

    def _release_locked(self, ticket: Ticket) -> None:
        ticket._released = True
        self._running -= 1
        self._feed_inflight -= ticket.feed_bytes
        self._stat(ticket.priority, ticket.tenant)["running"] -= 1

    def _remove_waiter(self, w: _Waiter) -> None:
        q = self._queues[w.req.priority].get(w.req.tenant)
        if q is not None:
            try:
                q.remove(w)
                self._queued_count[w.req.priority] -= 1
            except ValueError:
                pass  # already dispatched/removed

    def _dispatch(self) -> None:
        """Admit queued waiters while the gates allow, honoring class
        priority and per-tenant weighted round-robin within a class.
        FIFO per tenant; a head waiter the memory gate rejects blocks
        its class."""
        while True:
            picked = self._pick_next()
            if picked is None:
                return
            cls, tenant, w = picked
            if not self._fits(w.req):
                return
            # spend the tenant's credit only on an actual dispatch
            self._credits[cls][tenant] = \
                self._credits[cls].get(tenant, 1) - 1
            self._queues[cls][tenant].popleft()
            self._queued_count[cls] -= 1
            w.ticket = self._grant(w.req, self._stat(cls, tenant))
            w.admitted = True
            w.evt.set()

    def _pick_next(self) -> tuple[str, str, _Waiter] | None:
        for cls in PRIORITIES:
            tenants = {t: q for t, q in self._queues[cls].items() if q}
            if not tenants:
                continue
            order = sorted(tenants)
            credits = self._credits[cls]
            pick = next((t for t in order if credits.get(t, 0) > 0), None)
            if pick is None:
                # a full round elapsed: replenish every active tenant
                # with its current weight, forget drained tenants
                for t in order:
                    credits[t] = max(1, tenants[t][0].req.weight)
                for t in list(credits):
                    if t not in tenants:
                        del credits[t]
                pick = order[0]
            return cls, pick, tenants[pick][0]
        return None

    # -- observability -----------------------------------------------------
    def snapshot(self) -> dict:
        """citus_stat_wlm() source: gate occupancy, resolution totals,
        and one row per (priority class, tenant) ever seen."""
        with self._cv:
            rows = [
                {"priority": p, "tenant": t,
                 "queued": st["queued"], "running": st["running"],
                 "admitted_total": st["admitted"],
                 "shed_total": st["shed"],
                 "weight": st["weight"]}
                for (p, t), st in sorted(
                    self._tenant_stats.items(),
                    key=lambda kv: (PRIORITIES.index(kv[0][0]),
                                    kv[0][1]))]
            return {
                "slots_in_use": self._running,
                "slots_total": self._last_max_slots,
                "warming": bool(self._warm_holds and
                                time.monotonic() < self._warm_deadline),
                "feed_bytes_admitted": self._feed_inflight,
                "feed_bytes_limit": self._last_max_feed,
                "requests_total": self.requests_total,
                "admitted_total": self.admitted_total,
                "queued_total": self.queued_total,
                "shed_total": self.shed_total,
                "timedout_total": self.timedout_total,
                "canceled_total": self.canceled_total,
                "queue_wait_ms_total": round(self.queue_wait_ms_total, 3),
                "tenants": rows,
            }


# process-wide registry: sessions sharing a data_dir share the governor
_registry: dict[str, WorkloadManager] = {}
_registry_mu = threading.Lock()


def workload_manager_for(data_dir: str) -> WorkloadManager:
    key = os.path.realpath(data_dir)
    with _registry_mu:
        if key not in _registry:
            from ..executor.hbm import accountant_for

            mgr = WorkloadManager()
            # the gate and the accountant govern the same card
            mgr.attach_measured(accountant_for(key).pressure_bytes)
            _registry[key] = mgr
        return _registry[key]
