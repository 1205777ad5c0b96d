"""Maintenance daemon: periodic 2PC recovery, deferred cleanup, node
health sweeps, storage scrubs, log shipping and deadlock checks.

Counterpart of citus_tpu/background/daemon.py.  The reference runs one
bgworker per database (Citus src/backend/distributed/utils/
maintenanced.c CitusMaintenanceDaemonMain) that periodically recovers
prepared transactions (citus.recover_2pc_interval), cleans deferred
resources (shard_cleaner.c) and checks for distributed deadlocks.

Single-controller mapping: one daemon thread per Session, started at
open and stopped and joined by Session.close(); tick-driven, each duty
on its own interval read live from the session settings (-1 or 0
disables, as each setting says).  Defaults are the JAX package's:
recovery every 60 s, cleanup every 15 s, health sweep, scrub and
shipping off; the deadlock check runs every second.
"""

from __future__ import annotations

import threading
import time
import weakref

from ..operations.cleanup import cleanup_registry_for
from ..operations.health import health_sweep
from ..operations.scrubber import scrub_session
from ..replication import ship_all

TICK_SECONDS = 0.05
DEADLOCK_CHECK_SECONDS = 1.0
# duty → (its interval setting in ms, the value at or below which the
# duty is off); the deadlock check runs every DEADLOCK_CHECK_SECONDS
_DUTIES = {"recover": ("recover_2pc_interval_ms", -1),
           "cleanup": ("defer_shard_delete_interval_ms", -1),
           "health": ("health_check_interval_ms", -1),
           "scrub": ("scrub_interval_ms", -1),
           "ship": ("replication_ship_interval_ms", 0)}


class MaintenanceDaemon:
    """The session is held weakly: a session dropped without close()
    is still collected, and its daemon thread then ends."""

    def __init__(self, session):
        self._session = weakref.ref(session)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last = {}
        # how many times each duty ran
        self.recover_runs = 0
        self.cleanup_runs = 0
        self.deadlock_checks = 0
        self.health_sweeps = 0
        self.nodes_disabled = 0
        self.scrub_runs = 0
        self.scrub_repairs = 0
        self.ship_runs = 0

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        # each duty waits one full interval after start (the session's
        # open already ran recovery and the sweep synchronously)
        now = time.monotonic()
        self._last = dict.fromkeys((*_DUTIES, "deadlock"), now)
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="citus-maintenanced")
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        """Signal the loop and join it (a running duty finishes)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    # -- duties ------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            session = self._session()
            if session is None:
                return
            wait = self._sleep_s(session)
            del session  # no strong reference while asleep
            if self._stop.wait(wait):
                return
            session = self._session()
            if session is None:
                return
            now = time.monotonic()
            try:
                self._maybe_recover(session, now)
                self._maybe_cleanup(session, now)
                self._maybe_deadlock_check(session, now)
                self._maybe_health_sweep(session, now)
                self._maybe_scrub(session, now)
                self._maybe_ship(session, now)
            except Exception:  # noqa: BLE001 — the daemon survives transient errors and retries on its next tick, as the reference's does
                pass
            del session

    def _interval_s(self, session, duty: str) -> float | None:
        """The duty's interval in seconds, read live from the settings;
        None when the duty is off."""
        if duty == "deadlock":
            return DEADLOCK_CHECK_SECONDS
        setting, off_at = _DUTIES[duty]
        ms = session.settings.get(setting)
        return None if ms <= off_at else ms / 1000.0

    def _sleep_s(self, session) -> float:
        """Seconds until the next duty falls due, kept within
        [TICK_SECONDS, DEADLOCK_CHECK_SECONDS] (a SET takes effect within
        a second; an idle session's daemon wakes once a second)."""
        now = time.monotonic()
        waits = [self._last[d] + iv - now for d in self._last
                 if (iv := self._interval_s(session, d)) is not None]
        return min(max(min(waits), TICK_SECONDS), DEADLOCK_CHECK_SECONDS)

    def _due(self, session, duty: str, now: float) -> bool:
        iv = self._interval_s(session, duty)
        if iv is None or now - self._last[duty] < iv:
            return False
        self._last[duty] = now
        return True

    def _maybe_recover(self, session, now: float) -> None:
        if self._due(session, "recover", now):
            session.txn_manager.recover()
            self.recover_runs += 1

    def _maybe_cleanup(self, session, now: float) -> None:
        if self._due(session, "cleanup", now):
            cleanup_registry_for(session.data_dir).sweep(session.store,
                                                         session.catalog)
            self.cleanup_runs += 1

    def _maybe_deadlock_check(self, session, now: float) -> None:
        if self._due(session, "deadlock", now):
            session.locks.check_deadlocks()
            self.deadlock_checks += 1

    def _maybe_health_sweep(self, session, now: float) -> None:
        """Node-death detection: probe every node; failures are
        disabled so reads fail over to replicas.  Promotion stays
        operator-issued (citus_promote_node)."""
        if self._due(session, "health", now):
            self.nodes_disabled += len(health_sweep(session))
            self.health_sweeps += 1

    def _maybe_scrub(self, session, now: float) -> None:
        """Verify every placement copy, quarantine and re-replicate
        corrupt ones (operations/scrubber.py)."""
        if self._due(session, "scrub", now):
            rep = scrub_session(session, background=False)
            self.scrub_runs += 1
            self.scrub_repairs += rep.repaired

    def _maybe_ship(self, session, now: float) -> None:
        """Log shipping to every registered follower (0 = off: explicit
        citus_replication_ship() only)."""
        if self._due(session, "ship", now) and \
                session.replication.is_leader_with_followers():
            ship_all(session.data_dir, counters=session.stats.counters)
            self.ship_runs += 1
