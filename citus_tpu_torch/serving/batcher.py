"""Cross-session micro-batcher for point-index lookups (counterpart of
citus_tpu/serving/batcher.py).

The inference-serving move (PystachIO, PAPERS.md): concurrent small
requests coalesce into one batched probe so the fixed per-request cost
(index load, stripe open, chunk read + decompress, delete-mask apply)
amortizes across the batch.  ONE batcher per data_dir (the
lock_manager_for / workload_manager_for pattern — sessions sharing a
data directory share the storage those lookups hit).

Leader/follower protocol, no background thread:

* a lookup enqueues and, when no leader is active, BECOMES the leader;
* a leader whose request is alone dispatches immediately
  (**single-flight** — an idle system pays zero added latency);
* a leader that finds company waits ``serving_batch_window_ms`` once
  to accumulate arrivals, then drains up to ``serving_max_batch``
  requests per round until the queue is empty — requests that arrive
  while a batch executes form the next batch (adaptive batching);
* followers wait on their request's event in cancellation-aware slices
  (statement_timeout_ms / Session.cancel() abort a queued lookup the
  same way they abort a WLM queue wait — the abandoned queue slot is
  removed and counted as cleanly errored); a follower that finds
  leadership free with its request still queued SELF-PROMOTES, so a
  leader dying (or cancelled — the leader honors its own deadline
  between rounds, after its own request resolved) never strands the
  queue on dead air.

Each batch groups requests by (table, shard, column), resolves every
key against the shared point index (storage/pkindex.py), and reads the
UNION of hits in one stripe/chunk pass (`pkindex.read_rows_multi`),
demuxed back per request.  A request the index cannot serve (an overlay
materialized after eligibility) resolves as a fallback — the caller
runs the ordinary scan path.

Ledger invariant (chaos-soak enforced): every enqueued lookup resolves
as answered XOR cleanly errored XOR fallback — never lost in a dead
batch.  A leader dying mid-batch (even on BaseException) delivers a
clean error to every unresolved request in the batch before
propagating, and requests it never dispatched go back to the queue for
the next (self-promoted) leader.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from ..errors import QueryCanceled, StorageError
from ..stats.tracing import trace_span
from ..storage import pkindex
from ..utils.cancellation import check_cancel
from ..utils.faultinjection import fault_point


class LookupResult:
    """One resolved lookup: the rows (or fallback), plus the dispatch
    metadata the requester folds into its own session counters."""

    __slots__ = ("vals", "mask", "n", "fallback", "batch_size",
                 "dispatches_led")

    def __init__(self):
        self.vals = None
        self.mask = None
        self.n = 0
        self.fallback = False
        self.batch_size = 0
        self.dispatches_led = 0


class _Lookup:
    __slots__ = ("store", "table", "shard_id", "column", "value",
                 "columns", "evt", "result", "error")

    def __init__(self, store, table, shard_id, column, value, columns):
        self.store = store
        self.table = table
        self.shard_id = shard_id
        self.column = column
        self.value = value
        self.columns = tuple(columns)
        self.evt = threading.Event()
        self.result: LookupResult | None = None
        self.error: BaseException | None = None


def _clone_error(e: BaseException) -> BaseException:
    """A per-waiter copy of the batch failure (sharing one exception
    object across raising threads would share tracebacks); classifier
    markers (injected_fault / fault_point / shard_id / post_visibility)
    ride along so each session's retry loop classifies it exactly like
    a solo failure."""
    if not isinstance(e, Exception):
        # a BaseException (crash-sim power cut, interpreter teardown)
        # killed the leader: followers get a clean retryable error —
        # the non-Exception kind must only unwind its own session
        return StorageError(
            f"batch leader died mid-dispatch ({type(e).__name__})")
    try:
        clone = type(e)(*e.args)
    except Exception:
        clone = StorageError(f"batched lookup failed: {e}")
    for attr in ("injected_fault", "fault_point", "post_visibility",
                 "shard_id", "table"):
        if hasattr(e, attr):
            try:
                setattr(clone, attr, getattr(e, attr))
            except Exception:  # noqa: BLE001 — best-effort marker copy
                continue
    return clone


class MicroBatcher:
    """Per-data_dir cross-session point-lookup coalescer."""

    def __init__(self):
        self._mu = threading.Lock()
        self._queue: deque[_Lookup] = deque()
        self._leader_active = False
        # shared-layer totals (citus_stat_serving); per-session counters
        # fold requester-side from LookupResult
        self.requests_total = 0
        self.answered_total = 0
        self.errored_total = 0
        self.fallback_total = 0
        self.dispatch_total = 0
        self.batched_lookups_total = 0
        self.max_batch_seen = 0

    # -- public ------------------------------------------------------------
    def lookup(self, store, table: str, shard_id: int, column: str,
               value: int, columns, max_batch: int,
               window_s: float) -> LookupResult:
        """Resolve one point lookup through the shared batch queue.
        Returns a LookupResult (fallback=True when the index cannot
        answer); raises the batch failure as a clean error."""
        req = _Lookup(store, table, shard_id, column, value, columns)
        with self._mu:
            self.requests_total += 1
            self._queue.append(req)
            lead = not self._leader_active
            if lead:
                self._leader_active = True
        led = 0
        if lead:
            led = self._lead(max(1, max_batch), max(0.0, window_s))
        else:
            with trace_span("serving.batch_wait"):
                while not req.evt.wait(0.005):
                    try:
                        check_cancel()  # deadline / cancel() seam
                    except BaseException:
                        # leaving the wait: resolve our queue slot so
                        # the ledger never holds an abandoned request
                        with self._mu:
                            if not req.evt.is_set():
                                try:
                                    self._queue.remove(req)
                                except ValueError:
                                    pass  # already in a running batch
                                else:
                                    self.errored_total += 1
                                    req.evt.set()
                        raise
                    promote = False
                    with self._mu:
                        if not self._leader_active and \
                                not req.evt.is_set():
                            # the leader died or was cancelled with
                            # work still queued: self-promote so no
                            # lookup ever waits on dead air
                            self._leader_active = True
                            promote = True
                    if promote:
                        led += self._lead(max(1, max_batch),
                                          max(0.0, window_s))
        if req.error is not None:
            raise req.error
        req.result.dispatches_led = led
        return req.result

    # -- leader ------------------------------------------------------------
    def _lead(self, max_batch: int, window_s: float) -> int:
        """Drain the queue in batches until empty; returns the number of
        batches this leader dispatched.  Leadership is released
        atomically with the final emptiness check, so a request that
        enqueues while we lead is always served — by us or by itself."""
        first = True
        dispatched = 0
        batch: list[_Lookup] = []
        try:
            while True:
                if not first:
                    # the leader's own request resolved in an earlier
                    # round; later rounds serve OTHER sessions — honor
                    # this statement's deadline / Session.cancel()
                    # between rounds (the stranded queue is handed to a
                    # self-promoting follower, see lookup())
                    check_cancel()
                with self._mu:
                    if not self._queue:
                        self._leader_active = False
                        return dispatched
                    if not first or len(self._queue) > 1:
                        # company: drain a batch now (the first round
                        # waited its window below; later rounds batch
                        # whatever accumulated during execution)
                        batch = [self._queue.popleft()
                                 for _ in range(min(max_batch,
                                                    len(self._queue)))]
                    else:
                        batch = [self._queue.popleft()]  # single-flight
                if first and len(batch) > 1 and window_s > 0:
                    # arrivals already queued: hold the window once so
                    # the coalescing batch catches the burst's tail
                    with trace_span("serving.door_hold"):
                        time.sleep(window_s)
                    with self._mu:
                        while self._queue and len(batch) < max_batch:
                            batch.append(self._queue.popleft())
                first = False
                dispatched += 1
                self._execute_batch(batch)
                batch = []
        except BaseException:
            with self._mu:
                if batch:
                    # popped but never executed (cancel / power cut in
                    # the window sleep): hand the requests back — a
                    # waiting follower self-promotes and serves them
                    self._queue.extendleft(
                        r for r in reversed(batch)
                        if not r.evt.is_set())
                self._leader_active = False
            raise

    def _execute_batch(self, batch: list[_Lookup]) -> None:
        """Run one coalesced probe.  Resolves EVERY request in the batch
        (answered / errored / fallback) before returning; only
        BaseException (crash-sim power cuts, interpreter teardown)
        propagates — after delivering clean errors to the batch."""
        with self._mu:
            self.dispatch_total += 1
            self.batched_lookups_total += len(batch)
            self.max_batch_seen = max(self.max_batch_seen, len(batch))
        # the probe span lives on the LEADER's statement trace: the
        # flight recorder attributes coalesced work to the thread that
        # actually did it (followers record serving.batch_wait)
        with trace_span("serving.batch_probe", batched=len(batch)):
            self._execute_batch_inner(batch)

    def _execute_batch_inner(self, batch: list[_Lookup]) -> None:
        try:
            # named seam: a fault at dispatch must error the WHOLE batch
            # cleanly — the ledger proves no request is ever lost here
            fault_point("serving.batch_dispatch")
            groups: dict[tuple, list[_Lookup]] = {}
            for r in batch:
                groups.setdefault((r.table, r.shard_id, r.column),
                                  []).append(r)
            for (table, sid, col), group in groups.items():
                try:
                    self._probe_group(table, sid, col, group)
                except QueryCanceled:
                    raise  # the LEADER's deadline, not the group's
                except Exception as e:
                    self._deliver_error(group, e)
        except QueryCanceled:
            # the leader's own cancel/timeout fired on its thread (the
            # fault_point/check_cancel seams run there): innocent
            # coalesced lookups must not inherit a timeout they never
            # set — requeue them for the next (self-promoted) leader
            with self._mu:
                pending = [r for r in batch if not r.evt.is_set()]
                self._queue.extendleft(reversed(pending))
            # the resolution belt below must skip the requeued requests
            batch[:] = [r for r in batch if r.evt.is_set()]
            raise
        except Exception as e:  # noqa: BLE001 — re-raised per waiter; the leader drains on
            self._deliver_error(batch, e)
        except BaseException as e:
            self._deliver_error(batch, e)
            raise
        finally:
            for r in batch:  # belt: nothing leaves the batch unresolved
                if not r.evt.is_set():
                    self._deliver_error(
                        [r], StorageError(
                            "batched lookup left unresolved (batcher "
                            "bug — please report)"))

    def _deliver_error(self, reqs: list[_Lookup], e: BaseException) -> None:
        n = 0
        for r in reqs:
            if r.evt.is_set():
                continue
            r.error = _clone_error(e)
            r.evt.set()
            n += 1
        if n:
            with self._mu:
                self.errored_total += n

    def _probe_group(self, table: str, shard_id: int, column: str,
                     group: list[_Lookup]) -> None:
        """One (table, shard, column) group: resolve every key against
        the shared index, read the union of hits in ONE stripe/chunk
        pass, demux per request.  The probe store's cached manifest is
        refreshed first: a follower may have loaded a NEWER committed
        manifest at its statement start than this store has cached, and
        probing through the older view would un-see a row that
        follower's session already observed committed (read-committed /
        monotonic-read violation the solo path cannot produce).  One
        stat() per dispatch group; refreshes are monotone, so after it
        this store is at least as new as every requester's view."""
        store = group[0].store
        store.refresh_if_stale(table)
        batch_size = len(group)
        hit_lists = []
        live: list[_Lookup] = []
        for r in group:
            hits = pkindex.lookup(store, table, shard_id, column, r.value)
            if hits is None:
                # an overlay materialized between eligibility and
                # dispatch: this request re-runs its own scan path
                res = LookupResult()
                res.fallback = True
                res.batch_size = batch_size
                r.result = res
                r.evt.set()
                with self._mu:
                    self.fallback_total += 1
                continue
            hit_lists.append(hits)
            live.append(r)
        if not live:
            return
        union_cols: list[str] = []
        for r in live:
            for c in r.columns:
                if c not in union_cols:
                    union_cols.append(c)
        per_req = pkindex.read_rows_multi(store, table, shard_id,
                                          union_cols, hit_lists)
        answered = 0
        for r, (vals, mask, n) in zip(live, per_req):
            res = LookupResult()
            res.vals = {c: vals[c] for c in r.columns}
            res.mask = {c: mask[c] for c in r.columns}
            res.n = n
            res.batch_size = batch_size
            r.result = res
            r.evt.set()
            answered += 1
        with self._mu:
            self.answered_total += answered

    # -- observability -----------------------------------------------------
    def reset_totals(self) -> None:
        """Zero the shared-layer totals — for A/B harnesses (bench.py
        serving) that run sequential modes over one data_dir and must
        report per-mode numbers: `max_batch_seen` is a monotone max, so
        snapshot deltas cannot isolate a mode the way they do for the
        monotone sums."""
        with self._mu:
            self.requests_total = 0
            self.answered_total = 0
            self.errored_total = 0
            self.fallback_total = 0
            self.dispatch_total = 0
            self.batched_lookups_total = 0
            self.max_batch_seen = 0

    def snapshot(self) -> dict:
        """citus_stat_serving() source (shared-layer totals)."""
        with self._mu:
            occ = (self.batched_lookups_total / self.dispatch_total
                   if self.dispatch_total else 0.0)
            return {
                "queue_depth": len(self._queue),
                "leader_active": self._leader_active,
                "requests_total": self.requests_total,
                "answered_total": self.answered_total,
                "errored_total": self.errored_total,
                "fallback_total": self.fallback_total,
                "batch_dispatch_total": self.dispatch_total,
                "batched_lookups_total": self.batched_lookups_total,
                "max_batch_seen": self.max_batch_seen,
                "avg_batch_occupancy": round(occ, 3),
            }


# process-wide registry: sessions sharing a data_dir share the batcher
# (the lock_manager_for / workload_manager_for pattern)
_registry: dict[str, MicroBatcher] = {}
_registry_mu = threading.Lock()


def batcher_for(data_dir: str) -> MicroBatcher:
    key = os.path.realpath(data_dir)
    with _registry_mu:
        if key not in _registry:
            _registry[key] = MicroBatcher()
        return _registry[key]
