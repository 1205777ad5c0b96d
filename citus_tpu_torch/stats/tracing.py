"""Always-on span flight recorder: per-statement span trees with
cross-thread context propagation, per-statement-class DDSketch latency
histograms, a bounded in-memory ring of recent traces, a slow-query log
persisted through the durable-write seam, and CUDA-event device legs.

Counterpart of citus_tpu/stats/tracing.py.  Span names, phase names,
the trace dict and the slow-trace file format are the JAX package's, so
a trace of either package renders through either package's
`trace_export` and `tools/trace_summarize.py`.

* **Spans** — every statement produces a tree of named spans: parse →
  execution attempts → plan → feed build (the pipelined scan's
  prefetch / wire-encode / transfer / device-decode legs, carried
  across the producer thread; the stream's decode / transfer legs and
  its batches) → mesh.dispatch / mesh.fetch → host combine → retry
  backoff and OOM-ladder rungs.  Names live in ``SPAN_NAMES``.
* **Context propagation** — the active trace rides a thread-local;
  the scanpipe prefetch producer and the stream batch producer adopt
  the statement's context via :func:`capture_context` /
  :func:`adopt_context`, which force-closes anything the thread leaves
  open (:func:`open_span_count` is 0 between statements).
* **Histograms** — statement wall times fold into per-statement-class
  DDSketch bucket counts (ops/sketches.py), so ``citus_stat_latency()``
  reports p50/p95/p99 without storing raw samples.
* **Ring + slow log** — the last `trace_ring_statements` traces stay
  in memory (spans per trace capped at ``MAX_SPANS_PER_TRACE``);
  statements slower than `trace_slow_statement_ms` persist their tree
  as JSON under ``<data_dir>/slow_traces/`` (newest
  ``SLOW_TRACE_KEEP`` kept).  ``python -m
  citus_tpu_torch.stats.trace_export`` renders one as Chrome-trace JSON.
* **Device legs** (no JAX counterpart) — on the TPU one compiled
  program is the device phase; here `PlanCompiler` enqueues many eager
  launches, so the host span around them measures enqueue plus waits.
  :func:`device_timeline` records one CUDA event pair on the current
  stream around a span's launches and stores the pair's elapsed time
  as the span's ``device_ms`` meta.  That is the device *timeline*
  between the two points, so any host stall between them counts (the
  enqueue of an eager dispatch, a thread waiting for the interpreter
  lock): under the graph's lock a replay's leg is the program's device
  time plus such stalls.  ``mesh.fetch`` carries a leg too, around its
  blocking copies back: it starts at the dispatch leg's end event, so
  it times the copies and the host's return from them.  Pairs
  are read (:func:`resolve_device_legs`) only once the statement's own
  blocking fetch has returned, and only when `Event.query()` says both
  completed (a leg not complete then is read at the statement's end):
  the recorder adds no synchronize of its own.  A pair whose block
  raised is dropped unread.  Events are pooled on the recorder.  A CPU
  session records no pairs and no ``device_ms``.  (On the card's host
  an event's record costs about 4 µs and building the current stream's
  object 9 µs, so the pool keeps one object per stream.)
* **The port's own names** (no JAX counterpart) — ``mesh.wait``, the
  wait of a statement for the executor's locks (:func:`waited`: the
  compiler's run lock, a shared CUDA graph's lock), opened only when
  the lock is taken, under its own phase ``wait``; ``phase_breakdown``
  reports that phase only when it is non-zero, so a trace without it
  breaks down as the JAX package's does.  ``combine.unpack``,
  ``combine.project`` and ``combine.order`` split the host combine
  and map to no phase (``combine`` already counts the whole).
  ``mesh.fetch`` carries ``bytes``, the packed outputs and counters
  copied back.

Overhead: an unarmed `trace_span` is one thread-local read and a None
check; an active span is two `perf_counter` calls plus one small
object; a device leg is two `Event.record` calls and one
`elapsed_time` read; a lock taken at the first try opens no span.
`trace_sample_every` and the fast-class auto-degrade
(`trace_fast_statement_ms`) reduce tree recording to 1 in N
statements (histograms always update).
"""

from __future__ import annotations

import os
import threading
import time

from ..ops.sketches import dd_bucket_scalar
from .query_stats import fingerprint

# -- span-name registry ------------------------------------------------------
# Every named span the port records: the JAX package's names (mesh.degrade
# is recorded by the session's device-loss failover), then the port's own.
SPAN_NAMES: dict[str, str] = {
    "statement": "root span: one executed statement, wall-clock",
    "parse": "lexer+parser",
    "queue": "WLM admission: classification + slot/memory queue wait",
    "execute": "one execution attempt under the resilience envelope",
    "plan": "recursive planning + bind + distributed planning",
    "feed": "device feed build (eager, pipelined or per-batch)",
    "compile": "plan-cache resolution or CUDA-graph capture (meta "
               "cache=hit|miss|uncapturable, with the reason a run "
               "stays eager)",
    "compile.cache_load": "persisted plan-cache probe: meta + stamp + "
                          "CRC check of the key's entry",
    "compile.single_flight_wait": "follower waiting on another "
                                  "session's in-flight capture of the "
                                  "same key (capture dedup)",
    "wlm.warmup": "warm-before-admit: one persisted entry armed",
    "mesh.dispatch": "the eager device program's launches (device_ms: "
                     "its CUDA-event timeline)",
    "mesh.fetch": "device→host pull of outputs + overflow counters "
                  "(device_ms: the copies' CUDA-event timeline; bytes: "
                  "what they copy)",
    "combine": "host-side combine (having/order/limit/decode)",
    "fastpath": "single-shard host execution (router fast path)",
    "scan.prefetch": "scanpipe: stripe read + host decode (producer)",
    "scan.wire_encode": "scanpipe: host wire-encode for device decode",
    "scan.transfer": "scanpipe: accounted host→device placement",
    "scan.device_decode": "scanpipe: on-device expand of a wire payload",
    "stream.batch": "stream path: one batched execution round",
    "stream.decode": "stream path: stripe pull + decode for a batch",
    "stream.transfer": "stream path: batch host→device placement",
    "serving.cache_lookup": "result-cache key build + lookup",
    "serving.door_hold": "micro-batch leader holding the door open",
    "serving.batch_wait": "follower waiting on a batch leader",
    "serving.batch_probe": "leader executing one coalesced batch",
    "retry.backoff": "resilience envelope backoff sleep",
    "oom.degrade": "OOM ladder rung application",
    "mesh.degrade": "mesh shrink + failover after device loss",
    "replication.ship": "leader→follower batch staging (file diff + "
                        "journal segment + batch.json commit)",
    "replication.apply": "follower roll-forward of committed batches "
                         "behind the apply cursor",
    "replication.promote": "follower→leader promotion: roll forward, "
                           "fence, epoch bump, role flip",
    # the port's own (no JAX counterpart)
    "mesh.wait": "wait for an executor lock taken by another statement "
                 "(meta lock=run: the compiler's run lock; lock=graph: "
                 "a shared CUDA graph's lock)",
    "combine.unpack": "host combine: unpack the fetched [n_out, cap] "
                      "lanes into columns, nulls and the valid mask",
    "combine.project": "host combine: valid mask, HAVING, projection "
                       "and string/date decode",
    "combine.order": "host combine: ORDER BY, OFFSET/LIMIT and NULLs "
                     "surfaced in the result",
}

# phase attribution for the EXPLAIN ANALYZE Timing line and the
# sum-to-wall contract (the JAX package's whole map, so its traces
# break down the same way here): walking the tree, a span whose name maps here
# contributes its full duration to the phase and is NOT descended into
# (nested detail — scan.* under feed, serving.* under fastpath — stays
# in the trace but never double-counts a phase)
PHASE_OF: dict[str, str] = {
    "parse": "parse",
    "queue": "queue",
    "plan": "plan",
    "feed": "feed",
    "compile": "compile",
    "compile.cache_load": "compile",
    "compile.single_flight_wait": "compile",
    "mesh.dispatch": "device",
    "mesh.fetch": "device",
    "combine": "combine",
    "fastpath": "fastpath",
    "serving.cache_lookup": "serving",
    "serving.door_hold": "serving",
    "serving.batch_wait": "serving",
    "serving.batch_probe": "serving",
    "retry.backoff": "retry",
    "oom.degrade": "degrade",
    "mesh.degrade": "degrade",
    "replication.ship": "replication",
    "replication.apply": "replication",
    "replication.promote": "replication",
    "mesh.wait": "wait",
}

PHASE_ORDER = ("parse", "queue", "plan", "feed", "compile", "device",
               "combine", "fastpath", "serving", "retry", "degrade",
               "replication", "wait")

# spans kept per trace: a runaway statement (thousands of stripes ×
# columns) truncates instead of growing the ring without bound
MAX_SPANS_PER_TRACE = 8192
SLOW_TRACE_KEEP = 32
SLOW_TRACE_DIR = "slow_traces"
# statement text / class stored on traces and histogram keys is
# clamped: a bulk INSERT's normalized text is megabytes of "( ?, ?, ?"
# — the ring, the slow log and citus_stat_latency() need the head,
# not the literal list (prefixes stay stable per class, so clamped
# keys still aggregate correctly)
MAX_SQL_CHARS = 400


def clamp_sql(text: str) -> str:
    """The clamped form under which a statement appears in traces and
    histogram keys (bench scripts compare against it when checking a
    trace belongs to the statement they measured)."""
    if len(text) <= MAX_SQL_CHARS:
        return text
    return text[:MAX_SQL_CHARS] + " …"


_clamp = clamp_sql


def span_name(name: str) -> str:
    """Return the name verbatim; KeyError on an unregistered span (the
    runtime backstop for the static span-registry rule)."""
    SPAN_NAMES[name]
    return name


class Span:
    """One timed region.  `children` is appended from the owning thread
    (and, under `feed`, from an adopting producer thread) — list.append
    is GIL-atomic, and readers only walk finished traces or closed
    children, so no lock rides the hot path.

    The span is its OWN context manager (`trace_span` opens it and
    pushes it; `__exit__` closes and pops): one object per span is the
    budget on a statement of a few milliseconds."""

    __slots__ = ("name", "t0", "t1", "tid", "meta", "children",
                 "_stk", "_tr")

    def __init__(self, name: str, t0: float, tid: int,
                 meta: dict | None = None, stk: list | None = None,
                 tr: "Trace | None" = None):
        self.name = name
        self.t0 = t0
        self.t1 = None
        self.tid = tid
        self.meta = meta
        # eager list: a lazy first-child init would race between the
        # statement thread and an adopted producer both appending
        # under the feed span (list.append itself is GIL-atomic)
        self.children: list[Span] = []
        self._stk = stk
        self._tr = tr

    def duration(self) -> float:
        return (self.t1 if self.t1 is not None
                else time.perf_counter()) - self.t0

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb, _pc=time.perf_counter):
        self.t1 = _pc()
        if exc_type is not None:
            m = self.meta or {}
            m["error"] = exc_type.__name__
            self.meta = m
        stack = self._stk
        # pop back to (and including) this span; anything above it was
        # opened inside the block and never closed — count the leak so
        # tests can flag it, and never corrupt the stack
        while stack and stack[-1] is not self:
            stray = stack.pop()
            if stray.t1 is None:
                stray.t1 = self.t1
            if self._tr is not None:
                self._tr.leaked += 1
        if stack:
            stack.pop()
        return False


class Trace:
    """One statement's span tree plus bookkeeping flags."""

    __slots__ = ("sql", "cls", "root", "spans", "truncated", "leaked",
                 "wall_ms", "error", "legs", "pool")

    def __init__(self, sql: str, root: Span, pool=None):
        self.sql = sql
        self.cls: str | None = None
        self.root = root
        # `spans`/`leaked` are bumped with plain `+=` from the
        # statement thread AND adopted producer threads: a lost
        # increment under that race only softens the (8192-span)
        # truncation backstop by a few spans — to_dict() recounts
        # exactly from the tree, so the published number is never the
        # racy one
        self.spans = 1
        self.truncated = False
        self.leaked = 0
        self.wall_ms: float | None = None
        self.error: str | None = None
        # closed device legs not read yet (device_timeline appends from
        # the statement thread and adopting producers; the statement
        # thread swaps the list out under _legs_mu to read it)
        self.legs: list[_Leg] = []
        self.pool = pool  # the recorder's _EventPool

    def to_dict(self) -> dict:
        base = self.root.t0
        exact = 0

        def span_dict(s: Span) -> dict:
            nonlocal exact
            exact += 1
            t1 = s.t1 if s.t1 is not None else s.t0
            d = {"name": s.name,
                 "t0_ms": round((s.t0 - base) * 1000.0, 4),
                 "dur_ms": round((t1 - s.t0) * 1000.0, 4),
                 "tid": s.tid}
            if s.meta:
                d["meta"] = dict(s.meta)
            kids = sorted(s.children, key=lambda c: c.t0)
            if kids:
                d["children"] = [span_dict(c) for c in kids]
            return d

        root = span_dict(self.root)
        return {"schema": 1, "sql": self.sql, "class": self.cls,
                "wall_ms": self.wall_ms, "spans": exact,
                "truncated": self.truncated, "leaked": self.leaked,
                "error": self.error, "root": root}


# -- thread-local context ----------------------------------------------------
_tls = threading.local()
# tid → open-span stack, registered on a thread's first span so
# open_span_count() can see every thread (the StatCounters slot
# pattern); dead threads' entries are pruned on new registrations
_stacks_lock = threading.Lock()
_stacks: dict[int, list] = {}


def _tls_state():
    st = getattr(_tls, "state", None)
    if st is None:
        st = _tls.state = {"trace": None, "stack": []}
        tid = threading.get_ident()
        with _stacks_lock:
            live = {t.ident for t in threading.enumerate()}
            for dead in [t for t in _stacks if t not in live]:
                del _stacks[dead]
            _stacks[tid] = st["stack"]
    return st


def open_span_count() -> int:
    """Spans currently open across EVERY thread that ever recorded one
    — 0 whenever no statement is in flight (the post-soak no-leak
    assert, like the prefetch-charge ledger)."""
    with _stacks_lock:
        stacks = list(_stacks.values())
    return sum(len(s) for s in stacks)


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP = _NoopSpan()


def trace_span(name: str, _pc=time.perf_counter,
               _ident=threading.get_ident, **meta):
    """Open a named span under the current statement trace; a cheap
    no-op when no trace is active on this thread (tracing off, sampled
    out, or a non-statement thread that never adopted a context).
    The span starts NOW (at the call), is pushed immediately, and the
    `with` block's exit closes it."""
    st = getattr(_tls, "state", None)
    if st is None or st["trace"] is None or not st["stack"]:
        return _NOOP
    tr = st["trace"]
    if tr.spans >= MAX_SPANS_PER_TRACE:
        tr.truncated = True
        return _NOOP
    SPAN_NAMES[name]  # runtime backstop of the span-registry rule
    stack = st["stack"]
    sp = Span(name, _pc(), _ident(), meta or None, stack, tr)
    tr.spans += 1
    stack[-1].children.append(sp)
    stack.append(sp)
    return sp


def capture_context():
    """Token for handing the current statement's trace to a worker
    thread (None when nothing is being traced — adopt_context then
    no-ops)."""
    st = getattr(_tls, "state", None)
    if st is None or st["trace"] is None or not st["stack"]:
        return None
    return (st["trace"], st["stack"][-1])


class _AdoptCtx:
    __slots__ = ("token", "prev")

    def __init__(self, token):
        self.token = token
        self.prev = None

    def __enter__(self):
        if self.token is None:
            return None
        trace, parent = self.token
        st = _tls_state()
        self.prev = (st["trace"], list(st["stack"]))
        st["trace"] = trace
        st["stack"][:] = [parent]
        return trace

    def __exit__(self, exc_type, exc, tb):
        if self.token is None:
            return False
        st = _tls_state()
        trace = self.token[0]
        # the adopting thread must close everything it opened: spans
        # still above the borrowed parent are leaks — close them with
        # an honest end time and count them
        now = time.perf_counter()
        while len(st["stack"]) > 1:
            sp = st["stack"].pop()
            if sp.t1 is None:
                sp.t1 = now
            trace.leaked += 1
        prev_trace, prev_stack = self.prev
        st["trace"] = prev_trace
        st["stack"][:] = prev_stack
        return False


def adopt_context(token):
    """Adopt a captured statement context on a worker thread for the
    duration of the block: spans recorded inside nest under the span
    that was open at capture time.  Leak-proof by construction — on
    exit anything the thread left open is force-closed and counted."""
    return _AdoptCtx(token)


class _Waited:
    __slots__ = ("lock", "kind")

    def __init__(self, lock, kind):
        self.lock = lock
        self.kind = kind

    def __enter__(self):
        if not self.lock.acquire(blocking=False):  # graftlint: ignore[raw-lock-acquire] — released by __exit__
            with trace_span("mesh.wait", lock=self.kind):
                self.lock.acquire()  # graftlint: ignore[raw-lock-acquire] — released by __exit__
        return self.lock

    def __exit__(self, exc_type, exc, tb):
        self.lock.release()
        return False


def waited(lock, kind: str):
    """Hold `lock` for the block.  The first try does not block; only
    when another thread holds it does the block wait, inside a
    ``mesh.wait`` span with meta ``lock=kind``.  So a lock taken at
    once records nothing, and untraced a contended one costs one failed
    try."""
    return _Waited(lock, kind)


# -- device legs: CUDA event pairs around a span's launches ------------------
class _EventPool:
    """Timing events reused across statements (creating a pair costs
    host microseconds on a statement of a few milliseconds), and the
    stream objects they are recorded on.  One per TraceRecorder; the
    port runs one device per process."""

    MAX_FREE = 256

    def __init__(self):
        self._mu = threading.Lock()
        self._free: list = []
        # raw CUDA stream handle → its torch Stream: building the current
        # stream's object costs twice an event's record (PyTorch's streams
        # come from fixed pools, so the map stays small)
        self._streams: dict = {}

    def stream(self, device):
        """The current stream of `device` (a cuda torch.device)."""
        import torch

        idx = (device.index if device.index is not None
               else torch.cuda.current_device())
        raw = torch._C._cuda_getCurrentRawStream(idx)
        s = self._streams.get(raw)
        if s is None:
            s = self._streams[raw] = torch.cuda.current_stream(idx)
        return s

    def take(self):
        with self._mu:
            if self._free:
                return self._free.pop()
        import torch

        return torch.cuda.Event(enable_timing=True)

    def give(self, *events) -> None:
        with self._mu:
            if len(self._free) < self.MAX_FREE:
                self._free.extend(events)


class _Leg:
    __slots__ = ("span", "start", "end", "stream", "lends_end")

    def __init__(self, span, start, end, stream):
        self.span = span
        self.start = start
        self.end = end
        self.stream = stream
        # a leg chained after this one starts at this one's end event,
        # and gives it back to the pool itself
        self.lends_end = False


_legs_mu = threading.Lock()


class _DeviceTimeline:
    __slots__ = ("span", "device", "after", "leg")

    def __init__(self, span, device, after):
        self.span = span
        self.device = device
        self.after = after
        self.leg = None

    def __enter__(self):
        pool = self.span._tr.pool
        after = self.after
        if after is not None:
            # nothing was enqueued since the earlier leg's end: start there
            after.lends_end = True
            self.leg = _Leg(self.span, after.end, pool.take(), after.stream)
        else:
            stream = pool.stream(self.device)
            self.leg = _Leg(self.span, pool.take(), pool.take(), stream)
            self.leg.start.record(stream)
        return self.leg

    def __exit__(self, exc_type, exc, tb):
        leg = self.leg
        self.leg = None
        if exc_type is not None:
            # an OOM, a cancel or an injected fault inside the block:
            # the end event was never recorded — drop the pair unread
            return False
        leg.end.record(leg.stream)
        tr = self.span._tr
        with _legs_mu:
            tr.legs.append(leg)
        return False


def device_timeline(span, device, after=None):
    """CUDA event pair on the current stream around the block: the
    start before its first launch, the end after its last.  `span` is
    the open Span the pair belongs to (what `trace_span` returned; a
    no-op span or a CPU `device` records nothing).  `after`, the leg an
    earlier block on the same stream returned, with nothing enqueued
    since it closed, makes its end event this pair's start.  The pair
    is read by :func:`resolve_device_legs` into the span's
    ``device_ms``."""
    if not isinstance(span, Span) or span._tr is None or \
            span._tr.pool is None or getattr(device, "type", None) != "cuda":
        return _NOOP
    return _DeviceTimeline(span, device, after)


def resolve_device_legs(final: bool = False) -> None:
    """Read the current statement's closed device legs whose events both
    completed (`Event.query()`: no synchronize) into their spans'
    ``device_ms`` and return the events to the pool.  Called on the
    statement thread after a blocking fetch, which completed every
    launch its stream had enqueued and every side-stream copy that
    stream waited on.  Legs still in flight wait for the next call;
    `final` (the statement's end) drops them unread."""
    st = getattr(_tls, "state", None)
    tr = None if st is None else st["trace"]
    if tr is not None:
        _resolve(tr, final)


def _resolve(tr: "Trace", final: bool) -> None:
    if not tr.legs:
        return
    with _legs_mu:
        legs, tr.legs = tr.legs, []
    keep = []
    for leg in legs:
        if leg.start.query() and leg.end.query():
            ms = leg.start.elapsed_time(leg.end)
            m = leg.span.meta or {}
            m["device_ms"] = round(m.get("device_ms", 0.0) + ms, 4)
            leg.span.meta = m
            if leg.lends_end:
                tr.pool.give(leg.start)
            else:
                tr.pool.give(leg.start, leg.end)
        elif not final:
            keep.append(leg)
    if keep:
        with _legs_mu:
            tr.legs.extend(keep)


def device_ms(root, name: str = "mesh.dispatch") -> float:
    """Summed ``device_ms`` meta of every span named `name` (dict or
    Span form) — 0.0 on a CPU session."""
    out = 0.0

    def walk(s):
        nonlocal out
        if isinstance(s, dict):
            if s["name"] == name:
                out += (s.get("meta") or {}).get("device_ms", 0.0)
            kids = s.get("children", ())
        else:
            if s.name == name:
                out += (s.meta or {}).get("device_ms", 0.0)
            kids = list(s.children)
        for c in kids:
            walk(c)

    walk(root)
    return out


# -- per-class latency histograms (DDSketch) --------------------------------
class ClassHist:
    __slots__ = ("calls", "sum_ms", "max_ms", "buckets")

    def __init__(self):
        self.calls = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0
        self.buckets: dict[int, int] = {}

    def record(self, ms: float) -> None:
        key = dd_bucket_scalar(float(ms))
        self.calls += 1
        self.sum_ms += ms
        if ms > self.max_ms:
            self.max_ms = ms
        self.buckets[key] = self.buckets.get(key, 0) + 1

    @staticmethod
    def quantile_of(buckets: dict[int, int], q: float) -> float | None:
        """Quantile from a bucket-dict SNAPSHOT — callers must pass a
        copy taken under the recorder lock (iterating the live dict
        races concurrent record() calls: torn keys/counts pairs)."""
        import numpy as np

        from ..ops.sketches import dd_quantile

        if not buckets:
            return None
        keys = np.fromiter(buckets.keys(), dtype=np.int64)
        counts = np.fromiter(buckets.values(), dtype=np.int64)
        return dd_quantile(keys, counts, q)


class _StatementHandle:
    """What begin() returns and end() consumes: the wall clock always,
    the span tree only when this statement samples in."""

    __slots__ = ("sql", "t0", "trace", "nested")

    def __init__(self, sql, t0, trace, nested=False):
        self.sql = sql
        self.t0 = t0
        self.trace = trace
        self.nested = nested


class TraceRecorder:
    """ONE per Session (it rides SessionStats).  Thread-safe: concurrent
    execute() callers each trace their own statement on their own
    thread; the ring/histograms fold under a lock once per statement."""

    def __init__(self, data_dir: str | None = None, settings=None):
        self.data_dir = data_dir
        self.settings = settings
        import itertools

        self._mu = threading.Lock()
        self._ring: list[Trace] = []
        self._hists: dict[str, ClassHist] = {}
        self._seq = itertools.count(1)
        # separate tick stream for the fast-class auto-degrade: fed
        # from _seq, an even trace_sample_every would alias the two
        # modulos (survivors of the first check always land on the
        # same residue at the second) and fast classes would never
        # record a tree at all
        self._fast_seq = itertools.count(1)
        self._slow_seq = 0
        self.max_hist_classes = 512
        # CUDA timing events for the device legs, reused across
        # statements (a CPU session never takes one)
        self.events = _EventPool()
        # settings-profile memo keyed by Settings.version: four
        # registry lookups per statement are measurable at serving QPS
        self._cfg_memo = None

    def _cfg(self):
        """(enabled, sample_every, ring_keep, slow_ms, fast_ms,
        fast_every) — memoized per settings version (a benign race
        installs the same tuple)."""
        settings = self.settings
        if settings is None:
            return (True, 1, 128, 0, 0.0, 1)
        c = self._cfg_memo
        if c is not None and c[0] == settings.version:
            return c[1]
        vals = (bool(settings.get("trace_enabled")),
                max(1, int(settings.get("trace_sample_every"))),
                max(1, int(settings.get("trace_ring_statements"))),
                settings.get("trace_slow_statement_ms"),
                float(settings.get("trace_fast_statement_ms")),
                max(1, int(settings.get("trace_fast_sample_every"))))
        self._cfg_memo = (settings.version, vals)
        return vals

    # -- statement lifecycle ------------------------------------------------
    def begin(self, sql: str, t0: float | None = None) -> _StatementHandle:
        t0 = time.perf_counter() if t0 is None else t0
        st = _tls_state()
        if st["trace"] is not None:
            # re-entrant execute on one thread (internal fallback
            # paths): never corrupt the outer statement's stack, and
            # record NOTHING for the inner statement — the outer
            # statement's wall already covers it, so a histogram entry
            # here would double-count the time
            return _StatementHandle(sql, t0, None, nested=True)
        enabled, every, _keep, _slow, fast_ms, fast_every = self._cfg()
        if not enabled:
            return _StatementHandle(sql, t0, None, nested=True)
        if every > 1 and next(self._seq) % every:
            return _StatementHandle(sql, t0, None)
        if fast_ms > 0.0 and fast_every > 1:
            # auto-degrade to sampling for PROVEN-fast statement
            # classes (the serving cache-hit hammer): a class whose
            # observed mean wall sits under the threshold after ≥8
            # calls records trees 1-in-N — span trees cost ~15 µs,
            # which is real money on a 0.3 ms statement and nothing on
            # the ≥2 ms statements attribution exists for.  Histograms
            # always update; cold/slow classes always record.  (Racy
            # dict/attr reads are fine: both sides are GIL-atomic and
            # a stale mean only shifts WHEN sampling engages.)
            h = self._hists.get(_clamp(fingerprint(sql)))
            if h is not None and h.calls >= 8 and \
                    h.sum_ms < fast_ms * h.calls and \
                    next(self._fast_seq) % fast_every:
                return _StatementHandle(sql, t0, None)
        root = Span(span_name("statement"), t0, threading.get_ident())
        trace = Trace(_clamp(sql), root, self.events)
        st["trace"] = trace
        st["stack"].append(root)
        return _StatementHandle(sql, t0, trace)

    def end(self, h: _StatementHandle, error: BaseException | None = None,
            ) -> Trace | None:
        t1 = time.perf_counter()
        wall_ms = (t1 - h.t0) * 1000.0
        trace = h.trace
        if trace is not None:
            st = _tls_state()
            root = trace.root
            # close anything the statement left open on this thread
            # (exception unwinding skips no __exit__, so normally only
            # the root is here)
            while st["stack"] and st["stack"][-1] is not root:
                sp = st["stack"].pop()
                if sp.t1 is None:
                    sp.t1 = t1
                trace.leaked += 1
            root.t1 = t1
            if st["stack"]:
                st["stack"].pop()
            st["trace"] = None
            # legs whose events completed are read; the rest (a batch
            # prefetched past a failure) are dropped unread
            _resolve(trace, final=True)
            trace.wall_ms = round(wall_ms, 4)
            if error is not None:
                trace.error = type(error).__name__
        if h.nested and trace is None:
            return None
        cls = _clamp(fingerprint(h.sql))
        if trace is not None:
            trace.cls = cls
        with self._mu:
            hist = self._hists.get(cls)
            if hist is None:
                if len(self._hists) >= self.max_hist_classes:
                    victim = min(self._hists,
                                 key=lambda k: self._hists[k].calls)
                    del self._hists[victim]
                hist = self._hists[cls] = ClassHist()
            hist.record(wall_ms)
            if trace is not None:
                self._ring.append(trace)
                keep = self._cfg()[2]
                if len(self._ring) > keep:
                    del self._ring[:len(self._ring) - keep]
        if trace is not None:
            slow_ms = self._cfg()[3]
            if slow_ms and wall_ms >= slow_ms and self.data_dir:
                try:
                    self._persist_slow(trace)
                except OSError:
                    pass  # a full/readonly disk must not fail the query
        return trace

    # -- slow-query log -----------------------------------------------------
    def _persist_slow(self, trace: Trace) -> None:
        from ..utils.io import atomic_write_json

        d = os.path.join(self.data_dir, SLOW_TRACE_DIR)
        os.makedirs(d, exist_ok=True)
        with self._mu:
            self._slow_seq += 1
            seq = self._slow_seq
        doc = trace.to_dict()
        doc["recorded_unix"] = time.time()
        fname = f"trace_{int(time.time() * 1000):015d}_{seq:04d}.json"
        atomic_write_json(os.path.join(d, fname), doc)
        # bound the log: keep the newest SLOW_TRACE_KEEP files
        names = sorted(n for n in os.listdir(d)
                       if n.startswith("trace_") and n.endswith(".json"))
        for stale in names[:-SLOW_TRACE_KEEP]:
            try:
                os.remove(os.path.join(d, stale))
            except OSError:
                pass  # raced with another session's prune

    # -- read side ----------------------------------------------------------
    def traces(self) -> list[Trace]:
        with self._mu:
            return list(self._ring)

    def last_trace(self) -> dict | None:
        """Newest completed trace as a dict (bench scripts re-derive
        their phase_*_seconds keys from this instead of hand timers)."""
        with self._mu:
            if not self._ring:
                return None
            return self._ring[-1].to_dict()

    def latency_rows(self) -> list[dict]:
        """citus_stat_latency() rows: per-class calls + DDSketch
        quantiles, busiest classes first.  Per-class state is COPIED
        under the lock; quantiles compute on the snapshots (the live
        bucket dicts mutate under concurrent end() calls)."""
        with self._mu:
            items = sorted(
                ((cls, h.calls, h.sum_ms, h.max_ms, dict(h.buckets))
                 for cls, h in self._hists.items()),
                key=lambda t: -t[2])
        rows = []
        qof = ClassHist.quantile_of
        for cls, calls, sum_ms, max_ms, buckets in items:
            rows.append({
                "statement_class": cls,
                "calls": calls,
                "mean_ms": round(sum_ms / calls, 3) if calls else 0,
                "p50_ms": _round_q(qof(buckets, 0.50)),
                "p95_ms": _round_q(qof(buckets, 0.95)),
                "p99_ms": _round_q(qof(buckets, 0.99)),
                "max_ms": round(max_ms, 3),
            })
        return rows

    def reset_latency(self) -> None:
        with self._mu:
            self._hists.clear()


def _round_q(v):
    return None if v is None else round(float(v), 3)


# -- phase attribution -------------------------------------------------------
def phase_breakdown(root) -> dict[str, float]:
    """Coarse phase walls in SECONDS from a span tree (`root` is either
    a live Span or a to_dict() span dict).  A span whose name maps in
    PHASE_OF contributes its whole duration and is not descended into,
    so phases never double-count; "other" is the root wall minus every
    attributed phase (glue code, counter folds).  The port's own phase
    `wait` appears only when non-zero."""
    phases = dict.fromkeys(PHASE_ORDER, 0.0)

    def dur_s(s) -> float:
        if isinstance(s, dict):
            return s.get("dur_ms", 0.0) / 1000.0
        return max(0.0, s.duration())

    def kids(s):
        if isinstance(s, dict):
            return s.get("children", ())
        return list(s.children)

    def name_of(s):
        return s["name"] if isinstance(s, dict) else s.name

    def walk(s):
        # an EXPLAIN ANALYZE reads the breakdown mid-statement: spans
        # still open (the in-flight "execute") are containers to
        # descend, never durations to attribute
        still_open = not isinstance(s, dict) and s.t1 is None
        ph = PHASE_OF.get(name_of(s))
        if ph is not None and not still_open:
            phases[ph] += dur_s(s)
            return
        for c in kids(s):
            walk(c)

    for c in kids(root):
        walk(c)
    total = dur_s(root)
    phases["total"] = total
    phases["other"] = max(0.0, total - sum(
        phases[p] for p in PHASE_ORDER))
    if not phases["wait"]:
        del phases["wait"]
    return phases


def span_seconds(root, *names: str) -> float:
    """Summed duration of every span named in `names` across the whole
    tree (dict or Span form) — the bench scripts' phase_*_seconds
    derivation."""
    want = set(names)
    out = 0.0

    def walk(s):
        nonlocal out
        if isinstance(s, dict):
            if s["name"] in want:
                out += s.get("dur_ms", 0.0) / 1000.0
            for c in s.get("children", ()):
                walk(c)
        else:
            if s.name in want and s.t1 is not None:
                out += s.duration()
            for c in list(s.children):
                walk(c)

    walk(root)
    return out


def current_root() -> Span | None:
    """The in-flight statement's root span on this thread, or None —
    EXPLAIN ANALYZE reads its own trace-so-far through this."""
    st = getattr(_tls, "state", None)
    if st is None or st["trace"] is None:
        return None
    return st["trace"].root


def format_timing_line(root) -> str:
    """The EXPLAIN ANALYZE Timing payload: total + every nonzero phase,
    in ms (phase names are stable — tests and trace_summarize key on
    them)."""
    ph = phase_breakdown(root)
    parts = [f"total={ph['total'] * 1000:.2f}ms"]
    for name in PHASE_ORDER + ("other",):
        v = ph.get(name, 0.0)
        if v > 0.0005 or name in ("plan", "device"):
            parts.append(f"{name}={v * 1000:.2f}ms")
    return " ".join(parts)
