"""The measured window: a closed loop of sessions, and its arithmetic.

Each session is one thread that sends its next statement as soon as the
last one returned (zero think time) until the window's seconds are up.
A statement's latency is the host clock from the send to result rows in
hand (`Session.execute` returns them fetched to the host).  The window
runs from the start signal to the return of the last statement sent
inside it, so the rate takes all the work and all the time; the tail is
over every statement, a failed one counting as missing any limit.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Stmt:
    session: int
    query: str
    t_send: float
    t_done: float
    ok: bool
    error: str | None = None
    trace: dict | None = None  # the statement's span tree (traced runs)

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_send


class Reservoir:
    """A uniform sample of at most `k` of the items offered, drawn by
    `rng` (reservoir sampling): what the correctness check compares."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen = k, rng, 0
        self.items: list = []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item


@dataclass
class WindowLog:
    t0: float
    seconds: float
    statements: list[Stmt]
    samples: list = field(default_factory=list)  # (query, result)
    stuck: int = 0  # sessions whose statement never returned

    @property
    def t_last(self) -> float:
        return max((s.t_done for s in self.statements), default=self.t0)

    @property
    def attempted(self) -> int:
        return len(self.statements) + self.stuck

    @property
    def failed(self) -> int:
        return sum(not s.ok for s in self.statements) + self.stuck


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of
    the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    k = max(0, math.ceil(q / 100.0 * len(xs)) - 1)
    return xs[k]


def queries_per_s(log: WindowLog) -> float:
    """Statements answered in the window over the window's seconds, from
    the start to the return of the last statement sent inside it."""
    answered = sum(s.ok for s in log.statements)
    span = log.t_last - log.t0
    return answered / span if span > 0 else 0.0


def p95_ms(log: WindowLog) -> float:
    """95th percentile of every statement's latency, a failed one at
    infinity."""
    return percentile([s.latency_s * 1e3 if s.ok else math.inf
                       for s in log.statements], 95)


# how long past the window's close a statement may take to return
# before its session counts as stuck
JOIN_GRACE_S = 120.0


def run(executors, queries, seconds: float, seed: int, sample_k: int,
        during=None) -> WindowLog:
    """Drive `executors` (callables sql -> result, one per session) in a
    closed loop for `seconds`.  `queries` is a list of (name, sql,
    weight); each session draws its statements from its own stream of
    `seed`.  `during(t0)` runs on this thread while the sessions do (the
    traced run's profiler slice).  Returns the log with each session's
    sample of up to `sample_k` results."""
    n = len(executors)
    names = [q[0] for q in queries]
    sqls = {q[0]: q[1] for q in queries}
    w = np.array([q[2] for q in queries], dtype=np.float64)
    w = w / w.sum()
    logs: list[list[Stmt]] = [[] for _ in range(n)]
    samples = [Reservoir(sample_k, np.random.default_rng(
        [int(seed) % (1 << 64), 2, i])) for i in range(n)]
    go = threading.Event()
    t0_box = [0.0]

    def session(i):
        rng = np.random.default_rng([int(seed) % (1 << 64), 1, i])
        go.wait()
        t_end = t0_box[0] + seconds
        execute = executors[i]
        while True:
            t_send = time.perf_counter()
            if t_send >= t_end:
                return
            q = names[0] if len(names) == 1 else \
                names[int(rng.choice(len(names), p=w))]
            try:
                res = execute(sqls[q])
            except Exception as e:  # counted as failed, the loop goes on
                logs[i].append(Stmt(i, q, t_send, time.perf_counter(),
                                    False, f"{type(e).__name__}: {e}"[:300]))
                continue
            logs[i].append(Stmt(i, q, t_send, time.perf_counter(), True))
            samples[i].offer((q, res))

    threads = [threading.Thread(target=session, args=(i,), daemon=True,
                                name=f"portbench-session-{i}")
               for i in range(n)]
    for t in threads:
        t.start()
    t0_box[0] = time.perf_counter()
    go.set()
    if during is not None:
        during(t0_box[0])
    deadline = t0_box[0] + seconds + JOIN_GRACE_S
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    stuck = sum(t.is_alive() for t in threads)
    stmts = sorted((s for lg in logs for s in lg), key=lambda s: s.t_send)
    kept = [item for r in samples for item in r.items]
    return WindowLog(t0_box[0], seconds, stmts, kept, stuck)
