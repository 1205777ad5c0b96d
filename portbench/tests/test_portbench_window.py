"""The window's arithmetic: a rate over all statements and all the
window's time, and a tail over every statement, which a stall moves."""

import math
import threading
import time

import numpy as np
import pytest

from portbench import window
from portbench.window import Stmt, WindowLog


def log_of(latencies_ms, gap_ms=0.0, ok=None):
    """One session's statements back to back, `gap_ms` idle before each."""
    t, stmts = 100.0, []
    for i, ms in enumerate(latencies_ms):
        t += gap_ms / 1e3
        good = True if ok is None else ok[i]
        stmts.append(Stmt(0, "q", t, t + ms / 1e3, good))
        t += ms / 1e3
    return WindowLog(100.0, t - 100.0, stmts)


def test_percentile_is_nearest_rank():
    xs = list(range(1, 101))
    assert window.percentile(xs, 95) == 95
    assert window.percentile([5.0], 95) == 5.0
    assert window.percentile(xs[::-1], 50) == 50


def test_rate_counts_every_statement_over_all_the_time():
    lg = log_of([10.0] * 100)
    assert window.queries_per_s(lg) == pytest.approx(100.0)
    # a stall inside the window lowers the rate by all of its time
    stalled = log_of([10.0] * 99 + [1010.0])
    assert window.queries_per_s(stalled) == pytest.approx(50.0)


def test_p95_is_over_every_statement_and_a_stall_moves_it():
    assert window.p95_ms(log_of([10.0] * 100)) == pytest.approx(10.0)
    # six statements queued behind one stall: above the 95th rank
    slow = [10.0] * 94 + [300.0] * 6
    assert window.p95_ms(log_of(slow)) == pytest.approx(300.0)


def test_a_failed_statement_misses_every_limit():
    ok = [True] * 94 + [False] * 6
    lg = log_of([10.0] * 100, ok=ok)
    assert math.isinf(window.p95_ms(lg))
    assert lg.failed == 6 and lg.attempted == 100
    assert window.queries_per_s(lg) == pytest.approx(94 / 1.0)


def test_reservoir_keeps_a_seeded_uniform_sample():
    def sample(seed):
        r = window.Reservoir(5, np.random.default_rng(seed))
        for i in range(1000):
            r.offer(i)
        return r.items

    assert sample(1) == sample(1) and len(sample(1)) == 5
    assert sample(1) != sample(2)


def test_closed_loop_drives_every_session():
    lock = threading.Lock()

    def executor(ms):
        def run(sql):
            with lock:
                time.sleep(ms / 1e3)
            if sql == "bad":
                raise RuntimeError("planted")
            return sql
        return run

    lg = window.run([executor(5), executor(5)],
                    [("good", "good", 3.0), ("bad", "bad", 1.0)],
                    0.6, seed=9, sample_k=4)
    assert lg.stuck == 0
    assert {s.session for s in lg.statements} == {0, 1}
    assert lg.failed == sum(s.query == "bad" for s in lg.statements) > 0
    assert all(q == "good" and res == "good" for q, res in lg.samples)
    assert len(lg.samples) <= 8
    # two sessions through one lock: about one statement per 5 ms
    assert 60 <= lg.attempted <= 125
    assert lg.t_last >= lg.t0 + 0.6
    # every statement sent inside the window, none after it
    assert max(s.t_send for s in lg.statements) < lg.t0 + 0.6
