#!/usr/bin/env python3
"""Time phases 9-14 of one checkout's chip_smoke.py on one NVIDIA GPU.

    python3 tools/compare_phases.py ROOT [--eager]

ROOT is a checkout of the repo (this tree, or a `git archive` of another
commit unpacked under a gitignored directory).  The script imports
ROOT's own `chip_smoke.py` and `citus_tpu_torch`, builds ROOT's kernels,
generates TPC-H SF1 (seed 0) and loads it with lineitem_nullable into a
fresh data_dir as `chip_smoke.main` does, then runs ROOT's phases 9, 10,
11, 12, 13 and 14 in that order on it, each on the data_dir as the one
before left it.  Each phase's wall is logged as `P914 phase N: S s ok`;
a phase that fails is logged with its error (`FAILED`) and the next one
still runs, so a run gives every phase's wall.  Exit status 1 when any
phase failed.  With --eager (a checkout with the compiled form) no plan
captures a CUDA graph: every run takes the compiler's eager dispatch,
which separates what the graphs cost from the rest of a change.

To compare two commits on one card, run one process per checkout in
turns (A, B, B, A) within one machine, and read the `P914 phase` lines
and phase 9's `phase9 P2` lines of each log.
"""
import os
import shutil
import sys
import tempfile
import time
import traceback


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    eager = "--eager" in sys.argv[2:]
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    import citus_tpu_torch as ct
    from citus_tpu_torch.ingest import tpch
    from citus_tpu_torch.ops import hopper_kernels as hk

    assert ct.__file__.startswith(root), ct.__file__
    if eager:
        from citus_tpu_torch.executor.runner import Executor

        Executor._graph_for = lambda self, *a, **k: None
    ident = cs.card_identity()
    cs.log(f"tree {root}{' (eager)' if eager else ''}: {ident}")
    t0 = time.perf_counter()
    hk.build_all()
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="p914_")
    rc = 0
    try:
        d = os.path.join(tmp, "data")
        data = tpch.generate_tables(1.0, seed=0)
        sess = cs.rerun_connect(ct, d)
        tpch.load_tables(sess, data)
        li, orders, cust = data["lineitem"], data["orders"], data["customer"]
        cs.load_nullable(sess, li, tpch)
        sess.close()
        want = {"Q1": cs.numpy_q1(li), "Q3": cs.numpy_q3(cust, orders, li),
                "high_card_groupby": cs.numpy_high_card(li),
                "nullable": cs.numpy_nullable(li)}
        checks = {"Q1": cs.check_q1, "Q3": cs.check_q3,
                  "high_card_groupby": cs.check_high_card,
                  "nullable": cs.check_nullable}
        queries = {"Q1": tpch.QUERIES["Q1"], "Q3": tpch.QUERIES["Q3"],
                   "high_card_groupby": cs.HIGH_CARD_SQL,
                   "nullable": cs.NULLABLE_SQL}
        state = {"li_now": li}

        def p13():
            _l, state["li_now"] = cs.phase13(ct, hk, d, data, queries,
                                             checks, want, ident, tmp)

        def p14():
            ln = state["li_now"]
            want14 = dict(want, Q1=cs.numpy_q1(ln),
                          Q3=cs.numpy_q3(cust, orders, ln),
                          high_card_groupby=cs.numpy_high_card(ln))
            cs.phase14(ct, hk, d, data, ln, queries, checks, want14, ident)

        steps = [(9, lambda: cs.phase9(ct, hk, d, data, 3, ident)),
                 (10, lambda: cs.phase10(ct, hk, d, data, 3, ident)),
                 (11, lambda: cs.phase11(ct, hk, d, data, queries, checks,
                                         want, 2, ident)),
                 (12, lambda: cs.phase12(ct, hk, d, queries, checks, want,
                                         ident)),
                 (13, p13), (14, p14)]
        for n, fn in steps:
            t0 = time.perf_counter()
            # a failed phase is logged, and the later phases still run
            try:
                fn()
                cs.log(f"P914 phase {n}: {time.perf_counter() - t0:.3f} s "
                       "ok")
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                cs.log(f"P914 phase {n}: {time.perf_counter() - t0:.3f} s "
                       f"FAILED {e!r}"[:600])
                rc = 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
