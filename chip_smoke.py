#!/usr/bin/env python3
"""Drive the PyTorch port (citus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--sf 1.0] [--reps 3]

Phases, each fatal on failure (no result line is printed then):

1. print the card's name and power limit (nvidia-smi);
2. build the five Hopper kernels from citus_tpu_torch/csrc (nvcc,
   one process per source, started together);
3. generate TPC-H at --sf (6.0M lineitem rows at SF1) and load its
   eight tables through the port's own DDL, distribution and ingest
   into a temporary data_dir (shard_count 8), plus
   lineitem_nullable: lineitem's rows with l_discount and l_tax NULL on
   a seeded 10% of rows each;
4. the main path, under the default scan_pipeline=auto (device decode
   on a CUDA session): with every kernel launch count at 0, run TPC-H
   Q1, Q3, the high-cardinality GROUP BY and a NULL-aware aggregate over
   lineitem_nullable through Session.execute on the GPU, check each
   answer against a plain numpy evaluation of the same query over the
   generated arrays, and require each kernel to have launched on the
   query that carries it;
5. hold each kernel against its plain PyTorch version on the inputs the
   main path gave it, and time kernel, plain version and one library
   call (where one exists) against the card's bound: back-to-back
   wrapper calls (CUDA events: what a statement's thread pays), and the
   kernel's and the library call's own device time at cold L2
   (torch.profiler, 64 MB written between launches);
6. scan modes: for Q1 and the nullable query, one fresh session per
   scan_pipeline mode (off, host, device, then device, host, off) on
   the same data_dir: first-run wall, the pipeline's phase split and
   wire/decoded bytes, the answers against numpy, and the ledger's
   prefetch bytes back at 0; then the link's copy time for those bytes;
7. time warm runs of Q1, Q3, the GROUP BY and the nullable query
   (rows/s), and profile one more warm run of each (device busy time,
   idle share, heaviest kernels);
8. TPC-H 22: with every launch count at 0, each of the 22 TPC-H
   statements in a fresh session on the card (a cold scan with device
   decode), then one warm run (TPCH22_WARM_REPS); per statement the walls,
   retries, rows, each kernel's launches and the rows and host seconds
   of each intermediate result it stored.  Q4, Q13, Q18 and Q21 are held
   against numpy, the other 18 against the port's own CPU session
   (float32 on both sides): on the same data_dir, but for Q8 and Q9
   (CHECK_SMALL), which run again on a second, smaller data_dir (SF
   CHECK_SF, loaded by a card session) in a card session and in the CPU
   session.  Fails when an
   answer differs, when the dense-grid sum, the bucketed group-by sums
   or the dictionary decode never launch on the 14 statements that
   plan recursively, or when an `__intermediate_` temp outlives its
   statement (catalog, data_dir, feed cache) or prefetch bytes stay
   live.  One warm run each of Q4, Q13, Q18 and Q21 is profiled;
9. windows, sketches, prepared statements, EXPLAIN and DDL, on the same
   data_dir with every launch count at 0, each statement in a fresh
   cuda session (scan_pipeline=auto, float32), first run then the best
   of --reps warm runs: W1 rank/row_number over orders by customer, W2
   running sums and counts and a whole-partition max over a month of
   lineitem (and of lineitem_nullable, whose sum carries NULLs), W3
   dense_rank over orders ⋈ customer; S1 approx_count_distinct grouped
   by l_returnflag, l_linestatus, S2 approx_percentile 0.5 and 0.99 by
   l_shipmode, S3 approx_count_distinct(o_custkey); P1 a prepared
   point lookup on o_orderkey for 20 keys with the fast-path router on
   (answered on the host, by design) and off (on the card), and the
   literal form through the point index; P2 TPC-H Q1 prepared on
   l_shipdate and run for 3 dates; E1 EXPLAIN of Q3, of EXECUTE p1 and
   of W1; D1 (last) a view over Q1, ALTER TABLE supplier ADD COLUMN read
   in each scan mode, DROP COLUMN, and DROP TABLE of a table of its own.
   Per statement: rows, first and best warm walls, retries, launches,
   fast_path and plan-cache hits and misses.  Every answer is held
   against the port's CPU session on the same data_dir (float32; S2's
   percentiles within one DDSketch bucket, which a float32 log can flip),
   W1 against a numpy rank, S1 and S3 within 5% of the exact distinct
   count, P1 against numpy lookups.  Fails when an answer differs, when
   P1 is (with the router on) or is not (off) answered by the fast path,
   when P2's three EXECUTEs build more than one PlanCompiler, when a temp
   outlives its statement, when the dictionary decode never launches, or
   when neither the dense-grid sum nor the bucketed group-by sums launch
   on S1, S2 and P2;
10. the write path, last, on tables of its own (dropped at the end),
    with every launch count at 0, each step in a fresh cuda session
    (scan_pipeline=device, float32): I1 `INSERT INTO orders_w SELECT *
    FROM orders` (colocated with orders, 1.5M rows), I2 the
    high-cardinality GROUP BY inserted into li_agg (K3, and K5 on the
    cold lineitem scan), I3 orders re-sharded on o_custkey
    (repartition, every row's shard checked against its token); U1 an
    UPDATE of 1992's orders, a point UPDATE that must touch one shard,
    o_totalprice set to NULL for 1,000 seeded customers and a DELETE;
    T1 a DELETE seen inside its transaction (feed cache and pipeline
    bypassed) and rolled back, then three INSERTs and an UPDATE
    committed; M1 a MERGE from a 20,000-row reference table, half of it
    matching; C1 a 100,000-row CSV copied in; R1 a COMMIT killed at the
    port's `txn.apply` fault point in a session without statement
    retries (max_statement_retries = 0), recovered by the next session,
    and the change feed in LSN order; R2 the same kill under the default
    retries, resolved inside the session by its commit record.  Every
    affected count, mode and read-back (count(*), count(o_totalprice)
    and sum(o_totalprice) by o_orderpriority: K1, and K4 once NULLs
    exist) is held against numpy replaying the same writes on its own
    copy.  Fails on any mismatch or when K1, K3, K4 or K5 never
    launches in the phase;
11. statements larger than their budget, with every launch count at 0,
    each step in a fresh cuda session (scan_pipeline=device, float32):
    S1–S4 Q1, Q3, the GROUP BY and the nullable query under
    max_feed_bytes_per_device = 64 MiB, each streamed in at least 4
    batches through one PlanCompiler (first run and best warm walls,
    batch_cap, batches, launches, the ledger's peak `stream` bytes,
    max_memory_allocated; K1 once per batch on S1 and S4, K3 at least
    once per batch on S3, K2 on S2 where the per-batch plan keeps the
    bucketed probe); L1 Q3 with the caching allocator capped at 40% of
    its resident peak, answered by the OOM ladder after a real CUDA
    OOM; L2 orders ⋈ lineitem under a simulated budget below the orders
    side, answered in multi-pass (multipass_k ≥ 2); L3 the same with
    oom_degradation off, a clean ResourceExhausted, then Q1; T1 a
    statement timeout and T2 a cross-thread cancel at a stream batch
    boundary.  Every answer against numpy; fails when a step does not
    stream, a kernel misses its launches, or the ledger's stream, feed,
    plan or prefetch bytes or a producer thread outlive a step;
12. observability, with every launch count at 0, each step in a fresh
    cuda session (scan_pipeline=device, float32, every statement
    traced): EXPLAIN ANALYZE of Q1, Q3, the GROUP BY and the nullable
    query, first (cold scan) and warm, each answer still checked
    against numpy by a plain run between them; per query its Timing
    lines, the warm traced run's split (plan, feed, dispatch, fetch,
    combine, other), the summed device_ms of its dispatch event pairs,
    the profiler's device busy time, and (Q1, Q3) the synchronizing
    calls its warm run makes, by call site (CUDA sync debug mode).  Then
    S1's streamed Q1, L1's capped Q3 (its oom.degrade spans and
    attempts), the cost of tracing (Q1 warm, on and off interleaved,
    best of OVERHEAD_REPS each) and citus_check_cluster_node_health()
    on the card.  Fails when a dispatch's summed device_ms is not in
    (0, its device phase wall + 0.1 ms], when top-level spans cover
    less than 95% of a root, when a span stays open, the ledger's
    transient bytes or a producer thread outlive a step, when a kernel
    never launches under EXPLAIN ANALYZE, when tracing costs more than
    5% + 0.2 ms of Q1's best warm wall, or when a node probes unhealthy;
13. concurrent statements, last, with every launch count at 0, each
    step in sessions of its own: W1 eight sessions in threads, two
    tenants weighted a:3,b:1, max_concurrent_statements = 2, the result
    cache off, each running Q1, Q3, the GROUP BY and the nullable query
    twice (the first round in device scan mode), every answer against
    numpy, at most two statements executing at once (a count the script
    keeps), every statement admitted and some queued, every kernel
    launched (walls, queued_ms p50/p99/max per tenant,
    citus_stat_wlm(), max_memory_allocated); W2 two Q3s under a
    max_feed_bytes_per_device between one and two Q3 estimates: the
    second queues on bytes with slots free, both answer; W3 four Q3s
    under two slots and wlm_queue_depth = 1 (a clean AdmissionRejected,
    the rest answer) and a 200 ms statement_timeout_ms running out in
    the queue; P1 16 sessions in threads x 64 literal o_orderkey
    lookups with the micro-batcher on, then off (answers against numpy,
    answered + errored + fallback = requests, batches of more than one
    and fewer dispatches than lookups when on; p50/p99 latency,
    citus_stat_serving()); C1 Q1 twice with the result cache on (the
    hit launches no kernel), an INSERT into lineitem from a second
    session (a miss, equal to numpy's replay), an UPDATE of nation (Q1
    still hits); R1 a follower provisioned from the data_dir, its Q1
    and Q3 on the card equal to the leader's with K1, K2 and K5
    launched there, a leader INSERT shipped by citus_replication_ship()
    and seen, ReplicaTooStale at replica_max_staleness_lsn = 0 with an
    unshipped write, ReadOnlyReplica for a write on the follower, and
    citus_promote_replica(): the promoted dir takes a write and the old
    leader's ship is fenced.  The device-memory ledger holds no
    transient bytes after each step;
14. shard operations, background jobs and storage integrity, last, with
    every launch count at 0, each step in sessions of its own (the
    result cache off), every answer against numpy over lineitem as
    phase 13 left it: O0 citus_create_restore_point('pre_ops'); O1 a
    session warm on Q1 and Q3, then lineitem's first shard split at
    its token midpoint (orders' with it): Q1, Q3 and the GROUP BY in
    the warm session and a fresh one, `retries` 0, K1, K2, K3 and K5
    launched, and the parents' directories gone within 2 s under a
    session whose maintenance daemon sweeps every 200 ms; O2 a node
    added and citus_rebalance_start(), two sessions in threads running
    Q1 and Q3 meanwhile, get_rebalance_progress() polled, then
    citus_rebalance_wait(): moves made, the job done, its tasks
    admitted at the workload manager's background class; O3 a
    replication-factor-2 copy of lineitem_nullable's aggregated columns
    (6.0M rows), the storage.stripe_bitflip fault point armed once per
    scan mode (off, host, device): the answer right, one read repair,
    every copy verifying after, K4 and K5 launched in device mode, and
    EXPLAIN ANALYZE's Integrity line counting the repair; a bit flipped
    at rest found by citus_check_cluster() (quarantined, re-replicated)
    and the next run repairing nothing; a bit flipped in factor-1
    lineitem a clean CorruptStripe in every mode with no transient
    ledger bytes left; O4 every session closed, restore_cluster(
    data_dir, 'pre_ops'), lineitem back at 8 shards and Q1 and Q3 equal
    to numpy.  Walls and launches per step; fails past its 150 s budget
    or when a kernel never launches in the phase;
15. the compiled form: warm resident plans replayed as CUDA graphs,
    the persisted capacity memo, single-flight captures across sessions
    and warm-before-admit (see phase15);
16. the mesh, last, with every launch count at 0, on the SF1 data_dir
    (shard_count 8): M0 a 2-position session fits the node set to 2
    (citus_rebalance_mesh) and copies orders into orders_m, whose
    shards then sit on 2 nodes; M1 a 4-position session on cuda:0 runs
    Q3 over orders_m on 2 of its 4 positions, then citus_rebalance_mesh
    spreads every table over 4 nodes and Q3 over orders_m runs again;
    M2 Q1, Q3, the high-cardinality GROUP BY and the nullable aggregate
    at 4 positions, each against numpy and against a one-position
    session's rows; M3 a device-routed INSERT..SELECT into a 4-shard
    table (one shard per position) with its per-position row counts
    against numpy; M4 citus_drain_device(3) and Q3 over orders_m again
    (position 3 feeds no rows); M5 a replication-factor-2 data_dir at
    SF RF2_SF on 4 positions, a MeshSim kill of position 2 in the middle
    of Q3, failing over to 3 positions with Q3 equal to numpy.  Per
    step the wall, the all_to_all bytes, the rows per position and the
    launches per kernel; fails past its 150 s budget or when K1, K2 or
    K3 never launch at 4 positions;
17. fault tolerance under chaos, and the slab loader, last, with every
    launch count at 0: S1 ingest/tpch_slab.load_slabbed at SF SLAB_SF in
    order slabs of SLAB_ORDERS into a fresh data_dir on a cuda session
    (the wall of each slab, rows/s of ingest, customer and orders rows
    against tpch.table_rows), then Q1, Q3 and the high-cardinality
    GROUP BY on the card, first run and once warm, their rows against
    the port's CPU session on the same data_dir (float32 on both; the
    GROUP BY's on its first 10,000 orders, and whole by its group count
    and totals); K1, K2 and K3 must launch (K5's launches are printed).  S2 the chaos soak's smoke slice
    (tests/test_torch_chaos.run_soak: 45 ops, seed 1234, fault rate
    0.35) on cuda: three sessions at 2/2/8 positions under random armed
    faults and a device-killer, with the port's lock-order sanitizer
    armed; its counts, the restart's executable-cache hits (at least
    one) and zero sanitizer violations; K1 must launch.  Every kernel
    launched in the phase is held against its plain version on the
    inputs it recorded.  Fails past its 90 s budget;
18. print the kernels line (with each kernel's launches in phases 8
    to 17), then the device line last.

Exits non-zero without a result when no GPU is visible or the port's
package is not next to this script.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and f32
# rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# bytes copied between two scratch buffers before every launch timed on
# the device, more than the H100's 50 MB L2: each launch finds L2 cold, as
# a first-touch scan does
FLUSH_BYTES = 64 << 20
DEVICE_REPS = 24

# which Pallas kernel each CUDA kernel replaces (def lines)
REPLACES = {
    "dense_grid_sum": "citus_tpu/ops/pallas_kernels.py:85",
    "bucketed_probe": "citus_tpu/ops/pallas_kernels.py:133",
    "bucketed_groupby_sums": "citus_tpu/ops/pallas_kernels.py:203",
    "bit_unpack": "citus_tpu/ops/pallas_kernels.py:270",
    "dict_decode": "citus_tpu/ops/pallas_kernels.py:303",
}
# the query of the main path that must carry each kernel
CARRIER = {"dense_grid_sum": "Q1", "bucketed_probe": "Q3",
           "bucketed_groupby_sums": "high_card_groupby",
           "dict_decode": "Q1", "bit_unpack": "nullable"}

HIGH_CARD_SQL = ("select l_orderkey, count(*), sum(l_quantity) "
                 "from lineitem group by l_orderkey")
NULLABLE_SQL = ("select l_returnflag, l_linestatus, count(*), "
                "count(l_discount), sum(l_discount), sum(l_tax) "
                "from lineitem_nullable where l_shipdate <= date '1998-09-02' "
                "group by l_returnflag, l_linestatus order by 1, 2")
NULL_SHARE = 0.1
SCAN_MODES = ("off", "host", "device", "device", "host", "off")


def rerun_connect(ct, data_dir, **settings):
    """A session of phases 1-12: they time warm re-runs and count the
    launches and spans of repeated statements, so each run must execute
    — the serving result cache (on by default) stays off."""
    return ct.connect(data_dir, serving_result_cache_bytes=0, **settings)


def log(*a):
    print(*a, flush=True)


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def days(iso: str) -> int:
    import numpy as np

    return int(np.datetime64(iso, "D").astype(np.int64))


# -- plain numpy answers over the generated arrays -------------------------

def numpy_q1(li):
    import numpy as np

    cutoff = days("1998-12-01") - 90
    m = li["l_shipdate"] <= cutoff
    qty, price = li["l_quantity"], li["l_extendedprice"]
    disc, tax = li["l_discount"], li["l_tax"]
    rows = []
    for rf in ("A", "N", "R"):
        mrf = m & (li["l_returnflag"] == rf)
        for ls in ("F", "O"):
            g = mrf & (li["l_linestatus"] == ls)
            n = int(g.sum())
            if not n:
                continue
            dp = price[g] * (1 - disc[g])
            rows.append((rf, ls, qty[g].sum(), price[g].sum(), dp.sum(),
                         (dp * (1 + tax[g])).sum(), qty[g].mean(),
                         price[g].mean(), disc[g].mean(), n))
    return rows


def numpy_q3(cust, orders, li):
    import numpy as np

    d = days("1995-03-15")
    bkeys = cust["c_custkey"][cust["c_mktsegment"] == "BUILDING"]
    om = (orders["o_orderdate"] < d) & np.isin(orders["o_custkey"], bkeys)
    # order keys are 4i+1: dense index (k-1)//4
    n_ord = len(orders["o_orderkey"])
    sel = np.zeros(n_ord, dtype=bool)
    sel[(orders["o_orderkey"][om] - 1) // 4] = True
    lidx = (li["l_orderkey"] - 1) // 4
    lm = (li["l_shipdate"] > d) & sel[lidx]
    rev = np.bincount(lidx[lm], weights=(li["l_extendedprice"][lm]
                                         * (1 - li["l_discount"][lm])),
                      minlength=n_ord)
    has = np.bincount(lidx[lm], minlength=n_ord) > 0
    idx = np.flatnonzero(has)
    odate = orders["o_orderdate"][idx]
    order = np.lexsort((odate, -rev[idx]))[:10]
    out = []
    for i in idx[order]:
        out.append((int(orders["o_orderkey"][i]), float(rev[i]),
                    str(np.datetime64(int(orders["o_orderdate"][i]), "D")),
                    int(orders["o_shippriority"][i])))
    return out


def numpy_high_card(li):
    import numpy as np

    lidx = (li["l_orderkey"] - 1) // 4
    cnt = np.bincount(lidx)
    qty = np.bincount(lidx, weights=li["l_quantity"])
    keys = np.flatnonzero(cnt) * 4 + 1
    return keys, cnt[cnt > 0], qty[cnt > 0]


def nullable_masks(n: int):
    """The seeded NULL positions of lineitem_nullable's l_discount and
    l_tax."""
    import numpy as np

    rng = np.random.default_rng(1)
    return rng.random(n) < NULL_SHARE, rng.random(n) < NULL_SHARE


def load_nullable(sess, li, tpch, table="lineitem_nullable",
                  names=None, dist="l_orderkey") -> int:
    """`table`: lineitem's columns `names` (all by default) under
    lineitem's DDL types (its measures are nullable), shard_count 8 on
    `dist`, loaded from the generated arrays with l_discount and l_tax
    passed as lists holding None where NULL (the seeded masks)."""
    import numpy as np
    from citus_tpu_torch.ingest.copy_from import _ingest_batch

    names = list(names or li)
    ddl = tpch.SCHEMAS["lineitem"].replace("create table lineitem",
                                           f"create table {table}")
    if len(names) < len(li):  # keep the DDL lines of `names` only
        head, body = ddl.split("(", 1)
        cols = [c.strip() for c in body.rsplit(")", 1)[0].split(",")]
        ddl = head + "(" + ", ".join(
            c for c in cols if c.split()[0] in names) + ")"
    sess.execute(ddl)
    sess.create_distributed_table(table, dist, shard_count=8)
    null_disc, null_tax = nullable_masks(len(li["l_orderkey"]))

    def with_nulls(a, mask):
        cells = a.tolist()
        for i in np.flatnonzero(mask):
            cells[i] = None
        return cells

    batch = [with_nulls(li[c], null_disc) if c == "l_discount"
             else with_nulls(li[c], null_tax) if c == "l_tax"
             else list(li[c]) if li[c].dtype == object else li[c]
             for c in names]
    return _ingest_batch(sess, table, names, batch, pre_typed=True)[0]


def numpy_nullable(li):
    null_disc, null_tax = nullable_masks(len(li["l_orderkey"]))
    m = li["l_shipdate"] <= days("1998-09-02")
    rows = []
    for rf in ("A", "N", "R"):
        for ls in ("F", "O"):
            g = m & (li["l_returnflag"] == rf) & (li["l_linestatus"] == ls)
            n = int(g.sum())
            if not n:
                continue
            rows.append((rf, ls, n, int((g & ~null_disc).sum()),
                         li["l_discount"][g & ~null_disc].sum(),
                         li["l_tax"][g & ~null_tax].sum()))
    return rows


def check_nullable(res, want):
    got = res.rows()
    if len(got) != len(want):
        raise AssertionError(f"nullable: {len(got)} groups, numpy "
                             f"{len(want)}")
    for g, w in zip(got, want):
        if (g[0], g[1], int(g[2]), int(g[3])) != w[:4]:
            raise AssertionError(f"nullable keys/counts differ: {g} vs {w}")
        if not (close(g[4], w[4]) and close(g[5], w[5])):
            raise AssertionError(f"nullable sums differ: {g} vs {w}")


def close(a, b, rtol=1e-4) -> bool:
    return abs(float(a) - float(b)) <= rtol * max(abs(float(b)), 1.0)


def check_q1(res, want):
    got = res.rows()
    if len(got) != len(want):
        raise AssertionError(f"Q1: {len(got)} groups, numpy {len(want)}")
    for g, w in zip(got, want):
        if (g[0], g[1]) != (w[0], w[1]) or int(g[9]) != w[9]:
            raise AssertionError(f"Q1 keys/counts differ: {g} vs {w}")
        for j in range(2, 9):
            if not close(g[j], w[j]):
                raise AssertionError(f"Q1 column {j}: {g[j]} vs {w[j]}")


def check_q3(res, want):
    got = res.rows()
    if len(got) != len(want):
        raise AssertionError(f"Q3: {len(got)} rows, numpy {len(want)}")
    for g, w in zip(got, want):
        if int(g[0]) != w[0] or str(g[2]) != w[2] or int(g[3]) != w[3] \
                or not close(g[1], w[1]):
            raise AssertionError(f"Q3 row differs: {g} vs {w}")


def check_high_card(res, want):
    import numpy as np

    keys, cnt, qty = want
    k = np.asarray(res.columns[res.column_names[0]], dtype=np.int64)
    order = np.argsort(k)
    c = np.asarray(res.columns[res.column_names[1]], dtype=np.int64)[order]
    q = np.asarray(res.columns[res.column_names[2]],
                   dtype=np.float64)[order]
    if res.row_count != len(keys) or not np.array_equal(k[order], keys):
        raise AssertionError(f"high-card: {res.row_count} groups vs "
                             f"{len(keys)}, or keys differ")
    if not np.array_equal(c, cnt):
        raise AssertionError("high-card: counts differ")
    if not np.allclose(q, qty, rtol=1e-4, atol=1e-4):
        raise AssertionError("high-card: sums differ")


# -- kernels against their plain versions ----------------------------------

def _nbytes(a) -> int:
    if hasattr(a, "numel"):
        return a.numel() * a.element_size()
    if isinstance(a, (list, tuple)):
        return sum(_nbytes(x) for x in a)
    return 0


def _clone(a):
    if hasattr(a, "clone"):
        return a.clone()
    if isinstance(a, (list, tuple)):
        return [_clone(x) for x in a]
    return a


class Recorder:
    """Wraps a kernel wrapper to keep the inputs of its largest call (in
    bytes; a sequence of columns counts each column) on the main path:
    what phase 5 replays."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = None
        self.size = -1

    def __call__(self, *args):
        size = _nbytes(args)
        if size > self.size:
            self.size = size
            self.args = tuple(_clone(a) for a in args)
        return self.fn(*args)

    def install(self):
        setattr(self.module, self.name, self)

    def remove(self):
        setattr(self.module, self.name, self.fn)


def time_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_entries(prof):
    """(name, device µs, count) of each device-side entry of a
    torch.profiler run: kernels and copies.  CPU-side operator entries
    are left out: their device time repeats their kernels'."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)))
        if e.device_type == DeviceType.CUDA and us > 0:
            out.append((e.key, us, e.count))
    return out


def device_ms(fn, match=None, reps: int = DEVICE_REPS,
              tries: int = 3) -> float:
    """Device time of fn's kernels at cold L2, from torch.profiler:
    FLUSH_BYTES are copied between two scratch buffers before each of
    `reps` calls.  Counted are the kernel entries (never a copy or
    memset) whose names hold `match`: a wrapper's own kernel, not its
    output fill; with no `match`, every kernel of the call.  Returns ms
    per launch of the kernels matched, else ms per call: each kernel's
    total over its own count, times its launches per call (a library
    call of one or more kernels).

    A profile must hold `reps` flush copies or more, and each kernel's
    launches in a whole multiple of `reps`.  torch.profiler (2.11, CUDA
    12.8, on an H100) has dropped a single record (one flush copy, or
    one launch) from a session: such a profile is logged with its
    entries and taken again, up to `tries` times.  Only when every try
    lost records is one that lost at most one record of each kind
    taken, and said so; else this fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    src = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    fn()
    torch.cuda.synchronize()
    what = match or "the library call"
    near = None  # ms of the first profile that lost one record
    for t in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                dst.copy_(src)
                fn()
            torch.cuda.synchronize()
        entries = device_entries(prof)
        flushes = sum(n for k, _, n in entries
                      if k.startswith("Memcpy DtoD"))
        hits = [(us, n) for k, us, n in entries
                if not k.startswith(("Memcpy", "Memset"))
                and (match is None or match in k)]
        per_call = [max(1, round(n / reps)) for _, n in hits]
        if match:
            ms = sum(us for us, _ in hits) / 1e3 / max(
                1, sum(n for _, n in hits))
        else:
            ms = sum(us / n * m for (us, n), m in zip(hits, per_call)) / 1e3
        lost = [m * reps - n for (_, n), m in zip(hits, per_call)]
        if hits and flushes >= reps and not any(lost):
            return ms
        log(f"device time of {what}: profile {t + 1} of {tries} lost "
            f"records ({flushes} flush copies of {reps}, launches short "
            f"by {lost}); entries {[(k[:60], n) for k, _, n in entries]}")
        if near is None and hits and flushes >= reps - 1 \
                and all(0 <= x <= 1 for x in lost):
            near = ms
    if near is not None:
        log(f"device time of {what}: taken from a profile that lost one "
            "record")
        return near
    raise AssertionError(f"device time of {what}: {tries} profiles lost "
                         "more than one record each")


def kernel_case(hk, name, args) -> dict:
    """A kernel's call on recorded inputs, its plain version, the one
    library call of the same function (or None), a float64 reference
    (or None: compared exactly), and the bytes and operations its bound
    counts."""
    import torch

    counts = None
    if name == "dense_grid_sum":
        slot, values, total = args
        cols = list(values.unbind(1)) if hasattr(values, "unbind") \
            else list(values)
        n, a = slot.shape[0], len(cols)
        kern = lambda: hk.dense_grid_sum(slot, values, total)  # noqa: E731
        plain = lambda: hk.dense_grid_sum_plain(slot, values,  # noqa: E731
                                                total)
        # the yardstick sums a float32 stack built here, outside its
        # timed region
        stack = torch.stack([c.to(torch.float32) for c in cols], dim=1)
        counts = ((stack == 0) | (stack == 1)).all(dim=0)
        idx = torch.where((slot >= 0) & (slot < total), slot.long(),
                          torch.full_like(slot, total, dtype=torch.long))
        lib_out = torch.zeros(total + 1, a, device=slot.device)
        library = lambda: lib_out.index_add_(0, idx, stack)  # noqa: E731
        exact64 = lambda: torch.zeros(  # noqa: E731
            total + 1, a, dtype=torch.float64, device=slot.device
        ).index_add_(0, idx, stack.double())[:total]
        nbytes = n * 4 + sum(n * c.element_size() for c in cols) \
            + total * a * 4
        ops = n * a
        shape = (f"N {n}, total {total}, A {a}, columns "
                 f"{[str(c.dtype).replace('torch.', '') for c in cols]}")
    elif name == "bucketed_probe":
        dir2d, loc2d = args
        nb, tile = dir2d.shape
        cap = loc2d.shape[1]
        kern = lambda: hk.bucketed_probe(dir2d, loc2d)  # noqa: E731
        plain = lambda: hk.bucketed_probe_plain(dir2d, loc2d)  # noqa: E731
        lidx = loc2d.long()
        library = lambda: torch.gather(dir2d, 1, lidx)  # noqa: E731
        exact64 = None
        nbytes = nb * tile * 4 + 2 * nb * cap * 4
        ops = 0
        shape = f"dir2d {tuple(dir2d.shape)}, loc2d {tuple(loc2d.shape)}"
    elif name == "bit_unpack":
        packed, cap = args
        rows = packed.numel() // packed.shape[-1]
        kern = lambda: hk.bit_unpack(packed, cap)  # noqa: E731
        plain = lambda: hk.bit_unpack_plain(packed, cap)  # noqa: E731
        library = None  # no single PyTorch call unpacks bits
        exact64 = None
        nbytes = packed.numel() + rows * cap
        ops = 0
        shape = f"packed {tuple(packed.shape)}, cap {cap}"
    elif name == "dict_decode":
        codes, lut = args
        kern = lambda: hk.dict_decode(codes, lut)  # noqa: E731
        plain = lambda: hk.dict_decode_plain(codes, lut)  # noqa: E731
        idx = codes.to(torch.int64).reshape(-1)
        library = lambda: torch.index_select(lut, 0, idx)  # noqa: E731
        exact64 = None
        nbytes = (codes.numel() * codes.element_size()
                  + codes.numel() * lut.element_size()
                  + lut.numel() * lut.element_size())
        ops = 0
        shape = (f"codes {tuple(codes.shape)} {codes.dtype}, "
                 f"lut {lut.numel()}")
    else:
        loc2d, stack, tile = args
        nb, cap, a = stack.shape
        kern = lambda: hk.bucketed_groupby_sums(loc2d, stack,  # noqa: E731
                                                tile)
        plain = lambda: hk.bucketed_groupby_sums_plain(  # noqa: E731
            loc2d, stack, tile)
        flat = (loc2d.long() + torch.arange(nb, device=loc2d.device)[:, None]
                * tile).reshape(-1)
        vals = stack.reshape(nb * cap, a)
        lib_out = torch.zeros(nb * tile, a, device=stack.device)
        library = lambda: lib_out.index_add_(0, flat, vals)  # noqa: E731
        exact64 = lambda: torch.zeros(  # noqa: E731
            nb * tile, a, dtype=torch.float64, device=stack.device
        ).index_add_(0, flat, vals.double()).reshape(nb, tile, a)
        nbytes = nb * cap * 4 + nb * cap * a * 4 + nb * tile * a * 4
        ops = nb * cap * a
        counts = ((stack == 0) | (stack == 1)).all(dim=1).all(dim=0)
        garbage = float((stack == 0).all(dim=2).double().mean())
        shape = (f"nb {nb}, cap {cap}, a {a}, tile {tile}, garbage share "
                 f"{garbage!r}")
    return {"kern": kern, "plain": plain, "library": library,
            "exact64": exact64, "counts": counts, "nbytes": nbytes,
            "ops": ops, "shape": shape}


def hold_kernel(name, case, where: str = "") -> float:
    """Hold a kernel against its plain version on one case; returns
    max_abs_err, raises when they disagree."""
    import torch

    kern, plain, exact64 = case["kern"], case["plain"], case["exact64"]
    counts = case["counts"]
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = (got.to(torch.float64) - want.to(torch.float64)).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if exact64 is None:
        ok = bool(torch.equal(got, want))
        tol = "exact"
    else:
        # f32 sums of millions of rows in two different orders: the
        # plain version's one-hot product (K3's scatter) accumulates long
        # f32 runs and drifts by up to ~1e-3 of a column's magnitude at
        # 6M rows, so the kernel is held to the plain version at 1e-2 of
        # each column's largest value and, tightly, to a float64 sum of
        # the same inputs at 1e-4 of it
        ref = exact64()
        red = tuple(range(ref.dim() - 1))
        scale = ref.abs().amax(dim=red, keepdim=True) + 1.0
        k64 = float(((got.double() - ref).abs() / scale).max())
        p64 = float(((want.double() - ref).abs() / scale).max())
        # columns of 0/1 values are counts: exact
        exact = bool(torch.equal(got.double()[..., counts],
                                 ref[..., counts]))
        ok = bool(torch.all(err <= 1e-2 * scale)) and k64 <= 1e-4 and exact
        tol = (f"|kernel - plain| <= 1e-2·(1 + max|column|) and "
               f"|kernel - float64| <= 1e-4·(1 + max|column|), "
               f"{int(counts.sum())} count columns exact: {exact}; "
               f"vs float64: kernel {k64!r}, plain {p64!r}")
    log(f"check {name}{where}: {case['shape']}; max_abs_err {max_err!r} "
        f"({tol}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version"
                             f"{where}")
    return max_err


def kernel_report(hk, name, args, launches):
    if args is None:
        raise AssertionError(f"{name}: the main path never called it")
    case = kernel_case(hk, name, args)
    max_err = hold_kernel(name, case)
    kern, plain, library = case["kern"], case["plain"], case["library"]
    nbytes, ops = case["nbytes"], case["ops"]
    ms = time_ms(kern)
    plain_ms = time_ms(plain)
    library_ms = time_ms(library) if library is not None else None
    dev_ms = device_ms(kern, match=name)
    lib_dev_ms = device_ms(library) if library is not None else None
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    # "ms" is the wrapper's time per back-to-back call (= call_ms); the
    # bound is read against device_ms
    rep = {"name": name, "route": "cuda",
           "source": f"citus_tpu_torch/csrc/{name}.cu",
           "replaces": REPLACES[name], "launches": launches,
           "max_abs_err": max_err, "ms": ms, "call_ms": ms,
           "device_ms": dev_ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms, "library_device_ms": lib_dev_ms}
    log(f"time {name}: device {dev_ms!r} ms at cold L2 "
        f"({rep['bound_ms'] / dev_ms:.1%} of the bound), call {ms!r} ms, "
        f"plain {plain_ms!r} ms, library call {library_ms!r} ms, library "
        f"device {lib_dev_ms!r} ms, bound {rep['bound_ms']!r} ms "
        f"({rep['bound_by']})")
    return rep


def profile_query(sess, sql, top: int = 8) -> dict:
    """One more warm run under torch.profiler: device busy time (the sum
    of the device-side entries — kernels and copies — on one stream, so
    nothing overlaps), the idle share of the wall, and the heaviest
    device entries by name.  CPU-side operator entries are left out:
    their device time repeats their kernels'."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.execute(sql)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    events = device_entries(prof)
    busy_ms = sum(us for _, us, _ in events) / 1e3
    heavy = sorted(events, key=lambda e: e[1], reverse=True)[:top]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "top": [(k[:80], us / 1e3, n) for k, us, n in heavy]}
    log(f"  profile: wall {wall_ms!r} ms, device busy {busy_ms!r} ms, "
        f"idle share {out['device_idle_share']!r}")
    for name, ms, count in out["top"]:
        log(f"    {ms:10.4f} ms  x{count:<4d} {name}")
    return out


def link_ms(nbytes: int, pinned: bool, reps: int = 5) -> float:
    """Mean host→device copy time of `nbytes` (CUDA events)."""
    import torch

    host = torch.empty(max(1, nbytes), dtype=torch.uint8, pin_memory=pinned)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    host.to("cuda", non_blocking=pinned)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        host.to("cuda", non_blocking=pinned)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scan_modes(ct, data_dir, queries, checks, want, ident) -> None:
    """Phase 6: the first run of Q1 and the nullable query in each
    scan_pipeline mode, one fresh session (fresh feed cache) per mode on
    the same data_dir, in the order SCAN_MODES gives (the stripes are in
    the page cache for every mode).  Walls are host clock around
    Session.execute ending in a synchronize; the pipeline's phase walls
    are host clock too, so on the card its transfer and device-decode
    seconds are the time to enqueue the copies and kernels."""
    import torch

    from citus_tpu_torch.executor.hbm import accountant_for

    acc = accountant_for(data_dir)
    wire = {}
    for mode in SCAN_MODES:
        sess = rerun_connect(ct, data_dir, scan_pipeline=mode)
        for q in ("Q1", "nullable"):
            sess.executor.scan_stats.reset()
            t0 = time.perf_counter()
            res = sess.execute(queries[q])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            checks[q](res, want[q])
            snap = sess.executor.scan_stats.snapshot()
            prefetch = acc.live_bytes("prefetch")
            if prefetch:
                raise AssertionError(f"{mode} {q}: {prefetch} prefetch "
                                     "bytes live after the statement")
            if mode == "device" and not \
                    0 < snap["bytes_on_wire"] < snap["bytes_decoded"]:
                raise AssertionError(f"device {q}: wire bytes not below "
                                     f"decoded bytes: {snap}")
            if mode != "off" and snap["feeds_pipelined"] < 1:
                raise AssertionError(f"{mode} {q}: no pipelined feed")
            wire[mode, q] = snap
            log(f"scan {mode} {q}: first run {dt!r} s, matches numpy, "
                f"stats {json.dumps(snap)} ({ident})")
        del sess
    log(f"ledger {json.dumps(acc.snapshot())}, device budget "
        f"{acc.budget_bytes('cuda')} bytes")
    for q in ("Q1", "nullable"):
        for key in ("bytes_on_wire", "bytes_decoded"):
            n = wire["device", q][key]
            log(f"link {q} device-mode {key} {n}: pinned "
                f"{link_ms(n, True)!r} ms, pageable "
                f"{link_ms(n, False)!r} ms ({ident})")


# -- phase 8: the 22 TPC-H statements --------------------------------------

# the statements that plan recursively (subqueries, derived tables, WITH,
# views), and those whose answer numpy also checks
RECURSIVE_QUERIES = ("Q2", "Q4", "Q7", "Q8", "Q9", "Q11", "Q13", "Q15",
                     "Q16", "Q17", "Q18", "Q20", "Q21", "Q22")
# kernels that must launch on the recursive statements
TPCH22_KERNELS = ("dense_grid_sum", "bucketed_groupby_sums", "dict_decode")
PROFILED = ("Q4", "Q13", "Q18", "Q21")
# the statements whose card answers phase 8 holds against the CPU session
# on a second data_dir at CHECK_SF (their CPU runs over SF1 took most of
# the phase); the other statements without a numpy answer are held to the
# CPU session over SF1
# warm runs per statement: one (the script's time limit; the walls of
# the other phases take --reps)
TPCH22_WARM_REPS = 1
CHECK_SMALL = ("Q8", "Q9")
CHECK_SF = 0.1
TEMP_PREFIX = "__intermediate_"


def iso(day) -> str:
    import numpy as np

    return str(np.datetime64(int(day), "D"))


def numpy_q4(orders, li):
    """Orders of 1993 Q3 with a line received after its commit date
    (the semi join), counted per priority."""
    import numpy as np

    n_ord = len(orders["o_orderkey"])
    late = li["l_commitdate"] < li["l_receiptdate"]
    has = np.bincount((li["l_orderkey"][late] - 1) // 4,
                      minlength=n_ord) > 0
    od = orders["o_orderdate"]
    m = (od >= days("1993-07-01")) & (od < days("1993-10-01")) & has
    keys, cnt = np.unique(orders["o_orderpriority"][m].astype(str),
                          return_counts=True)
    return [(str(k), int(c)) for k, c in zip(keys, cnt)]


def numpy_q13(cust, orders):
    """Orders per customer (0 for customers without any: the LEFT
    join's null-extended rows), then customers per order count."""
    import re

    import numpy as np

    pat = re.compile("special.*requests", re.S)
    keep = np.fromiter((pat.search(c) is None for c in orders["o_comment"]),
                       dtype=bool, count=len(orders["o_comment"]))
    per = np.bincount(orders["o_custkey"][keep],
                      minlength=int(cust["c_custkey"].max()) + 1)
    dist = np.bincount(per[cust["c_custkey"]])
    rows = [(c, int(n)) for c, n in enumerate(dist) if n]
    return sorted(rows, key=lambda r: (-r[1], -r[0]))


def numpy_q18(cust, orders, li):
    """Orders whose lines sum past 212 units (the IN list over the
    high-cardinality GROUP BY), with their customer; sorted on the
    float32 prices the card compares (compute_dtype float32)."""
    import numpy as np

    n_ord = len(orders["o_orderkey"])
    qty = np.bincount((li["l_orderkey"] - 1) // 4,
                      weights=li["l_quantity"], minlength=n_ord)
    big = np.flatnonzero(qty > 212)
    price32 = orders["o_totalprice"].astype(np.float32)
    order = np.lexsort((orders["o_orderkey"][big], orders["o_orderdate"][big],
                        -price32[big]))[:100]
    rows = []
    for i in big[order]:
        c = int(orders["o_custkey"][i])
        rows.append((str(cust["c_name"][c - 1]), c,
                     int(orders["o_orderkey"][i]),
                     iso(orders["o_orderdate"][i]),
                     float(orders["o_totalprice"][i]), float(qty[i])))
    return rows


def numpy_q21(supp, nation, orders, li):
    """Late lines of Saudi suppliers in F orders where another supplier
    shipped a line of the order (the semi join) and no other supplier's
    line was late (the anti join), counted per supplier."""
    import numpy as np

    n_ord = len(orders["o_orderkey"])
    o = (li["l_orderkey"] - 1) // 4
    sk = li["l_suppkey"]
    late = li["l_receiptdate"] > li["l_commitdate"]
    top = np.iinfo(np.int64).max
    lo_all, hi_all = np.full(n_ord, top), np.full(n_ord, -1)
    np.minimum.at(lo_all, o, sk)
    np.maximum.at(hi_all, o, sk)
    lo_late, hi_late = np.full(n_ord, top), np.full(n_ord, -1)
    np.minimum.at(lo_late, o[late], sk[late])
    np.maximum.at(hi_late, o[late], sk[late])
    saudi_key = int(nation["n_nationkey"][
        nation["n_name"] == "SAUDI ARABIA"][0])
    saudi = np.zeros(int(supp["s_suppkey"].max()) + 1, dtype=bool)
    saudi[supp["s_suppkey"][supp["s_nationkey"] == saudi_key]] = True
    status_f = orders["o_orderstatus"] == "F"
    m = (late & saudi[sk] & status_f[o]
         & ((lo_all[o] != sk) | (hi_all[o] != sk))
         & (lo_late[o] == sk) & (hi_late[o] == sk))
    cnt = np.bincount(sk[m], minlength=len(saudi))
    rows = [(str(supp["s_name"][k - 1]), int(cnt[k]))
            for k in np.flatnonzero(cnt)]
    return sorted(rows, key=lambda r: (-r[1], r[0]))[:100]


def same_rows(got, want, ordered: bool, rtol: float = 1e-4) -> str | None:
    """None when `got` matches `want` (floats within rtol, everything
    else exact), else what differs.  An ordered answer may differ from
    the other side's order only where rows tie within rtol on the
    floats the ORDER BY compares: such a pair is matched as a multiset
    and said so."""

    def cell_eq(a, b) -> bool:
        if a is None or b is None:
            return a is None and b is None
        if isinstance(a, float) or isinstance(b, float):
            return close(a, b, rtol)
        return a == b

    def row_eq(g, w) -> bool:
        return len(g) == len(w) and all(cell_eq(a, b) for a, b in zip(g, w))

    got = [tuple(x.item() if hasattr(x, "item") else x for x in r)
           for r in got]
    want = [tuple(x.item() if hasattr(x, "item") else x for x in r)
            for r in want]
    if len(got) != len(want):
        return f"{len(got)} rows against {len(want)}"
    if ordered and all(row_eq(g, w) for g, w in zip(got, want)):
        return None
    # as multisets: rows bucketed by their exact cells, floats within rtol
    buckets: dict = {}
    for w in want:
        buckets.setdefault(tuple(None if isinstance(x, float) else x
                                 for x in w), []).append(w)
    for g in got:
        pool = buckets.get(tuple(None if isinstance(x, float) else x
                                 for x in g), [])
        hit = next((i for i, w in enumerate(pool) if row_eq(g, w)), None)
        if hit is None:
            return f"row {g} has no match"
        pool.pop(hit)
    if ordered:
        moved = [i for i, (g, w) in enumerate(zip(got, want))
                 if not row_eq(g, w)]
        log(f"    same rows; order differs at positions {moved}")
    return None


def check_no_temps(sess, acc, where: str) -> None:
    tables = [t for t in sess.catalog.tables if t.startswith(TEMP_PREFIX)]
    on_disk = [t for t in os.listdir(os.path.join(sess.data_dir, "tables"))
               if t.startswith(TEMP_PREFIX)]
    feeds = [k[0] for k in sess.executor.feed_cache._entries
             if k[0].startswith(TEMP_PREFIX)]
    prefetch = acc.live_bytes("prefetch")
    if tables or on_disk or feeds or prefetch:
        raise AssertionError(
            f"{where}: temps left in the catalog {tables}, the data_dir "
            f"{on_disk}, the feed cache {feeds}; prefetch bytes {prefetch}")


class TempTimer:
    """Wraps Session._store_result: the rows and host seconds of each
    intermediate result a statement stores."""

    def __init__(self, session_cls):
        self.cls, self.fn = session_cls, session_cls._store_result
        self.temps = []

    def install(self):
        timer = self

        def timed(sess, result, *args, **kw):
            t0 = time.perf_counter()
            name = timer.fn(sess, result, *args, **kw)
            timer.temps.append((result.row_count,
                                time.perf_counter() - t0))
            return name

        self.cls._store_result = timed

    def remove(self):
        self.cls._store_result = self.fn


def tpch22(ct, hk, data_dir, data, reps, ident) -> dict:
    """Phase 8.  Returns each kernel's launches over the 22 first runs."""
    import torch

    from citus_tpu_torch.executor.hbm import accountant_for
    from citus_tpu_torch.ingest import tpch
    from citus_tpu_torch.session import Session

    acc = accountant_for(data_dir)
    li, orders, cust = data["lineitem"], data["orders"], data["customer"]
    want_np = {"Q4": numpy_q4(orders, li), "Q13": numpy_q13(cust, orders),
               "Q18": numpy_q18(cust, orders, li),
               "Q21": numpy_q21(data["supplier"], data["nation"], orders,
                                li)}
    names = sorted(tpch.QUERIES, key=lambda q: int(q[1:]))
    timer = TempTimer(Session)
    timer.install()
    answers, first, profiles = {}, {}, {}
    hk.reset_launch_counts()
    try:
        for q in names:
            sql = tpch.QUERIES[q]
            sess = rerun_connect(ct, data_dir)
            del timer.temps[:]
            before = dict(hk.LAUNCHES)
            t0 = time.perf_counter()
            res = sess.execute(sql)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
            check_no_temps(sess, acc, q)
            launched = {n: hk.LAUNCHES[n] - before[n] for n in hk.KERNELS}
            temps = list(timer.temps)
            best, warm_launched, warm_retries = None, None, []
            for _ in range(min(reps, TPCH22_WARM_REPS)):
                before = dict(hk.LAUNCHES)
                t0 = time.perf_counter()
                again = sess.execute(sql)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
                warm_launched = {n: hk.LAUNCHES[n] - before[n]
                                 for n in hk.KERNELS}
                warm_retries.append(again.retries)
                check_no_temps(sess, acc, f"{q} warm")
            answers[q] = res.rows()
            first[q] = launched
            log(f"tpch22 {q}: {res.row_count} rows, first run {cold!r} s, "
                f"best of {min(reps, TPCH22_WARM_REPS)} warm {best!r} s, "
                f"retries {res.retries} "
                f"(warm {warm_retries}), launches first {launched} warm "
                f"{warm_launched}, temps (rows, host s) {temps} ({ident})")
            if q in want_np:
                diff = same_rows(answers[q], want_np[q], True)
                if diff:
                    raise AssertionError(f"{q} against numpy: {diff}")
                log(f"  {q} matches numpy")
            if q in PROFILED:
                profiles[q] = profile_query(sess, sql)
            del sess
    finally:
        timer.remove()
    for n in TPCH22_KERNELS:
        if not sum(first[q][n] for q in RECURSIVE_QUERIES):
            raise AssertionError(f"{n} never launched on the recursive "
                                 "TPC-H statements")
    # the other 18 statements: the card's SF1 answers against the CPU
    # session on the same data_dir, but for CHECK_SMALL, whose CPU runs
    # over SF1 took most of the phase: those run again, on the card and
    # on the CPU, on a second, smaller data_dir
    cpu = rerun_connect(ct, data_dir, device="cpu", compute_dtype="float32")
    differ = []
    for q in names:
        if q in want_np or q in CHECK_SMALL:
            continue  # held against numpy above, or at CHECK_SF below
        t0 = time.perf_counter()
        sql = tpch.QUERIES[q]
        want = cpu.execute(sql).rows()
        dt = time.perf_counter() - t0
        check_no_temps(cpu, acc, f"{q} on the CPU")
        diff = same_rows(answers[q], want, "order by" in sql.lower())
        if diff:
            differ.append(q)
            log(f"  {q}: card against CPU: {diff}; card {answers[q][:5]}, "
                f"CPU {want[:5]}")
        else:
            log(f"  {q} matches the CPU session ({dt!r} s on the CPU)")
    cpu.close()
    t0 = time.perf_counter()
    small_dir = data_dir + "_check"
    card = rerun_connect(ct, small_dir)
    tpch.load_tables(card, tpch.generate_tables(CHECK_SF, seed=1))
    cpu = rerun_connect(ct, small_dir, device="cpu", compute_dtype="float32")
    log(f"tpch22 check data_dir SF{CHECK_SF}: loaded in "
        f"{time.perf_counter() - t0!r} s")
    for q in CHECK_SMALL:
        sql = tpch.QUERIES[q]
        t0 = time.perf_counter()
        got = card.execute(sql).rows()
        t1 = time.perf_counter()
        want = cpu.execute(sql).rows()
        t2 = time.perf_counter()
        check_no_temps(cpu, accountant_for(small_dir), f"{q} on the CPU")
        diff = same_rows(got, want, "order by" in sql.lower())
        if diff:
            differ.append(q)
            log(f"  {q}: card against CPU at SF{CHECK_SF}: {diff}; card "
                f"{got[:5]}, CPU {want[:5]}")
        else:
            log(f"  {q} matches the CPU session at SF{CHECK_SF} (card "
                f"{t1 - t0!r} s, CPU {t2 - t1!r} s)")
    card.close()
    cpu.close()
    shutil.rmtree(small_dir, ignore_errors=True)
    if differ:
        raise AssertionError(f"card against CPU: {differ} differ")
    return {n: sum(first[q][n] for q in names) for n in hk.KERNELS}


# -- phase 9: windows, sketches, prepared statements, EXPLAIN, DDL ---------

W1_SQL = ("select o_orderkey, o_custkey, rank() over (partition by "
          "o_custkey order by o_totalprice desc, o_orderkey) as rk, "
          "row_number() over (partition by o_custkey order by o_totalprice "
          "desc, o_orderkey) as rn from orders order by o_orderkey limit 100")
W2_WHERE = "l_shipdate between date '1995-06-01' and date '1995-06-30'"
W2_SQL = ("select l_orderkey, l_linenumber, sum(l_extendedprice) over "
          "(partition by l_orderkey order by l_linenumber), count(*) over "
          "(partition by l_orderkey order by l_linenumber), "
          "max(l_quantity) over (partition by l_orderkey) from lineitem "
          f"where {W2_WHERE}")
W2N_SQL = ("select l_orderkey, l_linenumber, sum(l_discount) over "
           "(partition by l_orderkey order by l_linenumber), count(*) over "
           "(partition by l_orderkey order by l_linenumber), "
           "max(l_quantity) over (partition by l_orderkey) from "
           f"lineitem_nullable where {W2_WHERE}")
W3_SQL = ("select o_orderkey, c_nationkey, dense_rank() over (partition by "
          "c_nationkey order by o_orderdate) from orders, customer "
          "where o_custkey = c_custkey order by o_orderkey limit 200")
S1_SQL = ("select l_returnflag, l_linestatus, "
          "approx_count_distinct(l_partkey) from lineitem "
          "group by l_returnflag, l_linestatus order by 1, 2")
S2_SQL = ("select l_shipmode, approx_percentile(l_extendedprice, 0.5), "
          "approx_percentile(l_extendedprice, 0.99) from lineitem "
          "group by l_shipmode order by l_shipmode")
S3_SQL = "select approx_count_distinct(o_custkey) from orders"
P1_PREPARE = ("prepare p1 as select o_orderkey, o_custkey, o_totalprice "
              "from orders where o_orderkey = $1")
P1_KEYS = 20
# above one SF1 orders shard (1,500,000 rows over 8 shards): a prepared
# lookup's $n prunes to one shard, which the router scans on the host
# below this ceiling (the point index serves literal keys only, in both
# packages); the default 65,536 would send it to the card
P1_FAST_PATH_MAX_ROWS = 1 << 18
P2_DATES = ("1998-09-02", "1998-08-01", "1998-11-01")
# one DDSketch bucket: the factor γ = 1.02 between neighbouring keys
ONE_BUCKET = 0.021
PHASE9_DENSE = ("dense_grid_sum", "bucketed_groupby_sums")


def q1_body() -> str:
    from citus_tpu_torch.ingest import tpch

    return tpch.QUERIES["Q1"].split("order by")[0]


def numpy_w1(orders):
    """rank / row_number over (partition by o_custkey order by
    o_totalprice desc, o_orderkey) at float32 prices (the card's compute
    dtype), rows of the 100 smallest order keys."""
    import numpy as np

    ok, ck = orders["o_orderkey"], orders["o_custkey"]
    tp = orders["o_totalprice"].astype(np.float32)
    order = np.lexsort((ok, -tp, ck))
    sck, stp, sok = ck[order], tp[order], ok[order]
    idx = np.arange(len(ok))
    part = np.r_[True, sck[1:] != sck[:-1]]
    peer = part | np.r_[True, (stp[1:] != stp[:-1]) | (sok[1:] != sok[:-1])]
    part_start = np.maximum.accumulate(np.where(part, idx, 0))
    peer_start = np.maximum.accumulate(np.where(peer, idx, 0))
    rk = np.empty_like(idx)
    rn = np.empty_like(idx)
    rk[order] = peer_start - part_start + 1
    rn[order] = idx - part_start + 1
    first = np.argsort(ok, kind="stable")[:100]
    return [(int(ok[i]), int(ck[i]), int(rk[i]), int(rn[i])) for i in first]


def normalize_plan(lines) -> list:
    """EXPLAIN lines without what the session's device decides: the
    bucketed tags (on for a CUDA plan) and the pipelined scan's mode."""
    out = []
    for x in lines:
        x = str(x).replace(", bucketed probe", "").replace(
            ", bucketed group-by", "")
        if x.strip().startswith("pipelined scan:"):
            x = "  pipelined scan: <mode>"
        out.append(x)
    return out


def phase9(ct, hk, data_dir, data, reps, ident) -> dict:
    """Phase 9.  Returns each kernel's launches over the phase."""
    import numpy as np
    import torch

    from citus_tpu_torch.executor.hbm import accountant_for
    from citus_tpu_torch.ops.sketches import dd_bucket, dd_bucket_torch

    t_phase = time.perf_counter()
    acc = accountant_for(data_dir)
    li, orders = data["lineitem"], data["orders"]
    cpu = rerun_connect(ct, data_dir, device="cpu", compute_dtype="float32",
                        fast_path_max_rows=P1_FAST_PATH_MAX_ROWS)
    first_launches: dict = {}
    failures: list = []
    hk.reset_launch_counts()

    def sync():
        torch.cuda.synchronize()

    def run(name, sql, setup=(), warm=True, **settings):
        """`sql` in a fresh cuda session (after `setup`): the first run,
        then the best of `reps` warm runs."""
        sess = rerun_connect(ct, data_dir, **settings)
        for st in setup:
            sess.execute(st)
        pc = sess.executor.plan_cache
        before = dict(hk.LAUNCHES)
        t0 = time.perf_counter()
        res = sess.execute(sql)
        sync()
        first = time.perf_counter() - t0
        check_no_temps(sess, acc, name)
        launched = {n: hk.LAUNCHES[n] - before[n] for n in hk.KERNELS}
        first_launches[name] = launched
        best, retries = None, []
        for _ in range(reps if warm else 0):
            t0 = time.perf_counter()
            again = sess.execute(sql)
            sync()
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
            retries.append(again.retries)
            check_no_temps(sess, acc, f"{name} warm")
        log(f"phase9 {name}: {res.row_count} rows, first run {first!r} s, "
            f"best of {len(retries)} warm {best!r} s, retries "
            f"{res.retries} (warm {retries}), launches first {launched}, "
            f"fast_path {res.fast_path}, plan cache hits {pc.hits} misses "
            f"{pc.misses} ({ident})")
        return res, sess

    def against_cpu(name, got, sql, rtol=1e-4, setup=()):
        for st in setup:
            cpu.execute(st)
        t0 = time.perf_counter()
        want = cpu.execute(sql).rows()
        check_no_temps(cpu, acc, f"{name} on the CPU")
        diff = same_rows(got, want, "order by" in sql.lower(), rtol)
        if diff:
            failures.append(name)
            log(f"  {name}: card against CPU: {diff}; card {got[:3]}, "
                f"CPU {want[:3]}")
        else:
            log(f"  {name} matches the CPU session ({time.perf_counter() - t0!r}"
                " s on the CPU)")
        return want

    # W1–W3: windows
    res, _ = run("W1", W1_SQL)
    got = res.rows()
    against_cpu("W1", got, W1_SQL)
    diff = same_rows([tuple(int(x) for x in r) for r in got],
                     numpy_w1(orders), True)
    if diff:
        failures.append("W1 numpy")
        log(f"  W1 against numpy: {diff}")
    else:
        log("  W1 matches numpy's rank")
    for name, sql in (("W2", W2_SQL), ("W2 nullable", W2N_SQL),
                      ("W3", W3_SQL)):
        res, _ = run(name, sql)
        against_cpu(name, res.rows(), sql)

    # S1–S3: sketches
    res, _ = run("S1", S1_SQL)
    against_cpu("S1", res.rows(), S1_SQL, rtol=0.0)
    for rf, ls, est in res.rows():
        m = (li["l_returnflag"] == rf) & (li["l_linestatus"] == ls)
        exact = len(np.unique(li["l_partkey"][m]))
        log(f"  S1 {rf}{ls}: estimate {est}, exact {exact}, error "
            f"{(est - exact) / exact!r}")
        if abs(est - exact) > 0.05 * exact:
            failures.append("S1 error")
    res, _ = run("S2", S2_SQL)
    want = against_cpu("S2", res.rows(), S2_SQL, rtol=ONE_BUCKET)
    same = sum(1 for g, w in zip(res.rows(), want)
               for a, b in zip(g[1:], w[1:]) if a == b)
    log(f"  S2: {same} of {2 * len(want)} percentiles equal to the CPU's "
        "bit for bit")
    price = li["l_extendedprice"]
    host = dd_bucket(price.astype(np.float64))
    f32 = torch.from_numpy(price.astype(np.float32))
    card = dd_bucket_torch(f32.cuda()).cpu().numpy()
    cpu32 = dd_bucket_torch(f32).numpy()
    log(f"  DDSketch buckets of l_extendedprice at float32: card against "
        f"float64 {int((card != host).sum())} of {len(host)} differ, card "
        f"against CPU float32 {int((card != cpu32).sum())} ({ident})")
    res, _ = run("S3", S3_SQL)
    against_cpu("S3", res.rows(), S3_SQL, rtol=0.0)
    exact = len(np.unique(orders["o_custkey"]))
    est = res.rows()[0][0]
    log(f"  S3: estimate {est}, exact {exact}, error "
        f"{(est - exact) / exact!r}")
    if abs(est - exact) > 0.05 * exact:
        failures.append("S3 error")

    # P1: the prepared point lookup, fast path on, then off (on the card)
    rng = np.random.default_rng(9)
    pick = rng.choice(len(orders["o_orderkey"]), P1_KEYS, replace=False)
    for mode, on in (("on", True), ("off", False)):
        sess = rerun_connect(ct, data_dir,
                             fast_path_max_rows=P1_FAST_PATH_MAX_ROWS,
                             enable_fast_path_router=on)
        sess.execute(P1_PREPARE)
        walls, fast, before = [], [], dict(hk.LAUNCHES)
        for i in pick:
            key = int(orders["o_orderkey"][i])
            t0 = time.perf_counter()
            res = sess.execute(f"execute p1({key})")
            sync()
            walls.append(time.perf_counter() - t0)
            fast.append(res.fast_path)
            want = [(key, int(orders["o_custkey"][i]),
                     float(orders["o_totalprice"][i]))]
            diff = same_rows(res.rows(), want, True)
            if diff:
                failures.append(f"P1 {mode} {key}")
                log(f"  P1 {mode} key {key} against numpy: {diff}")
        launched = {n: hk.LAUNCHES[n] - before[n] for n in hk.KERNELS}
        first_launches[f"P1 {mode}"] = launched
        pc = sess.executor.plan_cache
        log(f"phase9 P1 fast path {mode}: {P1_KEYS} keys match numpy; "
            f"first {walls[0]!r} s, best {min(walls[1:])!r} s, median "
            f"{sorted(walls)[len(walls) // 2]!r} s; fast_path {set(fast)}; "
            f"launches {launched}; plan cache hits {pc.hits} misses "
            f"{pc.misses} ({ident})")
        if set(fast) != {on}:
            failures.append(f"P1 fast path {mode}: {fast}")
        check_no_temps(sess, acc, f"P1 {mode}")
    # the literal form rides the point index on the host
    sess = rerun_connect(ct, data_dir)
    walls = []
    for i in pick[:5]:
        key = int(orders["o_orderkey"][i])
        t0 = time.perf_counter()
        res = sess.execute("select o_orderkey, o_custkey, o_totalprice "
                           f"from orders where o_orderkey = {key}")
        walls.append(time.perf_counter() - t0)
        if not res.fast_path or len(res.rows()) != 1:
            failures.append(f"P1 literal {key}")
    lookups = sess.stats.counters.snapshot()["point_index_lookups"]
    log(f"phase9 P1 literal: point index lookups "
        f"{lookups}, walls {walls!r} ({ident})")
    if lookups != 5:
        failures.append("P1 literal: point index unused")

    # P2: prepared Q1, three EXECUTEs through one PlanCompiler
    p2 = "prepare p2 as " + q1_body().replace(
        "date '1998-12-01' - interval '90' day", "$1")
    sess = rerun_connect(ct, data_dir)
    sess.execute(p2)
    cpu.execute(p2)
    before = dict(hk.LAUNCHES)
    pc = sess.executor.plan_cache
    for d in P2_DATES:
        t0 = time.perf_counter()
        res = sess.execute(f"execute p2(date '{d}')")
        sync()
        dt = time.perf_counter() - t0
        log(f"phase9 P2 {d}: {res.row_count} rows, {dt!r} s, retries "
            f"{res.retries}, plan cache hits {pc.hits} misses {pc.misses}")
        against_cpu(f"P2 {d}", res.rows(), f"execute p2(date '{d}')")
        check_no_temps(sess, acc, f"P2 {d}")
    first_launches["P2"] = {n: hk.LAUNCHES[n] - before[n]
                            for n in hk.KERNELS}
    log(f"  P2: launches {first_launches['P2']}, PlanCompilers built "
        f"{pc.misses} ({ident})")
    if pc.misses > 1:
        failures.append(f"P2 built {pc.misses} PlanCompilers")

    # E1: EXPLAIN, against the CPU session's lines
    sess = rerun_connect(ct, data_dir,
                         fast_path_max_rows=P1_FAST_PATH_MAX_ROWS)
    sess.execute(P1_PREPARE)
    cpu.execute("deallocate all")
    cpu.execute(P1_PREPARE)
    key = int(orders["o_orderkey"][pick[0]])
    from citus_tpu_torch.ingest import tpch

    plans = {}
    for name, sql in (("Q3", tpch.QUERIES["Q3"]),
                      ("P1", f"execute p1({key})"), ("W1", W1_SQL)):
        lines = [str(r[0]) for r in sess.execute(f"explain {sql}").rows()]
        want = [str(r[0]) for r in cpu.execute(f"explain {sql}").rows()]
        plans[name] = lines
        log(f"phase9 E1 EXPLAIN {name}:")
        for x in lines:
            log(f"    {x}")
        if normalize_plan(lines) != normalize_plan(want):
            failures.append(f"E1 {name}")
            log(f"  E1 {name}: CPU session's lines {want}")
    if not any("WindowAgg" in x for x in plans["W1"]) or not any(
            "Fast Path Router" in x for x in plans["P1"]) or not any(
            "Generic Plan: 1 parameter" in x for x in plans["P1"]):
        failures.append("E1 tags")

    # D1, last: a view over Q1, then ALTER / DROP on supplier and a table
    # of its own
    sess = rerun_connect(ct, data_dir)
    sess.execute("create view q1v as " + q1_body())
    vsql = "select * from q1v order by l_returnflag, l_linestatus"
    res, _ = run("D1 view", vsql)
    against_cpu("D1 view", res.rows(), vsql)
    sess.execute("drop view q1v")
    sess.execute("alter table supplier add column s_extra bigint")
    n_supp = len(data["supplier"]["s_suppkey"])
    for mode in ("off", "host", "device"):
        res, _ = run(f"D1 {mode}", "select count(s_extra), count(*) "
                     "from supplier", warm=False, scan_pipeline=mode)
        if res.rows() != [(0, n_supp)]:
            failures.append(f"D1 {mode}: {res.rows()}")
    sess.execute("alter table supplier drop column s_extra")
    sess.execute("create table phase9_t (a bigint, b double precision)")
    sess.execute("select create_distributed_table('phase9_t', 'a', 4)")
    sess.execute("drop table phase9_t")
    if sess.catalog.has_table("phase9_t") or os.path.exists(
            os.path.join(data_dir, "tables", "phase9_t")):
        failures.append("D1 drop table")
    log(f"phase9 D1: view, ALTER ADD/DROP COLUMN through each scan mode, "
        f"DROP TABLE done ({ident})")

    launched = dict(hk.LAUNCHES)
    log(f"phase9: {time.perf_counter() - t_phase!r} s, launches {launched}")
    if not launched["dict_decode"]:
        failures.append("dict_decode never launched")
    if not sum(first_launches[q][n] for q in ("S1", "S2", "P2")
               for n in PHASE9_DENSE):
        failures.append("neither K1 nor K3 launched on S1, S2 and P2")
    if failures:
        raise AssertionError(f"phase 9: {failures}")
    return launched


# -- phase 10: the write path --------------------------------------------

PHASE10_KERNELS = ("dense_grid_sum", "bucketed_groupby_sums", "bit_unpack",
                   "dict_decode")
NULL_CUSTKEYS = 1000   # U1: o_totalprice set to NULL for these customers
MERGE_ROWS = 20_000    # M1: half of them match an existing order
COPY_ROWS = 100_000    # C1
READ_BACK = ("select o_orderpriority, count(*), count(o_totalprice), "
             "sum(o_totalprice) from orders_w group by o_orderpriority "
             "order by o_orderpriority")


class OrdersModel:
    """numpy's own copy of orders_w: the same writes replayed on arrays
    (float64, as the port's UPDATE computes them on the host)."""

    def __init__(self, orders):
        import numpy as np

        self.key = orders["o_orderkey"].astype(np.int64)
        self.cust = orders["o_custkey"].astype(np.int64)
        self.status = np.asarray(orders["o_orderstatus"], dtype=object)
        self.price = orders["o_totalprice"].astype(np.float64)
        self.date = orders["o_orderdate"].astype(np.int64)
        self.prio = np.asarray(orders["o_orderpriority"], dtype=object)
        self.valid = np.ones(len(self.key), dtype=bool)
        self.alive = np.ones(len(self.key), dtype=bool)

    def append(self, key, cust, status, price, date, prio):
        import numpy as np

        n = len(key)
        self.key = np.concatenate([self.key, key])
        self.cust = np.concatenate([self.cust, cust])
        self.status = np.concatenate([self.status,
                                      np.asarray(status, dtype=object)])
        self.price = np.concatenate([self.price, price])
        self.date = np.concatenate([self.date, date])
        self.prio = np.concatenate([self.prio,
                                    np.asarray(prio, dtype=object)])
        self.valid = np.concatenate([self.valid, np.ones(n, dtype=bool)])
        self.alive = np.concatenate([self.alive, np.ones(n, dtype=bool)])

    def read_back(self):
        rows = []
        for p in sorted(set(self.prio[self.alive])):
            g = self.alive & (self.prio == p)
            v = g & self.valid
            rows.append((p, int(g.sum()), int(v.sum()),
                         float(self.price[v].sum())))
        return rows


def phase10(ct, hk, data_dir, data, reps, ident) -> dict:
    """Phase 10.  Returns each kernel's launches over the phase."""
    import numpy as np
    import torch

    from citus_tpu_torch.catalog.distribution import (
        hash_token, shard_index_for_token_ranges)
    from citus_tpu_torch.executor.insert_select import execute_insert_select
    from citus_tpu_torch.ingest import tpch
    from citus_tpu_torch.ingest.copy_from import _ingest_batch
    from citus_tpu_torch.sql import parse
    from citus_tpu_torch.utils.faultinjection import InjectedFault, inject

    t_phase = time.perf_counter()
    orders, li = data["orders"], data["lineitem"]
    model = OrdersModel(orders)
    failures: list = []
    hk.reset_launch_counts()

    def connect():
        return rerun_connect(ct, data_dir, scan_pipeline="device",
                             compute_dtype="float32")

    def step(name, fn, check=None):
        """One step in a fresh cuda session, then its check on the same
        session: the step's wall (the check outside it), rows affected,
        mode, each kernel's launches in the step and, apart, in its check
        go to the log."""
        before = dict(hk.LAUNCHES)
        sess = connect()
        t0 = time.perf_counter()
        affected, mode = fn(sess)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        mid = dict(hk.LAUNCHES)
        if check is not None:
            check(sess)
        launched = {n: mid[n] - before[n] for n in hk.KERNELS}
        checked = {n: hk.LAUNCHES[n] - mid[n] for n in hk.KERNELS}
        log(f"phase10 {name}: rows affected {affected}, wall {dt!r} s, "
            f"mode {mode}, launches in the step {launched}, in its check "
            f"{checked} ({ident})")
        return sess

    def expect(name, got, want):
        if got != want:
            failures.append(name)
            log(f"  {name}: got {got}, numpy {want}")

    def check_read_back(name, sess):
        got = sess.execute(READ_BACK).rows()
        want = model.read_back()
        ok = len(got) == len(want) and all(
            g[0] == w[0] and int(g[1]) == w[1] and int(g[2]) == w[2]
            and close(g[3], w[3]) for g, w in zip(got, want))
        if not ok:
            failures.append(f"{name} read-back")
            log(f"  {name} read-back: card {got}, numpy {want}")
        return got

    def changed_shards(sess, table, before):
        man = sess.store.manifest(table)["shards"]
        return sorted(s for s in man if man[s] != before.get(s))

    # I1: colocated INSERT … SELECT
    ddl = tpch.SCHEMAS["orders"]
    boot = connect()
    for t in ("orders_w", "orders_by_cust"):
        boot.execute(ddl.replace("create table orders",
                                 f"create table {t}"))
    boot.create_distributed_table("orders_w", "o_orderkey", 8,
                                  colocate_with="orders")
    boot.create_distributed_table("orders_by_cust", "o_custkey", 8)
    boot.execute("create table li_agg (l_orderkey bigint, qty double "
                 "precision, n bigint)")
    boot.create_distributed_table("li_agg", "l_orderkey", 8)

    def insert_select(sql, want_mode, want_n):
        def run(sess):
            res, mode = execute_insert_select(sess, parse(sql)[0])
            n = int(res.rows()[0][0])
            expect(f"{sql[:30]} mode", mode, want_mode)
            expect(f"{sql[:30]} rows", n, want_n)
            return n, mode
        return run

    n_orders = len(model.key)
    step("I1", insert_select(
        "insert into orders_w select * from orders", "colocated",
        n_orders), lambda sess: check_read_back("I1", sess))

    # I2: high-cardinality INSERT … SELECT (K3, K5 on the cold scan)
    keys, cnt, qty = numpy_high_card(li)

    def check_i2(sess):
        res = sess.execute("select l_orderkey, n, qty from li_agg")
        try:
            check_high_card(res, (keys, cnt, qty))
        except AssertionError as e:
            failures.append("I2")
            log(f"  I2 against numpy: {e}")

    step("I2", insert_select(
        "insert into li_agg select l_orderkey, sum(l_quantity), count(*) "
        "from lineitem group by l_orderkey", "repartition", len(keys)),
        check_i2)

    # I3: host-routed repartition INSERT … SELECT
    def check_i3(sess):
        mins = sess.catalog.shard_mins("orders_by_cust")
        for i, sh in enumerate(sess.catalog.table_shards("orders_by_cust")):
            vals, _m, n = sess.store.read_shard(
                "orders_by_cust", sh.shard_id, ["o_custkey"])
            idx = shard_index_for_token_ranges(
                hash_token(vals["o_custkey"].astype(np.int64)), mins)
            if n and not bool((np.asarray(idx) == i).all()):
                failures.append("I3 routing")
                log(f"  I3: shard {sh.shard_id} holds rows of other "
                    "shards")

    step("I3", insert_select(
        "insert into orders_by_cust select * from orders", "repartition",
        n_orders), check_i3)

    # U1: UPDATE and DELETE
    d93, d94 = days("1993-01-01"), days("1994-01-01")
    point_key = int(model.key[n_orders // 2])
    rng = np.random.default_rng(10)
    null_custs = rng.choice(np.unique(model.cust), NULL_CUSTKEYS,
                            replace=False)
    u1 = [
        ("update orders_w set o_totalprice = o_totalprice * 1.1 "
         f"where o_orderdate < date '1993-01-01'",
         model.alive & (model.date < d93), "scale"),
        (f"update orders_w set o_totalprice = o_totalprice + 1 "
         f"where o_orderkey = {point_key}",
         model.alive & (model.key == point_key), "plus1"),
        ("update orders_w set o_totalprice = null where o_custkey in ("
         + ", ".join(str(int(c)) for c in null_custs) + ")",
         None, "null"),
        ("delete from orders_w where o_orderstatus = 'F' "
         "and o_orderdate >= date '1994-01-01'", None, "delete"),
    ]

    def run_u1(sess):
        total = []
        for sql, _m, kind in u1:
            if kind == "null":
                m = model.alive & np.isin(model.cust, null_custs)
            elif kind == "delete":
                m = model.alive & (model.status == "F") & \
                    (model.date >= d94)
            else:
                m = _m
            before = {k: list(v) for k, v in sess.store.manifest(
                "orders_w")["shards"].items()}
            got = int(sess.execute(sql).rows()[0][0])
            expect(f"U1 {kind} count", got, int(m.sum()))
            total.append(got)
            if kind == "scale":
                model.price[m] = model.price[m] * 1.1
            elif kind == "plus1":
                model.price[m] = model.price[m] + 1
                expect("U1 point shards touched",
                       len(changed_shards(sess, "orders_w", before)), 1)
            elif kind == "null":
                model.valid[m] = False
            else:
                model.alive[m] = False
        return total, "host"

    step("U1", run_u1, lambda sess: check_read_back("U1", sess))

    # T1: transactions
    def run_t1(sess):
        y95 = model.alive & (model.date >= days("1995-01-01")) & \
            (model.date < days("1996-01-01"))
        pipelined = sess.executor.scan_stats.snapshot()["feeds_pipelined"]
        sess.execute("begin")
        got = int(sess.execute(
            "delete from orders_w where o_orderdate >= date '1995-01-01' "
            "and o_orderdate < date '1996-01-01'").rows()[0][0])
        expect("T1 delete count", got, int(y95.sum()))
        inside = int(sess.execute(
            "select count(*) from orders_w").rows()[0][0])
        expect("T1 sees its delete", inside,
               int(model.alive.sum() - y95.sum()))
        cached = [k for k in sess.executor.feed_cache._entries
                  if k[0] == "orders_w"]
        expect("T1 feed cache bypassed", cached, [])
        expect("T1 pipeline bypassed",
               sess.executor.scan_stats.snapshot()["feeds_pipelined"],
               pipelined)
        sess.execute("rollback")
        after = int(sess.execute(
            "select count(*) from orders_w").rows()[0][0])
        expect("T1 rollback", after, int(model.alive.sum()))
        new_keys = [4 * n_orders + 10 + 4 * i for i in range(3)]
        sess.execute("begin")
        sess.execute(
            "insert into orders_w values " + ", ".join(
                f"({k}, 7, 'O', {100.0 + i}, date '1997-01-0{i + 1}', "
                f"'1-URGENT', 'Clerk#000000007', 0, 'txn')"
                for i, k in enumerate(new_keys)))
        sess.execute(f"update orders_w set o_totalprice = 555.5 "
                     f"where o_orderkey = {new_keys[0]}")
        sess.execute("commit")
        model.append(np.asarray(new_keys, dtype=np.int64),
                     np.full(3, 7, np.int64), ["O"] * 3,
                     np.asarray([555.5, 101.0, 102.0]),
                     np.asarray([days(f"1997-01-0{i + 1}")
                                 for i in range(3)], np.int64),
                     ["1-URGENT"] * 3)
        return [got, 3], "transaction"

    step("T1", run_t1)
    fresh = connect()
    got = fresh.execute("select o_orderkey, o_totalprice from orders_w "
                        "where o_comment = 'txn' order by o_orderkey")
    expect("T1 committed rows", [(int(k), float(v)) for k, v in got.rows()],
           [(int(k), float(v)) for k, v in zip(model.key[-3:],
                                               model.price[-3:])])

    # M1: MERGE from a reference table, half of its rows matching
    alive_keys = model.key[model.alive]
    matched = rng.choice(alive_keys, MERGE_ROWS // 2, replace=False)
    fresh_keys = 4 * np.arange(MERGE_ROWS // 2, dtype=np.int64) + 2
    mkeys = np.concatenate([matched, fresh_keys])
    mcust = rng.integers(1, 1000, MERGE_ROWS).astype(np.int64)
    mprice = np.round(rng.random(MERGE_ROWS) * 1000, 2)
    fresh.execute("create table merge_src (k bigint, cust bigint, "
                  "price double precision)")
    fresh.create_reference_table("merge_src")
    _ingest_batch(fresh, "merge_src", ["k", "cust", "price"],
                  [mkeys, mcust, mprice], pre_typed=True)

    def run_m1(sess):
        got = int(sess.execute(
            "merge into orders_w t using merge_src s on t.o_orderkey = s.k "
            "when matched then update set o_totalprice = s.price "
            "when not matched then insert (o_orderkey, o_custkey, "
            "o_orderstatus, o_totalprice, o_orderdate, o_orderpriority, "
            "o_clerk, o_shippriority, o_comment) values (s.k, s.cust, 'O', "
            "s.price, date '1998-01-01', '5-LOW', 'Clerk#000000001', 0, "
            "'merged')").rows()[0][0])
        expect("M1 updated + inserted", got, MERGE_ROWS)
        pos = {int(k): i for i, k in enumerate(model.key)
               if model.alive[i]}
        for k, p in zip(matched, mprice[:MERGE_ROWS // 2]):
            i = pos[int(k)]
            model.price[i], model.valid[i] = p, True
        half = MERGE_ROWS // 2
        model.append(fresh_keys, mcust[half:], ["O"] * half,
                     mprice[half:], np.full(half, days("1998-01-01")),
                     ["5-LOW"] * half)
        inserted = int(sess.execute(
            "select count(*) from orders_w where o_comment = 'merged'"
        ).rows()[0][0])
        expect("M1 inserted", inserted, half)
        return [got - inserted, inserted], "host"

    step("M1", run_m1, lambda sess: check_read_back("M1", sess))
    fresh.execute("drop table merge_src")

    # C1: COPY … FROM a CSV file the script writes
    ckeys = 4 * np.arange(COPY_ROWS, dtype=np.int64) + 3
    ccust = rng.integers(1, 1000, COPY_ROWS).astype(np.int64)
    cprice = np.round(rng.random(COPY_ROWS) * 1000, 2)
    cdate = rng.integers(days("1992-01-01"), days("1998-08-02"), COPY_ROWS)
    prios = np.asarray(["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                        "5-LOW"], dtype=object)
    cprio = prios[rng.integers(0, 5, COPY_ROWS)]
    csv_path = os.path.join(os.path.dirname(data_dir), "phase10_copy.csv")
    iso = np.datetime_as_string(cdate.astype("datetime64[D]"))
    with open(csv_path, "w") as f:
        for i in range(COPY_ROWS):
            f.write(f"{ckeys[i]},{ccust[i]},F,{float(cprice[i])!r},{iso[i]},"
                    f"{cprio[i]},Clerk#000000002,0,copied row {i}\n")

    def run_c1(sess):
        got = int(sess.execute(
            f"copy orders_w from '{csv_path}' with (format csv)"
        ).rows()[0][0])
        expect("C1 copied", got, COPY_ROWS)
        model.append(ckeys, ccust, ["F"] * COPY_ROWS, cprice, cdate, cprio)
        return got, "copy"

    sess = step("C1", run_c1, lambda sess: check_read_back("C1", sess))
    os.unlink(csv_path)

    # R1: a COMMIT that dies after its commit record, recovered at open
    lsn0 = int(sess.store.change_log.last_lsn())

    def run_r1(sess):
        # crash semantics: no statement retry envelope, so the COMMIT
        # raises and the next session's recovery at open resolves it
        sess.execute("set max_statement_retries = 0")
        m = model.alive & (model.prio == "2-HIGH") & model.valid
        sess.execute("begin")
        got = int(sess.execute(
            "update orders_w set o_totalprice = o_totalprice * 2 "
            "where o_orderpriority = '2-HIGH' and o_totalprice is not null"
        ).rows()[0][0])
        expect("R1 update count", got, int(m.sum()))
        try:
            with inject("txn.apply", require_fired=True):
                sess.execute("commit")
        except InjectedFault:
            pass
        else:
            failures.append("R1 commit did not raise")
        model.price[m] = model.price[m] * 2
        return got, "crash at txn.apply"

    step("R1", run_r1)
    before = dict(hk.LAUNCHES)
    t0 = time.perf_counter()
    recovered = connect()
    dt = time.perf_counter() - t0
    check_read_back("R1 after recovery", recovered)
    log(f"phase10 R1 recovery at open: {dt!r} s, its read-back launches "
        f"{ {n: hk.LAUNCHES[n] - before[n] for n in hk.KERNELS} } "
        f"({ident})")
    events = recovered.execute(
        f"select citus_change_feed('orders_w', {lsn0})").rows()
    lsns = [int(r[0]) for r in recovered.execute(
        "select citus_change_feed('orders_w')").rows()]
    kinds = {r[1] for r in recovered.execute(
        "select citus_change_feed('orders_w')").rows()}
    expect("R1 feed in LSN order", lsns == sorted(lsns) and
           len(set(lsns)) == len(lsns), True)
    expect("R1 feed kinds", kinds, {"insert", "delete"})
    expect("R1 feed has the recovered commit", len(events) > 0, True)
    log(f"phase10 change feed: {len(lsns)} events on orders_w, "
        f"{len(events)} from the recovered commit")

    # R2: the same COMMIT killed at txn.apply under the default statement
    # retries: the envelope resolves it by its commit record inside the
    # session, and the COMMIT returns
    def run_r2(sess):
        m = model.alive & (model.prio == "3-MEDIUM") & model.valid
        sess.execute("begin")
        got = int(sess.execute(
            "update orders_w set o_totalprice = o_totalprice * 2 "
            "where o_orderpriority = '3-MEDIUM' and o_totalprice is not null"
        ).rows()[0][0])
        expect("R2 update count", got, int(m.sum()))
        try:
            with inject("txn.apply", require_fired=True):
                sess.execute("commit")
        except InjectedFault:
            failures.append("R2 commit raised: not resolved in the session")
        model.price[m] = model.price[m] * 2
        expect("R2 txnlog empty",
               os.listdir(os.path.join(data_dir, "txnlog")), [])
        return got, "killed at txn.apply, resolved in the session"

    step("R2", run_r2, lambda sess: check_read_back("R2", sess))

    for t in ("orders_w", "orders_by_cust", "li_agg"):
        recovered.execute(f"drop table {t}")
    launched = dict(hk.LAUNCHES)
    log(f"phase10: {time.perf_counter() - t_phase!r} s, launches {launched}")
    for name in PHASE10_KERNELS:
        if not launched[name]:
            failures.append(f"{name} never launched")
    if failures:
        raise AssertionError(f"phase 10: {failures}")
    return launched


# -- phase 11: statements larger than their budget --------------------------

STREAM_FEED_BYTES = 64 << 20  # S1–S4, T1, T2: max_feed_bytes_per_device
# S-step → (the phase 4 query it runs, the kernel it must launch per batch)
STREAM_STEPS = (("S1", "Q1", "dense_grid_sum"),
                ("S2", "Q3", "bucketed_probe"),
                ("S3", "high_card_groupby", "bucketed_groupby_sums"),
                ("S4", "nullable", "dense_grid_sum"))
L1_FRACTION = 0.4  # L1: allocator cap, share of resident Q3's peak
L2_SQL = ("select count(*), sum(l_extendedprice) from orders, lineitem "
          "where o_orderkey = l_orderkey")
L2_BATCH_ROWS = 1 << 18  # L2's stream_batch_rows (before the ladder's shrink)
LEDGER_TRANSIENT = ("stream", "feed", "plan", "prefetch")


def phase11(ct, hk, data_dir, data, queries, checks, want, reps,
            ident) -> dict:
    """Phase 11.  Returns each kernel's launches over the phase."""
    import gc
    import threading

    import numpy as np
    import torch

    from citus_tpu_torch.errors import (
        QueryCanceled, ResourceExhausted, StatementTimeout)
    from citus_tpu_torch.executor.hbm import accountant_for, oom_budget
    from citus_tpu_torch.executor.stream import pick_stream_node
    from citus_tpu_torch.sql import parse

    t_phase = time.perf_counter()
    failures: list = []
    acc = accountant_for(data_dir)
    dev = torch.device("cuda", 0)
    hk.reset_launch_counts()

    def connect(**kw):
        return rerun_connect(ct, data_dir, scan_pipeline="device",
                             compute_dtype="float32", **kw)

    def ledger_clean(where):
        gc.collect()
        torch.cuda.synchronize()
        snap = acc.snapshot()
        left = {c: snap[f"live_{c}_bytes"] for c in LEDGER_TRANSIENT
                if snap[f"live_{c}_bytes"]}
        if left:
            failures.append(f"{where}: ledger not back at 0: {left}")
        producers = [t.name for t in threading.enumerate()
                     if t.is_alive() and t.name == "citus-stream-producer"]
        if producers:
            failures.append(f"{where}: producer threads alive: {producers}")
        return not left and not producers

    def launched_since(before):
        return {n: hk.LAUNCHES[n] - before[n] for n in hk.KERNELS}

    # -- S1–S4: streamed under a 64 MiB feed ceiling -----------------------
    best_warm = {}
    for step_name, q, kernel in STREAM_STEPS:
        sess = connect(max_feed_bytes_per_device=STREAM_FEED_BYTES)
        plan, _cleanup = sess._plan_select(parse(queries[q])[0])
        hw = acc.budget_bytes(dev, sess.settings)
        picked = pick_stream_node(
            plan, sess.catalog, sess.store, np.dtype("float32"),
            min(STREAM_FEED_BYTES, hw) if hw else STREAM_FEED_BYTES,
            prefetch_depth=sess.settings.get("scan_prefetch_depth"))
        stream_table = picked[0].rel.table if picked else None
        batch_cap = picked[1] if picked else None
        acc.reset_peaks()
        torch.cuda.reset_peak_memory_stats()
        sess.executor.scan_stats.reset()
        before = dict(hk.LAUNCHES)
        t0 = time.perf_counter()
        res = sess.execute(queries[q])
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        first_launches = launched_since(before)
        producer = sess.executor.scan_stats.snapshot()
        checks[q](res, want[q])
        batches, retries = res.streamed_batches, res.retries
        compilers = sess.executor.plan_cache.misses
        warm = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = sess.execute(queries[q])
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
            checks[q](res, want[q])
        best_warm[step_name] = min(warm)
        snap = acc.snapshot()
        path = ("bucketed probe" if first_launches["bucketed_probe"]
                else "fused lookup / expansion") if q == "Q3" else ""
        log(f"phase11 {step_name} ({q}): stream {stream_table} batch_cap "
            f"{batch_cap}, {batches} batches, retries {retries}, "
            f"PlanCompilers {compilers}, first run {first!r} s, warm "
            f"{warm!r} s (best {min(warm)!r}), the producer's host decode "
            f"{producer['stream_decode_seconds']!r} s and copy enqueue "
            f"{producer['stream_transfer_seconds']!r} s and the host merge "
            f"{producer['stream_merge_seconds']!r} s in the first run, "
            f"launches in the first run "
            f"{first_launches}, peak stream bytes {snap['peak_stream_bytes']}"
            f", ledger peak {snap['peak_bytes']}, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()}"
            + (f", probe path: {path}" if path else "") + f" ({ident})")
        if batches < 4:
            failures.append(f"{step_name}: {batches} batches, not >= 4")
        if compilers > 1 + retries:
            failures.append(f"{step_name}: {compilers} PlanCompilers for "
                            "one streamed statement")
        k = first_launches[kernel]
        if kernel == "dense_grid_sum" and k != batches:
            failures.append(f"{step_name}: K1 launched {k} times over "
                            f"{batches} batches")
        if kernel == "bucketed_groupby_sums" and k < batches:
            failures.append(f"{step_name}: K3 launched {k} times over "
                            f"{batches} batches")
        if kernel == "bucketed_probe" and path == "bucketed probe" \
                and k < batches:
            failures.append(f"{step_name}: K2 launched {k} times over "
                            f"{batches} batches")
        del sess, plan
        ledger_clean(step_name)

    # -- L1: a real CUDA allocator OOM through the ladder ------------------
    acc.evict_evictable()
    gc.collect()
    torch.cuda.empty_cache()
    base_alloc = torch.cuda.memory_allocated()
    base_reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    sess = connect()
    t0 = time.perf_counter()
    res = sess.execute(queries["Q3"])
    torch.cuda.synchronize()
    resident_wall = time.perf_counter() - t0
    checks["Q3"](res, want["Q3"])
    peak = torch.cuda.max_memory_allocated() - base_alloc
    sess.executor.feed_cache.clear()
    del sess, res
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(dev).total_memory
    cap = base_reserved + int(L1_FRACTION * peak)
    try:
        torch.cuda.set_per_process_memory_fraction(cap / total, dev)
        sess = connect()
        ooms = acc.oom_total
        t0 = time.perf_counter()
        before = dict(hk.LAUNCHES)
        try:
            res = sess.execute(queries["Q3"])
            torch.cuda.synchronize()
        except ResourceExhausted as e:
            failures.append(f"L1: the ladder did not answer: {e}")
            res = None
        wall = time.perf_counter() - t0
        real_ooms = acc.oom_total - ooms
        if res is not None:
            checks["Q3"](res, want["Q3"])
        log(f"phase11 L1: resident Q3 {resident_wall!r} s peaked "
            f"{peak} bytes above {base_alloc}; allocator capped at {cap} "
            f"of {total} bytes (after the run: "
            f"{acc.device_memory_stats(dev)}); CUDA OOMs classified "
            f"{real_ooms}, rungs "
            f"{sess.last_oom_rungs}, answer matches numpy "
            f"{res is not None}, batches "
            f"{res.streamed_batches if res is not None else None}, passes "
            f"{res.spill_passes if res is not None else None}, wall "
            f"{wall!r} s, launches {launched_since(before)} ({ident})")
        if real_ooms < 1 or not sess.last_oom_rungs:
            failures.append("L1: no CUDA allocator OOM was classified")
        del sess, res
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        gc.collect()
        torch.cuda.empty_cache()
    ledger_clean("L1")

    # -- L2: multi-pass under a simulated budget ---------------------------
    li = data["lineitem"]
    l2_want = (len(li["l_orderkey"]),
               float(li["l_extendedprice"].astype(np.float64).sum()))
    sess = connect(stream_batch_rows=L2_BATCH_ROWS)
    plan, _cleanup = sess._plan_select(parse(L2_SQL)[0])
    from citus_tpu_torch.executor.feed import walk_plan
    from citus_tpu_torch.executor.stream import (
        _scan_dev_rows, _scan_width_bytes)
    from citus_tpu_torch.planner.plan import ScanNode

    scans = {n.rel.table: _scan_dev_rows(n, sess.catalog, sess.store)
             * _scan_width_bytes(n, sess.catalog, np.dtype("float32"))
             for n in walk_plan(plan.root) if isinstance(n, ScanNode)}
    # below the orders side's feed, above half of it plus the batches
    l2_budget = int(scans["orders"] * 0.75)
    acc.evict_evictable()
    gc.collect()
    t0 = time.perf_counter()
    before = dict(hk.LAUNCHES)
    with oom_budget(acc, budget=l2_budget) as sim:
        try:
            res = sess.execute(L2_SQL)
        except ResourceExhausted as e:
            failures.append(f"L2: the ladder did not answer: {e}")
            res = None
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (None if res is None else
           (int(res.rows()[0][0]), float(res.rows()[0][1])))
    ok = got is not None and got[0] == l2_want[0] and \
        close(got[1], l2_want[1])
    k = sess.executor.oom.multipass_k
    log(f"phase11 L2: feeds {scans}, MemSim budget {l2_budget} bytes, "
        f"OOMs {sim.oom_raised}, rungs {sess.last_oom_rungs}, multipass_k "
        f"{k}, passes {res.spill_passes if res is not None else None}, "
        f"batches {res.streamed_batches if res is not None else None}, "
        f"answer {got} vs numpy {l2_want}: {'match' if ok else 'DIFFER'}, "
        f"wall {wall!r} s, launches {launched_since(before)} ({ident})")
    if not ok:
        failures.append("L2: answer differs from numpy")
    if k < 2 or res is None or res.spill_passes < 2:
        failures.append(f"L2: multipass_k {k}, not >= 2")
    del res, plan
    ledger_clean("L2")

    # -- L3: the ungoverned arm (a fresh session: L2's ladder state is
    # sticky on its executor) ----------------------------------------------
    del sess
    sess = connect(stream_batch_rows=L2_BATCH_ROWS, oom_degradation=False)
    raised = None
    with oom_budget(acc, budget=l2_budget):
        try:
            sess.execute(L2_SQL)
        except Exception as e:  # noqa: BLE001 — classified just below
            raised = e
    ok3 = isinstance(raised, ResourceExhausted)
    res = sess.execute(queries["Q1"])
    torch.cuda.synchronize()
    checks["Q1"](res, want["Q1"])
    clean = ledger_clean("L3")
    log(f"phase11 L3: oom_degradation=off raised "
        f"{type(raised).__name__ if raised else None}, the next Q1 matches "
        f"numpy, ledger back at 0 {clean} ({ident})")
    if not ok3:
        failures.append(f"L3: raised {raised!r}, not ResourceExhausted")
    del sess, res

    # -- T1, T2: the envelope on the card ----------------------------------
    sess = connect(max_feed_bytes_per_device=STREAM_FEED_BYTES)
    timeout_ms = max(1, int(best_warm["S1"] * 1000 / 10))
    sess.execute(f"set statement_timeout_ms = {timeout_ms}")
    t0 = time.perf_counter()
    raised = None
    try:
        sess.execute(queries["Q1"])
    except Exception as e:  # noqa: BLE001 — classified just below
        raised = e
    dt = time.perf_counter() - t0
    sess.execute("set statement_timeout_ms = 0")
    clean = ledger_clean("T1")
    res = sess.execute(queries["Q1"])
    checks["Q1"](res, want["Q1"])
    log(f"phase11 T1: statement_timeout_ms {timeout_ms} raised "
        f"{type(raised).__name__ if raised else None} after {dt!r} s; "
        f"producer joined and ledger at 0 {clean}; the next Q1 matches "
        f"numpy ({ident})")
    if not isinstance(raised, StatementTimeout):
        failures.append(f"T1: raised {raised!r}, not StatementTimeout")

    first_done, cancelled = threading.Event(), threading.Event()
    real = sess.executor.run_with_retry
    runs = []

    def run_with_retry(*a, **kw):
        out = real(*a, **kw)
        runs.append(1)
        if len(runs) == 1:
            first_done.set()
            cancelled.wait(30)
        return out

    def canceller():
        first_done.wait(60)
        sess.cancel()
        cancelled.set()

    sess.executor.run_with_retry = run_with_retry
    t = threading.Thread(target=canceller)
    t.start()
    raised = None
    try:
        sess.execute(queries["high_card_groupby"])
    except Exception as e:  # noqa: BLE001 — classified just below
        raised = e
    t.join()
    del sess.executor.run_with_retry
    clean = ledger_clean("T2")
    res = sess.execute(queries["Q1"])
    checks["Q1"](res, want["Q1"])
    log(f"phase11 T2: Session.cancel() after batch 1 raised "
        f"{type(raised).__name__ if raised else None} after {len(runs)} "
        f"batch(es); producer joined and ledger at 0 {clean}; the next Q1 "
        f"matches numpy ({ident})")
    if not isinstance(raised, QueryCanceled) or \
            isinstance(raised, StatementTimeout):
        failures.append(f"T2: raised {raised!r}, not QueryCanceled")
    del sess, res

    launched = dict(hk.LAUNCHES)
    log(f"phase11: {time.perf_counter() - t_phase!r} s, launches {launched}")
    if failures:
        raise AssertionError(f"phase 11: {failures}")
    return launched


# --------------------------------------------------------------------------

# -- phase 12: observability ----------------------------------------------

# Q1 warm runs per arm (tracing on / off), interleaved: the best of 12
# moved by 0.3-0.6 ms between two calls on one card, about the bound
OVERHEAD_REPS = 32
OVERHEAD_SHARE = 0.05  # tracing may cost this share of Q1's best warm wall
OVERHEAD_ABS_S = 0.0002  # ... plus this much
LEG_SLACK_MS = 0.1    # summed dispatch device_ms ≤ the device phase + this
TILE_SHARE = 0.95     # top-level spans cover at least this share of a root


def trace_figures(doc) -> dict:
    """The warm-wall split of one statement trace, in ms: each phase of
    the Timing line, dispatch and fetch apart, the summed device_ms of
    the dispatch pairs and of the transfers' pairs, and the share of the
    root the top-level spans cover."""
    from citus_tpu_torch.stats import tracing

    root = doc["root"]
    ph = tracing.phase_breakdown(root)
    out = {k: v * 1e3 for k, v in ph.items() if v}
    out["dispatch"] = tracing.span_seconds(root, "mesh.dispatch") * 1e3
    out["fetch"] = tracing.span_seconds(root, "mesh.fetch") * 1e3
    out["device_ms"] = tracing.device_ms(root, "mesh.dispatch")
    out["transfer_device_ms"] = (tracing.device_ms(root, "scan.transfer")
                                 + tracing.device_ms(root,
                                                     "stream.transfer"))
    top = sum(c["dur_ms"] for c in root.get("children", ()))
    out["tiled"] = top / root["dur_ms"] if root["dur_ms"] else 1.0
    out["spans"] = doc["spans"]
    return out


def host_syncs(sess, sql, within=None) -> dict:
    """Run `sql` warm with CUDA's sync debug mode on: each synchronizing
    call the statement made, by the innermost call site in the port's
    package, with counts.  With `within` ((file name, function) pairs),
    only the calls made inside one of those functions."""
    import collections
    import traceback
    import warnings

    import torch

    pkg = os.path.join(HERE, "citus_tpu_torch")
    sites = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()
        if within is not None and not any(
                (os.path.basename(f.filename), f.name) in within
                for f in stack):
            return
        frames = [f for f in stack if f.filename.startswith(pkg)]
        f = frames[-1] if frames else None
        where = (f"{os.path.relpath(f.filename, HERE)}:{f.lineno}" if f
                 else f"{os.path.basename(filename)}:{lineno}")
        sites[where] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sess.execute(sql)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return dict(sites)


def phase12(ct, hk, data_dir, queries, checks, want, ident) -> dict:
    """Phase 12 (observability).  Returns each kernel's launches under
    the phase's EXPLAIN ANALYZE statements."""
    import gc
    import threading

    import torch

    from citus_tpu_torch.stats import tracing
    from citus_tpu_torch.executor.hbm import accountant_for

    t_phase = time.perf_counter()
    failures: list = []
    acc = accountant_for(data_dir)
    dev = torch.device("cuda", 0)
    hk.reset_launch_counts()
    explain_launches = dict.fromkeys(hk.KERNELS, 0)

    def connect(**kw):
        return rerun_connect(ct, data_dir, scan_pipeline="device",
                             compute_dtype="float32",
                             trace_fast_statement_ms=0, **kw)

    def clean(where):
        gc.collect()
        torch.cuda.synchronize()
        open_spans = tracing.open_span_count()
        transient = acc.transient_bytes()
        threads = [t.name for t in threading.enumerate() if t.is_alive()
                   and t.name in ("citus-stream-producer", "scan-prefetch")]
        if open_spans or transient or threads:
            failures.append(f"{where}: open spans {open_spans}, transient "
                            f"ledger bytes {transient}, threads {threads}")

    def check_legs(where, fig):
        if not 0.0 < fig["device_ms"] <= fig.get("device", 0.0) \
                + LEG_SLACK_MS:
            failures.append(f"{where}: dispatch device_ms "
                            f"{fig['device_ms']!r} not in (0, device phase "
                            f"{fig.get('device', 0.0)!r} + {LEG_SLACK_MS}]")
        if fig["tiled"] < TILE_SHARE:
            failures.append(f"{where}: top-level spans tile only "
                            f"{fig['tiled']!r} of the root")

    def explain(sess, sql):
        before = dict(hk.LAUNCHES)
        lines = sess.execute("explain analyze " + sql).columns["QUERY PLAN"]
        torch.cuda.synchronize()
        for n in hk.KERNELS:
            explain_launches[n] += hk.LAUNCHES[n] - before[n]
        return lines, sess.stats.tracing.last_trace()

    # -- the four main-path queries: EXPLAIN ANALYZE first and warm --------
    for q in ("Q1", "Q3", "high_card_groupby", "nullable"):
        sess = connect()
        sql = queries[q]
        first_lines, first_doc = explain(sess, sql)
        res = sess.execute(sql)
        torch.cuda.synchronize()
        checks[q](res, want[q])
        warm = trace_figures(sess.stats.tracing.last_trace())
        lines, doc = explain(sess, sql)
        timing = next(x for x in lines if x.startswith("Timing: "))
        fig_first = trace_figures(first_doc)
        fig_explain = trace_figures(doc)
        prof = profile_query(sess, sql)
        syncs = host_syncs(sess, sql) if q in ("Q1", "Q3") else None
        log(f"phase12 {q}: first EXPLAIN ANALYZE "
            f"{next(x for x in first_lines if x.startswith('Timing: '))!r}"
            f", device_ms {fig_first['device_ms']!r}; warm "
            f"{timing!r}; warm traced run split (ms) "
            f"{warm}; profiler device busy "
            f"{prof['device_busy_ms']!r} ms of wall {prof['wall_ms']!r} ms"
            + (f"; host syncs by call site {syncs}" if syncs is not None
               else "") + f" ({ident})")
        for where, fig in ((f"{q} first", fig_first),
                           (f"{q} warm", warm),
                           (f"{q} warm EXPLAIN", fig_explain)):
            check_legs(where, fig)
        del sess, res
        clean(q)
    for name in hk.KERNELS:
        if explain_launches[name] <= 0:
            failures.append(f"{name} never launched under EXPLAIN ANALYZE")

    # -- S1: streamed Q1 under the 64 MiB ceiling --------------------------
    sess = connect(max_feed_bytes_per_device=STREAM_FEED_BYTES)
    res = sess.execute(queries["Q1"])
    torch.cuda.synchronize()
    checks["Q1"](res, want["Q1"])
    doc = sess.stats.tracing.last_trace()
    fig = trace_figures(doc)
    batches = len([1 for _ in _spans_named(doc["root"], "stream.batch")])
    log(f"phase12 S1 streamed Q1: {res.streamed_batches} batches, "
        f"{fig['spans']} spans (truncated {doc['truncated']}), split (ms) "
        f"{fig}, stream.batch spans {batches} ({ident})")
    if res.streamed_batches < 4 or batches != res.streamed_batches:
        failures.append(f"S1: {res.streamed_batches} batches, "
                        f"{batches} stream.batch spans")
    if fig["transfer_device_ms"] <= 0:
        failures.append("S1: no stream.transfer device_ms")
    check_legs("S1", fig)
    del sess, res
    clean("S1")

    # -- L1: Q3 under an allocator cap, answered by the ladder -------------
    acc.evict_evictable()
    gc.collect()
    torch.cuda.empty_cache()
    base_alloc = torch.cuda.memory_allocated()
    base_reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    sess = connect()
    sess.execute(queries["Q3"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base_alloc
    sess.executor.feed_cache.clear()
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(dev).total_memory
    cap = base_reserved + int(L1_FRACTION * peak)
    try:
        torch.cuda.set_per_process_memory_fraction(cap / total, dev)
        sess = connect()
        res = sess.execute(queries["Q3"])
        torch.cuda.synchronize()
        checks["Q3"](res, want["Q3"])
        doc = sess.stats.tracing.last_trace()
        rungs = [s.get("meta", {}).get("rung")
                 for s in _spans_named(doc["root"], "oom.degrade")]
        attempts = [s for s in doc["root"]["children"]
                    if s["name"] == "execute"]
        fig = trace_figures(doc)
        log(f"phase12 L1 capped Q3: rungs {sess.last_oom_rungs}, "
            f"oom.degrade spans {rungs}, execute attempts {len(attempts)}, "
            f"split (ms) {fig} ({ident})")
        if not rungs or len(attempts) != len(rungs) + 1:
            failures.append(f"L1: rung spans {rungs}, attempts "
                            f"{len(attempts)}")
        if fig["tiled"] < TILE_SHARE:
            failures.append(f"L1: top-level spans tile {fig['tiled']!r}")
        del sess, res
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        gc.collect()
        torch.cuda.empty_cache()
    clean("L1")

    # -- what tracing costs Q1's warm wall ---------------------------------
    sess = connect()
    sess.execute(queries["Q1"])
    walls = {True: [], False: []}
    for _ in range(OVERHEAD_REPS):
        for on in (True, False):
            sess.settings.set("trace_enabled", on)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sess.execute(queries["Q1"])
            torch.cuda.synchronize()
            walls[on].append(time.perf_counter() - t0)
    sess.settings.set("trace_enabled", True)
    checks["Q1"](res, want["Q1"])
    on, off = min(walls[True]), min(walls[False])
    log(f"phase12 tracing overhead on Q1: best of {OVERHEAD_REPS} warm "
        f"walls, tracing on {on!r} s, off {off!r} s, difference "
        f"{(on - off) * 1e3!r} ms ({(on / off - 1) * 100:.2f}%) ({ident})")
    if on > off * (1 + OVERHEAD_SHARE) + OVERHEAD_ABS_S:
        failures.append(f"tracing costs {(on - off) * 1e3!r} ms of Q1's "
                        f"{off * 1e3!r} ms best warm wall")

    health = sess.execute("select citus_check_cluster_node_health()").rows()
    log(f"phase12 citus_check_cluster_node_health(): {health}")
    if not health or not all(h for _n, _a, h in health):
        failures.append(f"health probe on the card: {health}")
    del sess, res
    clean("health")

    log(f"phase12: {time.perf_counter() - t_phase!r} s, launches under "
        f"EXPLAIN ANALYZE {explain_launches}")
    if failures:
        raise AssertionError(f"phase 12: {failures}")
    return explain_launches


# -- phase 13: concurrent statements ------------------------------------------

W1_THREADS = 8          # sessions in threads under admission
W1_SLOTS = 2            # max_concurrent_statements in W1 and W3
W1_WEIGHTS = "a:3,b:1"  # the two tenants' round-robin weights
P1_THREADS = 16         # point-read sessions in threads
P1_LOOKUPS = 64         # literal o_orderkey lookups per thread
PHASE13_BUDGET_S = 150.0


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None


def phase13(ct, hk, data_dir, data, queries, checks, want, ident,
            tmp) -> dict:
    """Phase 13 (concurrent statements).  Returns each kernel's launches
    over the phase."""
    import gc
    import threading

    import numpy as np
    import torch

    from citus_tpu_torch.errors import (AdmissionRejected, ReadOnlyReplica,
                                        ReplicaTooStale, ReplicationError,
                                        StatementTimeout)
    from citus_tpu_torch.executor.hbm import accountant_for
    from citus_tpu_torch.replication import provision_replica
    from citus_tpu_torch.serving import batcher_for
    from citus_tpu_torch.sql import parse
    from citus_tpu_torch.wlm import AdmissionRequest, planned_feed_bytes

    t_phase = time.perf_counter()
    failures: list = []
    acc = accountant_for(data_dir)
    hk.reset_launch_counts()
    li, orders = data["lineitem"], data["orders"]

    def clean(where, sessions=()):
        for s in sessions:
            s.close()
        gc.collect()
        torch.cuda.synchronize()
        if acc.transient_bytes():
            failures.append(f"{where}: {acc.transient_bytes()} transient "
                            "ledger bytes after the step")

    def run_threads(fn, args_list):
        threads = [threading.Thread(target=fn, args=a) for a in args_list]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    # -- W1: admission under concurrency ------------------------------------
    sessions = [ct.connect(data_dir, serving_result_cache_bytes=0,
                           max_concurrent_statements=W1_SLOTS,
                           wlm_tenant="a" if i % 2 else "b",
                           wlm_tenant_weights=W1_WEIGHTS)
                for i in range(W1_THREADS)]
    mu = threading.Lock()
    live = {"now": 0, "max": 0}
    queued_ms = {"a": [], "b": []}
    for s in sessions:
        orig = s._execute_resilient

        def counted(stmt, activity=None, timeout_ms=None, _orig=orig,
                    _s=s):
            # admitted statements only (an exempt SET runs here too)
            admitted = getattr(_s._wlm_tls, "last", None) is not None
            with mu:
                live["now"] += admitted
                live["max"] = max(live["max"], live["now"])
            try:
                return _orig(stmt, activity, timeout_ms=timeout_ms)
            finally:
                with mu:
                    live["now"] -= admitted
        s._execute_resilient = counted
    order = ("Q1", "Q3", "high_card_groupby", "nullable")
    bad: list = []

    def w1(s):
        try:
            for rnd in range(2):
                s.execute("set scan_pipeline = "
                          + ("device" if rnd == 0 else "auto"))
                for q in order:
                    checks[q](s.execute(queries[q]), want[q])
                    info = s._wlm_tls.last
                    with mu:
                        queued_ms[info["tenant"]].append(info["queued_ms"])
        except Exception as e:  # noqa: BLE001 — gathered as a failure
            bad.append(repr(e))

    torch.cuda.reset_peak_memory_stats()
    wlm = sessions[0].wlm
    base = wlm.snapshot()
    t0 = time.perf_counter()
    run_threads(w1, [(s,) for s in sessions])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snap = wlm.snapshot()
    admitted = sum(s.stats.counters.snapshot()["wlm_admitted_total"]
                   for s in sessions)
    statements = W1_THREADS * 2 * len(order)
    log(f"phase13 W1: {W1_THREADS} sessions x {2 * len(order)} statements "
        f"in {wall!r} s, at most {live['max']} executing at once, admitted "
        f"{admitted}, queued {snap['queued_total'] - base['queued_total']},"
        f" max_memory_allocated {torch.cuda.max_memory_allocated()} "
        f"({ident})")
    for t in ("a", "b"):
        xs = queued_ms[t]
        log(f"  tenant {t}: {len(xs)} admitted, queued_ms p50 "
            f"{_pct(xs, 0.5)!r} p99 {_pct(xs, 0.99)!r} max "
            f"{max(xs) if xs else None!r}")
    log(f"  citus_stat_wlm(): "
        f"{sessions[0].execute('select citus_stat_wlm()').rows()}")
    launched_w1 = dict(hk.LAUNCHES)
    if bad:
        failures.append(f"W1 answers: {bad[:3]}")
    if live["max"] > W1_SLOTS:
        failures.append(f"W1: {live['max']} statements executing at once")
    if admitted != statements:
        failures.append(f"W1: admitted {admitted} of {statements}")
    if snap["queued_total"] == base["queued_total"]:
        failures.append("W1: nothing queued")
    if not queued_ms["a"] or not queued_ms["b"]:
        failures.append("W1: a tenant was never admitted")
    if not all(launched_w1[k] > 0 for k in hk.KERNELS):
        failures.append(f"W1 launches {launched_w1}")
    clean("W1", sessions)

    # -- W2: the memory gate queues on bytes --------------------------------
    probe = ct.connect(data_dir, serving_result_cache_bytes=0)
    q3 = parse(queries["Q3"])[0]
    full = planned_feed_bytes(q3, probe.catalog, probe.store, 1,
                              probe.settings)
    budget = int(1.5 * full)
    pair = [ct.connect(data_dir, serving_result_cache_bytes=0,
                       max_feed_bytes_per_device=budget) for _ in range(2)]
    wlm = probe.wlm
    results, seen = {}, {"slots": None}

    def w2(i):
        try:
            results[i] = pair[i].execute(queries["Q3"])
        except Exception as e:  # noqa: BLE001 — gathered as a failure
            results[i] = e

    base = wlm.snapshot()
    t0 = time.perf_counter()
    ta = threading.Thread(target=w2, args=(0,))
    ta.start()
    while wlm.snapshot()["slots_in_use"] < 1 and ta.is_alive():
        time.sleep(0.0005)
    tb = threading.Thread(target=w2, args=(1,))
    tb.start()
    while tb.is_alive():
        s_now = wlm.snapshot()
        if any(r["queued"] for r in s_now["tenants"]):
            seen["slots"] = s_now["slots_in_use"]
            break
        time.sleep(0.0005)
    ta.join()
    tb.join()
    wall = time.perf_counter() - t0
    b_queued = pair[1].stats.counters.snapshot()["wlm_queued_total"]
    log(f"phase13 W2: Q3 planned {full} bytes, budget {budget}; two Q3s in "
        f"{wall!r} s; the second queued {b_queued} time(s) with "
        f"{seen['slots']} of 8 slots in use ({ident})")
    for i in (0, 1):
        if isinstance(results.get(i), Exception):
            failures.append(f"W2 Q3 {i}: {results[i]!r}")
        else:
            try:
                checks["Q3"](results[i], want["Q3"])
            except AssertionError as e:
                failures.append(f"W2 Q3 {i}: {e}")
    if b_queued != 1 or seen["slots"] is None or seen["slots"] >= 8:
        failures.append(f"W2: the second Q3 did not queue on bytes "
                        f"(queued {b_queued}, slots {seen['slots']})")
    clean("W2", pair)

    # -- W3: shedding and the timeout while queued --------------------------
    four = [ct.connect(data_dir, serving_result_cache_bytes=0,
                       max_concurrent_statements=W1_SLOTS, wlm_queue_depth=1)
            for _ in range(4)]
    barrier = threading.Barrier(4)
    outcomes: list = []

    def w3(s):
        barrier.wait()
        try:
            res = s.execute(queries["Q3"])
            checks["Q3"](res, want["Q3"])
            outcomes.append("answered")
        except AdmissionRejected:
            outcomes.append("shed")
        except Exception as e:  # noqa: BLE001 — gathered as a failure
            outcomes.append(repr(e))

    run_threads(w3, [(s,) for s in four])
    log(f"phase13 W3: 4 Q3s under {W1_SLOTS} slots, wlm_queue_depth 1: "
        f"{sorted(outcomes)}")
    if outcomes.count("shed") < 1 or \
            outcomes.count("answered") + outcomes.count("shed") != 4:
        failures.append(f"W3 shedding: {outcomes}")
    timed = ct.connect(data_dir, serving_result_cache_bytes=0,
                       max_concurrent_statements=1,
                       statement_timeout_ms=200)
    blocker = timed.wlm.admit(AdmissionRequest(max_slots=1))
    t0 = time.perf_counter()
    try:
        timed.execute(queries["Q3"])
        failures.append("W3: no StatementTimeout while queued")
    except StatementTimeout:
        log(f"phase13 W3: StatementTimeout after "
            f"{time.perf_counter() - t0!r} s queued (200 ms limit)")
    finally:
        timed.wlm.release(blocker)
    clean("W3", four + [timed, probe])

    # -- P1: the micro-batcher ----------------------------------------------
    rng = np.random.default_rng(13)
    batcher = batcher_for(data_dir)
    for mode, on in (("on", True), ("off", False)):
        readers = [ct.connect(data_dir, serving_result_cache_bytes=0,
                              serving_enabled=on,
                              fast_path_max_rows=P1_FAST_PATH_MAX_ROWS)
                   for _ in range(P1_THREADS)]
        picks = [rng.choice(len(orders["o_orderkey"]), P1_LOOKUPS,
                            replace=False) for _ in range(P1_THREADS)]
        lat: list = []
        wrong: list = []
        batcher.reset_totals()
        start = threading.Barrier(P1_THREADS)

        def p1(s, pick):
            start.wait()
            for i in pick:
                key = int(orders["o_orderkey"][i])
                t1 = time.perf_counter()
                try:
                    rows = s.execute(
                        "select o_orderkey, o_custkey, o_totalprice "
                        f"from orders where o_orderkey = {key}").rows()
                except Exception as e:  # noqa: BLE001 — a failure
                    wrong.append(repr(e))
                    continue
                dt = time.perf_counter() - t1
                with mu:
                    lat.append(dt)
                w = [(key, int(orders["o_custkey"][i]),
                      float(orders["o_totalprice"][i]))]
                if same_rows(rows, w, True):
                    wrong.append(key)

        t0 = time.perf_counter()
        run_threads(p1, list(zip(readers, picks)))
        wall = time.perf_counter() - t0
        bs = batcher.snapshot()
        n = P1_THREADS * P1_LOOKUPS
        log(f"phase13 P1 serving {mode}: {n} lookups in {wall!r} s, "
            f"latency p50 {_pct(lat, 0.5)!r} s p99 {_pct(lat, 0.99)!r} s; "
            f"batcher requests {bs['requests_total']} answered "
            f"{bs['answered_total']} errored {bs['errored_total']} fallback "
            f"{bs['fallback_total']} dispatches "
            f"{bs['batch_dispatch_total']} max batch "
            f"{bs['max_batch_seen']} ({ident})")
        log(f"  citus_stat_serving(): "
            f"{readers[0].execute('select citus_stat_serving()').rows()}")
        if wrong:
            failures.append(f"P1 {mode}: {len(wrong)} wrong answers, "
                            f"{wrong[:3]}")
        if bs["requests_total"] != bs["answered_total"] + \
                bs["errored_total"] + bs["fallback_total"]:
            failures.append(f"P1 {mode}: the batcher's ledger {bs}")
        if on and (bs["requests_total"] != n or bs["max_batch_seen"] < 2
                   or bs["batch_dispatch_total"] >= n):
            failures.append(f"P1 on: no coalescing {bs}")
        if not on and bs["requests_total"]:
            failures.append(f"P1 off: the batcher saw {bs}")
        clean(f"P1 {mode}", readers)

    # -- C1: the result cache -----------------------------------------------
    sess = ct.connect(data_dir)
    writer = ct.connect(data_dir, serving_result_cache_bytes=0)
    first = sess.execute(queries["Q1"])
    checks["Q1"](first, want["Q1"])
    torch.cuda.synchronize()
    before = dict(hk.LAUNCHES)
    t0 = time.perf_counter()
    hit = sess.execute(queries["Q1"])
    hit_s = time.perf_counter() - t0
    if hit.rows() != first.rows() or dict(hk.LAUNCHES) != before:
        failures.append("C1: the repeat was not a hit without launches")
    key = int(orders["o_orderkey"][7])
    extra = li["l_orderkey"] == key
    li2 = {c: np.concatenate([a, a[extra]]) for c, a in li.items()}
    writer.execute("insert into lineitem select * from lineitem "
                   f"where l_orderkey = {key}")
    c0 = sess.stats.counters.snapshot()
    miss = sess.execute(queries["Q1"])
    torch.cuda.synchronize()
    try:
        checks["Q1"](miss, numpy_q1(li2))
    except AssertionError as e:
        failures.append(f"C1 after the insert: {e}")
    c1 = sess.stats.counters.snapshot()
    writer.execute("update nation set n_comment = 'c1' "
                   "where n_nationkey = 1")
    before = dict(hk.LAUNCHES)
    again = sess.execute(queries["Q1"])
    c2 = sess.stats.counters.snapshot()
    misses = (c1["serving_cache_misses_total"]
              - c0["serving_cache_misses_total"])
    hits = c2["serving_cache_hits_total"] - c1["serving_cache_hits_total"]
    log(f"phase13 C1: hit in {hit_s!r} s, no launch; after the insert "
        f"{misses} miss ({int(extra.sum())} rows more, equal to numpy); "
        f"after the UPDATE of nation {hits} hit ({ident})")
    if misses != 1:
        failures.append("C1: the insert did not invalidate Q1")
    if hits != 1 or dict(hk.LAUNCHES) != before \
            or again.rows() != miss.rows():
        failures.append("C1: an UPDATE of nation invalidated Q1")
    clean("C1", [sess, writer])

    # -- R1: replication ----------------------------------------------------
    foll_dir = os.path.join(tmp, "replica")
    lead = ct.connect(data_dir, serving_result_cache_bytes=0)
    t0 = time.perf_counter()
    prov = provision_replica(data_dir, foll_dir,
                             counters=lead.stats.counters)
    prov_s = time.perf_counter() - t0
    foll = ct.connect(foll_dir, serving_result_cache_bytes=0)
    before = dict(hk.LAUNCHES)
    fq1, fq3 = foll.execute(queries["Q1"]), foll.execute(queries["Q3"])
    torch.cuda.synchronize()
    on_foll = {n: hk.LAUNCHES[n] - before[n] for n in hk.KERNELS}
    lq1, lq3 = lead.execute(queries["Q1"]), lead.execute(queries["Q3"])
    for name, f, ld in (("Q1", fq1, lq1), ("Q3", fq3, lq3)):
        diff = same_rows(f.rows(), ld.rows(), True)
        if diff:
            failures.append(f"R1 follower {name}: {diff}")
    if not all(on_foll[k] > 0 for k in ("dense_grid_sum", "bucketed_probe",
                                        "dict_decode")):
        failures.append(f"R1 follower launches {on_foll}")
    key2 = int(orders["o_orderkey"][11])
    extra2 = li2["l_orderkey"] == key2
    li3 = {c: np.concatenate([a, a[extra2]]) for c, a in li2.items()}
    lead.execute("insert into lineitem select * from lineitem "
                 f"where l_orderkey = {key2}")
    t0 = time.perf_counter()
    shipped = lead.execute("select citus_replication_ship()").rows()
    ship_s = time.perf_counter() - t0
    try:
        checks["Q1"](foll.execute(queries["Q1"]), numpy_q1(li3))
    except AssertionError as e:
        failures.append(f"R1 follower after the ship: {e}")
    lead.execute("insert into nation values (96, 'UNSHIPPED', 1, 'u')")
    foll.execute("set replica_max_staleness_lsn = 0")
    try:
        foll.execute(queries["Q1"])
        failures.append("R1: no ReplicaTooStale")
    except ReplicaTooStale:
        pass
    foll.settings.reset("replica_max_staleness_lsn")  # back to unbounded
    try:
        foll.execute("insert into nation values (95, 'X', 1, 'x')")
        failures.append("R1: the follower took a write")
    except ReadOnlyReplica:
        pass
    stat_l = lead.execute("select citus_stat_replication()").rows()
    stat_f = foll.execute("select citus_stat_replication()").rows()
    epoch = foll.execute("select citus_promote_replica()").rows()[0][0]
    foll.execute("insert into nation values (98, 'PROMOTED', 1, 'p')")
    took = foll.execute("select count(*) from nation "
                        "where n_nationkey = 98").rows()[0][0]
    lead.execute("insert into nation values (97, 'ZOMBIE', 1, 'z')")
    try:
        lead.execute("select citus_replication_ship()")
        failures.append("R1: the old leader's ship was not fenced")
        fenced = False
    except ReplicationError:
        fenced = True
    log(f"phase13 R1: provision {prov_s!r} s ({prov}); follower Q1 and Q3 "
        f"equal the leader's, launches on the follower {on_foll}; "
        f"incremental ship {ship_s!r} s {shipped}; citus_stat_replication "
        f"leader {stat_l} follower {stat_f}; promoted to epoch {epoch}, "
        f"its write landed ({took}), the old leader fenced ({fenced}) "
        f"({ident})")
    if int(took) != 1:
        failures.append("R1: the promoted follower lost its write")
    clean("R1", [lead, foll])

    launched = dict(hk.LAUNCHES)
    wall = time.perf_counter() - t_phase
    log(f"phase13: {wall!r} s (budget {PHASE13_BUDGET_S} s), launches "
        f"{launched}")
    if wall > PHASE13_BUDGET_S:
        failures.append(f"phase 13 took {wall!r} s")
    if failures:
        raise AssertionError(f"phase 13: {failures}")
    return launched, li3


PHASE14_BUDGET_S = 150.0
# the factor-2 copy of lineitem_nullable that O3 corrupts (at full
# size, distributed on l_shipdate): the columns the nullable aggregate
# reads, so every byte the bitflip fault point can flip lies in a chunk
# the aggregate reads and verifies
R2_TABLE = "lineitem_nullable_r2"
R2_COLUMNS = ("l_shipdate", "l_returnflag", "l_linestatus", "l_discount",
              "l_tax")
R2_SQL = NULLABLE_SQL.replace("from lineitem_nullable ",
                              f"from {R2_TABLE} ")


def flipped_column(path: str) -> str:
    """The column whose chunk holds the byte integrity.flip_one_bit
    flips in `path` (the first column when it is the footer's)."""
    from citus_tpu_torch.storage.format import read_stripe_footer

    footer = read_stripe_footer(path)
    pos = max(8, os.path.getsize(path) // 2)
    for col in footer["columns"]:
        for ch in col["chunks"]:
            if ch["voff"] <= pos < ch["voff"] + ch["vclen"] or \
                    ch["nclen"] and ch["noff"] <= pos < ch["noff"] \
                    + ch["nclen"]:
                return col["name"]
    return footer["columns"][0]["name"]


def primary_stripes(sess, table: str) -> list:
    """Primary-copy paths of every committed stripe of `table`."""
    st = sess.store
    return [os.path.join(st.shard_dir(table, s.shard_id), r["file"])
            for s in sess.catalog.table_shards(table)
            for r in st.manifest(table)["shards"].get(str(s.shard_id), [])]


def phase14(ct, hk, data_dir, data, li, queries, checks, want,
            ident) -> dict:
    """Phase 14 (shard operations, background jobs, storage integrity).
    `li` is lineitem as phase 13 left it and `want` the numpy answers
    over it.  Returns each kernel's launches over the phase."""
    import gc
    import threading

    import torch

    from citus_tpu_torch.errors import CorruptStripe
    from citus_tpu_torch.executor.hbm import accountant_for
    from citus_tpu_torch.ingest import tpch
    from citus_tpu_torch.operations.cleanup import cleanup_registry_for
    from citus_tpu_torch.operations.restore_point import restore_cluster
    from citus_tpu_torch.storage import integrity
    from citus_tpu_torch.utils.faultinjection import inject

    t_phase = time.perf_counter()
    failures: list = []
    acc = accountant_for(data_dir)
    hk.reset_launch_counts()
    open_sessions: list = []

    def connect(**settings):
        s = rerun_connect(ct, data_dir, **settings)
        open_sessions.append(s)
        return s

    def clean(where, sessions=()):
        for s in sessions:
            s.close()
            open_sessions.remove(s)
        gc.collect()
        torch.cuda.synchronize()
        if acc.transient_bytes():
            failures.append(f"{where}: {acc.transient_bytes()} transient "
                            "ledger bytes after the step")

    def launches_since(before):
        return {n: hk.LAUNCHES[n] - before[n] for n in hk.KERNELS}

    def answer(sess, q, where):
        res = sess.execute(queries[q])
        torch.cuda.synchronize()
        try:
            checks[q](res, want[q])
        except AssertionError as e:
            failures.append(f"{where} {q}: {e}")
        if res.retries:
            failures.append(f"{where} {q}: {res.retries} retries")
        return res

    def counter(sess, name):
        return sess.stats.counters.snapshot()[name]

    # -- O0: restore point --------------------------------------------------
    admin = connect()
    t0 = time.perf_counter()
    admin.execute("select citus_create_restore_point('pre_ops')")
    log(f"phase14 O0: citus_create_restore_point('pre_ops') "
        f"{time.perf_counter() - t0!r} s ({ident})")

    # -- O1: split lineitem's first shard (orders splits with it) -----------
    warm = connect()
    for _ in range(2):
        for q in ("Q1", "Q3"):
            answer(warm, q, "O1 warm before")
    shard = admin.catalog.table_shards("lineitem")[0]
    mid = (shard.min_value + shard.max_value) // 2
    before_ids = {t: {s.shard_id for s in admin.catalog.table_shards(t)}
                  for t in ("lineitem", "orders")}
    parents = [os.path.join(data_dir, "tables", t, f"shard_{sid}")
               for t in ("lineitem", "orders")
               for sid in before_ids[t]
               if admin.catalog.shards[sid].shard_index
               == shard.shard_index]
    t0 = time.perf_counter()
    admin.execute(f"select citus_split_shard_by_split_points("
                  f"{shard.shard_id}, '{mid}')")
    split_s = time.perf_counter() - t0
    rewritten = {t: sum(admin.store.shard_row_count(t, s.shard_id)
                        for s in admin.catalog.table_shards(t)
                        if s.shard_id not in before_ids[t])
                 for t in ("lineitem", "orders")}
    counts = {t: len(admin.catalog.table_shards(t))
              for t in ("lineitem", "orders")}
    log(f"phase14 O1: split in {split_s!r} s, rows rewritten {rewritten}, "
        f"shards {counts} ({ident})")
    if counts != {"lineitem": 9, "orders": 9}:
        failures.append(f"O1: shard counts {counts}")
    fresh = connect()
    after_split = dict(hk.LAUNCHES)
    for name, sess in (("warm", warm), ("fresh", fresh)):
        before = dict(hk.LAUNCHES)
        t0 = time.perf_counter()
        for q in ("Q1", "Q3", "high_card_groupby"):
            answer(sess, q, f"O1 {name}")
        got = launches_since(before)
        log(f"phase14 O1 {name} session: Q1, Q3, GROUP BY in "
            f"{time.perf_counter() - t0!r} s, launches {got}")
    o1 = launches_since(after_split)
    for k in ("dense_grid_sum", "bucketed_probe", "bucketed_groupby_sums",
              "dict_decode"):
        if o1[k] <= 0:
            failures.append(f"O1: {k} never launched")
    sweeper = connect(defer_shard_delete_interval_ms=200)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 2.0 and (
            any(os.path.isdir(p) for p in parents)
            or sweeper.maintenance.cleanup_runs == 0):
        time.sleep(0.05)
    pending = cleanup_registry_for(data_dir).pending()
    log(f"phase14 O1 cleanup: parents gone "
        f"{not any(os.path.isdir(p) for p in parents)}, daemon sweeps "
        f"{sweeper.maintenance.cleanup_runs}, pending records "
        f"{len(pending)} after {time.perf_counter() - t0!r} s")
    if any(os.path.isdir(p) for p in parents) or pending \
            or not sweeper.maintenance.cleanup_runs:
        failures.append("O1: the parents' cleanup did not finish in 2 s")
    clean("O1", [warm, fresh, sweeper])

    # -- O2: rebalance as a background job under query traffic -------------
    admin.execute("select citus_add_node('extra:1')")
    reb = connect(rebalance_improvement_threshold=0.05)
    readers = [connect() for _ in range(2)]
    bad: list = []

    def read(sess):
        try:
            for q in ("Q1", "Q3"):
                checks[q](sess.execute(queries[q]), want[q])
        except Exception as e:  # noqa: BLE001 — gathered as a failure
            bad.append(repr(e))

    threads = [threading.Thread(target=read, args=(s,)) for s in readers]
    bg0 = {r["tenant"]: r["admitted_total"]
           for r in reb.wlm.snapshot()["tenants"]
           if r["priority"] == "background"}.get("background", 0)
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    job_id = int(reb.execute("select citus_rebalance_start()"
                             ).rows()[0][0])
    progress = []
    while reb.jobs.job_status(job_id).status.value in ("scheduled",
                                                       "running"):
        rows = reb.execute("select get_rebalance_progress()").rows()
        progress.append(rows[-1] if rows else None)
        time.sleep(0.01)
    status = reb.execute("select citus_rebalance_wait()").rows()[0][0]
    for t in threads:
        t.join()
    reb_s = time.perf_counter() - t0
    job = reb.jobs.job_status(job_id)
    moves = len(job.tasks) - 1  # the last task finalizes the progress
    bg = {r["tenant"]: r["admitted_total"]
          for r in reb.wlm.snapshot()["tenants"]
          if r["priority"] == "background"}.get("background", 0) - bg0
    nodes = {reb.catalog.active_placement(s.shard_id).node_id
             for s in reb.catalog.table_shards("lineitem")}
    log(f"phase14 O2: job {job_id} {status} in {reb_s!r} s, {moves} moves, "
        f"{bg} tasks admitted at class background, progress samples "
        f"{progress[:1] + progress[-1:]}, lineitem on nodes "
        f"{sorted(nodes)}; 2 reader threads x (Q1, Q3) {bad or 'right'} "
        f"({ident})")
    if status != "done" or moves <= 0 or bg < moves + 1 or bad \
            or len(nodes) < 2:
        failures.append(f"O2: status {status}, moves {moves}, background "
                        f"admissions {bg}, nodes {nodes}, readers {bad}")
    clean("O2", [reb] + readers)

    # -- O3: read-repair, scrub, and a clean error without a replica --------
    loader = connect(shard_replication_factor=2)
    t0 = time.perf_counter()
    # phase 1's lineitem: the seeded NULLs and want["nullable"] are its
    n_r2 = load_nullable(loader, data["lineitem"], tpch, R2_TABLE,
                         R2_COLUMNS, dist="l_shipdate")
    stripes = primary_stripes(loader, R2_TABLE)
    copies = [p for s in loader.catalog.table_shards(R2_TABLE)
              for r in loader.store.manifest(R2_TABLE)["shards"].get(
                  str(s.shard_id), [])
              for p in loader.store._copy_paths(R2_TABLE, s.shard_id,
                                                r["file"])]
    log(f"phase14 O3: {R2_TABLE} {n_r2} rows, {len(stripes)} stripes, "
        f"{len(copies)} copies, loaded in {time.perf_counter() - t0!r} s")
    if len(copies) != 2 * len(stripes):
        failures.append(f"O3: {len(copies)} copies of {len(stripes)} "
                        "stripes")
    clean("O3 load", [loader])
    for mode in ("off", "host", "device"):
        sess = connect(scan_pipeline=mode)
        rr0 = counter(sess, "read_repairs_total")
        before = dict(hk.LAUNCHES)
        t0 = time.perf_counter()
        with inject("storage.stripe_bitflip", require_fired=True):
            res = sess.execute(R2_SQL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launches_since(before)
        rr = counter(sess, "read_repairs_total") - rr0
        try:
            check_nullable(res, want["nullable"])
        except AssertionError as e:
            failures.append(f"O3 {mode}: {e}")
        bad_files = []
        for p in copies:
            try:
                integrity.verify_stripe_file(p)
            except CorruptStripe:
                bad_files.append(p)
        log(f"phase14 O3 {mode}: bitflip armed, answered in {wall!r} s, "
            f"read repairs {rr}, unhealed copies {len(bad_files)}, "
            f"launches {got}")
        if rr != 1 or bad_files or sess.catalog._suspect_placements:
            failures.append(f"O3 {mode}: {rr} read repairs, unhealed "
                            f"{bad_files}")
        if mode == "device":
            if got["bit_unpack"] <= 0 or got["dict_decode"] <= 0:
                failures.append(f"O3 device: launches {got}")
            # a fresh session: the first one's feeds are cached
            clean("O3 device", [sess])
            sess = connect(scan_pipeline=mode)
            with inject("storage.stripe_bitflip", require_fired=True):
                lines = [r[0] for r in sess.execute(
                    "explain analyze " + R2_SQL).rows()]
            line = next((x for x in lines if x.startswith("Integrity:")),
                        None)
            log(f"phase14 O3 EXPLAIN ANALYZE: {line}")
            if line is None or "read repairs=1" not in line:
                failures.append(f"O3: Integrity line {line}")
        clean(f"O3 {mode}", [sess])
    # a bit flipped at rest: the scrub quarantines and re-replicates
    at_rest = stripes[len(stripes) // 2]
    integrity.flip_one_bit(at_rest)
    sess = connect()
    t0 = time.perf_counter()
    res = sess.execute("select citus_check_cluster()")
    scrub_s = time.perf_counter() - t0
    scrub = dict(zip(res.column_names, res.rows()[0]))
    rr0 = counter(sess, "read_repairs_total")
    try:
        check_nullable(sess.execute(R2_SQL), want["nullable"])
    except AssertionError as e:
        failures.append(f"O3 after the scrub: {e}")
    rr = counter(sess, "read_repairs_total") - rr0
    log(f"phase14 O3 at rest: citus_check_cluster() in {scrub_s!r} s: "
        f"{scrub}; the next run repaired {rr}")
    clean("O3 scrub", [sess])
    if scrub["corrupt_copies"] != 1 or scrub["quarantined"] != 1 or \
            scrub["repaired"] != 1 or scrub["unrepairable"] or rr:
        failures.append(f"O3 at rest: {scrub}, {rr} read repairs after")
    try:
        integrity.verify_stripe_file(at_rest)
    except CorruptStripe as e:
        failures.append(f"O3 at rest: not re-replicated ({e})")
    # factor 1: no copy to answer from
    victim = primary_stripes(admin, "lineitem")[0]
    col = flipped_column(victim)
    integrity.flip_one_bit(victim)
    for mode in ("off", "host", "device"):
        sess = connect(scan_pipeline=mode)
        try:
            sess.execute(f"select count(*), count({col}) from lineitem")
            failures.append(f"O3 factor 1 {mode}: no CorruptStripe")
        except CorruptStripe:
            pass
        clean(f"O3 factor 1 {mode}", [sess])
    log(f"phase14 O3 factor 1: a bit flipped in {col} of lineitem: a "
        "clean CorruptStripe in off, host and device, no transient bytes "
        "left")

    # -- O4: restore --------------------------------------------------------
    clean("O4", list(open_sessions))
    t0 = time.perf_counter()
    restore_cluster(data_dir, "pre_ops")
    restore_s = time.perf_counter() - t0
    sess = connect()
    n_li = len(sess.catalog.table_shards("lineitem"))
    for q in ("Q1", "Q3"):
        answer(sess, q, "O4")
    log(f"phase14 O4: restore_cluster in {restore_s!r} s; lineitem "
        f"{n_li} shards, {R2_TABLE} "
        f"{'gone' if not sess.catalog.has_table(R2_TABLE) else 'kept'}; "
        f"Q1 and Q3 equal numpy ({ident})")
    if n_li != 8 or sess.catalog.has_table(R2_TABLE):
        failures.append(f"O4: {n_li} shards after the restore")
    clean("O4", [sess])

    launched = dict(hk.LAUNCHES)
    wall = time.perf_counter() - t_phase
    log(f"phase14: {wall!r} s (budget {PHASE14_BUDGET_S} s), launches "
        f"{launched}")
    if wall > PHASE14_BUDGET_S:
        failures.append(f"phase 14 took {wall!r} s")
    missing = [k for k in hk.KERNELS if launched[k] <= 0]
    if missing:
        failures.append(f"phase 14: {missing} never launched")
    if failures:
        raise AssertionError(f"phase 14: {failures}")
    return launched


# -- phase 15: the compiled form ---------------------------------------------

PHASE15_BUDGET_S = 150.0
COMPILED_REPS = 6     # warm runs per arm, eager and replayed in turns
FANIN_SESSIONS = 8
ORDERS_SQL = ("select o_orderpriority, count(*), sum(o_totalprice) "
              "from orders group by o_orderpriority order by 1")
NEW_ORDER = ("insert into orders values (8000001, 1, 'O', 1234.5, "
             "date '1998-01-01', '1-URGENT', 'Clerk#000000001', 0, "
             "'phase15')")
# the device dispatch of a resident run: the eager program or the replay
DISPATCH = {("compiler.py", "_dispatch"), ("graphs.py", "replay")}
# what a replayed resident query launches: K4 and K5 decode in the cold
# feed build, which a warm run skips
REPLAYED_KERNELS = ("dense_grid_sum", "bucketed_probe",
                    "bucketed_groupby_sums")
# a fresh process on the data_dir: connect, then the first statement
FRESH_CHILD = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
t0 = time.perf_counter()
import torch
import citus_tpu_torch as ct
from citus_tpu_torch.stats import counters as sc
sess = ct.connect(sys.argv[2], serving_result_cache_bytes=0,
                  warmup_budget_ms=int(sys.argv[3]),
                  warmup_top_shapes=4096)
t1 = time.perf_counter()
res = sess.execute(sys.argv[4])
torch.cuda.synchronize()
t2 = time.perf_counter()
snap = sess.stats.counters.snapshot()
out = {"import_connect_s": t1 - t0, "first_statement_s": t2 - t1,
       "retries": res.retries, "rows": res.row_count,
       "dispatch": sess.executor.last_dispatch()[0],
       "warmup_armed": snap.get(sc.WARMUP_COMPILES_TOTAL, 0),
       "exec_cache_hits": snap.get(sc.EXEC_CACHE_HITS_TOTAL, 0)}
sess.close()
print(json.dumps(out))
"""


def numpy_orders(orders, extra=()) -> list:
    """ORDERS_SQL over the generated orders plus `extra` (priority,
    price) rows."""
    import numpy as np

    pr = np.concatenate([orders["o_orderpriority"].astype(str),
                         np.asarray([p for p, _ in extra], dtype=str)])
    price = np.concatenate([orders["o_totalprice"].astype(np.float64),
                            np.asarray([x for _, x in extra],
                                       dtype=np.float64)])
    keys, inv = np.unique(pr, return_inverse=True)
    cnt = np.bincount(inv, minlength=len(keys))
    tot = np.bincount(inv, weights=price, minlength=len(keys))
    return [(str(k), int(c), float(t)) for k, c, t in zip(keys, cnt, tot)]


class eager_arm:
    """Inside the block `sess` runs every resident plan through the
    compiler's own eager dispatch: its captured graphs stay as they
    are and are not replayed."""

    def __init__(self, sess):
        self.ex = sess.executor

    def __enter__(self):
        self.ex._graph_for = lambda *a, **k: None
        return self

    def __exit__(self, *exc):
        del self.ex._graph_for
        return False


def phase15(ct, hk, data_dir, data, queries, checks, want,
            ident) -> tuple[dict, dict]:
    """Phase 15 (the compiled form).  Returns each kernel's launches
    over the phase and under the replays of step G1."""
    import gc
    import threading

    import torch

    from citus_tpu_torch.executor.execcache import exec_cache_for
    from citus_tpu_torch.executor.hbm import accountant_for
    from citus_tpu_torch.stats import counters as sc

    t_phase = time.perf_counter()
    failures: list = []
    acc = accountant_for(data_dir)
    ec = exec_cache_for(data_dir)
    # graphs of earlier phases' sessions go first: the phase's own
    # captures are then all the ledger's `graph` bytes
    acc.release_graphs()
    gc.collect()
    graph0 = acc.live_bytes("graph")
    hk.reset_launch_counts()

    def launches_of(fn):
        before = dict(hk.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        return out, {n: hk.LAUNCHES[n] - before[n] for n in hk.KERNELS}

    def wall(sess, sql):
        t0 = time.perf_counter()
        res = sess.execute(sql)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    # -- G1: eager against replayed, per main-path query ---------------------
    sess = rerun_connect(ct, data_dir)
    replayed_launches = {n: 0 for n in hk.KERNELS}
    for q, sql in queries.items():
        ordered = "order by" in sql.lower()
        first, cold = launches_of(lambda: sess.execute(sql))
        checks[q](first, want[q])
        how_first = sess.executor.last_dispatch()[0]
        res = sess.execute(sql)  # captures now, if the first run did not
        rep, rl = launches_of(lambda: sess.execute(sql))
        how = sess.executor.last_dispatch()
        with eager_arm(sess):
            eag = sess.execute(sql)
            how_eager = sess.executor.last_dispatch()[0]
        checks[q](rep, want[q])
        checks[q](eag, want[q])
        diff = same_rows(rep.rows(), eag.rows(), ordered)
        if diff:
            failures.append(f"G1 {q}: replayed against eager: {diff}")
        if how[0] != "replayed" or how_eager != "eager":
            failures.append(f"G1 {q}: dispatched {how} / {how_eager}, not "
                            "replayed / eager")
        for n in REPLAYED_KERNELS:
            replayed_launches[n] += rl[n]
        carried = [n for n, cq in CARRIER.items()
                   if cq == q and n in REPLAYED_KERNELS]
        for n in carried:
            if rl[n] <= 0:
                failures.append(f"G1 {q}: {n} not counted under replay")
        best = {"eager": None, "replayed": None}
        for i in range(COMPILED_REPS):
            for arm in (("eager", "replayed") if i % 2 == 0
                        else ("replayed", "eager")):
                if arm == "eager":
                    with eager_arm(sess):
                        dt, _r = wall(sess, sql)
                else:
                    dt, _r = wall(sess, sql)
                best[arm] = dt if best[arm] is None else min(best[arm], dt)
        with eager_arm(sess):
            prof_e = profile_query(sess, sql)
            syn_e = host_syncs(sess, sql, within=DISPATCH)
        prof_r = profile_query(sess, sql)
        syn_r = host_syncs(sess, sql, within=DISPATCH)
        if syn_r:
            failures.append(f"G1 {q}: the replayed dispatch synchronizes "
                            f"at {syn_r}")
        log(f"phase15 G1 {q}: first run dispatched {how_first} (launches "
            f"{cold}), warm best of {COMPILED_REPS} eager "
            f"{best['eager'] * 1e3!r} ms, replayed "
            f"{best['replayed'] * 1e3!r} ms; idle share eager "
            f"{prof_e['device_idle_share']!r} (busy "
            f"{prof_e['device_busy_ms']!r} of {prof_e['wall_ms']!r} ms), "
            f"replayed {prof_r['device_idle_share']!r} (busy "
            f"{prof_r['device_busy_ms']!r} of {prof_r['wall_ms']!r} ms); "
            f"dispatch host syncs eager {syn_e}, replayed {syn_r}; "
            f"launches under one replay {rl}; rows equal to eager and "
            f"numpy ({ident})")
    transient = acc.transient_bytes()
    if transient:
        failures.append(f"G1: {transient} transient ledger bytes left")

    # -- G2: eight sessions on one cold key ----------------------------------
    fan = [rerun_connect(ct, data_dir) for _ in range(FANIN_SESSIONS)]
    want_o = numpy_orders(data["orders"])
    compiles0 = ec.snapshot()["compiles_total"]
    rows_seen: list = []
    errors: list = []
    start = threading.Barrier(FANIN_SESSIONS)
    mu = threading.Lock()

    def fan_in(s):
        try:
            for _ in range(3):
                start.wait()
                rows = s.execute(ORDERS_SQL).rows()
                with mu:
                    rows_seen.append(rows)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
            start.abort()

    threads = [threading.Thread(target=fan_in, args=(s,)) for s in fan]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    fan_s = time.perf_counter() - t0
    captures = ec.snapshot()["compiles_total"] - compiles0
    deduped = sum(s.stats.counters.snapshot().get(
        sc.COMPILES_DEDUPED_TOTAL, 0) for s in fan)
    bad = [r for r in rows_seen if same_rows(r, want_o, True)]
    if errors or bad or captures != 1 or deduped != FANIN_SESSIONS - 1:
        failures.append(f"G2: {captures} captures, {deduped} deduped, "
                        f"errors {errors}, {len(bad)} wrong answers")
    log(f"phase15 G2: {FANIN_SESSIONS} sessions x 3 runs of one cold key "
        f"in {fan_s!r} s: {captures} capture, compiles_deduped_total "
        f"{deduped}, {len(rows_seen)} answers equal to numpy ({ident})")

    # -- G3: an INSERT between two replays -----------------------------------
    s = fan[0]
    before_rows = s.execute(ORDERS_SQL).rows()
    how_before = s.executor.last_dispatch()[0]
    s.execute(NEW_ORDER)
    # the new data version's feed keys run eager once, then capture
    after_rows = s.execute(ORDERS_SQL).rows()
    how_after = s.executor.last_dispatch()[0]
    again_rows = s.execute(ORDERS_SQL).rows()
    how_again = s.executor.last_dispatch()[0]
    with eager_arm(s):
        eager_rows = s.execute(ORDERS_SQL).rows()
    want_new = numpy_orders(data["orders"], [("1-URGENT", 1234.5)])
    diffs = [same_rows(after_rows, eager_rows, True),
             same_rows(after_rows, want_new, True),
             same_rows(again_rows, want_new, True)]
    if how_before != "replayed" or how_after != "eager" or \
            how_again != "captured" or any(diffs) or \
            not same_rows(before_rows, after_rows, True):
        failures.append(f"G3: before {how_before}, after {how_after} then "
                        f"{how_again}, diffs {diffs}")
    log(f"phase15 G3: replayed before the INSERT, {how_after} and then "
        f"{how_again} after it; '1-URGENT' count {before_rows[0][1]} -> "
        f"{after_rows[0][1]}, equal to the eager run and to numpy")
    for f in fan:
        f.close()
    del fan, s

    # -- G4: the OOM ladder's first rung releases the graph pools -------------
    gc.collect()
    live = acc.live_bytes("graph")
    n_graphs = acc.graph_count()
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    freed = sess.executor._evict_for_oom()
    gc.collect()
    torch.cuda.synchronize()
    after = acc.live_bytes("graph")
    reserved_after = torch.cuda.memory_reserved()
    if not (live > graph0 and n_graphs and after == graph0
            and acc.graph_count() == 0 and freed >= n_graphs):
        failures.append(f"G4: graph bytes {graph0} -> {live} -> {after}, "
                        f"{n_graphs} graphs, {acc.graph_count()} left")
    # Q1 re-runs right; Q3 converges its key again: G3's order moved
    # o_orderkey's range, which the join's fingerprint holds, and G5's
    # fresh processes run this key
    for q in ("Q1", "Q3"):
        again, _l = launches_of(lambda: sess.execute(queries[q]))
        checks[q](again, want[q])
    log(f"phase15 G4: {n_graphs} graphs holding {live} bytes (ledger "
        f"'graph', {graph0} before the phase) released by the ladder's "
        f"first rung to {after}; allocator reserve {reserved} -> "
        f"{reserved_after} bytes; Q1 and Q3 then re-run right")
    sess.close()
    del sess
    gc.collect()

    # -- G5: a fresh process, with and without the warmup --------------------
    fresh = {}
    for arm, budget in (("warmup", 60_000), ("no warmup", 0)):
        out = subprocess.run(
            [sys.executable, "-c", FRESH_CHILD, HERE, data_dir,
             str(budget), queries["Q3"]],
            capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise AssertionError(f"G5 {arm}: exit {out.returncode}\n"
                                 f"{out.stderr[-3000:]}")
        fresh[arm] = json.loads(out.stdout.strip().splitlines()[-1])
        log(f"phase15 G5 {arm}: {fresh[arm]} ({ident})")
    # a persisted key: no capacity retry, and captured at its first run
    # (armed by the warmup, or resolved from the cache without it)
    if any(f["retries"] or f["dispatch"] != "captured"
           for f in fresh.values()) or \
            not fresh["warmup"]["warmup_armed"] or \
            fresh["warmup"]["exec_cache_hits"] or \
            fresh["no warmup"]["exec_cache_hits"] != 1:
        failures.append(f"G5: {fresh}")

    wall_s = time.perf_counter() - t_phase
    launched = dict(hk.LAUNCHES)
    log(f"phase15: {wall_s!r} s (budget {PHASE15_BUDGET_S} s), launches "
        f"{launched}, under G1's replays {replayed_launches}")
    if wall_s > PHASE15_BUDGET_S:
        failures.append(f"phase 15 took {wall_s!r} s")
    if failures:
        raise AssertionError("phase 15: " + "; ".join(failures))
    return launched, replayed_launches


# -- phase 16: the mesh -------------------------------------------------------

PHASE16_BUDGET_S = 150.0
MESH_POSITIONS = 4
# phase 16's replication-factor-2 data_dir (step M5)
RF2_SF = 0.1
# what a 4-position session must launch on Q1, Q3 and the GROUP BY
MESH_KERNELS = ("dense_grid_sum", "bucketed_probe", "bucketed_groupby_sums")
ROUTE_WHERE = "l_quantity < 10"


def _orders_m(sql: str) -> str:
    import re

    return re.sub(r"\borders\b", "orders_m", sql)


def phase16(ct, hk, data_dir, data, li, queries, checks, want,
            ident) -> dict:
    """Phase 16 (the mesh).  Returns each kernel's launches over the
    phase."""
    import numpy as np
    import torch

    from citus_tpu_torch.executor.insert_select import _device_shard_map
    from citus_tpu_torch.ingest import tpch
    from citus_tpu_torch.planner.plan import table_placement
    from citus_tpu_torch.stats import counters as sc
    from citus_tpu_torch.utils.faultinjection import simulate_mesh

    t_phase = time.perf_counter()
    n = MESH_POSITIONS
    launched = {k: 0 for k in hk.KERNELS}
    mesh_launched = {k: 0 for k in hk.KERNELS}
    hk.reset_launch_counts()

    def step(sess, label, fn, mesh=True):
        snap0 = sess.stats.counters.snapshot()
        before = dict(hk.LAUNCHES)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        d = {k: hk.LAUNCHES[k] - before[k] for k in hk.KERNELS}
        for k, v in d.items():
            launched[k] += v
            if mesh:
                mesh_launched[k] += v
        shuffled = (sess.stats.counters.snapshot().get(
            sc.SHUFFLE_BYTES_TOTAL, 0) - snap0.get(sc.SHUFFLE_BYTES_TOTAL, 0))
        log(f"phase16 {label}: wall {dt!r} s, all_to_all bytes {shuffled}, "
            f"rows per position in {getattr(res, 'device_rows_in', None)} "
            f"out {getattr(res, 'device_rows', None)}, launches {d} "
            f"({ident})")
        return res, shuffled

    # -- M0: orders_m laid out for 2 positions -----------------------------
    s2 = rerun_connect(ct, data_dir, n_devices=2)
    step(s2, "M0 citus_rebalance_mesh() at 2 positions",
         lambda: s2.execute("select citus_rebalance_mesh()"), mesh=False)
    s2.execute(tpch.SCHEMAS["orders"].replace("create table orders",
                                              "create table orders_m", 1))
    s2.execute("select create_distributed_table('orders_m', 'o_orderkey', "
               "8)")
    step(s2, "M0 insert into orders_m select * from orders",
         lambda: s2.execute("insert into orders_m select * from orders"),
         mesh=False)
    s2.close()

    # -- M1: a 4-position session; rebalance over 4 nodes ------------------
    s4 = rerun_connect(ct, data_dir, n_devices=n)
    used = sorted(set(table_placement(s4.catalog, "orders_m", n)))
    if used != [0, 1]:
        raise AssertionError(f"M1: orders_m on positions {used}, not 2")
    q3m = _orders_m(queries["Q3"])
    res, _ = step(s4, "M1 Q3 over orders_m on 2 of 4 positions",
                  lambda: s4.execute(q3m))
    checks["Q3"](res, want["Q3"])
    res, _ = step(s4, "M1 citus_rebalance_mesh() at 4 positions",
                  lambda: s4.execute("select citus_rebalance_mesh()"))
    log(f"phase16 M1 rebalance: {dict(zip(res.column_names, res.rows()[0]))}"
        f"; orders_m on positions "
        f"{sorted(set(table_placement(s4.catalog, 'orders_m', n)))}")
    res, _ = step(s4, "M1 Q3 over orders_m after the rebalance",
                  lambda: s4.execute(q3m))
    checks["Q3"](res, want["Q3"])
    if min(res.device_rows_in) <= 0:
        raise AssertionError(f"M1: a position fed no rows: "
                             f"{res.device_rows_in}")

    # -- M2: the main path at 4 positions ----------------------------------
    s1 = rerun_connect(ct, data_dir)
    for q, sql in queries.items():
        res, shuffled = step(s4, f"M2 {q} at {n} positions",
                             lambda: s4.execute(sql))
        checks[q](res, want[q])
        one = s1.execute(sql)
        diff = same_rows(res.rows(), one.rows(), "order by" in sql.lower())
        if diff:
            raise AssertionError(f"M2 {q}: {n} positions against one: "
                                 f"{diff}")
        if q == "Q3" and shuffled <= 0:
            raise AssertionError("M2 Q3: the repartition moved no bytes")
        step(s4, f"M2 {q} warm", lambda: s4.execute(sql))
    s1.close()
    missing = [k for k in MESH_KERNELS if mesh_launched[k] <= 0]
    if missing:
        raise AssertionError(f"M2: {missing} never launched at {n} "
                             "positions")

    # -- M3: a device-routed INSERT..SELECT --------------------------------
    s4.execute("create table li_route (l_orderkey bigint, "
               "l_quantity double precision)")
    s4.execute(f"select create_distributed_table('li_route', 'l_orderkey', "
               f"{n})")
    if _device_shard_map(s4, s4.catalog.table("li_route")) is None:
        raise AssertionError("M3: li_route is not one shard per position")
    res, shuffled = step(
        s4, "M3 insert into li_route select ... from lineitem",
        lambda: s4.execute("insert into li_route select l_orderkey, "
                           f"l_quantity from lineitem where {ROUTE_WHERE}"))
    if shuffled <= 0:
        raise AssertionError("M3: the output shuffle moved no bytes")
    per_pos = [s4.store.shard_row_count("li_route", sh.shard_id)
               for sh in s4.catalog.table_shards("li_route")]
    from citus_tpu_torch.catalog.distribution import (
        hash_token,
        shard_index_for_token_ranges,
    )

    keys = np.asarray(li["l_orderkey"])[np.asarray(li["l_quantity"]) < 10]
    want_pos = np.bincount(shard_index_for_token_ranges(
        hash_token(keys.astype(np.int64)),
        s4.catalog.shard_mins("li_route")), minlength=n).tolist()
    log(f"phase16 M3 rows per position {per_pos}, numpy {want_pos}")
    if per_pos != want_pos:
        raise AssertionError(f"M3: rows per position {per_pos} against "
                             f"numpy {want_pos}")

    # -- M4: drain position 3 ----------------------------------------------
    res, _ = step(s4, "M4 citus_drain_device(3)",
                  lambda: s4.execute("select citus_drain_device(3)"))
    log(f"phase16 M4 drain: {dict(zip(res.column_names, res.rows()[0]))}")
    res, _ = step(s4, "M4 Q3 over orders_m after the drain",
                  lambda: s4.execute(q3m))
    checks["Q3"](res, want["Q3"])
    if res.device_rows_in[3] != 0:
        raise AssertionError(f"M4: the drained position fed "
                             f"{res.device_rows_in[3]} rows")
    s4.execute("drop table li_route")
    s4.execute("drop table orders_m")
    s4.close()

    # -- M5: a position killed in the middle of Q3 (replication 2) ---------
    rf_dir = data_dir + "_rf2"
    small = tpch.generate_tables(RF2_SF, seed=3)
    want_small = numpy_q3(small["customer"], small["orders"],
                          small["lineitem"])
    rf = rerun_connect(ct, rf_dir, n_devices=n, shard_replication_factor=2)
    t0 = time.perf_counter()
    tpch.load_tables(rf, small)
    log(f"phase16 M5 load SF{RF2_SF} at replication 2: "
        f"{time.perf_counter() - t0!r} s")
    res, _ = step(rf, "M5 Q3 at 4 positions",
                  lambda: rf.execute(queries["Q3"]))
    check_q3(res, want_small)
    with simulate_mesh(kill={2}, after=2) as sim:
        res, _ = step(rf, "M5 Q3 with position 2 killed mid-statement",
                      lambda: rf.execute(queries["Q3"]))
    check_q3(res, want_small)
    snap = rf.stats.counters.snapshot()
    log(f"phase16 M5: {sim.trips} MeshSim trips, positions now "
        f"{rf.mesh.ids}, mesh_failovers {snap[sc.MESH_FAILOVERS_TOTAL]}, "
        f"queries_rescued {snap[sc.QUERIES_RESCUED_TOTAL]}")
    if rf.mesh.ids != (0, 1, 3) or snap[sc.MESH_FAILOVERS_TOTAL] != 1:
        raise AssertionError(f"M5: positions {rf.mesh.ids}, failovers "
                             f"{snap[sc.MESH_FAILOVERS_TOTAL]}")
    rf.close()
    shutil.rmtree(rf_dir, ignore_errors=True)

    total = time.perf_counter() - t_phase
    log(f"phase16: {total!r} s, launches {launched} ({ident})")
    if total > PHASE16_BUDGET_S:
        raise AssertionError(f"phase 16 took {total:.1f} s, over its "
                             f"{PHASE16_BUDGET_S} s budget")
    return launched


# -- phase 17: fault tolerance under chaos, and the slab loader -----------

PHASE17_BUDGET_S = 90.0
# at SF 0.75 Q3's order-key directory (keys 4i + 1: 4.5M wide) is over
# the bucketed probe's PROBE_BUCKET_MIN_EXTENT (2^22), so K2 serves it
# (at SF 0.5 it is 3.0M wide); three order slabs of 375,000
SLAB_SF = 0.75
SLAB_ORDERS = 375_000
SLAB_KERNELS = ("dense_grid_sum", "bucketed_probe", "bucketed_groupby_sums")
SLAB_CHECK_KEY = 40_001  # the first 10,000 orders (keys 4i + 1)
SOAK = {"n_ops": 45, "seed": 1234, "fault_rate": 0.35}
SOAK_KERNELS = ("dense_grid_sum",)


def phase17(ct, hk, tmp, ident) -> dict:
    """Phase 17.  Returns each kernel's launches over the phase."""
    import torch

    from citus_tpu_torch.ingest import tpch
    from citus_tpu_torch.ingest.tpch_slab import load_slabbed

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from test_torch_chaos import run_soak

    # Q1 (K1), Q3 (K2) and the high-cardinality GROUP BY (K3's carrier,
    # as on the main path)
    queries = {"Q1": tpch.QUERIES["Q1"], "Q3": tpch.QUERIES["Q3"],
               "high_card_groupby": HIGH_CARD_SQL}

    t_phase = time.perf_counter()
    launched = {k: 0 for k in hk.KERNELS}
    hk.reset_launch_counts()

    def recording(step, fn):
        """Run a step with every wrapper's inputs recorded; hold each
        kernel the step launched against its plain version on them."""
        recorders = {n: Recorder(hk, n) for n in hk.KERNELS}
        for r in recorders.values():
            r.install()
        before = dict(hk.LAUNCHES)
        try:
            out = fn()
        finally:
            for r in recorders.values():
                r.remove()
        d = {k: hk.LAUNCHES[k] - before[k] for k in hk.KERNELS}
        for name in hk.KERNELS:
            if d[name]:
                hold_kernel(name, kernel_case(hk, name, recorders[name].args),
                            f" (phase 17 {step})")
        return out, d

    def run(sess, label, sql):
        before = dict(hk.LAUNCHES)
        t0 = time.perf_counter()
        res = sess.execute(sql)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        d = {k: hk.LAUNCHES[k] - before[k] for k in hk.KERNELS}
        log(f"phase17 {label}: {res.row_count} rows, wall {dt!r} s, "
            f"launches {d} ({ident})")
        return res

    # -- S1: slab load, then Q1, Q3 and the GROUP BY on the card ----------
    def s1_step():
        slab_dir = os.path.join(tmp, "slab")
        sess = rerun_connect(ct, slab_dir)
        if sess.device.type != "cuda":
            raise AssertionError(f"S1: the session runs on {sess.device}")
        marks = [time.perf_counter()]

        def progress(table, done, total):
            marks.append(time.perf_counter())
            log(f"phase17 S1 slab {len(marks) - 1} ({table}): {done} of "
                f"{total} rows, {marks[-1] - marks[-2]!r} s")

        counts = load_slabbed(sess, SLAB_SF, seed=0, shard_count=8,
                              slab_orders=SLAB_ORDERS, progress=progress)
        load_s = marks[-1] - marks[0]
        rows = sum(counts.values())
        log(f"phase17 S1 load_slabbed SF{SLAB_SF}: {counts} in {load_s!r} s, "
            f"{rows / load_s!r} rows/s ({ident})")
        want = tpch.table_rows(SLAB_SF)
        for t in ("customer", "orders"):
            if counts[t] != want[t]:
                raise AssertionError(f"S1: {t} {counts[t]} rows, "
                                     f"table_rows {want[t]}")
        for t, n in counts.items():
            got = sess.execute(f"select count(*) from {t}").rows()[0][0]
            if int(got) != n:
                raise AssertionError(f"S1: {t} reads {got} rows, loaded {n}")
        answers = {}
        for q, sql in queries.items():
            for how in ("first run", "warm"):
                res = run(sess, f"S1 {q} {how}", sql)
            answers[q] = res.rows()
        sess.close()
        cpu = rerun_connect(ct, slab_dir, device="cpu",
                            compute_dtype="float32")
        # the GROUP BY's 1.1M groups take the CPU session ~18 s: it is
        # held there on the orders below SLAB_CHECK_KEY, and whole by
        # its group count and totals
        hc = answers["high_card_groupby"]
        answers["high_card_groupby"] = [
            r for r in hc if int(r[0]) < SLAB_CHECK_KEY]
        queries["high_card_groupby"] = HIGH_CARD_SQL.replace(
            "group by", f"where l_orderkey < {SLAB_CHECK_KEY} group by")
        for q, sql in queries.items():
            t0 = time.perf_counter()
            diff = same_rows(answers[q], cpu.execute(sql).rows(),
                             "order by" in sql.lower())
            if diff:
                raise AssertionError(f"S1 {q}: card against CPU: {diff}")
            log(f"phase17 S1 {q} matches the CPU session "
                f"({time.perf_counter() - t0!r} s on the CPU)")
        qty = float(cpu.execute(
            "select sum(l_quantity) from lineitem").rows()[0][0])
        got = (len(hc), sum(int(r[1]) for r in hc),
               sum(float(r[2]) for r in hc))
        if got[:2] != (counts["orders"], counts["lineitem"]) or \
                not close(got[2], qty):
            raise AssertionError(f"S1 high_card_groupby: groups, rows, "
                                 f"sum {got} against orders "
                                 f"{counts['orders']}, lineitem "
                                 f"{counts['lineitem']}, CPU sum {qty}")
        log(f"phase17 S1 high_card_groupby: {got[0]} groups of "
            f"{got[1]} rows, sum(l_quantity) {got[2]!r} (CPU {qty!r})")
        cpu.close()
        shutil.rmtree(slab_dir, ignore_errors=True)

    _, s1 = recording("S1", s1_step)
    missing = [k for k in SLAB_KERNELS if s1[k] <= 0]
    if missing:
        raise AssertionError(f"S1: {missing} never launched")
    log(f"phase17 S1 launches {s1}; dict_decode (device-mode scan) "
        f"{s1['dict_decode']}")

    # -- S2: the chaos soak's smoke slice on the card -----------------------
    def s2_step():
        stats = run_soak(os.path.join(tmp, "chaos", "data"),
                         device="cuda", **SOAK)
        torch.cuda.synchronize()
        return stats

    stats, s2 = recording("S2", s2_step)
    log(f"phase17 S2 soak {SOAK}: ops {stats['ops']}, statements "
        f"{stats['stmts']}, armed faults {stats['armed']}, clean "
        f"failures {stats['clean_failures']}, reconciles "
        f"{stats['reconciled']}, device kills {stats['device_kills']}, "
        f"restart exec-cache hits {stats['restart_exec_cache_hits']}, "
        f"sanitizer violations {stats['violations']} (locks "
        f"{stats['locks_tracked']}, acquisitions "
        f"{stats['acquisitions']}, order edges "
        f"{stats['order_edges']}), wall {stats['wall_s']!r} s, "
        f"launches {s2} ({ident})")
    if stats["violations"] or stats["restarts"] != 1 or \
            not stats["restart_same_routing"] or \
            stats["restart_exec_cache_hits"] < 1 or stats["armed"] < 8:
        raise AssertionError(f"S2: {stats}")
    missing = [k for k in SOAK_KERNELS if s2[k] <= 0]
    if missing:
        raise AssertionError(f"S2: {missing} never launched")
    for step in (s1, s2):
        for k, v in step.items():
            launched[k] += v

    total = time.perf_counter() - t_phase
    log(f"phase17: {total!r} s, launches {launched} ({ident})")
    if total > PHASE17_BUDGET_S:
        raise AssertionError(f"phase 17 took {total:.1f} s, over its "
                             f"{PHASE17_BUDGET_S} s budget")
    return launched


def _spans_named(span, name):
    if span["name"] == name:
        yield span
    for c in span.get("children", ()):
        yield from _spans_named(c, name)


def warm_runs(sess, q, sql, rows, reps, ident) -> None:
    """Phase 7 for one query: best of `reps` warm runs, then one more
    under the profiler."""
    import torch

    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        sess.execute(sql)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    log(f"{q}: best of {reps} warm runs {best!r} s, {rows / best!r} "
        f"rows/s ({ident})")
    profile_query(sess, sql)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(HERE, "citus_tpu_torch")):
        print("chip_smoke: the citus_tpu_torch package is not next to this "
              "script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    import citus_tpu_torch as ct
    from citus_tpu_torch.executor.scanpipe import resolve_scan_mode
    from citus_tpu_torch.ingest import tpch
    from citus_tpu_torch.ops import hopper_kernels as hk

    t_start = time.perf_counter()
    ident = card_identity()
    log(ident)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    t0 = time.perf_counter()
    built = hk.build_all(verbose=True)
    log(f"build: {sorted(built)} in {time.perf_counter() - t0:.3f} s")
    for name, out in built.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")

    tmp = tempfile.mkdtemp(prefix="citus_port_smoke_")
    try:
        t0 = time.perf_counter()
        data = tpch.generate_tables(args.sf, seed=0)
        log(f"generate SF{args.sf}: {time.perf_counter() - t0:.3f} s")
        sess = rerun_connect(ct, os.path.join(tmp, "data"))
        t0 = time.perf_counter()
        counts = tpch.load_tables(sess, data)
        log(f"load {counts}: {time.perf_counter() - t0:.3f} s")
        li, orders, cust = data["lineitem"], data["orders"], data["customer"]
        t0 = time.perf_counter()
        counts["lineitem_nullable"] = load_nullable(sess, li, tpch)
        log(f"load lineitem_nullable {counts['lineitem_nullable']}: "
            f"{time.perf_counter() - t0:.3f} s")
        want = {"Q1": numpy_q1(li), "Q3": numpy_q3(cust, orders, li),
                "high_card_groupby": numpy_high_card(li),
                "nullable": numpy_nullable(li)}
        checks = {"Q1": check_q1, "Q3": check_q3,
                  "high_card_groupby": check_high_card,
                  "nullable": check_nullable}
        queries = {"Q1": tpch.QUERIES["Q1"], "Q3": tpch.QUERIES["Q3"],
                   "high_card_groupby": HIGH_CARD_SQL,
                   "nullable": NULLABLE_SQL}
        rows = {"Q1": counts["lineitem"],
                "Q3": counts["customer"] + counts["orders"]
                + counts["lineitem"],
                "high_card_groupby": counts["lineitem"],
                "nullable": counts["lineitem_nullable"]}
        log(f"scan_pipeline {sess.settings.get('scan_pipeline')!r} resolves "
            f"to {resolve_scan_mode(sess.settings, sess.device)!r}")

        # the main path, with the kernels' inputs recorded on the way
        recorders = {n: Recorder(hk, n) for n in hk.KERNELS}
        for r in recorders.values():
            r.install()
        per_query = {}
        try:
            hk.reset_launch_counts()
            for q, sql in queries.items():
                before = dict(hk.LAUNCHES)
                t0 = time.perf_counter()
                res = sess.execute(sql)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                checks[q](res, want[q])
                per_query[q] = {n: hk.LAUNCHES[n] - before[n]
                                for n in hk.KERNELS}
                log(f"{q}: {res.row_count} rows, matches numpy, first run "
                    f"{dt:.3f} s, kernel launches {per_query[q]}")
            launches = dict(hk.LAUNCHES)
        finally:
            for r in recorders.values():
                r.remove()
        for name, q in CARRIER.items():
            if per_query[q][name] <= 0:
                raise AssertionError(f"{name} never launched on the main "
                                     f"path's {q}")
        for q in ("Q1", "nullable"):  # one call per dense aggregate
            if per_query[q]["dense_grid_sum"] != 1:
                raise AssertionError(f"{q}: dense_grid_sum launched "
                                     f"{per_query[q]['dense_grid_sum']} "
                                     "times, not once")

        reports = [kernel_report(hk, n, recorders[n].args, launches[n])
                   for n in hk.KERNELS]

        scan_modes(ct, os.path.join(tmp, "data"), queries, checks, want,
                   ident)

        for q in ("Q1", "Q3", "high_card_groupby", "nullable"):
            warm_runs(sess, q, queries[q], rows[q], args.reps, ident)

        t0 = time.perf_counter()
        launched = tpch22(ct, hk, os.path.join(tmp, "data"), data,
                          args.reps, ident)
        log(f"tpch22: {time.perf_counter() - t0:.3f} s, launches {launched}")
        t0 = time.perf_counter()
        launched9 = phase9(ct, hk, os.path.join(tmp, "data"), data,
                           args.reps, ident)
        log(f"phase 9: {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        launched10 = phase10(ct, hk, os.path.join(tmp, "data"), data,
                             args.reps, ident)
        log(f"phase 10: {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        launched11 = phase11(ct, hk, os.path.join(tmp, "data"), data,
                             queries, checks, want, 2, ident)
        log(f"phase 11: {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        launched12 = phase12(ct, hk, os.path.join(tmp, "data"), queries,
                             checks, want, ident)
        log(f"phase 12: {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        launched13, li_now = phase13(ct, hk, os.path.join(tmp, "data"),
                                     data, queries, checks, want, ident,
                                     tmp)
        log(f"phase 13: {time.perf_counter() - t0:.3f} s")
        # phase 13 added lineitem rows: phase 14's numpy answers are
        # phase 1's functions over lineitem as it now stands
        want14 = dict(want, Q1=numpy_q1(li_now),
                      Q3=numpy_q3(cust, orders, li_now),
                      high_card_groupby=numpy_high_card(li_now))
        t0 = time.perf_counter()
        launched14 = phase14(ct, hk, os.path.join(tmp, "data"), data,
                             li_now, queries, checks, want14, ident)
        log(f"phase 14: {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        launched15, replayed15 = phase15(ct, hk, os.path.join(tmp, "data"),
                                         data, queries, checks, want14,
                                         ident)
        log(f"phase 15: {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        launched16 = phase16(ct, hk, os.path.join(tmp, "data"), data,
                             li_now, queries, checks, want14, ident)
        log(f"phase 16: {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        launched17 = phase17(ct, hk, tmp, ident)
        log(f"phase 17: {time.perf_counter() - t0:.3f} s")
        for rep in reports:
            rep["launches_tpch22"] = launched[rep["name"]]
            rep["launches_phase9"] = launched9[rep["name"]]
            rep["launches_phase10"] = launched10[rep["name"]]
            rep["launches_phase11"] = launched11[rep["name"]]
            rep["launches_phase12"] = launched12[rep["name"]]
            rep["launches_phase13"] = launched13[rep["name"]]
            rep["launches_phase14"] = launched14[rep["name"]]
            rep["launches_phase15"] = launched15[rep["name"]]
            rep["launches_replayed"] = replayed15[rep["name"]]
            rep["launches_phase16"] = launched16[rep["name"]]
            rep["launches_phase17"] = launched17[rep["name"]]

        log(f"chip_smoke total: {time.perf_counter() - t_start:.3f} s")
        print(json.dumps({"kernels": reports}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
