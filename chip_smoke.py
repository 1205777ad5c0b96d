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
   decode), then the best of --reps warm runs; per statement the walls,
   retries, rows, each kernel's launches and the rows and host seconds
   of each intermediate result it stored.  Every answer is held against
   the port's own CPU session on the same data_dir (float32 on both
   sides), and Q4, Q13, Q18 and Q21 against numpy too.  Fails when an
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
    port's `txn.apply` fault point, recovered by the next session, and
    the change feed in LSN order.  Every affected count, mode and
    read-back (count(*), count(o_totalprice) and sum(o_totalprice) by
    o_orderpriority: K1, and K4 once NULLs exist) is held against numpy
    replaying the same writes on its own copy.  Fails on any mismatch
    or when K1, K3, K4 or K5 never launches in the phase;
11. print the kernels line (with each kernel's launches in phases 8,
    9 and 10), then the device line last.

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


def load_nullable(sess, li, tpch) -> int:
    """lineitem_nullable: lineitem's DDL (its measures are nullable),
    shard_count 8 on l_orderkey, loaded from the generated arrays with
    l_discount and l_tax passed as lists holding None where NULL."""
    import numpy as np
    from citus_tpu_torch.ingest.copy_from import _ingest_batch

    sess.execute(tpch.SCHEMAS["lineitem"].replace(
        "create table lineitem", "create table lineitem_nullable"))
    sess.create_distributed_table("lineitem_nullable", "l_orderkey",
                                  shard_count=8)
    null_disc, null_tax = nullable_masks(len(li["l_orderkey"]))

    def with_nulls(a, mask):
        cells = a.tolist()
        for i in np.flatnonzero(mask):
            cells[i] = None
        return cells

    names = list(li)
    batch = [with_nulls(li[c], null_disc) if c == "l_discount"
             else with_nulls(li[c], null_tax) if c == "l_tax"
             else list(li[c]) if li[c].dtype == object else li[c]
             for c in names]
    return _ingest_batch(sess, "lineitem_nullable", names, batch,
                         pre_typed=True)[0]


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


def kernel_report(hk, name, args, launches):
    import torch

    if args is None:
        raise AssertionError(f"{name}: the main path never called it")
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
    log(f"check {name}: {shape}; max_abs_err {max_err!r} ({tol}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
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
        sess = ct.connect(data_dir, scan_pipeline=mode)
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
            sess = ct.connect(data_dir)
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
            for _ in range(reps):
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
                f"best of {reps} warm {best!r} s, retries {res.retries} "
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
    cpu = ct.connect(data_dir, device="cpu", compute_dtype="float32")
    differ = []
    for q in names:
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
    cpu = ct.connect(data_dir, device="cpu", compute_dtype="float32",
                     fast_path_max_rows=P1_FAST_PATH_MAX_ROWS)
    first_launches: dict = {}
    failures: list = []
    hk.reset_launch_counts()

    def sync():
        torch.cuda.synchronize()

    def run(name, sql, setup=(), warm=True, **settings):
        """`sql` in a fresh cuda session (after `setup`): the first run,
        then the best of `reps` warm runs."""
        sess = ct.connect(data_dir, **settings)
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
        sess = ct.connect(data_dir, fast_path_max_rows=P1_FAST_PATH_MAX_ROWS,
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
    sess = ct.connect(data_dir)
    walls = []
    for i in pick[:5]:
        key = int(orders["o_orderkey"][i])
        t0 = time.perf_counter()
        res = sess.execute("select o_orderkey, o_custkey, o_totalprice "
                           f"from orders where o_orderkey = {key}")
        walls.append(time.perf_counter() - t0)
        if not res.fast_path or len(res.rows()) != 1:
            failures.append(f"P1 literal {key}")
    log(f"phase9 P1 literal: point index lookups "
        f"{sess.executor.point_index_lookups}, walls {walls!r} ({ident})")
    if sess.executor.point_index_lookups != 5:
        failures.append("P1 literal: point index unused")

    # P2: prepared Q1, three EXECUTEs through one PlanCompiler
    p2 = "prepare p2 as " + q1_body().replace(
        "date '1998-12-01' - interval '90' day", "$1")
    sess = ct.connect(data_dir)
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
    sess = ct.connect(data_dir, fast_path_max_rows=P1_FAST_PATH_MAX_ROWS)
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
    sess = ct.connect(data_dir)
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
        return ct.connect(data_dir, scan_pipeline="device",
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


# --------------------------------------------------------------------------

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
        sess = ct.connect(os.path.join(tmp, "data"))
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
        for rep in reports:
            rep["launches_tpch22"] = launched[rep["name"]]
            rep["launches_phase9"] = launched9[rep["name"]]
            rep["launches_phase10"] = launched10[rep["name"]]

        print(json.dumps({"kernels": reports}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
