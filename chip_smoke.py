#!/usr/bin/env python3
"""Drive the PyTorch port (citus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--sf 1.0] [--reps 3]

Phases, each fatal on failure (no result line is printed then):

1. print the card's name and power limit (nvidia-smi);
2. build the three Hopper kernels from citus_tpu_torch/csrc (nvcc,
   one process per source, started together);
3. generate TPC-H at --sf (6.0M lineitem rows at SF1) and load customer,
   orders and lineitem through the port's own DDL, distribution and
   ingest into a temporary data_dir (shard_count 8);
4. the main path: with every kernel launch count at 0, run TPC-H Q1, Q3
   and the high-cardinality GROUP BY through Session.execute on the GPU,
   check each answer against a plain numpy evaluation of the same query
   over the generated arrays, and require each kernel to have launched;
5. hold each kernel against its plain PyTorch version on the inputs the
   main path gave it, and time kernel, plain version and one library
   call against the card's bound;
6. time warm runs of the three queries (rows/s), and profile one more
   warm run of each (device busy time, idle share, heaviest kernels);
7. print the kernels line, then the device line last.

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

# which Pallas kernel each CUDA kernel replaces (def lines)
REPLACES = {
    "dense_grid_sum": "citus_tpu/ops/pallas_kernels.py:85",
    "bucketed_probe": "citus_tpu/ops/pallas_kernels.py:133",
    "bucketed_groupby_sums": "citus_tpu/ops/pallas_kernels.py:203",
}
# the query of the main path that must carry each kernel
CARRIER = {"dense_grid_sum": "Q1", "bucketed_probe": "Q3",
           "bucketed_groupby_sums": "high_card_groupby"}

HIGH_CARD_SQL = ("select l_orderkey, count(*), sum(l_quantity) "
                 "from lineitem group by l_orderkey")


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

class Recorder:
    """Wraps a kernel wrapper to keep the inputs of its largest call on
    the main path (what phase 5 replays)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = None
        self.size = -1

    def __call__(self, *args):
        size = sum(a.numel() for a in args if hasattr(a, "numel"))
        if size > self.size:
            self.size = size
            self.args = tuple(a.clone() if hasattr(a, "clone") else a
                              for a in args)
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


def kernel_report(hk, name, args, launches):
    import torch

    if args is None:
        raise AssertionError(f"{name}: the main path never called it")
    if name == "dense_grid_sum":
        slot, values, total = args
        n, a = values.shape
        kern = lambda: hk.dense_grid_sum(slot, values, total)  # noqa: E731
        plain = lambda: hk.dense_grid_sum_plain(slot, values,  # noqa: E731
                                                total)
        idx = torch.where((slot >= 0) & (slot < total), slot.long(),
                          torch.full_like(slot, total, dtype=torch.long))
        lib_out = torch.zeros(total + 1, a, device=values.device)
        library = lambda: lib_out.index_add_(0, idx, values)  # noqa: E731
        exact64 = lambda: torch.zeros(  # noqa: E731
            total + 1, a, dtype=torch.float64, device=values.device
        ).index_add_(0, idx, values.double())[:total]
        nbytes = n * 4 + n * a * 4 + total * a * 4
        ops = n * a
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
        # plain version's blocked product (or scatter) accumulates long
        # f32 runs and drifts by up to ~1e-3 of a column's magnitude at
        # 6M rows, so the kernel is held to the plain version at 1e-2 of
        # each column's largest value and, tightly, to a float64 sum of
        # the same inputs at 1e-4 of it
        ref = exact64()
        red = tuple(range(ref.dim() - 1))
        scale = ref.abs().amax(dim=red, keepdim=True) + 1.0
        k64 = float(((got.double() - ref).abs() / scale).max())
        p64 = float(((want.double() - ref).abs() / scale).max())
        ok = bool(torch.all(err <= 1e-2 * scale)) and k64 <= 1e-4
        tol = (f"|kernel - plain| <= 1e-2·(1 + max|column|) and "
               f"|kernel - float64| <= 1e-4·(1 + max|column|); "
               f"vs float64: kernel {k64!r}, plain {p64!r}")
    log(f"check {name}: shapes {[tuple(x.shape) for x in args if hasattr(x, 'shape')]}"
        f" max_abs_err {max_err!r} ({tol}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    ms = time_ms(kern)
    plain_ms = time_ms(plain)
    library_ms = time_ms(library)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    rep = {"name": name, "route": "cuda",
           "source": f"citus_tpu_torch/csrc/{name}.cu",
           "replaces": REPLACES[name], "launches": launches,
           "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms}
    log(f"time {name}: kernel {ms!r} ms, plain {plain_ms!r} ms, library "
        f"{library_ms!r} ms, bound {rep['bound_ms']!r} ms "
        f"({rep['bound_by']})")
    return rep


def profile_query(sess, sql, top: int = 8) -> dict:
    """One more warm run under torch.profiler: device busy time (the sum
    of the device-side entries — kernels and copies — on one stream, so
    nothing overlaps), the idle share of the wall, and the heaviest
    device entries by name.  CPU-side operator entries are left out:
    their device time repeats their kernels'."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.execute(sql)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    heavy = sorted(events, key=dev_us, reverse=True)[:top]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "top": [(e.key[:80], dev_us(e) / 1e3, e.count) for e in heavy]}
    log(f"  profile: wall {wall_ms!r} ms, device busy {busy_ms!r} ms, "
        f"idle share {out['device_idle_share']!r}")
    for name, ms, count in out["top"]:
        log(f"    {ms:10.4f} ms  x{count:<4d} {name}")
    return out


# --------------------------------------------------------------------------

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
        counts = tpch.load_tables(sess, data,
                                  tables={"customer", "orders", "lineitem"})
        log(f"load {counts}: {time.perf_counter() - t0:.3f} s")
        li, orders, cust = data["lineitem"], data["orders"], data["customer"]
        want = {"Q1": numpy_q1(li), "Q3": numpy_q3(cust, orders, li),
                "high_card_groupby": numpy_high_card(li)}
        checks = {"Q1": check_q1, "Q3": check_q3,
                  "high_card_groupby": check_high_card}
        queries = {"Q1": tpch.QUERIES["Q1"], "Q3": tpch.QUERIES["Q3"],
                   "high_card_groupby": HIGH_CARD_SQL}
        rows = {"Q1": counts["lineitem"],
                "Q3": counts["customer"] + counts["orders"]
                + counts["lineitem"],
                "high_card_groupby": counts["lineitem"]}

        # the main path, with the kernels' inputs recorded on the way
        recorders = {n: Recorder(hk, n) for n in hk.KERNELS}
        for r in recorders.values():
            r.install()
        launches = {n: 0 for n in hk.KERNELS}
        try:
            hk.reset_launch_counts()
            for q, sql in queries.items():
                before = dict(hk.LAUNCHES)
                t0 = time.perf_counter()
                res = sess.execute(sql)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                checks[q](res, want[q])
                delta = {n: hk.LAUNCHES[n] - before[n] for n in hk.KERNELS}
                log(f"{q}: {res.row_count} rows, matches numpy, first run "
                    f"{dt:.3f} s, kernel launches {delta}")
            launches = dict(hk.LAUNCHES)
        finally:
            for r in recorders.values():
                r.remove()
        for name, q in CARRIER.items():
            if launches[name] <= 0:
                raise AssertionError(f"{name} never launched on the main "
                                     f"path (expected on {q})")

        reports = [kernel_report(hk, n, recorders[n].args, launches[n])
                   for n in hk.KERNELS]

        for q, sql in queries.items():
            best = None
            for _ in range(args.reps):
                t0 = time.perf_counter()
                sess.execute(sql)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
            log(f"{q}: best of {args.reps} warm runs {best!r} s, "
                f"{rows[q] / best!r} rows/s ({ident})")
            profile_query(sess, sql)

        print(json.dumps({"kernels": reports}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
