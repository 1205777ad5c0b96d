"""One run of one cell: set-up, warm-up, the measured window, the traced
slice, and the comparison that decides `correct`.

The program under test is `citus_tpu_torch`: its sessions from
`connect`, its TPC-H loader `ingest.tpch.load_tables`, its spans,
counters and kernel launch counts.  The data, the window, the readers
and the reference are the benchmark's own.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from . import devprof, spans, window
from .datagen import tpch_gen
from .peaks import peaks_for

# tracing settings of the traced run: every statement records a tree,
# the ring keeps the whole window, nothing is written to the data_dir
TRACE_ON = {"trace_enabled": True, "trace_sample_every": 1,
            "trace_fast_statement_ms": 0.0, "trace_ring_statements": 100_000,
            "trace_slow_statement_ms": 0}
TRACE_OFF = {"trace_enabled": False, "trace_slow_statement_ms": 0}
# the traced slice: this share of the window, at most this long, at its end
PROFILE_SHARE, PROFILE_MAX_S = 1 / 3, 3.0
WARMUP_MAX_ROUNDS = 8


def log(*a) -> None:
    print("portbench:", *a, flush=True)


@dataclass
class Readings:
    """What the metric readers read (end_to_end/<m>.py and
    layer_metrics/<m>.py, each `read(r) -> float | None`)."""
    log: window.WindowLog
    setup_s: float
    counters: dict = field(default_factory=dict)  # deltas over the window
    traced: list = field(default_factory=list)  # Stmt with span trees
    slice: devprof.Slice | None = None
    bytes_per_stmt: dict = field(default_factory=dict)  # by query
    peaks: dict | None = None


def process_age_s() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def written_bytes() -> int | None:
    """Bytes this process has passed to write calls (Linux `wchar`)."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


def width(a: np.ndarray, compute_itemsize: int) -> int:
    """Bytes per value on the device: doubles at the compute dtype,
    strings as 4-byte dictionary codes."""
    if a.dtype == np.float64:
        return compute_itemsize
    if a.dtype == object:
        return 4
    return a.dtype.itemsize


def logical_bytes(ref, data: dict, truth, compute_itemsize: int) -> int:
    """Each input column the query reads, once, at its device width, for
    every row, plus the result it writes."""
    n = 0
    for table, cols in ref.READS.items():
        for c in cols:
            a = data[table][c]
            n += len(a) * width(a, compute_itemsize)
    row = sum(compute_itemsize if t == "float64" else np.dtype(t).itemsize
              for t in ref.RESULT_TYPES)
    return n + ref.rows(truth) * row


def result_columns(res) -> list:
    return [np.asarray(res.columns[n]) for n in res.column_names]


def check_layout(sess, config: dict, tables) -> None:
    """Hold the loaded catalog to the configuration's layout."""
    cat = sess.catalog
    want_shards = config["settings"]["shard_count"]
    dist = config["layout"]["distributed"]
    for t in tables:
        meta = cat.table(t)
        if t in config["layout"]["reference"]:
            if meta.distribution_column is not None:
                raise RuntimeError(f"{t} is not a reference table")
            continue
        col, colocate = dist[t]
        if meta.distribution_column != col:
            raise RuntimeError(f"{t} is distributed by "
                               f"{meta.distribution_column}, not {col}")
        if len(cat.table_shards(t)) != want_shards:
            raise RuntimeError(f"{t} has {len(cat.table_shards(t))} shards, "
                               f"not {want_shards}")
        if colocate in tables and \
                meta.colocation_id != cat.table(colocate).colocation_id:
            raise RuntimeError(f"{t} is not co-located with {colocate}")
    if sess.n_devices != config["n_devices"]:
        raise RuntimeError(f"session has {sess.n_devices} positions, not "
                           f"{config['n_devices']}")


def load(sess, data: dict, config: dict, tables) -> dict:
    """Load through the port's `load_tables`; returns seconds per table
    (the DDL and distribution under "ddl")."""
    from citus_tpu_torch.ingest import copy_from, tpch

    times: dict[str, float] = {}
    real = copy_from._ingest_batch

    def timed(session, table, *a, **k):
        t = time.perf_counter()
        try:
            return real(session, table, *a, **k)
        finally:
            times[table] = time.perf_counter() - t

    t0 = time.perf_counter()
    copy_from._ingest_batch = timed
    try:
        tpch.load_tables(sess, data,
                         shard_count=config["settings"]["shard_count"],
                         tables=set(tables))
    finally:
        copy_from._ingest_batch = real
    times["ddl"] = time.perf_counter() - t0 - sum(times.values())
    check_layout(sess, config, tables)
    return times


def warm(sessions, queries) -> int:
    """Run every query of the mix on every session, all sessions at once,
    until a round neither builds a plan nor captures a graph.  Returns
    the rounds run."""
    for r in range(1, WARMUP_MAX_ROUNDS + 1):
        moved = [False] * len(sessions)
        errors: list = []

        def one(i):
            s = sessions[i]
            try:
                for _name, sql, _w in queries:
                    misses = s.executor.plan_cache.misses
                    s.execute(sql)
                    kind = s.executor.last_dispatch()[0]
                    if s.executor.plan_cache.misses != misses or \
                            kind == "captured":
                        moved[i] = True
            except Exception as e:  # re-raised below, on the main thread
                errors.append(e)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(sessions))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        if r >= 2 and not any(moved):
            return r
    return WARMUP_MAX_ROUNDS


def attach_traces(sessions, log_: window.WindowLog) -> None:
    """Give each statement of the window its span tree."""
    for i, s in enumerate(sessions):
        trees = sorted((t.root for t in s.stats.tracing.traces()
                        if t.root.t0 >= log_.t0), key=lambda r: r.t0)
        j = 0
        for st in (x for x in log_.statements if x.session == i):
            while j < len(trees) and trees[j].t0 < st.t_send:
                j += 1
            if j < len(trees) and trees[j].t0 <= st.t_done:
                st.trace = spans.plain(trees[j])
                j += 1


def idle_gaps(sl: devprof.Slice, stmts, k: int = 10) -> list[list]:
    """The slice's idle time by what the host was doing: the innermost
    span open on any session at each gap's middle."""
    by: dict[str, float] = {}
    for a, b in sl.gaps():
        m = (a + b) / 2
        names = sorted({n for st in stmts if st.trace is not None
                        for n in [spans.innermost_at(st.trace, m)]
                        if n is not None})
        label = "+".join(names) if names else "between statements"
        by[label] = by.get(label, 0.0) + (b - a)
    return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]


def span_table(stmts) -> dict:
    """Mean ms per statement of every span name, and the statements'
    mean wall: where a statement's time goes."""
    by: dict[str, float] = {}
    for st in stmts:
        for sp in spans.walk(st.trace):
            by[sp["name"]] = by.get(sp["name"], 0.0) + sp["t1"] - sp["t0"]
    n = max(1, len(stmts))
    return {"statements": len(stmts),
            "ms": {k: 1e3 * v / n for k, v in
                   sorted(by.items(), key=lambda x: -x[1])}}


def counter_totals(sessions) -> dict:
    out: dict[str, int] = {}
    for s in sessions:
        for k, v in s.stats.counters.snapshot().items():
            out[k] = out.get(k, 0) + v
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str | None = None, sf: float | None = None,
             t_top: float | None = None, age_at_top: float = 0.0,
             hooks: dict | None = None) -> tuple[dict, list]:
    """Run `cell` once.  Returns (result, checks): the result line's
    dict without its checks, and [(name, value, limit)] of every number
    compared.  `device` "cpu" runs the port's plain formulations (the
    harness's CPU tests); `sf` overrides the configuration's scale;
    `hooks["after_load"](session)` runs once the data is loaded (the
    tests' planted faults)."""
    t_top = time.perf_counter() if t_top is None else t_top
    hooks = hooks or {}
    import torch

    import citus_tpu_torch as ct
    from citus_tpu_torch.ops import hopper_kernels as hk

    cfg, mix = cell.config, cell.mix
    on_cuda = device != "cpu"
    split: dict[str, object] = {}
    wrote0 = written_bytes()

    t = time.perf_counter()
    # the port's host library (g++, built inside the checkout at first
    # use) and its CUDA kernels (nvcc, csrc/build/ inside the checkout)
    from citus_tpu_torch import native

    split["native_lib"] = native.get_lib() is not None
    if on_cuda:
        hk.build_all()
        torch.cuda.init()
        if trace:
            devprof.prime()
    split["build_s"] = time.perf_counter() - t

    t = time.perf_counter()
    scale = cfg["scale_factor"] if sf is None else sf
    data = tpch_gen.generate(scale, seed, cell.tables)
    split["generate_s"] = time.perf_counter() - t

    settings = dict(cfg["settings"], **(TRACE_ON if trace else TRACE_OFF))
    conn = {"n_devices": cfg["n_devices"]}
    if not on_cuda:
        conn["device"] = "cpu"
    tmp = tempfile.mkdtemp(prefix="portbench-")
    data_dir = os.path.join(tmp, "data")
    sessions = []
    try:
        loader = ct.connect(data_dir, **conn, **settings)
        try:
            split["load_s"] = load(loader, data, cfg, cell.tables)
            if "after_load" in hooks:
                hooks["after_load"](loader)
        finally:
            loader.close()
        split["rows"] = {t_: len(next(iter(data[t_].values())))
                         for t_ in cell.tables}

        t = time.perf_counter()
        sessions = [ct.connect(data_dir, **conn, **settings)
                    for _ in range(int(mix["sessions"]))]
        split["connect_s"] = time.perf_counter() - t
        queries = [(q.name, q.sql, q.weight) for q in cell.queries]
        t = time.perf_counter()
        split["warmup_rounds"] = warm(sessions, queries)
        split["warmup_s"] = time.perf_counter() - t
        kind = torch.cuda.get_device_name(0) if on_cuda else "cpu"

        c0 = counter_totals(sessions)
        box: dict = {}

        def during(t0):
            if not (trace and on_cuda):
                return
            p = min(PROFILE_MAX_S, seconds * PROFILE_SHARE)
            time.sleep(max(0.0, t0 + seconds - p - time.perf_counter()))
            box["slice"] = devprof.profile_slice(p, list(hk.KERNELS),
                                                 lambda: hk.LAUNCHES)

        setup_s = age_at_top + (time.perf_counter() - t_top)
        split["setup_s"] = setup_s
        log("setup", split)
        wlog = window.run([s.execute for s in sessions], queries, seconds,
                          seed, int(mix.get("result_sample", 1)), during)
        peak = torch.cuda.max_memory_allocated() if on_cuda else 0
        counters = {k: v - c0.get(k, 0)
                    for k, v in counter_totals(sessions).items()}
        if trace:
            attach_traces(sessions, wlog)
        for s in sessions:
            s.close()
        sessions = []
        gc.collect()
        if on_cuda:
            torch.cuda.empty_cache()
        du = sum(os.path.getsize(os.path.join(dp, f))
                 for dp, _d, fs in os.walk(data_dir) for f in fs)
    finally:
        for s in sessions:
            s.close()
        shutil.rmtree(tmp, ignore_errors=True)

    # -- correctness, once the window has closed and the program's state
    # is freed: every sampled answer against the plain reference
    truths = {q.name: q.reference.truth(data) for q in cell.queries}
    worst: dict[str, float] = {}
    compared = 0
    for qname, res in wlog.samples:
        ref = next(q.reference for q in cell.queries if q.name == qname)
        for k, v in ref.compare(result_columns(res), truths[qname]).items():
            worst[k] = max(worst.get(k, -math.inf), v)
        compared += 1
    checks = [(k, worst[k], lim) for q in cell.queries
              for k, lim in q.reference.LIMITS.items() if k in worst]
    # every statement answered, some answers compared, each number
    # within its limit
    correct = wlog.failed == 0 and compared > 0 and \
        all(v <= lim for _k, v, lim in checks)

    itemsize = np.dtype(cfg["settings"]["compute_dtype"]).itemsize
    r = Readings(log=wlog, setup_s=setup_s, counters=counters,
                 slice=box.get("slice"), peaks=peaks_for(kind),
                 bytes_per_stmt={q.name: logical_bytes(
                     q.reference, data, truths[q.name], itemsize)
                     for q in cell.queries})
    if trace:
        cut = r.slice.t_enter if r.slice is not None else math.inf
        r.traced = [s for s in wlog.statements
                    if s.trace is not None and s.t_done <= cut]
        log("spans", span_table(r.traced))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.reader.read(r)
        if v is not None and math.isfinite(v):
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    wrote1 = written_bytes()
    log("run", {"statements": len(wlog.statements),
                "errors": [s.error for s in wlog.statements if not s.ok][:3],
                "stuck_sessions": wlog.stuck,
                "compared": compared, "window_s": wlog.t_last - wlog.t0,
                "data_dir_bytes": du,
                "process_wrote_bytes": None if wrote0 is None else
                wrote1 - wrote0,
                "memory_peak_bytes": peak,
                "logical_bytes_per_stmt": r.bytes_per_stmt})
    result = {"correct": bool(correct), "attempted": wlog.attempted,
              "failed": wlog.failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_cuda else "cpu",
                         "kind": kind,
                         "count": cell.chips if on_cuda else 0,
                         "memory_peak_bytes": int(peak)}}
    if trace and r.slice is not None:
        sl = r.slice
        log("profile", {"slice_s": sl.window_s, "busy_s": sl.busy_s,
                        "device_events": sl.device_events,
                        "kernels_seen": sl.seen,
                        "kernels_launched": sl.launched,
                        "coverage": sl.coverage})
        result["device"]["busy_s"] = sl.busy_s
        result["device"]["window_s"] = sl.window_s
        result["breakdown"] = {
            "device_ops": sl.top_ops(10),
            "idle_gaps": idle_gaps(sl, [s for s in wlog.statements
                                        if s.t_done >= sl.t_start
                                        and s.t_send <= sl.t_end])}
    return result, checks
