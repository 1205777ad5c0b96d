"""Run a QueryPlan eagerly, on one device or a mesh: the port's PlanCompiler.

Counterpart of citus_tpu/executor/compiler.py.  The JAX package traces
the whole plan into one shard_map program; PyTorch runs eagerly, so this
PlanCompiler walks the same plan nodes and executes each stage as torch
operations on the session device.  The static protocol carries over
unchanged, which keeps the runner's retry and feedback logic valid:

* `Capacities` size every data-dependent buffer (scan compaction, join
  output, aggregate output, bucketed probe / group-by packs);
* each stage adds dropped rows to an overflow counter and stale
  statistics to a `dense_oob` counter, and records its actual row count
  (`stage_actual`) for capacity feedback;
* the program ends by compacting its output rows, at their own
  dtypes, into one byte block and their count into the counter vector;
  the fetch copies the counters, then only those rows, into the
  session's host staging (executor/handoff.py) — two waits per
  execution — and `unpack_outputs` views them there.

A plan for N positions (a mesh session, distributed/mesh.py) runs the
same per-position program once per position, in lockstep, from the
statement's own thread: the plan-walking methods are generators, and each
collective — the repartition's all_to_all, the psum/pmin/pmax combines,
the broadcast all_gather — is a `yield` of the position's tensors that
the driver (`_lockstep`) answers once every position has reached it.  At
one position every collective is the identity and no shuffle buffer
exists.  The dense aggregate's per-slot sums run in one dense_grid_sum kernel call
on the card, reading the columns where they lie, where the JAX executor
takes its one-hot branch (f32 sums, and counts while n < 2^24, over at
most DENSE_ONEHOT_MAX_SLOTS slots).

Window functions run as the JAX executor's partition-sorted segmented
scans: one stable multi-key sort per ORDER BY spec, running scans that
reset at partition starts, results scattered back to the input rows.

"""

from __future__ import annotations

import math
import threading
from contextlib import nullcontext as _nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from ..errors import ExecutionError, PlanningError
from ..ops.aggregate import segment_aggregate
from ..ops.hashing import hash_token, shard_index_from_token
from ..ops.join import expand_join_outer, expand_join_pairs
from ..ops.partition import pack_by_target
from ..planner.plan import (
    AggregateNode,
    JoinNode,
    PlanNode,
    ProjectNode,
    QueryPlan,
    ScanNode,
    WindowNode,
)
from . import handoff
from .batch import Block
from .exprs import ColumnSource, evaluate, predicate_mask

_TORCH_FLOAT = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}

# packed-column prefix of a null mask riding a repartition
NULL_PREFIX = "__null__"
INT32_MIN = -(1 << 31)

# the per-position state the lockstep driver swaps in before stepping a
# position's program and saves after
_POS_ATTRS = ("_pos", "device", "_consts", "_overflow", "_dense_oob",
              "_stage_actual")


def _round_cap(n: int) -> int:
    return max(128, int(math.ceil(n / 128.0)) * 128)


def _fetch_meta(span, out, counters) -> None:
    """The `mesh.fetch` span's meta: the bytes copied back (rows, their
    counts and the other counters), the rows handed back and the slots
    they were compacted from."""
    if span is not None:
        span.meta = {**(span.meta or {}),
                     "bytes": out.nbytes + counters.nbytes,
                     "rows": sum(out.rows), "slots": out.slots}


def collect_device_params(plan: QueryPlan) -> list:
    """BParam nodes the device stages evaluate, sorted by index.

    Walks every expression the PlanCompiler evaluates (scan filters,
    projections, join keys/residuals, window specs, aggregates, and the
    device-topk ORDER BY keys).  Host-only expressions (host_select,
    HAVING) evaluate from the bound values.  A cached PlanCompiler is
    generic over these: each run reads the values from the plan it is
    given, never from the plan it was built for.  EXPLAIN counts them
    for its Generic Plan line."""
    from ..planner import expr as ir
    from .feed import walk_plan

    found: dict[int, object] = {}

    def visit(e):
        if e is None:
            return
        for n in ir.walk(e):
            if isinstance(n, ir.BParam):
                found[n.idx] = n

    for node in walk_plan(plan.root):
        if isinstance(node, ScanNode):
            visit(node.filter)
        elif isinstance(node, ProjectNode):
            for e, _cid in node.exprs:
                visit(e)
        elif isinstance(node, JoinNode):
            for e in list(node.left_keys) + list(node.right_keys):
                visit(e)
            visit(node.residual)
            visit(node.left_match_filter)
            visit(node.right_match_filter)
        elif isinstance(node, WindowNode):
            for w, _cid in node.functions:
                visit(w)
            for p in node.partition_by:
                visit(p)
        elif isinstance(node, AggregateNode):
            for g, _cid in node.group_keys:
                visit(g)
            for a, _cid in node.aggs:
                visit(a)
    if plan.device_topk is not None:
        for e, _d, _nf in plan.host_order_by:
            visit(e)
    return [found[i] for i in sorted(found)]


@dataclass
class Capacities:
    """Per-node static buffer sizes (see the JAX package for each)."""

    repartition: dict[int, int]
    join_out: dict[int, int]
    agg_out: dict[int, int] = None
    dense_off: bool = False
    scan_out: dict[int, int] = None
    output_repart: int | None = None
    bucket_probe: dict[int, int] = None
    agg_bucket: dict[int, int] = None

    def __post_init__(self):
        if self.agg_out is None:
            self.agg_out = {}
        if self.scan_out is None:
            self.scan_out = {}
        if self.bucket_probe is None:
            self.bucket_probe = {}
        if self.agg_bucket is None:
            self.agg_bucket = {}

    def grown(self, overflow: int) -> "Capacities":
        """Retry sizing: at least double, and at least enough for the
        observed overflow."""

        def g(v: int) -> int:
            return _round_cap(max(v * 2, v + int(overflow)))

        return Capacities({k: g(v) for k, v in self.repartition.items()},
                          {k: g(v) for k, v in self.join_out.items()},
                          {k: g(v) for k, v in self.agg_out.items()},
                          self.dense_off,
                          {k: g(v) for k, v in self.scan_out.items()},
                          g(self.output_repart)
                          if self.output_repart else None,
                          {k: g(v) for k, v in self.bucket_probe.items()},
                          {k: g(v) for k, v in self.agg_bucket.items()})


class PlanCompiler:
    """One instance per (plan shape, capacities, compute dtype, device):
    `run(plan, feeds, caps, staging=...)` executes the plan and returns
    its output rows, fetched into the staging, and counters.  The plan cache keeps instances across executions."""

    # one-hot eligibility bound of the JAX executor's dense-grid sum; the
    # port routes the same shapes through the dense_grid_sum kernel
    DENSE_ONEHOT_MAX_SLOTS = 4096

    def __init__(self, plan: QueryPlan, compute_dtype=np.float32,
                 device="cpu", mesh=None):
        self.caps = None
        self.compute_dtype = _TORCH_FLOAT[np.dtype(compute_dtype)]
        self.device = torch.device(device)
        self.out_meta = None
        self.stage_keys = None
        # a run keeps its plan, capacities and stage counters on the
        # instance, and the plan cache hands one instance to every thread
        # of a session that runs the shape: runs take turns
        self._run_lock = threading.Lock()
        # list constants uploaded once and kept (a CUDA graph captured
        # later reads them), and a capture's `$n` parameter tensors
        self._consts: dict = {}
        self._params = None
        # the feed keys of the last clean run at these capacities with
        # nothing left to tighten (None: no such run yet): the runner
        # captures the key's CUDA graph when the next run reads the same
        # feed keys (executor/graphs.py); `armed` when the persisted cache
        # already knew the key converged (its first run captures at once)
        self.settled_feeds = None
        self.armed = False
        # the mesh the plan's positions run on (one position: the device)
        self.n_dev = int(plan.n_devices)
        if mesh is None:
            from ..distributed.mesh import make_mesh

            mesh = make_mesh(self.n_dev, default_device=self.device)
        if mesh.size != self.n_dev:
            raise ExecutionError(
                f"a plan for {self.n_dev} positions cannot run on a mesh "
                f"of {mesh.size}")
        self.mesh = mesh
        self._pos = 0
        self._consts_by_dev: dict = {}
        # all_to_all bytes the last run moved across the mesh (every
        # position's whole [N, cap] packs, as the JAX package counts)
        self.shuffle_bytes = 0
        self._shuffle_bytes = 0

    # ------------------------------------------------------------------
    def run(self, plan: QueryPlan, feeds, caps: Capacities, *,
            staging, graph=None) -> tuple | None:
        """Execute against `feeds` (FeedSpec by scan-node id) with `caps`
        keyed by this plan's node ids: a cached instance serves every
        plan of its shape, and each statement plans anew.  Returns
        (Fetched rows, counters [2 + n_stages] int64 numpy, out_meta,
        stage_keys): the rows sit in `staging` (the calling session
        thread's handoff.ResultStaging) until its next fetch, counters are [capacity overflow, dense_oob, *stage
        actuals] and stage_keys entries are (walk_index, kind, width).
        With `graph` (a CapturedPlan of this key over these feeds) the
        dispatch is its replay; None when the graph was released before
        it could replay.  A statement that finds a lock taken waits for
        it under a `mesh.wait` span."""
        from ..stats.tracing import (
            device_timeline,
            resolve_device_legs,
            trace_span,
            waited,
        )

        if graph is not None:
            with waited(self._run_lock, "run"), waited(graph.lock, "graph"):
                if not graph.live:
                    return None
                with trace_span("mesh.dispatch", graph="replay") as sp, \
                        device_timeline(sp, self.device) as leg:
                    graph.replay(plan)
                # the copies' leg starts where the replay's ends
                with trace_span("mesh.fetch") as sp, \
                        device_timeline(sp, self.device, after=leg):
                    out, counters = staging.fetch(
                        graph.packed, graph.counters, graph.out_meta,
                        len(graph.stage_keys))
                _fetch_meta(sp, out, counters)
            resolve_device_legs()
            return out, counters, graph.out_meta, graph.stage_keys
        with waited(self._run_lock, "run"):
            self.plan = plan
            self.caps = caps
            try:
                # the eager program's launches, timed on the card by a
                # CUDA event pair (the span's device_ms), then the
                # copies back to the host, timed by another
                dspan = (trace_span("mesh.dispatch") if self.n_dev == 1
                         else trace_span("mesh.dispatch",
                                         graph="eager: mesh"))
                with dspan as sp, device_timeline(sp, self.device) as leg:
                    packed, counters, meta, stage_keys = self._dispatch(
                        plan, feeds)
                with trace_span("mesh.fetch") as sp, \
                        device_timeline(sp, self.device, after=leg):
                    self._mesh_seam("mesh.fetch")
                    try:
                        out, counters = staging.fetch(
                            packed, counters, meta, len(stage_keys))
                    except Exception as e:
                        from ..distributed.mesh import (
                            _reraise_if_device_loss,
                        )

                        _reraise_if_device_loss(e, "mesh.fetch")
                        raise
                _fetch_meta(sp, out, counters)
            finally:
                self.plan = self.caps = None
            self.out_meta, self.stage_keys = meta, stage_keys
            self.shuffle_bytes = self._shuffle_bytes
        # the fetch returned: every launch before it has completed
        resolve_device_legs()
        return out, counters, meta, stage_keys

    def _forget_run(self) -> None:
        """Drop the last dispatch's stage counters."""
        self._stage_actual = {}
        self._stage_width = {}
        self._overflow = self._dense_oob = None

    def _dispatch(self, plan: QueryPlan, feeds) -> tuple:
        """Enqueue the plan's launches for every position; returns the
        packed outputs ([N, B, cap + 1] uint8, executor/handoff.py) and
        counters still on the device, with out_meta and stage_keys.
        Counters combine across positions as the JAX runner does:
        overflow and dense_oob add, stage actuals take the largest
        position's; each position's output row count follows them."""
        from .cache import plan_order

        self._walk_order = plan_order(plan)
        self._stage_width = {}
        self._shuffle_bytes = 0
        home = self.device
        # the dispatch onto the mesh: a lost position kills it here
        self._mesh_seam("mesh.collective")
        states, bodies = [], []
        for i in range(self.n_dev):
            dev = home if self.n_dev == 1 else self.mesh.devices[i]
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            states.append({"_pos": i, "device": dev,
                           "_consts": self._consts_for(dev),
                           "_overflow": zero, "_dense_oob": zero,
                           "_stage_actual": {}})
            bodies.append(self._body(plan,
                                     self._position_blocks(feeds, i, dev)))
        try:
            outs = self._lockstep(bodies, states)
        finally:
            self.device, self._pos = home, 0
            self._consts = self._consts_for(home)
        meta = outs[0][1]
        if self.n_dev == 1:
            packed = outs[0][0].unsqueeze(0)
        else:
            packed = torch.stack([buf.to(home) for buf, _m, _n in outs])
        overflow = sum(st["_overflow"].to(home) for st in states)
        dense_oob = sum(st["_dense_oob"].to(home) for st in states)
        actual: dict = {}
        for st in states:
            for k, v in st["_stage_actual"].items():
                v = v.to(home)
                actual[k] = v if k not in actual else torch.maximum(
                    actual[k], v)
        self._overflow, self._dense_oob = overflow, dense_oob
        self._stage_actual = actual
        skeys = sorted(actual,
                       key=lambda k: (self._walk_order.get(
                           k[0], 1 << 30), k[1]))
        stage_keys = [(self._walk_order.get(nid, -1), kind,
                       self._stage_width[(nid, kind)])
                      for nid, kind in skeys]
        counters = torch.stack([overflow, dense_oob]
                               + [actual[k] for k in skeys]
                               + [n.to(home) for _b, _m, n in outs])
        return packed, counters, meta, stage_keys

    def _consts_for(self, dev) -> dict:
        """The list-constant cache of `dev` (the compiler's own dict for
        its home device, which a captured graph holds)."""
        if dev == self.device or self.n_dev == 1:
            return self._consts
        return self._consts_by_dev.setdefault(str(dev), {})

    def _position_blocks(self, feeds, i: int, dev) -> dict:
        """Position i's Blocks: its own row of every sharded feed, and
        the replicated feeds whole (copied to its device when it is
        another card)."""
        if self.n_dev == 1:
            return {nid: Block(dict(f.arrays), f.valid, dict(f.nulls))
                    for nid, f in feeds.items()}
        blocks = {}
        for nid, f in feeds.items():
            if f.sharded:
                blocks[nid] = Block({c: a[i] for c, a in f.arrays.items()},
                                    f.valid[i],
                                    {c: m[i] for c, m in f.nulls.items()})
            else:
                def on(t):
                    return t if t.device == dev else t.to(dev)

                blocks[nid] = Block({c: on(a) for c, a in f.arrays.items()},
                                    on(f.valid),
                                    {c: on(m) for c, m in f.nulls.items()})
        return blocks

    def _lockstep(self, bodies: list, states: list) -> list:
        """Step every position's program to its next collective, answer
        the collective for all of them, and repeat until every program
        returns.  Returns each program's return value, by position."""
        n = len(bodies)
        sends: list = [None] * n
        results: list = [None] * n
        while True:
            reqs, done = [], 0
            for i, gen in enumerate(bodies):
                st = states[i]
                for a in _POS_ATTRS:
                    setattr(self, a, st[a])
                try:
                    ctx = (torch.cuda.device(self.device)
                           if self.device.type == "cuda"
                           else _nullcontext())
                    with ctx:
                        reqs.append(gen.send(sends[i]))
                except StopIteration as stop:
                    results[i] = stop.value
                    reqs.append(None)
                    done += 1
                finally:
                    for a in _POS_ATTRS:
                        st[a] = getattr(self, a)
            if done == n:
                return results
            if done:
                raise ExecutionError(
                    "mesh positions diverged: some finished while others "
                    "wait at a collective")
            sends = self._collective(reqs)

    def _mesh_seam(self, seam: str) -> None:
        from ..utils.faultinjection import fault_point, mesh_device_check

        fault_point(seam)
        mesh_device_check(seam, tuple(self.mesh.ids))

    def _collective(self, reqs: list) -> list:
        """Answer one collective: reqs[i] = (kind, ops, tensors) from
        position i; returns each position's list of result tensors."""
        from ..distributed import mesh as dm

        kind, ops, first = reqs[0]
        for r in reqs:
            if r[0] != kind or r[1] != ops or len(r[2]) != len(first):
                raise ExecutionError(
                    "mesh positions diverged at a collective")
        self._mesh_seam("mesh.collective")
        devs = self.mesh.devices
        outs: list = [[] for _ in reqs]
        try:
            for t in range(len(first)):
                parts = [r[2][t] for r in reqs]
                if kind == "all_to_all":
                    res = dm.all_to_all(devs, parts)
                elif kind == "all_reduce":
                    res = dm.all_reduce(devs, parts, ops[t])
                elif kind == "all_gather":
                    res = dm.all_gather(devs, parts)
                else:
                    raise ExecutionError(f"bad collective {kind!r}")
                for i, r in enumerate(res):
                    outs[i].append(r)
        except Exception as e:
            dm._reraise_if_device_loss(e, "mesh.collective")
            raise
        return outs

    def _allreduce(self, tensors: list, ops: list):
        """psum / pmin / pmax of each tensor across the positions (ops[i]
        is 'sum', 'min' or 'max'); the identity at one position."""
        if self.n_dev == 1:
            return list(tensors)
        out = yield ("all_reduce", tuple(ops), list(tensors))
        return out

    def _is_first(self, shape) -> torch.Tensor:
        """[shape] bool: True on position 0 only (the JAX package's
        `axis_index == 0` emit gate)."""
        return torch.full(shape, self._pos == 0, dtype=torch.bool,
                          device=self.device)

    def _body(self, plan: QueryPlan, blocks: dict):
        """One position's program: the plan, the INSERT..SELECT output
        shuffle, the replicated-root gate and the device top-k, then the
        compaction of the output rows for the hand-off.  Returns (the
        position's [B, cap + 1] uint8 block, out_meta, its row count)."""
        out = yield from self._exec(plan.root, blocks)
        if plan.output_repart is not None:
            # INSERT..SELECT device routing: shuffle the final block to
            # the TARGET table's sharding, so the host writes each
            # position's rows without re-hashing
            shard_count, placement, bounds, key_expr = plan.output_repart
            out = yield from self._repartition(
                out, [key_expr], shard_count, placement,
                self.caps.output_repart, keep_null_rows=True,
                bounds=bounds or None)
        if self.n_dev > 1 and plan.root.dist.kind == "replicated":
            # every position holds identical rows: emit from position 0
            out = out.with_filter(self._is_first(out.valid.shape))
        topk = plan.device_topk
        if topk is not None and out.valid.shape[0] > topk:
            out = self._device_topk(out, topk)
        out_cids = sorted(plan.root.out_columns)
        shape = out.valid.shape
        lanes, meta = [], []
        for cid in out_cids:
            col = torch.broadcast_to(out.columns[cid], shape)
            lanes.append(col)
            meta.append(("col", cid, _np_dtype(col.dtype)))
        for cid in out_cids:
            if cid in out.nulls:
                lanes.append(torch.broadcast_to(out.nulls[cid], shape))
                meta.append(("null", cid, np.dtype(np.bool_)))
        buf, n = handoff.compact(lanes, out.valid, meta)
        return buf, meta, n

    # ------------------------------------------------------------------
    def _src(self, blk: Block) -> ColumnSource:
        return ColumnSource(blk.columns, blk.nulls, self.device,
                            self.compute_dtype, self._consts, self._params)

    def _record(self, nid: int, kind: str, count, width: int) -> None:
        """Track one capacity-consuming stage's actual row count (merged
        by max per (node, kind)) and its buffer width."""
        key = (nid, kind)
        c = count.to(torch.int64)
        if key in self._stage_actual:
            self._stage_actual[key] = torch.maximum(self._stage_actual[key],
                                                    c)
        else:
            self._stage_actual[key] = c
        self._stage_width[key] = max(int(width),
                                     self._stage_width.get(key, 0))

    def _exec(self, node: PlanNode, feeds: dict[int, Block]):
        """Run `node` for the current position: a generator that yields
        at each collective and returns the node's Block."""
        if isinstance(node, ScanNode):
            blk = feeds[id(node)]
            if node.filter is not None:
                blk = blk.with_filter(predicate_mask(node.filter,
                                                     self._src(blk)))
                self._record(id(node), "scan_out", blk.valid.sum(),
                             blk.valid.shape[0])
                k = self.caps.scan_out.get(id(node))
                if k is not None and k < blk.valid.shape[0]:
                    blk = self._compact(blk, k)
            return blk
        if isinstance(node, ProjectNode):
            blk = yield from self._exec(node.input, feeds)
            return self._project(blk, node.exprs)
        if isinstance(node, JoinNode):
            return (yield from self._exec_join(node, feeds))
        if isinstance(node, WindowNode):
            return (yield from self._exec_window(node, feeds))
        if isinstance(node, AggregateNode):
            return (yield from self._exec_aggregate(node, feeds))
        raise ExecutionError(f"unknown plan node {type(node).__name__}")

    def _compact(self, blk: Block, k: int) -> Block:
        """Pack surviving rows into k slots; more survivors than k count
        as capacity overflow."""
        n = blk.valid.shape[0]
        rank = torch.cumsum(blk.valid.to(torch.int64), 0) - 1
        n_valid = rank[n - 1] + 1 if n else torch.zeros(
            (), dtype=torch.int64, device=self.device)
        por = torch.zeros(k + 1, dtype=torch.int64, device=self.device)
        tgt = torch.where(blk.valid & (rank < k), rank,
                          torch.full_like(rank, k))
        por[tgt] = torch.arange(n, dtype=torch.int64, device=self.device)
        por = por[:k]
        out_valid = torch.arange(k, device=self.device) < \
            torch.clamp(n_valid, max=k)
        cols = {cid: arr[por] for cid, arr in blk.columns.items()}
        nulls = {cid: nm[por] for cid, nm in blk.nulls.items()}
        self._overflow = self._overflow + torch.clamp(n_valid - k, min=0)
        return Block(cols, out_valid, nulls)

    def _project(self, blk: Block, exprs) -> Block:
        cols, nulls = {}, {}
        src = self._src(blk)
        for e, cid in exprs:
            v, nmask = evaluate(e, src)
            cols[cid] = torch.broadcast_to(v, blk.valid.shape)
            if nmask is not None:
                nulls[cid] = torch.broadcast_to(nmask, blk.valid.shape)
        return Block(cols, blk.valid, nulls)

    # -- ORDER BY + LIMIT pushdown --------------------------------------
    def _device_topk(self, blk: Block, k: int) -> Block:
        """Top-k by the plan's ORDER BY keys; the host's exact sort over
        these k rows is unchanged, so the device pass needs only the same
        total-order direction (DESC negates floats and bit-complements
        ints; NaN ranks largest; NULL placement follows PG defaults)."""
        from ..ops.join import lexsort

        shape = blk.valid.shape
        src = self._src(blk)
        keys = []
        for e, desc, nulls_first in self.plan.host_order_by:
            v, nmask = evaluate(e, src)
            v = torch.broadcast_to(v, shape)
            nm = (torch.zeros(shape, dtype=torch.bool, device=self.device)
                  if nmask is None else torch.broadcast_to(nmask, shape))
            nulls_last = (not nulls_first if nulls_first is not None
                          else not desc)
            ranks = [(nm if nulls_last else ~nm).to(torch.int8)]
            if v.dtype.is_floating_point:
                nanm = torch.isnan(v)
                ranks.append((~nanm if desc else nanm).to(torch.int8))
                v = torch.where(nanm, torch.zeros_like(v), v)
                if desc:
                    v = -v
            elif v.dtype == torch.bool:
                v = v.to(torch.int8)
                if desc:
                    v = ~v
            elif desc:
                v = ~v
            keys.append((ranks, v))
        # lexsort: LAST operand is primary.  Precedence: validity, key0
        # nulls, key0 nan-rank, key0 value, key1 …
        operands = []
        for ranks, v in reversed(keys):
            operands.append(v)
            operands.extend(reversed(ranks))
        order = lexsort(operands + [(~blk.valid).to(torch.int8)])[:k]
        cols = {cid: arr[order] for cid, arr in blk.columns.items()}
        nulls = {cid: nm[order] for cid, nm in blk.nulls.items()}
        return Block(cols, blk.valid[order], nulls)

    # -- joins ----------------------------------------------------------
    def _eval_keys(self, blk: Block, keys, key_int32: tuple = ()):
        valid = blk.valid
        if not keys:
            # keyless (cartesian) join: constant key matches every pair
            return [torch.zeros(blk.valid.shape, dtype=torch.int64,
                                device=self.device)], valid
        arrays = []
        src = self._src(blk)
        for i, e in enumerate(keys):
            v, nmask = evaluate(e, src)
            if v.dtype.is_floating_point or v.dtype == torch.bool:
                if e.dtype.value in ("float32", "float64"):
                    raise PlanningError(
                        "float join keys are not supported; cast to int")
                v = v.to(torch.int64)
            # narrow to int32 where the planner proved both sides' ranges
            # fit; a runtime value outside int32 raises dense_oob so the
            # host retries wide
            narrow = (i < len(key_int32) and key_int32[i]
                      and not self.caps.dense_off)
            if narrow and v.dtype != torch.int32:
                wide = (v < -(1 << 31)) | (v > (1 << 31) - 1)
                if nmask is not None:
                    wide = wide & ~nmask
                self._dense_oob = self._dense_oob + (wide & blk.valid).sum()
            kd = torch.int32 if narrow else torch.int64
            arrays.append(torch.broadcast_to(v.to(kd), blk.valid.shape))
            if nmask is not None:
                valid = valid & ~nmask  # SQL: NULL never joins
        return arrays, valid

    def _dense_for(self, extents: tuple, keys: list) -> tuple | None:
        """(base, extent) for a single-key build side, or None."""
        from ..ops.join import dense_directory_ok

        if self.caps.dense_off or len(keys) != 1:
            return None
        if not extents or extents[0] is None:
            return None
        base, extent = extents[0]
        if not dense_directory_ok(extent, keys[0].shape[0]):
            return None
        return (int(base), int(extent))

    def _join_inputs(self, node: JoinNode, feeds):
        """Both sides, their repartition stages and key evaluation
        (generator).  At one position the repartition strategies and
        the cartesian all_gather are the identity."""
        if node.strategy not in ("local", "broadcast", "cartesian_gather",
                                 "repart_right", "repart_left",
                                 "repart_both"):
            raise ExecutionError(f"bad join strategy {node.strategy}")
        lblk = yield from self._exec(node.left, feeds)
        rblk = yield from self._exec(node.right, feeds)
        if self.n_dev > 1:
            lblk, rblk = yield from self._join_shuffles(node, lblk, rblk)
        key_int32 = getattr(node, "key_int32", ())
        lkeys, lmatch = self._eval_keys(lblk, node.left_keys, key_int32)
        rkeys, rmatch = self._eval_keys(rblk, node.right_keys, key_int32)
        if node.left_match_filter is not None:
            lmatch = lmatch & predicate_mask(node.left_match_filter,
                                             self._src(lblk))
        if node.right_match_filter is not None:
            rmatch = rmatch & predicate_mask(node.right_match_filter,
                                             self._src(rblk))
        return lblk, rblk, lkeys, lmatch, rkeys, rmatch

    def _join_shuffles(self, node: JoinNode, lblk: Block, rblk: Block):
        """The join's collectives on a mesh: the cartesian all_gather of
        the build side, or the repartition of one or both sides toward
        the partner's sharding (generator)."""
        # probe side preserved: left/full null-extend; anti KEEPS null-key
        # probe rows (they match nothing, so NOT EXISTS holds for them)
        keep_l = node.join_type in ("left", "full", "anti")
        keep_r = node.join_type in ("right", "full")  # build preserved
        if node.strategy == "cartesian_gather":
            # sharded × sharded keyless product: replicate the build side
            # on every position, then cross it with the local probe shard
            names = sorted(rblk.columns)
            nnames = sorted(rblk.nulls)
            got = yield ("all_gather", None,
                         [rblk.columns[c] for c in names]
                         + [rblk.nulls[c] for c in nnames] + [rblk.valid])
            rblk = Block(dict(zip(names, got[:len(names)])), got[-1],
                         dict(zip(nnames, got[len(names):-1])))
        elif node.strategy == "repart_right":
            # hash ONLY the key aligned with the partner's distribution
            # column — extra equi-keys don't participate in routing
            rblk = yield from self._repartition(
                rblk, [node.right_keys[node.repart_key_idx]],
                node.left.dist.shard_count, node.left.dist.placement,
                self.caps.repartition[id(node)], keep_null_rows=keep_r,
                bounds=node.left.dist.bounds or None, record_nid=id(node))
        elif node.strategy == "repart_left":
            lblk = yield from self._repartition(
                lblk, [node.left_keys[node.repart_key_idx]],
                node.right.dist.shard_count, node.right.dist.placement,
                self.caps.repartition[id(node)], keep_null_rows=keep_l,
                bounds=node.right.dist.bounds or None, record_nid=id(node))
        elif node.strategy == "repart_both":
            cap = self.caps.repartition[id(node)]
            identity = tuple(range(self.n_dev))
            lblk = yield from self._repartition(
                lblk, node.left_keys, self.n_dev, identity, cap,
                keep_null_rows=keep_l, record_nid=id(node))
            rblk = yield from self._repartition(
                rblk, node.right_keys, self.n_dev, identity, cap,
                keep_null_rows=keep_r, record_nid=id(node))
        return lblk, rblk

    def _repartition(self, blk: Block, keys, shard_count: int,
                     placement: tuple, capacity: int,
                     key_arrays: list | None = None,
                     valid: torch.Tensor | None = None,
                     keep_null_rows: bool = False,
                     bounds: tuple | None = None,
                     record_nid: int | None = None):
        """pack → all_to_all → flatten (generator; the identity at one
        position).  Toward a TABLE's sharding the single key hashes
        exactly like host ingest routing (hash_token); multi-key
        shuffles (repart_both, the aggregate and window combines) only
        need internal consistency and fold a 64-bit combine into token
        space.  Each position's [N, capacity] pack moves whole."""
        if self.n_dev == 1:
            return blk
        dev = self.device
        if key_arrays is None:
            key_arrays, valid = self._eval_keys(blk, keys)
            if keep_null_rows:
                # outer-preserved side: NULL-key rows ride the shuffle
                # (routed by their zeroed storage value); they match
                # nothing but must still emit null-extended
                valid = blk.valid
        if len(key_arrays) == 1:
            token = hash_token(key_arrays[0])
        else:
            h = _combine_hash64(key_arrays)
            token = ((h & 0xFFFFFFFF) + INT32_MIN).to(torch.int32)
        if bounds is not None:
            # range-aware routing: shard bounds are arbitrary after splits
            mins = torch.as_tensor(np.asarray(bounds, dtype=np.int64),
                                   device=dev)
            shard = torch.clamp(torch.searchsorted(
                mins, token.to(torch.int64), right=True) - 1,
                0, shard_count - 1)
        else:
            shard = shard_index_from_token(token, shard_count).to(
                torch.int64)
        placement_t = torch.as_tensor(np.asarray(placement,
                                                 dtype=np.int64),
                                      device=dev)
        target = placement_t[shard]
        if record_nid is not None:
            # the binding constraint on this buffer is the largest
            # (source position → target position) bucket
            sent = torch.zeros(self.n_dev, dtype=torch.int64,
                               device=dev).index_add_(
                0, target, valid.to(torch.int64))
            self._record(record_nid, "repartition", sent.max(), capacity)
        all_cols = dict(blk.columns)
        for cid, nmask in blk.nulls.items():
            all_cols[NULL_PREFIX + cid] = nmask
        packed, pvalid, overflow = pack_by_target(
            all_cols, valid, target, self.n_dev, capacity)
        self._overflow = self._overflow + overflow
        names = sorted(packed)
        parts = [packed[c] for c in names] + [pvalid]
        self._shuffle_bytes += sum(t.numel() * t.element_size()
                                   for t in parts)
        got = yield ("all_to_all", None, parts)
        flat_n = self.n_dev * capacity
        cols, nulls = {}, {}
        for cid, arr in zip(names, got[:-1]):
            flat = arr.reshape(flat_n)
            if cid.startswith(NULL_PREFIX):
                nulls[cid[len(NULL_PREFIX):]] = flat
            else:
                cols[cid] = flat
        return Block(cols, got[-1].reshape(flat_n), nulls)

    def _exec_lookup_join(self, node: JoinNode, lblk, rblk, lkeys, lmatch,
                          rkeys, rmatch) -> Block:
        """Fused PK-side lookup join: one output row per probe row; a
        probe with >1 match means the uniqueness claim was stale (surplus
        → dense_oob → retry on the expansion path)."""
        from ..ops.join import (_bounds, bucketed_unique_lookup,
                                dense_unique_lookup)

        if node.join_type == "inner" and \
                getattr(node, "build_side", "right") == "left":
            bblk, bkeys, bmatch = lblk, lkeys, lmatch
            pblk, pkeys, pmatch = rblk, rkeys, rmatch
            extents = getattr(node, "left_key_extents", ())
        else:
            bblk, bkeys, bmatch = rblk, rkeys, rmatch
            pblk, pkeys, pmatch = lblk, lkeys, lmatch
            extents = getattr(node, "right_key_extents", ())
        dense = self._dense_for(extents, bkeys)
        bucket_cap = (self.caps.bucket_probe.get(id(node))
                      if getattr(node, "probe_bucketed", False) else None)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        if dense is not None and bucket_cap is not None:
            bidx, counts, dense_oob, boverflow, bfill = \
                bucketed_unique_lookup(bkeys[0], bmatch, pkeys[0],
                                       dense[0], dense[1], bucket_cap)
            self._overflow = self._overflow + boverflow
            self._record(id(node), "bucket_probe", bfill, bucket_cap)
            counts = torch.where(pmatch, counts, zero)
        elif dense is not None:
            bidx, counts, dense_oob = dense_unique_lookup(
                bkeys[0], bmatch, pkeys[0], dense[0], dense[1])
            counts = torch.where(pmatch, counts, zero)
        else:
            order, lo, hi, dense_oob = _bounds(bkeys, bmatch, pkeys, dense)
            counts = torch.where(pmatch, hi - lo, torch.zeros_like(lo))
            m0 = bkeys[0].shape[0]
            bidx = order[torch.clamp(lo, 0, m0 - 1)]
        self._dense_oob = self._dense_oob + dense_oob + \
            torch.clamp(counts.to(torch.int64) - 1, min=0).sum()
        found = counts > 0
        probe_outer = node.join_type == "left"
        out_valid = pblk.valid if probe_outer else found
        if not probe_outer and node.residual is None:
            self._record(id(node), "join_out", out_valid.sum(),
                         out_valid.shape[0])
        # selective FK join: compact the probe side before gathering
        # build columns
        k = self.caps.join_out.get(id(node))
        if (not probe_outer and node.residual is None and k is not None
                and k < out_valid.shape[0]):
            marker = "__bidx__"
            tmp = self._compact(Block({**pblk.columns, marker: bidx},
                                      out_valid, pblk.nulls), k)
            bidx = tmp.columns.pop(marker)
            pblk = Block(tmp.columns, tmp.valid, tmp.nulls)
            out_valid = tmp.valid
        cols = dict(pblk.columns)
        nulls = dict(pblk.nulls)
        for cid, arr in bblk.columns.items():
            cols[cid] = arr[bidx]
            nm = bblk.nulls.get(cid)
            gathered = nm[bidx] if nm is not None else None
            if probe_outer:
                missing = ~found
                nulls[cid] = (missing if gathered is None
                              else (gathered | missing))
            elif gathered is not None:
                nulls[cid] = gathered
        return Block(cols, out_valid, nulls)

    def _exec_join(self, node: JoinNode, feeds):
        lblk, rblk, lkeys, lmatch, rkeys, rmatch = \
            yield from self._join_inputs(node, feeds)
        if node.join_type in ("semi", "anti"):
            return (yield from self._exec_semi_join(
                node, lblk, rblk, lkeys, lmatch, rkeys, rmatch))
        if getattr(node, "fuse_lookup", False) and not self.caps.dense_off:
            blk = self._exec_lookup_join(node, lblk, rblk, lkeys, lmatch,
                                         rkeys, rmatch)
            if node.residual is not None:
                blk = blk.with_filter(predicate_mask(node.residual,
                                                     self._src(blk)))
                if node.join_type == "inner":
                    self._record(id(node), "join_out", blk.valid.sum(),
                                 blk.valid.shape[0])
                    k = self.caps.join_out.get(id(node))
                    if k is not None and k < blk.valid.shape[0]:
                        blk = self._compact(blk, k)
            return blk
        out_cap = self.caps.join_out[id(node)]
        if node.join_type != "inner":
            blk = yield from self._exec_outer_expand(
                node, lblk, rblk, lkeys, lmatch, rkeys, rmatch, out_cap)
        else:
            if getattr(node, "build_side", "right") == "left":
                bkeys, bmatch, bblk = lkeys, lmatch, lblk
                pkeys, pmatch, pblk = rkeys, rmatch, rblk
                extents = getattr(node, "left_key_extents", ())
            else:
                bkeys, bmatch, bblk = rkeys, rmatch, rblk
                pkeys, pmatch, pblk = lkeys, lmatch, lblk
                extents = getattr(node, "right_key_extents", ())
            dense = self._dense_for(extents, bkeys)
            bidx, pidx, out_valid, _miss, overflow, dense_oob = \
                expand_join_pairs(bkeys, bmatch, pkeys, pmatch, pmatch,
                                  out_cap, probe_outer=False, dense=dense)
            self._overflow = self._overflow + overflow
            self._dense_oob = self._dense_oob + dense_oob
            self._record(id(node), "join_out", out_valid.sum(), out_cap)
            cols, nulls = {}, {}
            for cid, arr in pblk.columns.items():
                cols[cid] = arr[pidx]
            for cid, nmask in pblk.nulls.items():
                nulls[cid] = nmask[pidx]
            for cid, arr in bblk.columns.items():
                cols[cid] = arr[bidx]
            for cid, nmask in bblk.nulls.items():
                nulls[cid] = nmask[bidx]
            blk = Block(cols, out_valid, nulls)
        if node.residual is not None:
            blk = blk.with_filter(predicate_mask(node.residual,
                                                 self._src(blk)))
        return blk

    def _exec_semi_join(self, node: JoinNode, lblk: Block, rblk: Block,
                        lkeys, lmatch, rkeys, rmatch):
        """Semi/anti join (decorrelated EXISTS / NOT EXISTS): the output
        rows are the probe (left) rows.  Without a residual, one
        directory or binary-search bounds pass gives each probe its match
        count.  With a cross-side residual (Q21's `l2.l_suppkey <>
        l1.l_suppkey`) candidate pairs expand, only the residual's
        columns are gathered at pair capacity, and a scatter-max ORs the
        surviving pairs back onto their probe rows.  With `flag_combine`
        (probe replicated over a sharded build) the per-position flags
        psum across the mesh (generator)."""
        from ..ops.join import _bounds
        from ..planner.expr import expr_columns

        dense = self._dense_for(getattr(node, "right_key_extents", ()),
                                rkeys)
        n = lblk.valid.shape[0]
        if node.residual is None:
            _order, lo, hi, dense_oob = _bounds(rkeys, rmatch, lkeys, dense)
            self._dense_oob = self._dense_oob + dense_oob
            matched = lmatch & (hi > lo)
        else:
            cap = self.caps.join_out[id(node)]
            bidx, pidx, out_valid, _miss, overflow, dense_oob = \
                expand_join_pairs(rkeys, rmatch, lkeys, lmatch, lmatch,
                                  cap, probe_outer=False, dense=dense)
            self._overflow = self._overflow + overflow
            self._dense_oob = self._dense_oob + dense_oob
            self._record(id(node), "join_out", out_valid.sum(), cap)
            cols, nulls = {}, {}
            for cid in expr_columns(node.residual):
                if cid in lblk.columns:
                    blk, idx = lblk, pidx
                elif cid in rblk.columns:
                    blk, idx = rblk, bidx
                else:
                    continue
                cols[cid] = blk.columns[cid][idx]
                nm = blk.nulls.get(cid)
                if nm is not None:
                    nulls[cid] = nm[idx]
            pair = Block(cols, out_valid, nulls)
            ok = out_valid & predicate_mask(node.residual, self._src(pair))
            flags = torch.zeros(n, dtype=torch.int32, device=self.device)
            if n:
                flags.scatter_reduce_(0, pidx, ok.to(torch.int32),
                                      reduce="amax", include_self=True)
            matched = flags > 0
        if getattr(node, "flag_combine", False) and self.n_dev > 1:
            (m,) = yield from self._allreduce([matched.to(torch.int32)],
                                              ["sum"])
            matched = m > 0
        if node.join_type == "anti":
            valid = lblk.valid & ~matched
        else:
            valid = lblk.valid & matched
        return Block(dict(lblk.columns), valid, dict(lblk.nulls))

    def _exec_outer_expand(self, node: JoinNode, lblk: Block, rblk: Block,
                           lkeys, lmatch, rkeys, rmatch, out_cap: int):
        """LEFT/RIGHT/FULL pair emission with null extension.  LEFT:
        unmatched probe (left) rows emit once with the build columns
        NULL.  RIGHT/FULL: unmatched build rows append as a second
        segment of the build side's capacity with the probe columns
        NULL; a replicated (broadcast) build side psums its matched
        flags across the mesh and emits its unmatched rows on position
        0 only (generator)."""
        probe_outer = node.join_type in ("left", "full")
        build_outer = node.join_type in ("right", "full")
        dense = self._dense_for(getattr(node, "right_key_extents", ()),
                                rkeys)
        bidx, pidx, pair_valid, bmissing, unmatched_b, overflow, dense_oob \
            = expand_join_outer(rkeys, rblk.valid, rmatch, lkeys,
                                lblk.valid, lmatch, out_cap, probe_outer,
                                build_outer, dense=dense)
        self._overflow = self._overflow + overflow
        self._dense_oob = self._dense_oob + dense_oob
        self._record(id(node), "join_out", pair_valid.sum(), out_cap)
        if build_outer and node.strategy == "broadcast" and self.n_dev > 1:
            matched = rblk.valid & ~unmatched_b
            (m,) = yield from self._allreduce([matched.to(torch.int32)],
                                              ["sum"])
            unmatched_b = rblk.valid & (m == 0) & \
                self._is_first(rblk.valid.shape)
        cols, nulls = {}, {}
        for cid, arr in lblk.columns.items():
            cols[cid] = arr[pidx]
        for cid, nmask in lblk.nulls.items():
            nulls[cid] = nmask[pidx]
        for cid, arr in rblk.columns.items():
            cols[cid] = arr[bidx]
            gathered = rblk.nulls.get(cid)
            nulls[cid] = (bmissing if gathered is None
                          else (gathered[bidx] | bmissing))
        if not build_outer:
            return Block(cols, pair_valid, nulls)
        # the unmatched build rows' segment: probe columns NULL (zeros
        # stand in for their values, as nothing reads them)
        m = rblk.valid.shape[0]
        out_cols, out_nulls = {}, {}
        for cid in cols:
            pn = nulls.get(cid)
            if pn is None:
                pn = torch.zeros(pair_valid.shape, dtype=torch.bool,
                                 device=self.device)
            if cid in rblk.columns:
                seg = rblk.columns[cid]
                nm = rblk.nulls.get(cid)
                seg_null = (torch.zeros(m, dtype=torch.bool,
                                        device=self.device)
                            if nm is None else nm)
            else:
                seg = cols[cid].new_zeros((m,))
                seg_null = torch.ones(m, dtype=torch.bool,
                                      device=self.device)
            out_cols[cid] = torch.cat([cols[cid], seg])
            out_nulls[cid] = torch.cat([pn, seg_null])
        return Block(out_cols, torch.cat([pair_valid, unmatched_b]),
                     out_nulls)

    # -- window functions -----------------------------------------------
    def _exec_window(self, node: WindowNode, feeds):
        """Partition-sorted segmented scans (the WindowAgg analogue).

        Per distinct ORDER BY spec: one stable lexicographic sort
        (validity, then the partition keys, then each ORDER BY key with
        its NULL rank) and running segmented scans over it.  Results
        scatter back to the pre-sort row positions, so the input block
        passes through with the window columns appended.  combine=
        'repartition' first shuffles rows by partition key so each
        partition lies on one position (the identity at one position;
        generator)."""
        from ..ops.join import lexsort

        blk = yield from self._exec(node.input, feeds)
        if node.combine == "repartition" and self.n_dev > 1:
            # routing keys with explicit NULL flags (zeroed value +
            # flag), as the aggregate combine: a NULL partition's rows
            # must land on ONE position
            karr = []
            bsrc = self._src(blk)
            for p in node.partition_by:
                v, nm = evaluate(p, bsrc)
                v = torch.broadcast_to(v, blk.valid.shape)
                v = _routing_int64(v)
                if nm is not None:
                    nmb = torch.broadcast_to(nm, blk.valid.shape)
                    karr.append(torch.where(nmb, torch.zeros_like(v), v))
                    karr.append(nmb.to(torch.int64))
                else:
                    karr.append(v)
            if not karr:
                # one global partition: constant routing key
                karr = [torch.zeros(blk.valid.shape, dtype=torch.int64,
                                    device=self.device)]
            blk = yield from self._repartition(
                blk, None, self.n_dev, tuple(range(self.n_dev)),
                self.caps.repartition[id(node)], key_arrays=karr,
                valid=blk.valid, record_nid=id(node))
        n = blk.valid.shape[0]
        src = self._src(blk)
        dev = self.device

        # partition keys (NULLs form their own partition, like GROUP BY):
        # the value lane is zeroed under NULL, or the garbage it holds
        # would split the NULL partition
        pkeys = []
        for p in node.partition_by:
            v, nm = evaluate(p, src)
            v = torch.broadcast_to(v, (n,))
            if nm is not None:
                nmb = torch.broadcast_to(nm, (n,))
                v = torch.where(nmb, torch.zeros_like(v), v)
                pkeys.append(v)
                pkeys.append(nmb.to(torch.int32))
            else:
                pkeys.append(v)

        # group functions by their ORDER BY spec: one sort per spec
        by_order: dict[tuple, list] = {}
        for w, cid in node.functions:
            by_order.setdefault(w.order_by, []).append((w, cid))

        out_cols = dict(blk.columns)
        out_nulls = dict(blk.nulls)
        iota = torch.arange(n, dtype=torch.int64, device=dev)
        invalid = (~blk.valid).to(torch.int32)
        for order_spec, fns in by_order.items():
            okeys = []       # sort operands for the order keys
            peer_keys = []   # equality keys defining rank peers
            for e, desc in order_spec:
                v, nm = evaluate(e, src)
                v = torch.broadcast_to(v, (n,))
                nmb = (torch.zeros(n, dtype=torch.bool, device=dev)
                       if nm is None else torch.broadcast_to(nm, (n,)))
                null_rank = (nmb if not desc else ~nmb).to(torch.int8)
                # zero the lane under NULL first: peers compare by
                # (zeroed value, null flag), so all NULL rows tie
                v = torch.where(nmb, torch.zeros_like(v), v)
                peer_keys.append(v)
                peer_keys.append(nmb.to(torch.int8))
                if desc:
                    v = -v if v.dtype.is_floating_point else ~v
                okeys.append((null_rank, v))
            operands = []
            for null_rank, v in reversed(okeys):
                operands.append(v)
                operands.append(null_rank)
            # lexsort, primary last: validity > partition keys > order keys
            order = lexsort(operands + list(reversed(pkeys)) + [invalid])
            valid_s = blk.valid[order]

            pb = _starts(n, dev)
            for k in pkeys:
                pb = pb | _shift_ne(k[order])
            part_boundary = pb | _shift_ne(valid_s)  # invalid tail split off
            peer_boundary = part_boundary
            for k in peer_keys:
                peer_boundary = peer_boundary | _shift_ne(k[order])

            zero = torch.zeros_like(iota)
            part_start = torch.cummax(
                torch.where(part_boundary, iota, zero), 0).values
            peer_start = torch.cummax(
                torch.where(peer_boundary, iota, zero), 0).values
            # position of the last row of each peer group (running
            # aggregates include peers)
            peer_end = _seg_last(peer_boundary, iota)

            for w, cid in fns:
                res_s, null_s = self._window_value(
                    w, src, order, valid_s, part_boundary, peer_boundary,
                    part_start, peer_start, peer_end, iota)
                wcol = torch.zeros(n, dtype=res_s.dtype, device=dev)
                wcol[order] = res_s
                out_cols[cid] = wcol
                if null_s is not None:
                    wnull = torch.zeros(n, dtype=torch.bool, device=dev)
                    wnull[order] = null_s
                    out_nulls[cid] = wnull
        return Block(out_cols, blk.valid, out_nulls)

    def _window_value(self, w, src, order, valid_s, part_boundary,
                      peer_boundary, part_start, peer_start, peer_end,
                      iota):
        """One window function over the sorted view → (values, nulls)."""
        from ..ops.aggregate import _segmented_scan

        n = valid_s.shape[0]
        if w.kind == "row_number":
            return iota - part_start + 1, None
        if w.kind == "rank":
            return peer_start - part_start + 1, None
        if w.kind == "dense_rank":
            c = torch.cumsum(peer_boundary.to(torch.int64), 0)
            at_start = torch.cummax(
                torch.where(part_boundary, c, torch.zeros_like(c)), 0).values
            return c - at_start + 1, None

        # aggregate kinds: running (with ORDER BY, peers included) or
        # whole-partition (without)
        whole = not w.order_by

        def finish(scan):
            if whole:
                return _partition_total(scan, part_boundary, iota)
            return scan[peer_end]

        if w.kind == "count_star":
            contrib = valid_s
            v = None
        else:
            raw, nm = evaluate(w.arg, src)
            v = torch.broadcast_to(raw, (n,))[order]
            contrib = valid_s if nm is None else (
                valid_s & ~torch.broadcast_to(nm, (n,))[order])
        kind = w.kind
        cnt = finish(_segmented_scan(contrib.to(torch.int64),
                                     part_boundary, torch.add))
        if kind in ("count", "count_star"):
            return cnt, None
        if kind in ("sum", "avg"):
            acc = (self.compute_dtype if v.dtype.is_floating_point
                   else torch.int64)
            x = torch.where(contrib, v.to(acc),
                            torch.zeros((), dtype=acc, device=v.device))
            total = finish(_segmented_scan(x, part_boundary, torch.add))
            if kind == "avg":
                res = total.to(self.compute_dtype) / torch.clamp(
                    cnt, min=1).to(self.compute_dtype)
            else:
                res = total
            return res, cnt == 0
        if kind in ("min", "max"):
            ident = _big(v.dtype) if kind == "min" else _small(v.dtype)
            x = torch.where(contrib, v, torch.full_like(v, ident))
            op = torch.minimum if kind == "min" else torch.maximum
            return finish(_segmented_scan(x, part_boundary, op)), cnt == 0
        raise ExecutionError(f"bad window kind {w.kind}")

    # -- aggregation ----------------------------------------------------
    def _agg_values(self, node: AggregateNode, blk: Block):
        """Evaluate aggregate inputs → [(value, kind, contrib_valid)]."""
        values = []
        src = self._src(blk)
        for a, _cid in node.aggs:
            if a.kind == "count_star":
                values.append((torch.ones(blk.valid.shape, dtype=torch.int64,
                                          device=self.device),
                               "count", None))
                continue
            v, nmask = evaluate(a.arg, src)
            v = torch.broadcast_to(v, blk.valid.shape)
            if a.kind in ("sum", "avg"):
                v = v.to(self.compute_dtype if v.dtype.is_floating_point
                         else torch.int64)
            kind = "count" if a.kind == "count" else a.kind
            vv = None if nmask is None else ~torch.broadcast_to(
                nmask, blk.valid.shape)
            values.append((v, kind, vv))
        return values

    def _agg_inputs(self, node: AggregateNode, blk: Block):
        key_arrays, key_meta = [], []
        src = self._src(blk)
        for g, cid in node.group_keys:
            v, nmask = evaluate(g, src)
            key_arrays.append(torch.broadcast_to(v, blk.valid.shape))
            if nmask is not None:
                # NULLs form their own group: the null flag joins the key
                key_arrays.append(torch.broadcast_to(
                    nmask, blk.valid.shape).to(torch.int32))
                key_meta.append((cid, True))
            else:
                key_meta.append((cid, False))
        return key_arrays, key_meta, self._agg_values(node, blk)

    def _pack_group_keys(self, node: AggregateNode, key_arrays, key_meta,
                         valid, kr=None):
        """Composite group keys → ONE int64 key from the planner's known
        ranges (slot 0 of each key's width = NULL); out-of-range rows are
        counted so the dense_oob retry recompiles with packing off.
        Returns (packed [n] | None, oob)."""
        if kr is None:
            kr = getattr(node, "key_ranges", None)
        if kr is None or self.caps.dense_off or len(kr) != len(key_meta):
            return None, None
        expected = len(key_meta) + sum(1 for _c, f in key_meta if f)
        if expected != len(key_arrays):
            return None, None
        n = valid.shape[0]
        packed = torch.zeros(n, dtype=torch.int64, device=self.device)
        oob = torch.zeros((), dtype=torch.int64, device=self.device)
        ai = 0
        for (base, extent, _hn), (_cid, has_flag) in zip(kr, key_meta):
            v = key_arrays[ai].to(torch.int64)
            ai += 1
            nm = None
            if has_flag:
                nm = key_arrays[ai] != 0
                ai += 1
            raw = v - int(base)
            inb = (raw >= 0) & (raw < extent)
            width = extent + 1
            if nm is not None:
                slot = torch.where(nm, torch.zeros_like(raw), raw + 1)
                oob = oob + (valid & ~nm & ~inb).sum()
            else:
                slot = raw + 1
                oob = oob + (valid & ~inb).sum()
            packed = packed * width + torch.clamp(slot, 0, width - 1)
        packed = torch.where(valid, packed,
                             torch.full_like(packed, torch.iinfo(
                                 torch.int64).max))
        return packed, oob

    def _segment_aggregate_maybe_packed(self, node, key_arrays, key_meta,
                                        values, valid):
        packed, pack_oob = self._pack_group_keys(node, key_arrays,
                                                 key_meta, valid)
        if packed is not None:
            self._dense_oob = self._dense_oob + pack_oob
            return segment_aggregate([packed], values, valid,
                                     out_keys=key_arrays)
        return segment_aggregate(key_arrays, values, valid)

    @staticmethod
    def agg_bucket_shape(node: AggregateNode, dense_off: bool) -> bool:
        """Single decision point for the bucketed group-by (capacity
        planning and dispatch must agree): structurally eligible and
        picked by the planner's device gate."""
        if dense_off or node.combine not in ("local", "repartition"):
            return False
        if not getattr(node, "bucket_keys", None) or \
                getattr(node, "bucket_total", 0) <= 0:
            return False
        if node.dense_keys is not None:
            return False
        return bool(getattr(node, "group_bucketed", False))

    @staticmethod
    def agg_pushdown_shape(node: AggregateNode) -> bool:
        """Global aggregate over an inner join answerable from per-probe
        match counts (no pair emission)."""
        from ..planner import expr as ir

        if node.combine != "global" or node.group_keys:
            return False
        j = node.input
        if not isinstance(j, JoinNode) or j.join_type != "inner" or \
                j.residual is not None:
            return False
        if j.dist.kind == "replicated":
            return False
        lcids = set(j.left.out_columns)
        rcids = set(j.right.out_columns)
        agg_side = None
        for a, _cid in node.aggs:
            if a.kind == "count_star":
                continue
            if a.kind not in ("count", "sum", "min", "max"):
                return False
            cids = {c.cid for c in ir.walk(a.arg) if isinstance(c, ir.BCol)}
            side = ("left" if cids <= lcids
                    else "right" if cids <= rcids else None)
            if side is None or (agg_side is not None and side != agg_side):
                return False
            agg_side = side
        return True

    # psum'd count directories stay worthwhile while the collective
    # volume (extent × 4 B) is small next to the all_to_all volume it
    # replaces (the whole input, twice); the JAX package's bound
    PSUM_DIRECTORY_MAX_SLOTS = 1 << 22

    def _try_join_agg_pushdown(self, node: AggregateNode, feeds):
        """count/sum/min/max over an inner join weighted by per-probe
        match counts (the JAX executor's pushdown), or None when the
        shape does not qualify (generator).  On a mesh a repartition
        join with a dense build key takes the psum-directory variant,
        which needs no shuffle; at one position both coincide."""
        from ..ops.join import _bounds
        from ..planner import expr as ir

        if not self.agg_pushdown_shape(node):
            return None
        j = node.input
        lcids = set(j.left.out_columns)
        agg_side = None
        for a, _cid in node.aggs:
            if a.kind == "count_star":
                continue
            cids = {c.cid for c in ir.walk(a.arg) if isinstance(c, ir.BCol)}
            agg_side = "left" if cids <= lcids else "right"
        if agg_side is None:
            agg_side = ("left" if getattr(j, "build_side", "right")
                        == "right" else "right")
        if self.n_dev > 1 and j.strategy in ("repart_both", "repart_left",
                                             "repart_right"):
            pushed = yield from self._agg_pushdown_psum_directory(
                node, j, agg_side, feeds)
            if pushed is not None:
                return pushed
        lblk, rblk, lkeys, lmatch, rkeys, rmatch = \
            yield from self._join_inputs(j, feeds)
        if agg_side == "left":
            pblk, pkeys, pmatch = lblk, lkeys, lmatch
            bkeys, bmatch = rkeys, rmatch
            extents = getattr(j, "right_key_extents", ())
        else:
            pblk, pkeys, pmatch = rblk, rkeys, rmatch
            bkeys, bmatch = lkeys, lmatch
            extents = getattr(j, "left_key_extents", ())
        dense = self._dense_for(extents, bkeys)
        _order, lo, hi, dense_oob = _bounds(bkeys, bmatch, pkeys, dense)
        self._dense_oob = self._dense_oob + dense_oob
        counts = torch.where(pmatch, hi - lo, torch.zeros_like(lo))
        return (yield from self._agg_from_match_counts(node, pblk, counts))

    def _agg_pushdown_psum_directory(self, node: AggregateNode, j,
                                     agg_side: str, feeds):
        """Global aggregate over a repartition join without a shuffle:
        each position scatter-adds its build rows into an [extent]
        count directory keyed by the dense join key, ONE psum makes it
        global, and every probe row reads its global match count
        locally (generator).  None when ineligible (multi-key join, no
        dense extent, directory too wide, or a dense_oob retry)."""
        if self.caps.dense_off:
            return None
        if len(j.left_keys) != 1 or len(j.right_keys) != 1:
            return None
        extents = (getattr(j, "right_key_extents", ())
                   if agg_side == "left"
                   else getattr(j, "left_key_extents", ()))
        if not extents or extents[0] is None:
            return None
        base, extent = int(extents[0][0]), int(extents[0][1])
        if not (0 < extent + 1 <= self.PSUM_DIRECTORY_MAX_SLOTS):
            return None
        lblk = yield from self._exec(j.left, feeds)
        rblk = yield from self._exec(j.right, feeds)
        key_int32 = getattr(j, "key_int32", ())
        lkeys, lmatch = self._eval_keys(lblk, j.left_keys, key_int32)
        rkeys, rmatch = self._eval_keys(rblk, j.right_keys, key_int32)
        if j.left_match_filter is not None:
            lmatch = lmatch & predicate_mask(j.left_match_filter,
                                             self._src(lblk))
        if j.right_match_filter is not None:
            rmatch = rmatch & predicate_mask(j.right_match_filter,
                                             self._src(rblk))
        if agg_side == "left":
            pblk, pkeys, pmatch = lblk, lkeys, lmatch
            bkeys, bmatch = rkeys, rmatch
        else:
            pblk, pkeys, pmatch = rblk, rkeys, rmatch
            bkeys, bmatch = lkeys, lmatch
        # build rows outside the planned extent would miss the
        # directory: count them into dense_oob (stale statistics retry
        # on the repartition path); probe keys outside match nothing
        raw_b = bkeys[0].to(torch.int64) - base
        b_in = (raw_b >= 0) & (raw_b < extent)
        self._dense_oob = self._dense_oob + (bmatch & ~b_in).sum()
        idx = torch.where(bmatch & b_in, raw_b,
                          torch.full_like(raw_b, extent))
        dirc = torch.zeros(extent + 1, dtype=torch.int32,
                           device=self.device).index_add_(
            0, idx, torch.ones_like(idx, dtype=torch.int32))[:extent]
        (dirc,) = yield from self._allreduce([dirc], ["sum"])
        raw_p = pkeys[0].to(torch.int64) - base
        p_in = (raw_p >= 0) & (raw_p < extent)
        pidx = torch.clamp(raw_p, 0, extent - 1)
        counts = torch.where(pmatch & p_in, dirc[pidx].to(torch.int64),
                             torch.zeros_like(raw_p))
        return (yield from self._agg_from_match_counts(node, pblk, counts))

    def _agg_from_match_counts(self, node: AggregateNode, pblk: Block,
                               counts):
        """Finish an aggregate pushdown from per-probe-row match counts:
        each probe row lives on one position, so the positions' partials
        combine by psum / pmin / pmax, and position 0 emits the row
        (generator)."""
        values = self._agg_values(node, pblk)
        locals_, ops, slots = [], [], []
        for (_a, cid), (v, kind, vv) in zip(node.aggs, values):
            contrib = pblk.valid if vv is None else (pblk.valid & vv)
            w = torch.where(contrib, counts, torch.zeros_like(counts))
            if kind == "count":
                slots.append((cid, kind, None, len(locals_), None))
                locals_.append(w.sum())
                ops.append("sum")
                continue
            if kind == "sum":
                total = (torch.where(contrib, v, torch.zeros_like(v))
                         * w.to(v.dtype)).sum()
                op = "sum"
            elif kind == "min":
                total = torch.where(contrib & (w > 0), v,
                                    torch.full_like(v, _big(v.dtype))).min()
                op = "min"
            elif kind == "max":
                total = torch.where(contrib & (w > 0), v,
                                    torch.full_like(v, _small(v.dtype))).max()
                op = "max"
            else:
                raise ExecutionError(f"bad agg kind {kind}")
            slots.append((cid, kind, v.dtype, len(locals_),
                          len(locals_) + 1))
            locals_.extend([total, w.sum()])
            ops.extend([op, "sum"])
        combined = yield from self._allreduce(locals_, ops)
        cols, nulls = {}, {}
        for cid, kind, dt, vi, ni in slots:
            if kind == "count":
                cols[cid] = combined[vi].reshape(1).to(torch.int64)
                continue
            cols[cid] = combined[vi].reshape(1).to(dt)
            nulls[cid] = (combined[ni] == 0).reshape(1)
        return Block(cols, self._is_first((1,)), nulls)

    def _exec_aggregate(self, node: AggregateNode, feeds):
        pushed = yield from self._try_join_agg_pushdown(node, feeds)
        if pushed is not None:
            return pushed
        blk = yield from self._exec(node.input, feeds)
        if self.n_dev > 1 and node.input.dist.kind == "replicated":
            # replicated rows exist on every position: aggregate once
            blk = blk.with_filter(self._is_first(blk.valid.shape))
        if node.dense_keys is not None and not self.caps.dense_off and \
                node.combine in ("local", "repartition"):
            return (yield from self._exec_dense_aggregate(node, blk))
        if self.agg_bucket_shape(node, self.caps.dense_off) and \
                id(node) in self.caps.agg_bucket:
            return (yield from self._exec_bucketed_aggregate(node, blk))
        key_arrays, key_meta, values = self._agg_inputs(node, blk)

        if node.combine == "global":
            # no GROUP BY: one row per position, combined by psum / pmin
            # / pmax; position 0 emits it
            locals_, ops, slots = [], [], []
            for (_a, cid), (v, kind, vv) in zip(node.aggs, values):
                contrib = blk.valid if vv is None else (blk.valid & vv)
                if kind == "count":
                    slots.append((cid, kind, None, len(locals_)))
                    locals_.append(contrib.to(torch.int64).sum())
                    ops.append("sum")
                    continue
                if kind == "sum":
                    total = torch.where(contrib, v, torch.zeros_like(v)).sum()
                elif kind == "min":
                    total = torch.where(contrib, v, torch.full_like(
                        v, _big(v.dtype))).min()
                elif kind == "max":
                    total = torch.where(contrib, v, torch.full_like(
                        v, _small(v.dtype))).max()
                else:
                    raise ExecutionError(f"bad agg kind {kind}")
                slots.append((cid, kind, v.dtype, len(locals_)))
                locals_.extend([total, contrib.to(torch.int64).sum()])
                ops.extend([kind, "sum"])
            combined = yield from self._allreduce(locals_, ops)
            cols, nulls = {}, {}
            for cid, kind, dt, i in slots:
                if kind == "count":
                    cols[cid] = combined[i].reshape(1)
                    continue
                cols[cid] = combined[i].reshape(1).to(dt)
                # COUNT of zero rows is 0; the others are NULL on empty
                nulls[cid] = (combined[i + 1] == 0).reshape(1)
            return Block(cols, self._is_first((1,)), nulls)

        if node.combine not in ("local", "repartition"):
            raise ExecutionError(f"bad combine mode {node.combine}")
        # companion contribution counts: an all-NULL group yields NULL
        companions = [(v, "count", vv) if kind != "count" else None
                      for v, kind, vv in values]
        all_values = values + [c for c in companions if c is not None]
        gk, res, gvalid, ngroups = self._segment_aggregate_maybe_packed(
            node, key_arrays, key_meta, all_values, blk.valid)
        gk, res, gvalid = self._slice_groups(node, gk, res, gvalid, ngroups)
        partial = self._partial_block(node, key_meta, gk,
                                      res[:len(values)], gvalid)
        comp_res = iter(res[len(values):])
        comp_cids = []
        for (_a, cid), comp in zip(node.aggs, companions):
            if comp is not None:
                cnt = next(comp_res)
                partial.nulls[cid] = cnt == 0
                partial.columns[f"__cnt_{cid}"] = cnt
                comp_cids.append(cid)
        if node.combine == "local" or self.n_dev == 1:
            # one position (or groups that never span positions): the
            # partials are final
            for cid in comp_cids:
                partial.columns.pop(f"__cnt_{cid}")
            return partial
        return (yield from self._combine_partials(node, key_meta, partial,
                                                  comp_cids))

    def _combine_partials(self, node: AggregateNode, key_meta,
                          partial: Block, comp_cids: list):
        """combine='repartition' on a mesh: shuffle the partial groups by
        key hash, then merge them, so one position owns each group
        (generator).  The key arrays carry the null flags, so NULL
        groups route consistently; `repart_keys` (the DISTINCT rewrite)
        restricts the ROUTING to a key subset while co-routed rows
        still merge by the full key set."""
        route_idx = (set(node.repart_keys)
                     if getattr(node, "repart_keys", None) is not None
                     else None)
        shuffle_keys = []
        for ki, (cid, has_null) in enumerate(key_meta):
            if route_idx is not None and ki not in route_idx:
                continue
            v = _routing_int64(partial.columns[cid])
            if has_null:
                nm = partial.null_mask(cid)
                shuffle_keys.append(torch.where(nm, torch.zeros_like(v), v))
                shuffle_keys.append(nm.to(torch.int64))
            else:
                shuffle_keys.append(v)
        shuffled = yield from self._repartition(
            partial, None, self.n_dev, tuple(range(self.n_dev)),
            self.caps.repartition[id(node)], key_arrays=shuffle_keys,
            valid=partial.valid, record_nid=id(node))
        key_arrays2 = []
        for cid, has_null in key_meta:
            key_arrays2.append(shuffled.columns[cid])
            if has_null:
                key_arrays2.append(shuffled.null_mask(cid).to(torch.int32))
        values2 = []
        for a, cid in node.aggs:
            kind = {"count": "count", "count_star": "count", "sum": "sum",
                    "avg": "sum", "min": "min", "max": "max"}[a.kind]
            # a partial count merges by summing: `sum` keeps its int64
            values2.append((shuffled.columns[cid],
                            "sum" if kind == "count" else kind, None))
        for cid in comp_cids:
            values2.append((shuffled.columns[f"__cnt_{cid}"], "sum", None))
        gk2, res2, gvalid2, ngroups2 = self._segment_aggregate_maybe_packed(
            node, key_arrays2, key_meta, values2, shuffled.valid)
        gk2, res2, gvalid2 = self._slice_groups(node, gk2, res2, gvalid2,
                                                ngroups2)
        final = self._partial_block(node, key_meta, gk2,
                                    res2[:len(node.aggs)], gvalid2)
        for cid, cnt in zip(comp_cids, res2[len(node.aggs):]):
            final.nulls[cid] = cnt == 0
        return final

    def _exec_dense_aggregate(self, node: AggregateNode, blk: Block):
        """Dense-grid aggregation: group keys with small known ranges map
        to one slot id; sums reduce unsorted over [total] slots, and the
        positions' grids combine by psum / pmin / pmax (`_combine_grid`;
        generator)."""
        specs = node.dense_keys
        total = node.dense_total
        n = blk.valid.shape[0]
        src = self._src(blk)
        slot = torch.zeros(n, dtype=torch.int64, device=self.device)
        stride = 1
        strides = []
        for (g, _cid), (base, extent, has_null) in zip(node.group_keys,
                                                       specs):
            v, nmask = evaluate(g, src)
            v = torch.broadcast_to(v, (n,))
            # rebase in the key's own width first
            rebased = v.to(torch.int64) - int(base)
            idx = torch.clamp(rebased, 0, extent - 1)
            nm = torch.broadcast_to(nmask, (n,)) if nmask is not None \
                else None
            # a key outside the planned extent means stale statistics:
            # surface as dense_oob (→ retry on the sort path)
            oob = (rebased < 0) | (rebased >= extent)
            if nm is not None:
                oob = oob & ~nm
                if not has_null:
                    oob = oob | nm
            self._dense_oob = self._dense_oob + (oob & blk.valid).sum()
            if has_null and nm is not None:
                idx = torch.where(nm, torch.full_like(idx, extent), idx)
            slot = slot + idx * stride
            strides.append(stride)
            stride *= extent + (1 if has_null else 0)
        slot = torch.where(blk.valid, slot,
                           torch.full_like(slot, total)).to(torch.int32)

        values = self._agg_values(node, blk)
        # per-slot sums: the row count, each sum and count, and each
        # companion contribution count, all in one _dense_sums call.
        # Invalid rows sit in the trash slot, so a sum column needs
        # zeroing only under its NULLs.
        sums = [blk.valid]
        sum_of: dict[int, int] = {}
        companion_of: dict[int, int] = {}
        by_kind: dict[tuple, list] = {}
        for i, (v, kind, vv) in enumerate(values):
            contrib = blk.valid if vv is None else (blk.valid & vv)
            if kind == "count":
                sum_of[i] = len(sums)
                sums.append(contrib)
                continue
            if kind == "sum":
                sum_of[i] = len(sums)
                sums.append(v if vv is None else
                            torch.where(vv, v, torch.zeros_like(v)))
            elif kind in ("min", "max"):
                ident = _big(v.dtype) if kind == "min" else _small(v.dtype)
                arr = torch.where(contrib, v, torch.full_like(v, ident))
                by_kind.setdefault((kind, v.dtype), []).append((i, arr))
            else:
                raise ExecutionError(f"bad agg kind {kind}")
            companion_of[i] = len(sums)
            sums.append(contrib)
        red = self._dense_sums(sums, slot, total)
        rows_per_slot = red[0]
        results = [red[sum_of[i]] if i in sum_of else None
                   for i in range(len(values))]
        companions = [red[companion_of[i]] if i in companion_of else None
                      for i in range(len(values))]
        slot64 = slot.to(torch.int64) if by_kind else None
        for (op, _dt), items in by_kind.items():
            data = torch.stack([a for _, a in items], dim=1)
            ident = _big(data.dtype) if op == "min" else _small(data.dtype)
            ext = torch.full((total + 1, data.shape[1]), ident,
                             dtype=data.dtype, device=self.device)
            ext.scatter_reduce_(0, slot64[:, None].expand_as(data), data,
                                reduce="amin" if op == "min" else "amax",
                                include_self=True)
            for j, (i, _a) in enumerate(items):
                results[i] = ext[:total, j]
        results, companions, rows_per_slot, out_valid = \
            yield from self._combine_grid(node, values, results,
                                          companions, rows_per_slot)

        # reconstruct key columns from the slot grid
        iota = torch.arange(total, dtype=torch.int64, device=self.device)
        cols, nulls = {}, {}
        for (g, cid), (base, extent, has_null), st in zip(
                node.group_keys, specs, strides):
            ext = extent + (1 if has_null else 0)
            idx = torch.remainder(torch.div(iota, st, rounding_mode="floor"),
                                  ext)
            cols[cid] = (torch.clamp(idx, 0, extent - 1) + int(base)).to(
                _torch_dtype(g.dtype))
            if has_null:
                nulls[cid] = idx == extent
        for i, ((_a, cid), (_v, kind, _vv)) in enumerate(
                zip(node.aggs, values)):
            r = results[i]
            cols[cid] = r.to(torch.int64) if kind == "count" else r
            if companions[i] is not None:
                nulls[cid] = companions[i] == 0
        return Block(cols, out_valid, nulls)

    def _exec_bucketed_aggregate(self, node: AggregateNode, blk: Block):
        """Bucketed dense-grid aggregation (ops/groupby.py): the packed
        composite slot radix-partitions into 4096-slot tiles, each summed
        sort-free; stale ranges → dense_oob, hot buckets overflow and
        regrow.  The positions' grids combine like the flat dense grid's
        (`_combine_grid`; generator)."""
        from ..ops.groupby import bucketed_grid_aggregate
        from ..utils.faultinjection import fault_point

        # named seam: a failure while building the bucketed pack must
        # leave the plan cache without a half-built entry
        fault_point("executor.agg_bucket_fill")

        specs = node.bucket_keys
        total = node.bucket_total
        key_arrays, key_meta, values = self._agg_inputs(node, blk)
        packed, oob = self._pack_group_keys(node, key_arrays, key_meta,
                                            blk.valid, kr=specs)
        if packed is None:
            raise ExecutionError("bucketed aggregate without a slot layout "
                                 "(planner bug)")
        self._dense_oob = self._dense_oob + oob
        slot = torch.clamp(packed, 0, total - 1)

        op_values = []
        comp_idx: list[int | None] = []
        for v, kind, vv in values:
            contrib = blk.valid if vv is None else (blk.valid & vv)
            if kind == "count":
                op_values.append((contrib.to(torch.int32), "count"))
                comp_idx.append(None)
                continue
            if kind == "sum":
                arr = torch.where(contrib, v, torch.zeros_like(v))
            elif kind == "min":
                arr = torch.where(contrib, v, torch.full_like(v, _big(v.dtype)))
            elif kind == "max":
                arr = torch.where(contrib, v,
                                  torch.full_like(v, _small(v.dtype)))
            else:
                raise ExecutionError(f"bad agg kind {kind}")
            op_values.append((arr, kind))
            comp_idx.append(len(op_values))
            op_values.append((contrib.to(torch.int32), "count"))

        cap = self.caps.agg_bucket[id(node)]
        res, rows_per_slot, boverflow, bfill = bucketed_grid_aggregate(
            slot, blk.valid, op_values, total, cap)
        self._overflow = self._overflow + boverflow
        self._record(id(node), "agg_bucket", bfill, cap)

        results, companions = [], []
        for i, _val in enumerate(values):
            pos = sum(1 for c in comp_idx[:i] if c is not None) + i
            results.append(res[pos])
            ci = comp_idx[i]
            companions.append(None if ci is None else res[ci])
        results, companions, rows_per_slot, out_valid = \
            yield from self._combine_grid(node, values, results,
                                          companions, rows_per_slot)
        self._record(id(node), "agg_grid", (rows_per_slot > 0).sum(),
                     total)

        # reconstruct key columns from the packed slot (first key most
        # significant; lane 0 of each key's width is NULL)
        iota = torch.arange(total, dtype=torch.int64, device=self.device)
        cols, nulls = {}, {}
        stride = total
        for (base, extent, _hn), (g, cid) in zip(specs, node.group_keys):
            width = extent + 1
            stride //= width
            idx = torch.remainder(torch.div(iota, stride,
                                            rounding_mode="floor"), width)
            cols[cid] = (torch.clamp(idx - 1, 0, extent - 1) + int(base)).to(
                _torch_dtype(g.dtype))
            nulls[cid] = idx == 0
        for i, ((_a, cid), (_v, kind, _vv)) in enumerate(
                zip(node.aggs, values)):
            r = results[i]
            cols[cid] = r.to(torch.int64) if kind == "count" else r
            if companions[i] is not None:
                nulls[cid] = companions[i] == 0
        out = Block(cols, out_valid, nulls)
        k = self.caps.agg_out.get(id(node))
        if k is not None and k < total:
            out = self._compact(out, k)
        return out

    def _combine_grid(self, node: AggregateNode, values, results,
                      companions, rows_per_slot):
        """Cross-position combine shared by the flat and bucketed dense
        grids: combine='repartition' psums / pmins / pmaxes the slot
        grids and position 0 emits; 'local' keeps each position's slots
        (generator; the identity at one position).  Returns (results,
        companions, rows_per_slot, out_valid)."""
        if node.combine != "repartition" or self.n_dev == 1:
            return results, companions, rows_per_slot, rows_per_slot > 0
        tensors, ops = [rows_per_slot], ["sum"]
        for i, (_v, kind, _vv) in enumerate(values):
            tensors.append(results[i])
            ops.append("sum" if kind in ("count", "sum") else kind)
        comp_at = []
        for c in companions:
            if c is not None:
                comp_at.append(len(tensors))
                tensors.append(c)
                ops.append("sum")
            else:
                comp_at.append(None)
        got = yield from self._allreduce(tensors, ops)
        rows_per_slot = got[0]
        results = got[1:1 + len(values)]
        companions = [None if j is None else got[j] for j in comp_at]
        out_valid = (rows_per_slot > 0) & self._is_first(
            rows_per_slot.shape)
        return results, companions, rows_per_slot, out_valid

    def _dense_sums(self, arrays: list, slot: torch.Tensor,
                    total: int) -> list:
        """Σ per slot of each [n] array → [total] each (rows at slot
        `total` add nothing).  Where the JAX executor takes its one-hot
        branch — f32 sums, and bool counts exact in f32 while n < 2^24,
        over at most DENSE_ONEHOT_MAX_SLOTS slots — the arrays go as
        they lie into one dense_grid_sum call (its plain version on the
        CPU), an array passed twice read once; counts come back int64.
        Other arrays (int64 / f64 sums) stay on an exact index_add_ in
        their own dtype."""
        from ..ops.hopper_kernels import dense_grid_sum

        n = slot.shape[0]
        small = total + 1 <= self.DENSE_ONEHOT_MAX_SLOTS
        col_of: dict[int, int] = {}
        cols: list = []
        rest: dict[torch.dtype, list] = {}
        for j, arr in enumerate(arrays):
            if small and (arr.dtype == torch.float32 or (
                    arr.dtype == torch.bool and n < (1 << 24))):
                if id(arr) not in col_of:
                    col_of[id(arr)] = len(cols)
                    cols.append(arr)
            else:
                rest.setdefault(arr.dtype, []).append(j)
        out: list = [None] * len(arrays)
        if cols:
            red = dense_grid_sum(slot, cols, total)
            for j, arr in enumerate(arrays):
                if id(arr) in col_of:
                    r = red[:, col_of[id(arr)]]
                    out[j] = r if arr.dtype == torch.float32 else \
                        r.to(torch.int64)
        slot64 = slot.to(torch.int64) if rest else None
        for dt, js in rest.items():
            wide = torch.int64 if dt == torch.bool else dt
            data = torch.stack([arrays[j] for j in js], dim=1).to(wide)
            acc = torch.zeros(total + 1, len(js), dtype=wide,
                              device=self.device)
            acc.index_add_(0, slot64, data)
            for c, j in enumerate(js):
                out[j] = acc[:total, c]
        return out

    def _slice_groups(self, node: AggregateNode, gk, res, gvalid, ngroups):
        """Slice front-packed group slots to the planner's estimated
        capacity; groups beyond it count as overflow."""
        self._record(id(node), "agg_out", ngroups, gvalid.shape[0])
        agg_cap = self.caps.agg_out.get(id(node))
        if agg_cap is None or agg_cap >= gvalid.shape[0]:
            return gk, res, gvalid
        self._overflow = self._overflow + torch.clamp(
            ngroups.to(torch.int64) - agg_cap, min=0)
        return ([k[:agg_cap] for k in gk], [r[:agg_cap] for r in res],
                gvalid[:agg_cap])

    def _partial_block(self, node: AggregateNode, key_meta, gk, res,
                       gvalid) -> Block:
        cols, nulls = {}, {}
        i = 0
        for cid, has_null in key_meta:
            cols[cid] = gk[i]
            i += 1
            if has_null:
                nulls[cid] = gk[i].to(torch.bool)
                i += 1
        for (_a, cid), r in zip(node.aggs, res):
            cols[cid] = r
        return Block(cols, gvalid, nulls)


def _starts(n: int, device) -> torch.Tensor:
    """[n] bool, True at row 0 only."""
    out = torch.zeros(n, dtype=torch.bool, device=device)
    out[:1] = True
    return out


def _shift_ne(a: torch.Tensor) -> torch.Tensor:
    """Row i differs from row i - 1 (row 0 always does)."""
    out = _starts(a.shape[0], a.device)
    out[1:] = a[1:] != a[:-1]
    return out


def _seg_last(boundary: torch.Tensor, iota: torch.Tensor) -> torch.Tensor:
    """Per row: position of the last row of its segment (boundary marks
    segment starts): a reverse running min over next-boundary
    positions."""
    n = iota.shape[0]
    nb = torch.ones_like(boundary)
    nb[:-1] = boundary[1:]
    nxt = torch.where(nb, iota, torch.full_like(iota, n - 1))
    return torch.flip(torch.cummin(torch.flip(nxt, (0,)), 0).values, (0,))


def _partition_total(scan: torch.Tensor, part_boundary: torch.Tensor,
                     iota: torch.Tensor) -> torch.Tensor:
    """Broadcast each partition's last scan value to all its rows."""
    return scan[_seg_last(part_boundary, iota)]


def _torch_dtype(dt) -> torch.dtype:
    """SQL DataType → torch dtype of its device column."""
    from .exprs import _TORCH_DTYPE

    return _TORCH_DTYPE[dt]


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return np.dtype(str(dt).replace("torch.", "").replace("bool", "bool_"))


def _big(dtype):
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _small(dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def _routing_int64(v: torch.Tensor) -> torch.Tensor:
    """A shuffle routing key as int64: floats by their bit pattern."""
    if v.dtype == torch.float32:
        return v.contiguous().view(torch.int32).to(torch.int64)
    if v.dtype == torch.float64:
        return v.contiguous().view(torch.int64)
    return v.to(torch.int64)


def _combine_hash64(parts: list) -> torch.Tensor:
    """Mix several key columns into one 64-bit key (the JAX package's
    combine_hash64, in int64 with wrapping arithmetic)."""
    acc = torch.zeros(parts[0].shape, dtype=torch.int64,
                      device=parts[0].device)
    for p in parts:
        h = hash_token(p).to(torch.int64) & 0xFFFFFFFF
        acc = (acc * 0x100000001B3) ^ h
    return acc
