"""Run a QueryPlan eagerly on one device: the port's PlanCompiler.

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
* outputs return packed as one [n_out, 1, cap] int64 block plus one
  counter vector — two device→host copies per execution — and unpack
  through `unpack_outputs`.

On one device every repartition, psum and all_gather is the identity.
The dense-grid segment sum runs in the dense_grid_sum kernel on the card
where the JAX executor takes its one-hot branch (f32 stacks and int32
counts with n < 2^24, at most DENSE_ONEHOT_MAX_SLOTS slots).

Not in this slice (raise UnsupportedQueryError): window functions,
semi/anti joins, expansion-path outer joins, INSERT..SELECT routing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..errors import ExecutionError, PlanningError, UnsupportedQueryError
from ..ops.aggregate import segment_aggregate
from ..ops.join import expand_join_pairs
from ..planner.plan import (
    AggregateNode,
    JoinNode,
    PlanNode,
    ProjectNode,
    QueryPlan,
    ScanNode,
    WindowNode,
)
from .batch import Block
from .exprs import ColumnSource, evaluate, predicate_mask

_TORCH_FLOAT = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


def _round_cap(n: int) -> int:
    return max(128, int(math.ceil(n / 128.0)) * 128)


def _to_bits64(a: torch.Tensor) -> torch.Tensor:
    """Lossless widening to int64 for the packed transfer."""
    if a.dtype == torch.float64:
        return a.contiguous().view(torch.int64)
    if a.dtype == torch.float32:
        # sign-extended int32 bits; host truncation recovers them exactly
        return a.contiguous().view(torch.int32).to(torch.int64)
    return a.to(torch.int64)


def _from_bits64(arr: np.ndarray, dtype: np.dtype) -> np.ndarray:
    if dtype == np.float64:
        return arr.view(np.float64)
    if dtype == np.float32:
        return arr.astype(np.int32).view(np.float32)
    if dtype == np.bool_:
        return arr != 0
    return arr.astype(dtype)


def unpack_outputs(packed: np.ndarray, out_meta):
    """Packed [n_out, 1, cap] int64 → (cols, nulls, valid) numpy."""
    cols: dict[str, np.ndarray] = {}
    nulls: dict[str, np.ndarray] = {}
    valid = None
    for i, (kind, cid, dt) in enumerate(out_meta):
        arr = _from_bits64(packed[i], dt)
        if kind == "col":
            cols[cid] = arr
        elif kind == "null":
            nulls[cid] = arr
        else:
            valid = arr
    return cols, nulls, valid


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
    `run(plan, feeds)` executes the plan and returns the packed outputs
    and counters.  The plan cache keeps instances across executions."""

    # one-hot eligibility bound of the JAX executor's dense-grid sum; the
    # port routes the same shapes through the dense_grid_sum kernel
    DENSE_ONEHOT_MAX_SLOTS = 4096

    def __init__(self, plan: QueryPlan, caps: Capacities,
                 compute_dtype=np.float32, device="cpu"):
        self.caps = caps
        self.compute_dtype = _TORCH_FLOAT[np.dtype(compute_dtype)]
        self.device = torch.device(device)
        self.out_meta = None
        self.stage_keys = None
        if plan.n_devices != 1:
            raise ExecutionError("the port executes on one device")
        if plan.output_repart is not None:
            raise UnsupportedQueryError(
                "INSERT..SELECT device routing is not in this port yet")

    # ------------------------------------------------------------------
    def run(self, plan: QueryPlan, feeds) -> tuple:
        """Execute against `feeds` (FeedSpec by scan-node id).  Returns
        (packed [n_out, 1, cap] int64 numpy, counters [2 + n_stages]
        int64 numpy, out_meta, stage_keys): counters are [capacity
        overflow, dense_oob, *stage actuals] and stage_keys entries are
        (walk_index, kind, width)."""
        from .cache import plan_order

        self.plan = plan
        self._walk_order = plan_order(plan)
        self._stage_actual = {}
        self._stage_width = {}
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        self._overflow = zero
        self._dense_oob = zero
        blocks = {nid: Block(dict(f.arrays), f.valid, dict(f.nulls))
                  for nid, f in feeds.items()}
        try:
            out = self._exec(plan.root, blocks)
            topk = plan.device_topk
            if topk is not None and out.valid.shape[0] > topk:
                out = self._device_topk(out, topk)
            out_cids = sorted(plan.root.out_columns)
            shape = out.valid.shape
            rows, meta = [], []
            for cid in out_cids:
                col = torch.broadcast_to(out.columns[cid], shape)
                rows.append(_to_bits64(col))
                meta.append(("col", cid, _np_dtype(col.dtype)))
            for cid in out_cids:
                rows.append(torch.broadcast_to(out.null_mask(cid),
                                               shape).to(torch.int64))
                meta.append(("null", cid, np.dtype(np.bool_)))
            rows.append(out.valid.to(torch.int64))
            meta.append(("valid", "", np.dtype(np.bool_)))
            skeys = sorted(self._stage_actual,
                           key=lambda k: (self._walk_order.get(
                               k[0], 1 << 30), k[1]))
            stage_keys = [(self._walk_order.get(nid, -1), kind,
                           self._stage_width[(nid, kind)])
                          for nid, kind in skeys]
            counters = torch.stack(
                [self._overflow, self._dense_oob]
                + [self._stage_actual[k] for k in skeys])
            packed = torch.stack(rows).cpu().numpy()
            counters = counters.cpu().numpy()
        finally:
            self.plan = None
        self.out_meta, self.stage_keys = meta, stage_keys
        return packed[:, None, :], counters, meta, stage_keys

    # ------------------------------------------------------------------
    def _src(self, blk: Block) -> ColumnSource:
        return ColumnSource(blk.columns, blk.nulls, self.device,
                            self.compute_dtype)

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

    def _exec(self, node: PlanNode, feeds: dict[int, Block]) -> Block:
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
            return self._project(self._exec(node.input, feeds), node.exprs)
        if isinstance(node, JoinNode):
            return self._exec_join(node, feeds)
        if isinstance(node, WindowNode):
            raise UnsupportedQueryError(
                "window functions are not in this port yet")
        if isinstance(node, AggregateNode):
            return self._exec_aggregate(node, feeds)
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
        """Both sides + key evaluation.  On one device the repartition
        strategies and the cartesian all_gather are the identity."""
        if node.strategy not in ("local", "broadcast", "cartesian_gather",
                                 "repart_right", "repart_left",
                                 "repart_both"):
            raise ExecutionError(f"bad join strategy {node.strategy}")
        lblk = self._exec(node.left, feeds)
        rblk = self._exec(node.right, feeds)
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

    def _exec_join(self, node: JoinNode, feeds) -> Block:
        if node.join_type in ("semi", "anti"):
            raise UnsupportedQueryError(
                "semi/anti joins are not in this port yet")
        lblk, rblk, lkeys, lmatch, rkeys, rmatch = \
            self._join_inputs(node, feeds)
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
        if node.join_type != "inner":
            raise UnsupportedQueryError(
                f"{node.join_type} joins on the expansion path are not in "
                "this port yet")
        out_cap = self.caps.join_out[id(node)]
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

    def _try_join_agg_pushdown(self, node: AggregateNode, feeds):
        """count/sum/min/max over an inner join weighted by per-probe
        match counts (the JAX executor's pushdown; on one device its
        psum-directory variant and the plain one coincide)."""
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
        lblk, rblk, lkeys, lmatch, rkeys, rmatch = \
            self._join_inputs(j, feeds)
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
        values = self._agg_values(node, pblk)
        cols, nulls = {}, {}
        for (_a, cid), (v, kind, vv) in zip(node.aggs, values):
            contrib = pblk.valid if vv is None else (pblk.valid & vv)
            w = torch.where(contrib, counts, torch.zeros_like(counts))
            if kind == "count":
                cols[cid] = w.sum().reshape(1)
                continue
            if kind == "sum":
                total = (torch.where(contrib, v, torch.zeros_like(v))
                         * w.to(v.dtype)).sum()
            elif kind == "min":
                total = torch.where(contrib & (w > 0), v,
                                    torch.full_like(v, _big(v.dtype))).min()
            elif kind == "max":
                total = torch.where(contrib & (w > 0), v,
                                    torch.full_like(v, _small(v.dtype))).max()
            else:
                raise ExecutionError(f"bad agg kind {kind}")
            cols[cid] = total.reshape(1).to(v.dtype)
            nulls[cid] = (w.sum() == 0).reshape(1)
        return Block(cols, torch.ones(1, dtype=torch.bool,
                                      device=self.device), nulls)

    def _exec_aggregate(self, node: AggregateNode, feeds) -> Block:
        pushed = self._try_join_agg_pushdown(node, feeds)
        if pushed is not None:
            return pushed
        blk = self._exec(node.input, feeds)
        if node.dense_keys is not None and not self.caps.dense_off and \
                node.combine in ("local", "repartition"):
            return self._exec_dense_aggregate(node, blk)
        if self.agg_bucket_shape(node, self.caps.dense_off) and \
                id(node) in self.caps.agg_bucket:
            return self._exec_bucketed_aggregate(node, blk)
        key_arrays, key_meta, values = self._agg_inputs(node, blk)

        if node.combine == "global":
            cols, nulls = {}, {}
            for (_a, cid), (v, kind, vv) in zip(node.aggs, values):
                contrib = blk.valid if vv is None else (blk.valid & vv)
                if kind == "count":
                    cols[cid] = contrib.to(torch.int64).sum().reshape(1)
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
                cols[cid] = total.reshape(1).to(v.dtype)
                # COUNT of zero rows is 0; the others are NULL on empty
                nulls[cid] = (contrib.sum() == 0).reshape(1)
            return Block(cols, torch.ones(1, dtype=torch.bool,
                                          device=self.device), nulls)

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
        for (_a, cid), comp in zip(node.aggs, companions):
            if comp is not None:
                partial.nulls[cid] = next(comp_res) == 0
        # combine='repartition' shuffles partial groups by key so one
        # device owns each group; on one device the partials are final
        return partial

    def _exec_dense_aggregate(self, node: AggregateNode, blk: Block) -> Block:
        """Dense-grid aggregation: group keys with small known ranges map
        to one slot id; sums reduce unsorted over [total] slots."""
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
        rows_per_slot = self._dense_segment_sum(
            blk.valid.to(torch.int32)[:, None], slot, total)[:total, 0]
        # stacked reductions: one segment op per (reduction kind, dtype)
        results: list = [None] * len(values)
        companions: list = [None] * len(values)
        by_kind: dict[tuple, list] = {}
        for i, (v, kind, vv) in enumerate(values):
            contrib = blk.valid if vv is None else (blk.valid & vv)
            if kind == "count":
                by_kind.setdefault(("sum", torch.int32), []).append(
                    (i, contrib.to(torch.int32)))
                continue
            if kind == "sum":
                arr = torch.where(contrib, v, torch.zeros_like(v))
                by_kind.setdefault(("sum", v.dtype), []).append((i, arr))
            elif kind in ("min", "max"):
                ident = _big(v.dtype) if kind == "min" else _small(v.dtype)
                arr = torch.where(contrib, v, torch.full_like(v, ident))
                by_kind.setdefault((kind, v.dtype), []).append((i, arr))
            else:
                raise ExecutionError(f"bad agg kind {kind}")
            by_kind.setdefault(("companion", torch.int32), []).append(
                (i, contrib.to(torch.int32)))
        slot64 = slot.to(torch.int64)
        for (op, _dt), items in by_kind.items():
            data = torch.stack([a for _, a in items], dim=1)
            if op in ("sum", "companion"):
                red = self._dense_segment_sum(data, slot, total)
            else:
                ident = _big(data.dtype) if op == "min" else \
                    _small(data.dtype)
                red = torch.full((total + 1, data.shape[1]), ident,
                                 dtype=data.dtype, device=self.device)
                red.scatter_reduce_(0, slot64[:, None].expand_as(data), data,
                                    reduce="amin" if op == "min" else "amax",
                                    include_self=True)
            red = red[:total]
            for j, (i, _a) in enumerate(items):
                if op == "companion":
                    companions[i] = red[:, j]
                else:
                    results[i] = red[:, j]
        out_valid = rows_per_slot > 0

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

    def _exec_bucketed_aggregate(self, node: AggregateNode,
                                 blk: Block) -> Block:
        """Bucketed dense-grid aggregation (ops/groupby.py): the packed
        composite slot radix-partitions into 4096-slot tiles, each summed
        sort-free; stale ranges → dense_oob, hot buckets overflow and
        regrow."""
        from ..ops.groupby import bucketed_grid_aggregate

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
        out_valid = rows_per_slot > 0
        self._record(id(node), "agg_grid", out_valid.sum(), total)

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

    def _dense_segment_sum(self, data: torch.Tensor, slot: torch.Tensor,
                           total: int) -> torch.Tensor:
        """Σ per slot of [n, m] data → [total+1, m] (row `total` holds
        no contributions).  Where the JAX executor takes its one-hot
        branch — f32 sums, and int32 counts exact in f32 while n < 2^24,
        over at most DENSE_ONEHOT_MAX_SLOTS slots — the sum runs in the
        dense_grid_sum kernel (its plain version on the CPU); int64 /
        f64 stacks stay on an exact index_add_."""
        from ..ops.hopper_kernels import dense_grid_sum

        n, m = data.shape
        dt = data.dtype
        eligible = (total + 1 <= self.DENSE_ONEHOT_MAX_SLOTS
                    and (dt == torch.float32
                         or (dt == torch.int32 and n < (1 << 24))))
        if not eligible:
            out = torch.zeros(total + 1, m, dtype=dt, device=self.device)
            return out.index_add_(0, slot.to(torch.int64), data)
        red = dense_grid_sum(slot.contiguous(),
                             data.to(torch.float32).contiguous(), total)
        red = torch.cat([red, torch.zeros(1, m, dtype=torch.float32,
                                          device=self.device)])
        return red.to(dt) if dt == torch.int32 else red

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
