"""The port's compiled form: a warm resident plan replayed as a CUDA graph.

The JAX package compiles each plan once into one XLA program.  PyTorch
runs a plan eagerly, launch by launch, and on the card a warm resident
query's device then idles while the host enqueues.  A `CapturedPlan`
records `PlanCompiler._dispatch` once as one CUDA graph and replays it:
one launch from the host for the whole device program.

* **When.**  The runner captures a plan-cache key after one clean eager
  run at its converged capacities (nothing overflowed, nothing left to
  tighten) over the same feed keys, or at once when the key was armed
  from the persisted cache (executor/execcache.py).  Capture runs the
  dispatch once eagerly on a side stream (the warm-up PyTorch requires;
  its counters must be clean), then records it on that stream into a
  private memory pool (`CUDAGraph.capture_begin`/`capture_end`), in
  ``thread_local`` capture mode so that other sessions' threads keep
  running eagerly meanwhile.  N sessions racing one key capture once
  (the data_dir's CompileGate); the followers replay the leader's graph,
  and a session meeting a key another session already captured over
  the same feed keys adopts that graph.
* **What it reads.**  The graph reads the feed tensors of the session
  that captured it and the capturing compiler's list constants (IN
  lists, string remap tables, uploaded by the warm-up run outside the
  graph's pool).  It holds both strongly, so a graph another session
  adopted stays sound after the capturer closes or its plan cache evicts
  the compiler.  It is valid for a run only while that run's feeds
  carry the same feed-cache keys (same table, data version, columns,
  pruning, placement).  When the capturing
  session's feed cache drops one of those feeds (DML invalidation, LRU,
  the OOM ladder's eviction) the graph is released with it.  `$n`
  parameters are 0-d tensors the graph reads; each replay refills them.
* **Counting.**  Launches during capture run nothing and are recorded on
  the graph (`hopper_kernels.recording_launches`); each replay adds
  them to the kernels' launch counts.
* **Memory.**  The graph's private pool is measured after capture and
  charged to the data_dir's accountant under ``graph``; releasing the
  graph releases the charge.  The OOM ladder releases graphs before it
  evicts feeds.
* **Replay.**  Replay and the fetch of its static outputs run under the
  graph's own lock, so two sessions never overwrite each other's
  outputs before they are copied out.
* **No silent fallback.**  A run whose feeds are not all cache-resident
  (an open transaction's overlay, a multi-pass split scan, a zero feed
  cache) runs eagerly with that reason on its ``compile`` span and in
  EXPLAIN ANALYZE's Caches line.  A capture that fails on CUDA raises.
  Streamed batches rotate their buffers and stay eager.
"""

from __future__ import annotations

import threading
import weakref

import torch

from .compiler import collect_device_params
from .exprs import ColumnSource, _dt

# feeds whose tensors the graph would read must be served by the feed
# cache; the reason a run stays eager otherwise
NOT_RESIDENT = "feeds not cache-resident"


class CapturedPlan:
    """One captured dispatch: the CUDA graph, its static outputs, the
    feeds it reads and the launches it makes."""

    def __init__(self, key, graph, packed, counters, out_meta, stage_keys,
                 feed_keys: tuple, feed_tensors: list, consts: dict,
                 params: dict, launches: dict, pool_bytes: int,
                 accountant):
        self.lock = threading.Lock()
        self.key = key
        self.graph = graph
        self.packed = packed
        self.counters = counters
        self.out_meta = out_meta
        self.stage_keys = stage_keys
        self.feed_keys = feed_keys
        self._feeds = feed_tensors
        self.feed_ids = frozenset(id(t) for t in feed_tensors)
        # the list constants the dispatch reads: they live outside the
        # graph's pool, and the compiler that uploaded them may go first
        self._consts = consts
        self.params = params
        self.launches = dict(launches)
        # the charge goes back on release() or, for a graph its sessions
        # dropped unreleased, when it is collected
        self._charge = weakref.finalize(
            self, accountant.release, accountant.charge("graph", pool_bytes))
        self.live = True
        accountant.register_graph(self)

    def reads_any(self, tensor_ids) -> bool:
        return not self.feed_ids.isdisjoint(tensor_ids)

    def valid_for(self, feed_keys: tuple) -> bool:
        return self.live and feed_keys == self.feed_keys

    def replay(self, plan) -> None:
        """Refill the parameters from `plan`, replay, count launches.
        The caller holds `lock` until the outputs are fetched."""
        from ..ops.hopper_kernels import count_replay

        if self.params:
            values = {p.idx: p.value for p in collect_device_params(plan)}
            for idx, t in self.params.items():
                t.fill_(values[idx])
        self.graph.replay()
        count_replay(self.launches)

    def release(self) -> None:
        """Drop the graph, its pool, its outputs and its feed references,
        and give back the accountant's charge.  Idempotent."""
        with self.lock:
            if not self.live:
                return
            self.live = False
            self.graph = self.packed = self.counters = None
            self._feeds = []
            self._consts = {}
            self.params = {}
        self._charge()


def pool_bytes(graph) -> int:
    """Bytes of the caching allocator's segments owned by `graph`'s
    private pool (its intermediates and static outputs)."""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def _param_tensors(plan, compiler) -> dict:
    """One 0-d device tensor per `$n` parameter, filled with this run's
    value: the graph reads them, each replay refills them."""
    src = ColumnSource({}, device=compiler.device,
                       float_dtype=compiler.compute_dtype)
    out = {}
    for p in collect_device_params(plan):
        out[p.idx] = torch.full((), p.value, dtype=_dt(p.dtype, src),
                                device=compiler.device)
    return out


def capture(key, compiler, plan, feeds, caps, feed_keys: tuple,
            accountant):
    """Capture `compiler`'s dispatch of `plan` over `feeds` at `caps`.
    Returns the CapturedPlan, or None when the warm-up run overflowed or
    tripped a stale statistic (the statement then re-runs on the retry
    path, and the key is captured once it converges).  Raises what CUDA
    raises."""
    from ..ops.hopper_kernels import recording_launches

    dev = compiler.device
    with compiler._run_lock:
        params = _param_tensors(plan, compiler)
        compiler.plan, compiler.caps, compiler._params = plan, caps, params
        try:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            # the warm-up: one eager dispatch on the capture stream (lazy
            # initialisation, list constants uploaded, the counters read)
            with torch.cuda.stream(side):
                _p, counters, _m, _s = compiler._dispatch(plan, feeds)
            side.synchronize()
            c = counters.cpu()
            if int(c[0]) or int(c[1]):
                return None
            del _p, counters, _m, _s, c
            # torch.cuda.graph's context would also synchronize the whole
            # device and empty the allocator's device and pinned-host
            # caches before every capture: other sessions' work and the
            # scan's pinned staging would pay for each one
            graph = torch.cuda.CUDAGraph()
            with recording_launches() as launched, torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    packed, counters, meta, stage_keys = \
                        compiler._dispatch(plan, feeds)
                finally:
                    graph.capture_end()
            held = held_inputs(compiler, feeds)
        finally:
            compiler.plan = compiler.caps = None
            compiler._params = None
            # the capture's counters live in the graph's pool: the
            # compiler must not keep them, or the pool outlives a release
            compiler._forget_run()
    return CapturedPlan(key, graph, packed, counters, meta, stage_keys,
                        feed_keys, *held, params, launched,
                        pool_bytes(graph), accountant)


def held_inputs(compiler, feeds) -> tuple[list, dict]:
    """What a graph captured from `compiler` over `feeds` reads outside
    its pool, for it to hold: the feed tensors, and the list constants
    the warm-up run uploaded (a copy of the dict: the compiler may be
    evicted first).  Taken under the compiler's run lock."""
    tensors = [t for f in feeds.values()
               for t in (*f.arrays.values(), *f.nulls.values(), f.valid)]
    return tensors, dict(compiler._consts)
