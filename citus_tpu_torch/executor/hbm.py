"""Device-memory accountant: the ONE host→device placement seam.

Counterpart of citus_tpu/executor/hbm.py.  Every
feed tensor the port puts on its device flows through
`DeviceMemoryAccountant.place` (or `adopt`, for tensors a device decode
produced), which charges a measured ledger of live bytes, turns an
allocator OOM into the classified `DeviceMemoryExhausted`, and hangs a
``weakref.finalize`` off the returned tensor so the charge is released
the moment the tensor is garbage.  Attach the finalizer to the tensor
the feed holds — never to a view or to `untyped_storage()` (a new
Python object on every call): handing a view past the feed would
release the charge while the memory is still live.  A plan's own
intermediates (join, grid and compaction buffers the compiler allocates
as it runs) charge through `lease` for the duration of each run, at the
same worst-buffer estimate the ``max_plan_buffer_bytes`` guard trusts.

Per-position ledgers (a mesh session, distributed/mesh.py): a sharded
feed places through `place_sharded_slices`, which charges each position
its own slice; every other charge spreads evenly over the positions of
the widest mesh seen (`resize_mesh` narrows it after a failover).  When
N positions share one card, the card's budget splits evenly among them:
an armed MemSim refuses a charge when the total would exceed the budget
OR the hottest position would exceed budget / N, so a skew-placed table
shows up as the hot-position pressure it is.

`MemSim` arms a simulated byte budget (or a fail-at-allocation-N
trigger) at the seam, so tests sweep OOMs on hardware that never runs
out.  Releases credit the simulated budget too, so the degradation
ladder's evictions create real headroom under an armed budget.

The OOM degradation ladder (executor/runner.py `degrade_for_oom`) reads
this ledger: `evict_evictable` is its first rung (every session's
`FeedCache` on the data_dir registers here, weakly), `budget_bytes` and
`pressure_bytes` bound the capacity-regrow guard and size streams.

Charge categories:

* ``feed``     — transient statement-scoped table feeds
* ``cache``    — feed-cache-resident tensors (released on eviction; not
                 admission pressure, since the ladder can reclaim them)
* ``stream``   — in-flight stream / multi-pass batch tensors
* ``prefetch`` — pipelined-scan buffers placed ahead of consumption
                 (executor/scanpipe.py); graduate to their final
                 category through `recharge` when adopted
* ``plan``     — the leased buffer estimate of an executing plan
* ``graph``    — the private memory pools of captured CUDA graphs
                 (executor/graphs.py), measured after capture and
                 released with the graph (not admission pressure: the
                 ladder's first rung releases them before feeds)
* ``other``    — anything else routed through the seam
"""

from __future__ import annotations

import contextlib
import os
import threading
import weakref

import numpy as np
import torch

from ..errors import DeviceMemoryExhausted
from ..utils.faultinjection import fault_point

CATEGORIES = ("feed", "cache", "stream", "prefetch", "plan", "graph",
              "other")
# resident by design: kept between statements, reclaimed by the ladder
RESIDENT = ("cache", "graph")

# substring MemSim (deliberately, like the XLA allocator in the JAX
# package) puts in every simulated OOM message
_OOM_TOKEN = "RESOURCE_EXHAUSTED"

# the CUDA caching allocator's refusal (torch.cuda.OutOfMemoryError is
# the same class)
_TORCH_OOM = getattr(torch, "OutOfMemoryError", torch.cuda.OutOfMemoryError)


def is_resource_exhausted(exc: BaseException) -> bool:
    """Does this exception report a device-allocator OOM: the CUDA
    allocator's `torch.OutOfMemoryError`, or the simulated token?"""
    return isinstance(exc, _TORCH_OOM) or _OOM_TOKEN in str(exc)


class MemSim:
    """One simulated device-memory lifetime: arm with ``budget`` (bytes;
    a charge that would exceed it OOMs) and/or ``fail_at=N`` (the N-th
    charge through the seam OOMs once, 1-based).  Journals every
    charge."""

    def __init__(self, budget: int | None = None,
                 fail_at: int | None = None):
        self.budget = budget
        self.fail_at = fail_at
        self.allocs = 0
        self.oom_raised = 0
        self.journal: list[tuple[int, str, int]] = []


def _host_tensor(host) -> torch.Tensor:
    if isinstance(host, torch.Tensor):
        return host
    return torch.from_numpy(np.ascontiguousarray(host))


class DeviceMemoryAccountant:
    """Measured live device bytes for one data_dir's device."""

    def __init__(self, data_dir: str):
        self.data_dir = data_dir
        # REENTRANT: _release runs from weakref finalizers, which the
        # interpreter may fire at ANY allocation point — including gc
        # triggered inside a _charge that already holds the lock.  A
        # plain Lock would self-deadlock there; with an RLock the
        # nested _release interleaves safely (it touches only its own
        # handle's entry)
        self._mu = threading.RLock()
        self._next_handle = 0
        self._live: dict[int, tuple[str, int, tuple]] = {}
        self._live_total = 0
        # per mesh position: live bytes, over the widest mesh seen
        self._n_dev = 1
        self._live_by_dev: list[int] = [0]
        self._live_by_cat: dict[str, int] = {c: 0 for c in CATEGORIES}
        self._peak_by_cat: dict[str, int] = {c: 0 for c in CATEGORIES}
        self.peak_bytes = 0
        self.charges_total = 0
        self.releases_total = 0
        self.oom_total = 0
        self._sim: MemSim | None = None
        # weak registry of evictable device caches (each session's
        # FeedCache): the device is shared, so the ladder's eviction
        # rung reclaims EVERY session's cache-resident bytes
        self._evictables: list = []
        # every live captured graph on the data_dir's device
        self._graphs: weakref.WeakSet = weakref.WeakSet()

    # -- the seam ----------------------------------------------------------
    def place(self, host, device, category: str = "feed") -> torch.Tensor:
        """Copy one host array (numpy, or a CPU tensor — pinned ones copy
        asynchronously on the current stream) to `device` through the
        accounted seam.  Raises DeviceMemoryExhausted when the allocator
        (real or simulated) refuses.  On the CPU the tensor shares the
        host array's memory."""
        out, _handle = self.place_tracked(host, device, category)
        return out

    def place_tracked(self, host, device, category: str = "feed"):
        """`place` returning ``(tensor, charge_handle)`` — the pipelined
        scan places columns under ``prefetch`` while they sit in its
        queue and graduates the charge via `recharge` on adoption."""
        # named seam: a host→device transfer that dies here must surface
        # as a classified statement error, never a partially placed feed
        fault_point("executor.hbm_exhausted")
        t = _host_tensor(host)
        nbytes = t.numel() * t.element_size()
        handle = self._charge(category, nbytes)
        try:
            out = t.to(device, non_blocking=t.is_pinned())
        except Exception as e:
            self._release(handle)
            if is_resource_exhausted(e):
                self._count_oom()
                err = DeviceMemoryExhausted(
                    f"device allocator OOM placing {nbytes} bytes "
                    f"(category {category!r}): {e}")
                err.nbytes = nbytes
                raise err from e
            raise
        weakref.finalize(out, self._release, handle)
        return out, handle

    def recharge(self, handle: int, category: str) -> None:
        """Move a live charge to another category.  A handle whose charge
        already released is a no-op."""
        if category not in CATEGORIES:
            category = "other"
        with self._mu:
            entry = self._live.get(handle)
            if entry is None:
                return
            old_cat, nbytes, applied = entry
            if old_cat == category:
                return
            self._live[handle] = (category, nbytes, applied)
            self._live_by_cat[old_cat] -= nbytes
            self._live_by_cat[category] += nbytes

    def place_sharded_slices(self, mesh, slices, category: str = "feed"):
        """Place per-position host slices (one capacity each) for a mesh
        (distributed/mesh.py): an [N, cap] plane on the positions' one
        card, or one tensor per position across cards.  Each position is
        charged its own slice's bytes."""
        out, _handle = self.place_sharded_slices_tracked(mesh, slices,
                                                         category)
        return out

    def place_sharded_slices_tracked(self, mesh, slices,
                                     category: str = "feed"):
        from ..distributed.mesh import (
            _reraise_if_device_loss,
            put_sharded_slices,
        )
        from ..utils.faultinjection import mesh_device_check

        fault_point("executor.hbm_exhausted")
        self._note_mesh(mesh.size)
        host = [_host_tensor(s) for s in slices]
        per_dev = tuple(t.numel() * t.element_size() for t in host)
        handle = self._charge(category, sum(per_dev), per_dev=per_dev)
        try:
            if mesh.single_device():
                fault_point("mesh.device_put")
                for pid in mesh.ids:
                    # per-position seam: a dying position refuses its slice
                    mesh_device_check("mesh.device_put", (pid,))
                plane = torch.stack(host)
                try:
                    out = plane.to(mesh.devices[0])  # graftlint: ignore[mesh-seam] — the one-card form of put_sharded_slices: the mesh.device_put point and the per-position checks run just above
                except Exception as e:
                    _reraise_if_device_loss(e, "mesh.device_put")
                    raise
                weakref.finalize(out, self._release, handle)
            else:
                out = put_sharded_slices(mesh, host)
                for t in out:
                    weakref.finalize(t, self._release, handle)
        except Exception as e:
            self._release(handle)
            if is_resource_exhausted(e):
                self._count_oom()
                err = DeviceMemoryExhausted(
                    f"device allocator OOM placing {max(per_dev)} bytes "
                    f"on the hottest position (category {category!r}): "
                    f"{e}")
                err.nbytes = max(per_dev)
                raise err from e
            raise
        return out, handle

    def _note_mesh(self, n_dev: int) -> None:
        """Learn the mesh width so uniform charges span every position."""
        n = max(1, int(n_dev))
        with self._mu:
            if n > self._n_dev:
                self._n_dev = n
            if n > len(self._live_by_dev):
                self._live_by_dev.extend([0] * (n - len(self._live_by_dev)))

    def resize_mesh(self, n_dev: int) -> None:
        """Re-size the per-position axis after a device-loss failover or
        a drain: hot-position enforcement now spans the surviving width.
        The ledger keeps its old tail, so charges recorded under the
        wider mesh still release exactly what they added."""
        n = max(1, int(n_dev))
        with self._mu:
            self._n_dev = n
            if n > len(self._live_by_dev):
                self._live_by_dev.extend([0] * (n - len(self._live_by_dev)))

    def live_bytes_by_device(self) -> list[int]:
        """Live bytes per mesh position (citus_stat_mesh's view)."""
        with self._mu:
            return list(self._live_by_dev[:self._n_dev])

    def adopt(self, tensor: torch.Tensor, category: str = "feed") -> None:
        """Charge a device tensor the seam did NOT place (the output of
        an on-device decode), released by the tensor's finalizer."""
        handle = self._charge(category,
                              tensor.numel() * tensor.element_size())
        weakref.finalize(tensor, self._release, handle)

    @contextlib.contextmanager
    def lease(self, category: str, nbytes: int):
        """Charge `nbytes` for the duration of the block — the plan
        buffer estimate around each run of a PlanCompiler (its
        intermediates are allocated inside the run, where `place` does
        not see them; the lease makes them visible to the ledger and
        to an armed MemSim)."""
        handle = self._charge(category, max(0, int(nbytes)))
        try:
            yield
        finally:
            self._release(handle)

    def charge(self, category: str, nbytes: int) -> int:
        """Charge `nbytes` until `release(handle)` — a captured graph's
        private pool."""
        return self._charge(category, max(0, int(nbytes)))

    def release(self, handle: int) -> None:
        self._release(handle)

    # -- ledger ------------------------------------------------------------
    def _charge(self, category: str, nbytes: int,
                per_dev: tuple | None = None) -> int:
        if category not in CATEGORIES:
            category = "other"
        with self._mu:
            n = self._n_dev
            applied = (tuple(per_dev) if per_dev is not None
                       else tuple(nbytes // n + (1 if i < nbytes % n else 0)
                                  for i in range(n)))
            if len(applied) > len(self._live_by_dev):
                self._live_by_dev.extend(
                    [0] * (len(applied) - len(self._live_by_dev)))
            sim = self._sim
            if sim is not None:
                sim.allocs += 1
                sim.journal.append((sim.allocs, category, nbytes))
                fail = sim.fail_at is not None and sim.allocs == sim.fail_at
                would = self._live_total + nbytes
                over = sim.budget is not None and would > sim.budget
                if sim.budget is not None and len(applied) > 1:
                    # the card's budget splits evenly among its positions
                    hot = max(self._live_by_dev[d] + b
                              for d, b in enumerate(applied))
                    over = over or hot > sim.budget // len(applied)
                if fail or over:
                    sim.oom_raised += 1
                    self.oom_total += 1
                    why = (f"armed at allocation {sim.fail_at}" if fail
                           else f"budget {sim.budget} bytes, live would "
                                f"reach {would}")
                    err = DeviceMemoryExhausted(
                        f"{_OOM_TOKEN} (MemSim): allocation {sim.allocs} "
                        f"of {nbytes} bytes (category {category!r}) "
                        f"refused — {why}")
                    err.nbytes = nbytes
                    raise err
            self._next_handle += 1
            handle = self._next_handle
            self._live[handle] = (category, nbytes, applied)
            self._live_total += nbytes
            for d, b in enumerate(applied):
                self._live_by_dev[d] += b
            self._live_by_cat[category] += nbytes
            if self._live_by_cat[category] > self._peak_by_cat[category]:
                self._peak_by_cat[category] = self._live_by_cat[category]
            self.charges_total += 1
            if self._live_total > self.peak_bytes:
                self.peak_bytes = self._live_total
            return handle

    def _release(self, handle: int) -> None:
        with self._mu:
            entry = self._live.pop(handle, None)
            if entry is None:
                return
            category, nbytes, applied = entry
            self._live_total -= nbytes
            for d, b in enumerate(applied):
                self._live_by_dev[d] -= b
            self._live_by_cat[category] -= nbytes
            self.releases_total += 1

    def _count_oom(self) -> None:
        with self._mu:
            self.oom_total += 1

    def note_oom(self) -> None:
        """Fold an allocator OOM observed outside place()/lease() (an
        allocation inside a plan's run) into the totals."""
        self._count_oom()

    # -- reads -------------------------------------------------------------
    def live_bytes(self, category: str | None = None) -> int:
        with self._mu:
            return (self._live_total if category is None
                    else self._live_by_cat.get(category, 0))

    def transient_bytes(self) -> int:
        """Live bytes that should return to zero between statements —
        everything but the deliberately resident feed cache and graph
        pools.  The OOM tests assert this is 0 after every statement (no
        leaks)."""
        with self._mu:
            return self._live_total - sum(self._live_by_cat[c]
                                          for c in RESIDENT)

    def pressure_bytes(self) -> int:
        """Live bytes that constrain a new allocation: cache and graph
        bytes are left out because the ladder's first rung reclaims
        them."""
        return self.transient_bytes()

    def budget_bytes(self, device=None, settings=None) -> int:
        """The device byte ceiling the accountant enforces against: an
        armed MemSim budget, else the `hbm_budget_bytes` setting, else
        the CUDA device's total memory.  0 = unknown (a CPU device)."""
        with self._mu:
            if self._sim is not None and self._sim.budget is not None:
                return self._sim.budget
        if settings is not None:
            cfg = settings.get("hbm_budget_bytes")
            if cfg:
                return int(cfg)
        if device is not None and torch.device(device).type == "cuda":
            return int(torch.cuda.get_device_properties(
                torch.device(device)).total_memory)
        return 0

    @staticmethod
    def device_memory_stats(device=None) -> list[dict]:
        """The CUDA allocator's own view of the device (empty on the
        CPU): what the ledger is cross-checked against.  The caching
        allocator's reserve (`bytes_reserved` − `bytes_in_use`) is
        memory the ledger never sees."""
        if device is None or torch.device(device).type != "cuda":
            return []
        dev = torch.device(device)
        free, total = torch.cuda.mem_get_info(dev)
        st = torch.cuda.memory_stats(dev)
        return [{"device": str(dev),
                 "bytes_in_use": int(st.get("allocated_bytes.all.current",
                                            0)),
                 "peak_bytes_in_use": int(st.get(
                     "allocated_bytes.all.peak", 0)),
                 "bytes_reserved": int(st.get("reserved_bytes.all.current",
                                              0)),
                 "bytes_free": int(free), "bytes_limit": int(total)}]

    def snapshot(self) -> dict:
        with self._mu:
            snap = {
                "live_bytes": self._live_total,
                "live_bytes_hot_device": max(
                    self._live_by_dev[:self._n_dev], default=0),
                "peak_bytes": self.peak_bytes,
                "charges_total": self.charges_total,
                "releases_total": self.releases_total,
                "oom_total": self.oom_total,
                "memsim_armed": self._sim is not None,
                "memsim_budget": (self._sim.budget
                                  if self._sim is not None else None),
                "memsim_allocs": (self._sim.allocs
                                  if self._sim is not None else 0),
            }
            for c in CATEGORIES:
                snap[f"live_{c}_bytes"] = self._live_by_cat[c]
                snap[f"peak_{c}_bytes"] = self._peak_by_cat[c]
        return snap

    def reset_peaks(self) -> None:
        """Restart the peak marks at the current live bytes (a caller
        measuring one statement's peak)."""
        with self._mu:
            self.peak_bytes = self._live_total
            self._peak_by_cat = dict(self._live_by_cat)

    # -- eviction registry -------------------------------------------------
    def register_evictable(self, cache) -> None:
        """Register a cache exposing evict_coldest(target_bytes) and
        total_bytes — once per Executor for its FeedCache; weakly held,
        so a closed session's cache pins nothing."""
        with self._mu:
            self._evictables = [r for r in self._evictables
                                if r() is not None]
            self._evictables.append(weakref.ref(cache))

    def evict_evictable(self, target_bytes: int | None = None) -> int:
        """Evict cache-resident tensors across EVERY registered cache,
        coldest first within each, until `target_bytes` have been freed
        (None = everything).  Returns entries evicted.  Runs outside
        the accountant lock: evicting takes each cache's own lock, and
        the dropped tensors' finalizers re-enter _release (lock order:
        cache lock → accountant lock, never the reverse)."""
        with self._mu:
            refs = list(self._evictables)
        evicted = 0
        remaining = target_bytes
        for ref in refs:
            cache = ref()
            if cache is None:
                continue
            before = cache.total_bytes
            evicted += cache.evict_coldest(remaining)
            if remaining is not None:
                remaining -= max(0, before - cache.total_bytes)
                if remaining <= 0:
                    break
        return evicted

    # -- captured graphs ---------------------------------------------------
    def register_graph(self, graph) -> None:
        with self._mu:
            self._graphs.add(graph)

    def release_graphs(self, pred=None) -> int:
        """Release every live captured graph (those `pred` accepts, when
        given) — the ladder's first rung, and a feed cache dropping the
        feeds a graph reads.  Returns graphs released.  Runs outside the
        accountant lock: a release takes the graph's own lock, which a
        replay holds while it fetches."""
        with self._mu:
            doomed = [g for g in self._graphs
                      if g.live and (pred is None or pred(g))]
        for g in doomed:
            g.release()
        return len(doomed)

    def find_graph(self, key, feed_keys):
        """A live graph another session captured for plan-cache `key`
        over feeds of the same feed-cache keys, or None."""
        with self._mu:
            for g in self._graphs:
                if g.key == key and g.valid_for(feed_keys):
                    return g
        return None

    def graph_count(self) -> int:
        with self._mu:
            return sum(1 for g in self._graphs if g.live)

    # -- simulation --------------------------------------------------------
    def install_sim(self, sim: MemSim | None) -> None:
        with self._mu:
            self._sim = sim


# process-wide registry: sessions sharing a data_dir share the device,
# so they share ONE ledger
_registry: dict[str, DeviceMemoryAccountant] = {}
_registry_mu = threading.Lock()


def accountant_for(data_dir: str) -> DeviceMemoryAccountant:
    key = os.path.realpath(data_dir)
    with _registry_mu:
        if key not in _registry:
            _registry[key] = DeviceMemoryAccountant(key)
        return _registry[key]


class oom_budget:
    """``with oom_budget(accountant, budget=..., fail_at=...) as sim:``
    — arm a MemSim for the duration of the block."""

    def __init__(self, accountant: DeviceMemoryAccountant,
                 budget: int | None = None, fail_at: int | None = None):
        self.accountant = accountant
        self.sim = MemSim(budget, fail_at)

    def __enter__(self) -> MemSim:
        self.accountant.install_sim(self.sim)
        return self.sim

    def __exit__(self, *exc) -> bool:
        self.accountant.install_sim(None)
        return False
