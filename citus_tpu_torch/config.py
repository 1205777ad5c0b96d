"""Configuration variable registry (the GUC analogue).

The reference registers 145 `citus.*` GUCs in one place
(Citus src/backend/distributed/shared_library_init.c:982,
RegisterCitusConfigVariables) with typed definitions, defaults, ranges, and
docstrings.  This module mirrors that shape: a central typed registry, a
session-scoped settings object, and `set`/`get`/`show_all` with validation.

This copy registers only the variables the port reads; each keeps the
JAX package's name, default and range, so a setting means the same in
both packages.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable

from .errors import ConfigError


@dataclass(frozen=True)
class ConfigVar:
    name: str
    default: Any
    doc: str
    vartype: type = int
    min_value: Any = None
    max_value: Any = None
    choices: tuple | None = None
    validate: Callable[[Any], None] | None = None


_REGISTRY: dict[str, ConfigVar] = {}


def _register(var: ConfigVar) -> None:
    if var.name in _REGISTRY:
        raise ConfigError(f"duplicate config var {var.name}")
    _REGISTRY[var.name] = var


def registered_vars() -> dict[str, ConfigVar]:
    return dict(_REGISTRY)


_register(ConfigVar(
    "shard_count", 8,
    "Number of hash shards for new distributed tables "
    "(ref: citus.shard_count, shared_library_init.c:2616).",
    int, min_value=1, max_value=64000))
_register(ConfigVar(
    "shard_replication_factor", 1,
    "Placements per shard on distinct nodes; reads fail over to the next "
    "replica when a node is disabled/removed "
    "(ref: citus.shard_replication_factor, shared_library_init.c).",
    int, min_value=1, max_value=64))
_register(ConfigVar(
    "mesh_failover", True,
    "Query-level failover on device loss: when a mesh position dies, "
    "hangs or errors mid-statement (DeviceLostError), rebuild the mesh "
    "from the survivors, mark the lost position's nodes dead in the "
    "catalog health ledger, re-route shard reads onto surviving replica "
    "placements (shard_replication_factor >= 2) and re-execute the "
    "statement.  Off = a DeviceLostError surfaces immediately.",
    bool))
_register(ConfigVar(
    "repartition_capacity_factor", 1.5,
    "Static all_to_all buffer headroom over expected rows per partition "
    "on a mesh.  Overflow triggers a retry with doubled capacity.",
    float, min_value=1.0, max_value=64.0))
_register(ConfigVar(
    "enable_repartition_joins", True,
    "Allow dual/single repartition (all_to_all) joins "
    "(ref: citus.enable_repartition_joins, shared_library_init.c:1609).",
    bool))
_register(ConfigVar(
    "compute_dtype", "float32",
    "Device accumulation dtype for SQL double precision: float32 (the "
    "GPU default) or float64 (exact; the CPU parity tests).",
    str, choices=("float32", "float64")))
_register(ConfigVar(
    "join_output_capacity_factor", 1.0,
    "Static join-output headroom over probe-side capacity.",
    float, min_value=0.1, max_value=64.0))
_register(ConfigVar(
    "agg_group_capacity_factor", 1.5,
    "Static aggregate-output headroom over the estimated group count.",
    float, min_value=1.0, max_value=64.0))
_register(ConfigVar(
    "join_probe_bucket_factor", 2.0,
    "Per-bucket probe-slot headroom over the uniform-hash expectation "
    "for bucketed fused lookups (ops.join.bucketed_unique_lookup). "
    "Skewed buckets overflow and regrow through the normal retry path; "
    "capacity feedback tightens converged sizes.",
    float, min_value=1.0, max_value=64.0))
_register(ConfigVar(
    "agg_bucket_capacity_factor", 2.0,
    "Per-bucket row-slot headroom over the uniform expectation for "
    "bucketed dense-grid aggregation (ops/groupby.py). Hot buckets "
    "overflow and regrow through the normal retry path; capacity "
    "feedback tightens converged sizes.",
    float, min_value=1.0, max_value=64.0))
_register(ConfigVar(
    "enable_capacity_feedback", True,
    "After a clean execution, shrink buffers whose recorded actual row "
    "counts sit far below the planner's estimate and recompile once "
    "(the adaptive-executor actual-size feedback, adaptive_executor.c:962"
    ", done the static-shape way).",
    bool))
_register(ConfigVar(
    "enable_fast_path_router", True,
    "Execute single-shard pruned queries host-side, below "
    "fast_path_max_rows, skipping the device path entirely (ref: "
    "citus.enable_fast_path_router_planner, "
    "planner/fast_path_router_planner.c:530).",
    bool))
_register(ConfigVar(
    "enable_point_lookup_index", True,
    "Answer WHERE distcol = const through the persistent per-shard "
    "point-lookup index (storage/pkindex.py; ref: columnar btree/hash "
    "index support, columnar/README.md:176).",
    bool))
_register(ConfigVar(
    "fast_path_max_rows", 65536,
    "Row ceiling for host-side fast-path execution; bigger single-shard "
    "scans still use the device path.",
    int, min_value=0, max_value=1 << 24))
_register(ConfigVar(
    "exec_cache_enabled", True,
    "Persistent compiled-plan cache + single-flight capture dedup "
    "(executor/execcache.py): each converged plan key lands as a "
    "checksummed JSON entry (the plan-cache key, its converged "
    "capacities, unpack metadata) in <data_dir>/exec_cache/ through "
    "the durable-io seam, a fresh process resolves a plan-cache miss "
    "from it and captures its CUDA graph at once, and N sessions "
    "racing a cold key produce ONE capture (followers wait under "
    "their own statement_timeout_ms/cancel budget).  Corrupt/torn/"
    "version-skewed entries are detected (CRC + environment stamp) "
    "and resolve cleanly as a reject.  No reference GUC — the "
    "analogue is an inference server's model-artifact store "
    "(PystachIO, PAPERS.md).",
    bool))
_register(ConfigVar(
    "warmup_budget_ms", 0,
    "Warm-before-admit budget: a fresh session loads the kernels, "
    "makes the CUDA context and arms the persisted cache's hottest "
    "shapes (warmup_top_shapes) while the workload manager holds "
    "non-exempt admissions, for at most this long — then the hold "
    "auto-expires and the remainder resolves lazily (graceful "
    "degradation, never an indefinite block).  0 disables the hold "
    "(entries still resolve lazily on demand).  No reference GUC — "
    "the analogue is a serving replica reporting ready only after "
    "model load.",
    int, min_value=0, max_value=600_000))
_register(ConfigVar(
    "warmup_top_shapes", 8,
    "How many of the persisted cache's hottest entries (by hit "
    "count, then recency) the warm-before-admit phase arms (see "
    "warmup_budget_ms).",
    int, min_value=1, max_value=4096))
_register(ConfigVar(
    "max_cached_plans", 256,
    "Plan-cache entries; a structurally repeated query reuses its "
    "PlanCompiler (ref: planner/local_plan_cache.c:1-60).",
    int, min_value=0, max_value=100_000))
_register(ConfigVar(
    "max_cached_feed_bytes", 4 << 30,
    "Device byte budget for resident table feeds reused across "
    "queries (ref: connection/pool reuse, executor/adaptive_executor.c:962).",
    int, min_value=0, max_value=1 << 40))
_register(ConfigVar(
    "max_plan_buffer_bytes", 32 << 30,
    "Ceiling on a plan's largest static device buffer. Plans over it "
    "whose shape the OOM degradation ladder can help (streamable / "
    "multi-pass-splittable) degrade instead of erroring; genuinely "
    "ineligible shapes (windows, cartesian blowups) keep the clean "
    "immediate reject. 0 disables the guard.",
    int, min_value=0, max_value=1 << 44))
_register(ConfigVar(
    "max_feed_bytes_per_device", 6 << 30,
    "Per-device feed-byte ceiling before the executor streams the largest "
    "scan in stripe batches (executor/stream.py; the reference's "
    "per-stripe reader, columnar/columnar_reader.c:323). 0 disables "
    "streaming.",
    int, min_value=0, max_value=1 << 40))
_register(ConfigVar(
    "stream_batch_rows", 0,
    "Fixed per-device rows per stream batch (0 = size from the "
    "max_feed_bytes_per_device budget). Test/tuning knob.",
    int, min_value=0, max_value=1 << 30))
_register(ConfigVar(
    "scan_prefetch_depth", 2,
    "Bounded depth of the stream path's batch prefetch queue (batches "
    "in flight between the producer thread and the executing "
    "statement); the per-batch budget divides by depth + 5, so a "
    "deeper queue means smaller batches, never more resident bytes.",
    int, min_value=1, max_value=64))

# --- device-memory governance (executor/hbm.py accountant + the OOM
# degradation ladder) -------------------------------------------------------
_register(ConfigVar(
    "hbm_budget_bytes", 0,
    "Explicit device byte budget the accountant enforces the "
    "capacity-regrow guard against and sizes streams by "
    "(executor/hbm.py). 0 = an armed MemSim budget, else the card's "
    "total memory. No direct reference GUC — the analogue is the "
    "work_mem family bounding per-node memory.",
    int, min_value=0, max_value=1 << 44))
_register(ConfigVar(
    "oom_degradation", True,
    "Route DeviceMemoryExhausted (a CUDA allocator OOM or a simulated "
    "one) through the degradation ladder — evict caches, shrink stream "
    "batches, force streaming, multi-pass execution — retrying after "
    "each rung (executor.Executor.degrade_for_oom). Off surfaces the "
    "first OOM as a clean ResourceExhausted immediately.",
    bool))
_register(ConfigVar(
    "oom_max_spill_passes", 16,
    "Ceiling on multi-pass execution's pass count "
    "(executor/multipass.py); the ladder surfaces a clean "
    "ResourceExhausted rather than splitting further.",
    int, min_value=2, max_value=4096))

# --- resilience -----------------------------------------------------------
_register(ConfigVar(
    "max_statement_retries", 2,
    "Bounded per-statement retry loop for transient failures (injected "
    "faults, storage IO): classify, mark the failing placement suspect, "
    "run 2PC recovery, back off, re-execute (the adaptive executor's "
    "task retry onto replica placements, adaptive_executor.c:95-116). "
    "0 disables.",
    int, min_value=0, max_value=32))
_register(ConfigVar(
    "retry_backoff_base_ms", 5.0,
    "First retry backoff; doubles per attempt with ±50% jitter.",
    float, min_value=0.0, max_value=60_000.0))
_register(ConfigVar(
    "retry_backoff_max_ms", 200.0,
    "Backoff ceiling for the statement retry loop.",
    float, min_value=0.0, max_value=600_000.0))
_register(ConfigVar(
    "statement_timeout_ms", 0,
    "Cooperative per-statement deadline, checked at fault points, "
    "stream/COPY batch boundaries, multi-pass passes and retry "
    "iterations. Raises StatementTimeout (PostgreSQL statement_timeout "
    "analogue). 0 disables.",
    int, min_value=0, max_value=86_400_000))
_register(ConfigVar(
    "scan_pipeline", "auto",
    "Columnar scan feed pipeline (executor/scanpipe.py): 'off' = the "
    "eager read-everything-then-transfer path; 'host' = prefetch + "
    "native-codec decode on a producer thread overlapped with device "
    "placement, column by column; 'device' = host pipeline plus "
    "on-device decode — frame-of-reference packed ints, dictionary-"
    "coded low-NDV columns and bit-packed validity planes cross the "
    "wire and expand on the GPU (the bit_unpack / dict_decode CUDA "
    "kernels). 'auto' picks device on a CUDA session and host on a CPU "
    "one, engaging only above a small row floor. No reference GUC — "
    "the analogue is the columnar reader's chunk streaming, "
    "columnar_reader.c:323.",
    str, choices=("auto", "off", "host", "device")))
_register(ConfigVar(
    "columnar_stripe_row_limit", 150_000,
    "Rows per stripe (ref default 150000, columnar/README.md:96-112).",
    int, min_value=1_000, max_value=10_000_000))
_register(ConfigVar(
    "columnar_chunk_group_row_limit", 10_000,
    "Rows per chunk group (ref default 10000).",
    int, min_value=128, max_value=1_000_000))
_register(ConfigVar(
    "columnar_compression", "zstd",
    "Per-chunk compression codec (ref: none/pglz/lz4/zstd; here "
    "none/zlib/zstd).", str, choices=("none", "zlib", "zstd")))
_register(ConfigVar(
    "columnar_compression_level", 3,
    "Codec level (ref: columnar.compression_level).",
    int, min_value=1, max_value=19))
_register(ConfigVar(
    "storage_verify_checksums", True,
    "Verify stripe chunk/footer CRC32s on every read; a mismatch raises "
    "CorruptStripe (ref: PostgreSQL data_checksums).",
    bool))

# --- tracing (stats/tracing.py span flight recorder; the JAX package's
# knobs and defaults) -------------------------------------------------------
_register(ConfigVar(
    "trace_enabled", True,
    "Always-on span flight recorder: every statement records a span "
    "tree (parse/plan/feed/device/combine/retry phases, carried across "
    "producer threads; CUDA-event device legs on a cuda session), folds "
    "its wall time into per-statement-class DDSketch latency histograms "
    "(citus_stat_latency()), and keeps recent traces in a bounded ring.  "
    "Off disables all recording.",
    bool))
_register(ConfigVar(
    "trace_ring_statements", 128,
    "Completed statement traces kept in the in-memory ring (oldest "
    "dropped; spans per trace are capped too).",
    int, min_value=1, max_value=100_000))
_register(ConfigVar(
    "trace_slow_statement_ms", 5000,
    "Statements slower than this persist their span tree as JSON under "
    "<data_dir>/slow_traces/ (newest 32 kept; python -m "
    "citus_tpu_torch.stats.trace_export renders one for "
    "chrome://tracing).  0 disables the slow-query log.",
    int, min_value=0, max_value=86_400_000))
_register(ConfigVar(
    "trace_sample_every", 1,
    "Record a full span tree for 1 in N statements (histograms always "
    "update).  1 = every statement.",
    int, min_value=1, max_value=1_000_000))
_register(ConfigVar(
    "trace_fast_statement_ms", 5.0,
    "Auto-degrade threshold: statement classes whose observed mean wall "
    "(≥8 calls) is below this record span trees only 1 in "
    "trace_fast_sample_every statements.  Cold and slower classes and "
    "every histogram update stay always-on.  0 disables the degrade.",
    float, min_value=0.0, max_value=60_000.0))
_register(ConfigVar(
    "trace_fast_sample_every", 16,
    "Tree-recording sample rate for sub-threshold statement classes "
    "(see trace_fast_statement_ms).",
    int, min_value=1, max_value=1_000_000))


# --- workload management (wlm/ — the shared-pool governor analogue; the
# JAX package's knobs and defaults) ------------------------------------------
def _validate_tenant_weights(value: str) -> None:
    from .wlm.manager import parse_tenant_weights

    parse_tenant_weights(value)  # raises ConfigError on malformed spec


_register(ConfigVar(
    "wlm_enabled", True,
    "Route every non-exempt statement through the workload manager's "
    "admission gate (slots + HBM budget + per-tenant fair queue, "
    "wlm/manager.py).  Off restores the ungoverned race into the "
    "executor (ref: the citus.max_shared_pool_size governor as a "
    "whole, shared_library_init.c).",
    bool))
_register(ConfigVar(
    "max_concurrent_statements", 8,
    "Admission slots: statements executing concurrently across every "
    "session sharing this data_dir; the rest queue per tenant and "
    "priority class (ref: citus.max_shared_pool_size / "
    "citus.max_adaptive_executor_pool_size).",
    int, min_value=1, max_value=1024))
_register(ConfigVar(
    "wlm_queue_depth", 64,
    "Bounded admission queue per priority class; arrivals beyond it "
    "shed with a clean AdmissionRejected instead of queueing without "
    "bound (0 sheds whenever the gate is saturated).",
    int, min_value=0, max_value=1_000_000))
_register(ConfigVar(
    "wlm_default_priority", "interactive",
    "Priority class this session's statements enqueue at.  Classes "
    "dispatch strictly interactive > batch > background.",
    str, choices=("interactive", "batch", "background")))
_register(ConfigVar(
    "wlm_tenant", "",
    "Explicit tenant identity for fair queueing.  Empty derives the "
    "tenant from the statement's distcol = const pin (the "
    "citus_stat_tenants attribution, stats/tenants.py), falling back "
    "to 'default'.",
    str))
_register(ConfigVar(
    "wlm_tenant_weights", "",
    "Weighted round-robin shares per tenant within a priority class, "
    "as 'tenantA:3,tenantB:1' (unlisted tenants weigh 1).",
    str, validate=_validate_tenant_weights))

# --- serving layer (serving/: the cross-session micro-batcher and the
# CDC-invalidated result cache) ---------------------------------------------
_register(ConfigVar(
    "serving_enabled", True,
    "Route fast-path point-index lookups through the per-data_dir "
    "cross-session micro-batcher (serving/batcher.py): concurrent "
    "lookups coalesce into one batched stripe/chunk probe, single-"
    "flight when alone.  Also gates the result cache "
    "(serving_result_cache_bytes).  Off restores the solo path.",
    bool))
_register(ConfigVar(
    "serving_max_batch", 64,
    "Ceiling on point lookups coalesced into ONE batched index probe "
    "per dispatch; arrivals beyond it form the next batch.",
    int, min_value=1, max_value=4096))
_register(ConfigVar(
    "serving_batch_window_ms", 2.0,
    "How long a batch leader that found company holds the door open "
    "for the burst's tail before dispatching.  0 dispatches whatever "
    "is queued immediately; a lone request never waits.",
    float, min_value=0.0, max_value=1000.0))
_register(ConfigVar(
    "serving_result_cache_bytes", 256 << 20,
    "Byte budget for the shared per-data_dir result cache of repeated "
    "read statements (serving/result_cache.py).  Entries drop when the "
    "change journal shows a write to a table they read (never on a "
    "TTL), with a manifest-identity backstop.  A hit launches no "
    "kernel.  0 disables (what a benchmark of warm re-runs sets).",
    int, min_value=0, max_value=1 << 40))

# --- replication (replication/) --------------------------------------------
_register(ConfigVar(
    "replica_max_staleness_lsn", -1,
    "Follower read gate: the max lsns a replica may lag its leader and "
    "still answer.  Beyond it a statement fails with a clean "
    "ReplicaTooStale.  -1 = unbounded (lag is still reported by "
    "citus_stat_replication).",
    int, min_value=-1, max_value=1_000_000_000))
_register(ConfigVar(
    "replication_ship_interval_ms", 0,
    "Leader maintenance-daemon duty: ship a replication batch to every "
    "registered follower each interval.  0 = off (explicit "
    "citus_replication_ship() only).",
    int, min_value=0, max_value=86_400_000))

# --- shard operations and background jobs (operations/, background/;
# the JAX package's names and defaults) -------------------------------------
_register(ConfigVar(
    "recover_2pc_interval_ms", 60_000,
    "How often the maintenance daemon retries unresolved prepared "
    "commits (ref: citus.recover_2pc_interval); -1 disables.",
    int, min_value=-1, max_value=7_200_000))
_register(ConfigVar(
    "defer_shard_delete_interval_ms", 15_000,
    "Maintenance-daemon deferred cleanup sweep interval (ref: "
    "citus.defer_shard_delete_interval); -1 disables.",
    int, min_value=-1, max_value=86_400_000))
_register(ConfigVar(
    "health_check_interval_ms", -1,
    "Maintenance-daemon node health sweep: probe every node and disable "
    "failures so reads fail over to replicas; -1 disables.",
    int, min_value=-1, max_value=86_400_000))
_register(ConfigVar(
    "scrub_interval_ms", -1,
    "Maintenance-daemon storage scrub (operations/scrubber.py): verify "
    "every placement copy, quarantine and re-replicate corrupt ones; "
    "-1 disables (on demand: citus_check_cluster()).",
    int, min_value=-1, max_value=86_400_000))
_register(ConfigVar(
    "scrub_temp_max_age_s", 300.0,
    "Age floor before the scrubber removes orphan temp files left by "
    "crashes (younger ones may belong to an in-flight writer).",
    float, min_value=0.0, max_value=86_400.0))
_register(ConfigVar(
    "max_background_task_executors", 4,
    "Parallel background tasks (ref: "
    "citus.max_background_task_executors).",
    int, min_value=1, max_value=1000))
_register(ConfigVar(
    "rebalance_threshold", 0.1,
    "Utilization imbalance tolerated before a move is planned (ref "
    "default 10%).",
    float, min_value=0.0, max_value=1.0))
_register(ConfigVar(
    "rebalance_improvement_threshold", 0.5,
    "Minimum relative improvement for a move to be worth it (ref 50%).",
    float, min_value=0.0, max_value=1.0))


class Settings:
    """Session-scoped mutable settings over the global registry."""

    def __init__(self, overrides: dict[str, Any] | None = None):
        self._values: dict[str, Any] = {}
        # bumped on every mutation; consumers (the serving result
        # cache's key memo) cache derived fingerprints per version
        self.version = 0
        self._profile: tuple | None = None
        for name, value in (overrides or {}).items():
            self.set(name, value)

    def get(self, name: str) -> Any:
        if name in self._values:
            return self._values[name]
        var = _REGISTRY.get(name)
        if var is None:
            raise ConfigError(f"unrecognized configuration parameter {name!r}")
        return var.default

    def set(self, name: str, value: Any) -> None:
        var = _REGISTRY.get(name)
        if var is None:
            raise ConfigError(f"unrecognized configuration parameter {name!r}")
        if var.vartype is bool:
            if isinstance(value, str):
                lowered = value.strip().lower()
                if lowered in ("on", "true", "1", "yes"):
                    value = True
                elif lowered in ("off", "false", "0", "no"):
                    value = False
                else:
                    raise ConfigError(
                        f"{name}: invalid boolean value {value!r}")
            value = bool(value)
        elif var.vartype is int:
            value = int(value)
        elif var.vartype is float:
            value = float(value)
        elif var.vartype is str:
            value = str(value)
        if var.min_value is not None and value < var.min_value:
            raise ConfigError(f"{name}: {value} below minimum {var.min_value}")
        if var.max_value is not None and value > var.max_value:
            raise ConfigError(f"{name}: {value} above maximum {var.max_value}")
        if var.choices is not None and value not in var.choices:
            raise ConfigError(f"{name}: invalid value {value!r}; choose from {var.choices}")
        if var.validate is not None:
            var.validate(value)
        self._values[name] = value
        self.version += 1
        self._profile = None

    def reset(self, name: str) -> None:
        self._values.pop(name, None)
        self.version += 1
        self._profile = None

    def show_all(self) -> dict[str, Any]:
        return {name: self.get(name) for name in sorted(_REGISTRY)}

    def profile(self) -> tuple:
        """The full settings profile as a sorted, hashable tuple —
        cached per version so hot paths (the serving result-cache key
        covers every knob) don't re-enumerate the registry per call.

        The memo is stamped with the version read BEFORE enumerating:
        a SET racing a concurrent statement can install a stale tuple,
        but the stamp no longer matches and the next call recomputes —
        a plain `None` sentinel would let the stale tuple (and the
        result-cache keys built from it) persist until the next SET."""
        p = self._profile
        if p is None or p[0] != self.version:
            v = self.version
            p = (v, tuple(sorted(self.show_all().items())))
            self._profile = p
        return p[1]

    @contextlib.contextmanager
    def override(self, **kwargs):
        saved = dict(self._values)
        try:
            for k, v in kwargs.items():
                self.set(k, v)
            yield self
        finally:
            self._values = saved
            self.version += 1
            self._profile = None
