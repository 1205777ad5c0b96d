"""Cluster stat counters — citus_stat_counters analogue.

Counterpart of citus_tpu/stats/counters.py, copied whole: the same
counter names (citus_stat_counters lists the JAX package's names) and
the same per-thread slot design.  The reference keeps lock-free
per-backend counter slots in shared memory, aggregated when backends
exit (Citus src/backend/distributed/stats/stat_counters.c).  Here the
slot design maps to threads: each thread increments its private slot
without locking; snapshots sum across slots.  Slots are kept for the
registry's lifetime (sessions are not expected to churn thousands of
threads).

Counters whose modules are not in the port yet (the executable cache,
the mesh) are listed and read 0 until their module comes (ROADMAP queue
A items 7, 9).
"""

from __future__ import annotations

import threading
from collections import defaultdict

# counter names (the reference's are connection/query-execution oriented;
# ours mirror the engine's execution paths)
QUERIES_SINGLE_SHARD = "queries_single_shard"
QUERIES_MULTI_SHARD = "queries_multi_shard"
QUERIES_REPARTITION = "queries_repartition"
QUERIES_FAST_PATH = "queries_fast_path"
POINT_INDEX_LOOKUPS = "point_index_lookups"
SUBPLANS_EXECUTED = "subplans_executed"
ROWS_INGESTED = "rows_ingested"
ROWS_RETURNED = "rows_returned"
DML_UPDATE = "dml_update_count"
DML_DELETE = "dml_delete_count"
DML_MERGE = "dml_merge_count"
DDL_COMMANDS = "ddl_commands"
CAPACITY_RETRIES = "capacity_retries"
DEVICE_ROWS_SCANNED = "device_rows_scanned"
INSERT_SELECT_PUSHDOWN = "insert_select_pushdown"
INSERT_SELECT_REPARTITION = "insert_select_repartition"
INSERT_SELECT_PULL = "insert_select_pull"
CHUNKS_SKIPPED = "chunks_skipped"
QUERIES_STREAMED = "queries_streamed"
# pipelined columnar scan (executor/scanpipe.py): chunk groups decoded
# ahead by the prefetch producer, consumer waits on an empty prefetch
# queue (pipeline underruns), bytes expanded by on-device decode
CHUNKS_PREFETCHED_TOTAL = "chunks_prefetched_total"
PREFETCH_STALLS_TOTAL = "prefetch_stalls_total"
DEVICE_DECODED_BYTES_TOTAL = "device_decoded_bytes_total"
# statements whose plan executed the bucketed dense-grid group-by
# (ops/groupby.py) instead of the sort path
GROUPBY_BUCKETED_TOTAL = "groupby_bucketed_total"
# static all_to_all shuffle buffer volume the executed plans moved over
# the mesh (per-device capacity × devices² × row width, summed over the
# plan's repartition stages and every stream batch) — the EXPLAIN
# ANALYZE Mesh: line and bench_multichip.py read the per-statement
# delta to show what cross-device scaling actually costs
SHUFFLE_BYTES_TOTAL = "shuffle_bytes_total"
# resilient statement execution (session retry loop / deadline seams)
RETRIES_TOTAL = "retries_total"
FAILOVERS_TOTAL = "failovers_total"
TIMEOUTS_TOTAL = "timeouts_total"
QUERIES_CANCELED = "queries_canceled"
FAULTS_INJECTED_TOTAL = "faults_injected_total"
# mesh fault tolerance (session mesh-degrade path): devices observed
# lost, successful shrink-and-failover passes, and statements that
# ultimately ANSWERED because a failover rescued them (the
# kill-to-first-answer numerator bench_multichip's device_loss
# scenario publishes)
DEVICE_LOST_TOTAL = "device_lost_total"
MESH_FAILOVERS_TOTAL = "mesh_failovers_total"
QUERIES_RESCUED_TOTAL = "queries_rescued_total"
# workload manager (wlm/manager.py admission gate)
WLM_ADMITTED_TOTAL = "wlm_admitted_total"
WLM_QUEUED_TOTAL = "wlm_queued_total"
WLM_SHED_TOTAL = "wlm_shed_total"
WLM_QUEUE_WAIT_MS = "wlm_queue_wait_ms"
# serving layer (serving/ — cross-session micro-batcher + CDC-
# invalidated result cache; requester-side folds, the shared-layer
# totals live on the batcher/cache and surface via citus_stat_serving)
SERVING_BATCHED_LOOKUPS_TOTAL = "serving_batched_lookups_total"
SERVING_BATCH_DISPATCH_TOTAL = "serving_batch_dispatch_total"
SERVING_CACHE_HITS_TOTAL = "serving_cache_hits_total"
SERVING_CACHE_MISSES_TOTAL = "serving_cache_misses_total"
SERVING_CACHE_INVALIDATIONS_TOTAL = "serving_cache_invalidations_total"
# persistent executable cache + single-flight compile dedup + warm-
# before-admit (executor/execcache.py): disk adoptions vs cold misses
# vs detected-rot rejects, compiles saved by following another
# session's in-flight compile, and executables pre-adopted by the
# warmup phase before admission opened
EXEC_CACHE_HITS_TOTAL = "exec_cache_hits_total"
EXEC_CACHE_MISSES_TOTAL = "exec_cache_misses_total"
EXEC_CACHE_REJECTS_TOTAL = "exec_cache_rejects_total"
COMPILES_DEDUPED_TOTAL = "compiles_deduped_total"
WARMUP_COMPILES_TOTAL = "warmup_compiles_total"
# device-memory governance (executor/hbm.py accountant + the OOM
# degradation ladder in executor/runner.py degrade_for_oom)
OOM_EVENTS_TOTAL = "oom_events_total"
CACHE_EVICTIONS_TOTAL = "cache_evictions_total"
STREAM_BATCH_SHRINKS_TOTAL = "stream_batch_shrinks_total"
SPILL_PASSES_TOTAL = "spill_passes_total"
# storage integrity (storage/integrity.py read-path accounting folded
# in per statement; scrub counters from operations/scrubber.py)
# replication (replication/ — CDC log shipping leader→followers):
# batches staged by ship() / rolled in by apply_pending(), followers
# promoted to leader, zombie-leader ships rejected by epoch fencing,
# and the follower staleness gate's cumulative observed lag in lsns
# (the wlm_queue_wait_ms idiom: a lag-sum sample per staleness check —
# divide by checks for an average; the live per-follower lag is
# citus_stat_replication's column)
LOG_BATCHES_SHIPPED_TOTAL = "log_batches_shipped_total"
LOG_BATCHES_APPLIED_TOTAL = "log_batches_applied_total"
REPLICAS_PROMOTED_TOTAL = "replicas_promoted_total"
REPLICATION_FENCED_TOTAL = "replication_fenced_total"
REPLICA_LAG_LSN = "replica_lag_lsn"
STRIPES_VERIFIED_TOTAL = "stripes_verified_total"
CORRUPTION_DETECTED_TOTAL = "corruption_detected_total"
READ_REPAIRS_TOTAL = "read_repairs_total"
SCRUB_RUNS_TOTAL = "scrub_runs_total"
SCRUB_REPAIRS_TOTAL = "scrub_repairs_total"
# the port's own (the JAX package has none of them): the result
# hand-off (executor/handoff.py) — rows the card handed back, the
# output slots they were compacted from, and each growth of a session
# thread's host staging
RESULT_ROWS_FETCHED_TOTAL = "result_rows_fetched_total"
RESULT_SLOTS_TOTAL = "result_slots_total"
RESULT_STAGING_GROWS_TOTAL = "result_staging_grows_total"

ALL_COUNTERS = [
    QUERIES_SINGLE_SHARD, QUERIES_MULTI_SHARD, QUERIES_REPARTITION,
    QUERIES_FAST_PATH, POINT_INDEX_LOOKUPS,
    SUBPLANS_EXECUTED, ROWS_INGESTED, ROWS_RETURNED,
    DML_UPDATE, DML_DELETE, DML_MERGE, DDL_COMMANDS,
    CAPACITY_RETRIES, DEVICE_ROWS_SCANNED,
    INSERT_SELECT_PUSHDOWN, INSERT_SELECT_REPARTITION, INSERT_SELECT_PULL,
    CHUNKS_SKIPPED, QUERIES_STREAMED, GROUPBY_BUCKETED_TOTAL,
    SHUFFLE_BYTES_TOTAL,
    CHUNKS_PREFETCHED_TOTAL, PREFETCH_STALLS_TOTAL,
    DEVICE_DECODED_BYTES_TOTAL,
    RETRIES_TOTAL, FAILOVERS_TOTAL, TIMEOUTS_TOTAL, QUERIES_CANCELED,
    FAULTS_INJECTED_TOTAL,
    DEVICE_LOST_TOTAL, MESH_FAILOVERS_TOTAL, QUERIES_RESCUED_TOTAL,
    WLM_ADMITTED_TOTAL, WLM_QUEUED_TOTAL, WLM_SHED_TOTAL,
    WLM_QUEUE_WAIT_MS,
    SERVING_BATCHED_LOOKUPS_TOTAL, SERVING_BATCH_DISPATCH_TOTAL,
    SERVING_CACHE_HITS_TOTAL, SERVING_CACHE_MISSES_TOTAL,
    SERVING_CACHE_INVALIDATIONS_TOTAL,
    EXEC_CACHE_HITS_TOTAL, EXEC_CACHE_MISSES_TOTAL,
    EXEC_CACHE_REJECTS_TOTAL, COMPILES_DEDUPED_TOTAL,
    WARMUP_COMPILES_TOTAL,
    OOM_EVENTS_TOTAL, CACHE_EVICTIONS_TOTAL,
    STREAM_BATCH_SHRINKS_TOTAL, SPILL_PASSES_TOTAL,
    LOG_BATCHES_SHIPPED_TOTAL, LOG_BATCHES_APPLIED_TOTAL,
    REPLICAS_PROMOTED_TOTAL, REPLICATION_FENCED_TOTAL, REPLICA_LAG_LSN,
    STRIPES_VERIFIED_TOTAL, CORRUPTION_DETECTED_TOTAL,
    READ_REPAIRS_TOTAL, SCRUB_RUNS_TOTAL, SCRUB_REPAIRS_TOTAL,
]
# snapshots carry these too; citus_stat_counters lists ALL_COUNTERS, the
# JAX package's names
PORT_COUNTERS = [
    RESULT_ROWS_FETCHED_TOTAL, RESULT_SLOTS_TOTAL,
    RESULT_STAGING_GROWS_TOTAL,
]


class StatCounters:
    def __init__(self):
        self._local = threading.local()
        self._slots_lock = threading.Lock()
        self._slots: list[defaultdict] = []

    def _slot(self) -> defaultdict:
        slot = getattr(self._local, "slot", None)
        if slot is None:
            slot = defaultdict(int)
            self._local.slot = slot
            with self._slots_lock:
                self._slots.append(slot)
        return slot

    def increment(self, name: str, by: int = 1) -> None:
        self._slot()[name] += by

    def snapshot(self) -> dict[str, int]:
        with self._slots_lock:
            slots = list(self._slots)
        out: dict[str, int] = {}
        for slot in slots:
            for k, v in slot.items():
                out[k] = out.get(k, 0) + v
        return {k: out.get(k, 0) for k in ALL_COUNTERS + PORT_COUNTERS}

    def reset(self) -> None:
        with self._slots_lock:
            for slot in self._slots:
                slot.clear()
