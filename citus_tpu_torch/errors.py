"""Error hierarchy of the port (a pruned copy of citus_tpu/errors.py:
the classes the first slice raises, under the same names).

The reference (Citus) reports errors through PostgreSQL's ereport() with
dedicated error codes; the closest structural analogues here are a small
exception hierarchy.  Reference behavior surveyed from
Citus src/backend/distributed/planner/multi_router_planner.c
(deferred error machinery) and shared_library_init.c (GUC validation).
"""

from __future__ import annotations


class CitusTpuError(Exception):
    """Base class for all framework errors."""


class ConfigError(CitusTpuError):
    """Invalid configuration variable or value (GUC analogue)."""


class CatalogError(CitusTpuError):
    """Metadata/catalog inconsistency (pg_dist_* analogue)."""


class StorageError(CitusTpuError):
    """Columnar storage format or IO error.

    When raised from a shard read, carries `table`/`shard_id` attributes
    so the statement retry loop can mark the failing placement suspect
    and route the retry onto a surviving replica (the adaptive-executor
    placement failover, adaptive_executor.c:95-116)."""


class CorruptStripe(StorageError):
    """On-disk integrity violation: a stripe/manifest checksum mismatch,
    torn tail, or structural damage detected by the end-to-end CRC path
    (storage/format.py v2 footers, storage/integrity.py).

    Wrong bytes are never returned as data (the data_checksums +
    ereport(ERROR) analogue)."""


class ParseError(CitusTpuError):
    """SQL syntax error."""

    def __init__(self, message: str, line: int = 0, column: int = 0):
        self.line = line
        self.column = column
        if line:
            message = f"{message} (line {line}, column {column})"
        super().__init__(message)


class PlanningError(CitusTpuError):
    """Query cannot be planned distributedly.

    Mirrors Citus's "deferred error" pattern: the planner cascade records why
    each strategy failed and reports the most specific reason
    (multi_router_planner.c DeferredErrorMessage).
    """


class UnsupportedQueryError(PlanningError):
    """Query shape recognized but not supported by any planner stage."""


class QueryCanceled(CitusTpuError):
    """Statement canceled cooperatively (the pg_cancel_backend analogue):
    Session.cancel() sets a flag the executing thread notices at the next
    seam — fault point, stream/COPY batch boundary, retry iteration."""


class StatementTimeout(QueryCanceled):
    """`statement_timeout_ms` deadline passed (PostgreSQL
    statement_timeout analogue): the whole statement carries one
    cooperative deadline."""


class PlacementLostError(CatalogError):
    """A shard has placements, but none on a live node: every copy sits
    on nodes that are disabled or marked dead."""


class ExecutionError(CitusTpuError):
    """Runtime failure during distributed execution."""


class DeviceLostError(ExecutionError):
    """A mesh position's device died, hung past its deadline, or errored
    mid-statement (the reference's "connection to worker lost").

    Raised at the mesh seams (``mesh.device_put`` per-position transfer,
    ``mesh.collective`` exchange, ``mesh.fetch`` result pull) by the
    armed MeshSim (utils/faultinjection.py) or by wrapping a CUDA error
    that matches the device-loss signature (distributed/mesh.py
    is_device_loss).  The session's retry envelope marks the position
    suspect, rebuilds the mesh from the survivors, re-plans through the
    node↔device map (replicated placements fail over) and re-runs.
    ``device_id`` is the lost position's id when known (None for an
    opaque collective failure: the session then probes every position);
    ``seam`` names where it died."""

    def __init__(self, message: str, device_id: int | None = None,
                 seam: str | None = None):
        self.device_id = device_id
        self.seam = seam
        super().__init__(message)


class MeshDegradedError(DeviceLostError):
    """Device loss that cannot be failed over: no surviving position, a
    shard whose only placement sits on a lost position, or the failover
    budget is spent — the clean, client-facing terminal error."""


class StaleMeshPlan(ExecutionError):
    """A plan built for a mesh width the executor no longer has (a
    failover, drain or shrink narrowed it between planning and
    execution).  No device was lost: the session's retry envelope
    re-plans at the current width without counting a device loss."""


class ResourceExhausted(ExecutionError):
    """Device memory could not be made to fit even after the OOM
    degradation ladder (cache eviction → stream-batch shrink → forced
    streaming → multi-pass execution) ran out of rungs: the clean,
    client-facing error (the reference fails such a query with 53200
    out_of_memory)."""


class DeviceMemoryExhausted(ResourceExhausted):
    """A device allocation failed (torch.OutOfMemoryError, or the
    accountant's armed MemSim budget or an `error="oom"` fault).  Raised
    at the placement seam and around a plan's run (executor/hbm.py,
    executor/runner.py).  The pipelined scan sheds to the eager path on
    it; the session's retry envelope applies the next rung of the
    degradation ladder (Executor.degrade_for_oom) and re-runs."""


class CapacityOverflowError(ExecutionError):
    """A static-capacity device buffer overflowed (join/shuffle output).

    The executor retries with grown capacities and raises this only when
    the overflow persists.
    """

    def __init__(self, message: str, required: int = 0, capacity: int = 0):
        self.required = required
        self.capacity = capacity
        super().__init__(message)


class IngestError(CitusTpuError):
    """COPY/bulk-load failure."""


class AdmissionRejected(CitusTpuError):
    """The workload manager shed this statement instead of queueing it
    without bound: the admission queue for its priority class was full
    (wlm_queue_depth).  A clean, client-retryable error, never a
    half-executed statement."""


class ReplicationError(CitusTpuError):
    """Log-shipping state violation (replication/): a fenced leader
    shipping from a superseded epoch, a broken batch spool order, or a
    role mismatch (promoting a leader, shipping from a follower)."""


class ReadOnlyReplica(ReplicationError):
    """A write reached a follower data_dir; every mutation belongs on
    the leader.  Nothing was executed."""


class ReplicaTooStale(ReplicationError):
    """The follower's applied lsn lags its leader beyond
    `replica_max_staleness_lsn`: it refuses instead of serving old
    rows as if they were current."""
