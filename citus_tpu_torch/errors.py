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
    """Columnar storage format or IO error."""


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
    seam (a fault point or a COPY batch boundary)."""


class PlacementLostError(CatalogError):
    """A shard has placements, but none on a live node: every copy sits
    on nodes that are disabled or marked dead."""


class ExecutionError(CitusTpuError):
    """Runtime failure during distributed execution."""


class ResourceExhausted(ExecutionError):
    """Device memory could not be made to fit: the clean, client-facing
    error (the reference fails such a query with 53200 out_of_memory)."""


class DeviceMemoryExhausted(ResourceExhausted):
    """A device allocation failed (torch.cuda.OutOfMemoryError, or the
    accountant's armed MemSim budget).  Raised at the device-placement
    seam (executor/hbm.py).  The pipelined scan sheds to the eager path
    on it; elsewhere it surfaces as a clean ResourceExhausted."""


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
