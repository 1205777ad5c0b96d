"""Observability: counters, per-query stats, tenant stats, progress,
activity and the span flight recorder — counterpart of
citus_tpu/stats/ (the reference's stats/ + progress/ subsystems)."""

from .activity import ActivityRegistry
from .counters import ALL_COUNTERS, StatCounters
from .progress import ProgressMonitor, ProgressRegistry
from .query_stats import QueryStats, fingerprint
from .tenants import TenantStats, extract_tenants
from .tracing import TraceRecorder


class SessionStats:
    """Bundle owned by each Session as `sess.stats`.

    `data_dir`/`settings` feed the trace recorder (slow-query log
    destination + the trace_* knobs); both default to None for
    unit-test construction (tracing then runs in-memory with
    defaults)."""

    def __init__(self, data_dir: str | None = None, settings=None):
        self.counters = StatCounters()
        self.queries = QueryStats()
        self.tenants = TenantStats()
        self.progress = ProgressRegistry()
        self.activity = ActivityRegistry()
        self.tracing = TraceRecorder(data_dir, settings)


__all__ = [
    "ALL_COUNTERS", "ActivityRegistry", "ProgressMonitor",
    "ProgressRegistry", "QueryStats", "SessionStats", "StatCounters",
    "TenantStats", "TraceRecorder", "extract_tenants", "fingerprint",
]
