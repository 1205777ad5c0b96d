"""Workload management: admission control, per-tenant fair queueing and
overload shedding (the citus.max_shared_pool_size governor analogue —
see manager.py for the design).  Counterpart of citus_tpu/wlm/."""

from .admission import (
    fastpath_exempt_shape,
    planned_feed_bytes,
    planned_intermediate_bytes,
    read_tables,
    statement_exempt,
    statement_tables,
    statement_tenant,
)
from .manager import (
    PRIORITIES,
    AdmissionRequest,
    Ticket,
    WorkloadManager,
    parse_tenant_weights,
    workload_manager_for,
)

__all__ = [
    "PRIORITIES", "AdmissionRequest", "Ticket", "WorkloadManager",
    "fastpath_exempt_shape", "parse_tenant_weights", "planned_feed_bytes",
    "planned_intermediate_bytes", "read_tables", "statement_exempt",
    "statement_tables", "statement_tenant", "workload_manager_for",
]
