"""citus_tpu_torch — the PyTorch/CUDA port of citus_tpu.

The JAX package `citus_tpu` stays the reference; this package runs the
same system — SQL over hash-distributed columnar tables — on one NVIDIA
H100 through PyTorch, with the TPU's Pallas kernels rewritten by hand
for Hopper (ops/hopper_kernels.py, csrc/).  It imports torch, numpy and
the standard library only: what it needs from the JAX package it keeps
as its own copy.  Both packages read and write the same data_dir format.
"""

from .config import Settings, registered_vars
from .errors import (
    AdmissionRejected,
    CapacityOverflowError,
    CatalogError,
    CitusTpuError,
    ConfigError,
    ExecutionError,
    IngestError,
    ParseError,
    PlanningError,
    QueryCanceled,
    ReadOnlyReplica,
    ReplicaTooStale,
    ReplicationError,
    StatementTimeout,
    UnsupportedQueryError,
)
from .types import ColumnDef, DataType, TableSchema

__all__ = [
    "connect", "Settings", "registered_vars", "ColumnDef", "DataType",
    "TableSchema", "CitusTpuError", "ConfigError", "CatalogError",
    "ParseError", "PlanningError", "UnsupportedQueryError",
    "ExecutionError", "CapacityOverflowError", "IngestError",
    "QueryCanceled", "StatementTimeout", "AdmissionRejected",
    "ReplicationError", "ReadOnlyReplica", "ReplicaTooStale",
]


def connect(data_dir: str | None = None, device=None,
            n_devices: int | None = None, devices=None, **settings):
    """Open a Session.  `device=None` picks cuda and raises when no GPU is
    visible; pass device="cpu" to run the plain formulations.
    `n_devices=N` runs every statement as N hash-sharded mesh positions
    on that device; `devices=[...]` maps the positions onto the listed
    devices instead (one per position, a device may repeat)."""
    from .session import Session

    return Session(data_dir=data_dir, device=device, n_devices=n_devices,
                   devices=devices, **settings)
