"""Background services: the job runner and the maintenance daemon
(counterpart of citus_tpu/background/)."""

from .daemon import MaintenanceDaemon
from .jobs import BackgroundJobRunner, BackgroundTask, JobStatus

__all__ = ["BackgroundJobRunner", "BackgroundTask", "JobStatus",
           "MaintenanceDaemon"]
