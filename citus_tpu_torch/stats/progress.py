"""Progress monitors for long-running operations (Citus
src/backend/distributed/progress/multi_progress.c CreateProgressMonitor
backs these with dynamic shared memory other backends scan); here a
per-session registry read by get_rebalance_progress().  Counterpart of
citus_tpu/stats/progress.py."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class ProgressMonitor:
    operation: str          # e.g. "rebalance", "shard_move", "shard_split"
    target: str             # table / shard being operated on
    total_steps: int
    done_steps: int = 0
    detail: str = ""
    started_at: float = field(default_factory=time.time)
    finished: bool = False

    def advance(self, steps: int = 1, detail: str | None = None) -> None:
        self.done_steps += steps
        if detail is not None:
            self.detail = detail

    def finish(self) -> None:
        self.done_steps = self.total_steps
        self.finished = True


class ProgressRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._monitors: list[ProgressMonitor] = []

    def create(self, operation: str, target: str,
               total_steps: int) -> ProgressMonitor:
        mon = ProgressMonitor(operation, target, total_steps)
        with self._lock:
            # keep a short history; drop old finished monitors
            self._monitors = [m for m in self._monitors
                              if not m.finished][-50:] + [mon]
        return mon

    def active(self) -> list[ProgressMonitor]:
        with self._lock:
            return [m for m in self._monitors if not m.finished]

    def all(self) -> list[ProgressMonitor]:
        with self._lock:
            return list(self._monitors)
