"""Background job runner: dependency-ordered parallel task execution.

Counterpart of citus_tpu/background/jobs.py.  The reference schedules
background work (rebalancer moves, etc.) as rows in
pg_dist_background_job / pg_dist_background_task with inter-task
dependencies and per-node concurrency caps, executed by bgworkers (Citus
src/backend/distributed/utils/background_jobs.c citus_job_wait /
citus_job_cancel).

Single-controller mapping: jobs are in-process task DAGs run by a
bounded pool of worker threads, started on the first submission and
joined by `shutdown` (Session.close).  Tasks are Python callables;
state is queryable via job_status()/jobs() (the citus_job_* UDFs).
"""

from __future__ import annotations

import enum
import threading
import time
import traceback
from dataclasses import dataclass, field


class JobStatus(enum.Enum):
    SCHEDULED = "scheduled"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    CANCELLED = "cancelled"


_FINAL = (JobStatus.DONE, JobStatus.FAILED, JobStatus.CANCELLED)


@dataclass
class BackgroundTask:
    """pg_dist_background_task row analogue."""

    task_id: int
    job_id: int
    fn: object                      # zero-arg callable
    description: str = ""
    depends_on: tuple[int, ...] = ()
    status: JobStatus = JobStatus.SCHEDULED
    error: str | None = None
    result: object = None


@dataclass
class BackgroundJob:
    """pg_dist_background_job row analogue."""

    job_id: int
    description: str
    tasks: dict[int, BackgroundTask] = field(default_factory=dict)

    @property
    def status(self) -> JobStatus:
        states = {t.status for t in self.tasks.values()}
        if JobStatus.FAILED in states:
            return JobStatus.FAILED
        if JobStatus.CANCELLED in states:
            return JobStatus.CANCELLED
        if states <= {JobStatus.DONE}:
            return JobStatus.DONE
        if JobStatus.RUNNING in states:
            return JobStatus.RUNNING
        return JobStatus.SCHEDULED


class BackgroundJobRunner:
    """Bounded worker pool executing task DAGs; its threads live only
    while a job has tasks left.

    With a workload manager attached, every task first admits at the
    `background` priority class (wlm/manager.py): rebalance moves and
    maintenance jobs wait for capacity behind user statements instead
    of racing them for the card (the reference's
    citus.max_background_task_executors_per_node caps)."""

    def __init__(self, max_executors: int = 4, wlm=None,
                 wlm_request=None):
        self.max_executors = max_executors
        self._wlm = wlm
        self._wlm_request = wlm_request if wlm is not None else None
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._jobs: dict[int, BackgroundJob] = {}
        self._next_job = 1
        self._next_task = 1
        self._workers: list[threading.Thread] = []
        self._stop = False

    # -- submission --------------------------------------------------------
    def submit_job(self, description: str,
                   tasks: list[tuple[object, str, list[int]]]) -> int:
        """tasks: [(fn, description, depends_on_positions)] where
        depends_on_positions index into this submission's task list.
        Returns the job id."""
        with self._lock:
            if self._stop:
                raise RuntimeError("the background job runner is shut down")
            job = BackgroundJob(self._next_job, description)
            self._next_job += 1
            ids: list[int] = []
            for fn, desc, deps in tasks:
                t = BackgroundTask(self._next_task, job.job_id, fn, desc,
                                   tuple(ids[d] for d in deps))
                self._next_task += 1
                job.tasks[t.task_id] = t
                ids.append(t.task_id)
            self._jobs[job.job_id] = job
            self._ensure_workers()
            self._cv.notify_all()
            return job.job_id

    def _ensure_workers(self) -> None:
        self._workers = [w for w in self._workers if w.is_alive()]
        while len(self._workers) < self.max_executors:
            w = threading.Thread(
                target=self._worker_loop, daemon=True,
                name=f"citus-bgworker-{len(self._workers)}")
            self._workers.append(w)
            w.start()

    # -- execution ---------------------------------------------------------
    def _claim(self) -> BackgroundTask | None:
        for job in self._jobs.values():
            self._cancel_dependents_locked(job)
            for t in job.tasks.values():
                if t.status is not JobStatus.SCHEDULED:
                    continue
                if all(job.tasks[d].status is JobStatus.DONE
                       for d in t.depends_on):
                    t.status = JobStatus.RUNNING
                    return t
        return None

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                task = self._claim()
                while task is None and not self._stop:
                    if all(j.status in _FINAL for j in self._jobs.values()):
                        # nothing left to run: the worker ends (the next
                        # submission starts workers again), so an idle
                        # runner holds no thread
                        self._workers.remove(threading.current_thread())
                        return
                    self._cv.wait(timeout=0.2)
                    task = self._claim()
                if self._stop:
                    if task is not None:
                        task.status = JobStatus.CANCELLED
                        task.error = "runner shut down"
                        self._cv.notify_all()
                    return
            try:
                ticket = None
                if self._wlm_request is not None:
                    # background-class admission: waits for a free slot
                    # (maintenance never sheds)
                    ticket = self._wlm.admit(self._wlm_request())
                try:
                    task.result = task.fn()
                finally:
                    if ticket is not None:
                        self._wlm.release(ticket)
                with self._cv:
                    task.status = JobStatus.DONE
                    self._cv.notify_all()
            except Exception as exc:
                with self._cv:
                    task.status = JobStatus.FAILED
                    task.error = "".join(traceback.format_exception_only(
                        type(exc), exc)).strip()
                    # cancel dependents before the notify: a waiter
                    # reading the task table right after the job turns
                    # FAILED must not see them still SCHEDULED
                    self._cancel_dependents_locked(
                        self._jobs.get(task.job_id))
                    self._cv.notify_all()

    def _cancel_dependents_locked(self, job) -> None:
        """Mark every SCHEDULED task whose dependency chain holds a
        FAILED/CANCELLED task as CANCELLED (transitively).  Caller holds
        self._cv."""
        if job is None:
            return
        changed = True
        while changed:
            changed = False
            for t in job.tasks.values():
                if t.status is not JobStatus.SCHEDULED:
                    continue
                if any(job.tasks[d].status in (JobStatus.FAILED,
                                               JobStatus.CANCELLED)
                       for d in t.depends_on):
                    t.status = JobStatus.CANCELLED
                    t.error = "dependency failed"
                    changed = True

    # -- control (citus_job_wait / citus_job_cancel) -----------------------
    def wait(self, job_id: int, timeout: float = 3600.0) -> JobStatus:
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                job = self._jobs.get(job_id)
                if job is None:
                    raise KeyError(f"job {job_id} does not exist")
                if job.status in _FINAL:
                    return job.status
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"job {job_id} still running")
                self._cv.wait(timeout=min(remaining, 0.2))

    def cancel(self, job_id: int) -> None:
        with self._cv:
            job = self._jobs.get(job_id)
            if job is None:
                raise KeyError(f"job {job_id} does not exist")
            for t in job.tasks.values():
                if t.status is JobStatus.SCHEDULED:
                    t.status = JobStatus.CANCELLED
            self._cv.notify_all()

    def job_status(self, job_id: int) -> BackgroundJob:
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                raise KeyError(f"job {job_id} does not exist")
            return job

    def jobs(self) -> list[BackgroundJob]:
        with self._lock:
            return list(self._jobs.values())

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop the workers and join them: a running task finishes, a
        scheduled one never starts."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
            workers, self._workers = self._workers, []
        for w in workers:
            w.join(timeout=timeout)
