"""The traced run's device profile: one slice of the window under
torch.profiler, reduced to busy intervals on the host's clock.

Busy time is the union of every device operation's interval (kernels,
copies, memsets) across all streams, so operations that overlap on
several streams count once.  The slice is placed on the host's
`time.perf_counter` clock by a marker recorded inside the profile, so
its idle gaps can be set beside the port's spans, which use that clock.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

MARKER = "portbench.slice"


@dataclass
class Slice:
    t_start: float
    t_end: float
    # when the profiler was asked to start: statements done before it
    # ran unprofiled
    t_enter: float = 0.0
    # (start, end, name) of each device operation, clipped to the slice
    ops: list[tuple[float, float, str]] = field(default_factory=list)
    # kernels of the program seen in the profile, and launched (the
    # program's own launch counts) while it ran
    seen: dict[str, int] = field(default_factory=dict)
    launched: dict[str, int] = field(default_factory=dict)
    device_events: int = 0  # in the whole profile, before clipping

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    def busy(self) -> list[tuple[float, float]]:
        return merge([(a, b) for a, b, _ in self.ops])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def gaps(self) -> list[tuple[float, float]]:
        """The idle intervals of the slice."""
        out, t = [], self.t_start
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if t < self.t_end:
            out.append((t, self.t_end))
        return out

    @property
    def coverage(self) -> float | None:
        """Program kernels the profile holds per launch counted."""
        n = sum(self.launched.values())
        return sum(self.seen.values()) / n if n else None

    def top_ops(self, k: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for a, b, name in self.ops:
            by[name] = by.get(name, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]


def merge(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def short_name(name: str) -> str:
    return name if len(name) <= 80 else name[:77] + "..."


def prime() -> None:
    """Start and stop the profiler once on this thread, before any
    session thread exists: a profiler first started while those threads
    run records none of their operations, on the host or the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.empty(1, device="cuda")
    torch.cuda.synchronize()


def profile_slice(seconds: float, kernel_names, launches) -> Slice:
    """Profile the card for `seconds` while other threads run.
    `launches()` returns the program's launch counts by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    try:  # every thread's operations, not only this one's
        from torch.profiler import _ExperimentalConfig

        extra = {"experimental_config":
                 _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        extra = {}
    # the profiler sees the card only from a thread with a current CUDA
    # context; the sessions' threads hold theirs
    torch.empty(1, device="cuda")
    before = dict(launches())
    t_enter = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **extra) as prof:
        with record_function(MARKER):
            t_mark = time.perf_counter()
        t_start = time.perf_counter()
        time.sleep(seconds)
        t_end = time.perf_counter()
    after = dict(launches())
    events = prof.profiler.kineto_results.events()
    marks = [e for e in events
             if e.name() == MARKER and e.device_type() == DeviceType.CPU]
    if not marks:
        raise RuntimeError("the profile lost its marker")
    offset = t_mark - marks[0].start_ns() * 1e-9
    sl = Slice(t_start, t_end, t_enter)
    sl.launched = {k: after.get(k, 0) - before.get(k, 0)
                   for k in kernel_names}
    sl.seen = dict.fromkeys(kernel_names, 0)
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        sl.device_events += 1
        a = offset + e.start_ns() * 1e-9
        b = offset + e.end_ns() * 1e-9
        name = e.name()
        for k in kernel_names:
            if k in name and t_start <= a < t_end:
                sl.seen[k] += 1
        a, b = max(a, t_start), min(b, t_end)
        if b > a:
            sl.ops.append((a, b, short_name(name)))
    return sl
