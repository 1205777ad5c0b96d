"""Kernels: the least time the statements' logical bytes need at the
card's published memory bandwidth, over the device's busy time in the
profiled slice.

Logical bytes are each input column a statement reads, once, at its
device width, for every row, plus the result it writes, counted from
the generated data (cell.logical_bytes), so the share reads the same
work whatever implements it.  A statement counts by the share of its
latency that falls inside the slice."""


def read(r):
    sl, peaks = r.slice, r.peaks
    if sl is None or peaks is None or sl.busy_s <= 0:
        return None
    need = 0.0
    for s in r.log.statements:
        if not s.ok or s.t_done <= sl.t_start or s.t_send >= sl.t_end:
            continue
        inside = min(s.t_done, sl.t_end) - max(s.t_send, sl.t_start)
        need += r.bytes_per_stmt[s.query] * inside / s.latency_s
    if need <= 0:
        return None
    return need / peaks["hbm_bytes_per_s"] / sl.busy_s
