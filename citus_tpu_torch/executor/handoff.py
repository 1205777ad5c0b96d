"""The result hand-off: a plan's output rows from the device to the host.

The device program ends by compacting (`PlanCompiler._body`): each
output lane's valid rows, at the lane's own dtype, go to the front of
its region of one byte block, and the position's row count n joins the
counter vector.  The block is [N, B, cap + 1] uint8 for N positions and
a slot capacity cap: lane i holds byte rows ``lane_rows(meta)[i]`` to
that plus its itemsize, i.e. cap + 1 elements (the last is the slot
that invalid rows are scattered to).  Lanes sit in order of descending
itemsize, so every lane starts at a multiple of its own itemsize.  A
lane is a column or a column's NULL mask; a column with no NULL mask in
the plan has no lane.

The fetch (`ResultStaging.fetch`) makes two waits a statement: the
counter vector's copy, which also waits for the program, then the
first n rows of every lane, copied with ``non_blocking`` into one host
staging buffer (pinned on the card) and waited on with one event.  The
staging belongs to the session's thread and is reused: it grows
geometrically and is never allocated per statement.  `unpack_outputs`
returns numpy views into it, which the next fetch overwrites, so every
consumer copies what it keeps (`Executor._host_combine`'s select list,
the stream's and multi-pass's parts).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..stats import counters as sc

# host lanes start at multiples of this many bytes
_ALIGN = 64
# the staging buffer's first size, in bytes
_MIN_STAGING = 1 << 16


def lane_rows(out_meta) -> tuple[list[int], int]:
    """(first byte row of each lane of `out_meta`, in its order; B, the
    byte rows of a position's block).  Lanes are laid out by descending
    itemsize, stably."""
    order = sorted(range(len(out_meta)),
                   key=lambda i: -out_meta[i][2].itemsize)
    rows = [0] * len(out_meta)
    b = 0
    for i in order:
        rows[i] = b
        b += out_meta[i][2].itemsize
    return rows, b


def compact(lanes: list, valid: torch.Tensor, out_meta):
    """One position's output lanes ([cap] each, the dtypes of
    `out_meta`) compacted under `valid`: each valid slot goes to its
    rank, every other one to the extra slot at the end, one scatter per
    lane and no host sync (a CUDA graph captures it).  Returns the
    position's [B, cap + 1] uint8 block and its row count."""
    cap = valid.shape[0]
    dest = torch.where(valid, torch.cumsum(valid, 0) - 1, cap)
    rows, nb = lane_rows(out_meta)
    buf = torch.empty((nb, cap + 1), dtype=torch.uint8, device=valid.device)
    for lane, r, (_kind, _cid, dt) in zip(lanes, rows, out_meta):
        buf[r:r + dt.itemsize].view(-1).view(lane.dtype).index_copy_(
            0, dest, lane)
    return buf, valid.sum()


@dataclass
class Fetched:
    """One run's output rows on the host: `buf` holds lane i's rows of
    every position, position-major, from byte `offsets[i]`."""

    buf: np.ndarray
    offsets: list
    rows: list          # rows handed back per position
    slots: int          # slots the card produced: capacity × positions
    nbytes: int         # bytes of the rows and of their counts copied back


def unpack_outputs(fetched: Fetched, out_meta):
    """(cols, nulls) by cid: numpy views into the staging at the lanes'
    own dtypes, n rows each; a column without a NULL lane has no entry
    in nulls."""
    n = sum(fetched.rows)
    cols: dict[str, np.ndarray] = {}
    nulls: dict[str, np.ndarray] = {}
    for (kind, cid, dt), at in zip(out_meta, fetched.offsets):
        arr = fetched.buf[at:at + n * dt.itemsize].view(dt)
        (cols if kind == "col" else nulls)[cid] = arr
    return cols, nulls


class ResultStaging:
    """One session thread's host staging for fetched results.  The
    session's StatCounters (`counters`, None: nothing counted) count the
    rows handed back, the slots they came from and each growth."""

    def __init__(self, counters=None):
        self.counters = counters
        self._buf: torch.Tensor | None = None

    def _room(self, nbytes: int, pin: bool) -> torch.Tensor:
        have = 0 if self._buf is None else self._buf.numel()
        if self._buf is None or nbytes > have:
            size = max(nbytes, 2 * have, _MIN_STAGING)
            self._buf = None  # the old one goes before the new one comes
            self._buf = torch.empty(size, dtype=torch.uint8,
                                    pin_memory=pin)
            if self.counters is not None:
                self.counters.increment(sc.RESULT_STAGING_GROWS_TOTAL)
        return self._buf

    def fetch(self, packed: torch.Tensor, counters: torch.Tensor,
              out_meta, n_stages: int) -> tuple[Fetched, np.ndarray]:
        """Copy back a run's counter vector ([overflow, dense_oob,
        *n_stages stage actuals, *rows per position]) and then its rows
        from `packed` ([N, B, cap + 1] uint8).  Returns the Fetched rows
        and the counters without the row counts.  A run that overflowed
        or tripped a stale statistic hands back no rows: it re-runs."""
        k = counters.cpu().numpy().copy()
        n_pos, _b, width = packed.shape
        rows = [int(r) for r in k[2 + n_stages:]]
        k = k[:2 + n_stages]
        if k[0] or k[1]:
            rows = [0] * n_pos
        total = sum(rows)
        offsets, end = [], 0
        for _kind, _cid, dt in out_meta:
            offsets.append(end)
            end += -(-total * dt.itemsize // _ALIGN) * _ALIGN
        on_card = packed.device.type == "cuda"
        buf = self._room(end, on_card)
        if total and out_meta:
            flat = packed.reshape(n_pos, -1)
            starts, _b = lane_rows(out_meta)
            for (_kind, _cid, dt), at, r in zip(out_meta, offsets, starts):
                src = r * width
                for p, n in enumerate(rows):
                    size = n * dt.itemsize
                    if size:
                        buf[at:at + size].copy_(flat[p, src:src + size],
                                                non_blocking=on_card)
                        at += size
            if on_card:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(packed.device))
                done.synchronize()
        slots = (width - 1) * n_pos
        if self.counters is not None and not (k[0] or k[1]):
            self.counters.increment(sc.RESULT_ROWS_FETCHED_TOTAL, total)
            self.counters.increment(sc.RESULT_SLOTS_TOTAL, slots)
        nbytes = k.itemsize * n_pos + sum(total * dt.itemsize
                                          for _k, _c, dt in out_meta)
        return Fetched(buf.numpy(), offsets, rows, slots, nbytes), k
