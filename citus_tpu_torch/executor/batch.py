"""Block: the device-side batch of rows (columns + row validity + nulls).

Counterpart of citus_tpu/executor/batch.py.  A whole shard (or shuffle
partition) is processed as vectors: filters never shrink tensors — they
clear `valid` bits — so every stage keeps the static capacities the
runner's overflow-retry protocol sizes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Block:
    """columns: name → [N] tensor; valid: [N] bool row mask;
    nulls: name → [N] True-where-NULL (absent key = no nulls)."""

    columns: dict[str, torch.Tensor]
    valid: torch.Tensor
    nulls: dict[str, torch.Tensor] = field(default_factory=dict)

    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])

    def null_mask(self, name: str) -> torch.Tensor:
        """[N] bool, True where value is NULL."""
        if name in self.nulls:
            return self.nulls[name]
        return torch.zeros(self.valid.shape, dtype=torch.bool,
                           device=self.valid.device)

    def with_filter(self, mask: torch.Tensor) -> "Block":
        return Block(self.columns, self.valid & mask, self.nulls)


def block_from_numpy(values: dict[str, np.ndarray],
                     validity: dict[str, np.ndarray] | None = None,
                     capacity: int | None = None,
                     compute_dtype=None, device="cpu") -> Block:
    """Host arrays → padded Block on `device`.

    Per-column validity from storage becomes `nulls`; rows beyond the real
    row count are padding (valid=False).  float64 storage casts to
    `compute_dtype` when given.
    """
    n = len(next(iter(values.values())))
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < rows {n}")
    cols = {}
    nulls = {}
    for name, arr in values.items():
        arr = np.asarray(arr)
        if compute_dtype is not None and arr.dtype == np.float64:
            arr = arr.astype(compute_dtype)
        pad = np.zeros(cap - n, dtype=arr.dtype)
        cols[name] = torch.from_numpy(
            np.concatenate([arr, pad])).to(device)
        if validity and name in validity:
            v = np.asarray(validity[name], dtype=bool)
            if not v.all():
                nulls[name] = torch.from_numpy(np.concatenate(
                    [~v, np.zeros(cap - n, dtype=bool)])).to(device)
    valid = torch.from_numpy(np.concatenate(
        [np.ones(n, dtype=bool), np.zeros(cap - n, dtype=bool)])).to(device)
    return Block(cols, valid, nulls)


def block_to_numpy(block: Block) -> tuple[dict[str, np.ndarray], np.ndarray,
                                          dict[str, np.ndarray]]:
    """Block → host (columns, valid, nulls) as numpy."""
    cols = {n: a.cpu().numpy() for n, a in block.columns.items()}
    valid = block.valid.cpu().numpy()
    nulls = {n: a.cpu().numpy() for n, a in block.nulls.items()}
    return cols, valid, nulls


def compact_to_numpy(block: Block) -> tuple[dict[str, np.ndarray],
                                            dict[str, np.ndarray]]:
    """Gather only valid rows host-side (final result materialization)."""
    cols, valid, nulls = block_to_numpy(block)
    out = {n: a[valid] for n, a in cols.items()}
    out_nulls = {n: a[valid] for n, a in nulls.items()}
    return out, out_nulls
