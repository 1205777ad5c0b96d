"""The high-cardinality rollup by the distribution key, plainly:
`select l_orderkey, count(*), sum(l_quantity) from lineitem group by
l_orderkey` over the generated arrays.

`truth(data)` is numpy in float64; `evaluate(data, dtype, device)` is
the query in torch with the sums at `dtype` (bfloat16: the control);
`compare(columns, truth)` gives the number judged against LIMITS:
rollup_err, the largest over the groups of the count's and the sum's
absolute errors added, a missing or extra group reading its whole count
and sum.  Quantities are whole numbers from 1 to 50 and an order has at
most 7 lines, so every sum is a whole number below 2**24 and float32
holds each partial sum exactly: the comparison is exact.
Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np

READS = {"lineitem": ["l_orderkey", "l_quantity"]}
RESULT_TYPES = ["int64", "int64", "float64"]
LIMITS = {"rollup_err": 0}


def truth(data: dict) -> dict:
    li = data["lineitem"]
    keys, inv = np.unique(li["l_orderkey"], return_inverse=True)
    return {"keys": keys, "count": np.bincount(inv),
            "sum": np.bincount(inv, weights=li["l_quantity"])}


def rows(t: dict) -> int:
    return len(t["keys"])


def compare(columns: list, t: dict) -> dict[str, float]:
    keys = np.asarray(columns[0]).astype(np.int64)
    cnt = np.asarray(columns[1]).astype(np.float64)
    tot = np.asarray(columns[2]).astype(np.float64)
    tk = t["keys"]
    pos = np.minimum(np.searchsorted(tk, keys), len(tk) - 1)
    found = tk[pos] == keys
    # each true group's error: its count's and sum's, or all of both
    # when no returned row (or more than one) holds its key
    hits = np.bincount(pos[found], minlength=len(tk))
    err = t["count"] + t["sum"]
    one = found & (hits[pos] == 1)
    err[pos[one]] = (np.abs(cnt[one] - t["count"][pos[one]])
                     + np.abs(tot[one] - t["sum"][pos[one]]))
    extra = cnt[~found] + tot[~found]
    return {"rollup_err": float(max(err.max(initial=0.0),
                                    extra.max(initial=0.0)))}


def evaluate(data: dict, dtype: str = "float64", device: str = "cpu"):
    """The query in torch, sums at `dtype`, as the result's columns."""
    import torch

    dt = getattr(torch, dtype)
    li = data["lineitem"]
    okey = torch.from_numpy(li["l_orderkey"]).to(device)
    qty = torch.from_numpy(li["l_quantity"]).to(device)
    keys, inv, cnt = torch.unique(okey, return_inverse=True,
                                  return_counts=True)
    tot = torch.zeros(keys.numel(), dtype=dt, device=device).index_add_(
        0, inv, qty.to(dt))
    return [keys.cpu().numpy(), cnt.cpu().numpy(),
            tot.to(torch.float64).cpu().numpy()]
