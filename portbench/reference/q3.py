"""TPC-H Q3 with its validation parameters (BUILDING, 1995-03-15),
plainly, over the generated arrays.

`truth(data)` is numpy in float64: every qualifying order's revenue,
date and priority, and the first ten by (revenue desc, date).
`evaluate(data, dtype, device)` computes the whole query in torch at
`dtype` and returns it as the SQL result's columns: the reference put
in the program's place, which in bfloat16 is the control.
`compare(columns, truth)` gives the numbers judged, each against LIMITS.
Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np

DAY = 9204  # 1995-03-15
SEGMENT = "BUILDING"
TOP = 10
READS = {
    "customer": ["c_custkey", "c_mktsegment"],
    "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"],
    "lineitem": ["l_orderkey", "l_extendedprice", "l_discount",
                 "l_shipdate"],
}
# the result's columns as stored: key, revenue, date (day number), priority
RESULT_TYPES = ["int64", "float64", "int32", "int32"]
# q3_gap, the one number judged: over the returned rows, the largest of
# a revenue's relative error against the true revenue of its order and
# the relative amount by which that true revenue lies below the true
# revenue at the row's rank; a missing, extra or duplicate row, or one
# whose order does not qualify or whose date or priority is wrong,
# reads 1.  Set from the readings in PERF.md (the program over a dozen
# seeds and more; the bfloat16 control).
LIMITS = {"q3_gap": 1e-4}


def _order_rows(okeys: np.ndarray, lkeys: np.ndarray) -> np.ndarray:
    order = np.argsort(okeys, kind="stable")
    return order[np.searchsorted(okeys[order], lkeys)]


def truth(data: dict) -> dict:
    c, o, li = data["customer"], data["orders"], data["lineitem"]
    bkeys = c["c_custkey"][c["c_mktsegment"] == SEGMENT]
    osel = (o["o_orderdate"] < DAY) & np.isin(o["o_custkey"], bkeys)
    row = _order_rows(o["o_orderkey"], li["l_orderkey"])
    lm = (li["l_shipdate"] > DAY) & osel[row]
    n = len(o["o_orderkey"])
    rev = np.bincount(row[lm], weights=li["l_extendedprice"][lm]
                      * (1.0 - li["l_discount"][lm]), minlength=n)
    idx = np.flatnonzero(np.bincount(row[lm], minlength=n) > 0)
    ranked = idx[np.lexsort((o["o_orderdate"][idx], -rev[idx]))]
    by_key = idx[np.argsort(o["o_orderkey"][idx], kind="stable")]
    return {"keys": o["o_orderkey"][by_key], "rev": rev[by_key],
            "date": o["o_orderdate"][by_key].astype(np.int64),
            "prio": o["o_shippriority"][by_key].astype(np.int64),
            "top_rev": rev[ranked[:TOP]]}


def rows(t: dict) -> int:
    return len(t["top_rev"])


def days(col) -> np.ndarray:
    """Day numbers of a date column given as day numbers, datetime64 or
    ISO strings."""
    a = np.asarray(col)
    if a.dtype.kind in "iu":
        return a.astype(np.int64)
    if a.dtype.kind == "M":
        return a.astype("datetime64[D]").astype(np.int64)
    return np.array([np.datetime64(str(x)[:10], "D") for x in a],
                    dtype="datetime64[D]").astype(np.int64)


def compare(columns: list, t: dict) -> dict[str, float]:
    keys = np.asarray(columns[0]).astype(np.int64)
    rev = np.asarray(columns[1]).astype(np.float64)
    date, prio = days(columns[2]), np.asarray(columns[3]).astype(np.int64)
    if len(keys) != rows(t) or len(np.unique(keys)) != len(keys):
        return {"q3_gap": 1.0}
    pos = np.minimum(np.searchsorted(t["keys"], keys), len(t["keys"]) - 1)
    if not ((t["keys"][pos] == keys).all() and (t["date"][pos] == date).all()
            and (t["prio"][pos] == prio).all()):
        return {"q3_gap": 1.0}
    true_rev = t["rev"][pos]
    own = np.abs(rev - true_rev) / np.abs(true_rev)
    rank = (t["top_rev"] - true_rev) / np.abs(t["top_rev"])
    return {"q3_gap": float(max(own.max(initial=0.0),
                                rank.max(initial=0.0)))}


def evaluate(data: dict, dtype: str = "float64", device: str = "cpu"):
    """The query in torch at `dtype` (revenue products and sums), as the
    result's columns."""
    import torch

    dt = getattr(torch, dtype)
    c, o, li = data["customer"], data["orders"], data["lineitem"]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    bkeys = put(c["c_custkey"][c["c_mktsegment"] == SEGMENT])
    okey, odate = put(o["o_orderkey"]), put(o["o_orderdate"])
    osel = (odate < DAY) & torch.isin(put(o["o_custkey"]), bkeys)
    order = torch.argsort(okey, stable=True)
    row = order[torch.searchsorted(okey[order], put(li["l_orderkey"]))]
    lm = (put(li["l_shipdate"]) > DAY) & osel[row]
    vol = put(li["l_extendedprice"]).to(dt) * (
        1 - put(li["l_discount"]).to(dt))
    n = okey.numel()
    rev = torch.zeros(n, dtype=dt, device=device).index_add_(
        0, row[lm], vol[lm])
    cnt = torch.zeros(n, dtype=torch.int64, device=device).index_add_(
        0, row[lm], torch.ones_like(row[lm]))
    idx = torch.nonzero(cnt > 0).flatten()
    by_date = idx[torch.argsort(odate[idx], stable=True)]
    ranked = by_date[torch.argsort(-rev[by_date].to(torch.float64),
                                   stable=True)][:TOP]
    return [okey[ranked].cpu().numpy(),
            rev[ranked].to(torch.float64).cpu().numpy(),
            odate[ranked].cpu().numpy(),
            put(o["o_shippriority"])[ranked].cpu().numpy()]
