"""Slab-streaming TPC-H generator/loader for SF≥50 scale runs.

A copy of citus_tpu/ingest/tpch_slab.py: the same seed gives the same
rows in both packages (per-slab streams `default_rng([seed, table,
lo])`, the same comment pool, the same columns), ingested through the
port's `copy_from._ingest_batch(..., pre_typed=True)`.

`generate_tables` (tpch.py) materializes every table in RAM — ~3 GB per
SF unit — which caps it near SF10 on a 128 GB host.  This loader
generates and ingests in ORDER-RANGE SLABS (orders + their lineitems
together, customers separately), so peak memory is one slab regardless
of scale factor.  It covers the three tables the scale benchmarks touch
(customer, orders, lineitem); schemas for all eight are still created.

Two deliberate deviations from the monolithic generator, both documented
here because they are visible to consumers:

* per-slab RNG streams (seeded by (seed, table, slab)) — data differs
  from generate_tables at the same sf, but keys/distributions match.
* near-unique text columns cycle within a bounded pool (~4M distinct):
  a global string dictionary with 600M distinct entries would not fit
  host memory.  The benchmark queries never read these columns; the
  engine still stores/compresses the full 600M string VALUES.
"""

from __future__ import annotations

import numpy as np

from .copy_from import _ingest_batch
from .tpch import (
    DISTRIBUTION,
    PRIORITIES,
    REFERENCE_TABLES,
    SCHEMAS,
    SEGMENTS,
    SHIPINSTRUCT,
    SHIPMODES,
    table_rows,
)

_EPOCH_1992 = 8035          # days 1970→1992-01-01 (matches tpch.py)
_ORDER_DATE_RANGE = 2406

COMMENT_POOL = 4_000_000    # distinct values for near-unique text cols


def _comments(prefix: str, start: int, n: int) -> list[str]:
    return [f"{prefix} {i % COMMENT_POOL}" for i in range(start, start + n)]


def load_slabbed(session, sf: float, seed: int = 0,
                 shard_count: int | None = None,
                 slab_orders: int = 3_000_000,
                 progress=None) -> dict[str, int]:
    """Create schemas + distribution, then stream-load customer, orders,
    lineitem in slabs.  Returns row counts."""
    counts = table_rows(sf)
    for table, ddl in SCHEMAS.items():
        session.execute(ddl)
    for table, (dist_col, colocate) in DISTRIBUTION.items():
        session.create_distributed_table(table, dist_col,
                                         shard_count=shard_count,
                                         colocate_with=colocate)
    for table in REFERENCE_TABLES:
        session.create_reference_table(table)

    nc = counts["customer"]
    ns = counts["supplier"]
    npart = counts["part"]
    loaded = {"customer": 0, "orders": 0, "lineitem": 0}

    # -- customer slabs ------------------------------------------------
    cust_slab = max(1, slab_orders)
    for lo in range(0, nc, cust_slab):
        hi = min(lo + cust_slab, nc)
        n = hi - lo
        rng = np.random.default_rng([seed, 1, lo])
        cols = {
            "c_custkey": np.arange(lo + 1, hi + 1, dtype=np.int64),
            "c_name": [f"Customer#{i:09d}" for i in range(lo + 1, hi + 1)],
            "c_address": _comments("addr c", lo, n),
            "c_nationkey": rng.integers(0, 25, n).astype(np.int32),
            "c_phone": [f"{i % 35 + 10}-{i % 999:03d}"
                        for i in range(lo, hi)],
            "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n), 2),
            "c_mktsegment": [SEGMENTS[i] for i in rng.integers(0, 5, n)],
            "c_comment": _comments("customer comment", lo, n),
        }
        loaded["customer"] += _ingest_batch(
            session, "customer", list(cols), list(cols.values()),
            pre_typed=True)[0]
        if progress:
            progress("customer", loaded["customer"], nc)

    # -- orders + lineitem slabs ---------------------------------------
    no = counts["orders"]
    for lo in range(0, no, slab_orders):
        hi = min(lo + slab_orders, no)
        n = hi - lo
        rng = np.random.default_rng([seed, 2, lo])
        okey = (np.arange(lo, hi, dtype=np.int64) * 4) + 1
        odate = _EPOCH_1992 + rng.integers(0, _ORDER_DATE_RANGE, n)
        ocols = {
            "o_orderkey": okey,
            "o_custkey": rng.integers(1, nc + 1, n).astype(np.int64),
            "o_orderstatus": [("F", "O", "P")[i]
                              for i in rng.integers(0, 3, n)],
            "o_totalprice": np.round(rng.uniform(1000.0, 450_000.0, n), 2),
            "o_orderdate": odate.astype(np.int32),
            "o_orderpriority": [PRIORITIES[i]
                                for i in rng.integers(0, 5, n)],
            "o_clerk": np.char.add(
                "Clerk#", np.char.zfill(
                    rng.integers(1, max(ns, 2), n).astype("U9"), 9)
            ).astype(object),
            "o_shippriority": np.zeros(n, dtype=np.int32),
            "o_comment": _comments("order comment", lo, n),
        }
        loaded["orders"] += _ingest_batch(
            session, "orders", list(ocols), list(ocols.values()),
            pre_typed=True)[0]

        per_order = rng.integers(1, 8, n)
        nl = int(per_order.sum())
        l_okey = np.repeat(okey, per_order)
        l_odate = np.repeat(odate, per_order)
        starts = np.cumsum(per_order) - per_order
        linenumber = np.arange(nl) - np.repeat(starts, per_order) + 1
        qty = rng.integers(1, 51, nl).astype(np.float64)
        pkey = rng.integers(1, npart + 1, nl).astype(np.int64)
        extended = np.round((900 + (pkey % 1000) * 0.1) * qty, 2)
        shipdate = (l_odate + rng.integers(1, 122, nl)).astype(np.int32)
        returnflag = np.where(
            shipdate <= _EPOCH_1992 + 1277,
            np.array(["R", "A"], dtype=object)[rng.integers(0, 2, nl)],
            "N")
        linestatus = np.where(shipdate > _EPOCH_1992 + 1656, "O", "F")
        supp = ((pkey + rng.integers(0, 4, nl) * (ns // 4 + 1)) % ns) + 1
        lbase = loaded["lineitem"]
        lcols = {
            "l_orderkey": l_okey,
            "l_partkey": pkey,
            "l_suppkey": supp.astype(np.int64),
            "l_linenumber": linenumber.astype(np.int32),
            "l_quantity": qty,
            "l_extendedprice": extended,
            "l_discount": np.round(rng.integers(0, 11, nl) * 0.01, 2),
            "l_tax": np.round(rng.integers(0, 9, nl) * 0.01, 2),
            "l_returnflag": list(returnflag),
            "l_linestatus": list(linestatus.astype(object)),
            "l_shipdate": shipdate,
            "l_commitdate": (l_odate
                             + rng.integers(30, 91, nl)).astype(np.int32),
            "l_receiptdate": (shipdate
                              + rng.integers(1, 31, nl)).astype(np.int32),
            "l_shipinstruct": [SHIPINSTRUCT[i]
                               for i in rng.integers(0, 4, nl)],
            "l_shipmode": [SHIPMODES[i] for i in rng.integers(0, 7, nl)],
            "l_comment": _comments("li", lbase, nl),
        }
        loaded["lineitem"] += _ingest_batch(
            session, "lineitem", list(lcols), list(lcols.values()),
            pre_typed=True)[0]
        if progress:
            progress("orders+lineitem", loaded["orders"], no)
    return loaded
