"""The benchmark's own TPC-H generator (dbgen-lite), frozen.

A copy of the value distributions of `citus_tpu_torch/ingest/tpch.py`'s
`generate_tables`, kept here so that a change to the port cannot move
the yardstick.  Two things differ from that function, both for set-up
time, which every run of every cell pays: each table draws from its
own random stream, seeded by (table, seed), so a mix generates only the
tables its queries read and what they derive from (lineitem is built
from orders' keys and dates).  Every seed has the same sizes: row counts
follow the scale factor, and each order's 1 to 7 lines are drawn once
from a stream of their own that no seed changes, so the seed changes
the values and never the shape of the work (with lines per order drawn
from the seed, the 1.5M-group rollup ran 30% slower on some seeds than
on others, the same in two sets of runs).

The string vocabularies are the port's, copied.  String columns are
numpy object arrays.  The tables' DDL and Citus layout are the port's
(`ingest.tpch.load_tables`); the configuration file states the layout
and the harness holds the loaded catalog to it.
"""

from __future__ import annotations

import numpy as np

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [  # (name, regionkey): the real 25
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN"]
TYPES_1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPES_2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPES_3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINERS = ["SM CASE", "SM BOX", "MED BAG", "MED BOX", "LG CASE",
              "LG BOX", "WRAP CASE", "JUMBO PKG"]
COLORS = ["almond", "azure", "blue", "chocolate", "coral", "forest",
          "green", "ivory", "linen", "magenta", "midnight", "olive",
          "red", "royal", "salmon", "steel", "tan", "violet", "white"]

EPOCH_1992 = 8035          # days('1992-01-01')
ORDER_DATE_RANGE = 2406    # through 1998-08-02
# each table's stream: default_rng([STREAM[table], seed])
# the lines of each order: the same for every seed
LINES_PER_ORDER_STREAM = [9, 0]
STREAM = {"customer": 1, "orders": 2, "lineitem": 3, "supplier": 4,
          "part": 5, "partsupp": 6, "nation": 7, "region": 8}


def table_rows(sf: float) -> dict[str, int]:
    """Rows per table at `sf` (lineitem: 1 to 7 lines per order)."""
    return {
        "region": 5,
        "nation": 25,
        "supplier": max(int(10_000 * sf), 10),
        "customer": max(int(150_000 * sf), 30),
        "part": max(int(200_000 * sf), 40),
        "partsupp": max(int(200_000 * sf), 40) * 4,
        "orders": max(int(1_500_000 * sf), 150),
    }


def _rng(table: str, seed: int) -> np.random.Generator:
    return np.random.default_rng([STREAM[table], int(seed) % (1 << 64)])


def _labels(prefix: str, n: int) -> np.ndarray:
    return np.array([f"{prefix}{i}" for i in range(n)], dtype=object)


def _customer(sf: float, seed: int) -> dict:
    rng = _rng("customer", seed)
    nc = table_rows(sf)["customer"]
    return {
        "c_custkey": np.arange(1, nc + 1, dtype=np.int64),
        "c_name": np.array([f"Customer#{i:09d}" for i in range(1, nc + 1)],
                           dtype=object),
        "c_address": _labels("addr c", nc),
        "c_nationkey": rng.integers(0, 25, nc).astype(np.int32),
        "c_phone": np.array([f"{i % 35 + 10}-{i % 999:03d}"
                             for i in range(nc)], dtype=object),
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, nc), 2),
        "c_mktsegment": np.array(SEGMENTS, dtype=object)[
            rng.integers(0, 5, nc)],
        "c_comment": _labels("customer comment ", nc),
    }


def _orders(sf: float, seed: int) -> dict:
    rng = _rng("orders", seed)
    counts = table_rows(sf)
    no, nc, ns = counts["orders"], counts["customer"], counts["supplier"]
    # dbgen's order keys are sparse; keep them so (4i + 1)
    okey = np.arange(no, dtype=np.int64) * 4 + 1
    odate = EPOCH_1992 + rng.integers(0, ORDER_DATE_RANGE, no)
    return {
        "o_orderkey": okey,
        "o_custkey": rng.integers(1, nc + 1, no).astype(np.int64),
        "o_orderstatus": np.array(["F", "O", "P"], dtype=object)[
            rng.integers(0, 3, no)],
        "o_totalprice": np.round(rng.uniform(1000.0, 450_000.0, no), 2),
        "o_orderdate": odate.astype(np.int32),
        "o_orderpriority": np.array(PRIORITIES, dtype=object)[
            rng.integers(0, 5, no)],
        "o_clerk": np.char.add(
            "Clerk#", np.char.zfill(
                rng.integers(1, max(ns, 2), no).astype("U9"), 9)
        ).astype(object),
        "o_shippriority": np.zeros(no, dtype=np.int32),
        "o_comment": _labels("order comment ", no),
    }


def _lineitem(sf: float, seed: int, orders: dict) -> dict:
    rng = _rng("lineitem", seed)
    counts = table_rows(sf)
    npart, ns = counts["part"], counts["supplier"]
    okey = orders["o_orderkey"]
    odate = orders["o_orderdate"].astype(np.int64)
    per_order = np.random.default_rng(LINES_PER_ORDER_STREAM).integers(
        1, 8, len(okey))
    nl = int(per_order.sum())
    l_odate = np.repeat(odate, per_order)
    starts = np.cumsum(per_order) - per_order
    linenumber = np.arange(nl) - np.repeat(starts, per_order) + 1
    qty = rng.integers(1, 51, nl).astype(np.float64)
    pkey = rng.integers(1, npart + 1, nl).astype(np.int64)
    extended = np.round((900 + (pkey % 1000) * 0.1) * qty, 2)
    shipdate = (l_odate + rng.integers(1, 122, nl)).astype(np.int32)
    commit_delta = rng.integers(30, 91, nl)
    receipt_delta = rng.integers(1, 31, nl)
    returnflag = np.where(
        shipdate <= EPOCH_1992 + 1277,
        np.array(["R", "A"], dtype=object)[rng.integers(0, 2, nl)],
        "N")
    linestatus = np.where(shipdate > EPOCH_1992 + 1656, "O", "F")
    supp = ((pkey + rng.integers(0, 4, nl) * (ns // 4 + 1)) % ns) + 1
    return {
        "l_orderkey": np.repeat(okey, per_order),
        "l_partkey": pkey,
        "l_suppkey": supp.astype(np.int64),
        "l_linenumber": linenumber.astype(np.int32),
        "l_quantity": qty,
        "l_extendedprice": extended,
        "l_discount": np.round(rng.integers(0, 11, nl) * 0.01, 2),
        "l_tax": np.round(rng.integers(0, 9, nl) * 0.01, 2),
        "l_returnflag": returnflag.astype(object),
        "l_linestatus": linestatus.astype(object),
        "l_shipdate": shipdate,
        "l_commitdate": (l_odate + commit_delta).astype(np.int32),
        "l_receiptdate": (shipdate + receipt_delta).astype(np.int32),
        "l_shipinstruct": np.array(SHIPINSTRUCT, dtype=object)[
            rng.integers(0, 4, nl)],
        "l_shipmode": np.array(SHIPMODES, dtype=object)[
            rng.integers(0, 7, nl)],
        "l_comment": _labels("li ", nl),
    }


def _region(sf: float, seed: int) -> dict:
    return {
        "r_regionkey": np.arange(5, dtype=np.int32),
        "r_name": np.array(REGIONS, dtype=object),
        "r_comment": _labels("region comment ", 5),
    }


def _nation(sf: float, seed: int) -> dict:
    return {
        "n_nationkey": np.arange(25, dtype=np.int32),
        "n_name": np.array([n for n, _ in NATIONS], dtype=object),
        "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int32),
        "n_comment": _labels("nation comment ", 25),
    }


def _supplier(sf: float, seed: int) -> dict:
    rng = _rng("supplier", seed)
    ns = table_rows(sf)["supplier"]
    return {
        "s_suppkey": np.arange(1, ns + 1, dtype=np.int64),
        "s_name": np.array([f"Supplier#{i:09d}" for i in range(1, ns + 1)],
                           dtype=object),
        "s_address": _labels("addr s", ns),
        "s_nationkey": rng.integers(0, 25, ns).astype(np.int32),
        "s_phone": np.array([f"{i % 35 + 10}-{i % 999:03d}"
                             for i in range(ns)], dtype=object),
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, ns), 2),
        "s_comment": _labels("supplier comment ", ns),
    }


def _part(sf: float, seed: int) -> dict:
    rng = _rng("part", seed)
    npart = table_rows(sf)["part"]
    type_full = np.array(
        [f"{TYPES_1[a]} {TYPES_2[b]} {TYPES_3[c]}"
         for a, b, c in zip(rng.integers(0, 6, npart),
                            rng.integers(0, 5, npart),
                            rng.integers(0, 5, npart))], dtype=object)
    return {
        "p_partkey": np.arange(1, npart + 1, dtype=np.int64),
        "p_name": np.array(
            [f"{COLORS[i % len(COLORS)]} {COLORS[(i * 7 + 3) % len(COLORS)]} "
             f"part {i}" for i in range(npart)], dtype=object),
        "p_mfgr": np.array([f"Manufacturer#{1 + i % 5}"
                            for i in rng.integers(0, 5, npart)], dtype=object),
        "p_brand": np.array([f"Brand#{11 + i % 45}"
                             for i in rng.integers(0, 45, npart)],
                            dtype=object),
        "p_type": type_full,
        "p_size": rng.integers(1, 51, npart).astype(np.int32),
        "p_container": np.array(CONTAINERS, dtype=object)[
            rng.integers(0, len(CONTAINERS), npart)],
        "p_retailprice": np.round(900 + (np.arange(1, npart + 1) % 1000)
                                  * 0.1, 2),
        "p_comment": _labels("part comment ", npart),
    }


def _partsupp(sf: float, seed: int) -> dict:
    rng = _rng("partsupp", seed)
    counts = table_rows(sf)
    npart, ns, nps = counts["part"], counts["supplier"], counts["partsupp"]
    ps_part = np.repeat(np.arange(1, npart + 1, dtype=np.int64), 4)
    ps_supp = np.empty(nps, dtype=np.int64)
    for j in range(4):
        ps_supp[j::4] = ((ps_part[j::4] + j * (ns // 4 + 1)) % ns) + 1
    return {
        "ps_partkey": ps_part,
        "ps_suppkey": ps_supp,
        "ps_availqty": rng.integers(1, 10_000, nps).astype(np.int32),
        "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, nps), 2),
        "ps_comment": _labels("ps comment ", nps),
    }


MAKERS = {"region": _region, "nation": _nation, "supplier": _supplier,
          "customer": _customer, "part": _part, "partsupp": _partsupp,
          "orders": _orders}


def generate(sf: float, seed: int, tables) -> dict[str, dict[str, np.ndarray]]:
    """{table: {column: array}} for each table in `tables` (any of the
    eight), the same for the same (sf, seed)."""
    unknown = set(tables) - set(STREAM)
    if unknown:
        raise ValueError(f"no generator for tables {sorted(unknown)}")
    out = {}
    orders = None
    for t in tables:
        if t in ("orders", "lineitem") and orders is None:
            orders = _orders(sf, seed)
        if t == "orders":
            out[t] = orders
        elif t == "lineitem":
            out[t] = _lineitem(sf, seed, orders)
        else:
            out[t] = MAKERS[t](sf, seed)
    return out
