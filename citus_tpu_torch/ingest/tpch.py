"""dbgen-lite: seeded TPC-H-shaped data generation + schema DDL + queries.

A copy of citus_tpu/ingest/tpch.py: the same seed gives the same rows
in both packages.  Generates the 8 TPC-H tables at a given scale factor
directly into a Session (or as numpy columns), with the real schema, key
relationships (PK-FK integrity), and value distributions close enough
for planner/bench work.  Mirrors the role of the reference's TPC-H test data loads
(src/test/regress/sql/multi_*tpch*.sql use dbgen samples).

Row counts at SF=1 match dbgen: lineitem ≈ 6M, orders 1.5M, customer
150k, part 200k, partsupp 800k, supplier 10k, nation 25, region 5.
"""

from __future__ import annotations

import numpy as np

SCHEMAS = {
    "region": """create table region (
        r_regionkey int, r_name text, r_comment text)""",
    "nation": """create table nation (
        n_nationkey int, n_name text, n_regionkey int, n_comment text)""",
    "supplier": """create table supplier (
        s_suppkey bigint, s_name text, s_address text, s_nationkey int,
        s_phone text, s_acctbal double precision, s_comment text)""",
    "customer": """create table customer (
        c_custkey bigint, c_name text, c_address text, c_nationkey int,
        c_phone text, c_acctbal double precision, c_mktsegment text,
        c_comment text)""",
    "part": """create table part (
        p_partkey bigint, p_name text, p_mfgr text, p_brand text,
        p_type text, p_size int, p_container text,
        p_retailprice double precision, p_comment text)""",
    "partsupp": """create table partsupp (
        ps_partkey bigint, ps_suppkey bigint, ps_availqty int,
        ps_supplycost double precision, ps_comment text)""",
    "orders": """create table orders (
        o_orderkey bigint, o_custkey bigint, o_orderstatus text,
        o_totalprice double precision, o_orderdate date,
        o_orderpriority text, o_clerk text, o_shippriority int,
        o_comment text)""",
    "lineitem": """create table lineitem (
        l_orderkey bigint, l_partkey bigint, l_suppkey bigint,
        l_linenumber int, l_quantity double precision,
        l_extendedprice double precision, l_discount double precision,
        l_tax double precision, l_returnflag text, l_linestatus text,
        l_shipdate date, l_commitdate date, l_receiptdate date,
        l_shipinstruct text, l_shipmode text, l_comment text)""",
}

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [  # (name, regionkey) — the real 25
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

_EPOCH_1992 = 8035   # days('1992-01-01')
_ORDER_DATE_RANGE = 2406  # through 1998-08-02


def table_rows(sf: float) -> dict[str, int]:
    return {
        "region": 5,
        "nation": 25,
        "supplier": max(int(10_000 * sf), 10),
        "customer": max(int(150_000 * sf), 30),
        "part": max(int(200_000 * sf), 40),
        "partsupp": max(int(200_000 * sf), 40) * 4,
        "orders": max(int(1_500_000 * sf), 150),
        # lineitems: 1..7 per order, avg ≈ 4
    }


def generate_tables(sf: float, seed: int = 0) -> dict[str, dict[str, np.ndarray]]:
    """→ {table: {column: np array}} with str columns as python-object arrays."""
    rng = np.random.default_rng(seed)
    counts = table_rows(sf)
    out: dict[str, dict[str, np.ndarray]] = {}

    out["region"] = {
        "r_regionkey": np.arange(5, dtype=np.int32),
        "r_name": np.array(REGIONS, dtype=object),
        "r_comment": np.array([f"region comment {i}" for i in range(5)],
                              dtype=object),
    }
    out["nation"] = {
        "n_nationkey": np.arange(25, dtype=np.int32),
        "n_name": np.array([n for n, _ in NATIONS], dtype=object),
        "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int32),
        "n_comment": np.array([f"nation comment {i}" for i in range(25)],
                              dtype=object),
    }

    ns = counts["supplier"]
    out["supplier"] = {
        "s_suppkey": np.arange(1, ns + 1, dtype=np.int64),
        "s_name": np.array([f"Supplier#{i:09d}" for i in range(1, ns + 1)],
                           dtype=object),
        "s_address": np.array([f"addr s{i}" for i in range(ns)], dtype=object),
        "s_nationkey": rng.integers(0, 25, ns).astype(np.int32),
        "s_phone": np.array([f"{i % 35 + 10}-{i % 999:03d}" for i in range(ns)],
                            dtype=object),
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, ns), 2),
        "s_comment": np.array([f"supplier comment {i}" for i in range(ns)],
                              dtype=object),
    }

    nc = counts["customer"]
    out["customer"] = {
        "c_custkey": np.arange(1, nc + 1, dtype=np.int64),
        "c_name": np.array([f"Customer#{i:09d}" for i in range(1, nc + 1)],
                           dtype=object),
        "c_address": np.array([f"addr c{i}" for i in range(nc)], dtype=object),
        "c_nationkey": rng.integers(0, 25, nc).astype(np.int32),
        "c_phone": np.array([f"{i % 35 + 10}-{i % 999:03d}"
                             for i in range(nc)], dtype=object),
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, nc), 2),
        "c_mktsegment": np.array([SEGMENTS[i] for i in
                                  rng.integers(0, 5, nc)], dtype=object),
        "c_comment": np.array([f"customer comment {i}" for i in range(nc)],
                              dtype=object),
    }

    npart = counts["part"]
    type_full = np.array(
        [f"{TYPES_1[a]} {TYPES_2[b]} {TYPES_3[c]}"
         for a, b, c in zip(rng.integers(0, 6, npart),
                            rng.integers(0, 5, npart),
                            rng.integers(0, 5, npart))], dtype=object)
    out["part"] = {
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
        "p_container": np.array([CONTAINERS[i] for i in
                                 rng.integers(0, len(CONTAINERS), npart)],
                                dtype=object),
        "p_retailprice": np.round(900 + (np.arange(1, npart + 1) % 1000)
                                  * 0.1, 2),
        "p_comment": np.array([f"part comment {i}" for i in range(npart)],
                              dtype=object),
    }

    nps = counts["partsupp"]
    ps_part = np.repeat(np.arange(1, npart + 1, dtype=np.int64), 4)
    ps_supp = np.empty(nps, dtype=np.int64)
    for j in range(4):
        ps_supp[j::4] = ((ps_part[j::4] + j * (ns // 4 + 1)) % ns) + 1
    out["partsupp"] = {
        "ps_partkey": ps_part,
        "ps_suppkey": ps_supp,
        "ps_availqty": rng.integers(1, 10_000, nps).astype(np.int32),
        "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, nps), 2),
        "ps_comment": np.array([f"ps comment {i}" for i in range(nps)],
                               dtype=object),
    }

    no = counts["orders"]
    # dbgen: order keys are sparse (1 of every 4 key slots ×8 used); keep
    # them sparse to exercise sparse-key joins
    okey = (np.arange(no, dtype=np.int64) * 4) + 1
    odate = _EPOCH_1992 + rng.integers(0, _ORDER_DATE_RANGE, no)
    out["orders"] = {
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
        "o_comment": np.array([f"order comment {i}" for i in range(no)],
                              dtype=object),
    }

    per_order = rng.integers(1, 8, no)
    nl = int(per_order.sum())
    l_okey = np.repeat(okey, per_order)
    l_odate = np.repeat(odate, per_order)
    # 1..k within each order, vectorized (global iota minus segment start)
    starts = np.cumsum(per_order) - per_order
    linenumber = np.arange(nl) - np.repeat(starts, per_order) + 1
    qty = rng.integers(1, 51, nl).astype(np.float64)
    pkey = rng.integers(1, npart + 1, nl).astype(np.int64)
    price_base = 900 + (pkey % 1000) * 0.1
    extended = np.round(price_base * qty, 2)
    ship_delta = rng.integers(1, 122, nl)
    commit_delta = rng.integers(30, 91, nl)
    receipt_delta = rng.integers(1, 31, nl)
    shipdate = (l_odate + ship_delta).astype(np.int32)
    returnflag = np.where(
        shipdate <= _EPOCH_1992 + 1277,  # ~ receiptdate cutoffs
        np.array(["R", "A"], dtype=object)[rng.integers(0, 2, nl)],
        "N")
    linestatus = np.where(shipdate > _EPOCH_1992 + 1656, "O", "F")
    supp_for_part = ((pkey + rng.integers(0, 4, nl) * (ns // 4 + 1)) % ns) + 1
    out["lineitem"] = {
        "l_orderkey": l_okey,
        "l_partkey": pkey,
        "l_suppkey": supp_for_part.astype(np.int64),
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
        "l_comment": np.array([f"li {i}" for i in range(nl)], dtype=object),
    }
    return out


DISTRIBUTION = {
    # (distribution column, colocate_with) — lineitem⋈orders colocated on
    # orderkey; partsupp⋈part colocated on partkey — the classic Citus
    # TPC-H layout
    "lineitem": ("l_orderkey", None),
    "orders": ("o_orderkey", "lineitem"),
    "customer": ("c_custkey", None),
    "part": ("p_partkey", None),
    "partsupp": ("ps_partkey", "part"),
    "supplier": ("s_suppkey", None),
}
REFERENCE_TABLES = ["region", "nation"]


def load_into_session(session, sf: float = 0.001, seed: int = 0,
                      shard_count: int | None = None,
                      tables: set[str] | None = None) -> dict[str, int]:
    """Create, distribute and load all 8 tables; returns row counts.
    `tables` restricts which tables get DATA (schemas always exist)."""
    return load_tables(session, generate_tables(sf, seed), shard_count,
                       tables)


def load_tables(session, data: dict, shard_count: int | None = None,
                tables: set[str] | None = None) -> dict[str, int]:
    """The DDL, distribution and ingest half of load_into_session over
    already generated `data` (generate_tables' output), so a caller can
    keep the arrays as an independent reference."""
    from .copy_from import _ingest_batch

    counts = {}
    for table, ddl in SCHEMAS.items():
        session.execute(ddl)
    for table, (dist_col, colocate) in DISTRIBUTION.items():
        session.create_distributed_table(table, dist_col,
                                         shard_count=shard_count,
                                         colocate_with=colocate)
    for table in REFERENCE_TABLES:
        session.create_reference_table(table)
    if tables is not None:
        data = {t: cols for t, cols in data.items()
                if t in tables or t in REFERENCE_TABLES}
    for table, cols in data.items():
        names = list(cols.keys())
        # numeric columns pass through as numpy (zero-copy ingest fast
        # path); object (string) columns go as lists for interning
        batch = [list(cols[c]) if cols[c].dtype == object else cols[c]
                 for c in names]
        counts[table] = _ingest_batch(session, table, names, batch,
                                      pre_typed=True)[0]
    return counts


# -- the benchmark query texts (BASELINE.md configs) -----------------------

Q1 = """
select l_returnflag, l_linestatus,
       sum(l_quantity) as sum_qty,
       sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
       avg(l_quantity) as avg_qty,
       avg(l_extendedprice) as avg_price,
       avg(l_discount) as avg_disc,
       count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""

Q3 = """
select l_orderkey,
       sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING'
  and c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
"""

Q5 = """
select n_name,
       sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey
  and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey
  and n_regionkey = r_regionkey
  and r_name = 'ASIA'
  and o_orderdate >= date '1994-01-01'
  and o_orderdate < date '1994-01-01' + interval '1' year
group by n_name
order by revenue desc
"""

Q6 = """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval '1' year
  and l_discount between 0.05 and 0.07
  and l_quantity < 24
"""

Q9 = """
select nation, o_year, sum(amount) as sum_profit
from (
    select n_name as nation,
           extract(year from o_orderdate) as o_year,
           l_extendedprice * (1 - l_discount)
             - ps_supplycost * l_quantity as amount
    from part, supplier, lineitem, partsupp, orders, nation
    where s_suppkey = l_suppkey
      and ps_suppkey = l_suppkey
      and ps_partkey = l_partkey
      and p_partkey = l_partkey
      and o_orderkey = l_orderkey
      and s_nationkey = n_nationkey
      and p_name like '%green%'
) as profit
group by nation, o_year
order by nation, o_year desc
"""

Q7 = """
select supp_nation, cust_nation, l_year, sum(volume) as revenue
from (select n1.n_name as supp_nation, n2.n_name as cust_nation,
             extract(year from l_shipdate) as l_year,
             l_extendedprice * (1 - l_discount) as volume
      from supplier, lineitem, orders, customer, nation n1, nation n2
      where s_suppkey = l_suppkey and o_orderkey = l_orderkey
        and c_custkey = o_custkey and s_nationkey = n1.n_nationkey
        and c_nationkey = n2.n_nationkey
        and ((n1.n_name = 'FRANCE' and n2.n_name = 'GERMANY')
          or (n1.n_name = 'GERMANY' and n2.n_name = 'FRANCE'))
        and l_shipdate >= date '1995-01-01'
        and l_shipdate <= date '1996-12-31') shipping
group by supp_nation, cust_nation, l_year
order by supp_nation, cust_nation, l_year
"""

Q8 = """
select o_year,
       sum(case when nation = 'BRAZIL' then volume else 0 end)
         / sum(volume) as mkt_share
from (select extract(year from o_orderdate) as o_year,
             l_extendedprice * (1 - l_discount) as volume,
             n2.n_name as nation
      from part, supplier, lineitem, orders, customer,
           nation n1, nation n2, region
      where p_partkey = l_partkey and s_suppkey = l_suppkey
        and l_orderkey = o_orderkey and o_custkey = c_custkey
        and c_nationkey = n1.n_nationkey
        and n1.n_regionkey = r_regionkey and r_name = 'AMERICA'
        and s_nationkey = n2.n_nationkey
        and o_orderdate >= date '1995-01-01'
        and o_orderdate <= date '1996-12-31'
        and p_type = 'ECONOMY ANODIZED STEEL') all_nations
group by o_year
order by o_year
"""

Q10 = """
select c_custkey, c_name,
       sum(l_extendedprice * (1 - l_discount)) as revenue,
       c_acctbal, n_name, c_address, c_phone, c_comment
from customer, orders, lineitem, nation
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate >= date '1993-10-01'
  and o_orderdate < date '1993-10-01' + interval '3' month
  and l_returnflag = 'R' and c_nationkey = n_nationkey
group by c_custkey, c_name, c_acctbal, c_phone, n_name, c_address,
         c_comment
order by revenue desc, c_custkey
limit 20
"""

Q12 = """
select l_shipmode,
       sum(case when o_orderpriority = '1-URGENT'
                  or o_orderpriority = '2-HIGH'
                then 1 else 0 end) as high_line_count,
       sum(case when o_orderpriority <> '1-URGENT'
                 and o_orderpriority <> '2-HIGH'
                then 1 else 0 end) as low_line_count
from orders, lineitem
where o_orderkey = l_orderkey and l_shipmode in ('MAIL', 'SHIP')
  and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
  and l_receiptdate >= date '1994-01-01'
  and l_receiptdate < date '1994-01-01' + interval '1' year
group by l_shipmode
order by l_shipmode
"""

Q14 = """
select 100.00 * sum(case when p_type like 'PROMO%'
                         then l_extendedprice * (1 - l_discount)
                         else 0 end)
       / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
from lineitem, part
where l_partkey = p_partkey
  and l_shipdate >= date '1995-09-01'
  and l_shipdate < date '1995-09-01' + interval '1' month
"""

Q11 = """
select ps_partkey, sum(ps_supplycost * ps_availqty) as value
from partsupp, supplier, nation
where ps_suppkey = s_suppkey
  and s_nationkey = n_nationkey
  and n_name = 'GERMANY'
group by ps_partkey
having sum(ps_supplycost * ps_availqty) > (
    select sum(ps_supplycost * ps_availqty) * 0.0001
    from partsupp, supplier, nation
    where ps_suppkey = s_suppkey
      and s_nationkey = n_nationkey
      and n_name = 'GERMANY')
order by value desc
"""

Q13 = """
select c_count, count(*) as custdist
from (select c_custkey, count(o_orderkey) as c_count
      from customer left outer join orders
           on c_custkey = o_custkey
           and o_comment not like '%special%requests%'
      group by c_custkey) as c_orders
group by c_count
order by custdist desc, c_count desc
"""

# Q15 in CTE form (one statement).  The spec's standard form CREATEs the
# revenue0 view first; test_views.py runs that form through CREATE VIEW.
Q15 = """
with revenue0 as (
  select l_suppkey as supplier_no,
         sum(l_extendedprice * (1 - l_discount)) as total_revenue
  from lineitem
  where l_shipdate >= date '1996-01-01'
    and l_shipdate < date '1996-01-01' + interval '3' month
  group by l_suppkey)
select s_suppkey, s_name, s_address, s_phone, total_revenue
from supplier, revenue0
where s_suppkey = supplier_no
  and total_revenue = (select max(total_revenue) from revenue0)
order by s_suppkey
"""

Q16 = """
select p_brand, p_type, p_size, count(distinct ps_suppkey) as supplier_cnt
from partsupp, part
where p_partkey = ps_partkey
  and p_brand <> 'Brand#45'
  and p_type not like 'MEDIUM POLISHED%'
  and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
  and ps_suppkey not in (
      select s_suppkey from supplier
      where s_comment like '%Customer%Complaints%')
group by p_brand, p_type, p_size
order by supplier_cnt desc, p_brand, p_type, p_size
"""

Q18 = """
select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
       sum(l_quantity)
from customer, orders, lineitem
where o_orderkey in (select l_orderkey from lineitem
                     group by l_orderkey having sum(l_quantity) > 212)
  and c_custkey = o_custkey and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate, o_orderkey
limit 100
"""

# Q19 in the standard factored form (join predicate outside the OR; the
# textbook text repeats `p_partkey = l_partkey` inside each branch)
Q19 = """
select sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem, part
where p_partkey = l_partkey
  and ((p_brand = 'Brand#12'
        and p_container in ('SM CASE', 'SM BOX')
        and l_quantity >= 1 and l_quantity <= 11
        and p_size between 1 and 5
        and l_shipmode in ('AIR', 'REG AIR')
        and l_shipinstruct = 'DELIVER IN PERSON')
    or (p_brand = 'Brand#23'
        and p_container in ('MED BAG', 'MED BOX')
        and l_quantity >= 10 and l_quantity <= 20
        and p_size between 1 and 10
        and l_shipmode in ('AIR', 'REG AIR')
        and l_shipinstruct = 'DELIVER IN PERSON')
    or (p_brand = 'Brand#34'
        and p_container in ('LG CASE', 'LG BOX')
        and l_quantity >= 20 and l_quantity <= 30
        and p_size between 1 and 15
        and l_shipmode in ('AIR', 'REG AIR')
        and l_shipinstruct = 'DELIVER IN PERSON'))
"""

# -- correlated-subquery queries (decorrelated into semi/anti joins and
#    grouped derived tables by planner/decorrelate.py) ----------------------

Q2 = """
select s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address,
       s_phone, s_comment
from part, supplier, partsupp, nation, region
where p_partkey = ps_partkey
  and s_suppkey = ps_suppkey
  and p_size = 15
  and p_type like '%BRASS'
  and s_nationkey = n_nationkey
  and n_regionkey = r_regionkey
  and r_name = 'EUROPE'
  and ps_supplycost = (
      select min(ps_supplycost)
      from partsupp, supplier, nation, region
      where p_partkey = ps_partkey
        and s_suppkey = ps_suppkey
        and s_nationkey = n_nationkey
        and n_regionkey = r_regionkey
        and r_name = 'EUROPE')
order by s_acctbal desc, n_name, s_name, p_partkey
limit 100
"""

Q4 = """
select o_orderpriority, count(*) as order_count
from orders
where o_orderdate >= date '1993-07-01'
  and o_orderdate < date '1993-07-01' + interval '3' month
  and exists (
      select 1 from lineitem
      where l_orderkey = o_orderkey
        and l_commitdate < l_receiptdate)
group by o_orderpriority
order by o_orderpriority
"""

Q17 = """
select sum(l_extendedprice) / 7.0 as avg_yearly
from lineitem, part
where p_partkey = l_partkey
  and p_brand = 'Brand#23'
  and p_container = 'MED BOX'
  and l_quantity < (
      select 0.2 * avg(l_quantity)
      from lineitem
      where l_partkey = p_partkey)
"""

Q20 = """
select s_name, s_address
from supplier, nation
where s_suppkey in (
      select ps_suppkey
      from partsupp
      where ps_partkey in (select p_partkey from part
                           where p_name like 'forest%')
        and ps_availqty > (
            select 0.5 * sum(l_quantity)
            from lineitem
            where l_partkey = ps_partkey
              and l_suppkey = ps_suppkey
              and l_shipdate >= date '1994-01-01'
              and l_shipdate < date '1994-01-01' + interval '1' year))
  and s_nationkey = n_nationkey
  and n_name = 'CANADA'
order by s_name
"""

Q21 = """
select s_name, count(*) as numwait
from supplier, lineitem l1, orders, nation
where s_suppkey = l1.l_suppkey
  and o_orderkey = l1.l_orderkey
  and o_orderstatus = 'F'
  and l1.l_receiptdate > l1.l_commitdate
  and exists (
      select 1 from lineitem l2
      where l2.l_orderkey = l1.l_orderkey
        and l2.l_suppkey <> l1.l_suppkey)
  and not exists (
      select 1 from lineitem l3
      where l3.l_orderkey = l1.l_orderkey
        and l3.l_suppkey <> l1.l_suppkey
        and l3.l_receiptdate > l3.l_commitdate)
  and s_nationkey = n_nationkey
  and n_name = 'SAUDI ARABIA'
group by s_name
order by numwait desc, s_name
limit 100
"""

Q22 = """
select cntrycode, count(*) as numcust, sum(c_acctbal) as totacctbal
from (select substring(c_phone from 1 for 2) as cntrycode, c_acctbal
      from customer
      where substring(c_phone from 1 for 2) in
            ('13', '31', '23', '29', '30', '18', '17')
        and c_acctbal > (select avg(c_acctbal) from customer
                         where c_acctbal > 0.00
                           and substring(c_phone from 1 for 2) in
                               ('13', '31', '23', '29', '30', '18', '17'))
        and not exists (select 1 from orders
                        where o_custkey = c_custkey)) as custsale
group by cntrycode
order by cntrycode
"""

QUERIES = {"Q1": Q1, "Q2": Q2, "Q3": Q3, "Q4": Q4, "Q5": Q5, "Q6": Q6,
           "Q7": Q7, "Q8": Q8, "Q9": Q9, "Q10": Q10, "Q11": Q11,
           "Q12": Q12, "Q13": Q13, "Q14": Q14, "Q15": Q15, "Q16": Q16,
           "Q17": Q17, "Q18": Q18, "Q19": Q19, "Q20": Q20, "Q21": Q21,
           "Q22": Q22}
