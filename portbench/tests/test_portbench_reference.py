"""The frozen generator, each plain reference against sqlite over the
same arrays, and the control: the reference computed in bfloat16 in the
program's place must come out as not correct."""

import sqlite3

import numpy as np
import pytest
from conftest import TINY_SF

from portbench import spec
from portbench.datagen import tpch_gen

QUERIES = ("q3", "rollup_orderkey")


def reference(name):
    return spec.load_module(f"{spec.BENCH_DIR}/reference/{name}.py",
                            "reference")


def sql_text(name):
    with open(f"{spec.BENCH_DIR}/queries/{name}.sql") as f:
        return f.read()


@pytest.fixture(scope="module")
def data():
    return tpch_gen.generate(TINY_SF, 2**31 + 17,
                             ["customer", "orders", "lineitem"])


def test_generator_is_seeded_and_sized():
    a = tpch_gen.generate(0.002, 5, ["lineitem", "customer"])
    b = tpch_gen.generate(0.002, 5, ["customer", "lineitem"])
    c = tpch_gen.generate(0.002, 6, ["lineitem"])
    for t in a:
        for col in a[t]:
            assert np.array_equal(a[t][col], b[t][col]), (t, col)
    assert not np.array_equal(a["lineitem"]["l_quantity"],
                              c["lineitem"]["l_quantity"])
    # the same sizes for every seed: the values differ, the shape not
    assert np.array_equal(a["lineitem"]["l_orderkey"],
                          c["lineitem"]["l_orderkey"])
    rows = tpch_gen.table_rows(0.002)
    assert len(a["customer"]["c_custkey"]) == rows["customer"]
    assert 1 * rows["orders"] <= len(a["lineitem"]["l_orderkey"]) \
        <= 7 * rows["orders"]


@pytest.mark.parametrize("table", sorted(tpch_gen.STREAM))
def test_every_table_generates(table):
    cols = tpch_gen.generate(0.002, 3, [table])[table]
    assert len({len(v) for v in cols.values()}) == 1


def sqlite_rows(data, sql):
    """The query in sqlite over the same arrays (dates as day numbers,
    the literal date rewritten to its day number)."""
    db = sqlite3.connect(":memory:")
    for t, cols in data.items():
        names = list(cols)
        db.execute(f"create table {t} ({', '.join(names)})")
        rows = zip(*[cols[c].tolist() for c in names])
        db.executemany(f"insert into {t} values "
                       f"({', '.join('?' * len(names))})", rows)
    sql = sql.replace("date '1995-03-15'", "9204")
    return db.execute(sql).fetchall()


def test_q3_reference_matches_sqlite(data):
    ref = reference("q3")
    want = sqlite_rows(data, sql_text("q3"))
    t = ref.truth(data)
    got = ref.evaluate(data, "float64", "cpu")
    assert len(want) == ref.rows(t) == len(got[0]) == 10
    for i, (k, rev, d, p) in enumerate(want):
        assert int(got[0][i]) == k and int(got[2][i]) == d
        assert int(got[3][i]) == p
        assert got[1][i] == pytest.approx(rev, rel=1e-12)
        assert t["top_rev"][i] == pytest.approx(rev, rel=1e-12)


def test_rollup_reference_matches_sqlite(data):
    ref = reference("rollup_orderkey")
    want = sorted(sqlite_rows(data, sql_text("rollup_orderkey")))
    t = ref.truth(data)
    assert [r[0] for r in want] == t["keys"].tolist()
    assert [r[1] for r in want] == t["count"].tolist()
    assert [float(r[2]) for r in want] == t["sum"].tolist()


@pytest.mark.parametrize("name", QUERIES)
def test_reference_in_float64_reads_nought(data, name):
    ref = reference(name)
    readings = ref.compare(ref.evaluate(data, "float64", "cpu"),
                           ref.truth(data))
    assert set(readings) == set(ref.LIMITS)
    assert all(v == 0 for v in readings.values()), readings


@pytest.mark.parametrize("name", QUERIES)
def test_control_in_bfloat16_is_not_correct(data, name):
    """The reference in the program's place at the nearest precision
    below float32 fails at least one limit."""
    ref = reference(name)
    readings = ref.compare(ref.evaluate(data, "bfloat16", "cpu"),
                           ref.truth(data))
    over = {k: v for k, v in readings.items() if v > ref.LIMITS[k]}
    assert over, readings


def test_q3_compare_reads_dates_in_every_form(data):
    ref = reference("q3")
    t = ref.truth(data)
    cols = ref.evaluate(data, "float64", "cpu")
    iso = np.array([str(np.datetime64(int(d), "D")) for d in cols[2]],
                   dtype=object)
    as_dt = cols[2].astype("datetime64[D]")
    for dates in (iso, as_dt):
        assert ref.compare([cols[0], cols[1], dates, cols[3]], t) == {
            "q3_gap": 0.0}


def test_q3_gap_reads_structural_faults_as_one(data):
    ref = reference("q3")
    t = ref.truth(data)
    cols = ref.evaluate(data, "float64", "cpu")
    swapped = [c.copy() for c in cols]
    for c in swapped:
        c[[0, 1]] = c[[1, 0]]
    assert 0 < ref.compare(swapped, t)["q3_gap"] < 1
    short = [c[:9] for c in cols]
    wrong_day = [cols[0], cols[1], cols[2] + 1, cols[3]]
    for bad in (short, wrong_day):
        assert ref.compare(bad, t) == {"q3_gap": 1.0}


def test_rollup_err_counts_missing_and_extra_groups(data):
    ref = reference("rollup_orderkey")
    t = ref.truth(data)
    cols = ref.evaluate(data, "float64", "cpu")
    assert ref.compare(cols, t) == {"rollup_err": 0.0}
    missing = [c[1:] for c in cols]
    assert ref.compare(missing, t)["rollup_err"] == \
        t["count"][0] + t["sum"][0]
    extra = [np.append(cols[0], 3), np.append(cols[1], 2),
             np.append(cols[2], 9.0)]
    assert ref.compare(extra, t)["rollup_err"] == 11.0
    twice = [np.append(c, c[:1]) for c in cols]
    assert ref.compare(twice, t)["rollup_err"] >= t["count"][0]
