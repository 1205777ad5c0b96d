"""The port's DDL and catalog UDFs, against the JAX package on the same
data_dir: CREATE/DROP VIEW, CREATE/DROP SEQUENCE with nextval/currval,
ALTER TABLE ADD/DROP/RENAME COLUMN, DROP TABLE, and the catalog UDFs.

The shapes are those of tests/test_views.py, test_sequences.py and the
ALTER cases of test_window_alter.py.  Each DDL is made by one package
and read by the other, in both directions: the catalog, the manifest's
column map and the stripes are one on-disk format.  A column added after
a stripe was written reads as NULL from it in every scan_pipeline mode.

Tolerance: 1e-9 relative on floats, exact on keys and counts.
"""

import pytest
import torch

import citus_tpu
import citus_tpu_torch
from oracle import compare_results

torch.set_num_threads(1)

TOL = 1e-9


def _jax(data_dir):
    return citus_tpu.connect(data_dir=data_dir, n_devices=1,
                             exec_cache_enabled=False,
                             compute_dtype="float64",
                             serving_result_cache_bytes=0)


def _port(data_dir, **settings):
    return citus_tpu_torch.connect(data_dir, device="cpu",
                                   compute_dtype="float64", **settings)


@pytest.fixture()
def pair(tmp_path):
    """A fresh data_dir per test: a JAX session with table vt, and the
    port over it."""
    data_dir = str(tmp_path / "d")
    j = _jax(data_dir)
    j.execute("create table vt (k bigint, g bigint, v double precision)")
    j.create_distributed_table("vt", "k", shard_count=4)
    j.execute("insert into vt values (1, 0, 1.5), (2, 0, 2.5), "
              "(3, 1, 10.0), (4, 1, 20.0), (5, 2, 7.0)")
    yield j, _port(data_dir), data_dir
    j.close()


def _same(j, p, sql, ordered=None):
    want = j.execute(sql).rows()
    got = p.execute(sql).rows()
    compare_results(got, want, "order by" in sql if ordered is None
                    else ordered, TOL)
    return got


def _same_error(j, p, sql):
    with pytest.raises(citus_tpu.CitusTpuError) as jerr:
        j.execute(sql)
    with pytest.raises(citus_tpu_torch.CitusTpuError) as perr:
        p.execute(sql)
    assert type(perr.value).__name__ == type(jerr.value).__name__, sql


# -- views ------------------------------------------------------------------

VIEWS = [
    "create view small as select k, v from vt where v < 8.0",
    "create view gsum (grp, total) as select g, sum(v) from vt group by g",
    "create view gsum_small as select grp, total from gsum where total < 10",
]
VIEW_READS = [
    "select k from small order by k",
    "select grp, total from gsum order by grp",
    "select vt.k, gsum.total from vt, gsum where vt.g = gsum.grp "
    "and vt.k <= 2 order by vt.k",
    "select grp, total from gsum_small order by grp",
    "select count(*) from vt where v < (select max(total) from gsum)",
]


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_views_made_by_one_package_read_by_the_other(pair, maker):
    j, p, _d = pair
    for sql in VIEWS:
        (j if maker == "jax" else p).execute(sql)
    for sql in VIEW_READS:
        _same(j, p, sql)
    # OR REPLACE by the maker, seen by the reader
    (j if maker == "jax" else p).execute(
        "create or replace view small as select k, v from vt where v < 3.0")
    got = _same(j, p, "select k from small order by k")
    assert [k for (k,) in got] == [1, 2]
    (p if maker == "jax" else j).execute("drop view gsum_small")
    _same_error(j, p, "select * from gsum_small")


def test_view_errors_match_jax(pair):
    j, p, _d = pair
    j.execute("create view small as select k from vt")
    for sql in ("create view small as select k from vt",
                "create view vt as select 1 from vt",
                "create view bad (a, b, c) as select k, v from vt",
                "drop view nosuch",
                "create table small (x bigint)",
                "create sequence small"):
        _same_error(j, p, sql)
    p.execute("drop view if exists nosuch")
    p.execute("create view rec1 as select k from vt")
    p.execute("create or replace view rec1 as select k from rec1")
    _same_error(j, p, "select * from rec1")


def test_view_over_a_window_and_a_sketch(pair):
    j, p, _d = pair
    p.execute("create view ranked as select k, g, rank() over "
              "(partition by g order by v desc) as r from vt")
    p.execute("create view est as select g, approx_count_distinct(k) "
              "as n from vt group by g")
    _same(j, p, "select k, r from ranked order by k")
    _same(j, p, "select g, n from est order by g")


# -- sequences --------------------------------------------------------------

def test_sequences_across_packages(pair):
    j, p, data_dir = pair
    p.execute("create sequence s1")
    assert p.execute("select nextval('s1')").rows() == [(1,)]
    assert p.execute("select nextval('s1')").rows() == [(2,)]
    assert p.execute("select currval('s1')").rows() == [(2,)]
    j.execute("create sequence s2 start with 100 increment by 10")
    assert p.execute("select nextval('s2')").rows() == [(100,)]
    # the persisted counter: the JAX package continues the port's
    j2 = _jax(data_dir)
    try:
        assert j2.execute("select nextval('s1')").rows() == [(3,)]
        assert j2.execute("select nextval('s2')").rows() == [(110,)]
    finally:
        j2.close()
    p2 = _port(data_dir)
    assert p2.execute("select nextval('s2')").rows() == [(120,)]


def test_sequence_errors_match_jax(pair):
    j, p, _d = pair
    p.execute("create sequence fresh start with 5 increment by 2")
    p.execute("create sequence d")
    j.execute("drop sequence d")
    p.execute("drop sequence if exists d")
    for sql in ("select currval('fresh')", "select nextval('d')",
                "drop sequence d", "create sequence vt",
                "select nextval('nosuch')"):
        _same_error(j, p, sql)
    p.execute("create sequence d")
    _same_error(j, p, "create sequence d")


# -- ALTER TABLE / DROP TABLE -----------------------------------------------

MODES = ("off", "host", "device")


@pytest.mark.parametrize("mode", MODES)
def test_added_column_reads_null_from_older_stripes(pair, mode):
    """ADD COLUMN by the port, rows with the column inserted by the JAX
    package, read by the port in each scan mode and by the JAX package."""
    j, p, data_dir = pair
    p.execute("alter table vt add column extra bigint")
    j.execute("insert into vt (k, g, v, extra) values (1000, 0, 5.0, 7)")
    reader = _port(data_dir, scan_pipeline=mode)
    for sql in ("select count(*), count(extra) from vt",
                "select count(extra), sum(extra) from vt",
                "select k from vt where extra = 7",
                "select k, extra from vt order by k",
                "select g, count(extra), sum(v) from vt group by g "
                "order by g"):
        want = j.execute(sql).rows()
        compare_results(reader.execute(sql).rows(), want,
                        "order by" in sql, TOL)
    assert reader.execute("select count(*), count(extra) from vt").rows() \
        == [(6, 1)]


def test_alter_by_jax_read_by_the_port(pair):
    j, p, _d = pair
    j.execute("insert into vt values (6, 1, 3.0)")
    j.execute("alter table vt add column extra bigint")
    j.execute("insert into vt (k, g, v, extra) values (1000, 0, 5.0, 7)")
    j.execute("alter table vt rename column v to val")
    _same(j, p, "select k, val, extra from vt order by k")
    j.execute("alter table vt drop column extra")
    j.execute("alter table vt add column extra bigint")
    got = _same(j, p, "select count(extra), sum(val) from vt")
    assert got[0][0] == 0  # the dropped column's values stay dead
    _same_error(j, p, "select v from vt")


def test_alter_by_the_port_read_by_jax(pair):
    j, p, data_dir = pair
    p.execute("alter table vt rename column v to val")
    p.execute("alter table vt rename column k to kk")
    assert p.catalog.table("vt").distribution_column == "kk"
    j2 = _jax(data_dir)
    try:
        assert j2.catalog.table("vt").distribution_column == "kk"
        j2.execute("insert into vt values (9, 2, 4.5)")
        _same(j2, _port(data_dir), "select kk, g, val from vt order by kk")
        # rename a to a2, then add a: the new a reads NULL, not a2's data
        p2 = _port(data_dir)
        p2.execute("alter table vt rename column g to g2")
        p2.execute("alter table vt add column g bigint")
        got = _same(j2, p2, "select kk, g, g2 from vt order by kk")
        assert [r[1] for r in got] == [None] * 6
        p2.execute("alter table vt drop column g2")
        p2.execute("alter table vt add column g2 bigint")
        got = _same(j2, p2, "select count(g2), count(*) from vt")
        assert got == [(0, 6)]
        assert _same(j2, p2, "select val from vt where kk = 9") == [(4.5,)]
    finally:
        j2.close()


def test_alter_errors_match_jax(pair):
    j, p, _d = pair
    for sql in ("alter table vt drop column k",
                "alter table vt drop column nosuch",
                "alter table vt add column v bigint",
                "alter table vt rename column nosuch to x",
                "alter table vt rename column g to v",
                "alter table nosuch add column x bigint",
                "alter table vt add column nn bigint not null"):
        _same_error(j, p, sql)
    p.execute("alter table vt drop column if exists nosuch")
    p.execute("alter table vt add column if not exists v bigint")


def test_drop_table_across_packages(pair):
    j, p, data_dir = pair
    p.execute("create table tmp_t (a bigint, b double precision)")
    p.execute("select create_distributed_table('tmp_t', 'a', 2)")
    j.execute("insert into tmp_t values (1, 1.5), (2, 2.5)")
    p2 = _port(data_dir)
    assert p2.execute("select count(*), sum(b) from tmp_t").rows() \
        == [(2, 4.0)]
    p2.execute("drop table tmp_t")
    _same_error(j, p2, "select * from tmp_t")
    _same_error(j, p2, "drop table tmp_t")
    p2.execute("drop table if exists tmp_t")
    assert not p2.catalog.has_table("tmp_t")


# -- the catalog UDFs -------------------------------------------------------

def test_catalog_udfs_match_jax(pair):
    j, p, data_dir = pair
    p.execute("create table r (a bigint, t text)")
    p.execute("select create_reference_table('r')")
    j.execute("insert into r values (1, 'x')")
    j2 = _jax(data_dir)
    try:
        for sql in ("select citus_tables()", "select citus_shards()",
                    "select citus_shards('vt')"):
            _same(j2, _port(data_dir), sql, ordered=True)
        # each package changes the shared catalog in turn
        want = [j2.execute("select citus_add_node('n2')").rows()]
        got = [p.execute("select citus_disable_node('n2')").rows()]
        want.append(j2.execute("select citus_activate_node('n2')").rows())
        got.append(p.execute("select citus_add_node('n3')").rows())
        assert got == want == [[(True,)], [(True,)]]
        j2.execute("select 1 from vt limit 1")  # reload the catalog
        assert sorted(n.name for n in p.catalog.nodes.values()) == \
            sorted(n.name for n in j2.catalog.nodes.values())
        _same_error(j2, p, "select citus_add_node('n2')")
        p.execute("select citus_remove_node('n3')")
        _same_error(j2, p, "select citus_remove_node('n3')")
    finally:
        j2.close()


# the stats and health UDFs are answered since the observability slice
# (tests/test_torch_stats.py), the workload, serving and replication
# UDFs since the concurrent-statements slice (tests/test_torch_wlm.py,
# _serving.py, _replication.py), the shard operations and job UDFs since
# the operations slice (tests/test_torch_operations.py,
# _background.py, _integrity.py), and the mesh UDFs since the mesh slice,
# which answer as the JAX package's do (tests/test_torch_mesh.py)
UNPORTED = ["citus_drain_device", "citus_rebalance_mesh",
            "citus_stat_mesh"]
MESH_UDF_ARGS = {"citus_drain_device": "0"}


def test_every_jax_udf_is_answered_or_named():
    """The port's answered UDFs and its refusals, by ROADMAP item, cover
    the JAX package's UDF list exactly."""
    from citus_tpu import session as jsession
    from citus_tpu_torch import session as psession

    answered = set(psession._UDFS)
    named = set(psession._UNPORTED_UDFS)
    assert not answered & named
    assert answered | named == set(jsession._UDFS)
    assert len(answered) == 44


@pytest.mark.parametrize("udf", UNPORTED)
def test_udfs_of_unported_modules_are_refused(pair, udf):
    j, p, _d = pair
    sql = f"select {udf}({MESH_UDF_ARGS.get(udf, '')})"
    outcome = []
    for sess in (j, p):
        try:
            r = sess.execute(sql)
            outcome.append((r.column_names, r.rows()[0][:5]))
        except Exception as e:  # the error's kind is the outcome compared
            outcome.append(type(e).__name__)
    assert outcome[0] == outcome[1]
    assert udf != "citus_drain_device" or outcome[1] == "CatalogError"


def test_show_all_lists_the_fast_path_settings(pair):
    _j, p, _d = pair
    got = dict(p.execute("show all").rows())
    for name in ("enable_fast_path_router", "enable_point_lookup_index",
                 "fast_path_max_rows"):
        assert name in got
    assert got["fast_path_max_rows"] == "65536"
