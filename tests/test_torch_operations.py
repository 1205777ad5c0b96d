"""The port's shard operations (citus_tpu_torch/operations/) against the
JAX package's, on CPU torch in float64.

* Split, tenant isolation (integer and text keys), a move and a
  rebalance run by each package on copies of one JAX-written TPC-H
  data_dir: the catalog's shard rows (ids, ranges, placements) are
  equal, every shard's row set is equal, every child holds only rows of
  its token range, and the tables equal sqlite (tests/oracle.py).
* Each package opens the other's result and answers Q1 and Q3 alike.
* A restore point made by one package is restored by the other.
* A crash at `operations.shard_split` leaves registry records and
  half-written children; the next open of either package sweeps them.
* A split writes only live rows, gives the children mirror copies
  under replication factor 2, and leaves the point index to rebuild.
* A follower refuses the mutating UDFs; the 13 UDFs answer.

The JAX sessions run on its single-device configuration (`n_devices=1`,
no executable cache) with their maintenance duties off.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu.ingest import tpch as jtpch
from citus_tpu.operations import restore_point as jrestore
from citus_tpu_torch.catalog.distribution import hash_token
from citus_tpu_torch.errors import CatalogError, ReadOnlyReplica
from citus_tpu_torch.operations import restore_point as prestore
from citus_tpu_torch.operations.cleanup import CleanupRegistry
from citus_tpu_torch.replication import provision_replica
from citus_tpu_torch.storage import integrity
from citus_tpu_torch.storage.dictionary import string_hash_token
from citus_tpu_torch.utils import faultinjection as pfi

from oracle import make_oracle

torch.set_num_threads(1)

SF, SEED = 0.002, 3
_COMMON = dict(compute_dtype="float64", columnar_stripe_row_limit=1000,
               serving_result_cache_bytes=0, retry_backoff_base_ms=1,
               rebalance_improvement_threshold=0.05)
TENANTS = 7


def _jax(d, **kw):
    return citus_tpu.connect(data_dir=str(d), n_devices=1,
                             exec_cache_enabled=False,
                             recover_2pc_interval_ms=-1,
                             defer_shard_delete_interval_ms=-1,
                             health_check_interval_ms=-1,
                             **{**_COMMON, **kw})


def _port(d, **kw):
    return citus_tpu_torch.connect(str(d), device="cpu",
                                   **{**_COMMON, **kw})


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A JAX-written data_dir: TPC-H (8 shards, 1,000-row stripes) and a
    text-distributed `logs` table."""
    d = str(tmp_path_factory.mktemp("torch_ops") / "base")
    s = _jax(d)
    jtpch.load_into_session(s, sf=SF, seed=SEED, shard_count=8)
    s.execute("create table logs (tenant text, n bigint)")
    s.execute("select create_distributed_table('logs', 'tenant', 4)")
    s.execute("insert into logs values " + ", ".join(
        f"('tenant{i % TENANTS}', {i})" for i in range(100)))
    s.close()
    return d


@pytest.fixture(scope="module")
def oracle():
    data = jtpch.generate_tables(SF, SEED)
    return make_oracle(data, {
        "orders": ["o_orderdate"],
        "lineitem": ["l_shipdate", "l_commitdate", "l_receiptdate"]})


def _copy(base, tmp_path, name):
    d = str(tmp_path / name)
    shutil.copytree(base, d)
    return d


def _first_shard_mid(sess, table="lineitem"):
    sh = sess.catalog.table_shards(table)[0]
    return sh.shard_id, (sh.min_value + sh.max_value) // 2


# each operation as SQL over a session (the same text for both packages)
def _op_split(s):
    sid, mid = _first_shard_mid(s)
    return s.execute(f"select citus_split_shard_by_split_points({sid}, "
                     f"'{mid}')").rows()


def _op_isolate(s):
    return s.execute("select isolate_tenant_to_node('orders', 7)").rows()


def _op_isolate_text(s):
    return s.execute(
        "select isolate_tenant_to_node('logs', 'tenant3')").rows()


def _op_move(s):
    s.execute("select citus_add_node('device:1')")
    sid = s.catalog.table_shards("orders")[2].shard_id
    return s.execute(f"select citus_move_shard_placement({sid}, "
                     "'device:1')").rows()


def _op_rebalance(s):
    s.execute("select citus_add_node('device:1')")
    return s.execute("select rebalance_table_shards()").rows()


OPS = {"split": _op_split, "isolate": _op_isolate,
       "isolate_text": _op_isolate_text, "move": _op_move,
       "rebalance": _op_rebalance}
TABLES = ("lineitem", "orders", "customer", "logs", "nation")


def _shard_rows(sess):
    """{table: [(shard_id, index, min, max, placements)]}: the catalog's
    shard rows."""
    out = {}
    for t in TABLES:
        out[t] = [(s.shard_id, s.shard_index, s.min_value, s.max_value,
                   sorted((p.placement_id, p.node_id, p.shard_state)
                          for p in sess.catalog.all_shard_placements(
                              s.shard_id)))
                  for s in sess.catalog.table_shards(t)]
    return out


def _row_sets(sess):
    """{(table, shard_id): sorted rows} over every shard's live rows."""
    out = {}
    for t in TABLES:
        names = sess.catalog.table(t).schema.names
        for s in sess.catalog.table_shards(t):
            vals, valid, n = sess.store.read_shard(t, s.shard_id, names)
            cols = []
            for c in names:
                v = vals[c]
                v = (sess.store.dictionary(t, c).decode_array(v)
                     if t == "logs" and c == "tenant" else v.tolist())
                cols.append([x if ok else None
                             for x, ok in zip(v, valid[c])])
            out[(t, s.shard_id)] = sorted(zip(*cols), key=repr)
    return out


@pytest.fixture(scope="module")
def ran(base, tmp_path_factory):
    """{op: {pkg: (data_dir, udf rows, shard rows, row sets)}}."""
    root = tmp_path_factory.mktemp("torch_ops_runs")
    out = {}
    for op, fn in OPS.items():
        out[op] = {}
        for pkg, mk in (("jax", _jax), ("port", _port)):
            d = str(root / f"{op}_{pkg}")
            shutil.copytree(base, d)
            s = mk(d)
            got = fn(s)
            out[op][pkg] = (d, got, _shard_rows(s), _row_sets(s))
            s.close()
    return out


@pytest.mark.parametrize("op", sorted(OPS))
def test_operation_catalog_rows_match_jax(ran, op):
    (_jd, jgot, jrows, _js), (_pd, pgot, prows, _ps) = (
        ran[op]["jax"], ran[op]["port"])
    assert pgot == jgot
    assert prows == jrows
    if op in ("split", "isolate", "isolate_text"):
        table = {"split": "lineitem", "isolate": "orders",
                 "isolate_text": "logs"}[op]
        n = 4 if op == "isolate_text" else 8
        # the colocation group grew together; bounds stay contiguous
        assert len(prows[table]) > n
        for a, b in zip(prows[table], prows[table][1:]):
            assert a[3] + 1 == b[2]
        if table != "logs":
            assert len(prows["orders"]) == len(prows["lineitem"])
    if op in ("move", "rebalance"):
        assert any(pl[1] == 2 and pl[2] == "active"
                   for row in prows["orders"] for pl in row[4])


@pytest.mark.parametrize("op", sorted(OPS))
def test_operation_row_sets_match_jax_and_ranges(ran, op):
    _jd, _jg, _jr, jsets = ran[op]["jax"]
    pd, _pg, prows, psets = ran[op]["port"]
    assert psets == jsets
    # every shard holds only rows of its own token range
    s = _port(pd)
    try:
        for t in ("lineitem", "orders", "logs"):
            meta = s.catalog.table(t)
            col = meta.distribution_column
            for shard in s.catalog.table_shards(t):
                vals, _m, n = s.store.read_shard(t, shard.shard_id, [col])
                if not n:
                    continue
                if t == "logs":
                    d = s.store.dictionary(t, col)
                    toks = d.hash_tokens()[vals[col]]
                else:
                    toks = hash_token(vals[col])
                assert toks.min() >= shard.min_value
                assert toks.max() <= shard.max_value
    finally:
        s.close()


@pytest.mark.parametrize("op", sorted(OPS))
def test_operation_tables_equal_sqlite(ran, oracle, op):
    pd = ran[op]["port"][0]
    s = _port(pd)
    try:
        for sql in ("select l_orderkey, l_linenumber, l_quantity, "
                    "l_extendedprice from lineitem order by 1, 2",
                    "select o_orderkey, o_custkey, o_totalprice from "
                    "orders order by 1"):
            got = [tuple(r) for r in s.execute(sql).rows()]
            want = oracle.execute(sql).fetchall()
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g[:-1] == w[:-1]
                assert g[-1] == pytest.approx(w[-1], rel=1e-12)
        per = dict(s.execute("select tenant, count(*) from logs "
                             "group by tenant").rows())
        assert per == {f"tenant{k}": len(range(k, 100, TENANTS))
                       for k in range(TENANTS)}
    finally:
        s.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_split(ran, tmp_path, writer):
    d = _copy(ran["split"][writer][0], tmp_path, "x")
    reader = _port if writer == "jax" else _jax
    w, r = (_jax if writer == "jax" else _port)(d), None
    try:
        want = [w.execute(q).rows() for q in (jtpch.Q1, jtpch.Q3)]
        w.close()
        r = reader(d)
        got = [r.execute(q).rows() for q in (jtpch.Q1, jtpch.Q3)]
        assert len(r.catalog.table_shards("lineitem")) == 9
    finally:
        if r is not None:
            r.close()
    for g, wnt in zip(got, want):
        assert len(g) == len(wnt)
        for a, b in zip(g, wnt):
            assert a == pytest.approx(b, rel=1e-9)


@pytest.mark.parametrize("creator", ["jax", "port"])
def test_restore_point_across_packages(base, tmp_path, creator):
    d = _copy(base, tmp_path, "rp")
    mk = _jax if creator == "jax" else _port
    s = mk(d)
    before = s.execute("select count(*), sum(o_totalprice) from orders"
                       ).rows()
    s.execute("select citus_create_restore_point('pre')")
    s.execute("insert into region values (9, 'NOWHERE', 'x')")
    s.execute("delete from orders where o_orderkey < 100")
    sid, mid = _first_shard_mid(s)
    s.execute(f"select citus_split_shard_by_split_points({sid}, "
              f"'{mid}')")
    s.close()
    # the other package restores and reads
    restore = jrestore if creator == "port" else prestore
    restore.restore_cluster(d, "pre")
    other = _port if creator == "jax" else _jax
    r = other(d)
    try:
        (n, total), = r.execute("select count(*), sum(o_totalprice) "
                                "from orders").rows()
        assert n == before[0][0]
        assert total == pytest.approx(before[0][1], rel=1e-12)
        assert r.execute("select count(*) from region").rows() == [(5,)]
        assert len(r.catalog.table_shards("lineitem")) == 8
        assert prestore.list_restore_points(d) == ["pre"]
    finally:
        r.close()


def test_restore_point_name_validation(base, tmp_path):
    s = _port(_copy(base, tmp_path, "rpv"))
    try:
        s.execute("select citus_create_restore_point('a')")
        with pytest.raises(CatalogError):
            s.execute("select citus_create_restore_point('a')")
        with pytest.raises(CatalogError):
            s.execute("select citus_create_restore_point('../x')")
        with pytest.raises(CatalogError):
            prestore.restore_cluster(s.data_dir, "missing")
    finally:
        s.close()


def _child_dirs(d, table="lineitem"):
    return sorted(e for e in os.listdir(os.path.join(d, "tables", table))
                  if e.startswith("shard_"))


@pytest.mark.parametrize("reopen", ["jax", "port"])
def test_crash_at_shard_split_recovers_at_next_open(base, tmp_path,
                                                    monkeypatch, reopen):
    d = _copy(base, tmp_path, "crash")
    s = _port(d)
    want = s.execute(jtpch.Q1).rows()
    dirs0 = _child_dirs(d)
    sid, mid = _first_shard_mid(s)
    # a process death at the seam: no in-process rollback or sweep runs
    from citus_tpu_torch.operations import shard_split as split_mod

    monkeypatch.setattr(split_mod, "_restore_catalog", lambda *a: None)
    monkeypatch.setattr(CleanupRegistry, "sweep", lambda *a: 0)
    with pfi.inject("operations.shard_split", require_fired=True):
        with pytest.raises(pfi.InjectedFault):
            split_mod.split_shard_by_split_points(s, sid, [mid])
    monkeypatch.undo()
    # the children were written (and registered), the catalog on disk
    # still holds the parent
    assert len(_child_dirs(d)) > len(dirs0)
    with open(os.path.join(d, "cleanup.json")) as f:
        assert json.load(f)["records"]
    # the dead process's in-flight guard dies with it
    from citus_tpu.operations import cleanup as jcleanup
    from citus_tpu_torch.operations import cleanup as pcleanup

    pcleanup._registries.clear()
    jcleanup._registries.clear()
    r = (_jax if reopen == "jax" else _port)(d)
    try:
        assert _child_dirs(d) == dirs0
        assert CleanupRegistry(d).pending() == []
        assert len(r.catalog.table_shards("lineitem")) == 8
        got = r.execute(jtpch.Q1).rows()
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a == pytest.approx(b, rel=1e-9)
    finally:
        r.close()


def test_split_in_process_failure_rolls_back(base, tmp_path):
    d = _copy(base, tmp_path, "fail")
    s = _port(d, max_statement_retries=0)
    try:
        want = s.execute("select count(*), sum(l_quantity) from lineitem"
                         ).rows()
        dirs0 = _child_dirs(d)
        sid, mid = _first_shard_mid(s)
        with pfi.inject("operations.shard_split", require_fired=True):
            with pytest.raises(pfi.InjectedFault):
                s.execute(f"select citus_split_shard_by_split_points("
                          f"{sid}, '{mid}')")
        assert _child_dirs(d) == dirs0
        assert CleanupRegistry(d).pending() == []
        assert len(s.catalog.table_shards("lineitem")) == 8
        assert s.execute("select count(*), sum(l_quantity) from lineitem"
                         ).rows() == want
    finally:
        s.close()


def test_move_fault_leaves_the_old_placement(base, tmp_path):
    d = _copy(base, tmp_path, "movef")
    s = _port(d, max_statement_retries=0)
    try:
        s.execute("select citus_add_node('device:1')")
        sid = s.catalog.table_shards("orders")[0].shard_id
        before = s.catalog.active_placement(sid).placement_id
        with pfi.inject("operations.shard_move", require_fired=True):
            with pytest.raises(pfi.InjectedFault):
                s.execute(f"select citus_move_shard_placement({sid}, "
                          "'device:1')")
        assert s.catalog.active_placement(sid).placement_id == before
    finally:
        s.close()


def test_invalid_split_points_raise(base, tmp_path):
    s = _port(_copy(base, tmp_path, "inv"))
    try:
        sh = s.catalog.table_shards("orders")[0]
        with pytest.raises(CatalogError):
            s.execute(f"select citus_split_shard_by_split_points("
                      f"{sh.shard_id}, '{sh.max_value}')")
        with pytest.raises(CatalogError):
            s.execute("select citus_split_shard_by_split_points(1, '0')")
        with pytest.raises(CatalogError):
            s.execute(f"select citus_split_shard_by_split_points("
                      f"{s.catalog.table_shards('nation')[0].shard_id}, "
                      "'0')")
    finally:
        s.close()


def test_split_writes_only_live_rows(base, tmp_path):
    d = _copy(base, tmp_path, "live")
    s = _port(d)
    try:
        s.execute("delete from lineitem where l_linenumber = 1")
        want = s.execute("select count(*), sum(l_quantity) from lineitem"
                         ).rows()
        sid, mid = _first_shard_mid(s)
        children = s.execute(f"select citus_split_shard_by_split_points("
                             f"{sid}, '{mid}')").rows()[0][0]
        man = s.store.manifest("lineitem")
        for cid in children.split(","):
            recs = man["shards"][cid]
            assert recs and not any(r.get("deletes") for r in recs)
            assert all(r["rows"] == r.get("live_rows", r["rows"])
                       for r in recs)
        assert s.execute("select count(*), sum(l_quantity) from lineitem"
                         ).rows() == want
        assert s.execute("select count(*) from lineitem where "
                         "l_linenumber = 1").rows() == [(0,)]
    finally:
        s.close()


def test_split_gives_children_mirrors_under_factor_two(tmp_path):
    s = _port(tmp_path / "f2")
    try:
        s.execute("select citus_add_node('device:1')")
        s.execute("set shard_replication_factor = 2")
        s.execute("create table kv (id bigint, v bigint)")
        s.execute("select create_distributed_table('kv', 'id', 2)")
        s.execute("insert into kv values " + ", ".join(
            f"({i}, {i * 3})" for i in range(200)))
        sid, mid = _first_shard_mid(s, "kv")
        kids = [int(c) for c in s.execute(
            f"select citus_split_shard_by_split_points({sid}, '{mid}')"
        ).rows()[0][0].split(",")]
        for cid in kids:
            assert len(s.catalog.shard_placements(cid)) == 2
            for rec in s.store.manifest("kv")["shards"][str(cid)]:
                copies = s.store._copy_paths("kv", cid, rec["file"])
                assert len(copies) == 2
                for p in copies:
                    integrity.verify_stripe_file(p)
        # a flipped bit in a child's primary copy is read-repaired
        rec = s.store.manifest("kv")["shards"][str(kids[0])][0]
        primary = os.path.join(s.store.shard_dir("kv", kids[0]),
                               rec["file"])
        integrity.flip_one_bit(primary)
        s.store.refresh("kv")
        got = dict(s.execute("select id, v from kv").rows())
        assert got == {i: i * 3 for i in range(200)}
        integrity.verify_stripe_file(primary)
    finally:
        s.close()


def test_split_children_rebuild_the_point_index(base, tmp_path):
    d = _copy(base, tmp_path, "pk")
    s = _port(d)
    try:
        key = int(s.execute("select o_orderkey from orders order by 1 "
                            "limit 1").rows()[0][0])
        point = f"select o_totalprice from orders where o_orderkey = {key}"
        want = s.execute(point).rows()
        assert want
        tok = int(hash_token(np.asarray([key], np.int64))[0])
        sh = next(x for x in s.catalog.table_shards("orders")
                  if x.contains_token(tok))
        s.execute(f"select citus_split_shard_by_split_points("
                  f"{sh.shard_id}, '{min(tok, sh.max_value - 1)}')")
        child = next(x for x in s.catalog.table_shards("orders")
                     if x.contains_token(tok))
        side = os.path.join(s.store.shard_dir("orders", child.shard_id),
                            "PKIDX_o_orderkey.npz")
        assert not os.path.exists(side)
        r = s.execute(point)
        assert r.rows() == want and r.fast_path
        assert os.path.exists(side)
    finally:
        s.close()


def test_isolate_text_tenant_holds_only_its_token(base, tmp_path):
    s = _port(_copy(base, tmp_path, "iso"))
    try:
        sid = int(s.execute("select isolate_tenant_to_node('logs', "
                            "'tenant3')").rows()[0][0])
        shard = s.catalog.shards[sid]
        tok = string_hash_token("tenant3")
        assert shard.contains_token(tok)
        assert s.execute("select count(*) from logs where tenant = "
                         "'tenant3'").rows() == [(len(range(3, 100,
                                                            TENANTS)),)]
        vals, _m, n = s.store.read_shard("logs", sid, ["tenant"])
        d = s.store.dictionary("logs", "tenant")
        assert n and set(d.hash_tokens()[vals["tenant"]]) == {tok}
    finally:
        s.close()


MUTATING = [
    "select rebalance_table_shards()",
    "select citus_move_shard_placement(1, 'device:0')",
    "select citus_split_shard_by_split_points(1, '0')",
    "select isolate_tenant_to_node('orders', 7)",
    "select citus_rebalance_start()",
    "select citus_create_restore_point('x')",
]


@pytest.fixture(scope="module")
def follower(base, tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ops_follower")
    leader = str(root / "leader")
    shutil.copytree(base, leader)
    provision_replica(leader, str(root / "follower"))
    return str(root / "follower")


@pytest.mark.parametrize("sql", MUTATING)
def test_follower_refuses_mutating_udfs(follower, sql):
    f = _port(follower)
    try:
        with pytest.raises(ReadOnlyReplica):
            f.execute(sql)
        # reads keep answering
        assert f.execute("select count(*) from nation").rows() == [(25,)]
    finally:
        f.close()


ANSWERED = {
    "get_rebalance_progress": "select get_rebalance_progress()",
    "citus_cleanup_orphaned_resources":
        "select citus_cleanup_orphaned_resources()",
    "citus_rebalance_wait": "select citus_rebalance_wait()",
    "citus_job_list": "select citus_job_list()",
    "citus_check_cluster": "select citus_check_cluster()",
    "citus_rebalance_start": "select citus_rebalance_start()",
    "rebalance_table_shards": "select rebalance_table_shards()",
}


@pytest.mark.parametrize("udf", sorted(ANSWERED))
def test_operations_udfs_answer_like_jax(base, tmp_path, udf):
    out = {}
    for pkg, mk in (("jax", _jax), ("port", _port)):
        s = mk(_copy(base, tmp_path, pkg))
        try:
            r = s.execute(ANSWERED[udf])
            out[pkg] = (r.column_names, r.rows())
        finally:
            s.close()
    assert out["port"] == out["jax"]


def test_move_placement_retires_exactly_that_copy_like_jax(base, tmp_path):
    """The placement-targeted move (a node drain's primitive) moves the
    named replica, not the shard's primary, in both packages."""
    from citus_tpu.operations.shard_transfer import move_placement as jmove
    from citus_tpu_torch.operations.shard_transfer import (
        move_placement as pmove,
    )

    out = {}
    for pkg, mk, move in (("jax", _jax, jmove), ("port", _port, pmove)):
        s = mk(_copy(base, tmp_path, pkg))
        try:
            s.execute("select citus_add_node('device:1')")
            s.execute("select citus_add_node('device:2')")
            s.execute("set shard_replication_factor = 2")
            s.execute("create table r (id bigint, v bigint)")
            s.execute("select create_distributed_table('r', 'id', 2)")
            sid = s.catalog.table_shards("r")[0].shard_id
            primary, replica = s.catalog.shard_placements(sid)[:2]
            target = next(n.name for n in s.catalog.active_nodes()
                          if n.node_id not in (primary.node_id,
                                               replica.node_id))
            moved = move(s.catalog, s.store, replica.placement_id, target)
            again = move(s.catalog, s.store, replica.placement_id, target)
            out[pkg] = (moved, again, sorted(
                (p.placement_id, p.node_id, p.shard_state)
                for p in s.catalog.all_shard_placements(sid)))
        finally:
            s.close()
    assert out["port"] == out["jax"]
    assert out["port"][:2] == (True, False)
