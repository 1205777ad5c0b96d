"""The port's operations/health.py against the JAX package's, on CPU torch.

One data_dir written by the JAX package: a distributed table with
shard_replication_factor 2 over two nodes (device:0 and a spare), and a
reference table.  Each package opens its own copy (JAX: n_devices=1;
port: device="cpu").  Held equal to the JAX package:

* citus_check_cluster_node_health() rows, for healthy storage and for a
  node whose shard directory cannot be read;
* citus_promote_node(): the placements it demotes, the catalog it
  leaves, reads failing over to the surviving copies, and the refusal
  when a shard would lose its last copy.

The device leg of the probe is the session's device: a 4-byte tensor on
the CPU here (cuda:0 on a GPU session; chip_smoke.py phase 12 calls the
UDF on the card).
"""

import os
import shutil

import pytest
import torch

import citus_tpu
import citus_tpu_torch
from citus_tpu.operations import health as jhealth
from citus_tpu_torch.operations import health as phealth

torch.set_num_threads(1)

SETUP = [
    "select citus_add_node('spare')",
    "set shard_replication_factor = 2",
    "create table kv (id bigint, v bigint)",
    "select create_distributed_table('kv', 'id', 4)",
    "insert into kv values " + ", ".join(f"({i}, {i * 7})"
                                         for i in range(200)),
    "create table ref (k bigint, name text)",
    "select create_reference_table('ref')",
    "insert into ref values (1, 'a'), (2, 'b')",
]


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_health") / "base")
    s = citus_tpu.connect(data_dir=d, n_devices=1, exec_cache_enabled=False,
                          serving_result_cache_bytes=0,
                          health_check_interval_ms=-1)
    for sql in SETUP:
        s.execute(sql)
    s.close()
    return d


def _pair(base, tmp_path):
    jd, pd = str(tmp_path / "j"), str(tmp_path / "p")
    shutil.copytree(base, jd)
    shutil.copytree(base, pd)
    j = citus_tpu.connect(data_dir=jd, n_devices=1, exec_cache_enabled=False,
                          serving_result_cache_bytes=0,
                          health_check_interval_ms=-1,
                          recover_2pc_interval_ms=-1,
                          defer_shard_delete_interval_ms=-1)
    p = citus_tpu_torch.connect(pd, device="cpu")
    return j, p


def _catalog_state(sess):
    c = sess.catalog
    nodes = sorted((n.name, n.is_active) for n in c.nodes.values())
    placements = sorted((p.shard_id, p.node_id, p.shard_state)
                        for p in c.placements.values())
    return nodes, placements


def _health(sess):
    return sess.execute("select citus_check_cluster_node_health()").rows()


def test_health_rows_match_jax(base, tmp_path):
    j, p = _pair(base, tmp_path)
    rows = _health(p)
    assert rows == _health(j)
    assert rows == [("device:0", True, True), ("spare", True, True)]
    j.close()


def test_unreadable_storage_fails_the_probe_like_jax(base, tmp_path,
                                                     monkeypatch):
    j, p = _pair(base, tmp_path)
    real = os.listdir

    def listdir(path):
        # every copy hosted by the spare node (its replica dirs and any
        # shard dir it is the primary of) refuses a read
        spare = {pl.shard_id for pl in p.catalog.placements.values()
                 if p.catalog.nodes[pl.node_id].name == "spare"}
        if any(f"shard_{sid}" in str(path) for sid in spare):
            raise PermissionError(path)
        return real(path)

    monkeypatch.setattr(os, "listdir", listdir)
    rows = _health(p)
    assert rows == _health(j)
    assert ("spare", True, False) in rows
    assert (phealth.check_cluster_health(p)
            == jhealth.check_cluster_health(j))
    j.close()


def test_promote_node_matches_jax(base, tmp_path):
    j, p = _pair(base, tmp_path)
    for s in (j, p):
        s.execute("select citus_disable_node('spare')")
    got = p.execute("select citus_promote_node('spare')").rows()
    assert got == j.execute("select citus_promote_node('spare')").rows()
    assert got[0][0] > 0
    assert _catalog_state(p) == _catalog_state(j)
    assert sorted(p.execute("select id, v from kv").rows()) == \
        [(i, i * 7) for i in range(200)]
    # now the only copies sit on device:0: promoting it away is refused
    with pytest.raises(citus_tpu.CitusTpuError) as jerr:
        j.execute("select citus_promote_node('device:0')")
    with pytest.raises(citus_tpu_torch.CitusTpuError) as perr:
        p.execute("select citus_promote_node('device:0')")
    assert type(perr.value).__name__ == type(jerr.value).__name__
    assert str(perr.value) == str(jerr.value)
    assert _catalog_state(p) == _catalog_state(j)
    j.close()


def test_probe_places_on_the_session_device(base, tmp_path, monkeypatch):
    """The device leg is a 4-byte round trip through the session's
    device; a node name beyond the session's devices is unhealthy, as in
    the JAX package at one device."""
    j, p = _pair(base, tmp_path)
    seen = []
    real_ones = torch.ones

    def ones(*a, **kw):
        seen.append(kw.get("device"))
        return real_ones(*a, **kw)

    monkeypatch.setattr(torch, "ones", ones)
    node = p.catalog.node_by_name("device:0")
    assert phealth.probe_node(p, node)
    assert seen == [p.device]
    p.execute("select citus_add_node('device:3')")
    j.execute("select citus_add_node('device:3')")
    assert _health(p) == _health(j)
    assert ("device:3", True, False) in _health(p)
    j.close()
