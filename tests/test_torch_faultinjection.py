"""The port's fault engine (citus_tpu_torch/utils/faultinjection.py)
against the JAX package's: the delayed-start, probabilistic, sticky and
counted modes, arm / disarm / armed_points / injected_total, the
registry (`--list`, 34 points), and the `catalog.placement_probe` seam
in `Catalog.active_placement`, armed around the same SELECTs on copies
of one data_dir in both packages.
"""

import os
import shutil
import subprocess
import sys

import pytest

import citus_tpu
import citus_tpu_torch
from citus_tpu.errors import CitusTpuError as JaxError
from citus_tpu.utils import faultinjection as jfi
from citus_tpu_torch.errors import CitusTpuError
from citus_tpu_torch.utils import faultinjection as pfi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = {i: 100 + i for i in range(40)}
READS = ["select count(*), sum(v) from kv",
         "select id, v from kv where id = 7",
         "select v, count(*) from kv group by v order by v limit 5"]


@pytest.fixture(autouse=True)
def _clean():
    pfi.reset()
    jfi.reset()
    yield
    pfi.reset()
    jfi.reset()


def _fires(engine, name, n, **spec) -> list[bool]:
    """Pass `n` times through seam `name` armed with `spec`: which
    passes raised."""
    engine.arm(name, **spec)
    out = []
    for _ in range(n):
        try:
            engine.fault_point(name)
            out.append(False)
        except Exception as e:  # noqa: BLE001 — the engine's own raise
            assert getattr(e, "injected_fault", False), e
            out.append(True)
    engine.disarm(name)
    return out


@pytest.mark.parametrize("spec", [
    dict(after=3),
    dict(after=2, times=2),
    dict(p=0.5, seed=7, times=None, once=False),
    dict(p=0.3, seed=11, times=4),
    dict(once=False),
    dict(times=3),
    dict(),
], ids=["after", "after-times", "p-seed-sticky", "p-seed-times", "sticky",
        "times", "once"])
def test_modes_fire_as_the_jax_engine(spec):
    name = "store.read_shard"
    got = _fires(pfi, name, 12, **spec)
    assert got == _fires(jfi, name, 12, **spec)
    assert any(got)


def test_after_skips_then_fires_once():
    assert _fires(pfi, "txn.apply", 5, after=2) == [
        False, False, True, False, False]


def test_p_with_seed_is_deterministic():
    a = _fires(pfi, "wlm.admit", 40, p=0.4, seed=3, once=False)
    b = _fires(pfi, "wlm.admit", 40, p=0.4, seed=3, once=False)
    assert a == b and 0 < sum(a) < 40
    assert a != _fires(pfi, "wlm.admit", 40, p=0.4, seed=4, once=False)


def test_sticky_fault_stays_armed_until_disarmed():
    pfi.arm("cdc.append", once=False)
    for _ in range(5):
        with pytest.raises(pfi.InjectedFault):
            pfi.fault_point("cdc.append")
    assert pfi.armed_points() == ["cdc.append"]
    pfi.disarm("cdc.append")
    pfi.fault_point("cdc.append")
    assert pfi.armed_points() == []


def test_times_disarms_after_n():
    assert _fires(pfi, "txn.prepare", 6, times=3) == [True] * 3 + [False] * 3


def test_arm_disarm_armed_points_injected_total():
    before = pfi.injected_total()
    pfi.arm("store.read_shard", error="storage")
    pfi.arm("txn.apply", error=None, sleep=0.0)
    assert pfi.armed_points() == ["store.read_shard", "txn.apply"]
    pfi.fault_point("txn.apply")  # delay-only: counts, raises nothing
    with pytest.raises(CitusTpuError):
        pfi.fault_point("store.read_shard")
    assert pfi.injected_total() == before + 2
    assert pfi.fired_count("txn.apply") == 1
    assert pfi.armed_points() == []  # both were one-shot
    with pytest.raises(ValueError):
        pfi.arm("txn.apply", error="nonsense")


def test_list_names_equal_the_jax_package():
    out = {}
    for pkg in ("citus_tpu", "citus_tpu_torch"):
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.utils.faultinjection", "--list"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        out[pkg] = {line.split()[0] for line in proc.stdout.splitlines()}
    assert out["citus_tpu_torch"] == out["citus_tpu"]
    assert len(out["citus_tpu_torch"]) == 34
    assert set(pfi.FAULT_POINTS) == set(jfi.FAULT_POINTS)
    assert pfi.main(["--bogus"]) == 2


# -- catalog.placement_probe, in both packages -----------------------------

_QUIET = dict(n_devices=1, exec_cache_enabled=False,
              compute_dtype="float64", serving_result_cache_bytes=0,
              recover_2pc_interval_ms=-1, defer_shard_delete_interval_ms=-1,
              health_check_interval_ms=-1)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("probe") / "base")
    s = citus_tpu_torch.connect(d, device="cpu", compute_dtype="float64")
    s.execute("create table kv (id bigint, v bigint)")
    s.execute("select create_distributed_table('kv', 'id', 4)")
    s.execute("insert into kv values " + ", ".join(
        f"({i}, {v})" for i, v in SEED.items()))
    s.close()
    return d


def _pair(base, tmp_path, **kw):
    jdir, pdir = str(tmp_path / "j"), str(tmp_path / "p")
    shutil.copytree(base, jdir)
    shutil.copytree(base, pdir)
    j = citus_tpu.connect(data_dir=jdir, **{**_QUIET, **kw})
    p = citus_tpu_torch.connect(pdir, device="cpu",
                                **{"compute_dtype": "float64",
                                   "serving_result_cache_bytes": 0,
                                   "exec_cache_enabled": False, **kw})
    return j, p


@pytest.mark.parametrize("mode", ["off", "host", "device"])
def test_probe_fires_as_often_per_statement_as_in_jax(base, tmp_path, mode):
    j, p = _pair(base, tmp_path, max_statement_retries=0,
                 scan_pipeline=mode)
    for sql in READS:
        counts = []
        for sess, engine in ((j, jfi), (p, pfi)):
            # delay-only and sticky: every pass through the seam counts
            with engine.inject("catalog.placement_probe", error=None,
                               once=False, require_fired=True):
                before = engine.fired_count("catalog.placement_probe")
                sess.execute(sql)
                counts.append(engine.fired_count("catalog.placement_probe")
                              - before)
        assert counts[0] == counts[1] > 0, (sql, counts)
    j.close()
    p.close()


@pytest.mark.parametrize("retries", [0, 2])
def test_armed_probe_fails_cleanly_or_answers_right(base, tmp_path,
                                                    retries):
    """One injected probe failure: without retries a clean error in both
    packages; with them the retried statement's right answer."""
    j, p = _pair(base, tmp_path, max_statement_retries=retries)
    sql = READS[0]
    want = [(len(SEED), sum(SEED.values()))]
    outcomes = []
    for sess, engine, err in ((j, jfi, JaxError), (p, pfi, CitusTpuError)):
        with engine.inject("catalog.placement_probe", require_fired=True):
            try:
                rows = [tuple(int(x) for x in r)
                        for r in sess.execute(sql).rows()]
                outcomes.append(("rows", rows))
            except err as e:
                assert getattr(e, "fault_point", None) == \
                    "catalog.placement_probe"
                outcomes.append(("error", None))
    assert outcomes[0] == outcomes[1]
    if retries:
        assert outcomes[1] == ("rows", want)
    else:
        assert outcomes[1][0] == "error"
    # the next statement, unarmed, answers right in both
    for sess in (j, p):
        assert [tuple(int(x) for x in r)
                for r in sess.execute(sql).rows()] == want
        sess.close()
