"""The port's graftlint (citus_tpu_torch/analysis): the tree gate, the
baseline's hygiene, the CLI, fixtures for every rule family, parity with
the JAX package's graftlint on its fixture corpus, and the runtime
lock-order sanitizer's self-tests.

The tree gate is the acceptance check: the port (core.DEFAULT_SUBDIRS)
lints clean against citus_tpu_torch/analysis/lint_baseline.json, every
entry justified, in under 15 s.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import pytest

from citus_tpu_torch.analysis import load_baseline, run_lint, unbaselined
from citus_tpu_torch.analysis.core import BASELINE_NAME, FAMILY_RULES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIXTURES = os.path.join(ROOT, "tests", "lint_fixtures")


@pytest.fixture(scope="module")
def tree_scan():
    t0 = time.monotonic()
    findings = run_lint(ROOT)
    return findings, time.monotonic() - t0


def test_tree_lints_clean_within_budget(tree_scan):
    findings, elapsed = tree_scan
    baseline = load_baseline(os.path.join(ROOT, BASELINE_NAME))
    fresh, stale = unbaselined(findings, baseline)
    assert not fresh, ("unbaselined graftlint findings:\n"
                       + "\n".join(str(f) for f in fresh))
    assert not stale, ("stale baseline entries (fixed — remove them):\n"
                       + "\n".join(stale))
    assert elapsed < 15.0, f"tree lint took {elapsed:.1f}s (budget 15s)"
    # the gate lints the port and its scripts, never the JAX package
    assert {f.path.split("/")[0] for f in findings} <= {"citus_tpu_torch"}


def test_baseline_entries_all_justified():
    with open(os.path.join(ROOT, BASELINE_NAME)) as f:
        data = json.load(f)
    assert data["findings"]
    for e in data["findings"]:
        why = e.get("why", "")
        assert why and "TODO" not in why, (
            f"baseline entry without a justification: {e}")
        assert e["path"].startswith("citus_tpu_torch/"), e


def test_registries_in_sync(tree_scan):
    """The five registries: every finding of the family is baselined
    with its reason (uses the static rule cannot resolve), none new."""
    baseline = load_baseline(os.path.join(ROOT, BASELINE_NAME))
    reg = [f for f in tree_scan[0] if f.rule in FAMILY_RULES["registries"]]
    assert unbaselined(reg, baseline)[0] == []
    assert not [f for f in reg if "not declared" in f.message
                or "not registered" in f.message
                or "not defined" in f.message
                or "missing from" in f.message]


def test_fault_points_equal_the_jax_packages():
    from citus_tpu.utils.faultinjection import FAULT_POINTS as J
    from citus_tpu_torch.utils.faultinjection import FAULT_POINTS as P

    assert set(P) == set(J) and len(P) == 34


@pytest.mark.parametrize("args, rc", [
    (["--json"], 0),
    (["citus_tpu_torch/wlm/admision.py"], 2),   # typo'd on purpose
])
def test_cli_exit_codes(args, rc):
    proc = subprocess.run(
        [sys.executable, "-m", "citus_tpu_torch.analysis", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == rc, proc.stdout + proc.stderr
    if rc == 0:
        payload = json.loads(proc.stdout)
        assert payload["findings"] == [] and payload["baselined"] > 0
        assert payload["stale_baseline"] == []
    else:
        assert "no such file" in proc.stderr


def test_subset_scan_skips_unused_direction():
    for sub in ("citus_tpu_torch/planner/explain.py",
                "citus_tpu_torch/config.py",
                "citus_tpu_torch/stats/tracing.py",
                "citus_tpu_torch/utils/faultinjection.py"):
        assert run_lint(ROOT, subdirs=(sub,)) == [], sub


# -- the port's own fixtures: hot-path and placement rules -----------------
# each line a rule must flag carries `# expect[rule, ...]`

PORT_FIXTURES = {
    "citus_tpu_torch/executor/compiler.py": '''
import torch

from ..ops import helpers as hp
from ..ops.helpers import scale


class PlanCompiler:
    def _dispatch(self, plan, feeds):
        x = feeds["x"]
        n = x.sum().item()  # expect[host-sync-in-capture]
        if torch.any(x > 0):  # expect[capture-python-branch]
            x = x + 1
        y = x[x > 0]  # expect[host-sync-in-capture]
        idx = torch.nonzero(x)  # expect[host-sync-in-capture]
        k = int(x.max())  # expect[host-sync-in-capture]
        w = torch.where(x > 1)  # expect[host-sync-in-capture]
        m = x if bool(torch.all(x)) else y  # expect[host-sync-in-capture, capture-python-branch]
        return n, y, idx, k, w, m, self._helper(x), hp.gather(x), scale(x)

    def _helper(self, x):
        return x.cpu()  # expect[host-sync-in-capture]

    def never_dispatched(self, x):
        if x.any():
            return x.item()
        return torch.where(x > 0, x, 0)


def unrelated(x):
    return x.tolist()
''',
    "citus_tpu_torch/ops/helpers.py": '''
import torch


def gather(x):
    torch.cuda.synchronize()  # expect[host-sync-in-capture]
    return x


def scale(x):
    assert x.dtype != torch.bool and torch.is_tensor(x)
    while x.any():  # expect[capture-python-branch]
        x = x - 1
    return x * 2


def builds(items, hk):
    out = []
    for it in items:
        out.append(torch.cuda.CUDAGraph())  # expect[rebuild-in-loop]
        hk.build_all()  # expect[rebuild-in-loop]
    return out
''',
    "citus_tpu_torch/executor/stream.py": '''
def drain(batches):
    out = []
    for b in batches:
        out.append(b.cpu())  # expect[device-sync-in-loop]
        out.append(int(b.sum()))  # expect[device-sync-in-loop]
    return out


def sanctioned(batches):
    for b in batches:
        b.item()  # graftlint: ignore[device-sync-in-loop] — fixture: designed per-batch sync point


def outside_loop(b):
    return b.cpu()
''',
    "citus_tpu_torch/rawplace.py": '''
import numpy as np
import torch

from .distributed.mesh import put_sharded_slices


def bad_to(arr, device):
    return torch.from_numpy(arr).to(device)  # expect[raw-device-placement]


def bad_cuda(t):
    return t.cuda()  # expect[raw-device-placement]


def bad_as_tensor(arr):
    return torch.as_tensor(arr, device="cuda:0")  # expect[raw-device-placement]


def bad_put(mesh, arr):
    return put_sharded_slices(mesh, arr)  # expect[raw-device-placement]


def bad_position(t, mesh, i):
    return t.to(mesh.devices[i])  # expect[raw-device-placement, mesh-seam]


def bad_keyword(t, x):
    return t.to(device=x.device, non_blocking=True)  # expect[raw-device-placement]


def fine(x, t, arr):
    a = torch.empty(4, device=x.device)
    b = t.to(torch.float32)
    c = t.to("cpu")
    d = torch.tensor(arr)
    e = np.asarray(arr)
    return a, b, c, d, e


def fine_ignored(t, device):
    return t.to(device)  # graftlint: ignore[raw-device-placement] — fixture: sanctioned probe
''',
    "citus_tpu_torch/executor/hbm.py": '''
def place(t, device, mesh):
    a = t.to(device, non_blocking=True)
    return a, t.to(mesh.devices[0])  # expect[mesh-seam]
''',
    "citus_tpu_torch/distributed/mesh.py": '''
def put_sharded_slices(mesh, host):
    return [t.to(mesh.devices[i]) for i, t in enumerate(host)]
''',
}
PORT_RULES = (FAMILY_RULES["hotpath"]
              | {"raw-device-placement", "mesh-seam"})


def _write(root, files: dict) -> set:
    expected = set()
    for rel, src in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(src.lstrip("\n"))
        for i, line in enumerate(src.lstrip("\n").splitlines(), 1):
            m = re.search(r"# expect\[([a-z\-, ]+)\]", line)
            if m:
                expected |= {(r.strip(), rel, i)
                             for r in m.group(1).split(",")}
    return expected


def test_port_rules_fire_on_fixtures_and_stay_silent_elsewhere(tmp_path):
    expected = _write(str(tmp_path), PORT_FIXTURES)
    got = {(f.rule, f.path, f.line) for f in run_lint(str(tmp_path))
           if f.rule in PORT_RULES}
    assert got == expected, (f"missing {sorted(expected - got)}; "
                             f"extra {sorted(got - expected)}")
    assert {r for r, _p, _l in expected} == PORT_RULES


def test_each_rule_family_has_a_firing_fixture(tmp_path):
    """Every rule of the four families fires on a fixture: the JAX
    corpus (copied under citus_tpu_torch/) for locks, registries and
    the non-placement discipline rules, the port's own for the rest."""
    shutil.copytree(os.path.join(JAX_FIXTURES, "citus_tpu"),
                    str(tmp_path / "citus_tpu_torch"))
    _write(str(tmp_path), PORT_FIXTURES)
    rules = {f.rule for f in run_lint(str(tmp_path))}
    for family, expected in FAMILY_RULES.items():
        assert expected <= rules, (family, expected - rules)


def test_clean_fixture_stays_silent(tmp_path):
    shutil.copytree(os.path.join(JAX_FIXTURES, "citus_tpu"),
                    str(tmp_path / "citus_tpu_torch"))
    found = run_lint(str(tmp_path))
    for clean in ("citus_tpu_torch/clean.py", "citus_tpu_torch/utils/io.py"):
        assert not [f for f in found if f.path == clean], clean


def test_inline_ignore_suppresses(tmp_path):
    sub = tmp_path / "citus_tpu_torch"
    sub.mkdir()
    body = ("def f():\n"
            "    try:\n"
            "        return 1\n"
            "    except:{}\n"
            "        return 2\n")
    (sub / "mod.py").write_text(
        body.format("  # graftlint: ignore[bare-except] — test"))
    assert run_lint(str(tmp_path)) == []
    (sub / "mod.py").write_text(body.format(""))
    assert [f.rule for f in run_lint(str(tmp_path))] == ["bare-except"]


# the families whose rules are the JAX package's, message for message;
# the hot-path rules (CUDA capture against JAX tracing) and the
# placement rules (torch transfers against jax.device_put) differ by
# design and are left out
PARITY_RULES = (FAMILY_RULES["lockgraph"] | FAMILY_RULES["registries"]
                | (FAMILY_RULES["discipline"]
                   - {"raw-device-placement", "mesh-seam"}))


def test_parity_with_the_jax_graftlint_on_its_corpus(tmp_path):
    import citus_tpu.analysis as jan

    shutil.copytree(os.path.join(JAX_FIXTURES, "citus_tpu"),
                    str(tmp_path / "citus_tpu_torch"))

    def keyed(findings, pkg):
        # lock ids and paths in messages name the package
        return {(f.rule, f.context, f.message.replace(pkg, "<pkg>"))
                for f in findings if f.rule in PARITY_RULES}

    port = keyed(run_lint(str(tmp_path)), "citus_tpu_torch")
    ref = keyed(jan.run_lint(JAX_FIXTURES), "citus_tpu")
    assert port == ref, (f"port only {sorted(port - ref)}; "
                         f"JAX only {sorted(ref - port)}")
    assert {r for r, _c, _m in port} == PARITY_RULES


# -- runtime lock-order sanitizer -------------------------------------------

@pytest.fixture
def tsan():
    from citus_tpu_torch.analysis import sanitizer

    sanitizer.reset()
    yield sanitizer
    sanitizer.disable()
    sanitizer.reset()


def test_sanitizer_catches_seeded_inversion(tsan):
    with tsan.enabled():
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        with pytest.raises(tsan.LockOrderViolation):
            with b:
                with a:
                    pass
    assert len(tsan.violations()) == 1
    v = tsan.violations()[0]
    assert v.first != v.second
    assert "inverting acquisition" in str(v)


def test_sanitizer_catches_cross_thread_inversion(tsan):
    with tsan.enabled():
        a = threading.Lock()
        b = threading.Lock()

        def t1():
            with a:
                with b:
                    pass

        th = threading.Thread(target=t1)
        th.start()
        th.join()
        caught: list = []

        def t2():
            try:
                with b:
                    with a:
                        pass
            except tsan.LockOrderViolation as e:
                caught.append(e)

        th2 = threading.Thread(target=t2)
        th2.start()
        th2.join()
    assert caught, "inversion on the second thread was not raised"


def test_sanitizer_self_deadlock(tsan):
    with tsan.enabled():
        lk = threading.Lock()
        lk.acquire()
        with pytest.raises(tsan.LockOrderViolation):
            lk.acquire()
        lk.release()
    # a non-blocking probe (Condition._is_owned) is not a self-deadlock
    with tsan.enabled():
        lk2 = threading.Lock()
        with lk2:
            assert lk2.acquire(False) is False


def test_sanitizer_no_raise_mode_records_once(tsan):
    with tsan.enabled(raise_on_violation=False):
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        for _ in range(5):       # the same inversion, repeatedly
            with b:
                with a:
                    pass
    assert len(tsan.violations()) == 1


def test_sanitizer_release_after_disable_no_phantom(tsan):
    with tsan.enabled():
        lk = threading.Lock()
        lk.acquire()
    lk.release()   # after disable(): must still clear the held stack
    tsan.reset()
    with tsan.enabled():
        a = threading.Lock()
        with a:    # would record a phantom lk→a edge otherwise
            pass
        assert tsan.stats()["order_edges"] == 0
    assert tsan.violations() == []


def test_sanitizer_rlock_and_condition_compat(tsan):
    with tsan.enabled():
        r = threading.RLock()
        with r:
            with r:   # reentrant: no self-deadlock report
                assert r._recursion_count() == 2
        cv = threading.Condition()          # wraps a tracked RLock
        cvl = threading.Condition(threading.Lock())

        def waiter():
            with cv:
                cv.wait(timeout=0.2)

        th = threading.Thread(target=waiter)
        th.start()
        time.sleep(0.02)
        with cv:
            cv.notify_all()
        th.join()
        with cvl:
            cvl.notify_all()
    assert tsan.violations() == []


def test_sanitizer_wrappers_take_fork_reinit(tsan):
    """A wrapped lock takes os.register_at_fork's reinit hook, as
    concurrent.futures.thread's module lock needs when first imported
    under the sanitizer (the soak's first ThreadPoolExecutor import
    failed on its absence)."""
    with tsan.enabled():
        lk = threading.Lock()
        lk.acquire()
        lk._at_fork_reinit()
        assert not lk.locked()
        with lk:
            pass
    assert tsan.violations() == []


def test_disable_restores_what_enable_replaced(tsan):
    before = (threading.Lock, threading.RLock)
    tsan.enable()
    tsan.enable()   # idempotent: still restores the originals
    assert threading.Lock is tsan.TsanLock
    tsan.disable()
    assert (threading.Lock, threading.RLock) == before


def test_tsan_env_var_arms_at_import():
    env = dict(os.environ, CITUS_TPU_TORCH_TSAN="1")
    env.pop("CITUS_TPU_TSAN", None)
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, threading, citus_tpu_torch\n"
         "from citus_tpu_torch.analysis import sanitizer\n"
         "assert sanitizer.stats()['enabled']\n"
         "assert type(threading.Lock()).__name__ == 'TsanLock'\n"
         "print('armed')"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "armed" in proc.stdout
    env.pop("CITUS_TPU_TORCH_TSAN")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, citus_tpu_torch\n"
         "assert 'citus_tpu_torch.analysis.sanitizer' not in sys.modules\n"
         "print('unarmed')"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sanitizer_consistent_engine_order_is_clean(tsan, tmp_path):
    """Session open, DDL, DML and a transaction with every lock
    tracked: the port's real acquisition orders are violation-free
    (the chaos soak runs the big version)."""
    import citus_tpu_torch

    with tsan.enabled():
        s = citus_tpu_torch.connect(str(tmp_path / "d"), device="cpu",
                                    n_devices=2)
        s.execute("CREATE TABLE t1 (id INT, v INT)")
        s.execute("SELECT create_distributed_table('t1', 'id', 2)")
        s.execute("INSERT INTO t1 VALUES (1, 10), (2, 20)")
        s.execute("BEGIN")
        s.execute("UPDATE t1 SET v = 11 WHERE id = 1")
        s.execute("COMMIT")
        assert int(s.execute("SELECT sum(v) FROM t1").rows()[0][0]) == 31
        s.close()
        assert tsan.stats()["acquisitions"] > 0
    assert tsan.violations() == []
