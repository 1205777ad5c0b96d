"""Nothing the benchmark loads is JAX or the JAX package, and the
reference imports nothing of the port."""

import ast
import json
import os
import subprocess
import sys

import pytest

from portbench import guard, spec

FORBIDDEN_FOR_REFERENCE = ("citus_tpu_torch",) + guard.FORBIDDEN


def imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def bench_files():
    for dp, _d, fs in os.walk(spec.BENCH_DIR):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(dp, f)


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["citus_tpu_torch", "citus_tpu_torch.ops",
                                   "jaxtyping", "numpy"]) == []
    assert guard.forbidden_loaded(["citus_tpu.ops", "jax.numpy", "jaxlib",
                                   "flax"]) == ["citus_tpu.ops", "flax",
                                                "jax.numpy", "jaxlib"]


def test_no_file_of_the_benchmark_imports_jax():
    for path in bench_files():
        bad = imported_roots(path) & set(guard.FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_port():
    ref_dir = os.path.join(spec.BENCH_DIR, "reference")
    for f in sorted(os.listdir(ref_dir)):
        if f.endswith(".py"):
            roots = imported_roots(os.path.join(ref_dir, f))
            assert roots <= {"__future__", "numpy", "torch"}, (f, roots)
            assert not roots & set(FORBIDDEN_FOR_REFERENCE)


def test_every_module_a_run_loads_is_clean():
    """A fresh process that loads everything a run of each cell loads
    (the harness, the port, every reference and metric reader)."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {spec.ROOT!r})\n"
        "import portbench.run, portbench.cell, portbench.control\n"
        "import citus_tpu_torch, citus_tpu_torch.session\n"
        "from citus_tpu_torch.ingest import tpch, copy_from\n"
        "from citus_tpu_torch.ops import hopper_kernels\n"
        "from portbench import spec, guard\n"
        "for w in spec.load_benchmark()['workloads']:\n"
        "    spec.find_cell(w['name'])\n"
        "print(json.dumps(guard.forbidden_loaded()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the run would measure")
    out = subprocess.run(
        [sys.executable, os.path.join(spec.BENCH_DIR, "run.py"),
         "--workload", "tpch_sf1.q3_dash", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
