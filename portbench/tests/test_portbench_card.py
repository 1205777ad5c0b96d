"""On the card only (marker `cuda`): one short run of a cell through
the command BENCHMARK.json names, and the control on the card."""

import json
import os
import subprocess
import sys

import pytest

from portbench import spec


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run(
        [sys.executable, os.path.join(spec.BENCH_DIR, "run.py"),
         "--workload", "tpch_sf1.q3_dash", "--seed", "2147483999",
         "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] and line["device"]["kind"] == card
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"queries_per_s", "setup_s"}


@pytest.mark.cuda
@pytest.mark.parametrize("query", ["q3", "rollup_orderkey"])
def test_the_control_fails_on_the_card(card, query):
    from conftest import TINY_SF

    from portbench.datagen import tpch_gen

    ref = spec.load_module(f"{spec.BENCH_DIR}/reference/{query}.py",
                           "reference")
    data = tpch_gen.generate(TINY_SF, 7, sorted(
        {"orders"} | set(ref.READS)))
    readings = ref.compare(ref.evaluate(data, "bfloat16", "cuda"),
                           ref.truth(data))
    assert any(v > ref.LIMITS[k] for k, v in readings.items()), readings
