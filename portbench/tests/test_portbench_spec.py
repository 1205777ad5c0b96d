"""BENCHMARK.json against its contract, and every configuration, mix,
query and metric found by name, including ones added by new files
alone."""

import json
import os
import re
import shutil

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def one_line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"][:2] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        <= 64 << 10


def test_names_units_and_lines(bench):
    seen = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[kind]:
            assert NAME.match(e["name"]), e["name"]
            assert (kind, e["name"]) not in seen
            seen.add((kind, e["name"]))
    for e in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in bench["configs"]:
        assert one_line(e["source"]) and one_line(e["why"])
        assert len(e["reduced"]) <= 16
        assert os.path.exists(os.path.join(spec.ROOT, e["file"]))
        assert e["file"].startswith("portbench/")
    for w in bench["workloads"]:
        assert one_line(w["why"]) and w["chips"] in (1, 4)
    for e in bench["per_layer"]:
        assert one_line(e["layer"])


def test_bounds_and_sources(bench):
    names = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in names
    for m in bench["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert "bound" not in m and m["moves"] in names
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_what_it_must(bench):
    by_cfg = {c["name"] for c in bench["configs"]}
    used = {w["config"] for w in bench["workloads"]}
    assert used == by_cfg
    assert len({(w["config"], w["traffic"])
                for w in bench["workloads"]}) == len(bench["workloads"])
    for w in bench["workloads"]:
        c = spec.find_cell(w["name"])
        e2e = {m.name for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m.moves in e2e


@pytest.mark.parametrize("name", [
    "tpch_sf1.q3_dash", "tpch_sf1.groupby_rollup"])
def test_cells_found_by_name(name):
    c = spec.find_cell(name)
    assert c.queries and c.mix["sessions"] >= 1
    assert c.tables and c.config["settings"]["shard_count"] == 32
    for q in c.queries:
        assert q.sql.lower().startswith("select")
        for attr in ("READS", "LIMITS", "RESULT_TYPES", "truth", "rows",
                     "compare", "evaluate"):
            assert hasattr(q.reference, attr), (q.name, attr)
    for m in c.end_to_end + c.per_layer:
        assert callable(m.reader.read)


def test_additions_need_new_files_only(tmp_path):
    """A new configuration, mix, query and per-layer metric: files and
    entries added, no file of the benchmark edited."""
    root = tmp_path / "repo"
    bench_dir = root / "portbench"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    b = spec.load_benchmark()

    (bench_dir / "configs" / "tpch_sf01.json").write_text(json.dumps(
        dict(json.loads((bench_dir / "configs" / "tpch_sf1.json")
                        .read_text()), name="tpch_sf01", scale_factor=0.1)))
    (bench_dir / "queries" / "q6ish.sql").write_text(
        "select sum(l_quantity) from lineitem")
    (bench_dir / "reference" / "q6ish.py").write_text(
        (bench_dir / "reference" / "rollup_orderkey.py").read_text())
    (bench_dir / "traffic" / "mixed.json").write_text(json.dumps(
        {"loop": "closed", "sessions": 3, "result_sample": 2,
         "queries": [{"query": "q3", "weight": 3},
                     {"query": "q6ish", "weight": 1}]}))
    (bench_dir / "layer_metrics" / "statements_traced.py").write_text(
        "def read(r):\n    return float(len(r.traced))\n")
    b["configs"].append({"name": "tpch_sf01", "source": "x",
                         "file": "portbench/configs/tpch_sf01.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "tpch_sf01.mixed", "config": "tpch_sf01",
                           "traffic": "mixed", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "statements_traced", "unit": "count",
                           "better": "higher", "source": "program_span",
                           "layer": "session and planner",
                           "moves": "queries_per_s",
                           "workloads": ["tpch_sf01.mixed"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    c = spec.find_cell("tpch_sf01.mixed", root=str(root),
                       bench_dir=str(bench_dir))
    assert c.config["scale_factor"] == 0.1 and c.mix["sessions"] == 3
    assert [q.name for q in c.queries] == ["q3", "q6ish"]
    assert [q.weight for q in c.queries] == [3.0, 1.0]
    assert c.tables == ["customer", "lineitem", "orders"]
    assert [m.name for m in c.per_layer] == ["statements_traced"]
    assert c.per_layer[0].reader.read(type("R", (), {"traced": [1, 2]})) \
        == 2.0
    old = spec.find_cell("tpch_sf1.q3_dash", root=str(root),
                         bench_dir=str(bench_dir))
    assert "statements_traced" not in [m.name for m in old.per_layer]
    for p, body in before.items():
        assert p.read_bytes() == body, p
