"""Finds a cell's configuration, mix, queries, references and metric
readers by the names BENCHMARK.json gives them."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load_module(path: str, kind: str):
    """Import the file at `path` (a reference or a metric reader),
    once per path."""
    path = os.path.abspath(path)
    stem = os.path.splitext(os.path.basename(path))[0]
    name = (f"portbench_{kind}_{stem}_"
            + hashlib.sha1(path.encode()).hexdigest()[:10])
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


@dataclass
class Query:
    name: str
    sql: str
    weight: float
    reference: object  # the module reference/<name>.py


@dataclass
class Metric:
    name: str
    unit: str
    reader: object  # end_to_end/<name>.py or layer_metrics/<name>.py
    moves: str | None = None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    queries: list[Query]
    end_to_end: list[Metric]
    per_layer: list[Metric]
    tables: list[str] = field(default_factory=list)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reads_cell(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def find_cell(name: str, root: str = ROOT,
              bench_dir: str = BENCH_DIR) -> Cell:
    """The cell `name` of root/BENCHMARK.json with every file it names
    read or imported from `bench_dir`."""
    bench = load_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic",
                           w["traffic"] + ".json")) as f:
        mix = json.load(f)
    if mix.get("loop") != "closed" or mix.get("think_ms", 0) != 0:
        raise ValueError(f"mix {w['traffic']!r}: the window drives closed "
                         "loops with zero think time only")
    queries = []
    for q in mix["queries"]:
        qname = q["query"]
        with open(os.path.join(bench_dir, "queries", qname + ".sql")) as f:
            sql = f.read().strip()
        ref = load_module(os.path.join(bench_dir, "reference", qname + ".py"),
                          "reference")
        queries.append(Query(qname, sql, float(q.get("weight", 1.0)), ref))

    def metrics(kind: str, folder: str) -> list[Metric]:
        return [Metric(m["name"], m["unit"],
                       load_module(os.path.join(bench_dir, folder,
                                                m["name"] + ".py"), folder),
                       m.get("moves"))
                for m in bench[kind] if _reads_cell(m, name)]

    e2e = metrics("end_to_end", "end_to_end")
    layer = metrics("per_layer", "layer_metrics")
    tables = sorted({t for q in queries for t in q.reference.READS})
    return Cell(name, int(w.get("chips", 1)), config, mix, queries, e2e,
                layer, tables)
