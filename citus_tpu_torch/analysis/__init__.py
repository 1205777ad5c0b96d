"""graftlint for the port: concurrency + CUDA hot-path static analysis.

The JAX package's citus_tpu/analysis, aimed at citus_tpu_torch/ (plus
chip_smoke.py and the port's tools scripts; core.DEFAULT_SUBDIRS).  The
port shares the JAX package's concurrency (per-data_dir managers, the
WLM gate, the serving batcher, background jobs) and adds its own (the
graph capture gate, the mesh), so the same two failure classes are
machine-checked.  Four static rule families:

* **lock discipline** (`lockgraph.py`) — the static lock-acquisition
  graph, interprocedural through direct calls: cycles (potential
  deadlocks), writes to guarded attributes outside their owning lock,
  and raw ``.acquire()``;
* **CUDA hot-path hygiene** (`hotpath.py`) — host syncs and Python
  branches on tensor values inside what a CUDA graph captures
  (``PlanCompiler._dispatch`` and its callees), syncs inside the
  streaming loops, and graph / kernel-library rebuilds inside loops;
* **registry sync** (`registries.py`) — fault points, counters, config
  vars, EXPLAIN tags and span names used in source against their
  registries, both ways;
* **error/resource discipline** (`discipline.py`) — bare and swallowing
  excepts, silent broad handlers, threads nobody owns, durable writes
  outside ``utils/io``, and host→device transfers outside the
  ``executor/hbm`` accounted seam and the ``distributed/mesh`` seam.

Findings are suppressed inline (``# graftlint: ignore[rule]``) or by
``citus_tpu_torch/analysis/lint_baseline.json``, where every entry
carries a ``why``.  CLI: ``python -m citus_tpu_torch.analysis [--json]``.

The runtime half (`sanitizer.py`) is the lock-order sanitizer, armed at
``import citus_tpu_torch`` by ``CITUS_TPU_TORCH_TSAN=1`` or
programmatically (the chaos soak, tests/test_torch_chaos.py).
"""

from __future__ import annotations

from .core import (  # noqa: F401
    Finding,
    collect_modules,
    load_baseline,
    run_lint,
    unbaselined,
)
