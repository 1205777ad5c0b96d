"""Run one cell of BENCHMARK.json on the card(s) of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints progress lines, then as its last line one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), device, with --trace 1 breakdown, and
last the numbers compared for `correct`, each beside its limit (also
the last lines on standard error).  Exits non-zero, printing no result,
without a CUDA device for each chip the cell asks for, when the port is
missing, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_TOP = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    from portbench import cell as cellmod
    from portbench import guard, spec

    age = cellmod.process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    c = spec.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device is visible", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < c.chips:
        print(f"portbench: the cell needs {c.chips} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result, checks = cellmod.run_cell(c, args.seed, args.seconds,
                                      bool(args.trace), t_top=T_TOP,
                                      age_at_top=age)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, v, lim in checks}
    for k, v, lim in checks:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
