"""The control of `correct`, on the card: the reference itself put in the
program's place and computed in bfloat16, the nearest precision below
the configurations' float32, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

For each seed and each query of the cell's mix, one JSON line with the
readings of every number compared: the bfloat16 control's (which has to
fail a limit) and, as a further witness, the reference's in float32 on
the card.  The program's own readings are the `checks` of its runs
(run.py).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(query, data, truth, dtype: str, device: str) -> dict:
    ref = query.reference
    return ref.compare(ref.evaluate(data, dtype, device), truth)


def main(argv=None) -> int:
    from portbench import spec
    from portbench.datagen import tpch_gen

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    c = spec.find_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",") if s):
        data = tpch_gen.generate(c.config["scale_factor"], seed, c.tables)
        for q in c.queries:
            truth = q.reference.truth(data)
            for dtype in ("bfloat16", "float32"):
                t0 = time.perf_counter()
                r = readings(q, data, truth, dtype, args.device)
                over = {k: v for k, v in r.items()
                        if v > q.reference.LIMITS[k]}
                print(json.dumps({"workload": c.name, "seed": seed,
                                  "query": q.name, "dtype": dtype,
                                  "readings": r, "over_limit": over,
                                  "seconds": time.perf_counter() - t0}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
