"""graftlint CLI for the port.

    python -m citus_tpu_torch.analysis          # lint the port (core.py's
                                                # DEFAULT_SUBDIRS)
    python -m citus_tpu_torch.analysis --json   # machine-readable
    python -m citus_tpu_torch.analysis --all    # include baselined
    python -m citus_tpu_torch.analysis --write-baseline  # regenerate
    python -m citus_tpu_torch.analysis path/to/file.py   # lint a subset

Exit status: 0 when every finding is baselined (and no baseline entry
is stale), 1 otherwise, 2 on usage errors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .core import (
    BASELINE_NAME,
    baseline_payload,
    load_baseline,
    run_lint,
    unbaselined,
)


def _repo_root() -> str:
    # citus_tpu_torch/analysis/__main__.py → repo root two levels up from the
    # package directory
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m citus_tpu_torch.analysis",
        description="graftlint: concurrency + CUDA hot-path static "
                    "analysis of the port")
    p.add_argument("paths", nargs="*",
                   help="files/dirs relative to the repo root "
                        "(default: the port, chip_smoke.py and the "
                        "port's tools scripts)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit findings as JSON")
    p.add_argument("--all", action="store_true",
                   help="show baselined findings too")
    p.add_argument("--baseline", default=None,
                   help=f"baseline path (default: <root>/{BASELINE_NAME})")
    p.add_argument("--write-baseline", action="store_true",
                   help="write the current findings as the baseline "
                        "(carries forward existing justifications)")
    p.add_argument("--root", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    root = args.root or _repo_root()
    subdirs = tuple(args.paths) or None
    baseline_path = args.baseline or os.path.join(root, BASELINE_NAME)

    if args.write_baseline and subdirs:
        print("--write-baseline requires a whole-tree run (a subset "
              "would silently drop every other file's baseline "
              "entries)", file=sys.stderr)
        return 2
    for p in subdirs or ():
        if not os.path.exists(os.path.join(root, p)):
            # a typo'd target must not lint zero files and exit green
            print(f"no such file or directory under {root}: {p}",
                  file=sys.stderr)
            return 2

    findings = (run_lint(root, subdirs) if subdirs
                else run_lint(root))
    baseline = load_baseline(baseline_path)
    fresh, stale = unbaselined(findings, baseline)
    if subdirs:
        # the baseline is tree-wide: a subset run cannot judge entries
        # for files it never scanned
        stale = []

    if args.write_baseline:
        payload = baseline_payload(findings, baseline)
        with open(baseline_path, "w", encoding="utf-8") as f:  # graftlint: ignore[raw-durable-write] — lint baseline, not data-dir durable state
            json.dump(payload, f, indent=1)
            f.write("\n")
        print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    shown = findings if args.all else fresh
    if args.as_json:
        print(json.dumps({
            "findings": [f.to_dict() for f in shown],
            "baselined": len(findings) - len(fresh),
            "stale_baseline": stale,
        }, indent=1))
    else:
        for f in shown:
            print(f)
        for key in stale:
            print(f"stale baseline entry (violation fixed — remove it): "
                  f"{key}")
        n_base = len(findings) - len(fresh)
        print(f"graftlint: {len(fresh)} finding(s), {n_base} baselined, "
              f"{len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'}")
    return 1 if fresh or stale else 0


if __name__ == "__main__":
    sys.exit(main())
