"""Chrome-trace / Perfetto export for recorded statement traces.

Counterpart of citus_tpu/stats/trace_export.py; both read the same
trace format, so either renders the other package's slow traces.

`python -m citus_tpu_torch.stats.trace_export <trace.json | data_dir>
[-o out.json]` reads
a persisted slow-query trace (or picks the newest one under
`<data_dir>/slow_traces/`) and emits Chrome trace-event JSON — load it
at chrome://tracing or ui.perfetto.dev.  The same conversion is
importable (:func:`chrome_trace_events`) so bench scripts can export
the trace of a measured run next to the artifact.

Event mapping: every span becomes one complete event (`ph: "X"`) with
microsecond `ts`/`dur` relative to the statement start; threads keep
their identity (`tid`), so the scanpipe producer's prefetch/encode/
transfer legs render on their own track, visibly overlapped with the
statement thread's dispatch.  A span's meta (a dispatch's ``device_ms``)
rides in its event's ``args``.
"""

from __future__ import annotations

import json
import os
import sys

from .tracing import SLOW_TRACE_DIR, phase_breakdown


def chrome_trace_events(doc: dict) -> list[dict]:
    """Trace dict (Trace.to_dict() / a persisted slow-trace JSON) →
    Chrome trace-event list."""
    events: list[dict] = []
    tid_map: dict = {}

    def tid_of(raw) -> int:
        if raw not in tid_map:
            tid_map[raw] = len(tid_map) + 1
        return tid_map[raw]

    def walk(span: dict) -> None:
        events.append({
            "name": span["name"],
            "ph": "X",
            "ts": round(span.get("t0_ms", 0.0) * 1000.0, 1),
            "dur": round(span.get("dur_ms", 0.0) * 1000.0, 1),
            "pid": 1,
            "tid": tid_of(span.get("tid", 0)),
            "args": span.get("meta", {}),
        })
        for c in span.get("children", ()):
            walk(c)

    root = doc.get("root")
    if root:
        walk(root)
    meta = {"sql": doc.get("sql"), "class": doc.get("class"),
            "wall_ms": doc.get("wall_ms"),
            "truncated": doc.get("truncated"),
            "phases_ms": {k: round(v * 1000.0, 3)
                          for k, v in phase_breakdown(root).items()}
            if root else {}}
    events.append({"name": "statement_info", "ph": "M", "pid": 1,
                   "args": meta})
    return events


def newest_slow_trace(data_dir: str) -> str | None:
    d = os.path.join(data_dir, SLOW_TRACE_DIR)
    if not os.path.isdir(d):
        return None
    names = sorted(n for n in os.listdir(d)
                   if n.startswith("trace_") and n.endswith(".json"))
    return os.path.join(d, names[-1]) if names else None


def load_trace(path: str) -> dict:
    """`path` is a trace JSON file, a data_dir, or a slow_traces dir."""
    if os.path.isdir(path):
        inner = (path if os.path.basename(path) == SLOW_TRACE_DIR
                 else None)
        p = (newest_slow_trace(os.path.dirname(path)) if inner
             else newest_slow_trace(path))
        if p is None:
            raise FileNotFoundError(
                f"no slow-query traces under {path!r} (is "
                "trace_slow_statement_ms set low enough?)")
        path = p
    with open(path) as f:
        return json.load(f)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out_path = None
    args = []
    it = iter(argv)
    for a in it:
        if a in ("-o", "--out"):
            out_path = next(it, None)
            if out_path is None:
                print("trace_export: -o needs a path", file=sys.stderr)
                return 2
        elif a in ("-h", "--help"):
            print(__doc__)
            return 0
        else:
            args.append(a)
    if len(args) != 1:
        print("usage: python -m citus_tpu_torch.stats.trace_export "
              "<trace.json | data_dir> [-o out.json]", file=sys.stderr)
        return 2
    try:
        doc = load_trace(args[0])
    except (OSError, json.JSONDecodeError) as e:
        print(f"trace_export: {e}", file=sys.stderr)
        return 1
    payload = {"traceEvents": chrome_trace_events(doc),
               "displayTimeUnit": "ms"}
    text = json.dumps(payload, indent=1)
    if out_path:
        # an export artifact, not engine durable state: the io seam's
        # checksummed atomic write is for data the engine re-reads
        with open(out_path, "w") as f:
            f.write(text)
        print(f"wrote {out_path} ({len(payload['traceEvents'])} events)")
    else:
        print(text)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
