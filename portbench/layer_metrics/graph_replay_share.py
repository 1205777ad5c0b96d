"""Executor graphs: share of the statements whose device dispatch
replayed a captured CUDA graph (the `mesh.dispatch` span's graph tag)."""

from portbench import spans


def read(r):
    disp = [s for s in r.traced if spans.named(s.trace, "mesh.dispatch")]
    if not disp:
        return None
    return sum(any(d["meta"].get("graph") == "replay"
                   for d in spans.named(s.trace, "mesh.dispatch"))
               for s in disp) / len(disp)
