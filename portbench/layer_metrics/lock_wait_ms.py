"""Executor graphs: mean per statement of the time it waited for an
executor lock another statement held (`mesh.wait`: the compiler's run
lock or the shared CUDA graph's lock), in ms.

A program that records the wait also puts `bytes` on its `mesh.fetch`
spans; one whose fetches carry none records no wait either, and reads
nothing here."""

from portbench import spans


def read(r):
    if not any("bytes" in f["meta"] for s in r.traced
               for f in spans.named(s.trace, "mesh.fetch")):
        return None
    return 1e3 * sum(spans.seconds(s.trace, "mesh.wait")
                     for s in r.traced) / len(r.traced)
