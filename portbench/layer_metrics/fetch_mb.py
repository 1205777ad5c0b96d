"""Executor: mean per statement of the bytes its `mesh.fetch` spans
copied back from the device (their `bytes`: packed outputs and
counters), in MB (1e6 bytes), over the statements whose every fetch
carries them."""

from portbench import spans


def read(r):
    per = []
    for s in r.traced:
        sizes = [f["meta"].get("bytes")
                 for f in spans.named(s.trace, "mesh.fetch")]
        if sizes and None not in sizes:
            per.append(sum(sizes))
    return sum(per) / len(per) / 1e6 if per else None
