"""Executor: mean per statement of the device time of its copies back to
the host, the summed `device_ms` (a CUDA event pair's timeline) of its
`mesh.fetch` spans, in ms, over the statements whose every fetch leg
was read."""

from portbench import spans


def read(r):
    per = []
    for s in r.traced:
        legs = [f["meta"].get("device_ms")
                for f in spans.named(s.trace, "mesh.fetch")]
        if legs and None not in legs:
            per.append(sum(legs))
    return sum(per) / len(per) if per else None
