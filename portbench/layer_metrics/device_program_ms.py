"""Kernels: mean per statement of the device time of its program, the
summed `device_ms` (a CUDA event pair's timeline) of its `mesh.dispatch`
spans, in ms, over the statements whose every dispatch leg was read."""

from portbench import spans


def read(r):
    per = []
    for s in r.traced:
        legs = [d["meta"].get("device_ms")
                for d in spans.named(s.trace, "mesh.dispatch")]
        if legs and None not in legs:
            per.append(sum(legs))
    return sum(per) / len(per) if per else None
