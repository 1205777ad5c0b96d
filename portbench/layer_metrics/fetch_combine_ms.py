"""Executor: mean per statement of the device-to-host fetch
(`mesh.fetch`) and the host combine (`combine`) spans, in ms."""

from portbench import spans


def read(r):
    if not r.traced:
        return None
    return 1e3 * sum(spans.seconds(s.trace, "mesh.fetch", "combine")
                     for s in r.traced) / len(r.traced)
