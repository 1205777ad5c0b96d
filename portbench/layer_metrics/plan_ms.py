"""Session and planner: mean per statement of its `parse` and `plan`
spans, in ms."""

from portbench import spans


def read(r):
    if not r.traced:
        return None
    return 1e3 * sum(spans.seconds(s.trace, "parse", "plan")
                     for s in r.traced) / len(r.traced)
