"""The port's span trees as plain dicts on the host's clock.

`plain(span)` copies a recorded span (any object with name, t0, t1,
meta and children, as `Session.stats.tracing.traces()` returns them)
into {"name", "t0", "t1", "meta", "children"} with absolute
`time.perf_counter` seconds, so the metric readers depend on nothing of
the port.
"""

from __future__ import annotations


def plain(span) -> dict:
    t1 = span.t1 if span.t1 is not None else span.t0
    return {"name": span.name, "t0": span.t0, "t1": t1,
            "meta": dict(span.meta) if span.meta else {},
            "children": [plain(c) for c in sorted(list(span.children),
                                                   key=lambda c: c.t0)]}


def walk(tree: dict):
    yield tree
    for c in tree["children"]:
        yield from walk(c)


def named(tree: dict, *names: str) -> list[dict]:
    want = set(names)
    return [s for s in walk(tree) if s["name"] in want]


def seconds(tree: dict, *names: str) -> float:
    """Summed duration of the spans named `names` (a span inside another
    of them counts too: the names given never nest in the port)."""
    return sum(s["t1"] - s["t0"] for s in named(tree, *names))


def innermost_at(tree: dict, t: float) -> str | None:
    """The name of the deepest span open at time `t`, or None."""
    if not tree["t0"] <= t < tree["t1"]:
        return None
    for c in tree["children"]:
        inner = innermost_at(c, t)
        if inner is not None:
            return inner
    return tree["name"]
