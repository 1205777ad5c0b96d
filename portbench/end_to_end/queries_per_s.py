"""Statements answered in the window, over all sessions, per second of
the window (from its start to the return of the last statement sent
inside it)."""

from portbench.window import queries_per_s


def read(r):
    return queries_per_s(r.log) if r.log.statements else None
