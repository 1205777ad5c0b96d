"""The readers of lock_wait_ms, device_program_ms, device_copy_ms and
fetch_mb on span trees made by hand, including those of a program that
records no lock wait, no copy leg and no fetched bytes."""

from types import SimpleNamespace

import pytest

from portbench import spec

NEW = ("lock_wait_ms", "device_program_ms", "device_copy_ms", "fetch_mb")


def reader(name):
    return spec.load_module(f"{spec.BENCH_DIR}/layer_metrics/{name}.py",
                            "layer_metrics")


def span(name, t0, t1, children=(), **meta):
    return {"name": name, "t0": t0, "t1": t1, "meta": meta,
            "children": list(children)}


def stmt(wait_s=0.0, program=(1.0,), copy=(0.5,), fetched=(1000,)):
    """One statement's tree: an optional `mesh.wait`, then a dispatch and
    a fetch per entry of `program` / `copy` (None: a leg never read;
    `fetched` None: a fetch without bytes)."""
    kids, t = [], 0.0
    if wait_s:
        kids.append(span("mesh.wait", t, t + wait_s, lock="graph"))
        t += wait_s
    for i, ms in enumerate(program):
        meta = {} if ms is None else {"device_ms": ms}
        kids.append(span("mesh.dispatch", t, t + 0.001, **meta))
        meta = {}
        if copy[i] is not None:
            meta["device_ms"] = copy[i]
        if fetched is not None:
            meta["bytes"] = fetched[i]
        kids.append(span("mesh.fetch", t + 0.001, t + 0.002, **meta))
        t += 0.002
    return SimpleNamespace(trace=span("statement", 0.0, t + 0.001, [
        span("execute", 0.0, t, kids)]))


def readings(*stmts):
    return SimpleNamespace(traced=list(stmts))


def test_lock_wait_is_the_mean_over_every_statement():
    r = readings(stmt(wait_s=0.005), stmt(), stmt(wait_s=0.010))
    assert reader("lock_wait_ms").read(r) == pytest.approx(5.0)
    # a program whose fetches carry bytes and which never waited reads 0
    assert reader("lock_wait_ms").read(readings(stmt())) == 0.0


def test_device_legs_sum_per_statement_over_those_read():
    r = readings(stmt(program=(1.0, 2.0), copy=(0.5, 0.25),
                      fetched=(10, 20)),
                 stmt(program=(3.0,), copy=(1.25,)),
                 stmt(program=(None,), copy=(None,)))
    assert reader("device_program_ms").read(r) == pytest.approx(3.0)
    assert reader("device_copy_ms").read(r) == pytest.approx(1.0)


def test_fetched_bytes_in_megabytes():
    r = readings(stmt(program=(1.0, 1.0), copy=(0.1, 0.1),
                      fetched=(1_500_000, 500_000)),
                 stmt(fetched=(4_000_000,)))
    assert reader("fetch_mb").read(r) == pytest.approx(3.0)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_reads_nothing(name):
    assert reader(name).read(readings()) is None
    # a CPU run: no leg is ever timed
    cpu = readings(stmt(program=(None,), copy=(None,)))
    if name in ("device_program_ms", "device_copy_ms"):
        assert reader(name).read(cpu) is None


@pytest.mark.parametrize("name", ["lock_wait_ms", "device_copy_ms",
                                  "fetch_mb"])
def test_a_program_without_the_new_spans_reads_nothing(name):
    """The parent of these metrics: a timed dispatch, a fetch with
    neither a leg nor bytes, no wait span."""
    r = readings(stmt(copy=(None,), fetched=None),
                 stmt(copy=(None,), fetched=None))
    assert reader(name).read(r) is None
    assert reader("device_program_ms").read(r) == pytest.approx(1.0)


@pytest.mark.parametrize("cell,want", [
    ("tpch_sf1.q3_dash", set(NEW)),
    ("tpch_sf1.groupby_rollup", set(NEW) - {"lock_wait_ms"})])
def test_cells_read_the_new_metrics(cell, want):
    c = spec.find_cell(cell)
    got = {m.name for m in c.per_layer} & set(NEW)
    assert got == want
    assert {m.moves for m in c.per_layer if m.name in want} == \
        {"queries_per_s"}
