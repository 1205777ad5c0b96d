"""The result hand-off (citus_tpu_torch/executor/handoff.py) on CPU torch.

The device program compacts every output lane under its valid mask at
the lane's own dtype, and the fetch copies only the rows into the
session thread's host staging.  Each case holds the rows handed back to
a plain numpy selection of the same lanes (`lane[valid]`, positions
concatenated in order), bit for bit: directly on the compaction and the
fetch, and end to end, where a spy on `handoff.compact` keeps the lanes
each position's program produced.  Further: no result aliases the
staging, which the next statement overwrites, and the counters and the
`mesh.fetch` meta that say how much the compaction saved.
"""

import copy
import tempfile

import numpy as np
import pytest
import torch

import citus_tpu_torch
from citus_tpu_torch.executor import handoff
from citus_tpu_torch.executor import runner as prunner
from citus_tpu_torch.executor.compiler import Capacities
from citus_tpu_torch.executor.handoff import (
    ResultStaging,
    compact,
    unpack_outputs,
)
from citus_tpu_torch.ingest.copy_from import insert_rows
from citus_tpu_torch.sql import parse
from citus_tpu_torch.stats import counters as psc

torch.set_num_threads(1)

F32_SPECIAL = np.array([-0.0, np.nan, np.inf, -np.inf, 1e-40, -1e-45,
                        1.17e-38, 3.4e38], dtype=np.float32)
F64_SPECIAL = np.array([-0.0, np.nan, np.inf, -np.inf, 5e-324, 1e-310],
                       dtype=np.float64)
# the lanes a plan can hand back: keys, sums in both widths, booleans,
# DATE day numbers and dictionary codes, and NULL masks
KINDS = [("k", np.int64), ("f", np.float32), ("d", np.float64),
         ("b", np.bool_), ("dt", np.int32), ("s", np.int32)]


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def _position(rng, cap: int, share: float):
    """One position's lanes, valid mask and out_meta, in `_body`'s order
    (columns, then the NULL masks of the columns that have one)."""
    lanes, meta = [], []
    for cid, dt in KINDS:
        if dt == np.float32:
            a = rng.standard_normal(cap).astype(np.float32)
            a[:min(cap, 8)] = F32_SPECIAL[:min(cap, 8)]
        elif dt == np.float64:
            a = rng.standard_normal(cap)
            a[:min(cap, 6)] = F64_SPECIAL[:min(cap, 6)]
        elif dt == np.bool_:
            a = rng.random(cap) < 0.5
        elif dt == np.int64:
            a = rng.integers(-(1 << 62), 1 << 62, cap)
        else:
            a = rng.integers(-40_000, 40_000, cap).astype(np.int32)
        lanes.append(a)
        meta.append(("col", cid, np.dtype(dt)))
    for cid, _dt in KINDS[::2]:
        lanes.append(rng.random(cap) < 0.2)
        meta.append(("null", cid, np.dtype(np.bool_)))
    valid = rng.random(cap) < share
    return lanes, valid, meta


def _fetch(positions, staging=None, overflow=0):
    """Compact every position, stack the blocks as `_dispatch` does and
    fetch them with a counter vector of [overflow, 0, *rows]."""
    bufs, ns = [], []
    for lanes, valid, meta in positions:
        buf, n = compact([torch.from_numpy(a) for a in lanes],
                         torch.from_numpy(valid), meta)
        bufs.append(buf)
        ns.append(n)
    counters = torch.stack([torch.tensor(overflow), torch.tensor(0)] + ns)
    staging = staging or ResultStaging()
    return staging.fetch(torch.stack(bufs), counters, positions[0][2], 0)


@pytest.mark.parametrize("cap", [1, 1000, 4099])
@pytest.mark.parametrize("share", [0.0, 0.37, 1.0])
def test_fetched_rows_are_the_numpy_selection(cap, share):
    rng = np.random.default_rng(cap + int(share * 100))
    lanes, valid, meta = _position(rng, cap, share)
    out, k = _fetch([(lanes, valid, meta)])
    assert list(k) == [0, 0]
    assert out.rows == [int(valid.sum())] and out.slots == cap
    cols, nulls = unpack_outputs(out, meta)
    for a, (kind, cid, dt) in zip(lanes, meta):
        got = (cols if kind == "col" else nulls)[cid]
        assert got.dtype == dt
        assert np.array_equal(_bits(got), _bits(a[valid])), (kind, cid)
    # only the rows' bytes and their count come back
    assert out.nbytes == 8 + int(valid.sum()) * sum(
        dt.itemsize for _k, _c, dt in meta)


def test_float32_specials_come_back_bit_for_bit():
    a = np.tile(F32_SPECIAL, 3)
    valid = np.zeros(len(a), dtype=bool)
    valid[::2] = valid[1::3] = True
    meta = [("col", "f", np.dtype(np.float32))]
    out, _k = _fetch([([a], valid, meta)])
    (got,) = unpack_outputs(out, meta)[0].values()
    assert np.array_equal(got.view(np.uint32), a[valid].view(np.uint32))
    assert np.signbit(got[0]) and np.isnan(got).sum() == np.isnan(
        a[valid]).sum()


def test_two_positions_come_back_position_major():
    rng = np.random.default_rng(7)
    p0 = _position(rng, 640, 0.3)
    p1 = _position(rng, 640, 0.6)
    p1 = (p1[0], p1[1], p0[2])
    out, _k = _fetch([p0, p1])
    assert out.rows == [int(p0[1].sum()), int(p1[1].sum())]
    assert out.slots == 2 * 640
    cols, nulls = unpack_outputs(out, p0[2])
    for i, (kind, cid, _dt) in enumerate(p0[2]):
        want = np.concatenate([p0[0][i][p0[1]], p1[0][i][p1[1]]])
        got = (cols if kind == "col" else nulls)[cid]
        assert np.array_equal(_bits(got), _bits(want)), (kind, cid)


def test_an_overflowed_run_hands_back_nothing():
    rng = np.random.default_rng(3)
    lanes, valid, meta = _position(rng, 300, 0.5)
    out, k = _fetch([(lanes, valid, meta)], overflow=5)
    assert k[0] == 5 and out.rows == [0] and out.nbytes == 8
    assert all(len(a) == 0 for a in unpack_outputs(out, meta)[0].values())


def test_staging_grows_geometrically_and_is_reused():
    counters = psc.StatCounters()
    staging = ResultStaging(counters)
    rng = np.random.default_rng(5)
    small = _position(rng, 256, 1.0)
    big = _position(rng, 40_000, 1.0)
    grows = []
    for pos in (small, big, small, big, big, small):
        _fetch([pos], staging)
        grows.append(counters.snapshot()[psc.RESULT_STAGING_GROWS_TOTAL])
    assert grows == [1, 2, 2, 2, 2, 2]
    snap = counters.snapshot()
    assert snap[psc.RESULT_ROWS_FETCHED_TOTAL] == 3 * 256 + 3 * 40_000
    assert snap[psc.RESULT_SLOTS_TOTAL] == 3 * 256 + 3 * 40_000


# -- end to end ---------------------------------------------------------

N_ROWS = 3000
COLUMNS = ["k", "i", "f", "d", "b", "dt", "s"]


def _rows(seed: int, n: int, lo: int = 0) -> list:
    rng = np.random.default_rng(seed)
    f32 = list(F32_SPECIAL.astype(float))
    f64 = list(F64_SPECIAL) + [1e-300]
    out = []
    for j in range(n):
        k = lo + j
        f = f32[j % len(f32)] if j % 5 == 0 else float(
            rng.standard_normal())
        d = f64[j % len(f64)] if j % 7 == 0 else float(
            rng.standard_normal())
        row = [k, int(rng.integers(-10**12, 10**12)), f, d,
               bool(rng.random() < 0.5),
               str(np.datetime64("1992-01-01")
                   + np.timedelta64(int(rng.integers(0, 2500)), "D")),
               f"s{int(rng.integers(0, 40))}"]
        for c in range(1, 7):
            if rng.random() < 0.15:
                row[c] = None
        out.append(row)
    return out


def _connect(d, **kw):
    kw.setdefault("serving_result_cache_bytes", 0)
    kw.setdefault("enable_fast_path_router", False)
    return citus_tpu_torch.connect(d, device="cpu", shard_count=4, **kw)


def _load(s, rows) -> None:
    s.execute("create table h (k bigint, i bigint, f real, "
              "d double precision, b boolean, dt date, s text)")
    s.execute("select create_distributed_table('h', 'k')")
    insert_rows(s, "h", list(COLUMNS), [list(r) for r in rows])


class Seen(list):
    """Every position's uncompacted lanes, valid mask and out_meta, by
    call, and what the host unpacked (`unpacked`), as numpy copies."""

    unpacked: list


@pytest.fixture
def lanes_seen(monkeypatch):
    seen = Seen()
    seen.unpacked = []
    real, real_unpack = handoff.compact, prunner.unpack_outputs

    def spy(lanes, valid, meta):
        seen.append(([a.clone().numpy() for a in lanes],
                     valid.clone().numpy(), list(meta)))
        return real(lanes, valid, meta)

    def unpack(out, meta):
        cols, nulls = real_unpack(out, meta)
        seen.unpacked.append(({c: a.copy() for c, a in cols.items()},
                              {c: a.copy() for c, a in nulls.items()}))
        return cols, nulls

    monkeypatch.setattr(handoff, "compact", spy)
    monkeypatch.setattr(prunner, "unpack_outputs", unpack)
    return seen


def _raw(s, sql):
    plan, cleanup = s._plan_select(parse(sql)[0])
    assert not cleanup
    return plan, s.executor.execute_plan(plan, raw=True)


def _assert_selection(plan, res, calls, unpacked):
    """What the host unpacked is the positions' lanes selected by their
    valid masks, concatenated position-major, bit for bit; so is every
    column the raw result passes through."""
    meta = calls[0][2]
    want = {}
    for i, (kind, cid, _dt) in enumerate(meta):
        want[(kind, cid)] = np.concatenate([c[0][i][c[1]] for c in calls])
    n = sum(int(c[1].sum()) for c in calls)
    cols, nulls = unpacked
    assert len(cols) + len(nulls) == len(meta)
    for (kind, cid), a in want.items():
        got = (cols if kind == "col" else nulls)[cid]
        assert got.dtype == a.dtype
        assert np.array_equal(_bits(got), _bits(a)), (kind, cid)
    assert res.device_rows == [int(c[1].sum()) for c in calls]
    assert res.device_rows_scanned == sum(len(c[1]) for c in calls)
    if plan.host_having is not None:
        return
    assert res.row_count == n
    passed = 0
    for (e, _n), name in zip(plan.host_select, res.column_names):
        if not hasattr(e, "cid"):
            continue
        got = res.columns[name]
        assert np.array_equal(_bits(got), _bits(want[("col", e.cid)])), name
        nm = want.get(("null", e.cid), np.zeros(n, dtype=bool))
        assert np.array_equal(res.null_masks[name], nm), name
        passed += 1
    assert passed >= 2


SELECTIONS = {
    "none": "select k, i, f, d, b, dt, s from h where k < 0",
    "part": "select k, i, f, d, b, dt, s from h where i > 0",
    "all": "select k, i, f, d, b, dt, s from h",
    "grouped": "select s, count(*), sum(d), sum(f), min(dt), max(i) "
               "from h group by s",
}


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """{compute dtype: data_dir} holding table h."""
    out = {}
    for dt in ("float32", "float64"):
        d = str(tmp_path_factory.mktemp("handoff") / dt)
        s = _connect(d, compute_dtype=dt)
        _load(s, _rows(11, N_ROWS))
        s.close()
        out[dt] = d
    return out


@pytest.mark.parametrize("compute", ["float32", "float64"])
@pytest.mark.parametrize("query", list(SELECTIONS))
def test_results_are_the_numpy_selection_of_the_lanes(loaded, lanes_seen,
                                                      compute, query):
    s = _connect(loaded[compute], compute_dtype=compute)
    plan, res = _raw(s, SELECTIONS[query])
    # the last dispatch's lanes are the ones handed back
    _assert_selection(plan, res, lanes_seen[-1:], lanes_seen.unpacked[-1])
    if query == "none":
        assert res.row_count == 0
    elif query == "all":
        assert res.row_count == N_ROWS
    dtypes = {m[2] for m in lanes_seen[-1][2]}
    assert np.dtype(compute) in dtypes and np.dtype(np.bool_) in dtypes
    s.close()


def test_a_two_position_plan_keeps_its_rows_per_position(lanes_seen):
    d = tempfile.mkdtemp(prefix="handoff-mesh-")
    s = _connect(d + "/d", n_devices=2, compute_dtype="float64")
    _load(s, _rows(12, 2000))
    lanes_seen.clear()
    plan, res = _raw(s, "select k, i, d, s, dt from h where b")
    assert len(lanes_seen) == 2  # one program per position
    _assert_selection(plan, res, lanes_seen, lanes_seen.unpacked[-1])
    assert min(res.device_rows) > 0
    # the same rows through the session, per position as the host keeps
    # them
    r = s.execute("select k from h where b")
    assert r.device_rows == res.device_rows
    assert list(r.columns["k"]) == list(res.columns["k"])
    s.close()


def test_a_grouped_plan_reruns_after_a_capacity_overflow(loaded, lanes_seen,
                                                         monkeypatch):
    real = prunner.Executor._initial_capacities

    def tight(self, plan, feeds, dense_off=False):
        caps = real(self, plan, feeds, dense_off=dense_off)
        return Capacities(caps.repartition, caps.join_out,
                          {k: 128 for k in caps.agg_out}, caps.dense_off,
                          caps.scan_out, caps.output_repart,
                          caps.bucket_probe, caps.agg_bucket)

    sql = "select i, count(*), sum(d) from h group by i"
    s = _connect(loaded["float64"], compute_dtype="float64")
    want = s.execute(sql)
    s.close()
    monkeypatch.setattr(prunner.Executor, "_initial_capacities", tight)
    s = _connect(loaded["float64"], compute_dtype="float64",
                 exec_cache_enabled=False)
    lanes_seen.clear()
    plan, res = _raw(s, sql)
    assert res.retries >= 1 and len(lanes_seen) >= 2
    assert res.row_count > 128
    _assert_selection(plan, res, lanes_seen[-1:], lanes_seen.unpacked[-1])
    got = s.execute(sql)
    assert sorted(map(repr, got.rows())) == sorted(map(repr, want.rows()))
    s.close()


# -- no result aliases the staging ----------------------------------------

ROLLUP_A = "select g, count(*), sum(d) from r group by g"
ROLLUP_B = "select g, min(k), max(d), sum(k) from r where k > 100 group by g"


@pytest.fixture
def rollups(tmp_path):
    s = _connect(str(tmp_path / "d"), compute_dtype="float64",
                 trace_fast_statement_ms=0)
    s.execute("create table r (k bigint, g bigint, d double precision)")
    s.execute("select create_distributed_table('r', 'k')")
    rng = np.random.default_rng(4)
    insert_rows(s, "r", ["k", "g", "d"],
                [[k, k % 1000, float(rng.standard_normal())]
                 for k in range(6000)])
    yield s
    s.close()


def _snapshot(res):
    return ({n: np.array(res.columns[n], copy=True)
             for n in res.column_names},
            copy.deepcopy(res.null_masks))


def _same(res, snap):
    cols, nulls = snap
    for n in res.column_names:
        assert np.array_equal(np.asarray(res.columns[n]), cols[n]), n
    if nulls is not None:
        for n, m in nulls.items():
            assert np.array_equal(res.null_masks[n], m), n


def test_no_result_aliases_the_staging(rollups):
    s = rollups
    first = s.execute(ROLLUP_A)
    assert first.row_count == 1000
    keep = _snapshot(first)
    plan, raw = _raw(s, ROLLUP_A)
    keep_raw = _snapshot(raw)
    s.execute(ROLLUP_B)
    again = s.execute(ROLLUP_A)
    _raw(s, ROLLUP_B)
    _same(first, keep)
    _same(raw, keep_raw)
    assert sorted(map(repr, again.rows())) == sorted(map(repr, first.rows()))
    # INSERT..SELECT reads the raw rows; what lands is the source's
    s.execute("create table t (g bigint, c bigint, d double precision)")
    s.execute("select create_distributed_table('t', 'g')")
    s.execute("insert into t " + ROLLUP_A)
    s.execute(ROLLUP_B)
    landed = s.execute("select g, c, d from t")
    assert sorted(map(repr, landed.rows())) == sorted(
        map(repr, first.rows()))
    _same(first, keep)


def test_fetch_meta_and_counters_say_what_the_compaction_saved(rollups,
                                                              lanes_seen):
    s = rollups
    for _ in range(2):  # settle the plan and the staging
        s.execute(ROLLUP_A)
        s.execute(ROLLUP_B)
    c0 = s.stats.counters.snapshot()
    res = [s.execute(q) for q in (ROLLUP_A, ROLLUP_B, ROLLUP_A)]
    c1 = s.stats.counters.snapshot()
    assert c1[psc.RESULT_STAGING_GROWS_TOTAL] == \
        c0[psc.RESULT_STAGING_GROWS_TOTAL] >= 1
    rows = c1[psc.RESULT_ROWS_FETCHED_TOTAL] - \
        c0[psc.RESULT_ROWS_FETCHED_TOTAL]
    slots = c1[psc.RESULT_SLOTS_TOTAL] - c0[psc.RESULT_SLOTS_TOTAL]
    assert rows == sum(r.row_count for r in res)
    assert slots == sum(r.device_rows_scanned for r in res)
    assert 0 < rows < slots
    # citus_stat_counters keeps the JAX package's names; the snapshot
    # carries the port's own
    names = {n for n, _v in s.execute("select citus_stat_counters()").rows()}
    assert psc.RESULT_SLOTS_TOTAL not in names
    assert set(psc.PORT_COUNTERS) <= set(c1)

    r = s.execute(ROLLUP_A)
    root = s.stats.tracing.last_trace()["root"]
    (fetch,) = _find(root, "mesh.fetch")
    m = fetch["meta"]
    assert m["rows"] == r.row_count == 1000
    assert m["slots"] == r.device_rows_scanned > m["rows"]
    # the rows of every lane at its own width; the rest is the counter
    # vector
    meta = lanes_seen[-1][2]
    assert {dt.itemsize for _k, _c, dt in meta} == {8, 1}
    lane_bytes = m["rows"] * sum(dt.itemsize for _k, _c, dt in meta)
    extra = m["bytes"] - lane_bytes
    assert 0 < extra <= 8 * 16 and extra % 8 == 0


def _find(span, name, out=None):
    out = [] if out is None else out
    if span["name"] == name:
        out.append(span)
    for c in span.get("children", ()):
        _find(c, name, out)
    return out
