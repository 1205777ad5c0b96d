"""The port's torch expression evaluator vs the JAX package's
evaluate(xp=np), plus import hygiene of the port.

Every BExpr the slice's queries reach — arithmetic (integer truncating
division, fmod), comparisons, three-valued AND/OR/NOT with null masks,
IS NULL, IN lists, CASE, casts, date literals and EXTRACT, string-code
equality — is built once per package's IR and evaluated over the same
seeded columns (with NULLs).  Integers and booleans must match exactly,
float64 at rtol 1e-12.
"""

import ast
import os

import numpy as np
import pytest
import torch

from citus_tpu.executor import exprs as jexprs
from citus_tpu.planner import expr as jir
from citus_tpu.types import DataType as JDT
from citus_tpu_torch.executor import exprs as pexprs
from citus_tpu_torch.planner import expr as pir
from citus_tpu_torch.types import DataType as PDT

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 400


def _columns(rng):
    cols = {
        "t.i": rng.integers(-50, 50, N).astype(np.int32),
        "t.l": rng.integers(-10**12, 10**12, N).astype(np.int64),
        "t.f": rng.standard_normal(N) * 10,
        "t.d": rng.integers(8000, 11000, N).astype(np.int32),   # DATE
        "t.s": rng.integers(0, 5, N).astype(np.int32),          # STRING
        "t.b": rng.random(N) < 0.5,
    }
    cols["t.i"][:7] = 0  # zero divisors
    nulls = {"t.i": rng.random(N) < 0.2, "t.f": rng.random(N) < 0.2,
             "t.b": rng.random(N) < 0.3}
    return cols, nulls


def _exprs(ir, DT):
    i = ir.BCol("t.i", DT.INT32)
    lg = ir.BCol("t.l", DT.INT64)
    f = ir.BCol("t.f", DT.FLOAT64)
    d = ir.BCol("t.d", DT.DATE)
    s = ir.BCol("t.s", DT.STRING)
    b = ir.BCol("t.b", DT.BOOL)

    def c(v, t):
        return ir.BConst(v, t)

    gt = ir.BCmp(">", f, c(0.5, DT.FLOAT64))
    return {
        "add_mul": ir.BArith("*", ir.BArith("+", i, c(3, DT.INT32),
                                            DT.INT32), i, DT.INT32),
        "int_div": ir.BArith("/", lg, i, DT.INT64),
        "int_mod": ir.BArith("%", lg, i, DT.INT64),
        "float_div": ir.BArith("/", f, ir.BCast(i, DT.FLOAT64), DT.FLOAT64),
        "disc_price": ir.BArith("*", f, ir.BArith("-", c(1, DT.FLOAT64), f,
                                                  DT.FLOAT64), DT.FLOAT64),
        "cmp_le": ir.BCmp("<=", i, c(10, DT.INT32)),
        "cmp_ne": ir.BCmp("<>", lg, c(0, DT.INT64)),
        "and3": ir.BBool("AND", (gt, b, ir.BCmp("<", i, c(20, DT.INT32)))),
        "or3": ir.BBool("OR", (gt, b)),
        "not": ir.BBool("NOT", (b,)),
        "is_null": ir.BIsNull(f),
        "is_not_null": ir.BIsNull(i, negated=True),
        "in": ir.BInConst(i, (1, 2, 3, -4)),
        "not_in": ir.BInConst(s, (0, 3), negated=True),
        "case": ir.BCase(((gt, f), (b, c(-1.0, DT.FLOAT64))),
                         c(7.0, DT.FLOAT64), DT.FLOAT64),
        "case_no_else": ir.BCase(((ir.BCmp("=", s, c(2, DT.STRING)), i),),
                                 None, DT.INT32),
        "date_cmp": ir.BCmp("<", d, c(9204, DT.DATE)),
        "extract_year": ir.BExtract("year", d),
        "extract_month": ir.BExtract("month", d),
        "extract_day": ir.BExtract("day", d),
        "str_eq": ir.BCmp("=", s, c(1, DT.STRING)),
        "cast_int64": ir.BCast(i, DT.INT64),
        "null_const": ir.BArith("+", f, c(None, DT.FLOAT64), DT.FLOAT64),
        # the sketch expressions (HLL registers, DDSketch buckets and
        # the estimators' math)
        "hll_bucket_int64": ir.BHllBucket(lg, 12),
        "hll_rho_int32": ir.BHllRho(i, 12),
        "hll_rho_codes": ir.BHllRho(s, 12),
        "hll_bucket_float": ir.BHllBucket(f, 12),
        "dd_bucket": ir.BDDBucket(f),
        "exp2neg": ir.BMath("exp2neg", i),
        "ln": ir.BMath("ln", ir.BArith("*", f, f, DT.FLOAT64)),
    }


@pytest.mark.parametrize("name", sorted(_exprs(pir, PDT)))
def test_evaluator_matches_numpy_reference(rng, name):
    cols, nulls = _columns(rng)
    je = _exprs(jir, JDT)[name]
    pe = _exprs(pir, PDT)[name]
    jv, jn = jexprs.evaluate(je, jexprs.ColumnSource(cols, nulls), np)
    src = pexprs.ColumnSource(
        {k: torch.from_numpy(v) for k, v in cols.items()},
        {k: torch.from_numpy(v) for k, v in nulls.items()},
        float_dtype=torch.float64)
    pv, pn = pexprs.evaluate(pe, src)
    jv = np.broadcast_to(np.asarray(jv), (N,))
    pv = np.broadcast_to(pv.numpy(), (N,))
    jn = np.zeros(N, bool) if jn is None else np.broadcast_to(jn, (N,))
    pn = np.zeros(N, bool) if pn is None else np.broadcast_to(pn.numpy(),
                                                              (N,))
    np.testing.assert_array_equal(pn, jn)
    live = ~jn
    if np.issubdtype(jv.dtype, np.floating):
        np.testing.assert_allclose(pv[live], jv[live], rtol=1e-12,
                                   equal_nan=True)
    else:
        np.testing.assert_array_equal(pv[live], jv[live])
    # predicate semantics: NULL → false
    if jv.dtype == np.bool_:
        np.testing.assert_array_equal(
            np.broadcast_to(pexprs.predicate_mask(pe, src).numpy(), (N,)),
            np.broadcast_to(jexprs.predicate_mask(
                je, jexprs.ColumnSource(cols, nulls), np), (N,)))


def test_float_policy_follows_compute_dtype(rng):
    cols, nulls = _columns(rng)
    e = _exprs(pir, PDT)["disc_price"]
    src = pexprs.ColumnSource(
        {k: torch.from_numpy(v) for k, v in cols.items()}, {},
        float_dtype=torch.float32)
    v, _ = pexprs.evaluate(e, src)
    assert v.dtype == torch.float32


# -- import hygiene ---------------------------------------------------------

def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, "tools", f)
        for f in ("compare_grid_sums.py", "dense_grid_layouts.py",
                  "compare_bit_unpack.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "citus_tpu_torch")):
        out.extend(os.path.join(root, f) for f in files if f.endswith(".py"))
    return out


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "citus_tpu"):
                    bad.append(f"{os.path.relpath(path, REPO)}: {name}")
    scanned = {os.path.relpath(p, REPO) for p in _port_files()}
    # the modules of the fourth, eighth, ninth, tenth and eleventh slices
    # are among the scanned files
    for mod in ("executor/fastpath.py", "storage/pkindex.py",
                "planner/explain.py", "ops/sketches.py",
                "wlm/manager.py", "wlm/admission.py",
                "serving/classify.py", "serving/batcher.py",
                "serving/result_cache.py", "replication/state.py",
                "replication/shipper.py", "replication/applier.py",
                "replication/promote.py", "replication/__init__.py",
                "storage/integrity.py", "storage/table_store.py",
                "operations/cleanup.py", "operations/shard_transfer.py",
                "operations/shard_split.py", "operations/rebalancer.py",
                "operations/scrubber.py", "operations/restore_point.py",
                "operations/health.py", "background/__init__.py",
                "background/jobs.py", "background/daemon.py",
                "executor/execcache.py", "executor/graphs.py",
                "executor/runner.py", "executor/hbm.py",
                "executor/cache.py", "session.py",
                "distributed/__init__.py", "distributed/mesh.py",
                "executor/compiler.py", "executor/feed.py",
                "executor/scanpipe.py", "executor/stream.py",
                "executor/insert_select.py", "utils/faultinjection.py"):
        assert os.path.join("citus_tpu_torch", mod) in scanned
    assert len(_port_files()) > 20
    assert bad == []
