"""Host-side bound-expression evaluator over numpy (the combine phase).

A copy of the numpy half of citus_tpu/executor/exprs.py: the runner's
host combine (select list, HAVING, ORDER BY over fetched device results)
evaluates the same IR in exact float64 on the host, as the JAX package
does.  The device side is executor/exprs.py.

NULL semantics: every node returns (values, null_mask | None);
comparisons yield NULL if either side is NULL; AND/OR use Kleene logic;
WHERE treats NULL as false (`predicate_mask`).
"""

from __future__ import annotations

import numpy as np

from ..errors import ExecutionError
from ..planner import expr as ir
from ..types import DataType

_NP_DTYPE = {
    DataType.INT32: "int32", DataType.INT64: "int64",
    DataType.FLOAT32: "float32", DataType.FLOAT64: "float64",
    DataType.BOOL: "bool_", DataType.DATE: "int32",
    DataType.STRING: "int32",
}

def _dt(e_dtype: DataType, xp):
    return getattr(np, _NP_DTYPE[e_dtype])


class ColumnSource:
    """What the evaluator reads: column arrays + null masks by cid."""

    def __init__(self, columns: dict, nulls: dict | None = None):
        self.columns = columns
        self.nulls = nulls or {}

    def get(self, cid: str):
        if cid not in self.columns:
            raise ExecutionError(f"executor: missing column {cid!r}")
        return self.columns[cid], self.nulls.get(cid)


def evaluate(e: ir.BExpr, src: ColumnSource, xp=np):
    """→ (values, null_mask | None) as numpy arrays (xp is numpy)."""
    if isinstance(e, ir.BCol):
        return src.get(e.cid)
    if isinstance(e, ir.BConst):
        if isinstance(e.value, tuple):
            raise ExecutionError("unfolded interval constant reached executor")
        if e.value is None:
            # typed NULL: zeros + all-null mask (broadcast by consumers)
            return (xp.zeros((), dtype=_dt(e.dtype, xp)),
                    xp.ones((), dtype=bool))
        return (xp.asarray(e.value, dtype=_dt(e.dtype, xp)),
                None)
    if isinstance(e, ir.BParam):
        return (xp.asarray(e.value, dtype=_dt(e.dtype, xp)), None)
    if isinstance(e, ir.BArith):
        lv, ln = evaluate(e.left, src, xp)
        rv, rn = evaluate(e.right, src, xp)
        dt = _dt(e.dtype, xp)
        lv = lv.astype(dt)
        rv = rv.astype(dt)
        if e.op == "+":
            out = lv + rv
        elif e.op == "-":
            out = lv - rv
        elif e.op == "*":
            out = lv * rv
        elif e.op == "/":
            out = _safe_div(lv, rv, xp)
        elif e.op == "%":
            out = _safe_mod(lv, rv, xp)
        else:
            raise ExecutionError(f"bad arith op {e.op}")
        return out, _or_null(ln, rn, xp)
    if isinstance(e, ir.BCmp):
        lv, ln = evaluate(e.left, src, xp)
        rv, rn = evaluate(e.right, src, xp)
        if e.op == "=":
            out = lv == rv
        elif e.op == "<>":
            out = lv != rv
        elif e.op == "<":
            out = lv < rv
        elif e.op == "<=":
            out = lv <= rv
        elif e.op == ">":
            out = lv > rv
        elif e.op == ">=":
            out = lv >= rv
        else:
            raise ExecutionError(f"bad cmp op {e.op}")
        return out, _or_null(ln, rn, xp)
    if isinstance(e, ir.BBool):
        if e.op == "NOT":
            v, nmask = evaluate(e.args[0], src, xp)
            return ~v, nmask
        vals, nulls = [], []
        for a in e.args:
            v, nmask = evaluate(a, src, xp)
            vals.append(v)
            nulls.append(nmask)
        if e.op == "AND":
            out = vals[0]
            for v in vals[1:]:
                out = out & v
            # Kleene: NULL AND false = false; NULL if no operand is false
            any_null = _any_null(nulls, xp)
            if any_null is None:
                return out, None
            definite_false = _definite(vals, nulls, False, xp)
            return out, any_null & ~definite_false
        if e.op == "OR":
            out = vals[0]
            for v in vals[1:]:
                out = out | v
            any_null = _any_null(nulls, xp)
            if any_null is None:
                return out, None
            definite_true = _definite(vals, nulls, True, xp)
            return out, any_null & ~definite_true
        raise ExecutionError(f"bad bool op {e.op}")
    if isinstance(e, ir.BIsNull):
        v, nmask = evaluate(e.operand, src, xp)
        isnull = (xp.zeros(getattr(v, "shape", ()), dtype=bool)
                  if nmask is None else nmask)
        return (~isnull if e.negated else isnull), None
    if isinstance(e, ir.BInConst):
        v, nmask = evaluate(e.operand, src, xp)
        if len(e.values) == 0:
            out = xp.zeros(getattr(v, "shape", ()), dtype=bool)
        else:
            out = xp.isin(v, xp.asarray(list(e.values), dtype=v.dtype))
        if e.negated:
            out = ~out
        return out, nmask
    if isinstance(e, ir.BCase):
        dt = _dt(e.dtype, xp)
        if e.else_result is not None:
            out, nmask = evaluate(e.else_result, src, xp)
            out = xp.asarray(out, dtype=dt)
        else:
            out = xp.zeros((), dtype=dt)
            nmask = xp.ones((), dtype=bool)
        # apply WHENs in reverse so earlier branches win
        for cond, res in reversed(e.whens):
            cv, cn = evaluate(cond, src, xp)
            take = cv if cn is None else (cv & ~cn)
            rv, rn = evaluate(res, src, xp)
            out = xp.where(take, xp.asarray(rv, dtype=dt), out)
            new_null = (xp.zeros(getattr(rv, "shape", ()), dtype=bool)
                        if rn is None else rn)
            old_null = (xp.zeros((), dtype=bool) if nmask is None else nmask)
            nmask = xp.where(take, new_null, old_null)
        return out, nmask
    if isinstance(e, ir.BMath):
        v, nmask = evaluate(e.operand, src, xp)
        v = v.astype(_dt(e.dtype, xp))
        if e.op == "exp2neg":
            return xp.exp2(-v), nmask
        if e.op == "ln":
            return xp.log(v), nmask
        raise ExecutionError(f"bad math op {e.op}")
    if isinstance(e, ir.BDDBucket):
        from ..ops.sketches import dd_bucket

        v, nmask = evaluate(e.operand, src, xp)
        return dd_bucket(v.astype(_dt(DataType.FLOAT64, xp)), xp), nmask
    if isinstance(e, (ir.BHllBucket, ir.BHllRho)):
        v, nmask = evaluate(e.operand, src, xp)
        h = _hash32(v)
        if isinstance(e, ir.BHllBucket):
            out = (h >> np.uint32(32 - e.p)).astype(np.int32)
            return out, nmask
        w = (h << np.uint32(e.p)).astype(np.uint32)
        rho = _clz32(w) + 1
        cap = 32 - e.p + 1
        return xp.minimum(rho, cap).astype(np.int32), nmask
    if isinstance(e, ir.BStrRemap):
        v, nmask = evaluate(e.operand, src, xp)
        m = len(e.lut)
        if m == 0:
            # empty dictionary (all-NULL / empty column): codes are all
            # NULL_CODE — pass them through, nothing to remap
            return v, nmask
        lut = xp.asarray(list(e.lut), dtype=np.int32)
        # codes outside [0, m) are NULL_CODE or post-bind interned values
        # (stale plan — the fingerprint includes the lut, but guard the
        # gather anyway); map them to themselves → treated as NULL below
        safe = xp.clip(v, 0, m - 1)
        return xp.where((v >= 0) & (v < m), lut[safe], v), nmask
    if isinstance(e, ir.BCast):
        v, nmask = evaluate(e.operand, src, xp)
        return v.astype(_dt(e.dtype, xp)), nmask
    if isinstance(e, ir.BExtract):
        v, nmask = evaluate(e.operand, src, xp)
        return _extract_date_part(v, e.part, xp), nmask
    if isinstance(e, ir.BAgg):
        raise ExecutionError(
            "aggregate reached the scalar evaluator (planner bug)")
    raise ExecutionError(
        f"expression node {type(e).__name__} is not in this port yet")


def _hash32(v):
    """32-bit murmur-finalizer hash of an int/code column (the HLL input;
    the same fmix32 as shard routing, bit-identical to the device's)."""
    from ..catalog.distribution import hash_token

    return hash_token(np.asarray(v)).view(np.uint32)


def _clz32(w):
    """Count leading zeros of uint32 (clz(0) = 32)."""
    w64 = w.astype(np.uint64)
    # bit_length via exact float64 log2 (exact for < 2^53)
    bitlen = np.ceil(np.log2(w64.astype(np.float64) + 1.0))
    return (32 - bitlen).astype(np.int32)


def predicate_mask(e: ir.BExpr, src: ColumnSource, xp=np):
    """WHERE semantics: NULL → false."""
    v, nmask = evaluate(e, src, xp)
    if nmask is None:
        return v
    return v & ~nmask


def _or_null(a, b, xp):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def _any_null(nulls, xp):
    out = None
    for nmask in nulls:
        out = _or_null(out, nmask, xp)
    return out


def _definite(vals, nulls, truth: bool, xp):
    """Rows where some operand is definitely `truth` (not NULL)."""
    out = None
    for v, nmask in zip(vals, nulls):
        vv = v if truth else ~v
        if nmask is not None:
            vv = vv & ~nmask
        out = vv if out is None else (out | vv)
    return out


def _safe_div(lv, rv, xp):
    if np.issubdtype(np.asarray(rv).dtype if xp is np else rv.dtype,
                     np.integer):
        rv_safe = xp.where(rv == 0, xp.ones((), dtype=rv.dtype), rv)
        # SQL integer division truncates toward zero; // floors — bump the
        # quotient when signs differ and the division is inexact
        q = lv // rv_safe
        r = lv - q * rv_safe
        return q + ((r != 0) & ((lv < 0) != (rv_safe < 0))).astype(q.dtype)
    return lv / xp.where(rv == 0, xp.asarray(np.nan, dtype=rv.dtype), rv)


def _safe_mod(lv, rv, xp):
    # fmod semantics (sign of the dividend) — SQL/PG modulo truncates,
    # Python/numpy % floors; (-7) % 2 must be -1, not 1
    rv_safe = xp.where(rv == 0, xp.ones((), dtype=rv.dtype), rv)
    return xp.fmod(lv, rv_safe)


# Gregorian civil-date decomposition from days-since-epoch, branch-free
# (Howard Hinnant's civil_from_days algorithm) — runs on VPU as int math.
def _extract_date_part(days, part: str, xp):
    z = days.astype("int64") + 719468
    era = xp.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = xp.where(mp < 10, mp + 3, mp - 9)
    y = xp.where(m <= 2, y + 1, y)
    if part == "year":
        return y.astype("int32")
    if part == "month":
        return m.astype("int32")
    if part == "day":
        return d.astype("int32")
    raise ExecutionError(f"bad extract part {part}")
