"""Bound-expression evaluator over torch tensors.

Counterpart of citus_tpu/executor/exprs.py.  The JAX package evaluates
one IR through an `xp` slot (numpy or jax.numpy); torch does not fit that
slot, so the device side has its own evaluator here, held against the
JAX package's `evaluate(xp=np)` by the tests.  The host-side combine
(HAVING, select list, ORDER BY) runs on numpy in executor/host_exprs.py,
a copy of the numpy half.

NULL semantics: every node returns (values, null_mask | None);
comparisons are NULL if either side is; AND/OR use Kleene logic; WHERE
treats NULL as false (`predicate_mask`).

Float policy: SQL double precision evaluates in the session compute
dtype on the device (`float_dtype`), exactly as the JAX executor does.
"""

from __future__ import annotations

import torch

from ..errors import ExecutionError
from ..planner import expr as ir
from ..types import DataType

_TORCH_DTYPE = {
    DataType.INT32: torch.int32, DataType.INT64: torch.int64,
    DataType.FLOAT32: torch.float32, DataType.FLOAT64: torch.float64,
    DataType.BOOL: torch.bool, DataType.DATE: torch.int32,
    DataType.STRING: torch.int32,
}


class ColumnSource:
    """What the evaluator reads: column tensors + null masks by cid."""

    def __init__(self, columns: dict, nulls: dict | None = None,
                 device=None, float_dtype=torch.float64):
        self.columns = columns
        self.nulls = nulls or {}
        if device is None:
            first = next(iter(columns.values()), None)
            device = first.device if isinstance(first, torch.Tensor) \
                else torch.device("cpu")
        self.device = device
        self.float_dtype = float_dtype

    def get(self, cid: str):
        if cid not in self.columns:
            raise ExecutionError(f"executor: missing column {cid!r}")
        return self.columns[cid], self.nulls.get(cid)


def _dt(e_dtype: DataType, src: ColumnSource):
    if e_dtype == DataType.FLOAT64:
        return src.float_dtype
    return _TORCH_DTYPE[e_dtype]


def _const(value, dtype, src: ColumnSource) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=src.device)


def evaluate(e: ir.BExpr, src: ColumnSource):
    """→ (values, null_mask | None) as tensors on src.device."""
    if isinstance(e, ir.BCol):
        return src.get(e.cid)
    if isinstance(e, ir.BConst):
        if isinstance(e.value, tuple):
            raise ExecutionError("unfolded interval constant reached executor")
        if e.value is None:
            return (torch.zeros((), dtype=_dt(e.dtype, src),
                                device=src.device),
                    torch.ones((), dtype=torch.bool, device=src.device))
        return _const(e.value, _dt(e.dtype, src), src), None
    if isinstance(e, ir.BParam):
        return _const(e.value, _dt(e.dtype, src), src), None
    if isinstance(e, ir.BArith):
        lv, ln = evaluate(e.left, src)
        rv, rn = evaluate(e.right, src)
        dt = _dt(e.dtype, src)
        lv = lv.to(dt)
        rv = rv.to(dt)
        if e.op == "+":
            out = lv + rv
        elif e.op == "-":
            out = lv - rv
        elif e.op == "*":
            out = lv * rv
        elif e.op == "/":
            out = _safe_div(lv, rv)
        elif e.op == "%":
            rv_safe = torch.where(rv == 0, torch.ones_like(rv), rv)
            out = torch.fmod(lv, rv_safe)  # sign of the dividend, like SQL
        else:
            raise ExecutionError(f"bad arith op {e.op}")
        return out, _or_null(ln, rn)
    if isinstance(e, ir.BCmp):
        lv, ln = evaluate(e.left, src)
        rv, rn = evaluate(e.right, src)
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
        return out, _or_null(ln, rn)
    if isinstance(e, ir.BBool):
        if e.op == "NOT":
            v, nmask = evaluate(e.args[0], src)
            return ~v, nmask
        vals, nulls = [], []
        for a in e.args:
            v, nmask = evaluate(a, src)
            vals.append(v)
            nulls.append(nmask)
        if e.op not in ("AND", "OR"):
            raise ExecutionError(f"bad bool op {e.op}")
        out = vals[0]
        for v in vals[1:]:
            out = (out & v) if e.op == "AND" else (out | v)
        any_null = None
        for nmask in nulls:
            any_null = _or_null(any_null, nmask)
        if any_null is None:
            return out, None
        # Kleene: NULL AND false = false; NULL OR true = true
        definite = _definite(vals, nulls, e.op == "OR")
        return out, any_null & ~definite
    if isinstance(e, ir.BIsNull):
        v, nmask = evaluate(e.operand, src)
        isnull = (torch.zeros(v.shape, dtype=torch.bool, device=src.device)
                  if nmask is None else nmask)
        return (~isnull if e.negated else isnull), None
    if isinstance(e, ir.BInConst):
        v, nmask = evaluate(e.operand, src)
        if len(e.values) == 0:
            out = torch.zeros(v.shape, dtype=torch.bool, device=src.device)
        else:
            out = torch.isin(v, torch.tensor(list(e.values), dtype=v.dtype,
                                             device=src.device))
        if e.negated:
            out = ~out
        return out, nmask
    if isinstance(e, ir.BCase):
        dt = _dt(e.dtype, src)
        if e.else_result is not None:
            out, nmask = evaluate(e.else_result, src)
            out = out.to(dt)
        else:
            out = torch.zeros((), dtype=dt, device=src.device)
            nmask = torch.ones((), dtype=torch.bool, device=src.device)
        # apply WHENs in reverse so earlier branches win
        for cond, res in reversed(e.whens):
            cv, cn = evaluate(cond, src)
            take = cv if cn is None else (cv & ~cn)
            rv, rn = evaluate(res, src)
            out = torch.where(take, rv.to(dt), out)
            new_null = (torch.zeros(rv.shape, dtype=torch.bool,
                                    device=src.device)
                        if rn is None else rn)
            old_null = (torch.zeros((), dtype=torch.bool, device=src.device)
                        if nmask is None else nmask)
            nmask = torch.where(take, new_null, old_null)
        return out, nmask
    if isinstance(e, ir.BStrRemap):
        v, nmask = evaluate(e.operand, src)
        m = len(e.lut)
        if m == 0:
            return v, nmask
        lut = torch.tensor(list(e.lut), dtype=torch.int32, device=src.device)
        safe = torch.clamp(v, 0, m - 1).to(torch.int64)
        return torch.where((v >= 0) & (v < m), lut[safe], v), nmask
    if isinstance(e, ir.BCast):
        v, nmask = evaluate(e.operand, src)
        return v.to(_dt(e.dtype, src)), nmask
    if isinstance(e, ir.BExtract):
        v, nmask = evaluate(e.operand, src)
        return _extract_date_part(v, e.part), nmask
    if isinstance(e, ir.BAgg):
        raise ExecutionError(
            "aggregate reached the scalar evaluator (planner bug)")
    raise ExecutionError(
        f"expression node {type(e).__name__} is not in this port yet")


def predicate_mask(e: ir.BExpr, src: ColumnSource) -> torch.Tensor:
    """WHERE semantics: NULL → false."""
    v, nmask = evaluate(e, src)
    return v if nmask is None else (v & ~nmask)


def _or_null(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def _definite(vals, nulls, truth: bool):
    """Rows where some operand is definitely `truth` (not NULL)."""
    out = None
    for v, nmask in zip(vals, nulls):
        vv = v if truth else ~v
        if nmask is not None:
            vv = vv & ~nmask
        out = vv if out is None else (out | vv)
    return out


def _safe_div(lv: torch.Tensor, rv: torch.Tensor) -> torch.Tensor:
    if not rv.dtype.is_floating_point:
        rv_safe = torch.where(rv == 0, torch.ones_like(rv), rv)
        # SQL integer division truncates toward zero
        return torch.div(lv, rv_safe, rounding_mode="trunc")
    return lv / torch.where(rv == 0, torch.full_like(rv, float("nan")), rv)


def _extract_date_part(days: torch.Tensor, part: str) -> torch.Tensor:
    """Gregorian civil-date decomposition from days-since-epoch,
    branch-free (Howard Hinnant's civil_from_days)."""
    def fdiv(a, b):
        return torch.div(a, b, rounding_mode="floor")

    z = days.to(torch.int64) + 719468
    era = fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = fdiv(doe - fdiv(doe, 1460) + fdiv(doe, 36524) - fdiv(doe, 146096),
               365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + fdiv(yoe, 4) - fdiv(yoe, 100))
    mp = fdiv(5 * doy + 2, 153)
    d = doy - fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    if part == "year":
        return y.to(torch.int32)
    if part == "month":
        return m.to(torch.int32)
    if part == "day":
        return d.to(torch.int32)
    raise ExecutionError(f"bad extract part {part}")
