"""Host-side AST expression evaluator over decoded numpy columns.

Counterpart of citus_tpu/executor/host_eval.py.
Used where evaluation must cross table boundaries with raw (dictionary-
decoded) values — MERGE join/action conditions and assignment expressions
(the reference plans MERGE with the insert-select machinery,
Citus src/backend/distributed/planner/merge_planner.c:1245) —
and by test oracles.  Unlike executor.exprs (which runs over bound IR with
per-table dictionary codes), strings here are numpy object arrays compared
by value, so `target.name = source.name` is correct across tables with
different dictionaries.

Values are (values, null_mask | None) pairs, numpy only.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np

from ..errors import ExecutionError
from ..sql import ast
from ..types import date_to_days


class Scope:
    """Column name resolution: qualified 'alias.col' and bare 'col'.

    Bare names that exist under several qualifiers are ambiguous and
    rejected at lookup time (PostgreSQL raises the same way).
    """

    def __init__(self):
        self._cols: dict[str, tuple] = {}
        self._bare: dict[str, object] = {}

    _AMBIGUOUS = object()

    def add(self, qualifier: str, name: str, values, nulls=None):
        self._cols[f"{qualifier}.{name}"] = (values, nulls)
        if name in self._bare and self._bare[name] != f"{qualifier}.{name}":
            self._bare[name] = self._AMBIGUOUS
        else:
            self._bare[name] = f"{qualifier}.{name}"

    def resolve(self, ref: ast.ColumnRef):
        if ref.table:
            key = f"{ref.table}.{ref.name}"
            if key not in self._cols:
                raise ExecutionError(f"column {key} does not exist")
            return self._cols[key]
        slot = self._bare.get(ref.name)
        if slot is None:
            raise ExecutionError(f"column {ref.name!r} does not exist")
        if slot is self._AMBIGUOUS:
            raise ExecutionError(f"column reference {ref.name!r} is ambiguous")
        return self._cols[slot]


_guard_state = threading.local()


@contextlib.contextmanager
def _guarded():
    """Marks evaluation of a CASE branch result: per-row guards may
    exclude the rows whose divisors are zero, so raising is wrong."""
    prev = getattr(_guard_state, "depth", 0)
    _guard_state.depth = prev + 1
    try:
        yield
    finally:
        _guard_state.depth = prev


def _check_divisor(rv, rn, ln=None) -> None:
    """PostgreSQL raises division_by_zero for any non-NULL zero divisor
    (a NULL on EITHER side short-circuits the strict operator to NULL).
    Suppressed inside CASE branches (see _guarded) where the old
    masked-NaN behavior applies."""
    if getattr(_guard_state, "depth", 0):
        return
    rv = np.asarray(rv)
    zero = rv == 0
    if rn is not None:
        zero = zero & ~np.broadcast_to(rn, rv.shape)
    if ln is not None:
        zero = zero & ~np.broadcast_to(ln, zero.shape)
    if np.any(zero):
        raise ExecutionError("division by zero")


def _null_or(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def eval_expr(e: ast.Expr, scope: Scope):
    """→ (values, null_mask | None); values is a numpy array or scalar."""
    if isinstance(e, ast.Literal):
        if e.value is None:
            return np.zeros((), dtype=np.int32), np.ones((), dtype=bool)
        if e.type_hint == "date":
            return np.asarray(date_to_days(str(e.value))), None
        if isinstance(e.value, str):
            return np.asarray(e.value, dtype=object), None
        return np.asarray(e.value), None
    if isinstance(e, ast.ColumnRef):
        return scope.resolve(e)
    if isinstance(e, ast.UnaryOp):
        v, nm = eval_expr(e.operand, scope)
        if e.op == "-":
            return -v, nm
        if e.op.upper() == "NOT":
            # NOT NULL is NULL (null mask passes through)
            return ~np.asarray(v, dtype=bool), nm
        raise ExecutionError(f"bad unary op {e.op}")
    if isinstance(e, ast.BinaryOp):
        lv, ln = eval_expr(e.left, scope)
        rv, rn = eval_expr(e.right, scope)
        op = e.op.upper() if e.op.isalpha() else e.op
        if op in ("AND", "OR"):
            # full Kleene 3VL: NULL AND false = false, NULL AND true = NULL,
            # NULL OR true = true, NULL OR false = NULL — so NOT above a
            # composite still treats NULL correctly
            lb, rb = np.asarray(lv, dtype=bool), np.asarray(rv, dtype=bool)
            any_null = _null_or(ln, rn)
            if op == "AND":
                out = lb & rb
                if any_null is None:
                    return out, None
                lfalse = ~lb if ln is None else (~lb & ~ln)
                rfalse = ~rb if rn is None else (~rb & ~rn)
                definite_false = lfalse | rfalse
                return out, np.broadcast_to(any_null, np.shape(
                    definite_false)) & ~definite_false
            out = lb | rb
            if any_null is None:
                return out, None
            ltrue = lb if ln is None else (lb & ~ln)
            rtrue = rb if rn is None else (rb & ~rn)
            definite_true = ltrue | rtrue
            return out, np.broadcast_to(any_null, np.shape(
                definite_true)) & ~definite_true
        if op in ("=", "<>", "<", "<=", ">", ">="):
            out = _compare(op, lv, rv)
            return out, _null_or(ln, rn)
        if op == "||":
            ls = np.char.array(lv.astype(str) if hasattr(lv, "astype") else lv)
            rs = np.char.array(rv.astype(str) if hasattr(rv, "astype") else rv)
            return np.asarray(ls + rs, dtype=object), _null_or(ln, rn)
        if op in ("+", "-", "*", "/", "%"):
            lv = np.asarray(lv)
            rv = np.asarray(rv)
            if op == "+":
                out = lv + rv
            elif op == "-":
                out = lv - rv
            elif op == "*":
                out = lv * rv
            elif op == "/":
                _check_divisor(rv, rn, ln)
                if np.issubdtype(np.result_type(lv, rv), np.integer):
                    rv_safe = np.where(rv == 0, 1, rv)
                    q = lv // rv_safe
                    r = lv - q * rv_safe
                    out = q + ((r != 0) & ((lv < 0) != (rv_safe < 0)))
                else:
                    out = lv / np.where(rv == 0, np.nan, rv)
            else:
                _check_divisor(rv, rn, ln)
                out = np.fmod(lv, np.where(rv == 0, 1, rv))
            return out, _null_or(ln, rn)
        raise ExecutionError(f"bad binary op {e.op}")
    if isinstance(e, ast.IsNull):
        v, nm = eval_expr(e.operand, scope)
        isnull = (np.zeros(np.shape(v), dtype=bool) if nm is None
                  else np.broadcast_to(nm, np.shape(v)))
        return (~isnull if e.negated else isnull.copy()), None
    if isinstance(e, ast.Between):
        v, nm = eval_expr(e.operand, scope)
        lo, ln = eval_expr(e.low, scope)
        hi, hn = eval_expr(e.high, scope)
        out = (v >= lo) & (v <= hi)
        if e.negated:
            out = ~out
        return out, _null_or(nm, _null_or(ln, hn))
    if isinstance(e, ast.InList):
        v, nm = eval_expr(e.operand, scope)
        vals = []
        has_null_item = False
        for item in e.items:
            iv, inull = eval_expr(item, scope)
            if inull is not None and bool(np.asarray(inull).any()):
                has_null_item = True
                continue
            vals.append(iv[()] if np.ndim(iv) == 0 else iv)
        out = np.zeros(np.shape(v), dtype=bool)
        for x in vals:
            out = out | (v == x)
        # SQL: x IN (..., NULL) is TRUE when matched, else NULL;
        # x NOT IN (..., NULL) is FALSE when matched, else NULL
        null_out = nm
        if has_null_item:
            unmatched_null = ~out
            null_out = unmatched_null if null_out is None else (
                null_out | unmatched_null)
        if e.negated:
            out = ~out
        return out, null_out
    if isinstance(e, ast.CaseWhen):
        # branch results evaluate vectorized over ALL rows, so a zero
        # divisor in a branch the guard excludes must not raise — PG
        # guarantees CASE short-circuits per row (_check_divisor defers)
        if e.else_result is not None:
            with _guarded():
                out, nm = eval_expr(e.else_result, scope)
            out = np.asarray(out)
        else:
            out, nm = np.zeros((), dtype=np.int64), np.ones((), dtype=bool)
        for cond, res in reversed(e.whens):
            with _guarded():
                cv, cn = eval_expr(cond, scope)
            take = np.asarray(cv, dtype=bool)
            if cn is not None:
                take = take & ~cn
            with _guarded():
                rv, rn = eval_expr(res, scope)
            out = np.where(take, rv, out)
            new_null = (np.zeros(np.shape(rv), dtype=bool) if rn is None
                        else rn)
            old_null = np.zeros((), dtype=bool) if nm is None else nm
            nm = np.where(take, new_null, old_null)
        return out, nm
    if isinstance(e, ast.Cast):
        v, nm = eval_expr(e.operand, scope)
        return v, nm
    raise ExecutionError(
        f"host evaluator: unsupported expression {type(e).__name__}")


def _compare(op, lv, rv):
    if op == "=":
        return lv == rv
    if op == "<>":
        return lv != rv
    if op == "<":
        return lv < rv
    if op == "<=":
        return lv <= rv
    if op == ">":
        return lv > rv
    return lv >= rv


def split_conjuncts(e: ast.Expr | None) -> list[ast.Expr]:
    if e is None:
        return []
    if isinstance(e, ast.BinaryOp) and e.op.upper() == "AND":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]
