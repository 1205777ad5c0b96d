"""Bound expression IR: what the planner emits and executors evaluate.

The AST (citus_tpu.sql.ast) carries names; this IR carries *resolved*
references (unique column ids + dtypes) and is backend-agnostic: the same
tree is evaluated with jax.numpy on device and numpy on host (final HAVING/
ORDER BY), the analogue of the reference evaluating quals both on workers
and in the combine query on the coordinator
(planner/multi_logical_optimizer.c worker/master split).

SQL three-valued logic: every evaluation returns (values, null_mask);
WHERE treats NULL as false.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..types import DataType


class BExpr:
    """Bound expression base. All subclasses are frozen/hashable."""

    dtype: DataType


@dataclass(frozen=True)
class BCol(BExpr):
    """Resolved column: `cid` is the unique column id in executor Blocks
    (e.g. "0.l_orderkey" = range-table index 0, column l_orderkey)."""

    cid: str
    dtype: DataType
    # provenance for planning decisions (pruning, colocation):
    table: str = ""
    column: str = ""
    rel_index: int = -1

    def __str__(self):
        return self.cid


@dataclass(frozen=True)
class BConst(BExpr):
    value: object  # python scalar; dict-encoded strings already as int codes
    dtype: DataType

    def __str__(self):
        return repr(self.value)


@dataclass(frozen=True, repr=False)
class BParam(BExpr):
    """Prepared-statement parameter: a runtime scalar the compiled
    program takes as an INPUT rather than a baked literal, so one
    compiled plan serves every EXECUTE (the generic-plan analogue of the
    reference's prepared shard plans, planner/local_plan_cache.c).

    The bound VALUE rides along for host-side uses (shard pruning, chunk
    skipping, fast-path routing, host combine) but is excluded from
    repr/eq — plan fingerprints and compiled-plan cache keys must not
    see it."""

    idx: int
    dtype: DataType
    value: object = field(compare=False, default=None)

    def __repr__(self):
        return f"BParam({self.idx}, {self.dtype})"

    def __str__(self):
        return f"${self.idx + 1}"


@dataclass(frozen=True)
class BArith(BExpr):
    op: str  # + - * / %
    left: BExpr
    right: BExpr
    dtype: DataType

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclass(frozen=True)
class BCmp(BExpr):
    op: str  # = <> < <= > >=
    left: BExpr
    right: BExpr
    dtype: DataType = DataType.BOOL

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclass(frozen=True)
class BBool(BExpr):
    op: str  # AND OR NOT
    args: tuple[BExpr, ...]
    dtype: DataType = DataType.BOOL

    def __str__(self):
        if self.op == "NOT":
            return f"(NOT {self.args[0]})"
        return "(" + f" {self.op} ".join(map(str, self.args)) + ")"


@dataclass(frozen=True)
class BIsNull(BExpr):
    operand: BExpr
    negated: bool = False
    dtype: DataType = DataType.BOOL

    def __str__(self):
        return f"({self.operand} IS {'NOT ' if self.negated else ''}NULL)"


@dataclass(frozen=True)
class BInConst(BExpr):
    """operand IN (constant set) — string predicates lower to code sets."""

    operand: BExpr
    values: tuple  # python scalars, same space as operand
    negated: bool = False
    dtype: DataType = DataType.BOOL

    def __str__(self):
        neg = "NOT " if self.negated else ""
        return f"({self.operand} {neg}IN {self.values})"


@dataclass(frozen=True)
class BCase(BExpr):
    whens: tuple[tuple[BExpr, BExpr], ...]
    else_result: Optional[BExpr]
    dtype: DataType

    def __str__(self):
        parts = " ".join(f"WHEN {c} THEN {r}" for c, r in self.whens)
        return f"CASE {parts} ELSE {self.else_result} END"


@dataclass(frozen=True)
class BCast(BExpr):
    operand: BExpr
    dtype: DataType

    def __str__(self):
        return f"CAST({self.operand} AS {self.dtype.value})"


@dataclass(frozen=True)
class BExtract(BExpr):
    part: str  # year | month | day
    operand: BExpr
    dtype: DataType = DataType.INT32

    def __str__(self):
        return f"EXTRACT({self.part} FROM {self.operand})"


@dataclass(frozen=True)
class BMath(BExpr):
    """Unary math op for sketch estimators: exp2neg (2^-x) and ln.
    Evaluates with jnp on device and np on host."""

    op: str                     # exp2neg | ln
    operand: BExpr
    dtype: DataType = DataType.FLOAT64

    def __str__(self):
        return f"{self.op}({self.operand})"


@dataclass(frozen=True)
class BHllBucket(BExpr):
    """HyperLogLog register index: top `p` bits of the 32-bit hash of
    the operand (murmur finalizer — the same fmix32 the shard-routing
    hash uses).  NULL operands propagate (their rows fall in a NULL
    register that the estimator's count()/sum() aggregates skip)."""

    operand: BExpr
    p: int
    dtype: DataType = DataType.INT32

    def __str__(self):
        return f"hll_bucket({self.operand})"


@dataclass(frozen=True)
class BDDBucket(BExpr):
    """DDSketch log-domain bucket key of the operand (signed, monotone
    in value; ops/sketches.py dd_bucket).  Grouping by it IS the
    mergeable quantile sketch — per-shard bucket counts combine by
    addition through the ordinary aggregate split, the way BHllBucket
    registers merge by max.  NULL operands propagate (the NULL bucket
    group is dropped by the percentile rewrite — PG semantics)."""

    operand: BExpr
    dtype: DataType = DataType.INT32

    def __str__(self):
        return f"dd_bucket({self.operand})"


@dataclass(frozen=True)
class BHllRho(BExpr):
    """HyperLogLog rank: 1 + count-of-leading-zeros of the remaining
    32-p hash bits (capped at 32-p+1 when they are all zero)."""

    operand: BExpr
    p: int
    dtype: DataType = DataType.INT32

    def __str__(self):
        return f"hll_rho({self.operand})"


@dataclass(frozen=True)
class BStrRemap(BExpr):
    """String function over a dictionary-encoded column, lowered to a
    code remap: the (small) dictionary is transformed host-side at bind
    time and the device does ONE gather `lut[codes]` — no device string
    ops, the TPU-native shape for text functions (the reference evaluates
    text functions row-by-row in the executor; here they collapse to a
    per-distinct-value precomputation).  `values[new_code]` is the output
    dictionary used for decode and further predicate binding."""

    operand: BExpr              # STRING-typed input (codes on device)
    lut: tuple[int, ...]        # old code → new code
    values: tuple[str, ...]     # new code → string
    label: str = "strmap"       # display only (e.g. "substring(1,2)")
    dtype: DataType = DataType.STRING

    def __str__(self):
        return f"{self.label}({self.operand})"


@dataclass(frozen=True)
class BAgg(BExpr):
    """Aggregate call; appears only in Aggregate plan nodes."""

    kind: str            # sum | count | avg | min | max | count_star
    arg: Optional[BExpr]  # None for count(*)
    distinct: bool = False
    dtype: DataType = DataType.FLOAT64

    def __str__(self):
        if self.kind == "count_star":
            return "count(*)"
        d = "DISTINCT " if self.distinct else ""
        return f"{self.kind}({d}{self.arg})"


@dataclass(frozen=True)
class BWindow(BExpr):
    """Window function call; planned into a WindowNode device stage.

    kind: row_number | rank | dense_rank | sum | count | count_star |
    min | max | avg.  The default SQL frame applies: with order_by,
    running aggregate over RANGE UNBOUNDED PRECEDING..CURRENT ROW
    (peers included); without, the whole partition."""

    kind: str
    arg: Optional[BExpr]
    partition_by: tuple[BExpr, ...]
    order_by: tuple[tuple[BExpr, bool], ...]   # (expr, descending)
    dtype: DataType = DataType.INT64

    def __str__(self):
        a = "*" if self.arg is None else str(self.arg)
        parts = []
        if self.partition_by:
            parts.append("partition by "
                         + ", ".join(map(str, self.partition_by)))
        if self.order_by:
            parts.append("order by " + ", ".join(
                f"{e}{' desc' if d else ''}" for e, d in self.order_by))
        return f"{self.kind}({a}) over ({' '.join(parts)})"


def expr_columns(e: BExpr) -> set[str]:
    """All BCol cids referenced."""
    out: set[str] = set()

    def rec(x):
        if isinstance(x, BCol):
            out.add(x.cid)
        for c in children(x):
            rec(c)

    rec(e)
    return out


def children(e: BExpr) -> tuple:
    if isinstance(e, (BArith, BCmp)):
        return (e.left, e.right)
    if isinstance(e, BBool):
        return e.args
    if isinstance(e, (BIsNull, BCast, BExtract, BStrRemap, BMath,
                      BHllBucket, BHllRho, BDDBucket)):
        return (e.operand,)
    if isinstance(e, BInConst):
        return (e.operand,)
    if isinstance(e, BCase):
        out: tuple = ()
        for c, r in e.whens:
            out += (c, r)
        if e.else_result is not None:
            out += (e.else_result,)
        return out
    if isinstance(e, BAgg):
        return (e.arg,) if e.arg is not None else ()
    if isinstance(e, BWindow):
        out = () if e.arg is None else (e.arg,)
        out += e.partition_by
        out += tuple(k for k, _ in e.order_by)
        return out
    return ()


def walk(e: BExpr):
    yield e
    for c in children(e):
        yield from walk(c)


def contains_agg(e: BExpr) -> bool:
    return any(isinstance(x, BAgg) for x in walk(e))


def split_conjuncts(e: BExpr | None) -> list[BExpr]:
    if e is None:
        return []
    if isinstance(e, BBool) and e.op == "AND":
        out = []
        for a in e.args:
            out.extend(split_conjuncts(a))
        return out
    return [e]


def make_and(conjuncts: list[BExpr]) -> BExpr | None:
    if not conjuncts:
        return None
    if len(conjuncts) == 1:
        return conjuncts[0]
    return BBool("AND", tuple(conjuncts))


# numeric type promotion ----------------------------------------------------

_RANK = {DataType.BOOL: 0, DataType.INT32: 1, DataType.DATE: 1,
         DataType.INT64: 2, DataType.FLOAT32: 3, DataType.FLOAT64: 4}


def promote(a: DataType, b: DataType) -> DataType:
    if a == b:
        return a
    if a == DataType.STRING or b == DataType.STRING:
        from ..errors import PlanningError

        raise PlanningError(f"no arithmetic on string types ({a} vs {b})")
    # date - date → int; date +/- int handled in binder
    ra, rb = _RANK[a], _RANK[b]
    hi = a if ra >= rb else b
    if hi == DataType.DATE:
        hi = DataType.INT32
    return hi
