"""Expression builders for the SharkFrame fluent API (DESIGN.md §7).

These construct the *same* Expr / aggregate AST the SQL parser emits, so a
fluent query and its SQL-text twin bind to identical logical plans:

    from repro_torch.core.functions import col, sum_, count

    sess.table("uservisits") \\
        .filter(col("visitDate") > 10500) \\
        .group_by(col("destURL")) \\
        .agg(sum_(col("adRevenue")).alias("rev"), count().alias("n"))

Aggregate builders return the parser's `_AggExpr` node; `.alias(name)` (from
`Expr`) attaches the output column name, exactly like `AS name` in SQL.
Names with a trailing underscore (`sum_`, `min_`, ...) avoid shadowing
Python built-ins.
"""

from __future__ import annotations

from typing import Any, Optional

from .expr import Col, Expr, Func, Lit
from .plan import AggFunc
from .sql import _AggExpr

__all__ = [
    "col", "lit", "sum_", "avg", "min_", "max_", "count", "count_distinct",
    "substr", "lower", "upper", "length", "abs_", "sqrt", "log", "exp",
    "floor", "ceil", "year",
]


def col(name: str) -> Col:
    """Reference a column by name."""
    return Col(name)


def lit(value: Any) -> Lit:
    """A literal constant (int, float, str, bool)."""
    return Lit(value)


def _expr(e) -> Expr:
    return e if isinstance(e, Expr) else Lit(e)


# -- aggregates ---------------------------------------------------------------


def sum_(e) -> _AggExpr:
    return _AggExpr(AggFunc.SUM, _expr(e), False)


def avg(e) -> _AggExpr:
    return _AggExpr(AggFunc.AVG, _expr(e), False)


def min_(e) -> _AggExpr:
    return _AggExpr(AggFunc.MIN, _expr(e), False)


def max_(e) -> _AggExpr:
    return _AggExpr(AggFunc.MAX, _expr(e), False)


def count(e: Optional[Expr] = None) -> _AggExpr:
    """COUNT(*) when called with no argument, else COUNT(expr)."""
    return _AggExpr(AggFunc.COUNT, None if e is None else _expr(e), False)


def count_distinct(e) -> _AggExpr:
    return _AggExpr(AggFunc.COUNT, _expr(e), True)


# -- scalar functions (same names the SQL dialect accepts) --------------------


def substr(e, start: int, length: int) -> Func:
    """1-based substring, matching SQL SUBSTR(s, start, len)."""
    return Func("SUBSTR", (_expr(e), Lit(start), Lit(length)))


def lower(e) -> Func:
    return Func("LOWER", (_expr(e),))


def upper(e) -> Func:
    return Func("UPPER", (_expr(e),))


def length(e) -> Func:
    return Func("LENGTH", (_expr(e),))


def abs_(e) -> Func:
    return Func("ABS", (_expr(e),))


def sqrt(e) -> Func:
    return Func("SQRT", (_expr(e),))


def log(e) -> Func:
    return Func("LOG", (_expr(e),))


def exp(e) -> Func:
    return Func("EXP", (_expr(e),))


def floor(e) -> Func:
    return Func("FLOOR", (_expr(e),))


def ceil(e) -> Func:
    return Func("CEIL", (_expr(e),))


def year(e) -> Func:
    return Func("YEAR", (_expr(e),))
