"""Map pruning (paper §3.5).

Shark's memory store piggybacks statistics collection on data loading: per
partition, the range of each column and the distinct-value set for enum
columns.  At query time the master evaluates the query's predicate against
every partition's stats and *does not launch tasks* for partitions that
provably contain no matching row.  On the real warehouse trace this cut data
scanned by ~30x; 3277 of 3833 sampled queries had prunable predicates.

`may_match` is deliberately conservative: it returns False only when the
stats *refute* the predicate.  Anything it cannot reason about returns True
(scan the partition).
"""

from __future__ import annotations

from typing import Dict, Optional

from .columnar import ColumnStats
from .expr import (And, Between, Cmp, Col, Expr, Func, InList, Lit, Not, Or)


def _col_lit(e: Cmp):
    """Normalize Cmp to (col, op, literal) if it has that shape."""
    if isinstance(e.left, Col) and isinstance(e.right, Lit):
        return e.left.name, e.op, e.right.value
    if isinstance(e.right, Col) and isinstance(e.left, Lit):
        flip = {"=": "=", "!=": "!=", "<": ">", "<=": ">=", ">": "<", ">=": "<="}
        return e.right.name, flip[e.op], e.left.value
    return None


def may_match(pred: Optional[Expr], stats: Dict[str, ColumnStats]) -> bool:
    """Could any row of a partition with these stats satisfy `pred`?"""
    if pred is None:
        return True
    if isinstance(pred, And):
        return may_match(pred.left, stats) and may_match(pred.right, stats)
    if isinstance(pred, Or):
        return may_match(pred.left, stats) or may_match(pred.right, stats)
    if isinstance(pred, Not):
        inner = pred.child
        # only refute NOT(col = v) when the partition is constant v
        if isinstance(inner, Cmp):
            norm = _col_lit(inner)
            if norm is not None:
                col, op, v = norm
                st = stats.get(col)
                if st is not None and op == "=" and st.distinct is not None \
                        and st.distinct == frozenset({_as_stat_value(v)}):
                    return False
        return True
    if isinstance(pred, Between):
        if isinstance(pred.child, Col):
            st = stats.get(pred.child.name)
            if st is not None and _is_number(pred.lo) and _is_number(pred.hi):
                return st.may_satisfy_range(pred.lo, pred.hi)
        return True
    if isinstance(pred, InList):
        if isinstance(pred.child, Col):
            st = stats.get(pred.child.name)
            if st is not None:
                return any(_value_possible(st, v) for v in pred.values)
        return True
    if isinstance(pred, Cmp):
        norm = _col_lit(pred)
        if norm is None:
            return True
        col, op, v = norm
        st = stats.get(col)
        if st is None:
            return True
        if op == "=":
            return _value_possible(st, v)
        if op == "!=":
            # refute only if partition is constant v
            if st.distinct is not None and st.distinct == frozenset({_as_stat_value(v)}):
                return False
            return True
        if not _is_number(v):
            # string range compares: refutable via distinct set only
            if st.distinct is not None:
                import numpy as np
                vals = list(st.distinct)
                if op == "<":
                    return any(x < v for x in vals)
                if op == "<=":
                    return any(x <= v for x in vals)
                if op == ">":
                    return any(x > v for x in vals)
                if op == ">=":
                    return any(x >= v for x in vals)
            return True
        if op == "<":
            return st.min is None or st.min < v
        if op == "<=":
            return st.min is None or st.min <= v
        if op == ">":
            return st.max is None or st.max > v
        if op == ">=":
            return st.max is None or st.max >= v
    return True


def _is_number(v) -> bool:
    import numpy as np
    return isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, bool)


def _as_stat_value(v):
    return float(v) if _is_number(v) else v


def _value_possible(st: ColumnStats, v) -> bool:
    if st.distinct is not None:
        return v in st.distinct or _as_stat_value(v) in st.distinct
    if _is_number(v):
        return st.may_satisfy_range(v, v)
    return True
