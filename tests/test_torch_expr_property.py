"""Random expression trees on the torch port against the JAX reference: a
deterministic twin of tests/test_expr_property.py.

Each property runs its derandomized Hypothesis examples on both packages
(`torch_twin.twin_given`: the same draws for each, and on every run); the
engine's evaluation must match direct numpy evaluation in both, and the
port's values must equal the reference's.  The reference's docstring
follows.

Property-based test: random expression trees evaluated by the engine's
compiler must match direct numpy evaluation (the §5 bytecode-compilation
analogue cannot change semantics)."""

import numpy as np
import pytest

pytest.importorskip("hypothesis")

from hypothesis import strategies as st

from torch_twin import P, observed, twin_given


COLS = {"a": None, "b": None, "c": None}


def _numeric_expr(depth):
    if depth == 0:
        return st.one_of(
            st.sampled_from(list(COLS)).map(P.m("core.expr").Col),
            st.integers(-50, 50).map(P.m("core.expr").Lit),
        )
    sub = _numeric_expr(depth - 1)
    return st.one_of(
        sub,
        st.tuples(st.sampled_from(["+", "-", "*"]), sub, sub)
        .map(lambda t: P.m("core.expr").BinOp(*t)),
        sub.map(lambda e: P.m("core.expr").Func("ABS", (e,))),
    )


def _bool_expr(depth):
    num = _numeric_expr(depth)
    base = st.tuples(st.sampled_from(["=", "!=", "<", "<=", ">", ">="]),
                     num, num).map(lambda t: P.m("core.expr").Cmp(*t))
    if depth == 0:
        return base
    sub = _bool_expr(depth - 1)
    return st.one_of(
        base,
        st.tuples(sub, sub).map(lambda t: P.m("core.expr").And(*t)),
        st.tuples(sub, sub).map(lambda t: P.m("core.expr").Or(*t)),
        sub.map(P.m("core.expr").Not),
        st.tuples(num, st.integers(-20, 0), st.integers(0, 20))
        .map(lambda t: P.m("core.expr").Between(t[0], t[1], t[2])),
        st.tuples(num, st.lists(st.integers(-30, 30), min_size=1,
                                max_size=4))
        .map(lambda t: P.m("core.expr").InList(t[0], tuple(t[1]))),
    )


def _ref_eval(e, env):
    if isinstance(e, P.m("core.expr").Col):
        return env[e.name]
    if isinstance(e, P.m("core.expr").Lit):
        return e.value
    if isinstance(e, P.m("core.expr").BinOp):
        l, r = _ref_eval(e.left, env), _ref_eval(e.right, env)
        return {"+": l + r, "-": l - r, "*": l * r}[e.op]
    if isinstance(e, P.m("core.expr").Cmp):
        l, r = _ref_eval(e.left, env), _ref_eval(e.right, env)
        return {"=": l == r, "!=": l != r, "<": l < r, "<=": l <= r,
                ">": l > r, ">=": l >= r}[e.op]
    if isinstance(e, P.m("core.expr").And):
        return _ref_eval(e.left, env) & _ref_eval(e.right, env)
    if isinstance(e, P.m("core.expr").Or):
        return _ref_eval(e.left, env) | _ref_eval(e.right, env)
    if isinstance(e, P.m("core.expr").Not):
        return np.logical_not(_ref_eval(e.child, env))
    if isinstance(e, P.m("core.expr").Between):
        v = _ref_eval(e.child, env)
        return (v >= e.lo) & (v <= e.hi)
    if isinstance(e, P.m("core.expr").InList):
        v = _ref_eval(e.child, env)
        out = np.zeros_like(np.asarray(v), bool)
        for x in e.values:
            out |= np.asarray(v) == x
        return out
    if isinstance(e, P.m("core.expr").Func) and e.name == "ABS":
        return np.abs(_ref_eval(e.args[0], env))
    raise TypeError(e)


def _random_predicates_match_numpy(expr, seed):
    rng = np.random.default_rng(seed)
    env = {n: rng.integers(-40, 40, 64).astype(np.int64) for n in COLS}
    ctx = {n: P.m("core.expr").ColumnVal(v) for n, v in env.items()}
    got = np.asarray(P.m("core.expr").evaluate(expr, ctx).arr)
    want = np.asarray(_ref_eval(expr, env))
    np.testing.assert_array_equal(got, want)
    return observed(locals())


def test_random_predicates_match_numpy():
    twin_given(lambda: (_bool_expr(3), st.integers(0, 2**31 - 1)),
               _random_predicates_match_numpy, max_examples=120)


def _random_numeric_exprs_match_numpy(expr, seed):
    rng = np.random.default_rng(seed)
    env = {n: rng.integers(-20, 20, 32).astype(np.int64) for n in COLS}
    ctx = {n: P.m("core.expr").ColumnVal(v) for n, v in env.items()}
    got = np.asarray(P.m("core.expr").evaluate(expr, ctx).arr, dtype=np.float64)
    want = np.asarray(_ref_eval(expr, env), dtype=np.float64)
    np.testing.assert_allclose(got, want)
    return observed(locals())


def test_random_numeric_exprs_match_numpy():
    twin_given(lambda: (_numeric_expr(3), st.integers(0, 2**31 - 1)),
               _random_numeric_exprs_match_numpy, max_examples=80)


