"""Random expression trees through `compile_expr` on the torch port against
the JAX reference: a deterministic twin of
tests/test_compile_expr_property.py.

Each property runs its derandomized Hypothesis examples on both packages
(`torch_twin.twin_given`: the same draws for each, and on every run);
`compile_expr` must agree with `evaluate` in both, and the port's values
must equal the reference's (floats to rtol 1e-12).  The reference's
docstring follows.

Property-based test (hypothesis, gated like test_join_property.py):
`compile_expr` — the traced/jitted expression compiler — must agree with
`evaluate`, its numpy oracle, over randomly generated expression trees.

Coverage targets the places the lowering diverges structurally from the
interpreter:
  * dictionary-code-space predicates on dict-encoded STRING columns,
    including literals absent from a partition's dictionary (the dialect's
    NULL-ish case: the match set is empty, and != / NOT must still see
    every row);
  * dict-encoded NUMERIC columns evaluated on codes without decoding;
  * BITPACK-encoded columns with negative values (bias edge cases) read
    through the memoized decode;
  * mixed plain/encoded layouts — the per-partition signature machinery.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis")


from hypothesis import strategies as st

from torch_twin import P, observed, twin_given


NUM_COLS = ["a", "d", "bp"]     # plain int64, DICT-encoded, BITPACK-encoded
STR_COL = "s"
# dictionary values on purpose include negatives; literals sample a superset
# so absent-from-dictionary comparisons are generated too
DICT_POOL = np.array([-19, -7, -3, 0, 4, 5, 11, 23], np.int64)
STR_POOL = ["apple", "fig", "kiwi", "lime", "mango", "pear"]
STR_LITS = STR_POOL + ["", "banana", "zzz"]     # absent literals included

CMPS = ["=", "!=", "<", "<=", ">", ">="]


def _numeric_expr(depth):
    if depth == 0:
        return st.one_of(
            st.sampled_from(NUM_COLS).map(P.m("core.expr").Col),
            st.integers(-50, 50).map(P.m("core.expr").Lit),
        )
    sub = _numeric_expr(depth - 1)
    return st.one_of(
        sub,
        st.tuples(st.sampled_from(["+", "-", "*"]), sub, sub)
        .map(lambda t: P.m("core.expr").BinOp(*t)),
        sub.map(lambda e: P.m("core.expr").Func("ABS", (e,))),
    )


def _string_pred():
    return st.one_of(
        st.tuples(st.sampled_from(CMPS), st.sampled_from(STR_LITS))
        .map(lambda t: P.m("core.expr").Cmp(t[0], P.m("core.expr").Col(STR_COL), P.m("core.expr").Lit(t[1]))),
        st.lists(st.sampled_from(STR_LITS), min_size=1, max_size=3)
        .map(lambda vs: P.m("core.expr").InList(P.m("core.expr").Col(STR_COL), tuple(vs))),
        st.tuples(st.sampled_from(STR_LITS), st.sampled_from(STR_LITS))
        .map(lambda t: P.m("core.expr").Between(P.m("core.expr").Col(STR_COL), min(t), max(t))),
    )


def _bool_expr(depth):
    num = _numeric_expr(depth)
    base = st.one_of(
        st.tuples(st.sampled_from(CMPS), num, num).map(lambda t: P.m("core.expr").Cmp(*t)),
        _string_pred(),
    )
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


def _make_ctx(seed: int, n: int = 96):
    """Partition context mixing plain, DICT, and BITPACK layouts, exactly
    as the columnar store would hand them to a segment."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-40, 40, n).astype(np.int64)
    d_vals = rng.choice(DICT_POOL, n)
    bp_vals = rng.integers(-37, 29, n).astype(np.int64)   # negative bias
    s_vals = np.array([STR_POOL[i] for i in rng.integers(0, len(STR_POOL),
                                                         n)])
    d_blk = P.m("core.columnar").make_block(P.m("core.types").Field("d", P.m("core.types").DType.INT64), d_vals, P.m("core.compression").Encoding.DICT)
    bp_blk = P.m("core.columnar").make_block(P.m("core.types").Field("bp", P.m("core.types").DType.INT64), bp_vals, P.m("core.compression").Encoding.BITPACK)
    s_blk = P.m("core.columnar").make_block(P.m("core.types").Field("s", P.m("core.types").DType.STRING), s_vals)
    return {
        "a": P.m("core.expr").ColumnVal(a),
        "d": P.m("core.expr").ColumnVal(None, None, True, block=d_blk),
        "bp": P.m("core.expr").ColumnVal(None, None, True, block=bp_blk),
        "s": P.m("core.expr").ColumnVal(None, s_blk.str_dict, True, block=s_blk),
    }


def _assert_matches(expr, ctx):
    want = P.m("core.expr").evaluate(expr, ctx)
    got = P.m("core.expr").compile_expr(expr)(ctx)
    assert got.is_string == want.is_string
    if want.is_string:
        np.testing.assert_array_equal(got.decoded(), want.decoded())
        return np.asarray(got.decoded())
    w = np.asarray(want.arr)
    g = np.asarray(got.arr)
    if w.dtype.kind == "f" or g.dtype.kind == "f":
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64),
                                   rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(g, w)
    return g


def _random_predicates_compile_exactly(expr, seed):
    got = _assert_matches(expr, _make_ctx(seed))
    return observed(locals())


def test_random_predicates_compile_exactly():
    twin_given(lambda: (_bool_expr(3), st.integers(0, 2**31 - 1)),
               _random_predicates_compile_exactly, max_examples=120)


def _random_numeric_exprs_compile_exactly(expr, seed):
    got = _assert_matches(expr, _make_ctx(seed))
    return observed(locals())


def test_random_numeric_exprs_compile_exactly():
    twin_given(lambda: (_numeric_expr(3), st.integers(0, 2**31 - 1)),
               _random_numeric_exprs_compile_exactly, max_examples=60)


def _string_dictionary_predicates_compile_exactly(expr, seed):
    """Absent-literal string comparisons: the compiled code-space bounds
    must produce the same (possibly empty) match sets as the evaluator,
    and negation must recover every row."""
    ctx = _make_ctx(seed)
    got = _assert_matches(expr, ctx)
    negated = _assert_matches(P.m("core.expr").Not(expr), ctx)
    return observed(locals())


def test_string_dictionary_predicates_compile_exactly():
    twin_given(lambda: (_string_pred(), st.integers(0, 2**31 - 1)),
               _string_dictionary_predicates_compile_exactly,
               max_examples=40)


