"""The torch lowering of expressions (`CompiledExprSet`) against the
`evaluate()` oracle and against the JAX reference's lowering.

The same expression trees, built in both packages, run over a partition
context made from a seed with numpy that mixes every layout the lowering
distinguishes: plain int64 and float64 columns, a DICT-coded numeric
column (predicates on codes), a BITPACK column with a negative bias, a
frame-of-reference column (predicates on narrow codes) and a dictionary
string column.  Integers, booleans and strings must match exactly, floats
to rtol 1e-12.
"""

import numpy as np
import pytest

import repro.core.columnar as jcol
import repro.core.compression as jcomp
import repro.core.expr as jx
import repro.core.types as jty
import repro_torch.core.columnar as tcol
import repro_torch.core.compression as tcomp
import repro_torch.core.expr as tx
import repro_torch.core.types as tty

STR_POOL = ["apple", "fig", "kiwi", "lime", "mango", "pear"]
DICT_POOL = np.array([-19, -7, -3, 0, 4, 5, 11, 23], np.int64)


def _exprs(m):
    C, L = m.Col, m.Lit
    a, d, bp, fr, x, s = (C("a"), C("d"), C("bp"), C("fr"), C("x"),
                          C("s"))
    return [
        m.Cmp(">", a, L(3)),
        m.Cmp("<=", x, L(0.25)),
        m.Cmp(">=", a, L(2.5)),                  # int column, float literal
        m.Cmp("=", d, L(5)), m.Cmp("!=", d, L(6)), m.Cmp("<", d, L(0)),
        m.Between(d, -7, 11), m.InList(d, (4, 23, 99)),
        m.Between(fr, 1010, 1030), m.Cmp(">", fr, L(1020)),
        m.Cmp("=", s, L("kiwi")), m.Cmp("<", s, L("lime")),
        m.Cmp(">=", s, L("banana")), m.InList(s, ("fig", "zzz")),
        m.Between(s, "b", "m"), m.Cmp("!=", s, L("zzz")),
        m.And(m.Cmp(">", bp, L(-5)), m.Not(m.Cmp("=", a, L(0)))),
        m.Or(m.Between(x, -0.5, 0.5), m.InList(a, (1, 2, 3))),
        m.BinOp("+", a, bp), m.BinOp("*", x, L(2.5)),
        m.BinOp("-", bp, L(7)), m.BinOp("/", a, L(4)),
        m.BinOp("/", x, a), m.BinOp("%", bp, L(5)),
        m.BinOp("+", d, a), m.BinOp("*", fr, L(2)),
        m.Func("ABS", (bp,)), m.Func("SQRT", (m.Func("ABS", (x,)),)),
        m.Func("EXP", (x,)), m.Func("LOG", (m.BinOp("+", m.Func(
            "ABS", (a,)), L(1)),)),
        m.Func("FLOOR", (m.BinOp("*", x, L(10)),)), m.Func("CEIL", (a,)),
        m.Func("YEAR", (fr,)), m.Func("LENGTH", (s,)),
        m.Cmp(">", m.Func("LENGTH", (s,)), L(3)),
        d, fr, s, L(1.5),
    ]


def _ctx(seed, comp, col, ex, ty, n=200):
    rng = np.random.default_rng(seed)
    F, D = ty.Field, ty.DType
    a = rng.integers(-40, 40, n).astype(np.int64)
    x = rng.normal(size=n)
    d_blk = col.make_block(F("d", D.INT64), rng.choice(DICT_POOL, n),
                           comp.Encoding.DICT)
    bp_blk = col.make_block(F("bp", D.INT64),
                            rng.integers(-37, 29, n).astype(np.int64),
                            comp.Encoding.BITPACK)
    fr_blk = col.make_block(F("fr", D.INT32),
                            rng.integers(1000, 1040, n).astype(np.int32),
                            comp.Encoding.FOR)
    s_blk = col.make_block(F("s", D.STRING), np.array(
        [STR_POOL[i] for i in rng.integers(0, len(STR_POOL), n)]))
    return {
        "a": ex.ColumnVal(a), "x": ex.ColumnVal(x),
        "d": ex.ColumnVal(None, None, True, block=d_blk),
        "bp": ex.ColumnVal(None, None, True, block=bp_blk),
        "fr": ex.ColumnVal(None, None, True, block=fr_blk),
        "s": ex.ColumnVal(None, s_blk.str_dict, True, block=s_blk),
    }


def _same(got, want):
    assert got.is_string == want.is_string
    if want.is_string:
        np.testing.assert_array_equal(got.decoded(), want.decoded())
        return
    g, w = np.asarray(got.arr), np.asarray(want.arr)
    if w.dtype.kind == "f" or g.dtype.kind == "f":
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), rtol=1e-12,
                                   atol=0)
    else:
        np.testing.assert_array_equal(np.broadcast_to(g, w.shape), w)


N_EXPRS = len(_exprs(tx))


@pytest.mark.parametrize("i", range(N_EXPRS))
@pytest.mark.parametrize("seed", [0, 1])
def test_lowering_matches_oracles(i, seed):
    texpr = _exprs(tx)[i]
    jexpr = _exprs(jx)[i]
    tctx = _ctx(seed, tcomp, tcol, tx, tty)
    jctx = _ctx(seed, jcomp, jcol, jx, jty)
    got = tx.CompiledExprSet([texpr], device="cpu")(tctx)[0]
    _same(got, tx.evaluate(texpr, tctx))
    _same(got, jx.evaluate(jexpr, jctx))
    assert repr(texpr) == repr(jexpr)


def test_segment_set_shares_one_plan_per_layout():
    """One lowering per (expression set, layout) signature, reused across
    partitions and across CompiledExprSet instances via the plan cache."""
    exprs = _exprs(tx)[:4]
    first = tx.CompiledExprSet(exprs, device="cpu")
    outs = first(_ctx(3, tcomp, tcol, tx, tty))
    assert len(outs) == 4
    second = tx.CompiledExprSet(_exprs(tx)[:4], device="cpu")
    second(_ctx(4, tcomp, tcol, tx, tty))
    assert second._plans == first._plans


def test_modulo_by_zero_falls_back():
    """torch refuses integer % 0, numpy answers it: the lowering raises
    ExprCompileError so the partition takes the evaluate() oracle."""
    ctx = {"a": tx.ColumnVal(np.arange(5, dtype=np.int64))}
    e = tx.BinOp("%", tx.Col("a"), tx.Lit(0))
    with pytest.raises(tx.ExprCompileError):
        tx.CompiledExprSet([e], device="cpu")(ctx)
