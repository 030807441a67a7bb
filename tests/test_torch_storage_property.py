"""Storage-tier properties on the torch port against the JAX reference: a
deterministic twin of tests/test_storage_property.py.

Each property runs its derandomized Hypothesis examples on both packages
(`torch_twin.twin_given`: the same draws for each, and on every run,
expressions translated to the port's classes); every assertion of the
reference holds in both, and the port's decoded values, encodings, spill
segments and predicate masks must equal the reference's.  The reference's
docstring follows.

Property tests for the storage tier (hypothesis, gated like
test_join_property.py):

  * RLE / BITPACK / frame-of-reference / DICT encode->decode round-trip on
    arbitrary integer columns (including negative bias and degenerate
    constant/empty inputs), and `recompress` never changing decoded content;
  * spill-segment serialize->deserialize round-trip for whole partitions;
  * compressed-domain predicate parity: `compile_expr` over FOR- and
    RLE-encoded layouts must agree with the interpreted `evaluate()` oracle
    for every generated range/comparison predicate — the §12 claim that
    executing on codes never changes answers.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis")

from hypothesis import strategies as st

from torch_twin import P, observed, twin_given

EXAMPLES = 60       # the reference's max_examples


def int_arrays():
    return st.builds(
        lambda base, span, n, seed: (
            base + np.random.default_rng(seed).integers(0, span + 1, n)
        ).astype(np.int64),
        base=st.integers(-10**9, 10**9),
        span=st.integers(0, (1 << 31) - 1),
        n=st.integers(0, 400),
        seed=st.integers(0, 2**16),
    )


def runny_arrays():
    return st.builds(
        lambda vals, reps, seed: np.repeat(
            np.asarray(vals, np.int64),
            np.random.default_rng(seed).integers(1, 1 + max(reps, 1),
                                                 len(vals))).astype(np.int64),
        vals=st.lists(st.integers(-50, 50), min_size=1, max_size=30),
        reps=st.integers(1, 40),
        seed=st.integers(0, 2**16),
    )


def _comp():
    return P.m("core.compression")


class TestRoundTrip:
    @staticmethod
    def _for_round_trip(vals):
        comp = _comp()
        enc = comp.encode(vals, comp.Encoding.FOR)
        out = comp.decode_np(enc)
        np.testing.assert_array_equal(out, vals)
        return {"out": out, "nbytes": enc.nbytes}

    def test_for_round_trip(self):
        twin_given(lambda: (int_arrays(),), self._for_round_trip,
                   max_examples=EXAMPLES)

    @staticmethod
    def _bitpack_round_trip(vals):
        comp = _comp()
        span = int(vals.max() - vals.min()) if len(vals) else 0
        if span >= (1 << 16):
            vals = vals - vals.min()
            vals = (vals % (1 << 16)) + int(vals.min())
        enc = comp.encode(vals.astype(np.int64), comp.Encoding.BITPACK)
        out = comp.decode_np(enc)
        np.testing.assert_array_equal(out, vals)
        return {"out": out, "words": enc.words, "width": enc.bit_width}

    def test_bitpack_round_trip(self):
        twin_given(lambda: (int_arrays(),), self._bitpack_round_trip,
                   max_examples=EXAMPLES)

    @staticmethod
    def _rle_round_trip(vals):
        comp = _comp()
        enc = comp.encode(vals, comp.Encoding.RLE)
        out = comp.decode_np(enc)
        np.testing.assert_array_equal(out, vals)
        return {"out": out, "runs": enc.run_lengths}

    def test_rle_round_trip(self):
        twin_given(lambda: (runny_arrays(),), self._rle_round_trip,
                   max_examples=EXAMPLES)

    @staticmethod
    def _recompress_preserves_content_and_size(vals):
        comp = _comp()
        seen = []
        for initial in (comp.Encoding.PLAIN, comp.Encoding.RLE):
            enc = comp.encode(vals, initial)
            out = comp.recompress(enc)
            assert out.nbytes <= enc.nbytes
            np.testing.assert_array_equal(comp.decode_np(out),
                                          comp.decode_np(enc))
            seen.append([out.encoding.value, out.nbytes])
        return {"seen": seen}

    def test_recompress_preserves_content_and_size(self):
        twin_given(lambda: (st.one_of(int_arrays(), runny_arrays()),),
                   self._recompress_preserves_content_and_size,
                   max_examples=EXAMPLES)

    @staticmethod
    def _segment_round_trip(vals, runs, seed):
        n = min(len(vals), len(runs))
        if n == 0:
            return {"n": n}
        rng = np.random.default_rng(seed)
        F, D = P.m("core.types").Field, P.DType
        schema = P.Schema([F("a", D.INT64), F("r", D.INT64),
                           F("s", D.STRING)])
        data = {"a": vals[:n], "r": runs[:n],
                "s": rng.choice(np.array(["aa", "bb", "cc"]), n)}
        part = P.m("core.columnar").build_partition(3, schema, data)
        for blk in part.columns.values():
            blk.recompress()
        storage = P.m("core.storage")
        blob = storage.serialize_partition(3, part.columns)
        idx, cols = storage.deserialize_partition(blob)
        assert idx == 3
        for name in data:
            np.testing.assert_array_equal(cols[name].decoded(),
                                          part.columns[name].decoded())
        return {"n": n, "blob": np.frombuffer(blob, np.uint8)}

    def test_segment_round_trip(self):
        twin_given(lambda: (int_arrays(), runny_arrays(),
                            st.integers(0, 2**16)),
                   self._segment_round_trip, max_examples=EXAMPLES)


# ---------------------------------------------------------------------------
# Compressed-domain predicate parity vs evaluate()
# ---------------------------------------------------------------------------


def _pred_strategy():
    ex = P.m("core.expr")
    lit = st.one_of(st.integers(-60, 60),
                    st.floats(-60, 60, allow_nan=False).map(
                        lambda f: round(f, 2)))
    cmps = st.builds(lambda op, v: ex.Cmp(op, ex.Col("x"), ex.Lit(v)),
                     st.sampled_from(["=", "!=", "<", "<=", ">", ">="]), lit)
    between = st.builds(lambda a, b: ex.Between(ex.Col("x"), min(a, b),
                                                max(a, b)), lit, lit)
    inlist = st.builds(lambda vs: ex.InList(ex.Col("x"), tuple(vs)),
                       st.lists(st.integers(-60, 60), min_size=1,
                                max_size=4))
    return st.one_of(cmps, between, inlist)


def _shift_pred(pred, base):
    ex = P.m("core.expr")

    def shift(node):
        if isinstance(node, ex.Lit):
            return ex.Lit(node.value + base)
        if isinstance(node, ex.Between):
            return ex.Between(node.child, node.lo + base, node.hi + base)
        if isinstance(node, ex.InList):
            return ex.InList(node.child, tuple(v + base for v in node.values))
        return None
    return ex.rewrite_expr(pred, shift)


def _count_sum_specs():
    plan, ex = P.m("core.plan"), P.m("core.expr")
    return [plan.AggSpec("c", plan.AggFunc.COUNT, None),
            plan.AggSpec("s", plan.AggFunc.SUM, ex.Col("x"))]


def _colscan_runner():
    phys, plan = P.m("core.physical"), P.m("core.plan")
    seg = plan.PipelineSegment.__new__(plan.PipelineSegment)
    seg.pred = None
    seg.exprs = None
    record = phys.SegmentRecord(table="t", depth=1, consumer="aggregate",
                                outputs=["x"], pred=None)
    runner = phys.SegmentRunner.__new__(phys.SegmentRunner)
    runner.seg = seg
    runner.schema = P.Schema([P.m("core.types").Field("x", P.DType.INT64)])
    runner.backend = "compiled"
    runner.cfg = P.m("core.pde").PDEConfig(compressed_domain=True)
    runner.record = record
    runner.device = "cpu"
    return runner


def for_values():
    return st.builds(
        lambda base, n, seed: (base + np.random.default_rng(seed).integers(
            0, 120, n)).astype(np.int64),
        base=st.integers(-10**8, 10**8), n=st.integers(1, 300),
        seed=st.integers(0, 2**16))


class TestCompressedDomainParity:
    @staticmethod
    def _for_codes_match_oracle(vals, pred):
        ex, col = P.m("core.expr"), P.m("core.columnar")
        # predicate literals live near zero; shift them into the frame so
        # matches are possible but out-of-frame bounds are also exercised
        base = int(vals.min())
        pred = _shift_pred(pred, base)
        blk = col.make_block(P.m("core.types").Field("x", P.DType.INT64),
                             vals, encoding=_comp().Encoding.FOR)
        assert blk.enc.encoding == _comp().Encoding.FOR
        ctx = {"x": ex.ColumnVal(block=blk)}
        expect = np.asarray(ex.evaluate(pred, {"x": ex.ColumnVal(vals)}).arr)
        got = np.asarray(ex.compile_expr(pred)(ctx).arr)
        np.testing.assert_array_equal(got.astype(bool), expect.astype(bool))
        return {"got": got.astype(bool)}

    def test_for_codes_match_oracle(self):
        twin_given(lambda: (for_values(), _pred_strategy()),
                   self._for_codes_match_oracle, max_examples=EXAMPLES)

    @staticmethod
    def _rle_runs_match_oracle(vals, lo, hi):
        lo, hi = min(lo, hi), max(lo, hi)
        ex, col = P.m("core.expr"), P.m("core.columnar")
        blk = col.make_block(P.m("core.types").Field("x", P.DType.INT64),
                             vals, encoding=_comp().Encoding.RLE)
        assert blk.enc.encoding == _comp().Encoding.RLE
        mask = (vals >= lo) & (vals <= hi)
        batch = P.m("core.batch").PartitionBatch(
            {"x": ex.ColumnVal(block=blk)})
        runner = _colscan_runner()
        out, route = runner._run_rle_scan(batch, "x", lo, hi, "x",
                                          _count_sum_specs())
        assert route == "rle-scan"
        # partial-agg state columns, as _state_cols names them
        cnt = int(np.asarray(out.col("__c__cnt").arr)[0])
        acc = np.asarray(out.col("__s__acc").arr)[0]
        assert cnt == int(mask.sum())
        assert acc == vals[mask].sum()
        return observed(locals())

    def test_rle_runs_match_oracle(self):
        twin_given(lambda: (runny_arrays(), st.integers(-60, 60),
                            st.integers(-60, 60)),
                   self._rle_runs_match_oracle, max_examples=EXAMPLES)
