"""Compiled vectorized execution on the torch port against the JAX
reference: the twin of tests/test_compiled_segments.py, on
`device="cpu"`.

The same inputs, made from a seed with numpy, go through both packages:
expression-compiler parity on encoded layouts, sdict sharing through
renames, fused-aggregate segment metrics, decode memoization, and the
kernel routes forced through the engine (the reference's Pallas kernels in
interpret mode, the port's kernel wrappers on CPU tensors, which run their
plain versions).  Integers, booleans, strings, routes and counters must be
equal; floats to rtol 1e-12 (float64 sums in another order).
"""

import operator

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
from repro.core import DType as JDType, Schema as JSchema
from repro.core import SharkSession as JaxSession
from repro.core.pde import PDEConfig as JaxPDEConfig
from repro.core.pde import decide_segment_backend as jax_decide
from repro_torch.core import DType as TDType, Schema as TSchema
from repro_torch.core import SharkSession as TorchSession
from repro_torch.core.pde import PDEConfig as TorchPDEConfig
from repro_torch.core.pde import decide_segment_backend as torch_decide

PACKAGES = {"jax": (jcol, jcomp, jx, jty), "torch": (tcol, tcomp, tx, tty)}


# ---------------------------------------------------------------------------
# compile_expr vs evaluate: deterministic sweep over encoded layouts
# ---------------------------------------------------------------------------


def _ctx(pkg, seed=7):
    col, comp, ex, ty = PACKAGES[pkg]
    rng = np.random.default_rng(seed)
    n = 257
    a = rng.integers(-40, 40, n).astype(np.int64)
    d_vals = rng.choice(np.array([-7, -3, 0, 5, 11], np.int64), n)
    bp_vals = rng.integers(-37, 29, n).astype(np.int64)
    s_vals = np.array([f"g{i}" for i in rng.integers(0, 6, n)])
    F, D = ty.Field, ty.DType
    d_blk = col.make_block(F("d", D.INT64), d_vals, comp.Encoding.DICT)
    bp_blk = col.make_block(F("bp", D.INT64), bp_vals, comp.Encoding.BITPACK)
    s_blk = col.make_block(F("s", D.STRING), s_vals)
    return {
        "a": ex.ColumnVal(a),
        "d": ex.ColumnVal(None, None, True, block=d_blk),
        "bp": ex.ColumnVal(None, None, True, block=bp_blk),
        "s": ex.ColumnVal(None, s_blk.str_dict, True, block=s_blk),
    }


def _sweep(m):
    C, L = m.Col, m.Lit
    return [
        m.Cmp(">", C("a"), L(3)),
        m.And(m.Cmp(">=", C("d"), L(-3)), m.Cmp("<", C("d"), L(11))),
        m.Cmp("=", C("s"), L("g3")),
        m.Cmp("=", C("s"), L("absent")),     # literal not in the dictionary
        m.Cmp("!=", C("s"), L("absent")),    # ... negation sees every row
        m.InList(C("s"), ("g1", "g5", "nope")),
        m.Between(C("d"), -3, 5),
        m.Between(C("bp"), -30, -1),         # negative BITPACK bias range
        m.Or(m.Not(m.Cmp("=", C("a"), L(0))), m.Cmp("<=", C("s"), L("g2"))),
        m.BinOp("+", C("bp"), m.BinOp("*", C("d"), L(2))),
        m.BinOp("/", C("a"), L(4)),
        m.Func("ABS", (C("bp"),)),
        m.Func("LENGTH", (C("s"),)),
        C("s"),
        m.Cmp("<", L(5), C("d")),
    ]


def _values(v):
    return v.decoded() if v.is_string else np.asarray(v.arr)


def _assert_same(got, want):
    if want.dtype.kind in "fc" or got.dtype.kind in "fc":
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=1e-12)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("idx", range(15))
def test_compile_expr_matches_evaluate(idx):
    """The port's compiled expression equals its own evaluate() and the
    reference's compiled expression on the same encoded blocks."""
    t_expr, j_expr = _sweep(tx)[idx], _sweep(jx)[idx]
    t_ctx, j_ctx = _ctx("torch"), _ctx("jax")
    got = tx.compile_expr(t_expr)(t_ctx)
    own = tx.evaluate(t_expr, _ctx("torch"))
    ref = jx.compile_expr(j_expr)(j_ctx)
    assert got.is_string == own.is_string == ref.is_string
    for want in (own, ref):
        _assert_same(_values(got), _values(want))


def test_nan_dictionary_stays_off_code_space():
    """NaN-bearing float dictionaries refuse code space in both packages
    (np.unique sorts NaN to the tail, so code bounds would admit it), and
    the compiled results equal evaluate() and the reference's."""
    vals = np.array([1.0, 2.0, np.nan, 3.0, 2.0, np.nan])
    out = {}
    for pkg, (col, comp, ex, ty) in PACKAGES.items():
        blk = col.make_block(ty.Field("x", ty.DType.FLOAT64), vals,
                             comp.Encoding.DICT)
        assert blk.code_space() is None
        ctx = {"x": ex.ColumnVal(None, None, True, block=blk)}
        res = []
        for expr in (ex.Cmp(">", ex.Col("x"), ex.Lit(2.0)),
                     ex.Cmp(">=", ex.Col("x"), ex.Lit(2.0)),
                     ex.Between(ex.Col("x"), 1.5, 3.5)):
            got = np.asarray(ex.compile_expr(expr)(ctx).arr)
            np.testing.assert_array_equal(
                got, np.asarray(ex.evaluate(expr, ctx).arr))
            res.append(got)
        out[pkg] = res
    for g, w in zip(out["torch"], out["jax"]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(out["torch"][0],
                                  [False, False, False, True, False, False])


def test_code_space_predicate_never_decodes():
    """A filter-only DICT column is evaluated on codes in both packages:
    the block is never decoded, and the masks agree."""
    masks = {}
    for pkg in PACKAGES:
        ex = PACKAGES[pkg][2]
        ctx = _ctx(pkg)
        masks[pkg] = np.asarray(ex.compile_expr(
            ex.Between(ex.Col("d"), -3, 5))(ctx).arr)
        assert not ctx["d"].materialized
        assert ctx["d"].block.enc.decode_count == 0
    np.testing.assert_array_equal(masks["torch"], masks["jax"])


# ---------------------------------------------------------------------------
# Engine-level: segments, metrics, sdict sharing, dual-backend parity
# ---------------------------------------------------------------------------


def _star_data(rows=3000):
    rng = np.random.default_rng(0)
    return {
        "fn": rng.integers(0, 100, rows).astype(np.int64),
        "fv": rng.uniform(0, 10, rows),
        # few distinct values -> the load task dictionary-encodes this one
        "fd": rng.choice(np.round(np.linspace(0.0, 9.0, 37), 3), rows),
        "fs": np.array([f"g{i}" for i in rng.integers(0, 8, rows)]),
    }


def _star_session(pkg, backend="compiled", pde_config=None, rows=3000,
                  partitions=3):
    data = _star_data(rows)
    if pkg == "jax":
        sess = JaxSession(num_workers=2, max_threads=4,
                          default_partitions=partitions, backend=backend,
                          pde_config=pde_config)
        D, S = JDType, JSchema
    else:
        sess = TorchSession(num_workers=2, max_threads=4,
                            default_partitions=partitions, backend=backend,
                            pde_config=pde_config, device="cpu")
        D, S = TDType, TSchema
    sess.create_table("t", S.of(fn=D.INT64, fv=D.FLOAT64, fd=D.FLOAT64,
                                fs=D.STRING), data)
    return sess, data


def _both(sql, backend="compiled", pde=None, rows=3000):
    """The query on the port and on the reference: (results, sessions)."""
    out, sessions = {}, {}
    for pkg in PACKAGES:
        cfg = None
        if pde is not None:
            cfg = (JaxPDEConfig if pkg == "jax" else TorchPDEConfig)(**pde)
        sess, data = _star_session(pkg, backend, cfg, rows)
        out[pkg] = sess.sql_np(sql)
        sessions[pkg] = sess
    return out, sessions, data


def _shutdown(sessions):
    for sess in sessions.values():
        sess.shutdown()


def _same_rows(got, want, key):
    og, ow = np.argsort(got[key], kind="stable"), np.argsort(want[key],
                                                             kind="stable")
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k])[og], np.asarray(want[k])[ow]
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12)
        else:
            np.testing.assert_array_equal(g, w)


def test_segment_fused_aggregate_metrics():
    out, sessions, data = _both(
        "SELECT fs, SUM(fv) AS s, COUNT(*) AS c FROM t "
        "WHERE fn BETWEEN 20 AND 60 GROUP BY fs")
    _same_rows(out["torch"], out["jax"], "fs")
    shapes = {}
    for pkg, sess in sessions.items():
        m = sess.metrics()
        assert m.interpreted_scan_ops == 0
        # one scan-side segment + one reduce-side merge record
        assert len(m.segments) == 2
        seg, merge = m.segments
        assert seg.consumer == "aggregate" and seg.pred is not None
        assert seg.routes.get("jit", 0) == seg.partitions > 0
        assert seg.rows_in == len(data["fn"])
        assert merge.consumer == "merge_aggregate" and merge.partitions > 0
        shapes[pkg] = [(s.consumer, s.partitions, s.rows_in, s.rows_out,
                        dict(s.routes)) for s in m.segments]
    assert shapes["torch"] == shapes["jax"]
    # cross-check against pure numpy
    got = out["torch"]
    mask = (data["fn"] >= 20) & (data["fn"] <= 60)
    order = np.argsort(got["fs"])
    for i, g in enumerate(np.asarray(got["fs"])[order]):
        gm = mask & (data["fs"] == g)
        np.testing.assert_allclose(np.asarray(got["s"])[order][i],
                                   data["fv"][gm].sum(), rtol=1e-9)
        assert np.asarray(got["c"])[order][i] == gm.sum()
    _shutdown(sessions)


def test_renamed_dict_column_keeps_sdict_order_by_limit():
    """A projection that renames a dict-encoded string column keeps
    (codes, sdict) sharing, and ORDER BY + LIMIT over it sees string
    order: the port's compiled and numpy backends and the reference
    agree."""
    sql = ("SELECT fs AS label, fn FROM t WHERE fn >= 10 "
           "ORDER BY label DESC LIMIT 9")
    out, sessions, data = _both(sql)
    sess_n, _ = _star_session("torch", backend="numpy")
    got_n = sess_n.sql_np(sql)
    got = out["torch"]
    assert got["label"].dtype.kind == "U", "renamed column lost stringness"
    for want in (out["jax"], got_n):
        np.testing.assert_array_equal(got["label"], want["label"])
        np.testing.assert_array_equal(got["fn"], want["fn"])
    ref = np.sort(data["fs"][data["fn"] >= 10])[::-1][:9]
    np.testing.assert_array_equal(np.sort(got["label"])[::-1], ref)
    for sess in sessions.values():
        seg = sess.metrics().segments[0]
        assert seg.consumer == "sort" and "label" in seg.kept_code_cols
    _shutdown(sessions)
    sess_n.shutdown()


def test_segment_fallback_on_string_function():
    """String-transforming functions are not traceable: the segment falls
    back to the numpy evaluator in both packages, recorded alike."""
    out, sessions, data = _both("SELECT UPPER(fs) AS u FROM t WHERE fn < 50")
    want = np.sort(np.char.upper(data["fs"][data["fn"] < 50]))
    for pkg, sess in sessions.items():
        m = sess.metrics()
        assert len(m.segments) == 1 and m.segments[0].fallbacks > 0
        assert m.segments[0].routes.get("numpy", 0) == m.segments[0].partitions
        np.testing.assert_array_equal(np.sort(out[pkg]["u"]), want)
    assert sessions["torch"].metrics().segments[0].fallbacks == \
        sessions["jax"].metrics().segments[0].fallbacks
    _shutdown(sessions)


def test_backend_numpy_never_compiles():
    out, sessions, _ = _both("SELECT fn, fv FROM t WHERE fv > 5",
                             backend="numpy")
    for sess in sessions.values():
        m = sess.metrics()
        assert m.compiled_partitions() == 0
        assert m.segment_routes() == {"numpy": m.segments[0].partitions}
    assert sessions["torch"].metrics().segment_routes() == \
        sessions["jax"].metrics().segment_routes()
    _same_rows(out["torch"], out["jax"], "fv")
    _shutdown(sessions)


# ---------------------------------------------------------------------------
# Decode memoization
# ---------------------------------------------------------------------------


def test_decode_memoized_and_droppable():
    vals = np.random.default_rng(7).integers(-100, 100, 4096).astype(
        np.int64)
    encs = {pkg: PACKAGES[pkg][1].encode(vals, PACKAGES[pkg][1].Encoding
                                         .BITPACK) for pkg in PACKAGES}
    for pkg, enc in encs.items():
        comp = PACKAGES[pkg][1]
        a = comp.decode_np(enc)
        b = comp.decode_np(enc)
        assert a is b and enc.decode_count == 1
        np.testing.assert_array_equal(a, vals)
        freed = enc.drop_decoded()
        assert freed == a.nbytes and enc.decoded_nbytes == 0
        c = comp.decode_np(enc)
        assert enc.decode_count == 2
        np.testing.assert_array_equal(c, vals)
    assert encs["torch"].bit_width == encs["jax"].bit_width
    np.testing.assert_array_equal(encs["torch"].words, encs["jax"].words)


def test_memory_manager_drops_decode_caches():
    """The server's MemoryManager releases the column store's host decode
    memos: the same bytes and counters as the reference's."""
    out = {}
    for pkg in PACKAGES:
        root = "repro" if pkg == "jax" else "repro_torch"
        server = __import__(f"{root}.server", fromlist=["MemoryManager"])
        runtime = __import__(f"{root}.core.runtime",
                             fromlist=["BlockManager"])
        sess, _ = _star_session(pkg)
        # no WHERE: fn is consumed as values, so its decode is memoized (a
        # filtered dict column would be gathered post-mask and never cached)
        sess.sql_np("SELECT SUM(fn) AS s FROM t")
        mm = server.MemoryManager(runtime.BlockManager())
        mm.attach_catalog(sess.catalog)
        table = sess.catalog.get("t")
        held = table.decoded_cache_nbytes
        assert held > 0
        freed = mm.drop_decoded_caches()
        assert freed > 0 and table.decoded_cache_nbytes == 0
        stats = mm.stats()
        assert stats["decode_cache_drops"] == 1
        out[pkg] = (held, freed, stats["decode_cache_drops"],
                    stats["decode_cache_dropped_bytes"])
        sess.shutdown()
    assert out["torch"] == out["jax"]


def test_query_decodes_each_block_once():
    """Predicate + projection + aggregation over one column hit the
    memoized decode, not one decode per operator, in both packages; the
    answers agree."""
    out, sessions, _ = _both(
        "SELECT SUM(fv) AS s, AVG(fv) AS a, MAX(fv) AS m FROM t "
        "WHERE fv BETWEEN 2 AND 8")
    counts = {}
    for pkg, sess in sessions.items():
        table = sess.catalog.get("t")
        counts[pkg] = [p.columns["fv"].enc.decode_count
                       for p in table.partitions]
        assert all(c <= 1 for c in counts[pkg])
    assert counts["torch"] == counts["jax"]
    for k in out["jax"]:
        np.testing.assert_allclose(out["torch"][k], out["jax"][k],
                                   rtol=1e-12)
    _shutdown(sessions)


# ---------------------------------------------------------------------------
# Kernel routes forced through the engine (reference: Pallas in interpret
# mode; port: the kernel wrappers' plain versions on CPU tensors)
# ---------------------------------------------------------------------------

FORCE_KERNELS = dict(segment_force_kernels=True, segment_kernel_min_rows=256,
                     segment_min_compiled_rows=1)


def _kernel_route_matches(sql, route):
    """The query with the kernel routes forced, on both packages, against
    each other and the port's numpy backend: every column to rtol 1e-12,
    and `route` taken alike."""
    out, sessions, data = _both(sql, pde=FORCE_KERNELS)
    sess_n, _ = _star_session("torch", backend="numpy")
    want = sess_n.sql_np(sql)
    routes = {pkg: s.metrics().segment_routes()
              for pkg, s in sessions.items()}
    assert routes["torch"].get(route, 0) > 0, routes
    assert routes["torch"] == routes["jax"]
    assert out["torch"].keys() == out["jax"].keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(out["torch"][k], out["jax"][k],
                                   rtol=1e-12)
    for got in out.values():
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    _shutdown(sessions)
    sess_n.shutdown()
    return sessions


@pytest.mark.kernels_interpret
def test_colscan_route_matches_numpy_backend():
    _kernel_route_matches(
        "SELECT COUNT(*) AS c, SUM(fv) AS s, MIN(fv) AS mn, MAX(fv) AS mx, "
        "AVG(fv) AS av FROM t WHERE fn BETWEEN 25 AND 75", "colscan")


@pytest.mark.kernels_interpret
@pytest.mark.parametrize("op", [">", ">=", "<", "<=", "="])
def test_colscan_one_sided_ranges_exclude_padding(op):
    """One-sided ranges lower to lo/hi = ±inf: no padding (the TPU
    kernel's tiles) and no row past n (the CUDA kernel's ragged tail)
    satisfies them; the count is exact on both packages."""
    np_ops = {">": operator.gt, ">=": operator.ge, "<": operator.lt,
              "<=": operator.le, "=": operator.eq}
    out, sessions, data = _both(f"SELECT COUNT(*) AS c FROM t WHERE fn {op} "
                                f"47", pde=FORCE_KERNELS, rows=5000)
    want = int(np_ops[op](data["fn"], 47).sum())
    for pkg, sess in sessions.items():
        assert sess.metrics().segment_routes().get("colscan", 0) > 0
        assert int(out[pkg]["c"][0]) == want, (pkg, op, out[pkg]["c"], want)
    _shutdown(sessions)


@pytest.mark.kernels_interpret
def test_fused_decode_scan_route_on_dict_encoded_filter():
    # fd has 37 distinct values: the load task dictionary-encoded it in
    # both packages, so the filter column feeds the decode-fused kernel as
    # codes
    for pkg in PACKAGES:
        sess, _ = _star_session(pkg)
        enc = sess.catalog.get("t").partitions[0].columns["fd"].enc
        assert enc.encoding.value == "dict"
        sess.shutdown()
    _kernel_route_matches("SELECT COUNT(*) AS c, SUM(fv) AS s FROM t "
                          "WHERE fd BETWEEN 2.0 AND 7.5", "fused_decode_scan")


@pytest.mark.kernels_interpret
def test_groupby_mxu_route_matches_numpy_backend():
    sql = "SELECT fs, SUM(fv) AS s, COUNT(*) AS c FROM t GROUP BY fs"
    out, sessions, _ = _both(sql, pde=FORCE_KERNELS)
    sess_n, _ = _star_session("torch", backend="numpy")
    want = sess_n.sql_np(sql)
    routes = {pkg: s.metrics().segment_routes()
              for pkg, s in sessions.items()}
    assert routes["torch"].get("groupby_mxu", 0) > 0, routes
    assert routes["torch"] == routes["jax"]
    for got in out.values():
        _same_rows(got, want, "fs")
    _shutdown(sessions)
    sess_n.shutdown()


@pytest.mark.kernels_interpret
def test_groupby_ndv_guard_keeps_high_cardinality_off_kernel():
    """Backend selection is stats-driven and the same in both packages: a
    high-NDV group key does not take the group kernel, a low one does, and
    tiny partitions stay on the numpy evaluator by default."""
    jcfg, tcfg = JaxPDEConfig(**FORCE_KERNELS), TorchPDEConfig(
        **FORCE_KERNELS)
    for ndv, route in ((5000, "jit"), (8, "groupby_mxu")):
        ref = jax_decide(10_000, "groupby_mxu", group_ndv=ndv, on_tpu=False,
                         cfg=jcfg)
        got = torch_decide(10_000, "groupby_mxu", group_ndv=ndv,
                           on_gpu=False, cfg=tcfg)
        assert got.route == ref.route == route
    ref = jax_decide(10, "colscan", on_tpu=False, cfg=JaxPDEConfig())
    got = torch_decide(10, "colscan", on_gpu=False, cfg=TorchPDEConfig())
    assert got.route == ref.route == "numpy"
