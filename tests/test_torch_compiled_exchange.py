"""Compiled exchange on the torch port against the JAX reference: the twin
of tests/test_compiled_exchange.py.

Each body runs on both packages (`torch_twin.twin`; the port's sessions on
`device="cpu"`), asserts what its reference test asserts, and its answers
and plain-data locals must equal the reference's (integers and strings
exactly, floats to rtol 1e-12).  Where the port differs by design: PDE
asks `on_gpu=` where the reference asks `on_tpu=`; the port has no
`expr._x64` switch (torch keeps int64 without one); the kernel wrappers
take torch tensors.  The reference's docstring follows.

Compiled exchange (DESIGN.md §11): dictionary-preserving shuffle +
compiled reduce-side aggregation merge and join probe.

Covers the tentpole surface unit by unit — dictionary merge-remap concat,
decode-free string shuffles (asserted via the expr.DECODE_COUNTERS row
counter), the CompiledMerge / CompiledProbe jitted reduce kernels against
their interpreted oracles, int64-exact aggregation above 2^53, the
left-join string NULL fix, reduce-side route records in
ExecMetrics.segments, plan-fingerprint/explain invariance across exchange
modes, and (kernels_interpret-marked) the radix_partition and
segmented_merge Pallas kernels forced on CPU.
"""

import contextlib

import numpy as np
import pytest

from torch_twin import JAX, P, observed, twin


def _operand(a):
    """A kernel wrapper's operand: numpy for the reference, a torch tensor
    for the port (whose wrappers take tensors)."""
    if P.pkg is JAX:
        return a
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))


def _x64():
    """The reference's 64-bit switch; the port keeps int64 and float64
    without one."""
    if P.pkg is JAX:
        return P.m("core.expr")._x64()
    return contextlib.nullcontext()


def _accel():
    """PDE's accelerator flag: `on_tpu` for the reference, `on_gpu` for the
    port."""
    return {"on_tpu" if P.pkg is JAX else "on_gpu": True}


SESSION_KW = dict(num_workers=2, max_threads=4, default_partitions=3,
                  default_shuffle_buckets=4)


# ---------------------------------------------------------------------------
# dictionary-preserving concat
# ---------------------------------------------------------------------------


def _merge_string_dicts_unifies_and_remaps():
    d1 = np.array(["b", "d", "f"])
    d2 = np.array(["a", "d", "z"])
    unified, (r1, r2) = P.m("core.batch").merge_string_dicts([d1, d2])
    assert unified.tolist() == ["a", "b", "d", "f", "z"]
    assert unified[r1].tolist() == d1.tolist()
    assert unified[r2].tolist() == d2.tolist()
    return observed(locals())


def test_merge_string_dicts_unifies_and_remaps():
    twin(_merge_string_dicts_unifies_and_remaps)


def _concat_preserves_dictionaries_without_decoding():
    b1 = P.m("core.batch").PartitionBatch.from_numpy({"s": np.array(["b", "a", "b"]),
                                    "v": np.array([1.0, 2.0, 3.0])})
    b2 = P.m("core.batch").PartitionBatch.from_numpy({"s": np.array(["c", "a"]),
                                    "v": np.array([4.0, 5.0])})
    P.m("core.expr").reset_decode_counters()
    merged = P.m("core.batch").PartitionBatch.concat([b1, b2])
    assert P.m("core.expr").DECODE_COUNTERS["string_rows"] == 0
    sv = merged.cols["s"]
    assert sv.is_string and sv.sorted_dict
    assert sv.sdict.tolist() == ["a", "b", "c"]
    assert sv.decoded().tolist() == ["b", "a", "b", "c", "a"]
    assert np.asarray(merged.cols["v"].arr).tolist() == [1, 2, 3, 4, 5]
    return observed(locals())


def test_concat_preserves_dictionaries_without_decoding():
    twin(_concat_preserves_dictionaries_without_decoding)


def _concat_normalizes_unsorted_transform_dicts():
    # a string-function output: unsorted, duplicate-bearing dictionary
    codes = np.array([0, 1, 2], np.int32)
    d = np.array(["bb", "aa", "bb"])
    piece = P.m("core.batch").PartitionBatch({"s": P.m("core.expr").ColumnVal(codes, d, sorted_dict=False)})
    merged = P.m("core.batch").PartitionBatch.concat([piece])
    sv = merged.cols["s"]
    assert sv.sorted_dict and sv.sdict.tolist() == ["aa", "bb"]
    assert sv.decoded().tolist() == ["bb", "aa", "bb"]
    return observed(locals())


def test_concat_normalizes_unsorted_transform_dicts():
    twin(_concat_normalizes_unsorted_transform_dicts)


# ---------------------------------------------------------------------------
# compiled join probe
# ---------------------------------------------------------------------------


def _compiled_probe_matches_oracle():
    rng = np.random.default_rng(7)
    probe = P.m("core.joins").compile_probe()
    for _ in range(25):
        lk = rng.integers(0, 40, rng.integers(0, 200)).astype(np.int64)
        rk = rng.integers(0, 40, rng.integers(0, 200)).astype(np.int64)
        l1, r1 = P.m("core.joins")._match_pairs(lk, rk)
        l2, r2 = probe(lk, rk)
        assert np.array_equal(l1, l2) and np.array_equal(r1, r2)
    return observed(locals())


def test_compiled_probe_matches_oracle():
    twin(_compiled_probe_matches_oracle)


def _compiled_probe_sentinel_collision():
    """Real keys equal to the padding sentinel (int64 max / +inf) must not
    match the pad region."""
    probe = P.m("core.joins").compile_probe()
    lk = np.array([2**63 - 1, 5], np.int64)
    rk = np.array([5, 2**63 - 1, 2**63 - 1], np.int64)
    l1, r1 = P.m("core.joins")._match_pairs(lk, rk)
    l2, r2 = probe(lk, rk)
    assert np.array_equal(l1, l2) and np.array_equal(r1, r2)
    lkf = np.array([np.inf, 1.5])
    rkf = np.array([np.inf, 1.5, np.inf])
    l1, r1 = P.m("core.joins")._match_pairs(lkf, rkf)
    l2, r2 = probe(lkf, rkf)
    assert np.array_equal(l1, l2) and np.array_equal(r1, r2)
    return observed(locals())


def test_compiled_probe_sentinel_collision():
    twin(_compiled_probe_sentinel_collision)


def _compiled_probe_nan_keys_fall_back():
    """NaN float keys sort after the +inf pad sentinel, breaking the
    padding invariant — the probe must refuse (TypeError) and the reduce
    runner must fall back to the interpreted oracle."""
    PDEConfig = P.m("core.pde").PDEConfig
    ReduceRunner = P.m("core.physical").ReduceRunner
    SegmentRecord = P.m("core.physical").SegmentRecord
    probe = P.m("core.joins").compile_probe()
    with pytest.raises(TypeError):
        probe(np.array([1.0, np.nan]), np.array([np.nan, 1.0]))
    rec = SegmentRecord(table="<exchange>", depth=1, consumer="join_probe",
                        outputs=[], pred=None)
    rr = ReduceRunner("compiled", P.m("core.pde").PDEConfig(reduce_force_compiled=True), rec)
    l = P.m("core.batch").PartitionBatch.from_numpy({"k": np.array([1.0, np.nan]),
                                   "lv": np.array([1.0, 2.0])})
    r = P.m("core.batch").PartitionBatch.from_numpy({"k": np.array([np.nan, 1.0]),
                                   "rv": np.array([9.0, 8.0])})
    out = rr.join(l, r, "k", "k", "inner")
    ref = P.m("core.joins").join_local(l, r, "k", "k", "inner")
    assert np.array_equal(np.asarray(out.cols["lv"].arr),
                          np.asarray(ref.cols["lv"].arr))
    assert rec.fallbacks == 1 and rec.routes.get("numpy") == 1
    return observed(locals())


def test_compiled_probe_nan_keys_fall_back():
    twin(_compiled_probe_nan_keys_fall_back)


def _compiled_probe_bool_keys_fall_back():
    """BOOL keys have no iinfo pad sentinel: the probe must refuse with
    TypeError (not ValueError) so the reduce runner's oracle fallback
    engages instead of failing the query."""
    with pytest.raises(TypeError) as err:
        P.m("core.joins").compile_probe()(np.array([True, False]), np.array([False, True]))
    return err.type.__name__


def test_compiled_probe_bool_keys_fall_back():
    twin(_compiled_probe_bool_keys_fall_back)


def _dict_hash_cache_hits_and_evicts():
    import gc

    _DICT_HASH_CACHE = P.m("core.shuffle")._DICT_HASH_CACHE
    _dict_hashes = P.m("core.shuffle")._dict_hashes
    d = np.array(["alpha", "beta"])
    h1 = _dict_hashes(d)
    assert _dict_hashes(d) is h1        # memoized per dictionary object
    key_count = len(_DICT_HASH_CACHE)
    del d
    gc.collect()
    assert len(_DICT_HASH_CACHE) < key_count    # finalizer evicted it
    # the cache is process-wide: its size depends on earlier tests
    return observed(locals(), skip=("key_count",))


def test_dict_hash_cache_hits_and_evicts():
    twin(_dict_hash_cache_hits_and_evicts)


def _compiled_probe_empty_sides():
    probe = P.m("core.joins").compile_probe()
    empty = np.zeros(0, np.int64)
    keys = np.array([1, 2], np.int64)
    for lk, rk in ((empty, keys), (keys, empty), (empty, empty)):
        l2, r2 = probe(lk, rk)
        assert len(l2) == 0 and len(r2) == 0
    return observed(locals())


def test_compiled_probe_empty_sides():
    twin(_compiled_probe_empty_sides)


# ---------------------------------------------------------------------------
# compiled merge + int64 exactness
# ---------------------------------------------------------------------------


def _specs():
    return [P.m("core.plan").AggSpec("s", P.m("core.plan").AggFunc.SUM, P.m("core.expr").Col("v")),
            P.m("core.plan").AggSpec("mn", P.m("core.plan").AggFunc.MIN, P.m("core.expr").Col("v")),
            P.m("core.plan").AggSpec("mx", P.m("core.plan").AggFunc.MAX, P.m("core.expr").Col("v")),
            P.m("core.plan").AggSpec("c", P.m("core.plan").AggFunc.COUNT, None),
            P.m("core.plan").AggSpec("a", P.m("core.plan").AggFunc.AVG, P.m("core.expr").Col("v"))]


def _compiled_merge_matches_oracle():
    rng = np.random.default_rng(3)
    aggs = _specs()
    pieces = []
    for _ in range(4):
        n = int(rng.integers(1, 50))
        batch = P.m("core.batch").PartitionBatch.from_numpy({
            "g": np.array([f"g{i}" for i in rng.integers(0, 6, n)]),
            "v": rng.uniform(-10, 10, n)})
        pieces.append(P.m("core.aggregate").partial_aggregate(batch, ["g"], aggs))
    merged = P.m("core.batch").PartitionBatch.concat(pieces)
    ref = P.m("core.aggregate").merge_aggregate(merged, ["g"], aggs)
    got = P.m("core.aggregate").CompiledMerge(["g"], aggs)(merged)
    assert ref.cols["g"].decoded().tolist() == got.cols["g"].decoded().tolist()
    for k in ("s", "mn", "mx", "a"):
        np.testing.assert_allclose(np.asarray(got.cols[k].arr),
                                   np.asarray(ref.cols[k].arr), rtol=1e-12)
    assert np.array_equal(np.asarray(got.cols["c"].arr),
                          np.asarray(ref.cols["c"].arr))
    return observed(locals())


def test_compiled_merge_matches_oracle():
    twin(_compiled_merge_matches_oracle)


def _int64_aggregates_exact_above_2_53():
    """SUM/MIN/MAX of int64 values above 2^53 must not round-trip through
    float64 — deterministic values whose float64 images collide."""
    base = 2**60
    vals = np.array([base + 1, base + 3, base + 1, base + 7, base + 2],
                    np.int64)
    grp = np.array(["x", "y", "x", "y", "x"])
    aggs = [P.m("core.plan").AggSpec("s", P.m("core.plan").AggFunc.SUM, P.m("core.expr").Col("v")),
            P.m("core.plan").AggSpec("mn", P.m("core.plan").AggFunc.MIN, P.m("core.expr").Col("v")),
            P.m("core.plan").AggSpec("mx", P.m("core.plan").AggFunc.MAX, P.m("core.expr").Col("v"))]
    batch = P.m("core.batch").PartitionBatch.from_numpy({"g": grp, "v": vals})
    part = P.m("core.aggregate").partial_aggregate(batch, ["g"], aggs)
    for out in (P.m("core.aggregate").merge_aggregate(part, ["g"], aggs),
                P.m("core.aggregate").CompiledMerge(["g"], aggs)(part)):
        order = np.argsort(out.cols["g"].decoded())
        s = np.asarray(out.cols["s"].arr)[order]
        assert s.dtype == np.int64
        assert s.tolist() == [3 * base + 4, 2 * base + 10]
        assert np.asarray(out.cols["mn"].arr)[order].tolist() == \
            [base + 1, base + 3]
        assert np.asarray(out.cols["mx"].arr)[order].tolist() == \
            [base + 2, base + 7]
    return observed(locals())


def test_int64_aggregates_exact_above_2_53():
    twin(_int64_aggregates_exact_above_2_53)


def _int64_sum_exact_through_sql():
    """End-to-end: the engine's default (compiled) path keeps integer sums
    integer across partial -> shuffle -> merge."""
    base = 2**60
    n = 96
    vals = (base + np.arange(1, n + 1)).astype(np.int64)
    grp = np.array(["a", "b"] * (n // 2))
    for kw in (dict(), dict(pde_config=P.m("core.pde").PDEConfig(reduce_force_compiled=True))):
        sess = P.SharkSession(**SESSION_KW, **kw)
        sess.create_table("t", P.Schema.of(g=P.DType.STRING, v=P.DType.INT64),
                          {"g": grp, "v": vals})
        got = sess.sql_np("SELECT g, SUM(v) AS s, MIN(v) AS mn, "
                          "MAX(v) AS mx FROM t GROUP BY g")
        order = np.argsort(got["g"])
        for g, s, mn, mx in zip(np.asarray(got["g"])[order],
                                np.asarray(got["s"])[order],
                                np.asarray(got["mn"])[order],
                                np.asarray(got["mx"])[order]):
            mask = grp == g
            assert int(s) == int(vals[mask].sum())
            assert int(mn) == int(vals[mask].min())
            assert int(mx) == int(vals[mask].max())
        sess.shutdown()
    return observed(locals())


def test_int64_sum_exact_through_sql():
    twin(_int64_sum_exact_through_sql)


def _compiled_merge_refuses_count_distinct():
    ExprCompileError = P.m("core.expr").ExprCompileError
    with pytest.raises(ExprCompileError) as err:
        P.m("core.aggregate").CompiledMerge(["g"], [P.m("core.plan").AggSpec("d", P.m("core.plan").AggFunc.COUNT_DISTINCT,
                                      P.m("core.expr").Col("v"))])
    return err.type.__name__


def test_compiled_merge_refuses_count_distinct():
    twin(_compiled_merge_refuses_count_distinct)


# ---------------------------------------------------------------------------
# left join NULL emulation for strings
# ---------------------------------------------------------------------------


def _left_join_string_nulls():
    """Regression: right-side STRING columns of unmatched left rows used to
    keep row 0's value; they must take the reserved null code ("")."""
    left = P.m("core.batch").PartitionBatch.from_numpy({
        "lk": np.array([1, 2, 3, 4], np.int64),
        "lv": np.array([10.0, 20.0, 30.0, 40.0])})
    right = P.m("core.batch").PartitionBatch.from_numpy({
        "rk": np.array([1, 3], np.int64),
        "rs": np.array(["hit1", "hit3"]),
        "rv": np.array([100.0, 300.0])})
    out = P.m("core.joins").join_local(left, right, "lk", "rk", how="left")
    rows = sorted(zip(np.asarray(out.cols["lk"].arr).tolist(),
                      out.cols["rs"].decoded().tolist(),
                      np.asarray(out.cols["rv"].arr).tolist()))
    assert rows == [(1, "hit1", 100.0), (2, "", 0.0),
                    (3, "hit3", 300.0), (4, "", 0.0)]
    return observed(locals())


def test_left_join_string_nulls():
    twin(_left_join_string_nulls)


def _left_join_string_nulls_compiled_probe():
    left = P.m("core.batch").PartitionBatch.from_numpy({
        "lk": np.array([1, 2], np.int64), "lv": np.array([1.0, 2.0])})
    right = P.m("core.batch").PartitionBatch.from_numpy({
        "rk": np.array([2], np.int64), "rs": np.array(["only2"])})
    out = P.m("core.joins").join_local(left, right, "lk", "rk", how="left",
                     matcher=P.m("core.joins").compile_probe())
    rows = sorted(zip(np.asarray(out.cols["lk"].arr).tolist(),
                      out.cols["rs"].decoded().tolist()))
    assert rows == [(1, ""), (2, "only2")]
    return observed(locals())


def test_left_join_string_nulls_compiled_probe():
    twin(_left_join_string_nulls_compiled_probe)


def _left_join_empty_right_side():
    left = P.m("core.batch").PartitionBatch.from_numpy({
        "lk": np.array([7, 8], np.int64), "lv": np.array([1.0, 2.0])})
    right = P.m("core.batch").PartitionBatch.from_numpy({
        "rk": np.zeros(0, np.int64), "rs": np.zeros(0, np.str_),
        "rv": np.zeros(0, np.float64)})
    out = P.m("core.joins").join_local(left, right, "lk", "rk", how="left")
    assert np.asarray(out.cols["lk"].arr).tolist() == [7, 8]
    assert out.cols["rs"].decoded().tolist() == ["", ""]
    assert np.asarray(out.cols["rv"].arr).tolist() == [0.0, 0.0]
    return observed(locals())


def test_left_join_empty_right_side():
    twin(_left_join_empty_right_side)


def _string_join_keys_never_decode():
    left = P.m("core.batch").PartitionBatch.from_numpy({
        "k": np.array(["a", "b", "c", "b"]), "lv": np.arange(4.0)})
    right = P.m("core.batch").PartitionBatch.from_numpy({
        "k": np.array(["b", "z", "a"]), "rv": np.arange(3.0)})
    P.m("core.expr").reset_decode_counters()
    out = P.m("core.joins").join_local(left, right, "k", "k", how="inner")
    assert P.m("core.expr").DECODE_COUNTERS["string_rows"] == 0
    assert sorted(out.cols["k"].decoded().tolist()) == ["a", "b", "b"]
    return observed(locals())


def test_string_join_keys_never_decode():
    twin(_string_join_keys_never_decode)


# ---------------------------------------------------------------------------
# decode-free exchange end to end + route records + fingerprints
# ---------------------------------------------------------------------------


def _data(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    return {
        "g": np.array([f"u{i:04d}" for i in rng.integers(0, 500, n)]),
        "v": rng.uniform(0, 10, n),
        "k": rng.integers(0, 40, n).astype(np.int64),
    }


def _schema():
    return P.Schema.of(g=P.DType.STRING, v=P.DType.FLOAT64, k=P.DType.INT64)


def _mk(exchange="coded", **kw):
    sess = P.SharkSession(**SESSION_KW, exchange=exchange, **kw)
    sess.create_table("t", _schema(), _data())
    sess.create_table("d", P.Schema.of(dk=P.DType.INT64, ds=P.DType.STRING),
                      {"dk": np.arange(40, dtype=np.int64),
                       "ds": np.array([f"d{i % 5}" for i in range(40)])})
    return sess


def _coded_exchange_is_decode_free():
    sess = _mk()
    queries = [
        "SELECT g, COUNT(*) AS c, SUM(v) AS s FROM t GROUP BY g",
        "SELECT ds, SUM(v) AS s FROM t JOIN d ON t.k = d.dk GROUP BY ds",
        "SELECT g, v FROM t ORDER BY g LIMIT 7",
    ]
    for q in queries:
        P.m("core.expr").reset_decode_counters()
        sess.sql(q)          # execute eagerly, but don't materialize results
        assert P.m("core.expr").DECODE_COUNTERS["string_rows"] == 0, \
            f"shuffle path decoded strings\n  {q}"
    sess.shutdown()
    return observed(locals())


def test_coded_exchange_is_decode_free():
    twin(_coded_exchange_is_decode_free)


def _exchange_modes_agree_row_identically():
    coded, decoded = _mk("coded"), _mk("decoded")
    queries = [
        "SELECT g, COUNT(*) AS c, SUM(v) AS s FROM t GROUP BY g",
        "SELECT ds, COUNT(*) AS c FROM t JOIN d ON t.k = d.dk GROUP BY ds",
        "SELECT g, v FROM t ORDER BY g, v LIMIT 25",
    ]
    for q in queries:
        a, b = coded.sql_np(q), decoded.sql_np(q)
        for col in a:
            av, bv = np.asarray(a[col]), np.asarray(b[col])
            oa = np.lexsort([np.asarray(a[c]).astype(str) for c in a])
            ob = np.lexsort([np.asarray(b[c]).astype(str) for c in b])
            if av.dtype.kind == "f":
                np.testing.assert_allclose(av[oa], bv[ob], rtol=1e-9)
            else:
                assert av[oa].tolist() == bv[ob].tolist(), (q, col)
    coded.shutdown()
    decoded.shutdown()
    return observed(locals())


def test_exchange_modes_agree_row_identically():
    twin(_exchange_modes_agree_row_identically)


def _exchange_mode_leaves_plans_untouched():
    """explain() and plan_fingerprint are functions of the logical plan;
    the exchange is physical-layer only — byte-identical across modes."""
    optimize = P.m("core.plan").optimize
    plan_fingerprint = P.m("server.result_cache").plan_fingerprint
    coded, decoded = _mk("coded"), _mk("decoded")
    q = ("SELECT ds, SUM(v) AS s FROM t JOIN d ON t.k = d.dk "
         "WHERE v > 1.5 GROUP BY ds ORDER BY s LIMIT 3")
    assert coded.explain(q) == decoded.explain(q)
    fp_c, _ = plan_fingerprint(optimize(coded.plan(q), coded.catalog),
                               coded.catalog)
    fp_d, _ = plan_fingerprint(optimize(decoded.plan(q), decoded.catalog),
                               decoded.catalog)
    assert fp_c == fp_d
    coded.shutdown()
    decoded.shutdown()
    return observed(locals())


def test_exchange_mode_leaves_plans_untouched():
    twin(_exchange_mode_leaves_plans_untouched)


def _reduce_routes_recorded_in_metrics():
    sess = _mk(pde_config=P.m("core.pde").PDEConfig(reduce_force_compiled=True))
    sess.sql("SELECT ds, SUM(v) AS s FROM t JOIN d ON t.k = d.dk GROUP BY ds")
    m = sess.metrics()
    consumers = {s.consumer for s in m.segments}
    assert "merge_aggregate" in consumers
    assert "join_probe" in consumers
    for s in m.segments:
        if s.consumer in ("merge_aggregate", "join_probe"):
            assert s.partitions > 0
            assert all(r != "numpy" for r in s.routes), s.describe()
    sess.shutdown()
    return sorted(consumers), [(s.consumer, s.partitions) for s in m.segments]


def test_reduce_routes_recorded_in_metrics():
    twin(_reduce_routes_recorded_in_metrics)


def _reduce_routes_numpy_for_tiny_and_oracle_backend():
    sess = _mk()     # default threshold: tiny reduce tasks stay interpreted
    sess.sql("SELECT g, COUNT(*) AS c FROM t GROUP BY g")
    m = sess.metrics()
    merges = [s for s in m.segments if s.consumer == "merge_aggregate"]
    assert merges and all(set(s.routes) == {"numpy"} for s in merges)
    sess.shutdown()
    oracle = _mk(backend="numpy")
    oracle.sql("SELECT ds, SUM(v) AS s FROM t JOIN d ON t.k = d.dk "
               "GROUP BY ds")
    m = oracle.metrics()
    assert m.compiled_partitions() == 0
    oracle.shutdown()
    return [(s.consumer, dict(s.routes)) for s in merges]


def test_reduce_routes_numpy_for_tiny_and_oracle_backend():
    twin(_reduce_routes_numpy_for_tiny_and_oracle_backend)


def _decide_reduce_backend_routes():
    cfg = P.m("core.pde").PDEConfig()
    assert P.m("core.pde").decide_reduce_backend(10, cfg=cfg).route == "numpy"
    # on CPU, host numpy is the reduce fast path even for large tasks
    assert P.m("core.pde").decide_reduce_backend(100_000, cfg=cfg).route == "numpy"
    assert P.m("core.pde").decide_reduce_backend(100_000, **_accel(), cfg=cfg).route == "jit"
    # tiny bucket groups stay interpreted even on TPU
    assert P.m("core.pde").decide_reduce_backend(10, **_accel(), cfg=cfg).route == "numpy"
    forced = P.m("core.pde").PDEConfig(reduce_force_compiled=True)
    assert P.m("core.pde").decide_reduce_backend(10, cfg=forced).route == "jit"
    kcfg = P.m("core.pde").PDEConfig(segment_force_kernels=True,
                     reduce_force_compiled=True)
    assert P.m("core.pde").decide_reduce_backend(
        100_000, "segmented_merge", 32, cfg=kcfg).route == "segmented_merge"
    assert P.m("core.pde").decide_reduce_backend(
        100_000, "segmented_merge", 10_000, cfg=kcfg).route == "jit"
    assert P.m("core.pde").decide_reduce_backend(
        100_000, "segmented_merge", 32, **_accel(),
        cfg=cfg).route == "segmented_merge"
    return [P.m("core.pde").decide_reduce_backend(n, k, g, cfg=c).route
            for n, k, g, c in ((10, None, None, cfg), (100_000, None, None, cfg),
                               (10, None, None, forced),
                               (100_000, "segmented_merge", 32, kcfg),
                               (100_000, "segmented_merge", 10_000, kcfg))]


def test_decide_reduce_backend_routes():
    twin(_decide_reduce_backend_routes)


# ---------------------------------------------------------------------------
# Pallas kernels (interpret mode on CPU)
# ---------------------------------------------------------------------------


def _merge(ops, codes, vals, num_groups):
    """segmented_merge in float64: the reference takes `acc_dtype`, the
    port accumulates in its values' dtype (float64 here)."""
    if P.pkg is JAX:
        return ops.segmented_merge(codes, vals, num_groups,
                                   acc_dtype="float64")
    return ops.segmented_merge(_operand(codes), _operand(vals), num_groups)


def _segmented_merge_kernel_matches_numpy():
    ops = P.m("kernels").ops
    rng = np.random.default_rng(11)
    n, num_groups = 3000, 19
    codes = rng.integers(0, num_groups, n).astype(np.int32)
    vals = rng.uniform(-5, 5, n)
    with _x64():
        res = np.asarray(_merge(ops, codes, vals, num_groups))
    np.testing.assert_allclose(
        res[:, 0], np.bincount(codes, weights=vals, minlength=num_groups),
        rtol=1e-12)
    assert np.array_equal(res[:, 1].astype(np.int64),
                          np.bincount(codes, minlength=num_groups))
    for g in range(num_groups):
        sel = vals[codes == g]
        assert np.isclose(res[g, 2], sel.min())
        assert np.isclose(res[g, 3], sel.max())
    return observed(locals())


@pytest.mark.kernels_interpret
def test_segmented_merge_kernel_matches_numpy():
    twin(_segmented_merge_kernel_matches_numpy)


def _segmented_merge_kernel_empty_groups():
    ops = P.m("kernels").ops
    codes = np.array([0, 2, 2], np.int32)     # group 1 empty
    vals = np.array([1.0, 2.0, 3.0])
    with _x64():
        res = np.asarray(_merge(ops, codes, vals, 3))
    assert res[1, 1] == 0 and res[1, 2] == np.inf and res[1, 3] == -np.inf
    return observed(locals())


@pytest.mark.kernels_interpret
def test_segmented_merge_kernel_empty_groups():
    twin(_segmented_merge_kernel_empty_groups)


def _radix_partition_kernel_matches_reference():
    ops = P.m("kernels").ops
    fold_keys_u32 = P.m("kernels.radix_partition").fold_keys_u32
    radix_partition_ref = P.m("kernels.radix_partition").radix_partition_ref
    rng = np.random.default_rng(5)
    keys = rng.integers(-2**62, 2**62, 5000).astype(np.int64)
    folded = fold_keys_u32(keys)
    for nb in (4, 16, 130):
        b, c = ops.radix_partition(_operand(folded), nb)
        rb, rc = radix_partition_ref(folded, nb)
        assert np.array_equal(np.asarray(b), rb)
        assert np.array_equal(np.asarray(c), rc)
        assert int(np.asarray(c).sum()) == len(keys)
    return observed(locals())


@pytest.mark.kernels_interpret
def test_radix_partition_kernel_matches_reference():
    twin(_radix_partition_kernel_matches_reference)


def _forced_kernel_session_uses_radix_and_segmented_merge():
    RADIX_KERNEL_CALLS = P.m("core.shuffle").RADIX_KERNEL_CALLS
    before = RADIX_KERNEL_CALLS["count"]
    sess = _mk(pde_config=P.m("core.pde").PDEConfig(segment_force_kernels=True,
                                    reduce_force_compiled=True))
    ref = _mk()
    q = "SELECT ds, SUM(v) AS s FROM t JOIN d ON t.k = d.dk GROUP BY ds"
    got, want = sess.sql_np(q), ref.sql_np(q)
    og, ow = np.argsort(got["ds"]), np.argsort(want["ds"])
    assert np.asarray(got["ds"])[og].tolist() == \
        np.asarray(want["ds"])[ow].tolist()
    np.testing.assert_allclose(np.asarray(got["s"])[og],
                               np.asarray(want["s"])[ow], rtol=1e-9)
    assert RADIX_KERNEL_CALLS["count"] > before
    routes = sess.metrics().segment_routes()
    assert routes.get("segmented_merge", 0) > 0, routes
    sess.shutdown()
    ref.shutdown()
    # the radix counter is process-wide: its value depends on earlier tests
    return observed(locals(), skip=("RADIX_KERNEL_CALLS", "before"))


@pytest.mark.kernels_interpret
def test_forced_kernel_session_uses_radix_and_segmented_merge():
    twin(_forced_kernel_session_uses_radix_and_segmented_merge)


