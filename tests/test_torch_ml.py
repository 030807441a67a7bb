"""The analytics tier of the torch port against the JAX reference.

Twins of tests/test_ml_compiled.py on `SharkSession(device="cpu")`, where
the port decodes feature blocks and runs its kernels' plain versions, and
fits compared across the two packages.  The state the packages share is
data made from a seed with numpy (the same arrays are loaded into both
sessions) and the estimators' initial weights and centroids, which both
draw from `np.random.default_rng(seed)`: no conversion function is needed
beyond passing those numpy arrays to both.

Tolerances: the port's encoded and materialized paths agree bitwise under
float64 (the decodes are exact integer or gather operations, so the
products see identical operands), as in the reference; the fitted weights
and centroids of the two packages agree to rtol 1e-9 under float64
features (both accumulate in float64, in different orders, and the
float32 parameters round the same way); the kernel route matches the numpy
route to rtol 5e-4 under float32 features, as the reference's twin.
"""

import numpy as np
import pytest
import torch

from repro.core import DType as JDType
from repro.core import Schema as JSchema
from repro.core import SharkSession as JaxSession
from repro.ml import KMeans as JKMeans
from repro.ml import LinearRegression as JLinearRegression
from repro.ml import LogisticRegression as JLogisticRegression
from repro_torch.core import DType, Schema, SharkSession
from repro_torch.core.expr import DECODE_COUNTERS, torch_dtype
from repro_torch.core.pde import PDEConfig, decide_train_backend
from repro_torch.kernels import ops
from repro_torch.ml import (FeatureRDD, IterativeTrainer, KMeans,
                            LinearRegression, LogisticRegression,
                            table_rdd_to_features)

D = 5
ROWS = 4000


def _int_points(rows=ROWS):
    """Small-range int64 columns: the load task BITPACK-encodes them, so
    the encoded pipeline has real block recipes to decode."""
    rng = np.random.default_rng(7)
    w = rng.normal(size=D)
    raw = rng.integers(0, 16, size=(rows, D)).astype(np.int64)
    cols = {f"f{i}": raw[:, i] + 500 for i in range(D)}
    cols["label"] = ((raw - 8) @ w > 0).astype(np.int64)
    return cols


def _int_points_session(rows=ROWS, parts=4):
    cols = _int_points(rows)
    sess = SharkSession(num_workers=2, max_threads=2, device="cpu")
    sess.create_table("pts", Schema.of(
        **{f"f{i}": DType.INT64 for i in range(D)}, label=DType.INT64),
        cols, num_partitions=parts)
    return sess, cols


def _feats(sess, map_rows=None, dtype=np.float32):
    frame = sess.sql("SELECT * FROM pts", lazy=True)
    return table_rdd_to_features(frame, [f"f{i}" for i in range(D)], "label",
                                 map_rows=map_rows, dtype=dtype)


def test_encoded_partitions_stay_encoded_and_labels_keep_dtype():
    sess, _ = _int_points_session()
    feats = _feats(sess)
    assert isinstance(feats, FeatureRDD)
    batches = feats.collect()
    for b in batches:
        assert np.asarray(b.col("label").arr).dtype == np.int64
        # block-backed pass-through: the feature column still has its block
        assert b.col("f0").block is not None
    # legacy dense layout (map_rows) also preserves the label dtype
    dense = _feats(sess, map_rows=lambda x: x).collect()
    for b in dense:
        assert np.asarray(b.col("label").arr).dtype == np.int64
        assert b.col("features").arr.dtype == np.float32
    sess.shutdown()


def test_differential_parity_encoded_vs_materialized_f64():
    """Per-iteration gradients and final weights bit-identical between the
    encoded (device decode) and materialized (decode_np + stack) paths
    under float64."""
    sess, _ = _int_points_session()
    enc = _feats(sess, dtype=np.float64)
    mat = _feats(sess, map_rows=lambda x: x, dtype=np.float64)
    enc.cache()
    mat.cache()
    t_enc = IterativeTrainer(enc, "parity-enc", dtype=np.float64)
    t_mat = IterativeTrainer(mat, "parity-mat", dtype=np.float64)
    w = np.zeros(D, np.float64)
    for i in range(4):
        g_enc, n_enc = t_enc.gradient_iteration(w, "logistic")
        g_mat, n_mat = t_mat.gradient_iteration(w, "logistic")
        assert n_enc == n_mat == ROWS
        assert np.array_equal(g_enc, g_mat), (i, g_enc - g_mat)
        w = w - 0.5 * g_enc / ROWS
    sess.shutdown()


def test_encoded_training_never_decodes_host_side():
    sess, _ = _int_points_session()
    feats = _feats(sess)
    feats.cache()
    clf = LogisticRegression(dims=D, lr=0.5, iterations=2)
    clf.fit(feats)                       # materializes the cache
    before = dict(DECODE_COUNTERS)
    clf.fit(feats)
    clf.fit(feats)
    delta = {k: DECODE_COUNTERS[k] - before[k] for k in before}
    assert delta["numeric_blocks"] == 0 and delta["numeric_rows"] == 0, delta
    sess.shutdown()


def test_train_iterations_recorded_with_routes():
    sess, _ = _int_points_session()
    feats = _feats(sess)
    feats.cache()
    clf = LogisticRegression(dims=D, lr=0.5, iterations=3).fit(feats)
    m = clf.metrics
    assert m is not None
    train_segs = [s for s in m.segments if s.consumer == "train"]
    assert len(train_segs) == 3                     # one record per iteration
    for seg in train_segs:
        assert seg.table == "<train:logreg>"
        assert sum(seg.routes.values()) == 4        # one route per partition
        assert seg.rows_in == ROWS
    assert len(m.train_iterations) == 3
    for it in m.train_iterations:
        assert it["rows"] == ROWS and it["routes"]
    # kmeans records its own segment + objective must improve
    km = KMeans(k=3, dims=D, iterations=4).fit(feats)
    assert km.objective_history[-1] < km.objective_history[0]
    assert len(km.metrics.train_iterations) == 4
    sess.shutdown()


def test_decide_train_backend_routing():
    cfg = PDEConfig()
    assert decide_train_backend(10, D, on_gpu=False, cfg=cfg).route == "numpy"
    assert decide_train_backend(
        10_000, D, on_gpu=False, cfg=cfg).route == "jit"
    assert decide_train_backend(
        10_000, D, kernel_eligible="train_grad", on_gpu=True,
        cfg=cfg).route == "train_grad"
    forced = PDEConfig(segment_force_kernels=True)
    assert decide_train_backend(
        10_000, D, kernel_eligible="train_grad", on_gpu=False,
        cfg=forced).route == "train_grad"
    # below the kernel threshold the fused step still wins
    assert decide_train_backend(
        1000, D, kernel_eligible="train_grad", on_gpu=True,
        cfg=cfg).route == "jit"


def test_train_grad_kernel_route_parity():
    """Forced kernels: the gradient runs through the train_grad route (its
    plain version on the CPU) and matches the numpy-oracle route."""
    sess, _ = _int_points_session()
    cfg = PDEConfig(segment_force_kernels=True, segment_kernel_min_rows=256)
    feats = _feats(sess)
    feats.cache()
    tr_k = IterativeTrainer(feats, "kernel", cfg=cfg)
    tr_n = IterativeTrainer(feats, "oracle",
                            cfg=PDEConfig(segment_min_compiled_rows=10**9))
    w = np.zeros(D, np.float32)
    g_k, n_k = tr_k.gradient_iteration(w, "logistic")
    g_n, n_n = tr_n.gradient_iteration(w, "logistic")
    assert n_k == n_n == ROWS
    assert tr_k.metrics.segments[0].routes.get("train_grad", 0) > 0, \
        tr_k.metrics.segments[0].routes
    assert tr_n.metrics.segments[0].routes.get("numpy", 0) > 0
    np.testing.assert_allclose(g_k, g_n, rtol=5e-4, atol=5e-4)
    sess.shutdown()


def test_chaos_worker_killed_mid_iteration_model_identical():
    """Kill a worker between an iteration's map stage and its fetch: the
    shuffle outputs AND that worker's cached feature blocks vanish, the
    trainer recovers from lineage, and the final model is bitwise equal to
    the failure-free run."""
    def run(chaos: bool) -> np.ndarray:
        sess, _ = _int_points_session()
        sched = sess.ctx.scheduler
        if chaos:
            orig = sched.run_map_stage
            state = {"i": 0}

            def chaotic(dep):
                stats = orig(dep)
                state["i"] += 1
                if state["i"] == 2:      # mid-training: after iteration 2's
                    w = sorted(sched.alive)[0]   # map stage, before fetch
                    sched.kill_worker(w)
                    sched.add_worker()
                return stats

            sched.run_map_stage = chaotic
        feats = _feats(sess)
        feats.cache()
        clf = LogisticRegression(dims=D, lr=0.5, iterations=5).fit(feats)
        sess.shutdown()
        return clf.w

    w_chaos = run(chaos=True)
    w_clean = run(chaos=False)
    assert np.array_equal(w_chaos, w_clean)


def test_string_feature_column_rejected():
    sess = SharkSession(num_workers=2, device="cpu")
    sess.create_table("t", Schema.of(s=DType.STRING, y=DType.INT64),
                      {"s": np.array(["a", "b"] * 50),
                       "y": np.arange(100, dtype=np.int64)})
    feats = table_rdd_to_features(sess.sql("SELECT * FROM t", lazy=True),
                                  ["s"], "y")
    with pytest.raises(Exception, match="string column"):
        feats.collect()
    sess.shutdown()


# -- the two packages on the same table ---------------------------------


def _mixed_points(rows=18000):
    """One column per load-time encoding: BITPACK (small-range ints), DICT
    (floats on a cent grid), RLE (runs of 6), PLAIN (continuous floats,
    more than 4096 distinct values a partition), plus an int64 label."""
    rng = np.random.default_rng(11)
    cols = {
        "b0": rng.integers(0, 9, rows).astype(np.int64),
        "b1": rng.integers(-3, 4, rows).astype(np.int32),
        "d0": np.round(rng.integers(0, 300, rows) * 0.01, 2),
        "r0": np.repeat(rng.normal(size=rows // 6 + 1), 6)[:rows],
        "p0": rng.normal(size=rows),
    }
    z = (cols["b0"] - 4) * 0.3 + cols["d0"] - 1.5 + cols["r0"] - cols["p0"]
    cols["label"] = (z + rng.normal(scale=0.5, size=rows) > 0).astype(
        np.int64)
    schema = dict(b0="INT64", b1="INT32", d0="FLOAT64", r0="FLOAT64",
                  p0="FLOAT64", label="INT64")
    return cols, schema


FEATURES = ["b0", "b1", "d0", "r0", "p0"]


def _both_sessions(parts=4):
    cols, schema = _mixed_points()
    js = JaxSession(num_workers=2, max_threads=2)
    js.create_table("pts", JSchema.of(
        **{k: getattr(JDType, v) for k, v in schema.items()}), cols,
        num_partitions=parts)
    ts = SharkSession(num_workers=2, max_threads=2, device="cpu")
    ts.create_table("pts", Schema.of(
        **{k: getattr(DType, v) for k, v in schema.items()}), cols,
        num_partitions=parts)
    return js, ts


def test_mixed_table_covers_every_feature_encoding():
    _, ts = _both_sessions()
    encs = {c: {p.columns[c].encoding.value
                for p in ts.catalog.get("pts").partitions}
            for c in FEATURES + ["label"]}
    assert encs == {"b0": {"bitpack"}, "b1": {"bitpack"}, "d0": {"dict"},
                    "r0": {"rle"}, "p0": {"plain"}, "label": {"bitpack"}}
    ts.shutdown()


@pytest.mark.parametrize("est", ["logistic", "linear", "kmeans"])
@pytest.mark.parametrize("force", [False, True])
def test_fit_matches_reference(est, force):
    """The same table through both packages' estimators: float64 features,
    fitted parameters to rtol 1e-9.  `force` sends the port's partitions
    down the train_grad route (its plain version on the CPU)."""
    js, ts = _both_sessions()
    if force:
        ts.executor.pde = PDEConfig(segment_force_kernels=True,
                                    segment_kernel_min_rows=256)
    make = {"logistic": (JLogisticRegression, LogisticRegression,
                         dict(dims=5, lr=0.2, iterations=4), "w"),
            "linear": (JLinearRegression, LinearRegression,
                       dict(dims=5, lr=0.02, iterations=4), "w"),
            "kmeans": (JKMeans, KMeans, dict(k=4, dims=5, iterations=4),
                       "centroids")}[est]
    jcls, tcls, kw, attr = make
    want = jcls(**kw).fit(js.table("pts"), FEATURES, "label",
                          dtype=np.float64)
    got = tcls(**kw)
    if force:
        # the estimator builds its trainer with the default PDEConfig, so
        # the forced route is driven through the trainer directly
        feats = ts.table("pts").to_features(FEATURES, "label",
                                            dtype=np.float64)
        feats.cache()
        tr = IterativeTrainer(feats, "forced", cfg=ts.executor.pde,
                              dtype=np.float64)
        for _ in range(kw["iterations"]):
            if est == "kmeans":
                sums, counts, _ = tr.kmeans_iteration(got.centroids)
                nz = counts > 0
                got.centroids = got.centroids.copy()
                got.centroids[nz] = (sums[nz] / counts[nz, None]).astype(
                    np.float32)
            else:
                g, n = tr.gradient_iteration(
                    got.w, "logistic" if est == "logistic" else "linear")
                got.w = got.w - got.lr * (g / max(n, 1)).astype(got.w.dtype)
        routes = tr.metrics.segment_routes()
        assert routes.get("train_grad" if est != "kmeans" else "jit", 0) > 0
    else:
        got.fit(ts.table("pts"), FEATURES, "label", dtype=np.float64)
    np.testing.assert_allclose(getattr(got, attr), getattr(want, attr),
                               rtol=1e-9, atol=1e-12)
    if est == "kmeans" and not force:
        np.testing.assert_allclose(got.objective_history,
                                   want.objective_history, rtol=1e-9)
    js.shutdown()
    ts.shutdown()


def test_predict_and_loss_match_reference():
    js, ts = _both_sessions()
    jl = JLogisticRegression(dims=5, iterations=3).fit(
        js.table("pts"), FEATURES, "label")
    tl = LogisticRegression(dims=5, iterations=3).fit(
        ts.table("pts"), FEATURES, "label")
    np.testing.assert_allclose(tl.w, jl.w, rtol=1e-5, atol=1e-7)
    x = np.random.default_rng(5).normal(size=(50, 5))
    tl.w = jl.w.copy()
    np.testing.assert_allclose(tl.predict_proba(x, device="cpu"),
                               jl.predict_proba(x), rtol=1e-6)
    np.testing.assert_array_equal(tl.predict(x, device="cpu"),
                                  jl.predict(x))
    got = tl.predict_proba(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor) and got.shape == (50,)
    np.testing.assert_allclose(
        tl.loss(ts.table("pts"), FEATURES, "label"),
        jl.loss(js.table("pts"), FEATURES, "label"), rtol=1e-6)
    km_j = JKMeans(k=3, dims=5, iterations=2).fit(js.table("pts"), FEATURES,
                                                  "label")
    km_t = KMeans(k=3, dims=5, iterations=2)
    km_t.centroids = km_j.centroids.copy()
    np.testing.assert_array_equal(km_t.predict(x, device="cpu"),
                                  km_j.predict(x))
    lr_t = LinearRegression(dims=5)
    lr_t.w = np.arange(5, dtype=np.float32)
    lr_j = JLinearRegression(dims=5)
    lr_j.w = lr_t.w.copy()
    # the reference computes x @ w in float32 (JAX's x64 mode is off
    # outside its engine), the port in float64: float32 rounding apart
    np.testing.assert_allclose(lr_t.predict(x, device="cpu"),
                               lr_j.predict(x), rtol=1e-5, atol=1e-6)
    js.shutdown()
    ts.shutdown()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_assembled_features_match_reference(dtype):
    """fused_train_step("assemble") of every partition of the mixed table
    (BITPACK int64 and int32 columns, the int32 one with a negative bias,
    DICT, RLE, PLAIN and a BITPACK int64 label): the port's (x, y), its
    BITPACK columns written by one batched decode, equal the reference's
    exactly."""
    from repro.core.expr import _x64
    from repro.ml import featurize as jfz
    from repro_torch.ml import featurize as tfz
    js, ts = _both_sessions()
    jparts = js.table("pts").to_features(FEATURES, "label",
                                         dtype=dtype).collect()
    tparts = ts.table("pts").to_features(FEATURES, "label",
                                         dtype=dtype).collect()
    assert len(jparts) == len(tparts) == 4
    biases = set()
    for jb, tb in zip(jparts, tparts):
        sigs, args, lsig, largs = jfz.partition_recipes(jb, FEATURES, "label")
        with _x64():
            jx, jy = jfz.fused_train_step("assemble", sigs, lsig, dtype)(
                np.zeros(5, dtype), args, largs)
        sigs, args, lsig, largs = tfz.partition_recipes(tb, FEATURES, "label",
                                                        "cpu")
        assert [s[0] for s in sigs] == ["bitpack", "bitpack", "dict", "rle",
                                        "plain"] and lsig[0] == "bitpack"
        biases.add(int(args[1][0].bias))
        tx, ty = tfz.fused_train_step("assemble", sigs, lsig, dtype)(
            torch.zeros(5), args, largs)
        assert tx.dtype == ty.dtype == torch_dtype(dtype)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert min(biases) < 0
    js.shutdown()
    ts.shutdown()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_assembled_rle_columns_and_label_match_reference(dtype):
    """RLE blocks of int32 and float32 features and of an int64 label,
    each written straight into its column of x (or into y) by
    `rle_decode_into`: the port's (x, y) equal the reference's exactly."""
    from repro.core.expr import _x64
    from repro.ml import featurize as jfz
    from repro_torch.ml import featurize as tfz
    rng = np.random.default_rng(3)
    rows = 6000
    cols = {
        "ri": np.repeat(rng.integers(-10 ** 6, 10 ** 6, rows // 20 + 1),
                        20)[:rows].astype(np.int32),
        "rf": np.repeat(rng.normal(size=rows // 7 + 1), 7)[:rows].astype(
            np.float32),
        "p0": rng.normal(size=rows),
        "label": np.repeat(rng.integers(-10 ** 9, 10 ** 9, rows // 30 + 1),
                           30)[:rows].astype(np.int64)}
    schema = dict(ri="INT32", rf="FLOAT32", p0="FLOAT64", label="INT64")
    js = JaxSession(num_workers=2, max_threads=2)
    js.create_table("t", JSchema.of(
        **{k: getattr(JDType, v) for k, v in schema.items()}), cols,
        num_partitions=3)
    ts = SharkSession(num_workers=2, max_threads=2, device="cpu")
    ts.create_table("t", Schema.of(
        **{k: getattr(DType, v) for k, v in schema.items()}), cols,
        num_partitions=3)
    feats = ["ri", "rf", "p0"]
    jparts = js.table("t").to_features(feats, "label", dtype=dtype).collect()
    tparts = ts.table("t").to_features(feats, "label", dtype=dtype).collect()
    for jb, tb in zip(jparts, tparts):
        sigs, args, lsig, largs = jfz.partition_recipes(jb, feats, "label")
        with _x64():
            jx, jy = jfz.fused_train_step("assemble", sigs, lsig, dtype)(
                np.zeros(3, dtype), args, largs)
        sigs, args, lsig, largs = tfz.partition_recipes(tb, feats, "label",
                                                        "cpu")
        assert [s[0] for s in sigs[:2]] == ["rle", "rle"]
        assert lsig[0] == "rle"
        tx, ty = tfz.fused_train_step("assemble", sigs, lsig, dtype)(
            torch.zeros(3), args, largs)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    js.shutdown()
    ts.shutdown()


def test_cpu_session_trains_with_cpu_routes_and_no_launch():
    """A device="cpu" session trains on the CPU: the CPU rules pick the
    routes (jit at these sizes, not train_grad) and no kernel launches."""
    ops.reset_launch_counts()
    _, ts = _both_sessions()
    clf = LogisticRegression(dims=5, iterations=2).fit(
        ts.table("pts"), FEATURES, "label")
    routes = clf.metrics.segment_routes()
    assert routes == {"jit": 8}, routes
    assert set(ops.launch_counts().values()) == {0}
    ts.shutdown()
