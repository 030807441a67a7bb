"""The paper's Listing 1 on the torch port against the JAX reference: the
twin of tests/test_system.py's `test_paper_listing1_workflow` (sql2rdd ->
feature extraction -> logistic regression, all in one lineage graph,
surviving a worker failure).

The body runs on both packages (`torch_twin.twin`; the port's session on
`device="cpu"`).  The fitted weights must equal the reference's to rtol
1e-4 (both train in float32 and sum their gradients in another order; the
reference test's own bar, accuracy above 0.9, is looser), and so must the
predictions.  The port's model was fitted on a CPU session, so `predict`
runs on the CPU with no `device=`.  `test_serving_greedy_deterministic`
is the twin of the reference file's serving test: two engines over the
same yi-9b-smoke weights (the reference's, carried over by
`models/convert.params_from_jax`) give the same greedy tokens, and
`test_serving_greedy_deterministic_moe` the same for an MoE arch.  The
reference file's LM-training test waits for the port's training substrate
(ROADMAP A.5) and its XLA dry-run test gets no twin.
"""

import numpy as np
import pytest

from torch_twin import P, twin


def _paper_listing1_workflow():
    LogisticRegression = P.m("ml").LogisticRegression
    table_rdd_to_features = P.m("ml").table_rdd_to_features
    rng = np.random.default_rng(0)
    n, d = 6000, 8
    w_true = rng.normal(size=d)
    X = rng.normal(size=(n, d))
    y = (X @ w_true > 0).astype(np.float32)
    sess = P.SharkSession(num_workers=4, max_threads=4)
    cols = {f"f{i}": X[:, i].astype(np.float32) for i in range(d)}
    cols["label"] = y
    sess.create_table("users", P.Schema.of(
        **{f"f{i}": P.DType.FLOAT32 for i in range(d)}, label=P.DType.FLOAT32),
        cols)
    with pytest.warns(DeprecationWarning):
        rdd, names = sess.sql2rdd("SELECT * FROM users WHERE f0 > -10")
    feats = table_rdd_to_features(rdd, [f"f{i}" for i in range(d)], "label")
    clf = LogisticRegression(dims=d, lr=0.5, iterations=5).fit(feats)
    w_before = clf.w.copy()
    sess.ctx.scheduler.kill_worker(0)      # node failure mid-workflow
    clf.iterations = 5
    clf.fit(feats)                          # lineage recomputes lost parts
    pred = clf.predict(X)
    assert (pred == y).mean() > 0.9
    sess.shutdown()
    return {"names": names, "w_before": w_before, "w": clf.w,
            "accuracy": float((pred == y).mean())}


def test_paper_listing1_workflow():
    got = twin(_paper_listing1_workflow, rtol=1e-4)
    assert got["accuracy"] > 0.9


def test_predict_follows_the_fitted_device():
    """An estimator fitted on a `device="cpu"` session predicts numpy input
    there with no `device=` (the reference's `predict` runs on any host),
    and matches the reference's `predict` on the same weights; an explicit
    `device=` still wins, and one never fitted keeps the card default."""
    from repro.ml import KMeans as JKMeans
    from repro.ml import LinearRegression as JLinearRegression
    from repro.ml import LogisticRegression as JLogisticRegression
    from repro_torch.core import DType, Schema, SharkSession
    from repro_torch.ml import KMeans, LinearRegression, LogisticRegression

    rng = np.random.default_rng(3)
    X = rng.normal(size=(500, 3)).astype(np.float32)
    y = (X @ np.array([1.0, -2.0, 0.5]) > 0).astype(np.float32)
    sess = SharkSession(num_workers=2, max_threads=2, device="cpu")
    sess.create_table("p", Schema.of(a=DType.FLOAT32, b=DType.FLOAT32,
                                     c=DType.FLOAT32, y=DType.FLOAT32),
                      {"a": X[:, 0], "b": X[:, 1], "c": X[:, 2], "y": y})
    frame = sess.table("p")
    fitted = [LogisticRegression(dims=3, iterations=3).fit(
                  frame, ["a", "b", "c"], "y"),
              LinearRegression(dims=3, iterations=3).fit(
                  frame, ["a", "b", "c"], "y"),
              KMeans(k=2, dims=3, iterations=2).fit(frame, ["a", "b", "c"])]
    refs = [JLogisticRegression(dims=3), JLinearRegression(dims=3),
            JKMeans(k=2, dims=3)]
    for model, ref in zip(fitted, refs):
        assert str(model.device) == "cpu"
        if hasattr(model, "w"):
            ref.w = model.w.copy()
        else:
            ref.centroids = model.centroids.copy()
        got = model.predict(X)
        assert isinstance(got, np.ndarray)
        if isinstance(model, LinearRegression):
            np.testing.assert_allclose(got, ref.predict(X), rtol=1e-5,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(got, ref.predict(X))
        np.testing.assert_array_equal(model.predict(X, device="cpu"), got)
    np.testing.assert_allclose(fitted[0].predict_proba(X),
                               refs[0].predict_proba(X), rtol=1e-6)
    sess.shutdown()
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LogisticRegression(dims=3).predict(X)


def test_serving_greedy_deterministic():
    import jax
    import torch
    from repro.configs import get_config as jget_config
    from repro.models import lm as jlm
    from repro_torch.configs import get_config
    from repro_torch.models import convert, lm
    from repro_torch.serving import ServeEngine
    cfg = get_config("yi-9b-smoke")
    params, _ = jlm.init_params(jget_config("yi-9b-smoke"),
                                jax.random.PRNGKey(0))
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                    lm.build_model(cfg, "cpu"))
    assert model.embed.tok.dtype == torch.bfloat16
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    out1 = ServeEngine(cfg, model, max_seq=48).generate(prompts, 8)
    out2 = ServeEngine(cfg, model, max_seq=48).generate(prompts, 8)
    assert out1.shape == (2, 8) and out1.dtype == np.int32
    np.testing.assert_array_equal(out1, out2)


def test_serving_greedy_deterministic_moe():
    """The same for the MoE family: DeepSeek-V2-Lite's smoke variant (MLA,
    a dense layer 0, routed and shared experts), the reference's bf16
    parameters carried over."""
    import jax
    import torch
    from repro.configs import get_config as jget_config
    from repro.models import lm as jlm
    from repro_torch.configs import get_config
    from repro_torch.models import convert, lm
    from repro_torch.serving import ServeEngine
    name = "deepseek-v2-lite-16b-smoke"
    cfg = get_config(name)
    params, _ = jlm.init_params(jget_config(name), jax.random.PRNGKey(0))
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                    lm.build_model(cfg, "cpu"))
    assert model.layers[0].moe.w_up.dtype == torch.bfloat16
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    out1 = ServeEngine(cfg, model, max_seq=48).generate(prompts, 8)
    out2 = ServeEngine(cfg, model, max_seq=48).generate(prompts, 8)
    assert out1.shape == (2, 8) and out1.dtype == np.int32
    np.testing.assert_array_equal(out1, out2)
