"""Twins of tests/test_training_substrate.py on the port: the optimizer's
arithmetic, the schedule, checkpoint round trips in the reference's
layout, the data pipeline's determinism, and the engine's estimators.

Each test runs the reference test's body on the port (sessions on
`device="cpu"`) and, where both packages compute the same thing, holds
the port's answer to the reference's on the same numpy inputs: AdamW and
the schedule in float32 to rel 1e-6, checkpoint files byte for byte,
pipeline batches exactly.  `test_grad_accum_equivalence` is in
tests/test_torch_train_step.py; `test_zero1_specs_add_data_axis` has no
twin: ZeRO-1's partition specs shard the optimizer state over a mesh's
`data` axis, and the port trains on one card (`training/optim.py`).
"""

import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.core import SharkSession as JSharkSession
from repro.data import TokenPipeline as JTokenPipeline
from repro.data import synthetic_corpus as jsynthetic_corpus
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import adamw_update as jadamw_update
from repro.training import init_opt_state as jinit_opt_state
from repro.training import warmup_cosine as jwarmup_cosine
from repro_torch.checkpoint import (CheckpointManager, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core import SharkSession
from repro_torch.data import TokenPipeline, synthetic_corpus
from repro_torch.training import (AdamWConfig, adamw_update, init_opt_state,
                                  warmup_cosine)


def test_adamw_matches_reference():
    """The port's AdamW against the reference test's hand-rolled numpy
    AdamW, and against the reference's `adamw_update`."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    g = rng.normal(size=(4, 3)).astype(np.float32)
    kw = dict(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.01,
              grad_clip=1e9)
    params = {"w": torch.from_numpy(w.copy())}
    opt = init_opt_state(params)
    new_p, new_opt, gnorm = adamw_update(AdamWConfig(**kw),
                                         {"w": torch.from_numpy(g)}, params,
                                         opt)
    mu = 0.1 * g
    nu = 0.01 * g * g
    mhat = mu / (1 - 0.9)
    nhat = nu / (1 - 0.99)
    ref = w - 0.1 * (mhat / (np.sqrt(nhat) + 1e-8) + 0.01 * w)
    np.testing.assert_allclose(new_p["w"].numpy(), ref, rtol=1e-5)
    np.testing.assert_allclose(float(gnorm), np.sqrt((g * g).sum()),
                               rtol=1e-5)
    jp = {"w": jnp.asarray(w)}
    jnew, jopt, jn = jadamw_update(JAdamWConfig(**kw), {"w": jnp.asarray(g)},
                                   jp, jinit_opt_state(jp))
    np.testing.assert_allclose(new_p["w"].numpy(), np.asarray(jnew["w"]),
                               rtol=1e-6)
    for key in ("master", "mu", "nu"):
        np.testing.assert_allclose(new_opt[key]["w"].numpy(),
                                   np.asarray(jopt[key]["w"]), rtol=1e-6)
    assert int(new_opt["step"]) == int(jopt["step"]) == 1
    assert new_opt["step"].dtype == torch.int32


def test_adamw_keeps_bf16_params_and_float32_state():
    """Parameters stay in their dtype (bf16), rounded from the float32
    master weights; master, mu and nu are float32; several steps equal
    the reference's to float32 rounding."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(8, 5)).astype(np.float32)
    jp = {"a": jnp.asarray(w).astype(jnp.bfloat16)}
    params = {"a": torch.from_numpy(w).bfloat16()}
    opt, jopt = init_opt_state(params), jinit_opt_state(jp)
    cfg, jcfg = AdamWConfig(lr=1e-2), JAdamWConfig(lr=1e-2)
    for i in range(3):
        g = rng.normal(size=(8, 5)).astype(np.float32) * 3
        scale = jwarmup_cosine(jnp.asarray(i + 1))
        params, opt, n = adamw_update(cfg, {"a": torch.from_numpy(g)
                                            .bfloat16()}, params, opt,
                                      warmup_cosine(i + 1))
        jp, jopt, jn = jadamw_update(jcfg, {"a": jnp.asarray(g).astype(
            jnp.bfloat16)}, jp, jopt, scale)
        assert params["a"].dtype == torch.bfloat16
        assert all(opt[k]["a"].dtype == torch.float32
                   for k in ("master", "mu", "nu"))
        np.testing.assert_allclose(opt["master"]["a"].numpy(),
                                   np.asarray(jopt["master"]["a"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(
            params["a"].float().numpy(), np.asarray(jp["a"], np.float32))
        assert float(n) == pytest.approx(float(jn), rel=1e-6)


def test_grad_clip():
    cfg = AdamWConfig(lr=0.0, grad_clip=1.0)
    params = {"w": torch.ones(2)}
    opt = init_opt_state(params)
    _, _, gnorm = adamw_update(cfg, {"w": torch.full((2,), 100.0)}, params,
                               opt)
    assert float(gnorm) > 1.0  # norm reported pre-clip


def test_warmup_cosine_shape():
    steps = (0, 100, 200, 5000, 10000)
    xs = [float(warmup_cosine(torch.tensor(s))) for s in steps]
    assert xs[0] == 0.0
    assert xs[2] == pytest.approx(1.0, abs=1e-3)
    assert xs[-1] == pytest.approx(0.1, abs=1e-3)
    want = [float(jwarmup_cosine(jnp.asarray(s))) for s in steps]
    np.testing.assert_allclose(xs, want, rtol=1e-6)
    # a python int step and an int32 tensor give the same float32
    assert float(warmup_cosine(137)) == float(
        warmup_cosine(torch.tensor(137, dtype=torch.int32)))


def test_checkpoint_roundtrip_and_gc():
    params = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
              "nested": {"b": torch.ones(4, dtype=torch.float32)}}
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2, async_save=False)
        for s in (1, 2, 3):
            mgr.save(s, params, {"note": f"s{s}"})
        assert mgr.latest_step() == 3
        steps = sorted(int(x.split("_")[1]) for x in os.listdir(d))
        assert steps == [2, 3]  # retention
        restored, manifest = mgr.restore_latest(params)
        assert manifest["note"] == "s3"
        assert restored["a"].dtype == torch.bfloat16
        for a, b in ((restored["a"], params["a"]),
                     (restored["nested"]["b"], params["nested"]["b"])):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)


def test_checkpoint_elastic_restore_without_template():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 5, {"layer": {"w": torch.ones((3, 3))}})
        nested, manifest = restore_checkpoint(d)
        assert manifest["step"] == 5
        np.testing.assert_array_equal(nested["layer"]["w"].numpy(),
                                      np.ones((3, 3)))


def test_checkpoint_files_are_the_reference_layout():
    """The same tree saved by both packages: the same directories and
    file names, the same manifest, and every .npy file byte for byte
    (bf16 as its uint16 bits, logical dtype "bfloat16"); each package
    restores the other's."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(3, 5)).astype(np.float32)
    jtree = {"p": {"w": jnp.asarray(a).astype(jnp.bfloat16),
                   "b": jnp.asarray(a[0])},
             "step": jnp.asarray(7, jnp.int32)}
    ttree = {"p": {"w": torch.from_numpy(a).bfloat16(),
                   "b": torch.from_numpy(a[0].copy())},
             "step": torch.tensor(7, dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as dj, \
            tempfile.TemporaryDirectory() as dt:
        jsave_checkpoint(dj, 7, jtree, {"pipeline": {"step": 7}})
        save_checkpoint(dt, 7, ttree, {"pipeline": {"step": 7}})
        pj, pt = (os.path.join(x, "step_00000007") for x in (dj, dt))
        assert sorted(os.listdir(pj)) == sorted(os.listdir(pt))
        with open(os.path.join(pj, "manifest.json")) as f:
            mj = f.read()
        with open(os.path.join(pt, "manifest.json")) as f:
            mt = f.read()
        assert mj == mt
        assert json.loads(mt)["leaves"]["p/w"]["dtype"] == "bfloat16"
        for name in os.listdir(pj):
            with open(os.path.join(pj, name), "rb") as f1, \
                    open(os.path.join(pt, name), "rb") as f2:
                assert f1.read() == f2.read(), name
        got, _ = restore_checkpoint(dj)
        assert got["p"]["w"].dtype == torch.bfloat16
        assert torch.equal(got["p"]["w"], ttree["p"]["w"])
        assert int(got["step"]) == 7
        want, _ = JCheckpointManager(dt).restore_latest(jtree)
        np.testing.assert_array_equal(np.asarray(want["p"]["w"], np.float32),
                                      np.asarray(jtree["p"]["w"], np.float32))


def test_checkpoint_snapshot_is_taken_at_save():
    """An asynchronous save writes the values of the call's moment, not
    those of tensors the step loop updates in place afterwards."""
    w = torch.zeros(4)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, async_save=True)
        mgr.save(1, {"w": w})
        w.add_(1.0)
        mgr.wait()
        got, _ = restore_checkpoint(d)
        assert torch.equal(got["w"], torch.zeros(4))
        assert not any(x.endswith(".tmp") for x in os.listdir(d))


def test_pipeline_determinism_and_manifest():
    sess = SharkSession(num_workers=2, max_threads=2, device="cpu")
    synthetic_corpus(sess, "c", vocab=128, n_docs=20, mean_doc_len=64)
    p1 = TokenPipeline(sess, "c", 16, 4, sql_filter="quality > 0.3", seed=9)
    p2 = TokenPipeline.from_manifest(sess, p1.manifest(123))
    for step in (0, 5, 123):
        b1, b2 = p1.batch_at(step), p2.batch_at(step)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        np.testing.assert_array_equal(b1["labels"], b2["labels"])
    # labels are next-token shifted
    b = p1.batch_at(0)
    assert b["tokens"].shape == (4, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    # the reference's pipeline over the same corpus serves the same batches
    jsess = JSharkSession(num_workers=2, max_threads=2)
    jsynthetic_corpus(jsess, "c", vocab=128, n_docs=20, mean_doc_len=64)
    jp = JTokenPipeline(jsess, "c", 16, 4, sql_filter="quality > 0.3",
                        seed=9)
    np.testing.assert_array_equal(p1.stream, jp.stream)
    assert p1.manifest(123) == jp.manifest(123)
    for step in (0, 5, 123):
        for k, v in jp.batch_at(step).items():
            np.testing.assert_array_equal(p1.batch_at(step)[k], v)
    sess.shutdown()
    jsess.shutdown()


def test_sql_filter_changes_stream():
    sess = SharkSession(num_workers=2, max_threads=2, device="cpu")
    synthetic_corpus(sess, "c", vocab=128, n_docs=40, mean_doc_len=64)
    full = TokenPipeline(sess, "c", 16, 4, sql_filter=None)
    filtered = TokenPipeline(sess, "c", 16, 4, sql_filter="quality > 0.5")
    assert len(filtered.stream) < len(full.stream)
    sess.shutdown()


def test_ml_logreg_and_kmeans():
    """The reference test's estimators on the port: a logistic regression
    and a k-means fit straight from a SQL frame over the table."""
    from repro_torch.core import DType, Schema
    from repro_torch.ml import (KMeans, LogisticRegression,
                                table_rdd_to_features)
    rng = np.random.default_rng(0)
    n, d = 4000, 6
    w_true = rng.normal(size=d)
    X = rng.normal(size=(n, d))
    y = (X @ w_true > 0).astype(np.float32)
    sess = SharkSession(num_workers=2, max_threads=2, device="cpu")
    cols = {f"f{i}": X[:, i].astype(np.float32) for i in range(d)}
    cols["label"] = y
    sess.create_table("pts", Schema.of(
        **{f"f{i}": DType.FLOAT32 for i in range(d)}, label=DType.FLOAT32),
        cols)
    frame = sess.sql("SELECT * FROM pts", lazy=True)
    feats = table_rdd_to_features(frame, [f"f{i}" for i in range(d)],
                                  "label")
    clf = LogisticRegression(dims=d, lr=0.5, iterations=12).fit(feats)
    assert (clf.predict(X) == y).mean() > 0.9
    km = KMeans(k=3, dims=d, iterations=8).fit(feats)
    assert km.objective_history[-1] < km.objective_history[0]
    sess.shutdown()
