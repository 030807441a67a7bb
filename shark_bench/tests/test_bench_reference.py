"""The plain reference against the program at smoke sizes on the CPU, in
float32: the forward's logits, the loss and every gradient, one AdamW
update, and the pipeline's batches against their plain form; and the
weights drawn from the seed, again a chunk at a time."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import BENCH, smoke_config, smoke_traffic
from shark_bench import corpus, port, weights
from shark_bench.reference import adamw as ref_adamw
from shark_bench.reference import lm as ref_lm
from shark_bench.spec import load_spec

CONFIGS = ["qwen", "mamba"]


def spec_of(tmp_path, name):
    p = tmp_path / f"{name}.json"
    p.write_text(json.dumps(smoke_config(name)))
    return load_spec(p)


def f32_model(spec, seed):
    m = port.model(spec, seed, "cpu").float()
    return port.model_config(spec), m


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_program(tmp_path, name):
    from repro_torch.models import lm
    spec = spec_of(tmp_path, name)
    cfg, m = f32_model(spec, 3)
    toks = torch.randint(0, spec.vocab, (2, 96), generator=torch.Generator()
                         .manual_seed(0))
    want, _ = lm.prefill_fn(cfg, m, {"tokens": toks}, max_seq=97)
    P = weights.draw_all(spec, 3, "cpu", torch.float32)
    got = ref_lm.last_logits(spec, P, toks)
    np.testing.assert_allclose(got.numpy(), want[:, 0].numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_gradients_match_program(tmp_path, name):
    from repro_torch.models import lm
    spec = spec_of(tmp_path, name)
    cfg, m = f32_model(spec, 5)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, spec.vocab, (2, 64), generator=g)
             for k in ("tokens", "labels")}
    params = dict(m.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    want = lm.loss_fn(cfg, m, batch)
    want_g = torch.autograd.grad(want, list(params.values()))
    P = {n: v.requires_grad_(True) for n, v in
         weights.draw_all(spec, 5, "cpu", torch.float32).items()}
    got = ref_lm.loss(spec, P, batch["tokens"], batch["labels"])
    got_g = dict(zip(P, torch.autograd.grad(got, list(P.values()))))
    assert abs(float(got.detach()) - float(want.detach())) \
        < 1e-5 * abs(float(want.detach()))
    for n, w in zip(params, want_g):
        scale = float(w.abs().max()) + 1e-12
        assert float((got_g[n] - w).abs().max()) < 1e-4 * scale, n


def test_adamw_matches_program():
    from repro_torch.training import AdamWConfig, adamw_update, init_opt_state
    opt = json.loads((BENCH / "traffic/train-4x2k.json").read_text())[
        "optimizer"]
    g = torch.Generator().manual_seed(2)
    w = {"a": torch.randn(32, 8, generator=g), "b": torch.randn(5, generator=g)}
    state = init_opt_state({n: v.clone() for n, v in w.items()})
    prog = {n: v.clone() for n, v in w.items()}
    ref = {n: v.clone() for n, v in w.items()}
    ref_opt = ref_adamw.AdamW(ref, opt)
    from repro_torch.training.schedule import warmup_cosine
    for _ in range(3):
        grads = {n: torch.randn(v.shape, generator=g) * 3 for n, v in w.items()}
        adamw_update(AdamWConfig(**{k: opt[k] for k in (
            "lr", "b1", "b2", "eps", "weight_decay", "grad_clip")}),
            grads, prog, state, warmup_cosine(state["step"] + 1))
        ref_opt.step(ref, grads)
    for n in w:
        torch.testing.assert_close(state["master"][n], ref[n], rtol=1e-6,
                                   atol=1e-7)


def test_pipeline_batches_match_plain_form():
    t = smoke_traffic("train")
    c = t["corpus"]
    cols = corpus.draw(256, c["n_docs"], c["mean_doc_len"], seed=2 ** 31 + 5)
    sess, pipe = port.pipeline(cols, c["partitions"],
                               f"quality > {c['min_quality']}", t["seq"],
                               t["batch"], 2 ** 31 + 5, "cpu")
    try:
        stream = corpus.plain_stream(cols, c["min_quality"])
        assert np.array_equal(pipe.stream, stream)
        for step in range(3):
            want = corpus.plain_batch(stream, t["seq"], t["batch"],
                                      2 ** 31 + 5, step)
            got = pipe.batch_at(step)
            for k in want:
                assert np.array_equal(got[k], want[k])
    finally:
        sess.shutdown()


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_redraw_by_chunk(tmp_path, name, monkeypatch):
    spec = spec_of(tmp_path, name)
    monkeypatch.setattr(weights, "CHUNK", 5000)      # several chunks
    assert len(weights.chunks(spec)) > 2
    a = weights.draw_all(spec, 9, "cpu")
    b = weights.per_leaf(spec, 9, "cpu", lambda leaf, v: v.clone())
    c = weights.draw_all(spec, 10, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["embed.tok"], c["embed.tok"])
    m = port.model(spec, 9, "cpu")
    assert all(torch.equal(p, a[n]) for n, p in m.named_parameters())
    with pytest.raises(ValueError):
        weights.load(spec, 9, {n: p for n, p in m.named_parameters()
                               if n != "embed.tok"})
