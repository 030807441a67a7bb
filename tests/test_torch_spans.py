"""The program's spans (`repro_torch/spans.py`) on the CPU, on a tiny
Mamba2: without a profiler a span records nothing and changes no output;
under `torch.profiler` the training step, the batch draw and the serving
engine record their phases once each, in order and disjoint, and the
backward's operations start inside `train.backward`."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.core import SharkSession
from repro_torch.data import TokenPipeline, pipeline
from repro_torch.data.pipeline import synthetic_corpus
from repro_torch.models import lm
from repro_torch.serving import ServeEngine, engine
from repro_torch.training import (AdamWConfig, init_opt_state,
                                  make_train_step, train_step)

CFG = get_config("mamba2-370m-smoke")
B, S = 2, 32
TRAIN = ["repro_torch.data.batch", "repro_torch.train.forward",
         "repro_torch.train.backward", "repro_torch.train.optimizer"]


@pytest.fixture(scope="module")
def pipe():
    sess = SharkSession(device="cpu")
    synthetic_corpus(sess, "corpus", CFG.vocab, n_docs=8, mean_doc_len=64,
                     num_partitions=2)
    yield TokenPipeline(sess, "corpus", S, B, seed=3)
    sess.shutdown()


def _model():
    return lm.build_model(CFG, "cpu", torch.Generator().manual_seed(0))


def _train(pipe, microbatches=1):
    """One training step from fixed weights on `pipe`'s batch 0: the
    metrics, the parameters and the optimizer state."""
    model = _model()
    opt = init_opt_state(dict(model.named_parameters()))
    step = make_train_step(CFG, AdamWConfig(), microbatches)
    batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(0).items()}
    model, opt, m = step(model, opt, batch)
    return m, dict(model.named_parameters()), opt


def _serve(n_new=2):
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, CFG.vocab, (B, 16)).astype(np.int32)
    return ServeEngine(CFG, _model(), max_seq=64).generate(prompts, n_new)


@contextlib.contextmanager
def _no_spans():
    """The program as it was without spans: each site's span a no-op."""
    mods = (pipeline, engine, train_step)
    saved = [m.span for m in mods]
    for m in mods:
        m.span = lambda name: contextlib.nullcontext()
    try:
        yield
    finally:
        for m, s in zip(mods, saved):
            m.span = s


def _profiled(fn):
    """(fn's result, the profiler's CPU events as (name, start, end))."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()]
    return out, events


def _spans(events):
    return sorted((s, e, n) for n, s, e in events
                  if n.startswith(spans.PREFIX))


def _flat(train_out):
    m, params, opt = train_out
    return ([m["loss"], m["grad_norm"], m["lr_scale"]]
            + list(params.values())
            + [t for k in ("master", "mu", "nu") for t in opt[k].values()]
            + [opt["step"]])


def test_span_without_a_profiler_records_nothing(monkeypatch, pipe):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with spans.span("train.forward"):
        pass
    _train(pipe)
    _serve()


def test_span_under_a_profiler_is_named_with_the_prefix():
    def mark():
        with spans.span("a.b"):
            pass
    _, events = _profiled(mark)
    assert "repro_torch.a.b" in [n for n, _, _ in events]


@pytest.mark.parametrize("traced", [False, True], ids=["off", "profiled"])
def test_spans_change_no_output(pipe, traced):
    with _no_spans():
        before_train, before_served = _train(pipe), _serve()
    run = (lambda f: _profiled(f)[0]) if traced else (lambda f: f())
    after_train = run(lambda: _train(pipe))
    after_served = run(_serve)
    for a, b in zip(_flat(before_train), _flat(after_train)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert np.array_equal(before_served, after_served)


def test_training_step_records_each_phase_once(pipe):
    _, events = _profiled(lambda: _train(pipe))
    got = _spans(events)
    assert [n for _, _, n in got] == TRAIN
    for (_, end, _), (start, _, _) in zip(got, got[1:]):
        assert end <= start


def test_microbatches_record_a_forward_and_backward_each(pipe):
    _, events = _profiled(lambda: _train(pipe, microbatches=2))
    assert [n for _, _, n in _spans(events)] == (
        TRAIN[:1] + TRAIN[1:3] * 2 + TRAIN[3:])


def test_generate_records_prefill_decodes_and_copy():
    served, events = _profiled(lambda: _serve(2))
    assert served.shape == (B, 2)
    got = _spans(events)
    assert [n for _, _, n in got] == [
        "repro_torch.serve.prefill", "repro_torch.serve.decode",
        "repro_torch.serve.decode", "repro_torch.serve.to_host"]
    for (_, end, _), (start, _, _) in zip(got, got[1:]):
        assert end <= start


def test_backward_operations_start_inside_the_backward(pipe):
    _, events = _profiled(lambda: _train(pipe))
    (s, e), = [(s, e) for s, e, n in _spans(events)
               if n == "repro_torch.train.backward"]
    grads = [t for n, t, _ in events
             if n.startswith("autograd::engine::evaluate_function")]
    assert grads and all(s <= t <= e for t in grads)
