"""Each cell rehearsed end to end at smoke sizes on the CPU, on the
kernels' plain routes: set-up, the window, the traced window, the metrics,
and the comparison with the reference; and a planted fault in the timed
path that the comparison must catch, for each fault a cell can have."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from conftest import smoke_run

TRAIN = ["qwen2.5-3b.train-4x2k-smoke", "mamba2-370m.train-16x2k-smoke"]
PREFILL = ["qwen2.5-3b.prefill-mix-smoke", "mamba2-370m.prefill-mix-smoke"]


@pytest.mark.parametrize("cell", TRAIN + PREFILL)
def test_cell_rehearsal(smoke_root, cell):
    out = smoke_run(smoke_root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {"setup_s"} | ({"train_tokens_per_s"} if cell in TRAIN
                          else {"prefill_tokens_per_s", "ttft_p95_ms"})
    assert set(out["metrics"]) == want
    assert all(m["value"] > 0 for m in out["metrics"].values())


@pytest.mark.parametrize("cell", [TRAIN[0], PREFILL[1]])
def test_traced_rehearsal(smoke_root, cell):
    """On the CPU no device operation is traced: the device readers return
    nothing, the host-clock ones their values."""
    out = smoke_run(smoke_root, cell, traced=True)
    assert out["correct"], out["checks"]
    host = {"batch_ms.train", "mfu.train"} if cell in TRAIN \
        else {"mfu.prefill"}
    assert set(out["metrics"]) == host
    assert out["busy_s"] == 0.0


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def _unchanged_state():
    """The optimizer step returns its state unchanged."""
    from repro_torch.training import train_step

    def adamw_update(cfg, grads, params, opt_state, lr_scale=1.0):
        return params, opt_state, torch.zeros(())
    return patched(train_step, "adamw_update", adamw_update)


def _half_batch_loss():
    """The loss of half of the batch, the mean over the rest."""
    from repro_torch.models import lm
    loss_fn = lm.loss_fn

    def half(cfg, model, batch):
        b = batch["tokens"].shape[0]
        return loss_fn(cfg, model, {k: v[:b // 2] for k, v in batch.items()})
    return patched(lm, "loss_fn", half)


def _half_batch_prefill():
    """The prefill computes the first half of the batch and repeats it."""
    from repro_torch.models import lm
    prefill_fn = lm.prefill_fn

    def half(cfg, model, batch, max_seq):
        b = batch["tokens"].shape[0]
        keep = max(b // 2, 1)
        logits, caches = prefill_fn(
            cfg, model, {k: v[:keep] for k, v in batch.items()}, max_seq)
        idx = torch.arange(b, device=logits.device) % keep
        return logits[idx], {k: v[:, idx] for k, v in caches.items()}
    return patched(lm, "prefill_fn", half)


def _altered_token():
    """Each served token is altered where the engine produces it."""
    from repro_torch.serving import engine
    generate = engine.ServeEngine.generate

    def altered(self, prompt_tokens, max_new_tokens, extra=None):
        out = generate(self, prompt_tokens, max_new_tokens, extra)
        out[:, 0] = (out[:, 0] + 1) % self.cfg.vocab
        return out
    return patched(engine.ServeEngine, "generate", altered)


FAULTS = [(TRAIN[0], _unchanged_state), (TRAIN[1], _unchanged_state),
          (TRAIN[0], _half_batch_loss), (TRAIN[1], _half_batch_loss),
          (PREFILL[0], _half_batch_prefill), (PREFILL[1], _half_batch_prefill),
          (PREFILL[0], _altered_token), (PREFILL[1], _altered_token)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(smoke_root, cell, fault):
    with fault():
        out = smoke_run(smoke_root, cell, seed=11)
    assert not out["correct"], out["checks"]


def test_same_seed_same_inputs():
    from shark_bench import corpus
    from shark_bench.kinds import prefill as gen
    a = corpus.draw(256, 5, 64, seed=2 ** 31 + 11)
    b = corpus.draw(256, 5, 64, seed=2 ** 31 + 11)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    t = {"classes": [[4, 32], [2, 64], [1, 128]]}
    assert np.array_equal(gen.prompts(t, 2 ** 31 + 11, 5, 256),
                          gen.prompts(t, 2 ** 31 + 11, 5, 256))
    # every cycle holds each class once
    shapes = [gen.shape(t, 99, j) for j in range(6)]
    assert sorted(shapes[:3]) == sorted(shapes[3:]) == sorted(
        tuple(c) for c in t["classes"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [TRAIN[0], PREFILL[1]])
def test_cell_on_the_card(smoke_root, cell):
    """The smoke cells through the kernels on the card (run on a GPU host:
    `python -m pytest -m cuda shark_bench/tests`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = smoke_run(smoke_root, cell, device="cuda:0", traced=True)
    assert out["correct"], out["checks"]
    assert out["busy_s"] > 0
