"""Twin of tests/test_models_smoke.py's `test_smoke_forward_and_decode` for
the families the port builds: the four dense, the two MoE, the vlm and
the encdec architectures' smoke variants, with the reference's parameters
carried over by `models/convert.params_from_jax`, the reference test's
batch shape and its `make_batch` extras (bf16 `image_embeds` / `frames`
drawn N(0, 1) after the tokens and labels).

The vlm gates are drawn N(0, 1) (their zero init hides the cross
layers).  Prefill logits (B, 1, V) and finite, one decode step's logits
finite, and decode(tok | prefill(S)) equal to the full forward over S + 1
tokens to rel 0.05 (the reference test's bar, bf16 weights), and the
reference test's `loss_fn` check: finite, within 2 of log V (a random
init's cross-entropy).  The twin of its `test_smoke_train_step` is in
tests/test_torch_train_step.py.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JARCH_NAMES
from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import convert, lm

B, S, MAXS = 2, 32, 48
DENSE = [a for a in ARCH_NAMES if get_config(a).family == "dense"]
MOE = [a for a in ARCH_NAMES if get_config(a).family == "moe"]
VLM = [a for a in ARCH_NAMES if get_config(a).family == "vlm"]
ENCDEC = [a for a in ARCH_NAMES if get_config(a).family == "encdec"]


def test_dense_archs_are_the_reference_dense_archs():
    assert DENSE == [a for a in JARCH_NAMES
                     if jget_config(a).family == "dense"]
    assert len(DENSE) == 4


def test_moe_archs_are_the_reference_moe_archs():
    assert MOE == [a for a in JARCH_NAMES if jget_config(a).family == "moe"]
    assert len(MOE) == 2


def test_vlm_archs_are_the_reference_vlm_archs():
    assert VLM == [a for a in JARCH_NAMES if jget_config(a).family == "vlm"]
    assert len(VLM) == 1


def test_encdec_archs_are_the_reference_encdec_archs():
    assert ENCDEC == [a for a in JARCH_NAMES
                      if jget_config(a).family == "encdec"]
    assert len(ENCDEC) == 1


def make_batch(cfg, rng):
    """The reference test's batch as torch tensors: tokens, labels (the
    draws the extras follow), and a vlm or encdec model's bf16 extras."""
    batch = {
        "tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                                   .astype(np.int32)),
        "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                                   .astype(np.int32)),
    }
    for fam, key, t in (("vlm", "image_embeds", cfg.n_frontend_tokens),
                        ("encdec", "frames", cfg.enc_seq)):
        if cfg.family == fam:
            batch[key] = torch.from_numpy(rng.normal(
                size=(B, t, cfg.d_model)).astype(np.float32)).bfloat16()
    return batch


@pytest.mark.parametrize("arch", DENSE + MOE + VLM + ENCDEC)
def test_smoke_forward_and_decode(arch):
    cfg = get_config(arch + "-smoke")
    params, _ = jlm.init_params(jget_config(arch + "-smoke"),
                                jax.random.PRNGKey(0))
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                    lm.build_model(cfg, "cpu"))
    batch = make_batch(cfg, np.random.default_rng(0))
    tokens = batch["tokens"]
    # the reference inits the vlm gates to zero, which hides the cross
    # layers: draw them N(0, 1)
    gen = torch.Generator().manual_seed(1)
    for cp in getattr(model, "cross_layers", ()):
        for g in (cp.gate, cp.mlp_gate):
            g.copy_(torch.randn((), generator=gen))

    loss = float(lm.loss_fn(cfg, model, batch))
    assert np.isfinite(loss)
    assert abs(loss - np.log(cfg.vocab)) < 2.0  # random-init CE sanity

    logits_p, caches = lm.prefill_fn(cfg, model, batch, MAXS)
    assert logits_p.shape == (B, 1, cfg.vocab)
    assert bool(torch.isfinite(logits_p).all())

    next_tok = torch.argmax(logits_p[:, 0], -1)[:, None]
    logits_d, _ = lm.decode_fn(cfg, model, next_tok, caches, S)
    assert logits_d.shape == (B, 1, cfg.vocab)
    assert bool(torch.isfinite(logits_d).all())

    # decode(tok | prefill(S)) must equal full forward over S+1 tokens
    h = lm._backbone_full(cfg, model, torch.cat([tokens.long(), next_tok],
                                                dim=1), extra=batch)
    logits_full = (h[:, -1:, :] @ lm._unembed(cfg, model)).float()
    rel = float((logits_full - logits_d).abs().max()
                / (logits_full.abs().max() + 1e-6))
    assert rel < 0.05, (arch, rel)
