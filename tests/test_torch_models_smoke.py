"""Twin of tests/test_models_smoke.py's `test_smoke_forward_and_decode` for
the families the port builds: the four dense and the two MoE
architectures' smoke variants, with the reference's parameters carried
over by
`models/convert.params_from_jax` and the reference test's batch shape.

Prefill logits (B, 1, V) and finite, one decode step's logits finite, and
decode(tok | prefill(S)) equal to the full forward over S + 1 tokens to
rel 0.05 (the reference test's bar, bf16 weights).  The reference test's
`loss_fn` check waits for the port's training step (ROADMAP A.5).
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


def test_dense_archs_are_the_reference_dense_archs():
    assert DENSE == [a for a in JARCH_NAMES
                     if jget_config(a).family == "dense"]
    assert len(DENSE) == 4


def test_moe_archs_are_the_reference_moe_archs():
    assert MOE == [a for a in JARCH_NAMES if jget_config(a).family == "moe"]
    assert len(MOE) == 2


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_smoke_forward_and_decode(arch):
    cfg = get_config(arch + "-smoke")
    params, _ = jlm.init_params(jget_config(arch + "-smoke"),
                                jax.random.PRNGKey(0))
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                    lm.build_model(cfg, "cpu"))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                              .astype(np.int32))

    logits_p, caches = lm.prefill_fn(cfg, model, {"tokens": tokens}, MAXS)
    assert logits_p.shape == (B, 1, cfg.vocab)
    assert bool(torch.isfinite(logits_p).all())

    next_tok = torch.argmax(logits_p[:, 0], -1)[:, None]
    logits_d, _ = lm.decode_fn(cfg, model, next_tok, caches, S)
    assert logits_d.shape == (B, 1, cfg.vocab)
    assert bool(torch.isfinite(logits_d).all())

    # decode(tok | prefill(S)) must equal full forward over S+1 tokens
    h = lm._backbone_full(cfg, model, torch.cat([tokens.long(), next_tok],
                                                dim=1))
    logits_full = (h[:, -1:, :] @ lm._unembed(cfg, model)).float()
    rel = float((logits_full - logits_d).abs().max()
                / (logits_full.abs().max() + 1e-6))
    assert rel < 0.05, (arch, rel)
