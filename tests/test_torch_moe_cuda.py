"""The `moe` family on the card against the port on the CPU.

No JAX here, so the GPU host runs it (`pytest -m cuda
tests/test_torch_moe_cuda.py`); the CPU tests that hold the port to the
reference are tests/test_torch_moe.py and tests/test_torch_lm.py.  Both
MoE smoke variants (DeepSeek-V2-Lite's: MLA, a dense layer 0, shared
experts; Phi-3.5-MoE's: GQA through kernel 11), float32 weights drawn from
a seed: the prefill logits and caches and two decode steps on the card
equal the CPU's to rel 1e-5, and two runs on the card give identical bits
(the experts' combine sums over k, no atomics).
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import lm

B, S, MAXS = 2, 37, 48


def _rel(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def _serve(cfg, model, toks, steps):
    logits, caches = lm.prefill_fn(cfg, model, {"tokens": toks}, MAXS)
    out = [logits] + [v.clone() for _, v in sorted(caches.items())]
    for i in range(steps):
        tok = torch.argmax(logits[:, -1], dim=-1)
        logits, caches = lm.decode_fn(cfg, model, tok[:, None], caches,
                                      S + i)
        out.append(logits)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b-smoke",
                                  "phi3.5-moe-42b-a6.6b-smoke"])
def test_cuda_moe_serving_matches_cpu_and_repeats(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_config(name)
    cpu = lm.build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    cpu.float()
    gpu = copy.deepcopy(cpu).cuda()
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)).astype(np.int64))
    want = _serve(cfg, cpu, toks, 2)
    got = _serve(cfg, gpu, toks.cuda(), 2)
    again = _serve(cfg, gpu, toks.cuda(), 2)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.device.type == "cuda" and g.shape == w.shape, i
        assert _rel(g, w) < 1e-5, i
    for g, a in zip(got, again):
        assert torch.equal(g, a)
