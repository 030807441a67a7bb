"""Expert parallelism on the card: `moe_apply_ep` over `[cuda:0] * 4` slots
against the port on `[cpu] * 4` slots.

No JAX here, so the GPU host runs it (`pytest -m cuda
tests/test_torch_moe_ep_cuda.py`); tests/test_torch_moe_ep.py holds the
port's EP to the reference's on the CPU.  Float32 weights drawn from a
seed.  The layer (both MoE smoke configs' experts, capacity 4.0 and 1.0,
where slots drop, meshes (1, 4) and (2, 2)): y and the gradients of a
seeded weighted sum to rel 1e-5, `expert_load` equal, and two runs on the
card give identical bits.  The model (both smoke configs with
`moe_impl="ep_shardmap"`, mesh (1, 4)): prefill logits, the loss and every
gradient to rel 1e-4 (kernel 11 on the card, its plain version here).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models import moe as tmoe
from repro_torch.parallel import make_mesh, set_mesh

PHI = "phi3.5-moe-42b-a6.6b-smoke"
DS = "deepseek-v2-lite-16b-smoke"
B, S = 4, 16


def _rel(got, want):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


def _mesh(shape, device):
    return make_mesh(shape, ("data", "model"),
                     [torch.device(device)] * (shape[0] * shape[1]))


def _layer_run(p, x, w, cfg, shape, device):
    p = copy.deepcopy(p).to(device)
    for q in p.parameters():
        q.requires_grad_(True)
    x = x.to(device).requires_grad_(True)
    with set_mesh(_mesh(shape, device)):
        y, st = tmoe.moe_apply_ep(p, x, cfg, return_stats=True)
    grads = torch.autograd.grad((y * w.to(device)).sum(),
                                [x, *p.parameters()])
    return y, st, grads


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("cf", [4.0, 1.0])
@pytest.mark.parametrize("arch", [PHI, DS])
def test_cuda_ep_layer_matches_cpu_and_repeats(arch, cf, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(get_config(arch).moe, capacity_factor=cf)
    d = get_config(arch).d_model
    p = tmoe.MoE(d, cfg, torch.float32, "cpu",
                 torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    x, w = (torch.from_numpy(rng.normal(size=(B, S, d)).astype(np.float32))
            for _ in range(2))
    want = _layer_run(p, x, w, cfg, shape, "cpu")
    got = _layer_run(p, x, w, cfg, shape, "cuda")
    again = _layer_run(p, x, w, cfg, shape, "cuda")
    assert got[0].device.type == "cuda"
    assert _rel(got[0], want[0]) < 1e-5
    assert torch.equal(got[1]["expert_load"].cpu(), want[1]["expert_load"])
    for g, wg in zip(got[2], want[2]):
        assert g.device.type == "cuda" and _rel(g, wg) < 1e-5
    assert torch.equal(got[0], again[0])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [PHI, DS])
def test_cuda_ep_model_matches_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(get_config(arch), moe_impl="ep_shardmap")
    cpu = lm.build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    cpu.float()
    gpu = copy.deepcopy(cpu).cuda()
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                                 .astype(np.int64))
             for k in ("tokens", "labels")}
    outs = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        b = {k: v.to(dev) for k, v in batch.items()}
        for p in model.parameters():
            p.requires_grad_(True)
        with set_mesh(_mesh((1, 4), dev)):
            with torch.no_grad():
                logits, _ = lm.prefill_fn(cfg, model, {"tokens": b["tokens"]},
                                          S + 4)
            loss = lm.loss_fn(cfg, model, b)
            grads = torch.autograd.grad(loss, list(model.parameters()))
        outs.append((logits, loss, grads))
    (lc, sc, gc), (lg, sg, gg) = outs
    assert lg.device.type == "cuda"
    assert _rel(lg, lc) < 1e-4 and _rel(sg, sc) < 1e-4
    for a, b in zip(gg, gc):
        assert _rel(a, b) < 1e-4
