"""One rank's share of a dropless MoE layer on the card (`moe_apply_grouped`:
the held experts' grouped products, `torch._grouped_mm`, in bfloat16)
against the same layer in float32 on the CPU (there the plain sum, held to
it by tests/test_torch_moe_share.py), with its gradients; two runs' bits;
and that neither the layer nor a cut Moonlight's training forward and
backward (MLA too) waits for the device.

No JAX here, so the GPU host runs it (`pytest -m cuda
tests/test_torch_moe_share_cuda.py`); the CPU tests are
tests/test_torch_moe_share.py.
"""

import dataclasses
import warnings

import pytest
import torch

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.models import lm
from repro_torch.models import moe as tmoe

D, E, F = 256, 64, 128
CFG = tmoe.MoEConfig(num_experts=E, top_k=6, d_expert=F, n_shared=2,
                     score="sigmoid", routed_scale=2.446, select_bias=True,
                     held=8, held_offset=16)


def _layer(device):
    g = torch.Generator().manual_seed(0)
    p = tmoe.MoE(D, CFG, torch.bfloat16, "cpu", g)
    with torch.no_grad():
        p.select_bias.copy_(0.1 * (torch.rand(E, generator=g) - 0.5))
    return p.to(device)


def _run(p, x):
    params = [t.requires_grad_(True) for n, t in p.named_parameters()
              if n != "select_bias"]
    x = x.detach().requires_grad_(True)
    y = tmoe.moe_apply(p, x, CFG)
    grads = torch.autograd.grad(y.float().square().sum(), [x] + params)
    return [y] + list(grads)


@pytest.mark.cuda
def test_cuda_grouped_share_matches_cpu_and_repeats():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn(2, 512, D, generator=torch.Generator().manual_seed(1)) \
        .to(torch.bfloat16)
    want = _run(_layer("cpu").float(), x.float())
    gpu = _layer("cuda")
    got = _run(gpu, x.cuda())
    again = _run(gpu, x.cuda())
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.device.type == "cuda" and torch.isfinite(g.float()).all(), i
        rel = float((g.float().cpu() - w.float()).norm() / w.float().norm())
        assert rel < 2e-2, (i, rel)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.cuda
def test_cuda_grouped_share_never_waits_for_the_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = _layer("cuda")
    x = torch.randn(2, 512, D, device="cuda", dtype=torch.bfloat16)
    _run(p, x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _run(p, x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _waits(caught) == []


def _waits(caught):
    return [str(w.message) for w in caught
            if "synchronizing CUDA operation" in str(w.message)]


@pytest.mark.cuda
def test_cuda_moonlight_step_never_waits_for_the_device():
    """A training step's forward and backward of a cut Moonlight (MLA,
    the dense layer 0, two MoE layers of a share): no wait for the
    device, as `host_syncs.train` counts them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = ModelConfig(
        name="moonlight-cut", family="moe", n_layers=3, d_model=D,
        n_heads=4, n_kv_heads=4, d_ff=F, vocab=512,
        mla=MLAConfig(kv_lora=64, nope_dim=32, rope_dim=16, v_dim=32,
                      rope_theta=50000.0),
        moe=dataclasses.replace(CFG, first_dense=True, dense_d_ff=512))
    m = lm.build_model(cfg, "cuda")
    params = [p.requires_grad_(True) for n, p in m.named_parameters()
              if not n.endswith("select_bias")]
    tok = torch.randint(0, 512, (2, 256), device="cuda")
    batch = {"tokens": tok, "labels": tok}
    torch.autograd.grad(lm.loss_fn(cfg, m, batch), params)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.autograd.grad(lm.loss_fn(cfg, m, batch), params)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _waits(caught) == []
