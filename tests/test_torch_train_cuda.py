"""Training's kernels on the card against their plain versions.

No JAX here, so the GPU host runs it (`pytest -m cuda
tests/test_torch_train_cuda.py`); the CPU tests that hold the port's
training to the reference are tests/test_torch_train_step.py and
tests/test_torch_attention_grad.py.  Kernel 11's log-sum-exp output on
both routes (abs 1e-3 on bf16, 1e-4 on float32), the gradients through
`models/flash.FlashAttention` (kernel 11 forward, plain backward) and
`models/mamba2.SSDScan` (kernel 12 forward, plain backward) against
autograd of the plain versions on the card (rel 1e-4 in float32), and a
float32 train step on the card against the same step on the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import ssd_scan as ks
from repro_torch.models import flash as mf
from repro_torch.models import mamba2 as mm


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kv,s,t,hd,causal", [
    (2, 16, 2, 1000, 1000, 128, True),
    (1, 8, 8, 300, 300, 64, True),
    (2, 8, 2, 700, 129, 64, False),
    (1, 4, 4, 65, 65, 38, True),
])
def test_cuda_flash_lse_matches_plain(dtype, b, h, kv, s, t, hd, causal):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(s + t)
    q = torch.randn(b, s, h, hd, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(b, t, kv, hd, device=dev, generator=g).to(dtype)
            for _ in range(2))
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal)
    out, lse = kf.flash_attention_fwd(*args, return_lse=True)
    pout, plse = kf.flash_attention_fwd_plain(*args, return_lse=True)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    assert torch.equal(out, kf.flash_attention_fwd(*args))
    bound = 1e-3 if dtype == torch.bfloat16 else 1e-4
    assert float((lse - plse).abs().max()) < bound


@pytest.mark.cuda
@pytest.mark.parametrize("bwd", ["exact", "flash"])
@pytest.mark.parametrize("causal,s,t", [(True, 300, 300), (False, 200, 161)])
def test_cuda_flash_backward_matches_plain(bwd, causal, s, t):
    """float32 q, k, v: the exact backward after kernel 11's forward
    against autograd of the plain masked softmax to 1e-4; the reference's
    bf16-rounding backward against itself after the plain forward, to
    one bf16 step."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(7)
    b, h, kv, hd = 2, 8, 2, 64
    q = torch.randn(b, s, h, hd, device=dev, generator=g)
    k, v = (torch.randn(b, t, kv, hd, device=dev, generator=g)
            for _ in range(2))
    w = torch.randn(b, s, h, hd, device=dev, generator=g)

    def grads(fn):
        ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
        return torch.autograd.grad((fn(*ins) * w).sum(), ins)
    got = grads(lambda q, k, v: mf.attention(q, k, v, causal, bwd, 64))
    if bwd == "exact":
        want = grads(lambda q, k, v: kf.flash_attention_fwd_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal).transpose(1, 2))
        bound = 1e-4
    else:
        want = grads(lambda q, k, v: mf.FlashAttention.apply(
            q.cpu(), k.cpu(), v.cpu(), causal, bwd, 64).to(dev))
        bound = 2.0 ** -7
    for a, b_ in zip(got, want):
        assert _rel(a, b_) < bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_backward_matches_plain(dtype):
    """Gradients through kernel 12's forward and the plain backward
    against autograd of `ssd_scan_plain` on the card: float32 to 1e-4,
    bf16 (x, B, C) to 2e-2."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(3)
    b, s, h, p, n, chunk = 2, 300, 4, 64, 128, 128
    x = torch.randn(b, s, h, p, device=dev, generator=g).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, device=dev,
                                                  generator=g))
    a = -torch.exp(torch.randn(h, device=dev, generator=g))
    bm, cm = (torch.randn(b, s, 1, n, device=dev, generator=g).to(dtype)
              for _ in range(2))
    d = torch.randn(h, device=dev, generator=g)
    wy = torch.randn(b, s, h, p, device=dev, generator=g)
    ws = torch.randn(b, h, p, n, device=dev, generator=g)

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in (x, dt, a, bm, cm, d)]
        y, st = fn(*ins)
        loss = (y.float() * wy).sum() + (st * ws).sum()
        return torch.autograd.grad(loss, ins)
    got = grads(lambda *t: mm.ssd_scan(*t[:5], chunk, t[5]))
    want = grads(lambda *t: ks.ssd_scan_plain(*t[:5], chunk, t[5]))
    bound = 1e-4 if dtype == torch.float32 else 2e-2
    for a_, b_ in zip(got, want):
        assert _rel(a_, b_) < bound


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen2.5-3b-smoke", "mamba2-370m-smoke"])
def test_cuda_train_step_matches_cpu(name):
    """One float32 AdamW step of a smoke model on the card (kernels 11 or
    12 forward) against the same step on the CPU: loss, gradient norm and
    first moments (the clipped gradients) to 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    dev = _card()
    cfg = get_config(name)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    out = []
    for device in ("cpu", dev):
        model = lm.build_model(cfg, "cpu",
                               torch.Generator().manual_seed(0)).float()
        model.to(device)
        opt = init_opt_state(dict(model.named_parameters()))
        step = make_train_step(cfg, AdamWConfig(lr=1e-3))
        model, opt, m = step(model, opt, {k: v.to(device)
                                          for k, v in batch.items()})
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {n: mu.cpu() for n, mu in opt["mu"].items()}))
    assert abs(out[0][0] - out[1][0]) / abs(out[0][0]) < 1e-4
    assert abs(out[0][1] - out[1][1]) / abs(out[0][1]) < 1e-4
    for n, p in out[0][2].items():
        assert _rel(out[1][2][n], p) < 1e-4, n
