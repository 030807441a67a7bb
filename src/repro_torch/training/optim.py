"""AdamW with mixed precision: the reference's `repro/training/optim.py`
over the model's named parameters.

Parameters live in bfloat16 (the compute dtype).  The optimizer state
holds float32 master weights and float32 first and second moments, one
each a parameter, under the parameter's name; `step` is an int32 scalar.
Gradient clipping is by global norm; weight decay is decoupled (AdamW).
`torch.optim.AdamW` computes another function (no master copy, decay
before the moment update), so the update is written out as the
reference writes it.

The reference returns new trees (JAX arrays are immutable); the port
updates the state and the parameters in place, one tensor at a time, so
that the card holds one copy of the state (16 bytes a parameter: 3.09 B
parameters of Qwen2.5-3B take 49.4 GB).  The reference's `zero1_specs`
(mesh partition specs for ZeRO-1 sharding) and its `AdamWConfig.zero1`
switch have no counterpart on one card, as `parallel/` has none.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params: Tensors) -> Dict:
    """{"step": int32 0, "master": float32 copies, "mu": zeros, "nu":
    zeros}, each a dict by parameter name, on the parameters' devices."""
    master = {n: p.detach().to(torch.float32, copy=True)
              for n, p in params.items()}
    dev = next(iter(params.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "master": master,
            "mu": {n: torch.zeros_like(m) for n, m in master.items()},
            "nu": {n: torch.zeros_like(m) for n, m in master.items()}}


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32."""
    total = None
    for t in tensors:
        sq = torch.sum(torch.square(t.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Tensors, params: Tensors,
                 opt_state: Dict, lr_scale=1.0) -> Tuple[Tensors, Dict,
                                                         torch.Tensor]:
    """One AdamW step, in place.  Returns (params, opt_state, the global
    norm of the gradients before clipping): each parameter is its new
    float32 master weight rounded to its own dtype.  Per tensor, with the
    gradient g in float32 times clip = min(1, grad_clip / (norm + 1e-9)):
    mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, and master -= lr
    (mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps) + weight_decay
    master), t the step after the increment."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads.values())
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32)
    bias1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=t.device), t)
    bias2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=t.device), t)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=t.device)
    for name, g in grads.items():
        m = opt_state["master"][name]
        mu = opt_state["mu"][name]
        nu = opt_state["nu"][name]
        g = g.float() * clip
        mu.copy_(b1 * mu + (1.0 - b1) * g)
        nu.copy_(b2 * nu + (1.0 - b2) * g * g)
        mhat = mu / bias1
        nhat = nu / bias2
        m.copy_(m - lr * (mhat / (torch.sqrt(nhat) + cfg.eps)
                          + cfg.weight_decay * m))
        params[name].copy_(m)
    opt_state["step"] = step
    return params, opt_state, gnorm
