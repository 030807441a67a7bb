"""The reference's optimizer: AdamW with float32 moments, clipping by the
global norm of the gradients, decoupled weight decay, and a learning rate
warmed up linearly and then decayed on a cosine (Loshchilov and Hutter,
arXiv:1711.05101; the schedule of the trainer the traffic file names).

    clip = min(1, max_norm / (|g| + 1e-9)),  g <- clip g
    mu <- b1 mu + (1 - b1) g,  nu <- b2 nu + (1 - b2) g^2
    w  <- w - lr_t (mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps) + wd w)
    lr_t = lr * min(t / warmup, 1) * (floor + (1 - floor) (1 + cos(pi q)) / 2),
    q = clamp((t - warmup) / (total - warmup), 0, 1)

Plain PyTorch in float32; it imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def lr_scale(t: int, warmup: int, total: int, floor: float) -> float:
    warm = min(t / max(warmup, 1), 1.0)
    q = min(max((t - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return warm * (floor + (1.0 - floor) * 0.5 * (1.0 + math.cos(math.pi * q)))


class AdamW:
    """State {name: (mu, nu)} beside float32 weights updated in place."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: dict):
        self.o = opt
        self.t = 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One update; returns {"grad_norm": |g| before clipping, "clip":
        the factor}."""
        o = self.o
        self.t += 1
        t = self.t
        gnorm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
        clip = min(1.0, o["grad_clip"] / (gnorm + 1e-9))
        lr = o["lr"] * lr_scale(t, o["warmup"], o["total"], o["floor"])
        c1, c2 = 1.0 - o["b1"] ** t, 1.0 - o["b2"] ** t
        for n, g in grads.items():
            g = g * clip
            mu, nu, w = self.mu[n], self.nu[n], params[n]
            mu.mul_(o["b1"]).add_(g, alpha=1.0 - o["b1"])
            nu.mul_(o["b2"]).addcmul_(g, g, value=1.0 - o["b2"])
            upd = (mu / c1) / (torch.sqrt(nu / c2) + o["eps"]) \
                + o["weight_decay"] * w
            w.sub_(lr * upd)
        return {"grad_norm": gnorm, "clip": clip}
