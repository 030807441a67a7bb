"""The training step: loss -> gradients -> AdamW, with optional gradient
accumulation over microbatches (the reference's
`repro/training/train_step.py`, whose `lax.scan` this loop is).

`make_train_step(cfg, opt, microbatches)` returns `train_step(model,
opt_state, batch) -> (model, opt_state, metrics)`: the model's
parameters, which the step updates in place, have their gradients turned
on (serving weights are built without them), but for those marked
`untrained` (a MoE router's selection bias, held fixed); the forward runs kernels 11
and 12 on the card (`models/lm.loss_fn`), and autograd takes the
gradients.  With microbatches > 1 the global batch splits along axis 0
and the gradients accumulate in float32; the loss and gradients are the
microbatches' means.  Metrics are the reference's: `loss`, `grad_norm`
(before clipping) and `lr_scale` (`warmup_cosine` of the new step).

Under a profiler the step records the spans `repro_torch.train.forward`
and `repro_torch.train.backward` (once a microbatch) and
`repro_torch.train.optimizer` (the schedule, the global norm, the clip
and the update; `spans.py`).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig
from ..models import lm
from ..spans import span
from .optim import AdamWConfig, adamw_update
from .schedule import warmup_cosine


def _trainable(model) -> Dict[str, torch.Tensor]:
    """The parameters the step updates, their gradients turned on: all
    but those marked `untrained` (a MoE router's selection bias), which
    the step leaves as they are."""
    params = {n: p for n, p in model.named_parameters()
              if not getattr(p, "untrained", False)}
    for p in params.values():
        p.requires_grad_(True)
    return params


def make_train_step(cfg: ModelConfig, opt: AdamWConfig,
                    microbatches: int = 1):
    def grads_of(model, params, batch):
        with span("train.forward"):
            loss = lm.loss_fn(cfg, model, batch)
        with span("train.backward"):
            gs = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, gs))

    def train_step(model, opt_state, batch):
        params = _trainable(model)
        if microbatches == 1:
            loss, grads = grads_of(model, params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            mb = b // microbatches
            loss = 0.0
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, g = grads_of(model, params, part)
                loss = loss + l
                for n, gi in g.items():
                    grads[n] += gi.float()
                del g
            loss = loss / microbatches
            for gi in grads.values():
                gi /= microbatches
        with span("train.optimizer"):
            lr_scale = warmup_cosine(opt_state["step"] + 1)
            _, opt_state, gnorm = adamw_update(
                opt, grads, {n: p.data for n, p in params.items()},
                opt_state, lr_scale)
        return model, opt_state, {"loss": loss, "grad_norm": gnorm,
                                  "lr_scale": lr_scale}

    return train_step


def make_eval_step(cfg: ModelConfig):
    """eval_step(model, batch) -> the loss, without gradients."""
    @torch.no_grad()
    def eval_step(model, batch):
        return lm.loss_fn(cfg, model, batch)
    return eval_step
