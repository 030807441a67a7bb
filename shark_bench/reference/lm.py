"""The plain reference of the benchmark's models: the forward pass, the
training loss and its gradients, in plain PyTorch and float32.

It follows the published descriptions, not the program.  Here is what
every family shares: the token embedding; the layers, each the family's
`block(spec, prec, P, i, x)` in `reference/<family>.py` (found by the
configuration's family, `spec.reference`); the final RMSNorm; the head,
the embedding transposed when tied; and the loss, the mean next-token
cross-entropy over every position.

Parameters are a dict {name: tensor} under the names of `spec.leaves`.
`prec` is where the control changes the arithmetic: each matrix product's
operands pass through `prec.act` and `prec.weight`, and attention's q, k, v
and probabilities through `prec.act`; the reference itself (`FP32`) leaves
them as they are.  TF32 must be off (`no_tf32`).

It imports nothing of the program.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.utils.checkpoint

from shark_bench.spec import reference

Params = Dict[str, torch.Tensor]


class FP32:
    """float32 throughout."""

    @staticmethod
    def act(x):
        return x

    @staticmethod
    def weight(w):
        return w


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def mm(prec, x, w):
    return prec.act(x) @ prec.weight(w)


def head(spec, P: Params):
    """(D, V): the tied embedding transposed, or lm_head."""
    return P["embed.tok"].T if spec.tied else P["lm_head"]


def hidden(spec, P: Params, tokens, prec=FP32, remat: bool = False):
    """The final normed hidden states (B, S, D) of tokens (B, S); with
    `remat`, each layer's activations are recomputed in the backward."""
    block = reference(spec).block
    x = P["embed.tok"][tokens.long()]
    for i in range(spec.n_layers):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                block, spec, prec, P, i, x, use_reentrant=False)
        else:
            x = block(spec, prec, P, i, x)
    return rmsnorm(x, P["final_norm.w"], spec.eps)


def _xent_sum(prec, h, w, labels):
    logits = mm(prec, h, w)
    return (torch.logsumexp(logits, dim=-1)
            - torch.gather(logits, -1, labels[..., None].long())[..., 0]).sum()


def loss(spec, P: Params, tokens, labels, prec=FP32, chunks: int = 8):
    """The mean next-token cross-entropy, its head in `chunks` sequence
    chunks (each recomputed in the backward), the layers rematerialized."""
    h = hidden(spec, P, tokens, prec, remat=True)
    b, s, _ = h.shape
    cs = -(-s // chunks)
    w = head(spec, P)
    total = 0.0
    for i in range(0, s, cs):
        total = total + torch.utils.checkpoint.checkpoint(
            _xent_sum, prec, h[:, i:i + cs], w, labels[:, i:i + cs],
            use_reentrant=False)
    return total / (b * s)


@torch.no_grad()
def last_logits(spec, P: Params, tokens, prec=FP32):
    """Logits (B, V) at the last position of tokens (B, S)."""
    return mm(prec, hidden(spec, P, tokens, prec)[:, -1], head(spec, P))
