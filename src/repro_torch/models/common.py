"""Shared model components: initializers, norms, RoPE, MLPs, embeddings.

The reference keeps parameters as nested dicts with stacked leading layer
axes (`stacked_dense_init`); the port keeps them on `nn.Module`s, one
module per layer, with the reference's names and shapes (a weight is
(in, out) and applied as `x @ w`), so `models/convert.py` maps one tree
onto the other.  Each `*_init` of the reference is a module's
constructor here (`Norm`, `MLP`, `Embed`), drawing from an explicit
`torch.Generator` with the reference's distributions: normal in float32,
scaled, then cast.  `chunked_softmax_xent` and `full_softmax_xent` are
the reference's training losses.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.utils.checkpoint
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def cost_counter():
    """The innermost active cost counter (`launch/cost.CostCounter`, a
    dispatch mode), or None: what `named_scope` and `exchange` report
    to."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if getattr(mode, "counts_cost", False):
            return mode
    return None


def named_scope(name: str):
    """The reference's `jax.named_scope(name)` around a function: under a
    cost counter (`launch/cost.CostCounter`) the function's operations,
    and those of its backward, count under `name`; without one the
    function runs as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            counter = cost_counter()
            if counter is None:
                return fn(*args, **kwargs)
            return counter.scoped(name, fn, args, kwargs)
        return run
    return wrap


def exchange(tensors, n: int) -> None:
    """Report an all-to-all among n mesh slots whose results are
    `tensors` to the active cost counter (the exchange itself is the
    caller's `Tensor.to`, a no-op between slots of one device)."""
    counter = cost_counter()
    if counter is not None:
        counter.collective("all-to-all", list(tensors), n)


def _param(t: torch.Tensor) -> nn.Parameter:
    """Serving weights: no gradient is kept (the trainer turns gradients
    on for the parameters it updates, `training/train_step.py`)."""
    return nn.Parameter(t, requires_grad=False)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in `torch.promote_types` of the two dtypes: JAX's `@` promotes
    bfloat16 against float32 to float32, torch's refuses mixed operands.
    The reference mixes them where a bf16 input (Whisper's frames, a bf16
    batch's image embeddings) meets float32 weights, or a float32 input
    bf16 weights."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def normal(shape, std: float, dtype, device, generator) -> torch.Tensor:
    """N(0, std^2) drawn in float32, then cast (the reference's pattern)."""
    x = torch.randn(shape, dtype=torch.float32, device=device,
                    generator=generator)
    return (x * std).to(dtype)


def dense_init(in_dim: int, out_dim: int, dtype=torch.bfloat16,
               device=None, generator=None,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return normal((in_dim, out_dim), scale, dtype, device, generator)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dt)


class Norm(nn.Module):
    """`norm_init`'s parameters: `w` (ones), and `b` (zeros) for "ln"."""

    def __init__(self, kind: str, dim: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.kind = kind
        self.w = _param(torch.ones(dim, dtype=dtype, device=device))
        if kind == "ln":
            self.b = _param(torch.zeros(dim, dtype=dtype, device=device))


def norm_apply(kind: str, x: torch.Tensor, p: Norm) -> torch.Tensor:
    if kind == "rms":
        return rmsnorm(x, p.w)
    return layernorm(x, p.w, p.b)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # hd/2
    angles = positions[..., :, None].float() * freqs           # (..., s, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """`mlp_init`'s parameters: swiglu {gate, up, down}, gelu {fc, proj,
    fc_b, proj_b}."""

    def __init__(self, kind: str, d_model: int, d_ff: int,
                 dtype=torch.bfloat16, device=None, generator=None):
        super().__init__()
        self.kind = kind

        def mk(i, o):
            return _param(dense_init(i, o, dtype, device, generator))

        if kind == "swiglu":
            self.gate = mk(d_model, d_ff)
            self.up = mk(d_model, d_ff)
            self.down = mk(d_ff, d_model)
        else:
            self.fc = mk(d_model, d_ff)
            self.proj = mk(d_ff, d_model)
            self.fc_b = _param(torch.zeros(d_ff, dtype=dtype, device=device))
            self.proj_b = _param(torch.zeros(d_model, dtype=dtype,
                                             device=device))


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
           down: torch.Tensor) -> torch.Tensor:
    """(silu(x gate) * (x up)) down, the activation in float32; batched
    over a leading expert axis when x and the weights have one."""
    g = torch.matmul(x, gate)
    u = torch.matmul(x, up)
    return torch.matmul(F.silu(g.float()).to(x.dtype) * u, down)


def mlp_apply(kind: str, p: MLP, x: torch.Tensor) -> torch.Tensor:
    if kind == "swiglu":
        return swiglu(x, p.gate, p.up, p.down)
    h = x @ p.fc + p.fc_b
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ p.proj + p.proj_b


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    """`embed_init`'s parameters: `tok` (vocab, d_model), N(0, 0.02^2)."""

    def __init__(self, vocab: int, d_model: int, dtype=torch.bfloat16,
                 device=None, generator=None):
        super().__init__()
        self.tok = _param(normal((vocab, d_model), 0.02, dtype, device,
                                 generator))


class _Lookup(torch.autograd.Function):
    """table[tokens], whose backward adds each row's gradients in a
    float32 buffer and rounds the sum once to the table's dtype: added
    into a bfloat16 gradient one at a time (indexing's own backward), the
    duplicates of a frequent token lose most of their sum to rounding."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        return table[tokens]

    @staticmethod
    def backward(ctx, grad):
        tokens, = ctx.saved_tensors
        acc = torch.zeros(ctx.shape, dtype=torch.float32, device=grad.device)
        acc.index_put_((tokens.reshape(-1),),
                       grad.reshape(-1, ctx.shape[-1]).float(),
                       accumulate=True)
        return acc.to(ctx.dtype), None


def embed_lookup(p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of `tokens`; when autograd records, the table's gradient
    is summed in float32 (`_Lookup`)."""
    if torch.is_grad_enabled() and p.tok.requires_grad:
        return _Lookup.apply(p.tok, tokens)
    return p.tok[tokens]


# ---------------------------------------------------------------------------
# Cross-entropy
# ---------------------------------------------------------------------------

def _chunk_xent(hc: torch.Tensor, unembed: torch.Tensor,
                lc: torch.Tensor) -> torch.Tensor:
    """Summed next-token cross-entropy of one chunk: float32 logits of hc
    (B, c, D) against unembed (D, V), logsumexp minus the gold logit."""
    logits = (hc @ unembed).float()                     # (B, c, V)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return (logz - gold).sum()


def chunked_softmax_xent(h: torch.Tensor, unembed: torch.Tensor,
                         labels: torch.Tensor, num_chunks: int = 8
                         ) -> torch.Tensor:
    """Mean next-token CE.  h: (B, S, D) final hidden states, unembed
    (D, V), labels (B, S).  Loops over `num_chunks` sequence chunks, so
    the logits of one chunk, (B, S / num_chunks, V), exist at a time; when
    autograd records, each chunk runs under `torch.utils.checkpoint`, so
    its backward recomputes the chunk's logits rather than keep every
    chunk's for it (the reference's scan, whose logits XLA
    rematerializes).  The chunks' sums add in float32 in order."""
    b, s, d = h.shape
    if s % num_chunks:
        raise ValueError(f"sequence {s} is no multiple of {num_chunks} "
                         f"loss chunks")
    cs = s // num_chunks
    record = torch.is_grad_enabled() and (h.requires_grad
                                          or unembed.requires_grad)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(num_chunks):
        hc, lc = h[:, i * cs:(i + 1) * cs], labels[:, i * cs:(i + 1) * cs]
        if record:
            total = total + torch.utils.checkpoint.checkpoint(
                _chunk_xent, hc, unembed, lc, use_reentrant=False)
        else:
            total = total + _chunk_xent(hc, unembed, lc)
    return total / (b * s)


def full_softmax_xent(h: torch.Tensor, unembed: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE over the whole (B, S, V) float32 logits."""
    logits = (h @ unembed).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()
