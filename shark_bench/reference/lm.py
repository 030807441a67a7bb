"""The plain reference of the benchmark's models: the forward pass, the
training loss and its gradients, in plain PyTorch and float32.

It follows the published descriptions, not the program:
- dense (Qwen2): token embedding; per layer x += Attn(RMSNorm(x)), x +=
  SwiGLU(RMSNorm(x)); attention with biased q, k, v projections, rotary
  embeddings by halves (rotate_half) on q and k, grouped-query heads
  (query head h reads kv head h // (H / KV)), causal softmax scaled by
  1/sqrt(head_dim); final RMSNorm; the head is the embedding, transposed,
  when tied.
- ssm (Mamba2, arXiv:2405.21060): per layer x += Mamba2(RMSNorm(x)):
  in_proj to [z, x, B, C, dt]; a depthwise causal convolution with bias and
  SiLU over [x, B, C]; dt = softplus(dt + dt_bias), A = -exp(A_log); the
  SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t
  + D x_t, computed in chunks (the paper's minimal SSD); y = RMSNorm(y *
  SiLU(z)); out_proj.
- The loss is the mean next-token cross-entropy over every position.

Parameters are a dict {name: tensor} under the names of `spec.leaves`.
`prec` is where the control changes the arithmetic: each matrix product's
operands pass through `prec.act` and `prec.weight`, and attention's q, k, v
and probabilities through `prec.act`; the reference itself (`FP32`) leaves
them as they are.  TF32 must be off (`no_tf32`).

It imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

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


def rope(x, theta):
    """x (B, S, heads, hd), rotated by halves at positions 0..S-1."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(prec, q, k, v, q_block: int = 2048):
    """Causal grouped-query attention.  q (B, S, H, hd), k, v (B, S, KV,
    hd); returns (B, S, H * hd).  Queries go in blocks of `q_block` rows,
    so that the scores of one block exist at a time."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    q = prec.act(q).reshape(b, s, kv, g, hd).permute(0, 2, 3, 1, 4)
    k = prec.act(k).permute(0, 2, 1, 3)[:, :, None]          # (B, KV, 1, S, hd)
    v = prec.act(v).permute(0, 2, 1, 3)[:, :, None]
    outs = []
    for start in range(0, s, q_block):
        qb = q[:, :, :, start:start + q_block]
        rows = torch.arange(start, start + qb.shape[3], device=q.device)
        scores = (qb @ k.transpose(-1, -2)) / math.sqrt(hd)
        mask = torch.arange(s, device=q.device)[None, :] <= rows[:, None]
        scores = scores.masked_fill(~mask, float("-inf"))
        p = prec.act(torch.softmax(scores, dim=-1))
        outs.append(p @ v)                                   # (B, KV, g, r, hd)
    o = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4)
    return o.reshape(b, s, h * hd)


def dense_block(spec, prec, P: Params, i: int, x):
    p = f"layers.{i}."
    h = rmsnorm(x, P[p + "ln1.w"], spec.eps)
    b, s, _ = x.shape
    hd = spec.head_dim
    q = mm(prec, h, P[p + "attn.wq"])
    k = mm(prec, h, P[p + "attn.wk"])
    v = mm(prec, h, P[p + "attn.wv"])
    if spec.qkv_bias:
        q = q + P[p + "attn.bq"]
        k = k + P[p + "attn.bk"]
        v = v + P[p + "attn.bv"]
    q = rope(q.reshape(b, s, spec.n_heads, hd), spec.rope_theta)
    k = rope(k.reshape(b, s, spec.n_kv_heads, hd), spec.rope_theta)
    v = v.reshape(b, s, spec.n_kv_heads, hd)
    x = x + mm(prec, attention(prec, q, k, v), P[p + "attn.wo"])
    h = rmsnorm(x, P[p + "ln2.w"], spec.eps)
    a = F.silu(mm(prec, h, P[p + "mlp.gate"])) * mm(prec, h, P[p + "mlp.up"])
    return x + mm(prec, a, P[p + "mlp.down"])


def _segsum(x):
    """x (..., T) -> (..., T, T): sum of x[j+1..i] at [i, j], -inf above
    the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd(x, a, bm, cm, chunk: int):
    """The paper's minimal SSD.  x (b, s, h, p) already times dt; a (b, s,
    h) = dt * A; bm, cm (b, s, g, n).  Returns y (b, s, h, p) without the
    D skip."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    pad = (-s) % chunk
    if pad:   # zero rows: no input, no decay; their outputs are dropped
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, 0, 0, pad))
    c = (s + pad) // chunk
    hg = h // g
    x = x.reshape(b, c, chunk, h, p)
    a = a.reshape(b, c, chunk, h).permute(0, 3, 1, 2)          # (b, h, c, l)
    bm = bm.reshape(b, c, chunk, g, n)
    cm = cm.reshape(b, c, chunk, g, n)
    a_cs = torch.cumsum(a, dim=-1)
    # 1. within a chunk
    L = torch.exp(_segsum(a))                                  # (b, h, c, l, l)
    cb = torch.einsum("bclgn,bcsgn->bcgls", cm, bm)
    cb = cb.repeat_interleave(hg, dim=2)                       # (b, c, h, l, l)
    y = torch.einsum("bchls,bcshp->bclhp", cb * L.permute(0, 2, 1, 3, 4), x)
    # 2. each chunk's state
    decay = torch.exp(a_cs[..., -1:] - a_cs)                   # (b, h, c, l)
    bh = bm.repeat_interleave(hg, dim=3)                       # (b, c, l, h, n)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", bh, decay, x)
    # 3. across chunks
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    dchunk = torch.exp(_segsum(F.pad(a_cs[..., -1], (1, 0))))  # (b, h, c+1, c+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", dchunk, states)[:, :-1]
    # 4. states to outputs
    ch = cm.repeat_interleave(hg, dim=3)
    y = y + torch.einsum("bclhn,bchpn,bhcl->bclhp", ch, states,
                         torch.exp(a_cs))
    return y.reshape(b, c * chunk, h, p)[:, :s]


def mamba_block(spec, prec, P: Params, i: int, x):
    p = f"layers.{i}.mamba."
    h = rmsnorm(x, P[f"layers.{i}.ln.w"], spec.eps)
    b, s, _ = x.shape
    di, nh, g, n = spec.d_inner, spec.ssm_heads, spec.ngroups, spec.d_state
    zxbcdt = mm(prec, h, P[p + "in_proj"])
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * g * n]
    dt = zxbcdt[..., 2 * di + 2 * g * n:]
    w = P[p + "conv_w"]                                       # (conv_dim, K)
    k = w.shape[1]
    conv = F.conv1d(F.pad(xbc.transpose(1, 2), (k - 1, 0)), w[:, None, :],
                    P[p + "conv_b"], groups=w.shape[0])
    xbc = F.silu(conv).transpose(1, 2)
    xs = xbc[..., :di].reshape(b, s, nh, spec.headdim)
    bm = xbc[..., di:di + g * n].reshape(b, s, g, n)
    cm = xbc[..., di + g * n:].reshape(b, s, g, n)
    dt = F.softplus(dt + P[p + "dt_bias"])
    A = -torch.exp(P[p + "A_log"])
    y = ssd(xs * dt[..., None], dt * A, bm, cm, spec.chunk)
    y = y + xs * P[p + "D"][:, None]
    y = rmsnorm(y.reshape(b, s, di) * F.silu(z), P[p + "norm_w"], spec.eps)
    return x + mm(prec, y, P[p + "out_proj"])


def head(spec, P: Params):
    """(D, V): the tied embedding transposed, or lm_head."""
    return P["embed.tok"].T if spec.tied else P["lm_head"]


def hidden(spec, P: Params, tokens, prec=FP32, remat: bool = False):
    """The final normed hidden states (B, S, D) of tokens (B, S); with
    `remat`, each layer's activations are recomputed in the backward."""
    block = dense_block if spec.family == "dense" else mamba_block
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
