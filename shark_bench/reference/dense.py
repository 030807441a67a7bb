"""The plain reference's block of family "dense" (Qwen2): per layer x +=
Attn(RMSNorm(x)), x += SwiGLU(RMSNorm(x)); attention with biased q, k, v
projections, rotary embeddings by halves (rotate_half) on q and k,
grouped-query heads (query head h reads kv head h // (H / KV)), causal
softmax scaled by 1/sqrt(head_dim).  In float32; `prec` as `lm.py` says.

It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from shark_bench.reference.lm import Params, mm, rmsnorm


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


def block(spec, prec, P: Params, i: int, x):
    """Layer i: x += Attn(RMSNorm(x)), x += SwiGLU(RMSNorm(x))."""
    p = f"layers.{i}."
    sz = spec.sizes
    h = rmsnorm(x, P[p + "ln1.w"], spec.eps)
    b, s, _ = x.shape
    hd = sz.head_dim
    q = mm(prec, h, P[p + "attn.wq"])
    k = mm(prec, h, P[p + "attn.wk"])
    v = mm(prec, h, P[p + "attn.wv"])
    if sz.qkv_bias:
        q = q + P[p + "attn.bq"]
        k = k + P[p + "attn.bk"]
        v = v + P[p + "attn.bv"]
    q = rope(q.reshape(b, s, sz.n_heads, hd), sz.rope_theta)
    k = rope(k.reshape(b, s, sz.n_kv_heads, hd), sz.rope_theta)
    v = v.reshape(b, s, sz.n_kv_heads, hd)
    x = x + mm(prec, attention(prec, q, k, v), P[p + "attn.wo"])
    h = rmsnorm(x, P[p + "ln2.w"], spec.eps)
    a = F.silu(mm(prec, h, P[p + "mlp.gate"])) * mm(prec, h, P[p + "mlp.up"])
    return x + mm(prec, a, P[p + "mlp.down"])
