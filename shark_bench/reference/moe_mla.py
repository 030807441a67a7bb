"""The plain reference's block of family "moe_mla" (DeepSeek-V3,
arXiv:2412.19437 §2.1; Moonlight-16B-A3B): per layer x += MLA(RMSNorm(x)),
x += FFN(RMSNorm(x)), the FFN a dense SwiGLU MLP in the leading dense layer
and a MoE layer after it.  In float32; `prec` as `lm.py` says.

MLA: q = h Wq, split per head into a no-RoPE and a RoPE part; the latent
c = RMSNorm(h Wdkv); K's no-RoPE part c Wuk and V = c Wuv per head; one
RoPE key h Wkr shared by the heads.  RoPE rotates by halves at the
configuration's base; causal softmax scaled by 1/sqrt(no-RoPE + RoPE).
Queries go in blocks, each recomputed in the backward, so that the scores
of one block exist at a time.

MoE: the router's sigmoid scores s over every expert; each token's top k
experts by s + b, b the selection bias, which enters the choice alone (no
gradient trains it: it is added to the output times 0, so that it stays a
leaf of the loss's graph with a zero gradient); the weights the k chosen
scores over their sum plus 1e-20, times the routed scale.  The layer
computes the held experts' part alone (experts [offset, offset + held)):
each held expert's SwiGLU over the tokens that chose it, weighted, added in
expert order; the absent experts' part is left out, as on the chip.  The
shared experts are one SwiGLU MLP over every token.

It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from shark_bench.reference.dense import rope
from shark_bench.reference.lm import Params, mm, rmsnorm


def _attend(prec, q, k, v, start: int):
    """Causal softmax attention of the query rows [start, start + r):
    q (B, H, r, dq), k (B, H, S, dq), v (B, H, S, dv)."""
    scores = prec.act(q) @ prec.act(k).transpose(-1, -2) \
        / math.sqrt(q.shape[-1])
    rows = torch.arange(start, start + q.shape[2], device=q.device)
    mask = torch.arange(k.shape[2], device=q.device)[None, :] <= rows[:, None]
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return prec.act(p) @ prec.act(v)


def mla(spec, prec, P: Params, p: str, h, q_block: int = 1024):
    """The attention output (B, S, D) of layer `p` over the normed h."""
    z = spec.sizes
    b, s, _ = h.shape
    nh = z.n_heads
    q = mm(prec, h, P[p + "attn.wq"]).reshape(b, s, nh, z.qk_dim)
    q = torch.cat([q[..., :z.nope_dim],
                   rope(q[..., z.nope_dim:], z.rope_theta)], dim=-1)
    c = rmsnorm(mm(prec, h, P[p + "attn.wdkv"]), P[p + "attn.kv_norm"],
                spec.eps)
    k_rope = rope(mm(prec, h, P[p + "attn.wkr"]).reshape(b, s, 1, -1),
                  z.rope_theta)
    k = torch.cat([mm(prec, c, P[p + "attn.wuk"]).reshape(b, s, nh, -1),
                   k_rope.expand(b, s, nh, z.rope_dim)], dim=-1)
    v = mm(prec, c, P[p + "attn.wuv"]).reshape(b, s, nh, z.v_dim)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))          # (B, H, S, .)
    outs = []
    for start in range(0, s, q_block):
        qb = q[:, :, start:start + q_block]
        if torch.is_grad_enabled():
            outs.append(torch.utils.checkpoint.checkpoint(
                _attend, prec, qb, k, v, start, use_reentrant=False))
        else:
            outs.append(_attend(prec, qb, k, v, start))
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, nh * z.v_dim)
    return mm(prec, o, P[p + "attn.wo"])


def swiglu(prec, x, gate, up, down):
    return mm(prec, F.silu(mm(prec, x, gate)) * mm(prec, x, up), down)


def route(spec, prec, P: Params, p: str, x):
    """(the chosen experts (T, k), their weights (T, k)) of tokens x (T, D)."""
    z = spec.sizes
    s = torch.sigmoid(mm(prec, x, P[p + "moe.router"]))
    choice = (s + P[p + "moe.select_bias"]).detach()
    idx = torch.sort(choice, dim=-1, descending=True,
                     stable=True).indices[:, :z.top_k]
    w = torch.gather(s, 1, idx)
    return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * z.routed_scale


def moe(spec, prec, P: Params, p: str, h):
    """The MoE layer's output over the normed h (B, S, D): the held
    experts' part and the shared experts."""
    z = spec.sizes
    b, s, d = h.shape
    x = h.reshape(b * s, d)
    idx, w = route(spec, prec, P, p, x)
    y = torch.zeros_like(x)
    for j in range(z.held):
        tok, slot = (idx == z.offset + j).nonzero(as_tuple=True)
        ye = swiglu(prec, x[tok], P[p + "moe.w_gate"][j],
                    P[p + "moe.w_up"][j], P[p + "moe.w_down"][j])
        y = y.index_add(0, tok, ye * w[tok, slot, None])
    y = y + swiglu(prec, x, P[p + "moe.shared_gate"], P[p + "moe.shared_up"],
                   P[p + "moe.shared_down"])
    return (y + 0.0 * P[p + "moe.select_bias"].sum()).reshape(b, s, d)


def block(spec, prec, P: Params, i: int, x):
    """Layer i: x += MLA(RMSNorm(x)), x += MLP or MoE(RMSNorm(x))."""
    z = spec.sizes
    p = "layer0." if i < z.first_dense else f"layers.{i - z.first_dense}."
    x = x + mla(spec, prec, P, p, rmsnorm(x, P[p + "ln1.w"], spec.eps))
    h = rmsnorm(x, P[p + "ln2.w"], spec.eps)
    if i < z.first_dense:
        return x + swiglu(prec, h, P[p + "mlp.gate"], P[p + "mlp.up"],
                          P[p + "mlp.down"])
    return x + moe(spec, prec, P, p, h)
