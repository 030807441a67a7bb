"""Flash-semantics attention, forward: the model-level plain form of the
flash kernel (`kernels/flash_attention.py`, `kernels/csrc/flash.cu`).

`_flash_fwd_impl` is the reference's online softmax over KV chunks with
bfloat16 operands and float32 statistics; it returns (O, L = m + log l).
The hand-written backward (the reference's `custom_vjp`) comes with
training, as a `torch.autograd.Function` (ROADMAP A.5).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _grouped(q, k, v):
    b, s, h, hd = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    return q.reshape(b, s, n_kv, g, hd), k, v, n_kv, g


def _flash_fwd_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, kv_chunk: int, causal: bool):
    """q: (B,S,H,hd); k,v: (B,T,KV,hd); q_positions (B,S).  Returns
    (o (B,S,H,hd) in q's dtype, lse (B,S,KV,G) float32)."""
    b, s, h, hd = q.shape
    qg, k, v, n_kv, g = _grouped(q, k, v)
    t = k.shape[1]
    kv_chunk = min(kv_chunk, t)
    if t % kv_chunk != 0:
        raise ValueError(f"T={t} is not a multiple of kv_chunk={kv_chunk}")
    n_chunks = t // kv_chunk
    bf16 = torch.bfloat16
    scale = torch.tensor(1.0 / (hd ** 0.5), dtype=bf16)
    qs = (qg.to(bf16) * scale.to(q.device)).float()
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)

    m = torch.full((b, s, n_kv, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, s, n_kv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s, n_kv, g, hd), dtype=torch.float32,
                      device=q.device)
    for idx in range(n_chunks):
        kb = k[:, idx * kv_chunk:(idx + 1) * kv_chunk].to(bf16).float()
        vb = v[:, idx * kv_chunk:(idx + 1) * kv_chunk].to(bf16).float()
        kpos = idx * kv_chunk + torch.arange(kv_chunk, device=q.device)
        s_blk = torch.einsum("bsgxd,bcgd->bsgxc", qs, kb)
        if causal:
            mask = kpos[None, None, None, None, :] \
                <= q_positions[:, :, None, None, None]
            s_blk = torch.where(mask, s_blk, neg)
        m_new = torch.maximum(m, s_blk.amax(dim=-1))
        p = torch.exp(s_blk - m_new[..., None]).to(bf16).float()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bsgxc,bcgd->bsgxd", p, vb)
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    o = (acc / l_safe[..., None]).reshape(b, s, h, hd).to(q.dtype)
    lse = m + torch.log(l_safe)
    return o, lse
