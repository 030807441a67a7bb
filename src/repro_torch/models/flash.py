"""Flash-semantics attention with its backward: kernel 11's forward
(`kernels/flash_attention.py`, `kernels/csrc/flash.cu`) under a
`torch.autograd.Function` whose backward is plain PyTorch.

`_flash_fwd_impl` is the reference's online softmax over KV chunks with
bfloat16 operands and float32 statistics; it returns (O, L = m + log l).
It is the reference's oracle of its Pallas kernel, kept here as the
oracle of the port's.

`attention(q, k, v, causal, bwd, kv_chunk)` is what the model calls when
it trains: the forward is kernel 11 with its log-sum-exp output on the
card (its plain version on the CPU), and the backward recomputes the
probabilities per KV chunk from that log-sum-exp, never storing an S x T
tensor.  The reference computes two different gradients, and `bwd`
chooses between them as the configuration's `attn_impl` does there:

- "flash": `_flash_bwd`, the reference's hand-written backward
  (`repro/models/flash.py:_flash_bwd`), its arithmetic as written: P, dS,
  the scaled q and dO are rounded to bfloat16 whatever the input dtype,
  the products accumulate in float32;
- "exact": the gradient the reference's autodiff takes of its float32
  blockwise forward (`attn_impl="blockwise"`, and every cross-attention
  and encoder layer), the same chunk loop in float32 with no rounding.

One loop (`_backward`) computes both; they differ only in the rounding
function it is given.

Both take a ragged last chunk (T no multiple of kv_chunk), as the
forward does; the reference's `_flash_bwd` is reached only where T is a
multiple.  The reference's backward is XLA, not Pallas, so the port's is
plain PyTorch by design; making it a kernel is performance work.
"""

from __future__ import annotations

import functools
import math

import torch

from ..kernels import ops

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


def _r16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _backward(rnd, kv_chunk: int, causal: bool, res, d_o):
    """The backward of `_flash_fwd_impl`, with `rnd` applied where the
    reference's `_flash_bwd` rounds to bfloat16.  res = (q (B,S,H,hd), k,
    v (B,T,KV,hd), q_positions (B,S), o (B,S,H,hd), lse (B,S,KV,G)); d_o
    like o.  Returns (dq, dk, dv) in q's, k's and v's dtypes.  Per KV
    chunk, with the scaled q, dO, O and the chunk's k and v taken through
    `rnd`, and P = rnd(exp(s - lse)) zero where the mask hides a key: dV =
    P^T dO, dP = dO V^T, dS = rnd(P (dP - delta)), dQ += dS K, dK = dS^T Q,
    where delta = rowsum(dO O); products accumulate in float32.  A ragged
    last chunk is taken as it is."""
    q, k, v, q_positions, o, lse = res
    b, s, h, hd = q.shape
    qg, k, v, n_kv, g = _grouped(q, k, v)
    t = k.shape[1]
    kv_chunk = min(kv_chunk, t)
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32,
                         device=q.device)
    qs = rnd(rnd(qg.float()) * rnd(scale))
    d_og = rnd(d_o.reshape(b, s, n_kv, g, hd).float())
    og = rnd(o.reshape(b, s, n_kv, g, hd).float())
    delta = torch.einsum("bsgxd,bsgxd->bsgx", d_og, og)
    dq = torch.zeros((b, s, n_kv, g, hd), dtype=torch.float32,
                     device=q.device)
    dks, dvs = [], []
    for start in range(0, t, kv_chunk):
        kb = rnd(k[:, start:start + kv_chunk].float())
        vb = rnd(v[:, start:start + kv_chunk].float())
        s_blk = torch.einsum("bsgxd,bcgd->bsgxc", qs, kb)
        p = rnd(torch.exp(s_blk - lse[..., None]))       # true probs
        if causal:
            kpos = start + torch.arange(kb.shape[1], device=q.device)
            mask = kpos[None, None, None, None, :] \
                <= q_positions[:, :, None, None, None]
            p = torch.where(mask, p, 0.0)
        dvs.append(torch.einsum("bsgxc,bsgxd->bcgd", p, d_og))
        dp = torch.einsum("bsgxd,bcgd->bsgxc", d_og, vb)
        ds = rnd(p * (dp - delta[..., None]))
        dq = dq + torch.einsum("bsgxc,bcgd->bsgxd", ds, kb)
        dks.append(torch.einsum("bsgxc,bsgxd->bcgd", ds, qs))
    dq = (dq * (1.0 / math.sqrt(hd))).reshape(b, s, h, hd).to(q.dtype)
    dk = torch.cat(dks, 1).to(k.dtype)
    dv = torch.cat(dvs, 1).to(v.dtype)
    return dq, dk, dv


# "flash": the reference's hand-written `_flash_bwd`, rounding to bfloat16
# as written; "exact": the float32 gradient its autodiff takes of the
# blockwise forward, nothing rounded.
_flash_bwd = functools.partial(_backward, _r16)
_exact_bwd = functools.partial(_backward, _same)


BACKWARDS = {"flash": _flash_bwd, "exact": _exact_bwd}


class FlashAttention(torch.autograd.Function):
    """Kernel 11 forward, `BACKWARDS[bwd]` backward.  q (B,S,H,hd), k, v
    (B,T,KV,hd) in the model's layout; the kernel sees them transposed,
    without a copy, and its (B,H,S) log-sum-exp is saved in the
    reference's (B,S,KV,G) layout.  The causal mask is by sequence index
    (every query row's position is its index, as the model's are)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, bwd: str, kv_chunk: int):
        o, lse = ops.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), causal,
                                         return_lse=True)
        o = o.transpose(1, 2)
        b, s, h, _ = q.shape
        n_kv = k.shape[2]
        lse = lse.transpose(1, 2).reshape(b, s, n_kv, h // n_kv)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.bwd, ctx.kv_chunk = causal, bwd, kv_chunk
        return o

    @staticmethod
    def backward(ctx, d_o):
        q, k, v, o, lse = ctx.saved_tensors
        b, s = q.shape[:2]
        positions = torch.arange(s, device=q.device)[None].expand(b, s)
        dq, dk, dv = BACKWARDS[ctx.bwd](ctx.kv_chunk, ctx.causal,
                                        (q, k, v, positions, o, lse), d_o)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, bwd: str = "exact", kv_chunk: int = 1024
              ) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v through kernel 11, q (B,S,H,hd), k, v
    (B,T,KV,hd), output in q's layout and dtype.  Where autograd records
    (grad mode on and an input that requires grad) it goes through
    `FlashAttention` with backward `bwd` ("exact" or "flash"); else it is
    the kernel's call alone, with no log-sum-exp written."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, bwd, kv_chunk)
    return ops.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal).transpose(1, 2)
