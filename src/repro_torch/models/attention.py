"""GQA self-attention (RoPE, optional QKV bias): prefill, training and
decode, for every `dense` layer and the `hybrid` family's shared block;
and cross-attention, for the `vlm` family's gated cross layers and the
`encdec` decoder's.

Prefill and training run attention through `models/flash.attention`:
kernel 11 (`kernels/csrc/flash.cu`) on the card, its plain masked
softmax on the CPU, with a plain-torch backward when autograd records
(`models/flash.py`).  `attention_route` follows the reference's choice:
`attn_impl="flash"` takes the reference's hand-written backward,
otherwise the exact float32 one; `attn_scores_dtype="bf16"` (where
`attn_impl` is not "flash") runs the reference's blockwise loop with
bfloat16 scores in plain torch, since the TPU kernel has no such option.
Self-attention is causal (Whisper's encoder calls it with
`causal=False`); cross-attention (`cross_attention`) is non-causal, S
queries against the T rows of its source, S != T, with no RoPE, the
reference's `_blockwise_attention(..., causal=False)`, whose gradient is
the exact one.  Neither
repeats k/v heads: the kernel reads kv head h // (H // KV) for query head
h, and the plain version groups the queries by kv head, as the reference
does.  `_blockwise_attention` is the reference's route (an online softmax
over KV chunks in plain torch) and the port's oracle for it.  Decode
attends one query against the KV cache with a length mask, in plain
torch, writing the new k/v into the preallocated cache in place; decode's
cross-attention (`cross_attention_cached`) reads the k/v that prefill
computed once from the source (`cross_kv`), in float32.

Where a bfloat16 source meets float32 weights or the reverse, the
projections compute in the promoted dtype (`common.matmul`), as JAX's
`@` does.

MLA (Multi-head Latent Attention, DeepSeek-V2) is plain torch, as the
reference's is plain JAX (it reaches no Pallas kernel): the prefill
decompresses K and V per KV chunk inside its online-softmax loop, so the
full (S, H, nope + v) tensors never exist, and the decode scores the
query against the compressed cache (c_kv, k_rope) with W_uk absorbed
into the query and W_uv applied after the weighting.  Its RoPE angle base
is `MLAConfig.rope_theta`, 10000.0 unless a configuration says otherwise
(Moonlight-16B-A3B: 50000.0), whatever the config's `rope_theta`, as in
the reference.  A prefill or training pass of MLA runs inside the span
`attn.mla` (`spans.py`).
`quantize_kv` and `decode_attention_q8` are the int8 KV cache
(`kv_cache_quant`), plain torch as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..spans import span
from . import flash as fl
from .common import (_param, apply_rope, dense_init, matmul, named_scope,
                     rmsnorm)

NEG_INF = -1e30


class GQA(nn.Module):
    """`gqa_init`'s parameters: wq (d, H*hd), wk, wv (d, KV*hd), wo
    (H*hd, d), and zero biases bq, bk, bv with `qkv_bias`."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 qkv_bias: bool = False, dtype=torch.bfloat16, device=None,
                 generator=None):
        super().__init__()

        def mk(i, o):
            return _param(dense_init(i, o, dtype, device, generator))

        self.wq = mk(d_model, n_heads * head_dim)
        self.wk = mk(d_model, n_kv * head_dim)
        self.wv = mk(d_model, n_kv * head_dim)
        self.wo = mk(n_heads * head_dim, d_model)
        self.qkv_bias = qkv_bias
        if qkv_bias:
            for nm, width in (("bq", n_heads * head_dim),
                              ("bk", n_kv * head_dim),
                              ("bv", n_kv * head_dim)):
                setattr(self, nm, _param(torch.zeros(width, dtype=dtype,
                                                     device=device)))


def _project_qkv(p: GQA, x: torch.Tensor, n_heads: int, n_kv: int,
                 head_dim: int):
    b, s, _ = x.shape
    q = matmul(x, p.wq)
    k = matmul(x, p.wk)
    v = matmul(x, p.wv)
    if p.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    return (q.reshape(b, s, n_heads, head_dim),
            k.reshape(b, s, n_kv, head_dim),
            v.reshape(b, s, n_kv, head_dim))


def _blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_positions: torch.Tensor, kv_chunk: int,
                         causal: bool, kv_offset: int = 0,
                         scores_dtype: str = "f32") -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,T,KV,hd).  Online softmax over KV chunks.
    With the reference's default `scores_dtype="f32"` everything is
    float32; with "bf16" the scaled q, the scores and the probabilities
    are bfloat16 (each product summed in float32 and rounded once, the
    masked score the bfloat16 of -1e30, exp(s - m) taken on bfloat16
    operands), and m, l and the output accumulator stay float32, as the
    reference's variant computes them.  Plain torch, so autograd
    differentiates it as the reference's autodiff does."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    n_kv = k.shape[2]
    g = h // n_kv
    bf16 = scores_dtype == "bf16"
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, s, n_kv, g, hd).float() * scale
    if bf16:
        qg = qg.to(torch.bfloat16).float()

    kv_chunk = min(kv_chunk, t)
    t_orig = t
    if t % kv_chunk != 0:
        pad = kv_chunk - t % kv_chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        t = t + pad
    n_chunks = t // kv_chunk
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)

    m = torch.full((b, s, n_kv, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, s, n_kv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s, n_kv, g, hd), dtype=torch.float32,
                      device=q.device)
    if bf16:
        # -1e30 as the reference's bfloat16 constant
        neg = neg.to(torch.bfloat16).float()
    for idx in range(n_chunks):
        kb = k[:, idx * kv_chunk:(idx + 1) * kv_chunk].float()
        vb = v[:, idx * kv_chunk:(idx + 1) * kv_chunk].float()
        if bf16:
            kb, vb = (x.to(torch.bfloat16).float() for x in (kb, vb))
        kpos = idx * kv_chunk + torch.arange(kv_chunk, device=q.device) \
            + kv_offset
        scores = torch.einsum("bsgxd,bcgd->bsgxc", qg, kb)
        if bf16:
            scores = scores.to(torch.bfloat16).float()
        if causal:
            mask = kpos[None, None, None, None, :] \
                <= q_positions[:, :, None, None, None]
            scores = torch.where(mask, scores, neg)
        if t != t_orig:  # mask KV padding (non-multiple chunk lengths)
            valid = (kpos < t_orig)[None, None, None, None, :]
            scores = torch.where(valid, scores, neg)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        if bf16:
            # exp of bfloat16 operands, the result bfloat16
            x = (scores.to(torch.bfloat16)
                 - m_new[..., None].to(torch.bfloat16))
            p = torch.exp(x.float()).to(torch.bfloat16).float()
        else:
            p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bsgxc,bcgd->bsgxd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, s, h, hd).to(q.dtype)


def attention_route(impl: str, scores_dtype: str, t: int,
                    kv_chunk: int) -> str:
    """The reference's choice in `_self_attention`, with the port's names:
    "flash" (kernel 11, `_flash_bwd` backward) for `impl="flash"` where T
    is a multiple of min(kv_chunk, T); else "bf16" (the plain blockwise
    route with bfloat16 scores) for `scores_dtype="bf16"`, which the TPU
    kernel has no option for; else "exact" (kernel 11, the float32
    blockwise gradient)."""
    if impl == "flash" and t % min(kv_chunk, t) == 0:
        return "flash"
    return "bf16" if scores_dtype == "bf16" else "exact"


@named_scope("attention")
def self_attention(p: GQA, x: torch.Tensor, positions: torch.Tensor,
                   n_heads: int, n_kv: int, head_dim: int, rope_theta: float,
                   causal: bool = True, return_kv: bool = False,
                   kv_chunk: int = 1024, scores_dtype: str = "f32",
                   impl: str = "blockwise"):
    """Full-sequence self-attention (prefill and training), causal unless
    `causal` is False (Whisper's encoder).  x: (B,S,D); positions: (B,S),
    the same row for every batch entry (the causal mask is by sequence
    index).  With `return_kv`, also (k after RoPE, v), each (B,S,KV,hd),
    as the reference caches them.  `attention_route` picks the route from
    `impl`, `scores_dtype` and `kv_chunk` as the reference does: kernel
    11 (which tiles on its own; `kv_chunk` is the backward's chunk), or
    the plain blockwise loop for bf16 scores."""
    b, s, d = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim)
    if rope_theta > 0:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    route = attention_route(impl, scores_dtype, k.shape[1], kv_chunk)
    if route == "bf16":
        out = _blockwise_attention(q, k, v, positions, kv_chunk, causal,
                                   scores_dtype="bf16")
    else:
        # (B,S,H,hd) seen as (B,H,S,hd), k and v as (B,KV,T,hd): the kernel
        # reads the strides and groups the query heads by kv head, and its
        # output comes back in q's layout, so nothing is copied or repeated
        out = fl.attention(q, k, v, causal, route, kv_chunk)
    y = out.reshape(b, s, n_heads * head_dim) @ p.wo
    if return_kv:
        return y, (k, v)
    return y


@named_scope("attention")
def decode_attention(p: GQA, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cur_len: int, n_heads: int,
                     n_kv: int, head_dim: int, rope_theta: float):
    """One-token decode: x (B,1,D); cache (B,Smax,KV,hd); cur_len = number
    of valid cache entries.  Returns the attention output (B,1,D).  The
    new token's k (after RoPE) and v are written into the caches at
    position cur_len IN PLACE (the reference returns updated copies).

    The cache is read at its storage dtype with float32 products and
    sums, as the reference's dots accumulate in float32."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim)
    pos = torch.full((b, 1), cur_len, dtype=torch.int32, device=x.device)
    if rope_theta > 0:
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    cache_k[:, cur_len:cur_len + 1] = k.to(cache_k.dtype)
    cache_v[:, cur_len:cur_len + 1] = v.to(cache_v.dtype)
    t = cache_k.shape[1]
    g = n_heads // n_kv
    scale = 1.0 / math.sqrt(head_dim)
    qg = (q.reshape(b, n_kv, g, head_dim).float() * scale) \
        .to(cache_k.dtype).float()
    scores = torch.einsum("bgxd,btgd->bgxt", qg, cache_k.float())
    mask = torch.arange(t, device=x.device)[None, None, None, :] <= cur_len
    scores = torch.where(mask, scores,
                         torch.tensor(NEG_INF, device=x.device))
    w = torch.softmax(scores, dim=-1).to(cache_v.dtype).float()
    out = torch.einsum("bgxt,btgd->bgxd", w, cache_v.float())
    return out.reshape(b, 1, n_heads * head_dim).to(x.dtype) @ p.wo


# -- int8-quantized KV cache (`kv_cache_quant`) ------------------------------
#
# K and V quantize symmetrically per (token, kv head) to int8 when prefill
# writes them and when decode appends; the scores factor exactly as
# (q . k_q) * k_scale, so the cache is read as int8 plus one bfloat16 scale
# a row: half the bytes of the bfloat16 cache.

def quantize_kv(x: torch.Tensor):
    """x: (..., hd) -> (int8 values, bfloat16 per-(...) scales): scale =
    max(|x|) / 127 over hd (at least 1e-8), values round(x / scale)
    clipped to [-127, 127], in float32 as the reference computes them."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    sc = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / sc), -127, 127).to(torch.int8)
    return q, sc[..., 0].to(torch.bfloat16)


@named_scope("attention")
def decode_attention_q8(p: GQA, x: torch.Tensor, cache_k: torch.Tensor,
                        k_scale: torch.Tensor, cache_v: torch.Tensor,
                        v_scale: torch.Tensor, cur_len: int, n_heads: int,
                        n_kv: int, head_dim: int, rope_theta: float):
    """Decode against the int8 cache: cache_k / cache_v (B,Smax,KV,hd)
    int8, k_scale / v_scale (B,Smax,KV) bfloat16.  The token's quantized k
    (after RoPE) and v and their scales are written at cur_len IN PLACE
    (the reference returns updated copies).  The reference's arithmetic:
    the scaled q rounded to bfloat16, raw = q . k_q in float32, scores =
    raw * k_scale, a float32 softmax over the valid rows, the weights
    times v_scale rounded to bfloat16 against v_q, summed in float32.
    Returns the attention output (B,1,D)."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim)
    pos = torch.full((b, 1), cur_len, dtype=torch.int32, device=x.device)
    if rope_theta > 0:
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    cache_k[:, cur_len:cur_len + 1] = kq
    k_scale[:, cur_len:cur_len + 1] = ks
    cache_v[:, cur_len:cur_len + 1] = vq
    v_scale[:, cur_len:cur_len + 1] = vs
    t = cache_k.shape[1]
    g = n_heads // n_kv
    scale = 1.0 / math.sqrt(head_dim)
    qg = (q.reshape(b, n_kv, g, head_dim).float() * scale) \
        .to(torch.bfloat16).float()
    raw = torch.einsum("bgxd,btgd->bgxt", qg, cache_k.float())
    scores = raw * k_scale.transpose(1, 2)[:, :, None, :].float()
    mask = torch.arange(t, device=x.device)[None, None, None, :] <= cur_len
    scores = torch.where(mask, scores,
                         torch.tensor(NEG_INF, device=x.device))
    w = torch.softmax(scores, dim=-1)
    wv = (w * v_scale.transpose(1, 2)[:, :, None, :].float()) \
        .to(torch.bfloat16).float()
    out = torch.einsum("bgxt,btgd->bgxd", wv, cache_v.float())
    return out.reshape(b, 1, n_heads * head_dim).to(x.dtype) @ p.wo


# ---------------------------------------------------------------------------
# Cross-attention (the vlm family's image layers, the encdec decoder's)
# ---------------------------------------------------------------------------

def cross_kv(p: GQA, kv_src: torch.Tensor, n_kv: int, head_dim: int):
    """k, v (B,T,KV,hd) of the source kv_src (B,T,D): no bias, no RoPE,
    in the promoted dtype of the source and the weights."""
    b, t, _ = kv_src.shape
    k = matmul(kv_src, p.wk).reshape(b, t, n_kv, head_dim)
    v = matmul(kv_src, p.wv).reshape(b, t, n_kv, head_dim)
    return k, v


# the reference's `cross_attention` chunks its blockwise route by 512
CROSS_KV_CHUNK = 512


def cross_attention(p: GQA, x: torch.Tensor, kv_src: torch.Tensor,
                    n_heads: int, n_kv: int, head_dim: int,
                    return_kv: bool = False):
    """x: (B,S,D) queries; kv_src: (B,T,D) encoder or image states.  The
    S queries attend to all T rows (no mask) through kernel 11, q, k and v
    in their promoted dtype, the output cast back to q's dtype, as the
    reference's `_blockwise_attention` returns it.  With `return_kv`, also
    `cross_kv`'s (k, v), what decode caches."""
    b, s, _ = x.shape
    q = matmul(x, p.wq).reshape(b, s, n_heads, head_dim)
    k, v = cross_kv(p, kv_src, n_kv, head_dim)
    dt = torch.promote_types(q.dtype, k.dtype)
    # the reference's blockwise route (chunks of min(512, T)): its
    # gradient is the exact one
    out = fl.attention(q.to(dt), k.to(dt), v.to(dt), False, "exact",
                       min(CROSS_KV_CHUNK, kv_src.shape[1]))
    y = matmul(out.reshape(b, s, n_heads * head_dim).to(q.dtype), p.wo)
    if return_kv:
        return y, (k, v)
    return y


def cross_attention_cached(p: GQA, x: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, n_heads: int, n_kv: int,
                           head_dim: int) -> torch.Tensor:
    """Decode-time cross-attention of x (B,S,D) against the k, v
    (B,T,KV,hd) that prefill computed from the source.  The reference's
    arithmetic: q scaled in float32 and not rounded to the cache's dtype,
    k and v upcast, a float32 softmax over all T, the output cast to x's
    dtype before `wo`."""
    b, s, _ = x.shape
    q = matmul(x, p.wq).reshape(b, s, n_heads, head_dim)
    g = n_heads // n_kv
    scale = 1.0 / math.sqrt(head_dim)
    qg = q.reshape(b, s, n_kv, g, head_dim).float() * scale
    scores = torch.einsum("bsgxd,btgd->bsgxt", qg, k.float())
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bsgxt,btgd->bsgxd", w, v.float())
    return matmul(out.reshape(b, s, n_heads * head_dim).to(x.dtype), p.wo)


# ---------------------------------------------------------------------------
# MLA - Multi-head Latent Attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

MLA_ROPE_THETA = 10000.0


class MLA(nn.Module):
    """`mla_init`'s parameters: wq (d, H*(nope+rope)), wdkv (d, kv_lora),
    wkr (d, rope), wuk (kv_lora, H*nope), wuv (kv_lora, H*v), wo (H*v, d),
    and kv_norm (kv_lora,) float32 ones."""

    def __init__(self, d_model: int, n_heads: int, kv_lora: int,
                 nope_dim: int, rope_dim: int, v_dim: int,
                 dtype=torch.bfloat16, device=None, generator=None):
        super().__init__()

        def mk(i, o):
            return _param(dense_init(i, o, dtype, device, generator))

        self.wq = mk(d_model, n_heads * (nope_dim + rope_dim))
        self.wdkv = mk(d_model, kv_lora)
        self.wkr = mk(d_model, rope_dim)
        self.wuk = mk(kv_lora, n_heads * nope_dim)
        self.wuv = mk(kv_lora, n_heads * v_dim)
        self.wo = mk(n_heads * v_dim, d_model)
        self.kv_norm = _param(torch.ones(kv_lora, dtype=torch.float32,
                                         device=device))


def _mla_qkv(p: MLA, x: torch.Tensor, positions: torch.Tensor,
             n_heads: int, nope_dim: int, rope_dim: int,
             rope_theta: float = MLA_ROPE_THETA):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope), c_kv (B,S,kv_lora),
    k_rope (B,S,1,rope)), RoPE at base `rope_theta` applied, all in x's
    dtype."""
    b, s, _ = x.shape
    q = (x @ p.wq).reshape(b, s, n_heads, nope_dim + rope_dim)
    q_nope, q_rope = q[..., :nope_dim], q[..., nope_dim:]
    q_rope = apply_rope(q_rope, positions, rope_theta)
    c_kv = rmsnorm(x @ p.wdkv, p.kv_norm)
    k_rope = (x @ p.wkr).reshape(b, s, 1, rope_dim)
    k_rope = apply_rope(k_rope, positions, rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def mla_attention(p: MLA, x: torch.Tensor, positions: torch.Tensor,
                  n_heads: int, nope_dim: int, rope_dim: int, v_dim: int,
                  kv_chunk: int = 1024, return_kv: bool = False,
                  rope_theta: float = MLA_ROPE_THETA):
    """Prefill MLA, causal.  x: (B,S,D); positions (B,S).  K and V are
    decompressed per KV chunk inside the online-softmax loop, so full
    (S, H, nope + v) tensors never exist.  The reference asserts S % kv_chunk
    == 0 (after kv_chunk = min(kv_chunk, S)); the port takes a shorter
    last chunk instead, which changes nothing where the reference runs.
    With `return_kv`, also (c_kv (B,S,kv_lora), k_rope (B,S,rope)), what
    the decode caches."""
    with span("attn.mla"):
        b, s, _ = x.shape
        q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, positions, n_heads,
                                                nope_dim, rope_dim, rope_theta)
        scale = 1.0 / math.sqrt(nope_dim + rope_dim)
        kv_chunk = min(kv_chunk, s)
        wuk = p.wuk.reshape(-1, n_heads, nope_dim)
        wuv = p.wuv.reshape(-1, n_heads, v_dim)
        qn = q_nope.float() * scale
        qr = q_rope.float() * scale
        # filled on the device: a tensor of a Python number is copied from
        # the host, and that copy waits for the device
        neg = torch.full((), NEG_INF, dtype=torch.float32, device=x.device)

        m = torch.full((b, s, n_heads), NEG_INF, dtype=torch.float32,
                       device=x.device)
        l = torch.zeros((b, s, n_heads), dtype=torch.float32, device=x.device)
        acc = torch.zeros((b, s, n_heads, v_dim), dtype=torch.float32,
                          device=x.device)
        for start in range(0, s, kv_chunk):
            ckv = c_kv[:, start:start + kv_chunk]
            kr = k_rope[:, start:start + kv_chunk, 0]
            kpos = start + torch.arange(ckv.shape[1], device=x.device)
            k_nope = torch.einsum("bcl,lhd->bchd", ckv, wuk)     # decompress K
            v = torch.einsum("bcl,lhv->bchv", ckv, wuv)          # decompress V
            sc = torch.einsum("bshd,bchd->bshc", qn, k_nope.float())
            sc = sc + torch.einsum("bshr,bcr->bshc", qr, kr.float())
            mask = kpos[None, None, None, :] <= positions[:, :, None, None]
            sc = torch.where(mask, sc, neg)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            pr = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pr.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bshc,bchv->bshv", pr,
                                                       v.float())
            m = m_new
        out = (acc / torch.clamp(l[..., None], min=1e-30)).to(x.dtype)
        y = out.reshape(b, s, n_heads * v_dim) @ p.wo
        if return_kv:
            return y, (c_kv, k_rope[:, :, 0, :])
        return y


def mla_decode(p: MLA, x: torch.Tensor, cache_ckv: torch.Tensor,
               cache_kr: torch.Tensor, cur_len: int, n_heads: int,
               nope_dim: int, rope_dim: int, v_dim: int,
               rope_theta: float = MLA_ROPE_THETA) -> torch.Tensor:
    """One-token MLA decode against the compressed cache (cache_ckv
    (B,Smax,kv_lora), cache_kr (B,Smax,rope)); the token's c_kv and k_rope
    are written at cur_len IN PLACE.  Scores take W_uk into the query
    (q_nope W_uk^T against c_kv) and the weighted c_kv goes through W_uv
    after the softmax, in float32, as the reference computes them.
    Returns the attention output (B,1,D)."""
    b = x.shape[0]
    pos = torch.full((b, 1), cur_len, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, pos, n_heads, nope_dim,
                                            rope_dim, rope_theta)
    cache_ckv[:, cur_len:cur_len + 1] = c_kv.to(cache_ckv.dtype)
    cache_kr[:, cur_len:cur_len + 1] = k_rope[:, :, 0].to(cache_kr.dtype)
    t = cache_ckv.shape[1]
    scale = 1.0 / math.sqrt(nope_dim + rope_dim)
    wuk = p.wuk.reshape(-1, n_heads, nope_dim).float()
    wuv = p.wuv.reshape(-1, n_heads, v_dim).float()
    ckv = cache_ckv.float()
    q_abs = torch.einsum("bshd,lhd->bshl", q_nope.float(), wuk)
    sc = torch.einsum("bshl,btl->bsht", q_abs, ckv) * scale
    sc = sc + torch.einsum("bshr,btr->bsht", q_rope.float() * scale,
                           cache_kr.float())
    mask = torch.arange(t, device=x.device)[None, None, None, :] <= cur_len
    sc = torch.where(mask, sc, torch.full((), NEG_INF, device=x.device))
    w = torch.softmax(sc, dim=-1)
    ctx = torch.einsum("bsht,btl->bshl", w, ckv)
    out = torch.einsum("bshl,lhv->bshv", ctx, wuv)
    return out.reshape(b, 1, n_heads * v_dim).to(x.dtype) @ p.wo
