"""Architecture assembly for the families the port runs:

  dense  — a stack of [norm -> GQA -> residual, norm -> MLP -> residual]
           blocks (Phi3-medium-14b, Yi-9B, Qwen2.5-3b, StarCoder2-15b)
  ssm    — a stack of Mamba2 (SSD) blocks (Mamba2-370m)
  hybrid — groups of [1 SHARED attention slot + k Mamba2 blocks], then a
           tail of Mamba2 blocks (Zamba2-7B)

The `moe`, `vlm` and `encdec` families raise `NotImplementedError` when a
model is built (ROADMAP A.5), and so does a dense configuration that asks
for what the port does not compute yet: the int8 KV cache
(`kv_cache_quant`) or scores in another dtype than float32
(`attn_scores_dtype`).  `attn_impl` and `attn_chunk_remat` choose the
reference's route or backward, not the forward's function, and are not
read.

The reference stacks each family's layers on a leading axis and runs them
under `lax.scan`; the port keeps one module per layer (`nn.ModuleList`,
`models/convert.py` unstacks a reference tree) and loops in Python.  The
shared attention block is ONE module used by every group, as in the
reference.  Sharding annotations (`act_shard`, `maybe_shard`) have no
meaning on one card and are left out.

Entry points: `build_model`, `prefill_fn` (full-sequence forward that
writes the caches, allocated at `max_seq`), `decode_fn` (one token against
the caches, updated in place).  On the card the prefill runs the two
hand-written kernels where the reference runs their oracles: every dense
layer's attention and the shared attention through `flash_attention_fwd`
(grouped-query, k/v never repeated), every Mamba2 block's SSD through
`ssd_scan`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.runtime import resolve_device
from . import attention as att
from . import mamba2 as m2
from .common import (MLP, Embed, Norm, _param, dense_init, embed_lookup,
                     mlp_apply, norm_apply)

Caches = Dict[str, torch.Tensor]
FAMILIES = ("dense", "ssm", "hybrid")


# ===========================================================================
# Parameters
# ===========================================================================

class DecoderLayer(nn.Module):
    """One dense block: {ln1, attn, ln2, mlp}, the reference's
    `_decoder_layer_init` names."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        self.ln1 = Norm(cfg.norm, cfg.d_model, device)
        self.attn = att.GQA(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                            cfg.qkv_bias, dtype, device, generator)
        self.ln2 = Norm(cfg.norm, cfg.d_model, device)
        self.mlp = MLP(cfg.mlp, cfg.d_model, cfg.d_ff, dtype, device,
                       generator)


class MambaLayer(nn.Module):
    """One residual Mamba2 slot: {ln, mamba}."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        self.ln = Norm(cfg.norm, cfg.d_model, device)
        self.mamba = m2.Mamba2(cfg.d_model, cfg.ssm, dtype, device,
                               generator)


class SharedAttention(nn.Module):
    """The hybrid family's one attention block: {ln, attn, ln2, mlp}."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        self.ln = Norm(cfg.norm, cfg.d_model, device)
        self.attn = att.GQA(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                            False, dtype, device, generator)
        self.ln2 = Norm(cfg.norm, cfg.d_model, device)
        self.mlp = MLP(cfg.mlp, cfg.d_model, cfg.d_ff, dtype, device,
                       generator)


def _hybrid_layout(cfg: ModelConfig):
    """(groups, Mamba2 blocks per group, tail blocks)."""
    per = cfg.attn_every  # group = 1 shared-attn slot + (per-1) mamba
    n_groups = cfg.n_layers // per
    return n_groups, per - 1, cfg.n_layers - n_groups * per


class LM(nn.Module):
    """`init_params`'s tree as modules: embed, final_norm, lm_head (unless
    tied), and layers (dense, ssm) or group_mamba / tail_mamba /
    shared_attn (hybrid).  Matrices and biases bfloat16, norms and SSM
    vectors float32."""

    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__()
        dtype = torch.bfloat16
        self.cfg = cfg
        self.embed = Embed(cfg.vocab, cfg.d_model, dtype, device, generator)
        self.final_norm = Norm(cfg.norm, cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param(dense_init(cfg.d_model, cfg.vocab, dtype,
                                             device, generator))

        def mamba_layers(n):
            return nn.ModuleList(MambaLayer(cfg, dtype, device, generator)
                                 for _ in range(n))

        if cfg.family == "dense":
            self.layers = nn.ModuleList(
                DecoderLayer(cfg, dtype, device, generator)
                for _ in range(cfg.n_layers))
        elif cfg.family == "ssm":
            self.layers = mamba_layers(cfg.n_layers)
        else:
            n_groups, n_group_mamba, n_tail = _hybrid_layout(cfg)
            self.group_mamba = nn.ModuleList(mamba_layers(n_group_mamba)
                                             for _ in range(n_groups))
            if n_tail:
                self.tail_mamba = mamba_layers(n_tail)
            self.shared_attn = SharedAttention(cfg, dtype, device, generator)


def check_ported(cfg: ModelConfig) -> None:
    """Raise `NotImplementedError` for what the port does not compute yet,
    rather than compute another function."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the port "
            f"runs {FAMILIES}; see ROADMAP A.5")
    if cfg.family != "dense":
        return
    if cfg.kv_cache_quant:
        raise NotImplementedError(
            f"{cfg.name}: the int8 KV cache (kv_cache_quant=True) is not "
            f"ported yet; see ROADMAP A.5")
    if cfg.attn_scores_dtype != "f32":
        raise NotImplementedError(
            f"{cfg.name}: attention scores in {cfg.attn_scores_dtype!r} are "
            f"not ported yet (the port computes them in float32); see "
            f"ROADMAP A.5")


def build_model(cfg: ModelConfig, device=None,
                generator: Optional[torch.Generator] = None) -> LM:
    """A model of `cfg` with the reference's init distributions, drawn on
    `device` (default: the card) from `generator` (default: seed 0 on that
    device)."""
    check_ported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        return LM(cfg, dev, generator)


# ===========================================================================
# Caches
# ===========================================================================

def _grow_caches(cfg: ModelConfig, b: int, max_seq: int, dtype,
                 device) -> Caches:
    """Zeroed caches sized to max_seq, for prefill to write into and
    decode to update in place: the attention k/v (L or G, B, max_seq, KV,
    hd) in the activation dtype, the SSM states (..., B, H, P, N) float32,
    the conv states (..., B, d_conv-1, conv_dim) in the activation
    dtype."""
    if cfg.family == "dense":
        kv = (cfg.n_layers, b, max_seq, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device)}
    s = cfg.ssm
    nh = s.n_heads(cfg.d_model)
    conv_dim = s.d_inner(cfg.d_model) + 2 * s.ngroups * s.d_state

    def ssm(*lead):
        return {"ssm": torch.zeros(lead + (b, nh, s.headdim, s.d_state),
                                   dtype=torch.float32, device=device),
                "conv": torch.zeros(lead + (b, s.d_conv - 1, conv_dim),
                                    dtype=dtype, device=device)}

    if cfg.family == "ssm":
        return ssm(cfg.n_layers)
    n_groups, n_group_mamba, n_tail = _hybrid_layout(cfg)
    kv = (n_groups, b, max_seq, cfg.n_kv_heads, cfg.hd)
    out = {"attn_k": torch.zeros(kv, dtype=dtype, device=device),
           "attn_v": torch.zeros(kv, dtype=dtype, device=device)}
    g = ssm(n_groups, n_group_mamba)
    out["group_ssm"], out["group_conv"] = g["ssm"], g["conv"]
    if n_tail:
        t = ssm(n_tail)
        out["tail_ssm"], out["tail_conv"] = t["ssm"], t["conv"]
    return out


def _store_states(caches: Caches, ssm_key: str, conv_key: str, idx,
                  state, conv_state) -> None:
    caches[ssm_key][idx].copy_(state)
    # a prompt shorter than d_conv - 1 fills only the last rows; the rows
    # before stay zero, the causal conv's own padding
    conv = caches[conv_key][idx]
    conv[:, conv.shape[1] - conv_state.shape[1]:].copy_(conv_state)


# ===========================================================================
# Full-sequence forward (prefill)
# ===========================================================================

def _attn_mlp_full(cfg: ModelConfig, ln_a: Norm, attn: att.GQA, ln_m: Norm,
                   mlp: MLP, x, positions, cache_k=None, cache_v=None):
    """norm -> GQA self-attention (kernel 11) -> residual, norm -> MLP ->
    residual; with caches (B, max_seq, KV, hd), k after RoPE and v are
    written into their first S rows."""
    h = norm_apply(cfg.norm, x, ln_a)
    if cache_k is None:
        a = att.self_attention(attn, h, positions, cfg.n_heads,
                               cfg.n_kv_heads, cfg.hd, cfg.rope_theta)
    else:
        a, (k, v) = att.self_attention(attn, h, positions, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.hd, cfg.rope_theta,
                                       return_kv=True)
        cache_k[:, :x.shape[1]] = k
        cache_v[:, :x.shape[1]] = v
    x = x + a
    h = norm_apply(cfg.norm, x, ln_m)
    return x + mlp_apply(cfg.mlp, mlp, h)


def _mamba_full(cfg: ModelConfig, lp: MambaLayer, x, caches, ssm_key,
                conv_key, idx):
    h = norm_apply(cfg.norm, x, lp.ln)
    if caches is None:
        return x + m2.mamba2_forward(lp.mamba, h, cfg.d_model, cfg.ssm)
    y, st, cst = m2.mamba2_forward(lp.mamba, h, cfg.d_model, cfg.ssm,
                                   return_state=True)
    _store_states(caches, ssm_key, conv_key, idx, st, cst)
    return x + y


def _hybrid_full(cfg: ModelConfig, model: LM, x, positions,
                 caches: Optional[Caches]):
    ap = model.shared_attn
    for gi, group in enumerate(model.group_mamba):
        # shared attention slot: the same parameters in every group
        kv = ((None, None) if caches is None
              else (caches["attn_k"][gi], caches["attn_v"][gi]))
        x = _attn_mlp_full(cfg, ap.ln, ap.attn, ap.ln2, ap.mlp, x,
                           positions, *kv)
        for li, lp in enumerate(group):
            x = _mamba_full(cfg, lp, x, caches, "group_ssm", "group_conv",
                            (gi, li))
    for li, lp in enumerate(getattr(model, "tail_mamba", ())):
        x = _mamba_full(cfg, lp, x, caches, "tail_ssm", "tail_conv", li)
    return x


@torch.no_grad()
def _backbone_full(cfg: ModelConfig, model: LM, tokens: torch.Tensor,
                   caches: Optional[Caches] = None) -> torch.Tensor:
    """Final hidden states (B,S,D) of tokens (B,S); with `caches` (from
    `_grow_caches`), every layer's cache entries are written into them."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    x = embed_lookup(model.embed, tokens)
    if cfg.family == "dense":
        for i, lp in enumerate(model.layers):
            kv = ((None, None) if caches is None
                  else (caches["k"][i], caches["v"][i]))
            x = _attn_mlp_full(cfg, lp.ln1, lp.attn, lp.ln2, lp.mlp, x,
                               positions, *kv)
    elif cfg.family == "ssm":
        for i, lp in enumerate(model.layers):
            x = _mamba_full(cfg, lp, x, caches, "ssm", "conv", i)
    else:
        x = _hybrid_full(cfg, model, x, positions, caches)
    return norm_apply(cfg.norm, x, model.final_norm)


def _unembed(cfg: ModelConfig, model: LM) -> torch.Tensor:
    if cfg.tie_embeddings:
        return model.embed.tok.T
    return model.lm_head


@torch.no_grad()
def prefill_fn(cfg: ModelConfig, model: LM, batch: Dict[str, torch.Tensor],
               max_seq: int):
    """Returns (last-position logits (B,1,V) float32, caches sized to
    max_seq).  batch["tokens"]: (B,S) integer tokens on the model's
    device."""
    check_ported(cfg)
    tokens = batch["tokens"].long()
    b, s = tokens.shape
    if s > max_seq:
        raise ValueError(f"prompt of {s} tokens exceeds max_seq={max_seq}")
    caches = _grow_caches(cfg, b, max_seq, model.embed.tok.dtype,
                          tokens.device)
    h = _backbone_full(cfg, model, tokens, caches)
    logits = (h[:, -1:, :] @ _unembed(cfg, model)).float()
    return logits, caches


# ===========================================================================
# Decode — one token against the caches
# ===========================================================================

def _attn_mlp_decode(cfg: ModelConfig, ln_a: Norm, attn: att.GQA,
                     ln_m: Norm, mlp: MLP, x, cache_k, cache_v,
                     cur_len: int):
    """One token through norm -> GQA decode -> residual, norm -> MLP ->
    residual; the token's k and v go into the caches at cur_len."""
    h = norm_apply(cfg.norm, x, ln_a)
    x = x + att.decode_attention(attn, h, cache_k, cache_v, cur_len,
                                 cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                 cfg.rope_theta)
    h = norm_apply(cfg.norm, x, ln_m)
    return x + mlp_apply(cfg.mlp, mlp, h)


def _mamba_decode(cfg: ModelConfig, lp: MambaLayer, x, caches, ssm_key,
                  conv_key, idx):
    h = norm_apply(cfg.norm, x, lp.ln)
    y, st, cst = m2.mamba2_decode(lp.mamba, h, caches[ssm_key][idx],
                                  caches[conv_key][idx], cfg.d_model,
                                  cfg.ssm)
    caches[ssm_key][idx].copy_(st)
    caches[conv_key][idx].copy_(cst)
    return x + y


def _hybrid_decode(cfg: ModelConfig, model: LM, x, caches: Caches,
                   cur_len: int):
    ap = model.shared_attn
    for gi, group in enumerate(model.group_mamba):
        x = _attn_mlp_decode(cfg, ap.ln, ap.attn, ap.ln2, ap.mlp, x,
                             caches["attn_k"][gi], caches["attn_v"][gi],
                             cur_len)
        for li, lp in enumerate(group):
            x = _mamba_decode(cfg, lp, x, caches, "group_ssm", "group_conv",
                              (gi, li))
    for li, lp in enumerate(getattr(model, "tail_mamba", ())):
        x = _mamba_decode(cfg, lp, x, caches, "tail_ssm", "tail_conv", li)
    return x


@torch.no_grad()
def decode_fn(cfg: ModelConfig, model: LM, token: torch.Tensor,
              caches: Caches, cur_len: int):
    """token: (B, 1) integer; cur_len: count of valid cache entries (the
    new token's position).  Returns (logits (B,1,V) float32, caches): the
    caches are updated in place."""
    check_ported(cfg)
    x = embed_lookup(model.embed, token.long())
    if cfg.family == "dense":
        for i, lp in enumerate(model.layers):
            x = _attn_mlp_decode(cfg, lp.ln1, lp.attn, lp.ln2, lp.mlp, x,
                                 caches["k"][i], caches["v"][i],
                                 int(cur_len))
    elif cfg.family == "ssm":
        for i, lp in enumerate(model.layers):
            x = _mamba_decode(cfg, lp, x, caches, "ssm", "conv", i)
    else:
        x = _hybrid_decode(cfg, model, x, caches, int(cur_len))
    x = norm_apply(cfg.norm, x, model.final_norm)
    logits = (x @ _unembed(cfg, model)).float()
    return logits, caches
