"""Architecture assembly for the families the port runs:

  dense  — a stack of [norm -> GQA -> residual, norm -> MLP -> residual]
           blocks (Phi3-medium-14b, Yi-9B, Qwen2.5-3b, StarCoder2-15b)
  ssm    — a stack of Mamba2 (SSD) blocks (Mamba2-370m)
  hybrid — groups of [1 SHARED attention slot + k Mamba2 blocks], then a
           tail of Mamba2 blocks (Zamba2-7B)
  moe    — the dense block with its MLP replaced by routed experts
           (`models/moe.py`), with GQA (Phi-3.5-MoE) or MLA attention and
           an optional dense layer 0 (DeepSeek-V2-Lite: `layer0`, MLA and
           an MLP of `moe.dense_d_ff`); decode routes dropless

The `vlm` and `encdec` families raise `NotImplementedError` when a model
is built (ROADMAP A.5), and so does a configuration that asks for what
the port does not compute yet: on a GQA `dense` or `moe` configuration,
the int8 KV cache (`kv_cache_quant`) or scores in another dtype than
float32 (`attn_scores_dtype`); on a `moe` one, expert parallelism
(`moe_impl="ep_shardmap"`).  An MLA configuration reads neither cache
field, as the reference's does not.  `attn_impl` and `attn_chunk_remat`
choose the reference's route or backward, not the forward's function,
and are not read.

The reference stacks each family's layers on a leading axis and runs them
under `lax.scan`; the port keeps one module per layer (`nn.ModuleList`,
`models/convert.py` unstacks a reference tree) and loops in Python.  The
shared attention block is ONE module used by every group, as in the
reference.  Sharding annotations (`act_shard`, `maybe_shard`) have no
meaning on one card and are left out.

Entry points: `build_model`, `prefill_fn` (full-sequence forward that
writes the caches, allocated at `max_seq`), `decode_fn` (one token against
the caches, updated in place).  On the card the prefill runs the two
hand-written kernels where the reference runs their oracles: every GQA
layer's attention (dense, GQA moe) and the shared attention through
`flash_attention_fwd` (grouped-query, k/v never repeated), every Mamba2
block's SSD through `ssd_scan`.  MLA and the experts are plain torch, as
they are plain JAX in the reference.  The reference's `aux` (the MoE
layers' `frac_dropped`, summed), which prefill ignores, is what
`_backbone_full(..., stats=[])` collects: each MoE layer's statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.runtime import resolve_device
from . import attention as att
from . import mamba2 as m2
from . import moe as moe_mod
from .common import (MLP, Embed, Norm, _param, dense_init, embed_lookup,
                     mlp_apply, norm_apply)

Caches = Dict[str, torch.Tensor]
FAMILIES = ("dense", "ssm", "hybrid", "moe")


# ===========================================================================
# Parameters
# ===========================================================================

class DecoderLayer(nn.Module):
    """One decoder block, the reference's `_decoder_layer_init` names:
    {ln1, attn, ln2, mlp}, or {ln1, attn, ln2, moe} with `use_moe`; attn
    is MLA when the config has `mla`, else GQA."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator,
                 use_moe: bool = False):
        super().__init__()
        self.ln1 = Norm(cfg.norm, cfg.d_model, device)
        if cfg.mla is not None:
            m = cfg.mla
            self.attn = att.MLA(cfg.d_model, cfg.n_heads, m.kv_lora,
                                m.nope_dim, m.rope_dim, m.v_dim, dtype,
                                device, generator)
        else:
            self.attn = att.GQA(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.hd, cfg.qkv_bias, dtype, device,
                                generator)
        self.ln2 = Norm(cfg.norm, cfg.d_model, device)
        if use_moe:
            self.moe = moe_mod.MoE(cfg.d_model, cfg.moe, dtype, device,
                                   generator)
        else:
            self.mlp = MLP(cfg.mlp, cfg.d_model, cfg.d_ff, dtype, device,
                           generator)

    @property
    def ffn(self) -> nn.Module:
        """The block's second half: `moe` or `mlp`."""
        return self.moe if hasattr(self, "moe") else self.mlp


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


def _dense_layer0(cfg: ModelConfig) -> ModelConfig:
    """The config of a `moe` model's dense layer 0: its MLP is
    `moe.dense_d_ff` wide."""
    return dataclasses.replace(cfg, d_ff=cfg.moe.dense_d_ff)


def _first_dense(cfg: ModelConfig) -> bool:
    """Whether the model has a separate dense `layer0` before its stacked
    `layers` (a `moe` model with `moe.first_dense`)."""
    return cfg.family == "moe" and cfg.moe.first_dense


def _hybrid_layout(cfg: ModelConfig):
    """(groups, Mamba2 blocks per group, tail blocks)."""
    per = cfg.attn_every  # group = 1 shared-attn slot + (per-1) mamba
    n_groups = cfg.n_layers // per
    return n_groups, per - 1, cfg.n_layers - n_groups * per


class LM(nn.Module):
    """`init_params`'s tree as modules: embed, final_norm, lm_head (unless
    tied), and layers (dense, ssm, moe; with `moe.first_dense`, also the
    dense layer0) or group_mamba / tail_mamba / shared_attn (hybrid).
    Matrices and biases bfloat16, norms, SSM vectors and the MoE router
    float32."""

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

        if cfg.family in ("dense", "moe"):
            self.layers = nn.ModuleList(
                DecoderLayer(cfg, dtype, device, generator,
                             use_moe=cfg.family == "moe")
                for _ in range(cfg.n_layers - _first_dense(cfg)))
            if _first_dense(cfg):
                self.layer0 = DecoderLayer(_dense_layer0(cfg), dtype,
                                           device, generator)
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
    if cfg.family == "moe" and cfg.moe_impl == "ep_shardmap":
        raise NotImplementedError(
            f"{cfg.name}: expert parallelism (moe_impl='ep_shardmap', a "
            f"mesh of several cards) is not ported yet; see ROADMAP A.5")
    # an MLA model caches (c_kv, k_rope) and scores in float32 whatever
    # these two fields say, as the reference's does
    if cfg.family not in ("dense", "moe") or cfg.mla is not None:
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

def _cache_names(cfg: ModelConfig):
    """The stacked layers' two cache names: c_kv and k_rope with MLA, k
    and v with GQA."""
    return ("ckv", "kr") if cfg.mla is not None else ("k", "v")


def _grow_caches(cfg: ModelConfig, b: int, max_seq: int, dtype,
                 device) -> Caches:
    """Zeroed caches sized to max_seq, for prefill to write into and
    decode to update in place, under the reference's names: the attention
    k/v (L or G, B, max_seq, KV, hd) in the activation dtype; an MLA
    model's ckv (L, B, max_seq, kv_lora) and kr (L, B, max_seq, rope);
    a `moe` model's dense layer 0 under k0 / v0 (B, max_seq, ...): its
    k / v, or its c_kv / k_rope with MLA; the SSM states (..., B, H, P,
    N) float32, the conv states (..., B, d_conv-1, conv_dim) in the
    activation dtype."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.family in ("dense", "moe"):
        if cfg.mla is not None:
            widths = ((cfg.mla.kv_lora,), (cfg.mla.rope_dim,))
        else:
            widths = ((cfg.n_kv_heads, cfg.hd),) * 2
        n = cfg.n_layers - _first_dense(cfg)
        out = {nm: zeros(n, b, max_seq, *w)
               for nm, w in zip(_cache_names(cfg), widths)}
        if _first_dense(cfg):
            out["k0"], out["v0"] = (zeros(b, max_seq, *w) for w in widths)
        return out
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

def _ffn(cfg: ModelConfig, ffn: nn.Module, h, stats: Optional[List] = None,
         dropless: bool = False):
    """The block's second half on the normed h: the MLP, or the routed
    experts (appending their statistics to `stats` when given)."""
    if not isinstance(ffn, moe_mod.MoE):
        return mlp_apply(cfg.mlp, ffn, h)
    if stats is None:
        return moe_mod.moe_apply(ffn, h, cfg.moe, dropless=dropless)
    y, st = moe_mod.moe_apply(ffn, h, cfg.moe, return_stats=True,
                              dropless=dropless)
    stats.append(st)
    return y


def _attn_mlp_full(cfg: ModelConfig, ln_a: Norm, attn: nn.Module,
                   ln_m: Norm, ffn: nn.Module, x, positions, cache_a=None,
                   cache_b=None, stats: Optional[List] = None):
    """norm -> self-attention -> residual, norm -> MLP or experts ->
    residual.  The attention is MLA when the config has `mla` (plain
    torch), else GQA (kernel 11).  With caches (B, max_seq, ...), the
    layer's k after RoPE and v (GQA) or c_kv and k_rope (MLA) are written
    into their first S rows."""
    h = norm_apply(cfg.norm, x, ln_a)
    want_kv = cache_a is not None
    if cfg.mla is not None:
        m = cfg.mla
        out = att.mla_attention(attn, h, positions, cfg.n_heads, m.nope_dim,
                                m.rope_dim, m.v_dim, cfg.kv_chunk,
                                return_kv=want_kv)
    else:
        out = att.self_attention(attn, h, positions, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd, cfg.rope_theta,
                                 return_kv=want_kv)
    if want_kv:
        out, (ka, kb) = out
        cache_a[:, :x.shape[1]] = ka
        cache_b[:, :x.shape[1]] = kb
    x = x + out
    h = norm_apply(cfg.norm, x, ln_m)
    return x + _ffn(cfg, ffn, h, stats)


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


def _decoder_full(cfg: ModelConfig, model: LM, x, positions,
                  caches: Optional[Caches], stats: Optional[List]):
    """The dense and moe families' blocks: `layer0` first if the model
    has one, then the stacked `layers`."""
    a, b = _cache_names(cfg)
    if _first_dense(cfg):
        lp = model.layer0
        kv = (None, None) if caches is None else (caches["k0"],
                                                  caches["v0"])
        x = _attn_mlp_full(cfg, lp.ln1, lp.attn, lp.ln2, lp.mlp, x,
                           positions, *kv)
    for i, lp in enumerate(model.layers):
        kv = (None, None) if caches is None else (caches[a][i], caches[b][i])
        x = _attn_mlp_full(cfg, lp.ln1, lp.attn, lp.ln2, lp.ffn, x,
                           positions, *kv, stats=stats)
    return x


@torch.no_grad()
def _backbone_full(cfg: ModelConfig, model: LM, tokens: torch.Tensor,
                   caches: Optional[Caches] = None,
                   stats: Optional[List] = None) -> torch.Tensor:
    """Final hidden states (B,S,D) of tokens (B,S); with `caches` (from
    `_grow_caches`), every layer's cache entries are written into them;
    with a list `stats`, each MoE layer appends its routing statistics
    (`moe.moe_apply`'s; the reference's `aux` is the sum of their
    `frac_dropped`)."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    x = embed_lookup(model.embed, tokens)
    if cfg.family in ("dense", "moe"):
        x = _decoder_full(cfg, model, x, positions, caches, stats)
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

def _attn_mlp_decode(cfg: ModelConfig, ln_a: Norm, attn: nn.Module,
                     ln_m: Norm, ffn: nn.Module, x, cache_a, cache_b,
                     cur_len: int):
    """One token through norm -> GQA or MLA decode -> residual, norm ->
    MLP or dropless experts -> residual; the token's k and v (GQA) or
    c_kv and k_rope (MLA) go into the caches at cur_len."""
    h = norm_apply(cfg.norm, x, ln_a)
    if cfg.mla is not None:
        m = cfg.mla
        a = att.mla_decode(attn, h, cache_a, cache_b, cur_len, cfg.n_heads,
                           m.nope_dim, m.rope_dim, m.v_dim)
    else:
        a = att.decode_attention(attn, h, cache_a, cache_b, cur_len,
                                 cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                 cfg.rope_theta)
    x = x + a
    h = norm_apply(cfg.norm, x, ln_m)
    return x + _ffn(cfg, ffn, h, dropless=True)


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


def _decoder_decode(cfg: ModelConfig, model: LM, x, caches: Caches,
                    cur_len: int):
    a, b = _cache_names(cfg)
    if _first_dense(cfg):
        lp = model.layer0
        x = _attn_mlp_decode(cfg, lp.ln1, lp.attn, lp.ln2, lp.mlp, x,
                             caches["k0"], caches["v0"], cur_len)
    for i, lp in enumerate(model.layers):
        x = _attn_mlp_decode(cfg, lp.ln1, lp.attn, lp.ln2, lp.ffn, x,
                             caches[a][i], caches[b][i], cur_len)
    return x


@torch.no_grad()
def decode_fn(cfg: ModelConfig, model: LM, token: torch.Tensor,
              caches: Caches, cur_len: int):
    """token: (B, 1) integer; cur_len: count of valid cache entries (the
    new token's position).  Returns (logits (B,1,V) float32, caches): the
    caches are updated in place."""
    check_ported(cfg)
    x = embed_lookup(model.embed, token.long())
    if cfg.family in ("dense", "moe"):
        x = _decoder_decode(cfg, model, x, caches, int(cur_len))
    elif cfg.family == "ssm":
        for i, lp in enumerate(model.layers):
            x = _mamba_decode(cfg, lp, x, caches, "ssm", "conv", i)
    else:
        x = _hybrid_decode(cfg, model, x, caches, int(cur_len))
    x = norm_apply(cfg.norm, x, model.final_norm)
    logits = (x @ _unembed(cfg, model)).float()
    return logits, caches
