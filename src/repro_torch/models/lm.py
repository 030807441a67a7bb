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
  vlm    — groups of [cross_every - 1 dense blocks + 1 gated
           cross-attention layer] over stub image embeddings
           (Llama-3.2-Vision): x + tanh(gate) * cross(norm(x)), then x +
           tanh(mlp_gate) * mlp(norm(x))
  encdec — a non-causal encoder over stub frames (cast to bfloat16, RoPE
           on positions 0..T-1), then a causal decoder whose blocks
           attend to the encoder's output between self-attention and MLP
           (Whisper)

The frontends are stubs, as in the reference: the batch carries
`image_embeds` (B, n_frontend_tokens, d_model) for a vlm model and
`frames` (B, enc_seq, d_model) for an encdec one; a missing one raises
`KeyError` naming it.  A `moe` configuration with
`moe_impl="ep_shardmap"` runs its prefill and training over the active
mesh's slots (`models/moe.moe_apply_ep`, `parallel.set_mesh`), its decode
dropless, as the reference's does.  The two serving options of a
GQA `dense` or `moe` configuration are the reference's: the int8 KV
cache (`kv_cache_quant`: k and v int8 with bfloat16 scales a row,
written quantized by prefill, read by `attention.decode_attention_q8`)
and bfloat16 scores (`attn_scores_dtype="bf16"`, also read by a `vlm`
model's self layers: the plain blockwise route, `attention.
attention_route`).  Where the reference does not read a field, neither
does the port: an MLA configuration's cache fields, a `vlm` model's
`kv_cache_quant` (its cache is never quantized), both fields of an
`encdec` model and of the hybrid shared attention.  `attn_impl` chooses
the backward of the dense, moe and vlm self layers' attention (the
reference's hand-written one for "flash", the exact float32 gradient
otherwise; `models/flash.py`), not the forward's function;
`attn_chunk_remat` changes only the reference's memory and is not read.

The reference stacks each family's layers on a leading axis and runs them
under `lax.scan`; the port keeps one module per layer (`nn.ModuleList`,
`models/convert.py` unstacks a reference tree) and loops in Python.  The
shared attention block is ONE module used by every group, as in the
reference.  Sharding annotations (`act_shard`, `maybe_shard`) only
constrain XLA's placement and are left out (`parallel/__init__.py`).

Entry points: `build_model`, `loss_fn` (the training loss: the chunked
cross-entropy plus `AUX_LOSS_WEIGHT` times the MoE layers' summed
`frac_dropped`), `prefill_fn` (full-sequence forward that writes the
caches, allocated at `max_seq`), `decode_fn` (one token against the
caches, updated in place). Where autograd records and `cfg.remat` is set
(the default), each block the reference checkpoints (a stacked layer, a
hybrid or vlm group, an encoder or decoder block) runs under
`torch.utils.checkpoint`, so its backward recomputes its activations. On
the card the prefill runs the two hand-written kernels where the reference
runs their oracles: every GQA layer's attention (dense, GQA moe, vlm,
encdec) and the shared attention through `flash_attention_fwd` (grouped-
query, k/v never repeated), the cross-attention and Whisper's encoder
through it too, non-causally; every Mamba2 block's SSD through `ssd_scan`.
MLA, the experts and decode's attention are plain torch, as they are plain
JAX in the reference. The reference's `aux` (the MoE layers'
`frac_dropped`, summed), which prefill ignores, is what
`_backbone_full(..., stats=[])` collects: each MoE layer's statistics.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from ..configs.base import ModelConfig
from ..core.runtime import resolve_device
from ..parallel.compat import get_abstract_mesh, set_mesh
from . import attention as att
from . import mamba2 as m2
from . import moe as moe_mod
from .common import (MLP, Embed, Norm, _param, chunked_softmax_xent,
                     dense_init, embed_lookup, mlp_apply, norm_apply)

Caches = Dict[str, torch.Tensor]
FAMILIES = ("dense", "ssm", "hybrid", "moe", "vlm", "encdec")
# the batch key of each cross-attending family's stub frontend output
CROSS_INPUTS = {"vlm": "image_embeds", "encdec": "frames"}
AUX_LOSS_WEIGHT = 0.01


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


class CrossLayer(nn.Module):
    """The vlm family's gated cross-attention layer, `cross_layers`'s
    names: {ln, attn (GQA, no bias), gate, ln_mlp, mlp, mlp_gate}; the
    two gates are float32 scalars, zero at init, so that a fresh model's
    cross layers add nothing (tanh(0) = 0)."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        self.ln = Norm(cfg.norm, cfg.d_model, device)
        self.attn = att.GQA(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                            False, dtype, device, generator)
        self.gate = _param(torch.zeros((), dtype=torch.float32,
                                       device=device))
        self.ln_mlp = Norm(cfg.norm, cfg.d_model, device)
        self.mlp = MLP(cfg.mlp, cfg.d_model, cfg.d_ff, dtype, device,
                       generator)
        self.mlp_gate = _param(torch.zeros((), dtype=torch.float32,
                                           device=device))


class CrossDecoderLayer(DecoderLayer):
    """One encdec decoder block: a `DecoderLayer` {ln1, attn, ln2, mlp}
    plus ln_cross and cross (GQA over the encoder's output, no bias)."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__(cfg, dtype, device, generator)
        self.ln_cross = Norm(cfg.norm, cfg.d_model, device)
        self.cross = att.GQA(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.hd, False, dtype, device, generator)


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


def _vlm_layout(cfg: ModelConfig):
    """(groups, dense blocks per group)."""
    return cfg.n_layers // cfg.cross_every, cfg.cross_every - 1


class LM(nn.Module):
    """`init_params`'s tree as modules: embed, final_norm, lm_head (unless
    tied), and layers (dense, ssm, moe; with `moe.first_dense`, also the
    dense layer0), group_mamba / tail_mamba / shared_attn (hybrid),
    self_layers (G lists of dense blocks) / cross_layers (vlm), or encoder /
    enc_final_norm / layers (encdec; the encoder's attention has no bias).
    Matrices and biases bfloat16, norms, SSM vectors, the MoE router and
    the vlm gates float32."""

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
        elif cfg.family == "vlm":
            n_groups, n_self = _vlm_layout(cfg)
            self.self_layers = nn.ModuleList(
                nn.ModuleList(DecoderLayer(cfg, dtype, device, generator)
                              for _ in range(n_self))
                for _ in range(n_groups))
            self.cross_layers = nn.ModuleList(
                CrossLayer(cfg, dtype, device, generator)
                for _ in range(n_groups))
        elif cfg.family == "encdec":
            enc = dataclasses.replace(cfg, qkv_bias=False)
            self.encoder = nn.ModuleList(
                DecoderLayer(enc, dtype, device, generator)
                for _ in range(cfg.enc_layers))
            self.enc_final_norm = Norm(cfg.norm, cfg.d_model, device)
            self.layers = nn.ModuleList(
                CrossDecoderLayer(cfg, dtype, device, generator)
                for _ in range(cfg.n_layers))
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


def _quant_cache(cfg: ModelConfig) -> bool:
    """Whether the stacked layers' k / v caches are int8: a GQA dense or
    moe configuration with `kv_cache_quant` (an MLA model caches c_kv and
    k_rope, a vlm model's cache is never quantized, as in the
    reference)."""
    return (cfg.kv_cache_quant and cfg.family in ("dense", "moe")
            and cfg.mla is None)


def _attn_opts(cfg: ModelConfig) -> dict:
    """The reference's options of a dense, moe or vlm self layer's
    attention (its `_attn_full`): the chunk, the score dtype and the
    route; the hybrid shared block, the encoder and the encdec decoder
    pass the chunk alone."""
    return dict(kv_chunk=cfg.kv_chunk, scores_dtype=cfg.attn_scores_dtype,
                impl=cfg.attn_impl)


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
                 device, cross=None) -> Caches:
    """Zeroed caches sized to max_seq, for prefill to write into and
    decode to update in place, under the reference's names: the attention
    k/v (L or G, B, max_seq, KV, hd) in the activation dtype (with
    `kv_cache_quant` on a GQA dense or moe model, int8 plus bfloat16
    k_scale / v_scale (L, B, max_seq, KV)), a vlm
    model's (G, n_self, B, max_seq, KV, hd) with time on axis 3; a vlm or
    encdec model's cross-attention xk / xv (G or L, B, T, KV, hd), where
    `cross` is (T, dtype): written once by prefill, read by decode; an
    MLA model's ckv (L, B, max_seq, kv_lora) and kr (L, B, max_seq, rope);
    a `moe` model's dense layer 0 under k0 / v0 (B, max_seq, ...): its
    k / v, or its c_kv / k_rope with MLA; the SSM states (..., B, H, P,
    N) float32, the conv states (..., B, d_conv-1, conv_dim) in the
    activation dtype."""
    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    kv = (cfg.n_kv_heads, cfg.hd)
    if cfg.family in ("dense", "moe"):
        if cfg.mla is not None:
            widths = ((cfg.mla.kv_lora,), (cfg.mla.rope_dim,))
        else:
            widths = (kv,) * 2
        n = cfg.n_layers - _first_dense(cfg)
        if _quant_cache(cfg):
            out = {nm: zeros(n, b, max_seq, *kv, dt=torch.int8)
                   for nm in ("k", "v")}
            out.update({nm: zeros(n, b, max_seq, cfg.n_kv_heads,
                                  dt=torch.bfloat16)
                        for nm in ("k_scale", "v_scale")})
        else:
            out = {nm: zeros(n, b, max_seq, *w)
                   for nm, w in zip(_cache_names(cfg), widths)}
        if _first_dense(cfg):
            out["k0"], out["v0"] = (zeros(b, max_seq, *w) for w in widths)
        return out
    if cfg.family in CROSS_INPUTS:
        t, xdt = cross
        lead = _vlm_layout(cfg) if cfg.family == "vlm" else (cfg.n_layers,)
        return {"k": zeros(*lead, b, max_seq, *kv),
                "v": zeros(*lead, b, max_seq, *kv),
                "xk": zeros(lead[0], b, t, *kv, dt=xdt),
                "xv": zeros(lead[0], b, t, *kv, dt=xdt)}
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
    out = {"attn_k": zeros(n_groups, b, max_seq, *kv),
           "attn_v": zeros(n_groups, b, max_seq, *kv)}
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
# Full-sequence forward (prefill and training)
# ===========================================================================

def _remat(cfg: ModelConfig, fn, *args):
    """fn(*args), under `torch.utils.checkpoint` where autograd records
    and `cfg.remat` is set (the reference's `jax.checkpoint` of the same
    block): its backward recomputes the block's activations from args,
    under the mesh the forward saw (autograd may run the backward on
    another thread, or after the caller's `set_mesh` has exited)."""
    if cfg.remat and torch.is_grad_enabled():
        mesh = get_abstract_mesh()

        def run(*a):
            with set_mesh(mesh):
                return fn(*a)
        return torch.utils.checkpoint.checkpoint(run, *args,
                                                 use_reentrant=False)
    return fn(*args)


def _ffn(cfg: ModelConfig, ffn: nn.Module, h, stats: Optional[List] = None,
         dropless: bool = False):
    """The block's second half on the normed h: the MLP, or the routed
    experts (appending their statistics to `stats` when given): over the
    active mesh's slots with `moe_impl="ep_shardmap"` (prefill and
    training), dropless at decode, as the reference's decode is."""
    if not isinstance(ffn, moe_mod.MoE):
        return mlp_apply(cfg.mlp, ffn, h)
    if cfg.moe_impl == "ep_shardmap" and not dropless:
        apply = moe_mod.moe_apply_ep
    else:
        apply = functools.partial(moe_mod.moe_apply, dropless=dropless)
    if stats is None:
        return apply(ffn, h, cfg.moe)
    y, st = apply(ffn, h, cfg.moe, return_stats=True)
    stats.append(st)
    return y


def _write_kv(cache_a, cache_b, ka, kb, scales=None) -> None:
    """A layer's k / v (or c_kv / k_rope) into the first S rows of its
    caches (B, max_seq, ...); with `scales` (the int8 cache's k_scale and
    v_scale), quantized per row as the reference's prefill writes them."""
    s = ka.shape[1]
    if scales is None:
        cache_a[:, :s] = ka
        cache_b[:, :s] = kb
        return
    for cache, scale, val in ((cache_a, scales[0], ka),
                              (cache_b, scales[1], kb)):
        qv, sv = att.quantize_kv(val)
        cache[:, :s] = qv
        scale[:, :s] = sv


def _self_attn_full(cfg: ModelConfig, attn: nn.Module, h, positions,
                    cache_a=None, cache_b=None, causal: bool = True,
                    opts: Optional[dict] = None, scales=None):
    """Self-attention of the normed h: MLA when the config has `mla` (plain
    torch), else GQA (kernel 11; non-causal with `causal=False`, Whisper's
    encoder) with the options `opts` (`_attn_opts`, or the chunk alone).
    With caches (B, max_seq, ...), the layer's k after RoPE and v (GQA) or
    c_kv and k_rope (MLA) are written into their first S rows (`_write_kv`,
    quantized with `scales`)."""
    want_kv = cache_a is not None
    if cfg.mla is not None:
        m = cfg.mla
        out = att.mla_attention(attn, h, positions, cfg.n_heads, m.nope_dim,
                                m.rope_dim, m.v_dim, cfg.kv_chunk,
                                return_kv=want_kv)
    else:
        out = att.self_attention(attn, h, positions, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd, cfg.rope_theta,
                                 causal=causal, return_kv=want_kv,
                                 **(opts or dict(kv_chunk=cfg.kv_chunk)))
    if want_kv:
        out, (ka, kb) = out
        _write_kv(cache_a, cache_b, ka, kb, scales)
    return out


def _attn_mlp_full(cfg: ModelConfig, ln_a: Norm, attn: nn.Module,
                   ln_m: Norm, ffn: nn.Module, x, positions, cache_a=None,
                   cache_b=None, stats: Optional[List] = None,
                   causal: bool = True, opts: Optional[dict] = None,
                   scales=None):
    """norm -> self-attention (`_self_attn_full`) -> residual, norm -> MLP
    or experts -> residual."""
    x = x + _self_attn_full(cfg, attn, norm_apply(cfg.norm, x, ln_a),
                            positions, cache_a, cache_b, causal, opts,
                            scales)
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
        def block(x, gi=gi, group=group):
            # shared attention slot: the same parameters in every group
            kv = ((None, None) if caches is None
                  else (caches["attn_k"][gi], caches["attn_v"][gi]))
            x = _attn_mlp_full(cfg, ap.ln, ap.attn, ap.ln2, ap.mlp, x,
                               positions, *kv)
            for li, lp in enumerate(group):
                x = _mamba_full(cfg, lp, x, caches, "group_ssm",
                                "group_conv", (gi, li))
            return x
        x = _remat(cfg, block, x)
    for li, lp in enumerate(getattr(model, "tail_mamba", ())):
        x = _remat(cfg, lambda x, li=li, lp=lp: _mamba_full(
            cfg, lp, x, caches, "tail_ssm", "tail_conv", li), x)
    return x


def _decoder_full(cfg: ModelConfig, model: LM, x, positions,
                  caches: Optional[Caches], stats: Optional[List]):
    """The dense and moe families' blocks: `layer0` first if the model
    has one, then the stacked `layers` (each a block for `_remat`)."""
    a, b = _cache_names(cfg)
    opts = _attn_opts(cfg)
    if _first_dense(cfg):
        lp = model.layer0
        kv = (None, None) if caches is None else (caches["k0"],
                                                  caches["v0"])
        x = _attn_mlp_full(cfg, lp.ln1, lp.attn, lp.ln2, lp.mlp, x,
                           positions, *kv, opts=opts)
    for i, lp in enumerate(model.layers):
        kv = (None, None) if caches is None else (caches[a][i], caches[b][i])
        scales = ((caches["k_scale"][i], caches["v_scale"][i])
                  if caches is not None and "k_scale" in caches else None)

        def block(x, lp=lp, kv=kv, scales=scales):
            # the layer's statistics in a list of its own: a recomputation
            # under `_remat` appends to a fresh one, which is dropped
            st = [] if stats is not None else None
            y = _attn_mlp_full(cfg, lp.ln1, lp.attn, lp.ln2, lp.ffn, x,
                               positions, *kv, stats=st, opts=opts,
                               scales=scales)
            return y, st
        x, st = _remat(cfg, block, x)
        if stats is not None:
            stats.extend(st)
    return x


def _gated_cross(cfg: ModelConfig, cp: CrossLayer, x, attend):
    """A vlm cross layer: x + tanh(gate) * attend(norm(x)), then x +
    tanh(mlp_gate) * mlp(norm(x)); tanh of the float32 gate is rounded to
    x's dtype before the product, as the reference's `.astype` does."""
    ca = attend(norm_apply(cfg.norm, x, cp.ln))
    x = x + torch.tanh(cp.gate).to(x.dtype) * ca
    y = mlp_apply(cfg.mlp, cp.mlp, norm_apply(cfg.norm, x, cp.ln_mlp))
    return x + torch.tanh(cp.mlp_gate).to(x.dtype) * y


def _cross_block(cfg: ModelConfig, lp: CrossDecoderLayer, x, self_attend,
                 cross_attend):
    """An encdec decoder block: self-attention, cross-attention and MLP,
    each on the normed x and added to it."""
    x = x + self_attend(norm_apply(cfg.norm, x, lp.ln1))
    x = x + cross_attend(norm_apply(cfg.norm, x, lp.ln_cross))
    return x + mlp_apply(cfg.mlp, lp.mlp, norm_apply(cfg.norm, x, lp.ln2))


def _cross_full(cfg: ModelConfig, cross: att.GQA, h, src, caches, idx):
    """Prefill cross-attention of h against src (kernel 11, non-causal);
    with caches, its k and v go into xk / xv at idx."""
    if caches is None:
        return att.cross_attention(cross, h, src, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.hd)
    y, (k, v) = att.cross_attention(cross, h, src, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.hd, return_kv=True)
    caches["xk"][idx] = k
    caches["xv"][idx] = v
    return y


def _vlm_full(cfg: ModelConfig, model: LM, x, positions, image_embeds,
              caches: Optional[Caches]):
    opts = _attn_opts(cfg)
    for gi, (group, cp) in enumerate(zip(model.self_layers,
                                         model.cross_layers)):
        def block(x, src, gi=gi, group=group, cp=cp):
            for li, lp in enumerate(group):
                kv = ((None, None) if caches is None
                      else (caches["k"][gi, li], caches["v"][gi, li]))
                x = _attn_mlp_full(cfg, lp.ln1, lp.attn, lp.ln2, lp.mlp, x,
                                   positions, *kv, opts=opts)
            return _gated_cross(cfg, cp, x, lambda h: _cross_full(
                cfg, cp.attn, h, src, caches, gi))
        x = _remat(cfg, block, x, image_embeds)
    return x


def _encoder_full(cfg: ModelConfig, model: LM, frames):
    """The encoder over frames (B, T, D), cast to bfloat16 whatever the
    weights are (the reference's cast; against float32 weights the first
    block computes in float32): non-causal self-attention with RoPE on
    positions 0..T-1, then enc_final_norm."""
    b, t, _ = frames.shape
    positions = torch.arange(t, dtype=torch.int32,
                             device=frames.device)[None].expand(b, t)
    x = frames.to(torch.bfloat16)
    for lp in model.encoder:
        x = _remat(cfg, lambda x, lp=lp: _attn_mlp_full(
            cfg, lp.ln1, lp.attn, lp.ln2, lp.mlp, x, positions,
            causal=False), x)
    return norm_apply(cfg.norm, x, model.enc_final_norm)


def _encdec_decoder_full(cfg: ModelConfig, model: LM, x, positions, enc,
                         caches: Optional[Caches]):
    for i, lp in enumerate(model.layers):
        kv = (None, None) if caches is None else (caches["k"][i],
                                                  caches["v"][i])

        def block(x, enc, i=i, lp=lp, kv=kv):
            return _cross_block(
                cfg, lp, x,
                lambda h: _self_attn_full(cfg, lp.attn, h, positions, *kv),
                lambda h: _cross_full(cfg, lp.cross, h, enc, caches, i))
        x = _remat(cfg, block, x, enc)
    return x


def _backbone_full(cfg: ModelConfig, model: LM, tokens: torch.Tensor,
                   caches: Optional[Caches] = None,
                   stats: Optional[List] = None,
                   extra: Optional[Dict[str, torch.Tensor]] = None
                   ) -> torch.Tensor:
    """Final hidden states (B,S,D) of tokens (B,S); with `caches` (from
    `_grow_caches`), every layer's cache entries are written into them;
    with a list `stats`, each MoE layer appends its routing statistics
    (`moe.moe_apply`'s; the reference's `aux` is the sum of their
    `frac_dropped`).  `extra` holds a vlm model's `image_embeds` or an
    encdec model's `frames` (`KeyError` without them).  Differentiable:
    `loss_fn` trains through it (with no caches), `prefill_fn` calls it
    under `torch.no_grad()`."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    x = embed_lookup(model.embed, tokens)
    if cfg.family in ("dense", "moe"):
        x = _decoder_full(cfg, model, x, positions, caches, stats)
    elif cfg.family == "ssm":
        for i, lp in enumerate(model.layers):
            x = _remat(cfg, lambda x, i=i, lp=lp: _mamba_full(
                cfg, lp, x, caches, "ssm", "conv", i), x)
    elif cfg.family == "vlm":
        x = _vlm_full(cfg, model, x, positions, _cross_input(cfg, extra),
                      caches)
    elif cfg.family == "encdec":
        enc = _encoder_full(cfg, model, _cross_input(cfg, extra))
        x = _encdec_decoder_full(cfg, model, x, positions, enc, caches)
    else:
        x = _hybrid_full(cfg, model, x, positions, caches)
    return norm_apply(cfg.norm, x, model.final_norm)


def _unembed(cfg: ModelConfig, model: LM) -> torch.Tensor:
    if cfg.tie_embeddings:
        return model.embed.tok.T
    return model.lm_head


def _cross_input(cfg: ModelConfig, extra) -> torch.Tensor:
    """The batch's stub frontend output for a vlm or encdec model; a
    missing one raises `KeyError` naming it, as the reference's lookup
    does."""
    return (extra or {})[CROSS_INPUTS[cfg.family]]


def loss_fn(cfg: ModelConfig, model: LM, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """The reference's training loss: the mean next-token cross-entropy
    of batch["labels"] (B,S) given batch["tokens"] (B,S)
    (`chunked_softmax_xent` over `cfg.loss_chunks` chunks), plus
    AUX_LOSS_WEIGHT times the MoE layers' `frac_dropped` summed (0 for
    the other families; it carries no gradient, as in the reference).  A
    vlm or encdec batch carries its frontend input too."""
    check_ported(cfg)
    stats = [] if cfg.family == "moe" else None
    h = _backbone_full(cfg, model, batch["tokens"].long(), stats=stats,
                       extra=batch)
    loss = chunked_softmax_xent(h, _unembed(cfg, model), batch["labels"],
                                cfg.loss_chunks)
    if stats:
        loss = loss + AUX_LOSS_WEIGHT * sum(st["frac_dropped"]
                                            for st in stats)
    return loss


@torch.no_grad()
def prefill_fn(cfg: ModelConfig, model: LM, batch: Dict[str, torch.Tensor],
               max_seq: int):
    """Returns (last-position logits (B,1,V) float32, caches sized to
    max_seq).  batch["tokens"]: (B,S) integer tokens on the model's
    device; a vlm model's batch also holds `image_embeds` (B, T, D) and an
    encdec model's `frames` (B, T, D), on that device too."""
    check_ported(cfg)
    tokens = batch["tokens"].long()
    b, s = tokens.shape
    if s > max_seq:
        raise ValueError(f"prompt of {s} tokens exceeds max_seq={max_seq}")
    wdt = model.embed.tok.dtype
    cross = None
    if cfg.family in CROSS_INPUTS:
        src = _cross_input(cfg, batch)
        # k, v of the source in JAX's promotion of its dtype and the
        # weights'; frames enter the encoder as bfloat16
        sdt = torch.bfloat16 if cfg.family == "encdec" else src.dtype
        cross = (src.shape[1], torch.promote_types(sdt, wdt))
    caches = _grow_caches(cfg, b, max_seq, wdt, tokens.device, cross)
    h = _backbone_full(cfg, model, tokens, caches, extra=batch)
    logits = (h[:, -1:, :] @ _unembed(cfg, model)).float()
    return logits, caches


# ===========================================================================
# Decode — one token against the caches
# ===========================================================================

def _attn_mlp_decode(cfg: ModelConfig, ln_a: Norm, attn: nn.Module,
                     ln_m: Norm, ffn: nn.Module, x, cache_a, cache_b,
                     cur_len: int, scales=None):
    """One token through norm -> GQA or MLA decode -> residual, norm ->
    MLP or dropless experts -> residual; the token's k and v (GQA) or
    c_kv and k_rope (MLA) go into the caches at cur_len (int8 with
    `scales`, the k_scale / v_scale caches, through
    `decode_attention_q8`)."""
    h = norm_apply(cfg.norm, x, ln_a)
    if cfg.mla is not None:
        m = cfg.mla
        a = att.mla_decode(attn, h, cache_a, cache_b, cur_len, cfg.n_heads,
                           m.nope_dim, m.rope_dim, m.v_dim)
    elif scales is not None:
        a = att.decode_attention_q8(attn, h, cache_a, scales[0], cache_b,
                                    scales[1], cur_len, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.hd, cfg.rope_theta)
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
    quant = "k_scale" in caches
    for i, lp in enumerate(model.layers):
        scales = ((caches["k_scale"][i], caches["v_scale"][i]) if quant
                  else None)
        x = _attn_mlp_decode(cfg, lp.ln1, lp.attn, lp.ln2, lp.ffn, x,
                             caches[a][i], caches[b][i], cur_len, scales)
    return x


def _vlm_decode(cfg: ModelConfig, model: LM, x, caches: Caches,
                cur_len: int):
    for gi, (group, cp) in enumerate(zip(model.self_layers,
                                         model.cross_layers)):
        for li, lp in enumerate(group):
            x = _attn_mlp_decode(cfg, lp.ln1, lp.attn, lp.ln2, lp.mlp, x,
                                 caches["k"][gi, li], caches["v"][gi, li],
                                 cur_len)
        x = _gated_cross(cfg, cp, x, lambda h: att.cross_attention_cached(
            cp.attn, h, caches["xk"][gi], caches["xv"][gi], cfg.n_heads,
            cfg.n_kv_heads, cfg.hd))
    return x


def _encdec_decode(cfg: ModelConfig, model: LM, x, caches: Caches,
                   cur_len: int):
    for i, lp in enumerate(model.layers):
        x = _cross_block(
            cfg, lp, x,
            lambda h: att.decode_attention(
                lp.attn, h, caches["k"][i], caches["v"][i], cur_len,
                cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.rope_theta),
            lambda h: att.cross_attention_cached(
                lp.cross, h, caches["xk"][i], caches["xv"][i], cfg.n_heads,
                cfg.n_kv_heads, cfg.hd))
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
    elif cfg.family == "vlm":
        x = _vlm_decode(cfg, model, x, caches, int(cur_len))
    elif cfg.family == "encdec":
        x = _encdec_decode(cfg, model, x, caches, int(cur_len))
    else:
        x = _hybrid_decode(cfg, model, x, caches, int(cur_len))
    x = norm_apply(cfg.norm, x, model.final_norm)
    logits = (x @ _unembed(cfg, model)).float()
    return logits, caches
