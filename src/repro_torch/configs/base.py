"""ModelConfig: one declarative description covers all 10 assigned
architectures (dense / MoE / MLA / SSM / hybrid / VLM / enc-dec).

A copy of the reference's `repro/configs/base.py`, field for field, so the
two registries compare equal, with a few fields of the port's own whose
defaults compute what the reference computes (`MLAConfig.rope_theta`, and
`MoEConfig`'s router and share settings); the port builds every family
and option of a registered configuration (`models/lm.build_model`)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..models.mamba2 import SSMConfig
from ..models.moe import MoEConfig


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    nope_dim: int = 128
    rope_dim: int = 64
    v_dim: int = 128
    rope_theta: float = 10000.0      # the RoPE part's angle base


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 => d_model // n_heads
    norm: str = "rms"                # rms | ln
    mlp: str = "swiglu"              # swiglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: one SHARED attention block slot every `attn_every` slots
    attn_every: int = 0
    # vlm: one gated cross-attention layer every `cross_every` layers
    cross_every: int = 0
    n_frontend_tokens: int = 0       # vlm: projected patch tokens
    # enc-dec
    enc_layers: int = 0
    enc_seq: int = 0                 # whisper frames after conv frontend
    # runtime knobs
    kv_chunk: int = 1024
    loss_chunks: int = 8
    remat: bool = True
    sub_quadratic: bool = False      # supports long_500k decode
    # ---- perf variants (§Perf hillclimbing; defaults = paper-faithful
    # baseline). See EXPERIMENTS.md for the iteration log. ----
    attn_scores_dtype: str = "f32"   # f32 | bf16 (score/prob tensors)
    moe_impl: str = "gspmd"          # gspmd | ep_shardmap (explicit a2a EP)
    kv_cache_quant: bool = False     # int8 KV cache (Shark §3.2 compression)
    attn_impl: str = "blockwise"     # blockwise | flash (Pallas kernel)
    attn_chunk_remat: bool = False   # recompute chunk probs in backward
    attn_seq_shard: bool = False     # context-parallel attention (shard S
                                     # over `model` when heads don't divide)
    seq_parallel_residual: bool = False  # residual stream sharded over S

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def n_params(self) -> int:
        """Approximate parameter count (for 6ND roofline accounting)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.hd
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            cfg = self.ssm
            di = cfg.d_inner(d)
            nh = cfg.n_heads(d)
            per = d * (2 * di + 2 * cfg.ngroups * cfg.d_state + nh) \
                + di * d + (di + 2 * cfg.ngroups * cfg.d_state) * cfg.d_conv
            return emb + L * per
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.mla is not None:
            m = self.mla
            attn = d * self.n_heads * (m.nope_dim + m.rope_dim) \
                + d * m.kv_lora + d * m.rope_dim \
                + m.kv_lora * self.n_heads * (m.nope_dim + m.v_dim) \
                + self.n_heads * m.v_dim * d
        if self.mlp == "swiglu":
            ffn = 3 * d * f
        else:
            ffn = 2 * d * f
        if self.family == "moe" and self.moe is not None:
            e = self.moe
            ffn = d * e.num_experts + 3 * d * e.d_expert * e.num_experts \
                + (3 * d * e.d_expert * e.n_shared)
        per = attn + ffn
        total = emb + L * per
        if self.family == "hybrid" and self.ssm is not None:
            cfg = self.ssm
            di = cfg.d_inner(d)
            nh = cfg.n_heads(d)
            mamba_per = d * (2 * di + 2 * cfg.ngroups * cfg.d_state + nh) \
                + di * d
            n_attn_slots = self.n_layers // (self.attn_every or 7)
            n_mamba = self.n_layers - n_attn_slots
            total = emb + n_mamba * (mamba_per + 3 * d * f) + attn  # shared!
        if self.family == "encdec":
            total = emb + (L + self.enc_layers) * per + L * attn  # + cross
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.family != "moe" or self.moe is None:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        e = self.moe
        hd = self.hd
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.mla is not None:
            m = self.mla
            attn = d * self.n_heads * (m.nope_dim + m.rope_dim) \
                + d * m.kv_lora + d * m.rope_dim \
                + m.kv_lora * self.n_heads * (m.nope_dim + m.v_dim) \
                + self.n_heads * m.v_dim * d
        ffn_active = 3 * d * e.d_expert * (e.top_k + e.n_shared) \
            + d * e.num_experts
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(emb + L * (attn + ffn_active))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
