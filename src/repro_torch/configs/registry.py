"""All 10 assigned architectures (exact configs from the assignment) plus
reduced smoke variants of each family for CPU tests.

Sources are noted per entry; see DESIGN.md §4 for applicability notes and
the deepseek-v2-lite "160 routed" assignment-text discrepancy.  A copy of
the reference's `repro/configs/registry.py`: every entry and smoke variant
equals the reference's field for field (tests/test_torch_lm.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from ..models.mamba2 import SSMConfig
from ..models.moe import MoEConfig
from .base import MLAConfig, ModelConfig

REGISTRY: Dict[str, ModelConfig] = {}


def _reg(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


# --- dense -----------------------------------------------------------------

PHI3_MEDIUM = _reg(ModelConfig(
    name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=10, d_ff=17920, vocab=100352, norm="rms",
    mlp="swiglu", rope_theta=10000.0))  # [arXiv:2404.14219]

YI_9B = _reg(ModelConfig(
    name="yi-9b", family="dense", n_layers=48, d_model=4096, n_heads=32,
    n_kv_heads=4, d_ff=11008, vocab=64000, norm="rms", mlp="swiglu",
    rope_theta=10000.0))  # [arXiv:2403.04652]

QWEN25_3B = _reg(ModelConfig(
    name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048, n_heads=16,
    n_kv_heads=2, d_ff=11008, vocab=151936, norm="rms", mlp="swiglu",
    qkv_bias=True, tie_embeddings=True,
    rope_theta=1000000.0))  # [hf:Qwen/Qwen2.5-*]

STARCODER2_15B = _reg(ModelConfig(
    name="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=4, d_ff=24576, vocab=49152, norm="ln",
    mlp="gelu", qkv_bias=True, rope_theta=100000.0))  # [arXiv:2402.19173]

# --- MoE ---------------------------------------------------------------------

PHI35_MOE = _reg(ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=6400, vocab=32064, norm="rms",
    mlp="swiglu", rope_theta=10000.0,
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=6400)))
# [hf:microsoft/Phi-3.5-MoE-instruct]

DEEPSEEK_V2_LITE = _reg(ModelConfig(
    name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=102400, norm="rms",
    mlp="swiglu", rope_theta=10000.0,
    mla=MLAConfig(kv_lora=512, nope_dim=128, rope_dim=64, v_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, n_shared=2,
                  first_dense=True, dense_d_ff=10944)))
# [arXiv:2405.04434] — 64 routed top-6 + 2 shared; see DESIGN.md on the
# assignment text's "160 routed" inconsistency.

# --- SSM ---------------------------------------------------------------------

MAMBA2_370M = _reg(ModelConfig(
    name="mamba2-370m", family="ssm", n_layers=48, d_model=1024, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab=50280, norm="rms", rope_theta=0.0,
    ssm=SSMConfig(d_state=128, expand=2, headdim=64, ngroups=1, d_conv=4,
                  chunk=256),
    sub_quadratic=True))  # [arXiv:2405.21060]

# --- VLM ---------------------------------------------------------------------

LLAMA32_VISION = _reg(ModelConfig(
    name="llama-3.2-vision-11b", family="vlm", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=128256, norm="rms",
    mlp="swiglu", rope_theta=500000.0, cross_every=5,
    n_frontend_tokens=1601))  # [hf:meta-llama/Llama-3.2-11B-Vision]

# --- hybrid --------------------------------------------------------------------

ZAMBA2_7B = _reg(ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584, n_heads=32,
    n_kv_heads=32, d_ff=14336, vocab=32000, norm="rms", mlp="swiglu",
    rope_theta=10000.0, attn_every=7,
    ssm=SSMConfig(d_state=64, expand=2, headdim=112, ngroups=1, d_conv=4,
                  chunk=256),
    sub_quadratic=True))  # [arXiv:2411.15242] 81 slots: 11x(1 shared attn +
# 6 mamba) + 4 mamba; the attention block params are SHARED across slots.

# --- audio enc-dec ---------------------------------------------------------------

WHISPER_BASE = _reg(ModelConfig(
    name="whisper-base", family="encdec", n_layers=6, d_model=512, n_heads=8,
    n_kv_heads=8, d_ff=2048, vocab=51865, norm="ln", mlp="gelu",
    rope_theta=10000.0, enc_layers=6, enc_seq=1500))  # [arXiv:2212.04356]
# conv frontend stubbed: input_specs() provides precomputed frame embeddings.


# --- reduced smoke variants (CPU tests) -------------------------------------------

def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    kw = dict(
        name=cfg.name + "-smoke", n_layers=2, d_model=64, vocab=256,
        loss_chunks=2, kv_chunk=64)
    if cfg.family in ("dense", "moe", "vlm", "hybrid", "encdec"):
        kw.update(n_heads=4, n_kv_heads=max(1, 4 * cfg.n_kv_heads
                                            // max(cfg.n_heads, 1)),
                  d_ff=128, head_dim=16)
    if cfg.family == "moe":
        ne = min(8, cfg.moe.num_experts)
        tk = min(2, cfg.moe.top_k)
        kw.update(moe=dataclasses.replace(
            cfg.moe, d_expert=32, num_experts=ne, top_k=tk, dense_d_ff=64,
            # capacity == worst case so smoke tests are drop-free and the
            # prefill/decode consistency check is exact
            capacity_factor=float(ne) / tk))
    if cfg.mla is not None:
        kw.update(mla=MLAConfig(kv_lora=32, nope_dim=16, rope_dim=8, v_dim=16))
    if cfg.ssm is not None:
        kw.update(ssm=dataclasses.replace(cfg.ssm, d_state=16, headdim=16,
                                          chunk=16))
    if cfg.family == "hybrid":
        kw.update(n_layers=8, attn_every=4)  # 2 groups of (1 attn + 3 mamba)
    if cfg.family == "encdec":
        kw.update(enc_layers=2, enc_seq=32)
    if cfg.family == "vlm":
        kw.update(n_layers=4, cross_every=2, n_frontend_tokens=16)
    return dataclasses.replace(cfg, **kw)


def get_config(name: str) -> ModelConfig:
    if name in REGISTRY:
        return REGISTRY[name]
    if name.endswith("-smoke"):
        return smoke_variant(REGISTRY[name[:-len("-smoke")]])
    raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")


ARCH_NAMES = list(REGISTRY)
