"""Family "dense": a decoder of grouped-query attention and a SwiGLU MLP
in every layer, the configuration's keys as Hugging Face's Qwen2 and Llama
config.json name them."""

from __future__ import annotations

import dataclasses
from typing import List

from shark_bench import yardstick
from shark_bench.spec import Leaf, Spec, mat, vec


@dataclasses.dataclass(frozen=True)
class Sizes:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    qkv_bias: bool
    rope_theta: float


def fields(c: dict) -> dict:
    return dict(
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        vocab=c["vocab_size"], tied=c["tie_word_embeddings"],
        eps=c["rms_norm_eps"],
        sizes=Sizes(n_heads=c["num_attention_heads"],
                    n_kv_heads=c["num_key_value_heads"],
                    head_dim=c["head_dim"], d_ff=c["intermediate_size"],
                    qkv_bias=c["attention_bias"],
                    rope_theta=c["rope_theta"]))


def leaves(spec: Spec) -> List[Leaf]:
    d, z, out = spec.d_model, spec.sizes, []
    h, kv, hd = z.n_heads, z.n_kv_heads, z.head_dim
    for i in range(spec.n_layers):
        p = f"layers.{i}."
        out += [vec(p + "ln1.w", d, "norm"),
                mat(p + "attn.wq", d, h * hd),
                mat(p + "attn.wk", d, kv * hd),
                mat(p + "attn.wv", d, kv * hd),
                mat(p + "attn.wo", h * hd, d)]
        if z.qkv_bias:
            out += [vec(p + "attn." + nm, w, "normal", "bfloat16", 0.1)
                    for nm, w in (("bq", h * hd), ("bk", kv * hd),
                                  ("bv", kv * hd))]
        out += [vec(p + "ln2.w", d, "norm"),
                mat(p + "mlp.gate", d, z.d_ff),
                mat(p + "mlp.up", d, z.d_ff),
                mat(p + "mlp.down", z.d_ff, d)]
    return out


def mixer_cost(spec: Spec, b: int, s: int):
    """One layer's causal attention over b x s, bf16 operands."""
    z = spec.sizes
    return yardstick.flash_cost(b, z.n_heads, s, z.head_dim, 2,
                                kv=z.n_kv_heads)


def flops_per_token(spec: Spec) -> float:
    return 0.0


def kernels(spec: Spec, b: int, s: int) -> dict:
    return {"flash_fwd": (spec.n_layers, mixer_cost(spec, b, s))}


def program(spec: Spec) -> dict:
    z = spec.sizes
    return dict(
        name=spec.name, family="dense", n_layers=spec.n_layers,
        d_model=spec.d_model, n_heads=z.n_heads, n_kv_heads=z.n_kv_heads,
        d_ff=z.d_ff, vocab=spec.vocab, head_dim=z.head_dim, norm="rms",
        mlp="swiglu", qkv_bias=z.qkv_bias, rope_theta=z.rope_theta,
        tie_embeddings=spec.tied, norm_eps=spec.eps)
