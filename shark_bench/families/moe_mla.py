"""Family "moe_mla": the DeepSeek-V3 block (arXiv:2412.19437; Moonlight-16B-A3B
is one), the configuration's keys as Hugging Face's deepseek_v3 config.json
names them.  Every layer has multi-head latent attention (MLA: no query
LoRA, K and V decompressed from a `kv_lora_rank` latent, a no-RoPE and a
RoPE part in each head, one RoPE key shared by the heads); the first
`first_k_dense_replace` layers (one) have a dense SwiGLU MLP, the rest a
MoE layer: `n_shared_experts` shared SwiGLU experts as one MLP, and routed
SwiGLU experts chosen by a sigmoid router with a selection bias
(`noaux_tc` with one group), the chosen scores renormalised and scaled by
`routed_scaling_factor`.

A configuration may give one chip's share of an expert-parallel deployment
(`expert_parallel`: ranks, and this chip's rank): `n_routed_experts` is then
the experts held here, experts [rank x held, (rank + 1) x held) of the
router's `published.n_routed_experts`, and the layer computes its own
experts' part of each token's result alone.
"""

from __future__ import annotations

import dataclasses
from typing import List

from shark_bench.spec import Leaf, Spec, mat, vec


@dataclasses.dataclass(frozen=True)
class Sizes:
    n_heads: int
    kv_lora: int
    nope_dim: int
    rope_dim: int
    v_dim: int
    rope_theta: float
    first_dense: int            # leading layers with a dense MLP (0 or 1)
    d_ff: int                   # the dense MLP's width
    d_expert: int
    n_experts: int              # the router's outputs: every expert
    held: int                   # the routed experts held here
    offset: int                 # the first held expert's id
    top_k: int
    n_shared: int
    routed_scale: float

    @property
    def qk_dim(self) -> int:
        return self.nope_dim + self.rope_dim


def fields(c: dict) -> dict:
    if c["q_lora_rank"] is not None:
        raise ValueError("a query LoRA (q_lora_rank) is not written")
    if (c["scoring_func"], c["topk_method"], c["n_group"], c["topk_group"],
            c["moe_layer_freq"]) != ("sigmoid", "noaux_tc", 1, 1, 1):
        raise ValueError("written: the sigmoid noaux_tc router with one "
                         "group, a MoE layer in every layer after the dense "
                         "ones")
    if c["first_k_dense_replace"] not in (0, 1) or not c["norm_topk_prob"]:
        raise ValueError("written: at most one leading dense layer, the "
                         "chosen scores renormalised")
    held = c["n_routed_experts"]
    ranks = c.get("expert_parallel", {"ranks": 1, "rank": 0})
    n_experts = c.get("published", {}).get("n_routed_experts", held)
    if held * ranks["ranks"] != n_experts:
        raise ValueError(f"{ranks['ranks']} ranks of {held} experts do not "
                         f"make the router's {n_experts}")
    return dict(
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        vocab=c["vocab_size"], tied=c["tie_word_embeddings"],
        eps=c["rms_norm_eps"],
        sizes=Sizes(n_heads=c["num_attention_heads"],
                    kv_lora=c["kv_lora_rank"],
                    nope_dim=c["qk_nope_head_dim"],
                    rope_dim=c["qk_rope_head_dim"], v_dim=c["v_head_dim"],
                    rope_theta=float(c["rope_theta"]),
                    first_dense=c["first_k_dense_replace"],
                    d_ff=c["intermediate_size"],
                    d_expert=c["moe_intermediate_size"],
                    n_experts=n_experts, held=held,
                    offset=ranks["rank"] * held,
                    top_k=c["num_experts_per_tok"],
                    n_shared=c["n_shared_experts"],
                    routed_scale=float(c["routed_scaling_factor"])))


# {init: (the sample weights.py draws, its value from that sample)}
INITS = {"select_bias": ("uniform", lambda z: 0.1 * (z - 0.5))}


def prefix(spec: Spec, i: int) -> str:
    """Layer i's names in the program: `layer0.` for the dense layer,
    `layers.<j>.` for the j-th MoE layer."""
    first = spec.sizes.first_dense
    return "layer0." if i < first else f"layers.{i - first}."


def _ffn_mat(name: str, i: int, o: int) -> Leaf:
    """A matrix of a MLP or expert: its FLOPs are `flops_per_token`'s."""
    return dataclasses.replace(mat(name, i, o), matmul=False)


def leaves(spec: Spec) -> List[Leaf]:
    d, z, out = spec.d_model, spec.sizes, []
    h = z.n_heads
    for i in range(spec.n_layers):
        p = prefix(spec, i)
        out += [vec(p + "ln1.w", d, "norm"),
                mat(p + "attn.wq", d, h * z.qk_dim),
                mat(p + "attn.wdkv", d, z.kv_lora),
                mat(p + "attn.wkr", d, z.rope_dim),
                mat(p + "attn.wuk", z.kv_lora, h * z.nope_dim),
                mat(p + "attn.wuv", z.kv_lora, h * z.v_dim),
                mat(p + "attn.wo", h * z.v_dim, d),
                vec(p + "attn.kv_norm", z.kv_lora, "norm"),
                vec(p + "ln2.w", d, "norm")]
        if i < z.first_dense:
            out += [_ffn_mat(p + "mlp.gate", d, z.d_ff),
                    _ffn_mat(p + "mlp.up", d, z.d_ff),
                    _ffn_mat(p + "mlp.down", z.d_ff, d)]
            continue
        f, e, sh = z.d_expert, z.held, z.n_shared * z.d_expert
        out += [Leaf(p + "moe.router", (d, z.n_experts), "float32", "normal",
                     d ** -0.5),
                Leaf(p + "moe.w_gate", (e, d, f), "bfloat16", "normal",
                     d ** -0.5),
                Leaf(p + "moe.w_up", (e, d, f), "bfloat16", "normal",
                     d ** -0.5),
                Leaf(p + "moe.w_down", (e, f, d), "bfloat16", "normal",
                     f ** -0.5),
                _ffn_mat(p + "moe.shared_gate", d, sh),
                _ffn_mat(p + "moe.shared_up", d, sh),
                _ffn_mat(p + "moe.shared_down", sh, d),
                vec(p + "moe.select_bias", z.n_experts, "select_bias")]
    return out


def mixer_cost(spec: Spec, b: int, s: int):
    """One layer's MLA over b x s, bf16 operands: the causal pairs' scores
    (no-RoPE and RoPE parts) and probabilities times V; q, the latent and
    the RoPE key read and the output written once.  The projections and
    the decompression are the layer's matrices (2 FLOPs a weight and
    token)."""
    z = spec.sizes
    pairs = s * (s + 1) / 2
    nbytes = 2.0 * b * s * (z.n_heads * (z.qk_dim + z.v_dim) + z.kv_lora
                            + z.rope_dim)
    return nbytes, 2.0 * b * z.n_heads * pairs * (z.qk_dim + z.v_dim)


def flops_per_token(spec: Spec) -> float:
    """The mean over the layers of a token's FLOPs in the dense MLP or in
    the MoE layer: the router, the shared experts, and top_k x held /
    n_experts routed experts, the held experts' share at their expected
    load."""
    d, z = spec.d_model, spec.sizes
    dense = 2.0 * 3 * d * z.d_ff
    moe = 2.0 * (d * z.n_experts + 3 * d * z.d_expert * z.n_shared
                 + z.top_k * z.held / z.n_experts * 3 * d * z.d_expert)
    return (z.first_dense * dense
            + (spec.n_layers - z.first_dense) * moe) / spec.n_layers


def kernels(spec: Spec, b: int, s: int) -> dict:
    """No kernel of the port runs on this family's path."""
    return {}


def program(spec: Spec) -> dict:
    z = spec.sizes
    return dict(
        name=spec.name, family="moe", n_layers=spec.n_layers,
        d_model=spec.d_model, n_heads=z.n_heads, n_kv_heads=z.n_heads,
        d_ff=z.d_expert, vocab=spec.vocab, norm="rms", mlp="swiglu",
        rope_theta=z.rope_theta, tie_embeddings=spec.tied,
        norm_eps=spec.eps,
        mla=dict(kv_lora=z.kv_lora, nope_dim=z.nope_dim,
                 rope_dim=z.rope_dim, v_dim=z.v_dim,
                 rope_theta=z.rope_theta),
        moe=dict(num_experts=z.n_experts, top_k=z.top_k,
                 d_expert=z.d_expert, n_shared=z.n_shared,
                 first_dense=z.first_dense == 1, dense_d_ff=z.d_ff,
                 score="sigmoid", routed_scale=z.routed_scale,
                 select_bias=True, held=z.held, held_offset=z.offset))
