"""A model configuration file as the benchmark reads it: the published
widths (`configs/<name>.json`, keys as the source's config.json names them)
in one shape that the weights, the reference and the work formulas share.

Nothing here imports the program: the adapter (`port.py`) turns a `Spec`
into the program's own configuration.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class Spec:
    name: str
    family: str                 # dense | ssm
    n_layers: int
    d_model: int
    vocab: int                  # rows of the embedding (padded, as run)
    tied: bool
    eps: float
    # dense
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    qkv_bias: bool = False
    rope_theta: float = 0.0
    # ssm
    d_state: int = 0
    d_conv: int = 0
    expand: int = 0
    headdim: int = 0
    ngroups: int = 0
    chunk: int = 0

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.headdim if self.headdim else 0

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ngroups * self.d_state


def load_spec(path: Path) -> Spec:
    """The Spec of one configuration file."""
    c = json.loads(Path(path).read_text())
    if c["family"] == "dense":
        return Spec(
            name=c["name"], family="dense",
            n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
            vocab=c["vocab_size"], tied=c["tie_word_embeddings"],
            eps=c["rms_norm_eps"], n_heads=c["num_attention_heads"],
            n_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
            d_ff=c["intermediate_size"], qkv_bias=c["attention_bias"],
            rope_theta=c["rope_theta"])
    if c["family"] == "ssm":
        s = c["ssm_cfg"]
        pad = c["pad_vocab_size_multiple"]
        return Spec(
            name=c["name"], family="ssm", n_layers=c["n_layer"],
            d_model=c["d_model"], vocab=-(-c["vocab_size"] // pad) * pad,
            tied=c["tie_embeddings"], eps=c["norm_epsilon"],
            d_state=s["d_state"], d_conv=s["d_conv"], expand=s["expand"],
            headdim=s["headdim"], ngroups=s["ngroups"],
            chunk=s["chunk_size"])
    raise ValueError(f"{path}: family {c['family']!r} has no reader here")


# ---------------------------------------------------------------------------
# Leaves: every parameter, by the name the model's state uses
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    dtype: str                  # "bfloat16" | "float32"
    init: str                   # how weights.py draws it
    std: float = 0.0
    matmul: bool = False        # a weight of a matrix product (model FLOPs)


def leaves(spec: Spec) -> List[Leaf]:
    """Every parameter of the model in the order the weights are drawn:
    matrices (y = x @ w, w of shape (in, out)) and biases in bfloat16,
    norms and the SSM's vectors in float32."""
    d, out = spec.d_model, []

    def mat(name, i, o, std=None):
        out.append(Leaf(name, (i, o), "bfloat16", "normal",
                        std if std is not None else i ** -0.5, True))

    def vec(name, n, init, dtype="float32", std=0.0):
        out.append(Leaf(name, (n,), dtype, init, std))

    out.append(Leaf("embed.tok", (spec.vocab, d), "bfloat16", "normal", 0.02,
                    spec.tied))
    if not spec.tied:
        mat("lm_head", d, spec.vocab)
    vec("final_norm.w", d, "norm")
    for i in range(spec.n_layers):
        p = f"layers.{i}."
        if spec.family == "dense":
            h, kv, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
            vec(p + "ln1.w", d, "norm")
            mat(p + "attn.wq", d, h * hd)
            mat(p + "attn.wk", d, kv * hd)
            mat(p + "attn.wv", d, kv * hd)
            mat(p + "attn.wo", h * hd, d)
            if spec.qkv_bias:
                for nm, w in (("bq", h * hd), ("bk", kv * hd),
                              ("bv", kv * hd)):
                    vec(p + "attn." + nm, w, "normal", "bfloat16", 0.1)
            vec(p + "ln2.w", d, "norm")
            mat(p + "mlp.gate", d, spec.d_ff)
            mat(p + "mlp.up", d, spec.d_ff)
            mat(p + "mlp.down", spec.d_ff, d)
        else:
            di, nh = spec.d_inner, spec.ssm_heads
            vec(p + "ln.w", d, "norm")
            mat(p + "mamba.in_proj", d,
                2 * di + 2 * spec.ngroups * spec.d_state + nh)
            out.append(Leaf(p + "mamba.conv_w", (spec.conv_dim, spec.d_conv),
                            "bfloat16", "normal", 0.1))
            vec(p + "mamba.conv_b", spec.conv_dim, "conv_b")
            vec(p + "mamba.A_log", nh, "A_log")
            vec(p + "mamba.D", nh, "norm")
            vec(p + "mamba.dt_bias", nh, "dt_bias")
            vec(p + "mamba.norm_w", di, "norm")
            mat(p + "mamba.out_proj", di, d)
    return out


def n_params(spec: Spec) -> int:
    return sum(math.prod(leaf.shape) for leaf in leaves(spec))


def matmul_params(spec: Spec) -> int:
    """Weights that take part in a matrix product for every token: the
    layers' matrices and the head (the tied embedding counts as the head;
    an untied embedding is a lookup)."""
    return sum(math.prod(leaf.shape) for leaf in leaves(spec)
               if leaf.matmul)


def head_params(spec: Spec) -> int:
    return spec.d_model * spec.vocab


def conv_flops_per_token(spec: Spec) -> float:
    """The depthwise causal convolution's multiply-adds, per token and
    layer (2 FLOPs a tap)."""
    return 2.0 * spec.conv_dim * spec.d_conv if spec.family == "ssm" else 0.0
