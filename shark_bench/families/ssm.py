"""Family "ssm": Mamba2 (arXiv:2405.21060), one Mamba2 block in every
layer, the configuration's keys as mamba_ssm's config.json names them
(`ssm_cfg` holds the block's widths)."""

from __future__ import annotations

import dataclasses
import math
from typing import List

import torch

from shark_bench import yardstick
from shark_bench.spec import Leaf, Spec, mat, vec


@dataclasses.dataclass(frozen=True)
class Sizes:
    d_state: int
    d_conv: int
    expand: int
    headdim: int
    ngroups: int
    chunk: int
    d_inner: int                # expand * d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ngroups * self.d_state


def fields(c: dict) -> dict:
    s = c["ssm_cfg"]
    pad = c["pad_vocab_size_multiple"]
    return dict(
        n_layers=c["n_layer"], d_model=c["d_model"],
        vocab=-(-c["vocab_size"] // pad) * pad, tied=c["tie_embeddings"],
        eps=c["norm_epsilon"],
        sizes=Sizes(d_state=s["d_state"], d_conv=s["d_conv"],
                    expand=s["expand"], headdim=s["headdim"],
                    ngroups=s["ngroups"], chunk=s["chunk_size"],
                    d_inner=s["expand"] * c["d_model"]))


def _dt_bias(z):                     # softplus(dt_bias) in [1e-3, 0.1]
    dt = torch.exp(math.log(1e-3) + z * (math.log(0.1) - math.log(1e-3)))
    return dt + torch.log(-torch.expm1(-dt))


# {init: (the sample weights.py draws, its value from that sample)}
INITS = {
    "conv_b": ("uniform", lambda z: 0.2 * (z - 0.5)),
    # A = -exp(A_log) in [-16, -1]
    "A_log": ("uniform", lambda z: torch.log(1.0 + 15.0 * z)),
    "dt_bias": ("uniform", _dt_bias),
}


def leaves(spec: Spec) -> List[Leaf]:
    d, z, out = spec.d_model, spec.sizes, []
    di, nh = z.d_inner, z.ssm_heads
    for i in range(spec.n_layers):
        p = f"layers.{i}."
        out += [vec(p + "ln.w", d, "norm"),
                mat(p + "mamba.in_proj", d,
                    2 * di + 2 * z.ngroups * z.d_state + nh),
                Leaf(p + "mamba.conv_w", (z.conv_dim, z.d_conv), "bfloat16",
                     "normal", 0.1),
                vec(p + "mamba.conv_b", z.conv_dim, "conv_b"),
                vec(p + "mamba.A_log", nh, "A_log"),
                vec(p + "mamba.D", nh, "norm"),
                vec(p + "mamba.dt_bias", nh, "dt_bias"),
                vec(p + "mamba.norm_w", di, "norm"),
                mat(p + "mamba.out_proj", di, d)]
    return out


def mixer_cost(spec: Spec, b: int, s: int):
    """One layer's SSD scan over b x s, bf16 operands."""
    z = spec.sizes
    return yardstick.ssd_cost(b, s, z.ssm_heads, z.headdim, z.d_state, 2,
                              z.ngroups)


def flops_per_token(spec: Spec) -> float:
    """The depthwise causal convolution's multiply-adds, per token and
    layer (2 FLOPs a tap)."""
    return 2.0 * spec.sizes.conv_dim * spec.sizes.d_conv


def kernels(spec: Spec, b: int, s: int) -> dict:
    z = spec.sizes
    return {"ssd_fwd": (spec.n_layers, mixer_cost(spec, b, s)),
            "ssd_bwd": (spec.n_layers, yardstick.ssd_bwd_cost(
                b, s, z.ssm_heads, z.headdim, z.d_state, 2, z.ngroups))}


def program(spec: Spec) -> dict:
    z = spec.sizes
    return dict(
        name=spec.name, family="ssm", n_layers=spec.n_layers,
        d_model=spec.d_model, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab=spec.vocab, norm="rms", rope_theta=0.0,
        tie_embeddings=spec.tied, sub_quadratic=True, norm_eps=spec.eps,
        ssm=dict(d_state=z.d_state, expand=z.expand, headdim=z.headdim,
                 ngroups=z.ngroups, d_conv=z.d_conv, chunk=z.chunk))
