"""Mixture-of-Experts layer: top-k routing with capacity, shared experts,
and the routing statistics (PDE-style load: `expert_load` is the paper's
heavy-hitter statistic).

Dispatch is the reference's permutation form: token -> expert assignments
sort by expert id, each assignment's slot is its rank in its expert's run,
and an (E, C, D) capacity buffer goes through the experts as three batched
matrix products.  Plain PyTorch, as the reference's is plain JAX (no
Pallas kernel on this path).  Where torch's primitives promise less than
JAX's, the port pins the reference's choice down, since each changes which
tokens drop or what they add up to:
- top-k ties: `lax.top_k` puts the lower expert first among equal gates;
  the port takes the top k of a stable descending sort;
- the sort by expert is stable (`jnp.argsort`'s default), so the last
  tokens of an overloaded expert are the ones dropped;
- `mode="drop"`: dropped assignments are scattered into one spare row
  (a buffer of cap + 1 rows) that is sliced off, and their gathered rows
  are zeroed;
- the combine: each token has exactly k assignments in order, so the
  float32 sum over them is a sum over k of (T, k, D), which is
  deterministic on the card (`index_add_` there uses atomics);
- `cap` uses Python's `round` (half to even), as the reference does.

`moe_apply_ep` (`moe_impl="ep_shardmap"`, expert parallelism over a mesh
of cards) is not ported: `models/lm.check_ported` raises for it (ROADMAP
A.5).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from .common import _param, normal, swiglu


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int            # per-expert FFN width
    n_shared: int = 0        # always-on shared experts (DeepSeek style)
    capacity_factor: float = 1.25
    first_dense: bool = False  # layer 0 uses a dense MLP (DeepSeek-V2)
    dense_d_ff: int = 0


class MoE(nn.Module):
    """One layer of `moe_init`'s parameters, as the LM's stacked layers
    draw them: `router` (d, E) float32; `w_gate`, `w_up` (E, d, d_expert)
    and `w_down` (E, d_expert, d); with `n_shared > 0`, `shared_gate`,
    `shared_up` (d, n_shared * d_expert) and `shared_down`.  Every matrix
    is N(0, 1/in) (the reference's `stacked_dense_init`; its unstacked
    `moe_init` alone draws the router at std 0.02)."""

    def __init__(self, d_model: int, cfg: MoEConfig, dtype=torch.bfloat16,
                 device=None, generator=None):
        super().__init__()
        e = cfg.num_experts

        def mk(shape, dt=dtype):
            return _param(normal(shape, 1.0 / math.sqrt(shape[-2]), dt,
                                 device, generator))

        self.router = mk((d_model, e), torch.float32)
        self.w_gate = mk((e, d_model, cfg.d_expert))
        self.w_up = mk((e, d_model, cfg.d_expert))
        self.w_down = mk((e, cfg.d_expert, d_model))
        if cfg.n_shared > 0:
            sh_ff = cfg.d_expert * cfg.n_shared
            self.shared_gate = mk((d_model, sh_ff))
            self.shared_up = mk((d_model, sh_ff))
            self.shared_down = mk((sh_ff, d_model))


def capacity(t: int, cfg: MoEConfig, dropless: bool = False) -> int:
    """Slots an expert holds for t tokens: t when dropless, else
    max(1, round(t * k / E * capacity_factor))."""
    if dropless:
        return t
    return int(max(1, round(t * cfg.top_k / cfg.num_experts
                            * cfg.capacity_factor)))


def moe_apply(p: MoE, x: torch.Tensor, cfg: MoEConfig,
              return_stats: bool = False, dropless: bool = False):
    """x: (B, S, D) -> (B, S, D).  Permutation dispatch with capacity drop.

    `dropless=True` sizes every expert's buffer to the worst case (one
    slot per token) so nothing drops: decode uses it, where token counts
    are tiny and batch-dependent drops would break prefill/decode
    equivalence.  With `return_stats`, also {"expert_load" (E,) float32
    assignment counts, "frac_dropped" float32, "router_entropy"
    float32}."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    xf = x.reshape(t, d)

    logits = xf.float() @ p.router                              # (T, E)
    gates = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    topw, topi = srt[:, :k], idx[:, :k]                         # (T, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    cap = capacity(t, cfg, dropless)

    # flatten assignments, sort by expert, slot = rank within expert run
    flat_e = topi.reshape(-1)                                   # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first_idx = torch.searchsorted(sorted_e, sorted_e, side="left")
    slot_sorted = torch.arange(t * k, device=x.device) - first_idx
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted

    tok_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    keep = slot < cap
    # scatter tokens into (E, cap + 1, D): the dropped assignments all go
    # to the spare row `cap`, which is then sliced off
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[flat_e, torch.where(keep, slot, cap)] = xf[tok_idx]
    buf = buf[:, :cap]

    # expert FFN: batched matrix products over the expert axis
    out_buf = swiglu(buf, p.w_gate, p.w_up, p.w_down)

    # gather back, weight, combine over k (k assignments a token, in order)
    gathered = out_buf[flat_e, torch.where(keep, slot, 0)]      # (T*k, D)
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=x.dtype, device=x.device))
    weighted = gathered.float() * topw.reshape(-1)[:, None]
    yf = weighted.reshape(t, k, d).sum(dim=1)
    y = yf.to(x.dtype).reshape(b, s, d)

    if cfg.n_shared > 0:
        sh = swiglu(xf, p.shared_gate, p.shared_up, p.shared_down)
        y = y + sh.reshape(b, s, d)

    if not return_stats:
        return y
    load = torch.bincount(flat_e, minlength=e).float()          # per expert
    frac_dropped = 1.0 - keep.sum() / (t * k)
    entropy = -torch.mean(torch.sum(gates * torch.log(gates + 1e-9), -1))
    return y, {"expert_load": load, "frac_dropped": frac_dropped,
               "router_entropy": entropy}


def load_balance_loss(logits_gates_load) -> torch.Tensor:
    """Switch-style aux loss from (gates, load)."""
    gates, load = logits_gates_load
    e = gates.shape[-1]
    me = torch.mean(gates, dim=0)
    pe = load / torch.clamp(torch.sum(load), min=1.0)
    return e * torch.sum(me * pe)
