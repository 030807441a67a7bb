"""Mixture-of-Experts configuration.

Only the dataclass the config registry needs is ported so far; the routed
layer itself (`moe_init`, `moe_apply`) waits for the MoE slice (ROADMAP
A.5).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int            # per-expert FFN width
    n_shared: int = 0        # always-on shared experts (DeepSeek style)
    capacity_factor: float = 1.25
    first_dense: bool = False  # layer 0 uses a dense MLP (DeepSeek-V2)
    dense_d_ff: int = 0
