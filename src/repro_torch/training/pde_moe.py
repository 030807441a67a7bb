"""Partial DAG Execution applied to MoE training (DESIGN.md §4): the
reference's `repro/training/pde_moe.py` on the port's statistics.

The MoE router's per-expert load vector is the paper's "heavy hitters"
statistic, the capacity factor its degree-of-parallelism knob, and the
step boundary its stage boundary.  `MoEReplanner` consumes the
`expert_load` that `models/moe.moe_apply(..., return_stats=True)` emits
(host numpy, one observation a step), keeps a lossy history of one byte
an expert a step (the paper's log-encoded size, `core/stats.encode_size`)
and re-selects the capacity factor, snapped to `CAPACITY_BUCKETS`, and
whether the hot experts should run densely.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..core.stats import decode_size, encode_size

CAPACITY_BUCKETS = (1.0, 1.25, 1.5, 2.0, 3.0)


@dataclasses.dataclass
class MoEPlan:
    capacity_factor: float
    hot_experts: List[int]
    dense_hot: bool
    reason: str


class MoEReplanner:
    def __init__(self, num_experts: int, top_k: int,
                 target_drop_rate: float = 0.0,
                 dense_hot_threshold: float = 0.5,
                 history: int = 16):
        self.num_experts = num_experts
        self.top_k = top_k
        self.dense_hot_threshold = dense_hot_threshold
        self.history = history
        # lossy history: one byte per expert per step (paper §3.1)
        self._codes: List[np.ndarray] = []

    def observe(self, expert_load) -> None:
        """One step's (E,) expert loads: numpy, or a tensor (copied to the
        host)."""
        if hasattr(expert_load, "detach"):
            expert_load = expert_load.detach().cpu().numpy()
        codes = np.array([encode_size(int(x)) for x in expert_load],
                         np.uint8)
        self._codes.append(codes)
        if len(self._codes) > self.history:
            self._codes.pop(0)

    def plan(self, tokens_per_step: int) -> MoEPlan:
        if not self._codes:
            return MoEPlan(1.25, [], False, "no statistics yet: default")
        loads = np.stack([[decode_size(int(c)) for c in row]
                          for row in self._codes])          # (steps, E)
        mean_load = loads.mean(axis=0)
        expected = tokens_per_step * self.top_k / self.num_experts
        peak = float(np.percentile(loads.max(axis=0), 99))
        cf_needed = peak / max(expected, 1.0)
        cf = next((b for b in CAPACITY_BUCKETS if b >= cf_needed),
                  CAPACITY_BUCKETS[-1])
        total = mean_load.sum()
        frac = mean_load / max(total, 1.0)
        hot = [int(i) for i in np.argsort(-frac)
               if frac[i] > self.dense_hot_threshold / self.num_experts * 4]
        dense_hot = bool(hot) and float(frac[hot].sum()) \
            > self.dense_hot_threshold
        return MoEPlan(
            cf, hot[:4], dense_hot,
            f"p99 load {peak:.0f} vs expected {expected:.0f} -> "
            f"cf {cf} (needed {cf_needed:.2f}); "
            f"{len(hot)} heavy-hitter experts carry "
            f"{float(frac[hot].sum()) if hot else 0:.0%}")

    def bucketed_capacity(self, tokens_per_step: int) -> float:
        """Snap to a bucket (one compiled variant each in the reference)."""
        return self.plan(tokens_per_step).capacity_factor
