"""Segmented reduce-side merge (DESIGN.md §11).

`segmented_merge(codes, values, num_groups)` returns the (num_groups, 4)
float64 tensor of per-group [sum, count, min, max] of one float state
column; an empty group reports count 0 and the ±inf min / max identities.
Integer states never come here (they stay on the int64-exact compiled
merge in core/aggregate.py).

On a CUDA tensor the wrapper launches `csrc/group.cu` with its min / max
lanes (it replaces repro/kernels/segmented_merge.py:segmented_merge; see
the note in the source).  On CPU tensors it runs `segmented_merge_plain`.
"""

from __future__ import annotations

import torch

from ._common import count_launch, on_cpu
from .groupby_mxu import _valid, groupby_sum_plain, launch_group

LAUNCHES = {"count": 0}


def segmented_merge_plain(codes: torch.Tensor, values: torch.Tensor,
                          num_groups: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device).  Min and max start
    from the ±inf identities with include_self=True, so empty groups keep
    them (include_self=False would leave 0 there)."""
    sc = groupby_sum_plain(codes, values, num_groups)
    c, ok = _valid(codes, num_groups)
    v = values.to(torch.float64)[ok]
    inf = float("inf")
    mn = torch.full((num_groups,), inf, dtype=torch.float64, device=v.device)
    mx = torch.full((num_groups,), -inf, dtype=torch.float64,
                    device=v.device)
    mn = mn.scatter_reduce(0, c, v, "amin", include_self=True)
    mx = mx.scatter_reduce(0, c, v, "amax", include_self=True)
    return torch.cat([sc, mn[:, None], mx[:, None]], dim=1)


def segmented_merge(codes: torch.Tensor, values: torch.Tensor,
                    num_groups: int) -> torch.Tensor:
    if on_cpu(codes, values):
        return segmented_merge_plain(codes, values, num_groups)
    out = launch_group("segmented_merge", codes, values, num_groups, True)
    count_launch(LAUNCHES)
    return out
