"""Small-NDV group-by aggregation (paper §6.3.1, §6.4).

`groupby_sum(codes, values, num_groups)` returns the (num_groups, 2)
float64 tensor of per-group [sum, count] for group ids in
[0, num_groups); other ids contribute nothing.  The caller rounds counts.

On a CUDA tensor the wrapper launches `csrc/group.cu` without the min/max
lanes (it replaces repro/kernels/groupby_mxu.py:groupby_sum, whose one-hot
MXU matmul has no reason to exist on Hopper: the kernel adds each row into
shared-memory group accumulators, see the note in the source).  On CPU
tensors it runs `groupby_sum_plain`.  The module keeps the reference's
name so the route string `groupby_mxu` reads the same in both packages.
"""

from __future__ import annotations

import torch

from . import _build
from ._common import (check_cuda_operand, count_launch, grid_blocks,
                      on_cpu)

LAUNCHES = {"groupby_sum": 0}
MAX_GROUPS = 1024      # shared-memory accumulators per block (group.cu)


def _valid(codes: torch.Tensor, num_groups: int):
    c = codes.to(torch.int64)
    ok = (c >= 0) & (c < num_groups)
    return c[ok], ok


def groupby_sum_plain(codes: torch.Tensor, values: torch.Tensor,
                      num_groups: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    c, ok = _valid(codes, num_groups)
    v = values.to(torch.float64)[ok]
    sums = torch.zeros(num_groups, dtype=torch.float64, device=v.device)
    sums.index_add_(0, c, v)
    cnts = torch.bincount(c, minlength=num_groups).to(torch.float64)
    return torch.stack([sums, cnts], dim=1)


def launch_group(name: str, codes: torch.Tensor, values: torch.Tensor,
                 num_groups: int, with_minmax: bool) -> torch.Tensor:
    """One call of csrc/group.cu; returns (G, 4 if with_minmax else 2)."""
    n = int(codes.shape[0])
    check_cuda_operand(codes, "codes")
    check_cuda_operand(values, "values", n)
    if codes.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"codes must be int32 or int64, got {codes.dtype}")
    if not 1 <= num_groups <= MAX_GROUPS:
        raise ValueError(f"{name} kernel takes 1..{MAX_GROUPS} groups, "
                         f"got {num_groups}")
    nb = grid_blocks(n, rows_per_thread=8)
    dev = codes.device
    scratch = torch.empty(5 * nb * num_groups, dtype=torch.float64,
                          device=dev)
    width = 4 if with_minmax else 2
    out = torch.empty((num_groups, width), dtype=torch.float64, device=dev)
    rc = _build.kernel_fn("group")(
        codes.data_ptr(), _build.dtype_code(codes), values.data_ptr(),
        _build.dtype_code(values), n, int(num_groups), int(with_minmax),
        scratch.data_ptr(), nb, out.data_ptr(), _build.stream_handle(dev))
    _build.check_launch(name, rc)
    return out


def groupby_sum(codes: torch.Tensor, values: torch.Tensor,
                num_groups: int) -> torch.Tensor:
    if on_cpu(codes, values):
        return groupby_sum_plain(codes, values, num_groups)
    out = launch_group("groupby_sum", codes, values, num_groups, False)
    count_launch(LAUNCHES, "groupby_sum")
    return out
