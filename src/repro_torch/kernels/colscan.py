"""Fused filter + aggregate column scan (paper §6.2.1–6.2.2).

`colscan(filter_col, agg_col, lo, hi)` returns the float64 tensor
[count, sum, min, max] of `agg_col` over the rows with
`lo <= filter_col <= hi`.  NaN filter values fail both bounds, even when a
bound is ±inf.  An empty selection gives [0, 0, +inf, -inf].

On a CUDA tensor the wrapper launches `csrc/scan.cu` (PlainFilter policy;
see the note there: it replaces repro/kernels/colscan.py:colscan, is
bound by the bytes it reads, and folds per-block partials in a fixed
order).  On CPU tensors it runs `colscan_plain`, the same arithmetic in
PyTorch.  Accumulation is float64 on both.
"""

from __future__ import annotations

import torch

from . import _build
from ._common import (check_cuda_operand, count_launch, grid_blocks,
                      on_cpu)

# launches of the CUDA kernel (one per wrapper call that reached the card)
LAUNCHES = {"colscan": 0}


def colscan_plain(filter_col: torch.Tensor, agg_col: torch.Tensor,
                  lo, hi) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    f = filter_col.to(torch.float64)
    a = agg_col.to(torch.float64)
    mask = (f >= float(lo)) & (f <= float(hi))
    if a.numel() == 0:
        inf = float("inf")
        return torch.tensor([0.0, 0.0, inf, -inf], dtype=torch.float64,
                            device=a.device)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=a.device)
    cnt = mask.sum().to(torch.float64)
    s = torch.where(mask, a, torch.zeros_like(a)).sum()
    mn = torch.where(mask, a, inf).min()
    mx = torch.where(mask, a, -inf).max()
    return torch.stack([cnt, s, mn, mx])


def launch_scan(name: str, filt: torch.Tensor, codes, agg_col: torch.Tensor,
                n: int, lo, hi) -> torch.Tensor:
    """One call of csrc/scan.cu: `filt` is the filter column, or with
    `codes` the dictionary gathered through them."""
    nb = grid_blocks(n)
    dev = agg_col.device
    partials = torch.empty(4 * nb, dtype=torch.float64, device=dev)
    out = torch.empty(4, dtype=torch.float64, device=dev)
    rc = _build.kernel_fn("scan")(
        filt.data_ptr(), _build.dtype_code(filt),
        codes.data_ptr() if codes is not None else None,
        int(filt.shape[0]) if codes is not None else 0,
        agg_col.data_ptr(), _build.dtype_code(agg_col), n,
        float(lo), float(hi), partials.data_ptr(), nb, out.data_ptr(),
        _build.stream_handle(dev))
    _build.check_launch(name, rc)
    return out


def colscan(filter_col: torch.Tensor, agg_col: torch.Tensor, lo, hi
            ) -> torch.Tensor:
    if on_cpu(filter_col, agg_col):
        return colscan_plain(filter_col, agg_col, lo, hi)
    n = int(filter_col.shape[0])
    check_cuda_operand(filter_col, "filter_col")
    check_cuda_operand(agg_col, "agg_col", n)
    out = launch_scan("colscan", filter_col, None, agg_col, n, lo, hi)
    count_launch(LAUNCHES, "colscan")
    return out
