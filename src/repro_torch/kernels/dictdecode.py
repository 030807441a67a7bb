"""Dictionary decode fused into the filter + aggregate scan (paper §3.2).

`fused_decode_scan(codes, dictionary, agg_col, lo, hi)` is `colscan` with
the filter value of row i taken as `dictionary[codes[i]]`; a code outside
[0, len(dictionary)) — the pad code d of the TPU kernel — reads NaN and so
fails both bounds.

On a CUDA tensor the wrapper launches `csrc/scan.cu` with its DictGather
policy (it replaces repro/kernels/dictdecode.py:fused_decode_scan): the
int32 codes stream from HBM, the dictionary (at most 4096 values) stays
in L1, and the decoded filter column never exists.  On CPU tensors it runs
`fused_decode_scan_plain`.

The other decoders of the reference module (dict_decode, bitpack_decode,
rle_decode) are not on the engine's path and are not ported yet.
"""

from __future__ import annotations

import torch

from ._common import check_cuda_operand, count_launch, on_cpu
from .colscan import colscan_plain, launch_scan

LAUNCHES = {"count": 0}


def fused_decode_scan_plain(codes: torch.Tensor, dictionary: torch.Tensor,
                            agg_col: torch.Tensor, lo, hi) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    d = dictionary.shape[0]
    padded = torch.cat([dictionary.to(torch.float64),
                        torch.full((1,), float("nan"), dtype=torch.float64,
                                   device=dictionary.device)])
    c = codes.to(torch.int64)
    c = torch.where((c >= 0) & (c < d), c, torch.full_like(c, d))
    return colscan_plain(padded[c], agg_col, lo, hi)


def fused_decode_scan(codes: torch.Tensor, dictionary: torch.Tensor,
                      agg_col: torch.Tensor, lo, hi) -> torch.Tensor:
    if on_cpu(codes, dictionary, agg_col):
        return fused_decode_scan_plain(codes, dictionary, agg_col, lo, hi)
    n = int(codes.shape[0])
    check_cuda_operand(codes, "codes")
    check_cuda_operand(dictionary, "dictionary")
    check_cuda_operand(agg_col, "agg_col", n)
    if codes.dtype != torch.int32:
        raise TypeError(f"codes must be int32, got {codes.dtype}")
    out = launch_scan("fused_decode_scan", dictionary, codes, agg_col, n,
                      lo, hi)
    count_launch(LAUNCHES)
    return out
