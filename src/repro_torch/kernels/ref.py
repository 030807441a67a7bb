"""Plain PyTorch oracles, under the reference's names
(repro/kernels/ref.py).  The five kernels of the engine's path keep their
plain version beside the kernel; this module gathers them, plus the three
decoders whose kernels are not ported yet (used by compression's
`decode_torch`)."""

from __future__ import annotations

import torch

from .colscan import colscan_plain as colscan_ref
from .dictdecode import fused_decode_scan_plain as fused_decode_scan_ref
from .groupby_mxu import groupby_sum_plain as groupby_sum_ref
from .radix_partition import radix_partition_plain
from .segmented_merge import segmented_merge_plain as segmented_merge_ref

__all__ = ["colscan_ref", "fused_decode_scan_ref", "groupby_sum_ref",
           "radix_partition_plain", "segmented_merge_ref", "dict_decode_ref",
           "rle_decode_ref", "bitpack_decode_ref"]


def dict_decode_ref(codes: torch.Tensor, dictionary: torch.Tensor
                    ) -> torch.Tensor:
    return dictionary[codes.to(torch.int64)]


def rle_decode_ref(run_values: torch.Tensor, run_ends: torch.Tensor,
                   n: int) -> torch.Tensor:
    """run_ends are cumulative (exclusive) end positions; output length n."""
    pos = torch.arange(n, device=run_ends.device, dtype=run_ends.dtype)
    idx = torch.searchsorted(run_ends, pos, right=True)
    return run_values[idx]


def bitpack_decode_ref(words: torch.Tensor, bit_width: int, bias: int,
                       n: int) -> torch.Tensor:
    """Unpack `32 // bit_width` lanes per uint32 word, plus the bias, to
    int64.  Words arrive as int64 values (torch has no CPU `>>` for
    uint32)."""
    per_word = 32 // bit_width
    shifts = torch.arange(per_word, device=words.device,
                          dtype=torch.int64) * bit_width
    lanes = (words.to(torch.int64)[:, None] >> shifts[None, :]) \
        & ((1 << bit_width) - 1)
    return lanes.reshape(-1)[:n] + int(bias)
