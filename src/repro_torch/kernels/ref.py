"""Plain PyTorch oracles, under the reference's names
(repro/kernels/ref.py).  Every kernel of the port keeps its plain version
beside the kernel; this module gathers them."""

from __future__ import annotations

from .colscan import colscan_plain as colscan_ref
from .dictdecode import bitpack_decode_plain as bitpack_decode_ref
from .dictdecode import dict_decode_plain as dict_decode_ref
from .dictdecode import fused_decode_scan_plain as fused_decode_scan_ref
from .dictdecode import rle_decode_plain as rle_decode_ref
from .groupby_mxu import groupby_sum_plain as groupby_sum_ref
from .radix_partition import radix_partition_plain
from .segmented_merge import segmented_merge_plain as segmented_merge_ref
from .topk_similarity import topk_similarity_plain as topk_similarity_ref
from .train_grad import train_grad_plain as train_grad_ref

__all__ = ["colscan_ref", "fused_decode_scan_ref", "groupby_sum_ref",
           "radix_partition_plain", "segmented_merge_ref", "dict_decode_ref",
           "rle_decode_ref", "bitpack_decode_ref", "topk_similarity_ref",
           "train_grad_ref"]
