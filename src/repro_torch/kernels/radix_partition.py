"""Map-side shuffle bucketing (radix partition, paper §5).

`radix_partition(keys_u32, num_buckets, with_counts)` returns int32 bucket
ids `mix_u32(key) % num_buckets` for pre-folded 32-bit key hashes and,
with `with_counts`, the int32 per-bucket histogram (exact at any size);
otherwise `(ids, None)`.  Ids are bit-identical to `radix_partition_ref`.

Keys arrive as a torch.uint32 tensor, or as int32 holding the same bits.
On a CUDA tensor the wrapper launches `csrc/radix.cu` (it replaces
repro/kernels/radix_partition.py:radix_partition, both variants; see the
note in the source).  On CPU tensors it runs `radix_partition_plain`.

PyTorch on the CPU implements neither `>>` nor `%` for torch.uint32, so
the plain `mix_u32` and `fold_keys_u32` compute in int64 and mask with
0xFFFFFFFF after every multiply and shift; multiplies are split in 16-bit
halves so no int64 product overflows.

Like the reference, the 32-bit mix assigns buckets differently from the
host partitioner's 64-bit mix; a shuffle fixes its route per partitioner,
so equal keys always land in equal buckets.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from ._common import (check_cuda_operand, count_launch, grid_blocks,
                      on_cpu)

LAUNCHES = {"radix_partition": 0}
MAX_BUCKETS = 8192     # shared-memory histogram per block (radix.cu)

_GOLDEN32 = 2654435761          # 2^32 / phi, Knuth's constant
_MIX2 = 0x85EBCA6B
_M32 = 0xFFFFFFFF


def fold_keys_u32(keys):
    """Fold int64 key hashes into uint32 lanes: xor of the two 32-bit
    halves.  numpy in, numpy uint32 out (as in the reference); a torch
    int64 tensor in, an int64 tensor of the same values out."""
    if isinstance(keys, torch.Tensor):
        k = keys.to(torch.int64)
        # arithmetic >> sign-extends, but the mask keeps only bits the
        # logical shift of the reference would also give
        return (k ^ (k >> 32)) & _M32
    k = np.asarray(keys).astype(np.int64, copy=False).view(np.uint64)
    return ((k ^ (k >> np.uint64(32))) & np.uint64(_M32)).astype(np.uint32)


def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix_u32(h: torch.Tensor) -> torch.Tensor:
    """The radix hash mix on an int64 tensor of uint32 values."""
    h = _mul_u32(h, _GOLDEN32)
    h = h ^ (h >> 15)
    h = _mul_u32(h, _MIX2)
    return h ^ (h >> 13)


def _as_u32_values(keys: torch.Tensor) -> torch.Tensor:
    if keys.dtype in (torch.uint32, torch.int32):
        return keys.view(torch.int32).to(torch.int64) & _M32
    return keys.to(torch.int64) & _M32


def radix_partition_plain(keys_u32: torch.Tensor, num_buckets: int,
                          with_counts: bool = True):
    """Plain PyTorch version of the kernel (any device)."""
    b = (mix_u32(_as_u32_values(keys_u32)) % int(num_buckets)).to(
        torch.int32)
    if not with_counts:
        return b, None
    counts = torch.bincount(b.to(torch.int64), minlength=int(num_buckets))
    return b, counts.to(torch.int32)


def radix_partition(keys_u32: torch.Tensor, num_buckets: int,
                    with_counts: bool = True):
    if on_cpu(keys_u32):
        return radix_partition_plain(keys_u32, num_buckets, with_counts)
    check_cuda_operand(keys_u32, "keys")
    if keys_u32.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"keys must be uint32 (or int32 bits), got "
                        f"{keys_u32.dtype}")
    if not 1 <= num_buckets <= MAX_BUCKETS:
        raise ValueError(f"radix kernel takes 1..{MAX_BUCKETS} buckets, "
                         f"got {num_buckets}")
    n = int(keys_u32.shape[0])
    dev = keys_u32.device
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    counts = (torch.zeros(int(num_buckets), dtype=torch.int32, device=dev)
              if with_counts else None)
    rc = _build.kernel_fn("radix")(
        keys_u32.data_ptr(), n, int(num_buckets), ids.data_ptr(),
        counts.data_ptr() if counts is not None else None,
        grid_blocks(n), _build.stream_handle(dev))
    _build.check_launch("radix_partition", rc)
    count_launch(LAUNCHES, "radix_partition")
    return ids, counts


def radix_partition_ref(keys_u32: np.ndarray, num_buckets: int):
    """Numpy oracle for the hash mix and histogram (the reference's own,
    kept here so the port imports nothing of it)."""
    k = np.asarray(keys_u32, np.uint32)
    h = (k * np.uint32(_GOLDEN32)).astype(np.uint32)
    h = h ^ (h >> np.uint32(15))
    h = (h * np.uint32(_MIX2)).astype(np.uint32)
    h = h ^ (h >> np.uint32(13))
    b = (h % np.uint32(num_buckets)).astype(np.int32)
    return b, np.bincount(b, minlength=num_buckets).astype(np.int32)
