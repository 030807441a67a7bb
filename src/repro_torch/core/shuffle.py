"""Shuffle partitioners (paper §3.1, §5 "Memory-based Shuffle").

Map output is materialized in worker memory (the BlockManager), never on
disk; the partitioner assigns rows to reduce buckets by a deterministic key
hash shared with DISTRIBUTE BY so co-partitioned tables align.

String keys hash through the partition dictionary — one crc32 per *distinct*
value, then an O(1) gather per row — so the shuffle path never materializes
a string (the columnar store making the shuffle CPU-cheap, §3.2).

`kernel=<device>` routes the hash-mix + modulo through the `radix_partition`
kernel on that device (GPU sessions, or forced routes on the CPU, where the
kernel's plain version runs; `kernel=True` means the CPU).  The choice is
fixed per partitioner, never per task: a shuffle's bucket assignment must
be one function of the key value on every map task, and the kernel's 32-bit
mix is a *different* (equally valid) function than the host's 64-bit mix.
"""

from __future__ import annotations

import weakref
import zlib
from typing import Callable, List, Optional, Sequence

import numpy as np

from .batch import PartitionBatch
from .columnar import hash_key_values

# diagnostic: how many partitioner calls took the radix kernel route
RADIX_KERNEL_CALLS = {"count": 0}

# Dictionaries are immutable load-time state, so their per-entry crc32
# hashes are derived metadata worth memoizing (the same partition
# dictionary is hashed by every query shuffling that partition) — the
# shuffle-side analogue of the memoized block decode in compression.py.
# Keyed by id() (ndarrays are not hashable) with a weakref finalizer
# evicting dead entries; the liveness check below guards id reuse.
_DICT_HASH_CACHE: dict = {}
_DICT_HASH_CACHE_MAX = 4096


def _dict_hashes(sdict: np.ndarray) -> np.ndarray:
    key = id(sdict)
    hit = _DICT_HASH_CACHE.get(key)
    if hit is not None and hit[0]() is sdict:
        return hit[1]
    hd = np.array([zlib.crc32(s.encode()) for s in sdict.tolist()],
                  dtype=np.int64)
    try:
        ref = weakref.ref(sdict,
                          lambda _r, k=key: _DICT_HASH_CACHE.pop(k, None))
    except TypeError:
        return hd   # un-weakref-able object: skip caching
    if len(_DICT_HASH_CACHE) >= _DICT_HASH_CACHE_MAX:
        _DICT_HASH_CACHE.clear()    # crude but bounded; hashes rebuild
    _DICT_HASH_CACHE[key] = (ref, hd)
    return hd


def _row_keys(batch: PartitionBatch, key: str) -> np.ndarray:
    v = batch.col(key)
    if v.is_string:
        return _dict_hashes(v.sdict)[np.asarray(v.arr)]
    return hash_key_values(np.asarray(v.arr))


def _mix_mod(k: np.ndarray, num_buckets: int) -> np.ndarray:
    h = k.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    h ^= h >> np.uint64(29)
    return (h % np.uint64(num_buckets)).astype(np.int32)


def _kernel_buckets(k: np.ndarray, num_buckets: int, device) -> np.ndarray:
    import torch

    from ..kernels import ops as kernel_ops
    from ..kernels.radix_partition import fold_keys_u32
    RADIX_KERNEL_CALLS["count"] += 1

    def launch(c: np.ndarray):
        # host fold (as in the reference), then the 32-bit lanes cross to
        # the device as int32 bits
        keys = torch.from_numpy(fold_keys_u32(c).view(np.int32)).to(device)
        return kernel_ops.radix_partition(keys, num_buckets=num_buckets,
                                          with_counts=False)[0]

    chunk = kernel_ops.DOUBLE_BUFFER["chunk_rows"]
    if len(k) >= 2 * chunk:
        # Double-buffered: fold+dispatch of chunk i+1 overlaps compute of
        # chunk i (DESIGN.md §14).  Bucket id is per-row, so chunked and
        # single-shot results are bit-identical.
        parts = kernel_ops.double_buffer_map(
            launch, [k[i:i + chunk] for i in range(0, len(k), chunk)])
        return np.concatenate(parts)
    return launch(k).cpu().numpy()


def _kernel_device(kernel):
    """None for the host route, else the device the radix kernel runs on."""
    if kernel is None or kernel is False:
        return None
    return "cpu" if kernel is True else kernel


def bucket_by_hash(key: str, num_buckets: int, kernel=None
                   ) -> Callable[[PartitionBatch], np.ndarray]:
    from .batch import EXCHANGE_TIMERS
    device = _kernel_device(kernel)

    def partitioner(batch: PartitionBatch) -> np.ndarray:
        import time
        t0 = time.perf_counter()
        k = _row_keys(batch, key)
        out = (_kernel_buckets(k, num_buckets, device) if device is not None
               else _mix_mod(k, num_buckets))
        EXCHANGE_TIMERS["hash"] += time.perf_counter() - t0
        return out
    return partitioner


def bucket_by_composite(keys: Sequence[str], num_buckets: int,
                        kernel=None
                        ) -> Callable[[PartitionBatch], np.ndarray]:
    from .batch import EXCHANGE_TIMERS
    device = _kernel_device(kernel)

    def partitioner(batch: PartitionBatch) -> np.ndarray:
        import time
        t0 = time.perf_counter()
        h = np.zeros(batch.num_rows, np.int64)
        for key in keys:
            k = _row_keys(batch, key)
            h = h * np.int64(1000003) + k
        out = (_kernel_buckets(h, num_buckets, device) if device is not None
               else _mix_mod(h, num_buckets))
        EXCHANGE_TIMERS["hash"] += time.perf_counter() - t0
        return out
    return partitioner


# -- whole-stage fusion: pre-bucketed map output (DESIGN.md §14) -------------
#
# A fused stage program finishes the map side *inside* the task — partial
# aggregate, bucket assignment, and per-bucket slicing all happen before
# control returns to the scheduler.  The task then hands back a
# BucketedBatch: the per-reducer pieces in bucket order, produced by the
# exact slicing the scheduler would otherwise apply (same stable argsort /
# searchsorted / take), so shuffle blocks are byte-identical to the
# segment-at-a-time path — including under lineage recovery, where the
# re-run task re-derives the same pieces deterministically.


class BucketedBatch:
    """Map output already split into per-reducer pieces (bucket order)."""

    def __init__(self, pieces: List[PartitionBatch]):
        self.pieces = pieces

    @property
    def num_rows(self) -> int:
        return sum(p.num_rows for p in self.pieces)

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.pieces)


def split_bucket_pieces(batch: PartitionBatch, bucket_of: np.ndarray,
                        num_buckets: int) -> List[PartitionBatch]:
    """Slice `batch` into per-bucket pieces — the scheduler's legacy
    slicing, verbatim, so fused and seam-by-seam shuffle blocks match."""
    order = np.argsort(bucket_of, kind="stable")
    sorted_buckets = np.asarray(bucket_of)[order]
    bounds = np.searchsorted(sorted_buckets, np.arange(num_buckets + 1))
    return [batch.take(order[bounds[b]:bounds[b + 1]])
            for b in range(num_buckets)]


def single_bucket() -> Callable[[PartitionBatch], np.ndarray]:
    """Degenerate partitioner: everything to reducer 0 (the MPP-style single
    coordinator plan the paper contrasts against in §6.2.2)."""
    def partitioner(batch: PartitionBatch) -> np.ndarray:
        return np.zeros(batch.num_rows, np.int32)
    return partitioner
