"""Shuffle partitioners (paper §3.1, §5 "Memory-based Shuffle").

Map output is materialized in worker memory (the BlockManager), never on
disk; the partitioner assigns rows to reduce buckets by a deterministic key
hash shared with DISTRIBUTE BY so co-partitioned tables align.

String keys hash through the partition dictionary — one crc32 per *distinct*
value, then an O(1) gather per row — so the shuffle path never materializes
a string (the columnar store making the shuffle CPU-cheap, §3.2).

`kernel=<device>` routes a map task's whole split through the radix
kernel on that device (GPU sessions, or forced routes on the CPU, where the
kernel's plain version runs; `kernel=True` means the CPU): the partitioner
returns a `BucketSplit`, the rows grouped by bucket (`order`, stable) and
the bucket starts (`bounds`), and `split_bucket_pieces` cuts the pieces
straight from them, with no host argsort.  On a GPU the int64 key hashes
cross to the device unfolded, through a pinned staging buffer of the
worker thread's own (reused, grown on demand) by an asynchronous copy on
the current stream; one launch folds, buckets and splits them; order and
bounds come back in one copy into pinned memory: one synchronize a map
task.  One launch takes a whole partition, so a split is never chunked:
chunks would need their splits merged on the host again.  The choice is
fixed per partitioner, never per task: a shuffle's bucket assignment must
be one function of the key value on every map task, and the kernel's
32-bit mix is a *different* (equally valid) function than the host's
64-bit mix.
"""

from __future__ import annotations

import threading
import weakref
import zlib
from typing import Callable, List, Sequence, Union

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


class BucketSplit:
    """A map task's rows split by bucket: `order` the row indices grouped
    by bucket, ascending within a bucket, and `bounds` the num_buckets + 1
    bucket starts into it.  Both are the split's own arrays (never views
    of a reused staging buffer), so a split may be kept."""

    __slots__ = ("order", "bounds")

    def __init__(self, order: np.ndarray, bounds: np.ndarray):
        self.order = order
        self.bounds = bounds


# what a partitioner returns: bucket ids (host route) or a kernel's split
Partition = Union[np.ndarray, BucketSplit]


_STAGING = threading.local()


def _pinned(name: str, device, numel: int, dtype) -> "torch.Tensor":
    """The calling thread's pinned buffer `name` for `device`, grown to at
    least `numel` elements: one map task at a time uses a thread's buffers,
    so no two tasks overwrite one in flight."""
    import torch
    bufs = getattr(_STAGING, "bufs", None)
    if bufs is None:
        bufs = _STAGING.bufs = {}
    buf = bufs.get((name, device))
    if buf is None or buf.numel() < numel:
        size = max(numel, 2 * buf.numel() if buf is not None else 1024)
        buf = bufs[(name, device)] = torch.empty(size, dtype=dtype,
                                                 pin_memory=True)
    return buf[:numel]


def split_keys(k: np.ndarray, num_buckets: int, device) -> BucketSplit:
    """The radix kernel's split of int64 key hashes `k` on `device`."""
    import torch

    from ..kernels import radix_partition as rp
    from ..kernels._common import count_launch
    count_launch(RADIX_KERNEL_CALLS, "count")     # map tasks run on threads
    dev = torch.device(device)
    if dev.type == "cpu":
        order, bounds = rp.radix_split(torch.from_numpy(k), num_buckets)
        return BucketSplit(order.numpy(), bounds.numpy())
    n = len(k)
    staged = _pinned("keys", dev, n, torch.int64)
    np.copyto(staged.numpy(), k, casting="no")
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    keys.copy_(staged, non_blocking=True)
    packed = rp.radix_split_packed(keys, num_buckets)
    back = _pinned("split", dev, packed.numel(), torch.int32)
    back.copy_(packed, non_blocking=True)
    torch.cuda.current_stream(dev).synchronize()
    # copied out: the pinned buffer is the thread's next split's too
    out = back.numpy().copy()
    return BucketSplit(out[:n], out[n:n + num_buckets + 1])


def _kernel_device(kernel):
    """None for the host route, else the device the radix kernel runs on."""
    if kernel is None or kernel is False:
        return None
    return "cpu" if kernel is True else kernel


def bucket_by_hash(key: str, num_buckets: int, kernel=None
                   ) -> Callable[[PartitionBatch], Partition]:
    device = _kernel_device(kernel)

    def partitioner(batch: PartitionBatch) -> np.ndarray:
        k = _row_keys(batch, key)
        return (split_keys(k, num_buckets, device) if device is not None
                else _mix_mod(k, num_buckets))
    return partitioner


def bucket_by_composite(keys: Sequence[str], num_buckets: int,
                        kernel=None
                        ) -> Callable[[PartitionBatch], Partition]:
    device = _kernel_device(kernel)

    def partitioner(batch: PartitionBatch) -> np.ndarray:
        h = np.zeros(batch.num_rows, np.int64)
        for key in keys:
            k = _row_keys(batch, key)
            h = h * np.int64(1000003) + k
        return (split_keys(h, num_buckets, device) if device is not None
                else _mix_mod(h, num_buckets))
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


def split_bucket_pieces(batch: PartitionBatch, bucket_of: Partition,
                        num_buckets: int) -> List[PartitionBatch]:
    """Slice `batch` into per-bucket pieces — the scheduler's legacy
    slicing, verbatim, so fused and seam-by-seam shuffle blocks match.  A
    `BucketSplit` (the radix kernel's route) is cut as it is: its order is
    the stable argsort of its ids, so the pieces are the same rows in the
    same order."""
    if isinstance(bucket_of, BucketSplit):
        order, bounds = bucket_of.order, bucket_of.bounds
    else:
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
