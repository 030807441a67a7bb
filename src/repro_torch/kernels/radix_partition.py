"""Map-side shuffle partition (radix partition, paper §5).

`radix_partition(keys_u32, num_buckets, with_counts)` returns int32 bucket
ids `mix_u32(key) % num_buckets` for pre-folded 32-bit key hashes and,
with `with_counts`, the int32 per-bucket histogram (exact at any size);
otherwise `(ids, None)`.  Ids are bit-identical to `radix_partition_ref`.

`radix_split(keys, num_buckets)` is a shuffle's whole map-side split:
`(order, bounds)`, int32, where `order` is the row indices grouped by
bucket and ascending within a bucket (exactly `np.argsort(ids,
kind="stable")`) and `bounds` the B + 1 bucket starts, the last n (exactly
`np.searchsorted(ids[order], np.arange(B + 1))`).  Its keys are the host's
int64 key hashes, folded on the device bit-for-bit as `fold_keys_u32`, or
32-bit lanes as above.

Keys arrive as torch.int64, or as torch.uint32 / int32 holding the 32-bit
bits.  On a CUDA tensor the wrappers launch `csrc/radix.cu` (it replaces
repro/kernels/radix_partition.py:radix_partition, both variants; the
design note is in the source) and raise if the launch fails; on CPU
tensors they run `radix_partition_plain` / `radix_split_plain`.  A call
takes one route (`radix_plan`, counted in `ROUTES`), whatever it asks for:
`one_launch` for B <= ONE_LAUNCH_MAX (every shuffle of the executor), and
`two_launch` above it.  A call makes one int32 allocation of its outputs
(order, bounds, ids, counts, in that order, as asked); the look-back words
between the blocks are the stream's (`_common.stream_ticket`): SCRATCH_WORDS
int64 zeros, the most any call needs, allocated at the first call on the
stream that needs them and left zeroed by every launch, so a CUDA graph
captured after that first call keeps valid words.

PyTorch on the CPU implements neither `>>` nor `%` for torch.uint32, so
the plain `mix_u32` and `fold_keys_u32` compute in int64 and mask with
0xFFFFFFFF after every multiply and shift; multiplies are split in 16-bit
halves so no int64 product overflows.

Like the reference, the 32-bit mix assigns buckets differently from the
host partitioner's 64-bit mix; a shuffle fixes its route per partitioner,
so equal keys always land in equal buckets.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from ._common import check_cuda_operand, count_launch, on_cpu, stream_ticket

LAUNCHES = {"radix_partition": 0}
# calls by route (radix.cu's note)
ROUTES = {"one_launch": 0, "two_launch": 0}
MAX_BUCKETS = 8192     # two_launch's shared-memory counts (radix.cu)
ONE_LAUNCH_MAX = 1024  # 8 warps' counts of every bucket in shared memory
TILE = 4096            # rows of a one_launch tile (radix.cu's kTile)
GRID_MAX = 264         # one_launch chunks (a block each): two an SM of 132
CHUNKS_MAX = 256       # two_launch chunks
# int64 words of the stream's scratch: 2 holding radix.cu's four 32-bit
# counters, then one_launch's look-back word a chunk and bucket
SCRATCH_WORDS = 2 + GRID_MAX * ONE_LAUNCH_MAX
MAX_ROWS = 2 ** 31 - 1  # order and bounds are int32

# plan word flags (radix.cu; bit 0 is the int64 keys')
IDS, COUNTS, SPLIT = 2, 4, 8
ROUTE_CODES = {"one_launch": 0, "two_launch": 1}

_GOLDEN32 = 2654435761          # 2^32 / phi, Knuth's constant
_MIX2 = 0x85EBCA6B
_M32 = 0xFFFFFFFF


class RadixPlan(NamedTuple):
    route: str
    blocks: int
    chunks: int        # one_launch: chunks of whole tiles, a block each
    per: int           # one_launch: tiles a chunk; two_launch: its rows
    size: int          # int32s of the call's one allocation
    scratch: int       # int64 words it uses of the stream's scratch
    launches: int

    def word(self, keys64: bool, flags: int) -> int:
        """radix.cu's plan word: bit 0 int64 keys, bits 1-3 the outputs,
        bits 4-5 the route, bits 8-23 the blocks, bits 24-39 the chunks,
        bits 40-63 `per`."""
        return (int(keys64) | flags | ROUTE_CODES[self.route] << 4
                | self.blocks << 8 | self.chunks << 24 | self.per << 40)


def one_launch_chunks(n: int, tile: int = TILE, most: int = GRID_MAX):
    """(chunks, tiles a chunk) of route one_launch over n rows: a tile a
    chunk up to `most` tiles, else `most` chunks at most of whole tiles."""
    tiles = max(1, -(-int(n) // tile))
    per = -(-tiles // most)
    return -(-tiles // per), per


@functools.lru_cache(maxsize=4096)
def radix_plan(n: int, num_buckets: int, flags: int) -> RadixPlan:
    """The launch of a call over n keys into num_buckets buckets asking
    for `flags` (IDS, COUNTS, SPLIT; ids alone take the same route as the
    rest): a function of its arguments only."""
    n, b = int(n), int(num_buckets)
    if not 1 <= b <= MAX_BUCKETS:
        raise ValueError(f"radix kernel takes 1..{MAX_BUCKETS} buckets, "
                         f"got {b}")
    if not 0 <= n <= MAX_ROWS:
        raise ValueError(f"radix kernel takes at most {MAX_ROWS} keys, "
                         f"got {n}")
    size = ((n + b + 1 if flags & SPLIT else 0) + (n if flags & IDS else 0)
            + (b if flags & COUNTS else 0))
    if b <= ONE_LAUNCH_MAX:
        chunks, per = one_launch_chunks(n)
        scratch = 2 + chunks * b if chunks > 1 else 0
        return RadixPlan("one_launch", chunks, chunks, per, size, scratch, 1)
    chunks = min(CHUNKS_MAX, max(1, -(-n // TILE)))
    rows = -(-max(1, -(-n // chunks)) // 32) * 32
    return RadixPlan("two_launch", chunks, 0, rows, size + chunks * b, 2,
                     2 if flags & SPLIT else 1)


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


def radix_split_plain(keys: torch.Tensor, num_buckets: int):
    """Plain PyTorch version of `radix_split` (any device): the fold in
    int64 with masks, the mix, a stable argsort of the ids, and the bucket
    starts from their counts."""
    h = (fold_keys_u32(keys) if keys.dtype == torch.int64
         else _as_u32_values(keys))
    ids = mix_u32(h) % int(num_buckets)
    order = torch.argsort(ids, stable=True).to(torch.int32)
    bounds = torch.zeros(int(num_buckets) + 1, dtype=torch.int64,
                         device=keys.device)
    bounds[1:] = torch.cumsum(torch.bincount(ids, minlength=int(num_buckets)),
                              0)
    return order, bounds.to(torch.int32)


def _check_keys(keys: torch.Tensor) -> None:
    check_cuda_operand(keys, "keys")
    if keys.dtype not in (torch.int64, torch.uint32, torch.int32):
        raise TypeError(f"keys must be int64, or uint32 (or int32 bits), "
                        f"got {keys.dtype}")


_SCRATCH = {}


def _launch(keys: torch.Tensor, num_buckets: int, flags: int
            ) -> torch.Tensor:
    """One call of csrc/radix.cu on a CUDA tensor: the call's one int32
    allocation of its outputs (RadixPlan's layout); a failed launch
    raises."""
    _check_keys(keys)
    n = int(keys.shape[0])
    plan = radix_plan(n, num_buckets, flags)
    dev = keys.device
    stream = _build.stream_handle(dev)
    out = torch.empty(max(1, plan.size), dtype=torch.int32, device=dev)
    scratch = (stream_ticket(_SCRATCH, dev, stream, "radix", SCRATCH_WORDS,
                             torch.int64) if plan.scratch else None)
    rc = _build.kernel_fn("radix")(
        keys.data_ptr(), n, int(num_buckets),
        plan.word(keys.dtype == torch.int64, flags), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, stream)
    _build.check_launch("radix_partition", rc)
    for _ in range(plan.launches):
        count_launch(LAUNCHES, "radix_partition")
    count_launch(ROUTES, plan.route)
    return out


def radix_partition(keys_u32: torch.Tensor, num_buckets: int,
                    with_counts: bool = True):
    if on_cpu(keys_u32):
        return radix_partition_plain(keys_u32, num_buckets, with_counts)
    if keys_u32.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"keys must be uint32 (or int32 bits), got "
                        f"{keys_u32.dtype}")
    n = int(keys_u32.shape[0])
    out = _launch(keys_u32, num_buckets, IDS | (COUNTS if with_counts
                                                else 0))
    return out[:n], (out[n:n + int(num_buckets)] if with_counts else None)


def radix_split_packed(keys: torch.Tensor, num_buckets: int
                       ) -> torch.Tensor:
    """`radix_split` on a CUDA tensor as one int32 tensor: order (n), then
    bounds (B + 1), so one copy brings both back."""
    return _launch(keys, num_buckets, SPLIT)


def radix_split(keys: torch.Tensor, num_buckets: int):
    if on_cpu(keys):
        return radix_split_plain(keys, num_buckets)
    n = int(keys.shape[0])
    out = radix_split_packed(keys, num_buckets)
    return out[:n], out[n:n + int(num_buckets) + 1]


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


def radix_split_ref(keys: np.ndarray, num_buckets: int):
    """Numpy oracle for `radix_split`: int64 keys are folded first (other
    integer keys are taken as 32-bit lanes), then the reference's ids,
    their stable argsort and the bucket starts; int32 `(order, bounds)`."""
    k = np.asarray(keys)
    lanes = (fold_keys_u32(k) if k.dtype == np.int64
             else k.astype(np.int64).astype(np.uint32))
    ids = radix_partition_ref(lanes, num_buckets)[0]
    order = np.argsort(ids, kind="stable")
    bounds = np.searchsorted(ids[order], np.arange(num_buckets + 1))
    return order.astype(np.int32), bounds.astype(np.int32)
