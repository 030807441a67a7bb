"""Small-NDV group-by aggregation (paper §6.3.1, §6.4).

`groupby_sum(codes, values, num_groups)` returns the (num_groups, 2)
float64 tensor of per-group [sum, count] for group ids in
[0, num_groups); other ids contribute nothing.  The caller rounds counts.

On a CUDA tensor the wrapper launches `csrc/group.cu` without the min/max
lanes (it replaces repro/kernels/groupby_mxu.py:groupby_sum, whose one-hot
MXU matmul has no reason to exist on Hopper: the kernel adds each row into
shared-memory group accumulators and folds the blocks' partials inside the
same launch, see the note in the source); `group_plan` sizes that launch.
On CPU tensors it runs `groupby_sum_plain`.  The module keeps the
reference's name so the route string `groupby_mxu` reads the same in both
packages.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from ._common import THREADS, check_cuda_operand, count_launch, on_cpu

LAUNCHES = {"groupby_sum": 0}
MAX_GROUPS = 1024      # shared-memory accumulators per block (group.cu)
ROWS_PER_THREAD = 24   # one 16-block cluster covers a 93,750-row partition
MIN_ROWS_PER_THREAD = 4   # a smaller n still spreads over the cluster
MAX_CLUSTER = 16       # blocks a cluster (the non-portable size)
MAX_CLUSTERS = 16
MAX_ROWS = 1 << 40     # a block's 32-bit counts stay exact (group.cu)
WARPS = THREADS // 32  # accumulator copies at most: one a warp
# a block's shared memory stays under this, so that two blocks share an SM
# and a 16-block cluster fits any GPC
SMEM_BUDGET = 112 * 1024


class GroupPlan(NamedTuple):
    cluster: int       # blocks a cluster
    blocks: int        # clusters * cluster
    copies: int        # private accumulator copies a block
    lane_sums: bool    # sums in a float64 column per thread, no atomics
    smem_bytes: int    # the block's dynamic shared memory

    def word(self, with_minmax: bool) -> int:
        """The plan bits of group.cu's `plan` argument (the dtypes go in
        bits 0-3 per call)."""
        return (int(with_minmax) << 4 | int(self.lane_sums) << 5
                | self.copies << 8 | self.cluster << 12 | self.blocks << 20)


def copy_bytes(num_groups: int, with_minmax: bool) -> int:
    """Shared memory of one copy of the accumulators (group.cu): float64
    sum and uint32 count, and for the merge min and max bits (8 bytes) and
    a NaN flag (4 bytes), per group; rounded up to 8 bytes."""
    return -(-(32 if with_minmax else 12) * num_groups // 8) * 8


def lane_sum_bytes(num_groups: int) -> int:
    """Shared memory of the lane-private sums: a float64 per group and
    thread."""
    return 8 * num_groups * THREADS


@functools.lru_cache(maxsize=4096)
def group_plan(n: int, num_groups: int, with_minmax: bool) -> GroupPlan:
    """The one launch of csrc/group.cu for n rows.  Blocks and clusters
    are a function of n only, so the kernel's fold order is the same on
    every run: up to 16 * THREADS * ROWS_PER_THREAD rows, one cluster of a
    power of two up to 16 blocks, as many as keep MIN_ROWS_PER_THREAD rows
    a thread; beyond that, up to MAX_CLUSTERS clusters of 16 at about
    ROWS_PER_THREAD rows a thread.
    Sums of a small G go to lane-private columns (no float64 atomics:
    shared memory runs those as compare-and-swap loops) when they fit
    SMEM_BUDGET beside 8 count copies; otherwise the accumulator copies a
    block keeps (8, 4, 2 or 1) are the most that fit."""
    need = max(1, -(-int(n) // (THREADS * ROWS_PER_THREAD)))
    if need <= MAX_CLUSTER:
        spread = -(-int(n) // (THREADS * MIN_ROWS_PER_THREAD))
        blocks = min(MAX_CLUSTER, max(1, spread))
        cluster, clusters = 1 << (blocks - 1).bit_length(), 1
    else:
        cluster = MAX_CLUSTER
        clusters = min(MAX_CLUSTERS, -(-need // MAX_CLUSTER))
    one = copy_bytes(num_groups, with_minmax)
    lanes = lane_sum_bytes(num_groups)
    if not with_minmax and WARPS * one + lanes <= SMEM_BUDGET:
        return GroupPlan(cluster, cluster * clusters, WARPS, True,
                         WARPS * one + lanes)
    copies = WARPS
    while copies > 1 and copies * one > SMEM_BUDGET:
        copies //= 2
    return GroupPlan(cluster, cluster * clusters, copies, False,
                     copies * one)


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


# group.cu's dtype codes of codes (bits 0-1) and values (bits 2-3)
_CODE_BITS = {torch.int32: 0, torch.int64: 1}
_VALUE_BITS = {torch.int32: 0 << 2, torch.int64: 1 << 2,
               torch.float32: 2 << 2, torch.float64: 3 << 2}


@functools.lru_cache(maxsize=4096)
def _launch(n: int, num_groups: int, with_minmax: bool):
    """(plan word, elements of the one allocation) of a call: the (G,
    width) output, then with more than one cluster the clusters' partials
    and the ticket counter."""
    plan = group_plan(n, num_groups, with_minmax)
    clusters = plan.blocks // plan.cluster
    extra = (clusters * (5 if with_minmax else 2) * num_groups + 1
             if clusters > 1 else 0)
    return plan.word(with_minmax), extra


def launch_group(name: str, codes: torch.Tensor, values: torch.Tensor,
                 num_groups: int, with_minmax: bool) -> torch.Tensor:
    """One call of csrc/group.cu (one kernel launch); returns (G, 4 if
    with_minmax else 2).  One allocation; one ctypes call of seven
    arguments."""
    n = int(codes.shape[0])
    check_cuda_operand(codes, "codes")
    check_cuda_operand(values, "values", n)
    if values.get_device() != codes.get_device():
        raise ValueError(f"{name} operands on two devices: {codes.device}, "
                         f"{values.device}")
    code_bits = _CODE_BITS.get(codes.dtype)
    if code_bits is None:
        raise TypeError(f"codes must be int32 or int64, got {codes.dtype}")
    value_bits = _VALUE_BITS.get(values.dtype)
    if value_bits is None:
        raise TypeError(f"{name} kernel does not take {values.dtype} values")
    if not 1 <= num_groups <= MAX_GROUPS:
        raise ValueError(f"{name} kernel takes 1..{MAX_GROUPS} groups, "
                         f"got {num_groups}")
    if n >= MAX_ROWS:
        raise ValueError(f"{name} kernel takes fewer than 2**40 rows")
    word, extra = _launch(n, num_groups, with_minmax)
    width = 4 if with_minmax else 2
    dev = codes.device
    if extra:
        buf = torch.empty(num_groups * width + extra, dtype=torch.float64,
                          device=dev)
        out = buf[:num_groups * width].view(num_groups, width)
    else:
        out = buf = torch.empty(num_groups, width, dtype=torch.float64,
                                device=dev)
    rc = _build.kernel_fn("group")(
        codes.data_ptr(), values.data_ptr(), n, num_groups,
        word | code_bits | value_bits, buf.data_ptr(),
        _build.stream_handle(dev))
    _build.check_launch(name, rc)
    return out


def groupby_sum(codes: torch.Tensor, values: torch.Tensor,
                num_groups: int) -> torch.Tensor:
    # the card's test first: cheaper than on_cpu on this per-partition path
    # (launch_group checks that both lie on one card; on_cpu raises on a
    # CPU / CUDA mix)
    if not (codes.is_cuda and values.is_cuda) and on_cpu(codes, values):
        return groupby_sum_plain(codes, values, num_groups)
    out = launch_group("groupby_sum", codes, values, num_groups, False)
    count_launch(LAUNCHES, "groupby_sum")
    return out
