"""Fused filter + aggregate column scan (paper §6.2.1–6.2.2).

`colscan(filter_col, agg_col, lo, hi)` returns the float64 tensor
[count, sum, min, max] of `agg_col` over the rows with
`lo <= filter_col <= hi`.  NaN filter values fail both bounds, even when a
bound is ±inf.  An empty selection gives [0, 0, +inf, -inf].

On a CUDA tensor the wrapper launches `csrc/scan.cu` (it replaces
repro/kernels/colscan.py:colscan; the design note is in the source): one
launch a call, over a grid of `scan_plan(n)` (a block an SM), every
row's loads in flight before any test, and the last block to take a
ticket folding the blocks' partials in a fixed order.  When the filter
and the aggregate are one tensor the column is read once (route
`one_column`, else `two_columns`; counted in `ROUTES`).
`launch_scan` is the one launch function of both scan kernels (this and
`dictdecode.fused_decode_scan`): a call makes one allocation (the
4-double answer, then the blocks' partials) and one ctypes call of ten
plain arguments, its plan word and buffer size cached per (n, dictionary
length, dtypes, one column); the fold's ticket is a word per (device,
stream) (`_common.stream_ticket`).  On CPU tensors it runs
`colscan_plain`, the same arithmetic in PyTorch.  Accumulation is float64
on both.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from ._common import count_launch, on_cpu, stream_ticket

# launches of the CUDA kernel (one per wrapper call that reached the card)
LAUNCHES = {"colscan": 0}
# colscan's launches by path: one column that is both filter and aggregate
# (read once), or two
ROUTES = {"one_column": 0, "two_columns": 0}
# scan.cu's dtype codes of the filter (or dictionary) and the aggregate:
# the C interfaces' codes but bfloat16's
SCAN_CODES = {t: c for t, c in _build.DTYPE_CODES.items() if c < 4}
# rows a thread takes a step (scan.cu's kRows): 4 took less device time
# than 8 and 16 at phase 2's partition on an H100
# (scripts/kernel_probe.py scan)
SCAN_ROWS = 4
TILE_ROWS = 32 * SCAN_ROWS    # rows of a warp's tile
MAX_WARPS = 32                # 1,024 threads a block
SMS = 132                     # the H100's SMs: at most a block each
STAGE_BYTES = 32 * 1024       # a dictionary staged as float64 (scan.cu)
MAX_DICT = 2 ** 30 - 1        # the plan word's dictionary length field


class ScanPlan(NamedTuple):
    blocks: int
    warps: int         # a block


@functools.lru_cache(maxsize=4096)
def scan_plan(n: int) -> ScanPlan:
    """The one launch of a scan over n rows: warp tiles of TILE_ROWS rows
    spread over at most SMS blocks, with as many warps a block (up to 32)
    as give each warp one tile a step.  A function of n only, so the fold
    order, and the result's bits, are the same on every run at a size."""
    tiles = max(1, -(-int(n) // TILE_ROWS))
    blocks = min(SMS, tiles)
    return ScanPlan(blocks, min(MAX_WARPS, -(-tiles // blocks)))


def scan_staged(n: int, d: int) -> bool:
    """A dictionary of d values is staged in shared memory (as float64)
    when it fits in STAGE_BYTES and has no more values than the rows one
    block scans (otherwise staging would read more than the gather)."""
    return 0 < d * 8 <= STAGE_BYTES and d <= -(-int(n) // scan_plan(n).blocks)


def scan_word(n: int, fcode: int, acode: int, coded: bool, same: bool,
              d: int = 0) -> int:
    """scan.cu's plan word: bits 0-1 the filter's (codes: the
    dictionary's) dtype, 2-3 the aggregate's, 4 codes, 5 one column, 6 the
    dictionary staged, 7-12 warps a block, 13-24 blocks, 25-54 the
    dictionary's length."""
    plan = scan_plan(n)
    staged = coded and scan_staged(n, d)
    return (fcode | acode << 2 | int(coded) << 4 | int(same) << 5
            | int(staged) << 6 | plan.warps << 7 | plan.blocks << 13
            | d << 25)


def scan_buffer(n: int) -> int:
    """Doubles of a call's one buffer: the answer, then 4 a block for the
    blocks' partials when there is more than one block."""
    blocks = scan_plan(n).blocks
    return 4 + (4 * blocks if blocks > 1 else 0)


@functools.lru_cache(maxsize=4096)
def _launch(n: int, d: int, ftype: torch.dtype, atype: torch.dtype,
            coded: bool, same: bool) -> tuple:
    """(plan word, buffer doubles) of a call, computed once per size,
    dtypes and shape."""
    return (scan_word(n, SCAN_CODES[ftype], SCAN_CODES[atype], coded, same,
                      d), scan_buffer(n))


_TICKETS = {}


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """The fold ticket of `stream` (a raw handle) on `device`, shared by
    both scan kernels (`_common.stream_ticket`)."""
    return stream_ticket(_TICKETS, device, stream, "scan")


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


def _check_scan(rows: torch.Tensor, table: torch.Tensor,
                agg: torch.Tensor) -> None:
    """What scan.cu cannot see: dtypes, ranks, contiguity, sizes, one
    device (`rows`: the filter column or the codes; `table`: the filter
    column or the dictionary; a tensor passed twice is checked once)."""
    for t in (rows,) + tuple(t for t in (table, agg) if t is not rows):
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"scan operands must be 1-D and contiguous, got "
                             f"shape {tuple(t.shape)}")
        if t.dtype not in SCAN_CODES:
            raise TypeError(f"scan kernels take int32, int64, float32 or "
                            f"float64, got {t.dtype}")
    if rows.shape[0] != agg.shape[0]:
        raise ValueError(f"{rows.shape[0]} filter rows but {agg.shape[0]} "
                         f"aggregate rows")
    if not rows.get_device() == table.get_device() == agg.get_device():
        raise ValueError(f"scan operands on two devices: {rows.device}, "
                         f"{table.device}, {agg.device}")


def launch_scan(name: str, filt: torch.Tensor, dictionary,
                agg: torch.Tensor, lo, hi) -> torch.Tensor:
    """One call of csrc/scan.cu on CUDA tensors: `filt` is the filter
    column, or with `dictionary` the int32 codes gathered through it.
    Returns the [count, sum, min, max] tensor; its error code raises."""
    coded = dictionary is not None
    table = dictionary if coded else filt
    _check_scan(filt, table, agg)
    n = agg.shape[0]
    d = table.shape[0] if coded else 0
    if coded and (filt.dtype != torch.int32 or d > MAX_DICT):
        raise TypeError(f"{name} takes int32 codes into at most {MAX_DICT} "
                        f"values, got {filt.dtype} codes and {d} values")
    fptr, aptr = filt.data_ptr(), agg.data_ptr()
    same = not coded and fptr == aptr and filt.dtype == agg.dtype
    word, size = _launch(n, d, table.dtype, agg.dtype, coded, same)
    dev = agg.device
    stream = _build.stream_handle(dev)
    buf = torch.empty(size, dtype=torch.float64, device=dev)
    rc = _build.kernel_fn("scan")(
        fptr, dictionary.data_ptr() if coded else None, aptr, n, word,
        float(lo), float(hi), buf.data_ptr(), _ticket(dev, stream).data_ptr(),
        stream)
    if rc:
        _build.check_launch(name, rc)
    if not coded:
        count_launch(ROUTES, "one_column" if same else "two_columns")
    return buf[:4]


def colscan(filter_col: torch.Tensor, agg_col: torch.Tensor, lo, hi
            ) -> torch.Tensor:
    # the card's test first: cheaper than on_cpu on this per-partition
    # path (on_cpu raises on a CPU / CUDA mix)
    if not (filter_col.is_cuda and agg_col.is_cuda) \
            and on_cpu(filter_col, agg_col):
        return colscan_plain(filter_col, agg_col, lo, hi)
    out = launch_scan("colscan", filter_col, None, agg_col, lo, hi)
    count_launch(LAUNCHES, "colscan")
    return out
