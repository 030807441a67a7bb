"""Full-batch gradient of the in-engine estimators (DESIGN.md §15.2).

`train_grad(x, y, w, kind)` returns the unnormalised (d,) float64 sum over
rows of `x_i * r_i`, where `r_i = sigmoid(x_i . w) - y_i` ("logistic") or
`x_i . w - y_i` ("linear").  x is (n, d) row-major, float32 or float64; y
(n,) and w (d,) have x's dtype; every product and sum is taken in float64.
Callers divide by their row count, so partials of different partitions
add before normalising.  An unknown `kind` raises ValueError before any
launch.

On CUDA tensors the wrapper launches `csrc/train.cu` (it replaces
repro/kernels/train_grad.py:train_grad; the design note is in the
source): one launch a call, in which the last block to finish folds the
blocks' partial rows in a fixed order.  Two routes, chosen by
`train_plan(n, d, dtype)` and counted in `ROUTES`:
- `registers` (d <= REG_MAX_DIMS): neighbouring lanes share a row, each
  reading one 16-byte chunk of it once and keeping that chunk's float64
  accumulators in registers;
- `chunked` (larger d): blocks walk 256-row chunks through shared memory.
A call makes one allocation (the output, then the blocks' partial rows)
and one ctypes call of nine plain arguments, its plan word cached per
(n, d, dtype); the fold's ticket is a word per (device, stream), allocated
at the first call on that stream, so calls on two streams never share one.
On CPU tensors it runs `train_grad_plain`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from ._common import count_launch, grid_blocks, on_cpu, stream_ticket

LAUNCHES = {"train_grad": 0}
ROUTES = {"registers": 0, "chunked": 0}
KINDS = ("logistic", "linear")
MAX_DIMS = 2048         # the chunked route's shared-memory slots (train.cu)
# the register route pads d to 4, 8, 16 or 32 columns, a row shared by up
# to 8 lanes (float32; 16 for float64) of one 16-byte chunk each
REG_MAX_DIMS = 32
# the grid: a block per 512 rows, at most MAX_BLOCKS, a function of n only
# (at phase 3's 156,250 x 12, 306 blocks: a register-route lane takes two
# steps of 4 rows; 611 and 153 blocks took longer on an H100,
# scripts/kernel_probe.py train)
ROWS_PER_THREAD = 2


class TrainPlan(NamedTuple):
    route: str         # "registers" or "chunked"
    width_class: int   # registers: d padded to 2 << width_class; chunked 0
    blocks: int

    def word(self, float64: bool, logistic: bool) -> int:
        """train.cu's plan word: bit 0 float64 x, bit 1 logistic, bits 2-4
        the width class (0 = chunked), bits 8-19 the blocks."""
        return (int(float64) | int(logistic) << 1 | self.width_class << 2
                | self.blocks << 8)


@functools.lru_cache(maxsize=4096)
def train_plan(n: int, d: int, dtype: torch.dtype) -> TrainPlan:
    """The one launch of a gradient over x (n, d): the route by d alone,
    the grid by n alone (so the fold order, and the result's bits, are the
    same on every run at a shape)."""
    if not 1 <= d <= MAX_DIMS:
        raise ValueError(f"train_grad kernel takes 1..{MAX_DIMS} columns, "
                         f"got {d}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x must be float32 or float64, got {dtype}")
    blocks = grid_blocks(n, ROWS_PER_THREAD)
    if d > REG_MAX_DIMS:
        return TrainPlan("chunked", 0, blocks)
    width_class = max(1, (d - 1).bit_length() - 1)
    return TrainPlan("registers", width_class, blocks)


@functools.lru_cache(maxsize=4096)
def _launch(n: int, d: int, dtype: torch.dtype, logistic: bool):
    """(route, plan word, doubles of the one allocation) of a call."""
    plan = train_plan(n, d, dtype)
    return (plan.route, plan.word(dtype == torch.float64, logistic),
            d + plan.blocks * d)


_TICKETS = {}


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """The fold ticket of `stream` (a raw handle) on `device`
    (`_common.stream_ticket`)."""
    return stream_ticket(_TICKETS, device, stream, "train_grad")


def stable_sigmoid(z: torch.Tensor) -> torch.Tensor:
    """1 / (1 + e^-z) for z >= 0, e^z / (1 + e^z) below: no overflow on
    either side (the form of trainer._np_sigmoid)."""
    e = torch.exp(-z.abs())
    return torch.where(z >= 0, 1.0 / (1.0 + e), e / (1.0 + e))


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"train_grad: unknown kind {kind!r}")


def train_grad_plain(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                     kind: str = "logistic") -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    _check_kind(kind)
    x64 = x.to(torch.float64)
    z = x64 @ w.to(torch.float64)
    p = stable_sigmoid(z) if kind == "logistic" else z
    return x64.T @ (p - y.to(torch.float64))


def train_grad(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               kind: str = "logistic") -> torch.Tensor:
    _check_kind(kind)
    if on_cpu(x, y, w):
        return train_grad_plain(x, y, w, kind)
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (n, d) matrix, got shape "
                         f"{tuple(x.shape)}")
    n, d = (int(s) for s in x.shape)
    for t, name, size in ((y, "y", n), (w, "w", d)):
        if t.shape != (size,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({size},) vector, "
                             f"got shape {tuple(t.shape)}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} must have x's dtype {x.dtype}, got "
                            f"{t.dtype}")
    route, word, size = _launch(n, d, x.dtype, kind == "logistic")
    buf = torch.empty(size, dtype=torch.float64, device=x.device)
    stream = _build.stream_handle(x.device)
    rc = _build.kernel_fn("train")(
        x.data_ptr(), y.data_ptr(), w.data_ptr(), n, d, word, buf.data_ptr(),
        _ticket(x.device, stream).data_ptr(), stream)
    _build.check_launch("train_grad", rc)
    count_launch(LAUNCHES, "train_grad")
    count_launch(ROUTES, route)
    return buf[:d]
