"""Full-batch gradient of the in-engine estimators (DESIGN.md §15.2).

`train_grad(x, y, w, kind)` returns the unnormalised (d,) float64 sum over
rows of `x_i * r_i`, where `r_i = sigmoid(x_i . w) - y_i` ("logistic") or
`x_i . w - y_i` ("linear").  x is (n, d) row-major, float32 or float64; y
(n,) and w (d,) have x's dtype; every product and sum is taken in float64.
Callers divide by their row count, so partials of different partitions
add before normalising.  An unknown `kind` raises ValueError before any
launch.

On CUDA tensors the wrapper launches `csrc/train.cu` (it replaces
repro/kernels/train_grad.py:train_grad; one read of x bounds it, see the
note in the source: fixed row ranges per block, per-thread column slots in
shared memory, a fixed-order fold of the block partials).  On CPU tensors
it runs `train_grad_plain`.
"""

from __future__ import annotations

import torch

from . import _build
from ._common import count_launch, grid_blocks, on_cpu

LAUNCHES = {"train_grad": 0}
KINDS = ("logistic", "linear")
MAX_DIMS = 2048         # shared-memory slots per block (train.cu)


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
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    for t, name, size in ((y, "y", n), (w, "w", d)):
        if t.shape != (size,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({size},) vector, "
                             f"got shape {tuple(t.shape)}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} must have x's dtype {x.dtype}, got "
                            f"{t.dtype}")
    if not 1 <= d <= MAX_DIMS:
        raise ValueError(f"train_grad kernel takes 1..{MAX_DIMS} columns, "
                         f"got {d}")
    nb = grid_blocks(n)
    partials = torch.empty(nb * d, dtype=torch.float64, device=x.device)
    out = torch.empty(d, dtype=torch.float64, device=x.device)
    rc = _build.kernel_fn("train")(
        x.data_ptr(), _build.dtype_code(x), y.data_ptr(), w.data_ptr(), n, d,
        int(kind == "logistic"), partials.data_ptr(), nb, out.data_ptr(),
        _build.stream_handle(x.device))
    _build.check_launch("train_grad", rc)
    count_launch(LAUNCHES, "train_grad")
    return out
