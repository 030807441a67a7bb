"""Mamba2 SSD scan, forward (every Mamba2 prefill of the `ssm` and
`hybrid` families).

`ssd_scan(x, dt, a, b, c, chunk, d=None)` returns `(y, final_state)` for
x (B, S, H, P), dt (B, S, H) float32 after softplus, a (H,) float32
(negative), and b, c (B, S, N) in x's dtype (ngroups = 1: one B and C for
all heads).  Per (batch, head), with `cum` the running sum of `dt * a`:

    y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
    state  = sum_j exp(cum_S - cum_j) dt_j B_j x_j^T        (P x N)

y is SSD(x) plus the D skip `x * d` when `d` (H,) is given, summed in
float32 and cast once to x's dtype, as `models/mamba2.ssd_chunked` does;
final_state is float32 in the reference's (B, H, P, N) layout.  x, dt, b
and c are read in place: a (B, S, ...) view whose inner dims are dense
(the in-projection's slices) needs no copy.

The result does not depend on the chunk length except through rounding.
`chunk` sets the plain version's chunk (as `ssd_chunked`'s); the kernel
walks the sequence in tiles of 64 rows, the same function.

On CUDA tensors the wrapper launches `csrc/ssd.cu` (it replaces
repro/kernels/ssd_scan.py:ssd_scan and also writes the final state, which
the TPU kernel kept in scratch and dropped; the design note is in the
source).  On CPU tensors it runs `ssd_scan_plain`, which is
`ssd_chunked`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._common import count_launch, on_cpu

LAUNCHES = {"ssd_scan": 0}
MAX_STATE = 128         # N, ssd.cu's shared-memory tiles
MAX_HEADDIM = 128       # P


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, chunk: int = 128,
                   d: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (any device): `ssd_chunked` with one group."""
    from ..models.mamba2 import ssd_chunked
    if d is None:
        d = torch.zeros(x.shape[2], dtype=torch.float32, device=x.device)
    return ssd_chunked(x, dt, a, b[:, :, None], c[:, :, None], d, chunk)


def _check(x, dt, a, b, c, d) -> None:
    if x.dim() != 4 or b.dim() != 3 or c.shape != b.shape:
        raise ValueError(f"ssd_scan takes x (B, S, H, P) and b, c (B, S, N); "
                         f"got {tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bsz, s, h, p = x.shape
    n = b.shape[2]
    if b.shape[:2] != x.shape[:2] or dt.shape != (bsz, s, h) \
            or a.shape != (h,) or (d is not None and d.shape != (h,)):
        raise ValueError(f"ssd_scan shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    if not (x.dtype == b.dtype == c.dtype
            and x.dtype in (torch.bfloat16, torch.float32)):
        raise TypeError(f"x, b, c must share bfloat16 or float32, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError("dt and a must be float32")
    if not (1 <= p <= MAX_HEADDIM and 1 <= n <= MAX_STATE and s >= 1):
        raise ValueError(f"ssd kernel takes P <= {MAX_HEADDIM}, N <= "
                         f"{MAX_STATE}, S >= 1; got P={p}, N={n}, S={s}")
    if x.stride(3) != 1 or x.stride(2) != p:
        raise ValueError("x's (H, P) dims must be dense")
    if b.stride(2) != 1 or c.stride(2) != 1:
        raise ValueError("b's and c's state dim must be contiguous")
    if not (dt.is_contiguous() and a.is_contiguous()):
        raise ValueError("dt and a must be contiguous")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int = 128,
             d: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    operands = (x, dt, a, b, c) + ((d,) if d is not None else ())
    if on_cpu(*operands):
        return ssd_scan_plain(x, dt, a, b, c, chunk, d)
    _check(x, dt, a, b, c, d)
    bsz, s, h, p = (int(v) for v in x.shape)
    n = int(b.shape[2])
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32,
                        device=x.device)
    rc = _build.kernel_fn("ssd")(
        x.data_ptr(), _build.dtype_code(x), x.stride(0), x.stride(1),
        dt.data_ptr(), a.data_ptr(), b.data_ptr(), b.stride(0), b.stride(1),
        c.data_ptr(), c.stride(0), c.stride(1), bsz, s, h, p, n,
        y.data_ptr(), state.data_ptr(), _build.stream_handle(x.device))
    _build.check_launch("ssd_scan", rc)
    count_launch(LAUNCHES, "ssd_scan")
    if d is not None:
        y += x.float() * d.float()[:, None]
    return y.to(x.dtype), state
