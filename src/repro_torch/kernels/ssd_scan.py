"""Mamba2 SSD scan, forward (every Mamba2 prefill of the `ssm` and
`hybrid` families).

`ssd_scan(x, dt, a, b, c, chunk, d=None)` returns `(y, final_state)` for
x (B, S, H, P), dt (B, S, H) float32 after softplus, a (H,) float32
(negative), and b, c in x's dtype: (B, S, N), one B and C for all heads,
or (B, S, G, N), G groups of H / G consecutive heads each (Mamba2's
`ngroups`).  Per (batch, head), with `cum` the running sum of `dt * a` and
B, C those of the head's group:

    y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
    state  = sum_j exp(cum_S - cum_j) dt_j B_j x_j^T        (P x N)

y is SSD(x) plus the D skip `x * d` when `d` (H,) is given, summed in
float32 and cast once to x's dtype, as `models/mamba2.ssd_chunked` does;
final_state is float32 in the reference's (B, H, P, N) layout.  x, dt, b
and c are read in place: a (B, S, ...) view whose inner dims are dense
(the in-projection's slices) needs no copy.  With G > 1 groups the card
runs one launch per group on the group's heads (x, b and c are read in
place; dt's columns are copied once into group order) and joins y and the
states.

The result does not depend on the chunk length except through rounding.
`chunk` sets the plain version's chunk (as `ssd_chunked`'s); the kernels
walk the sequence in chunks of 64 rows, the same function.

On CUDA tensors the wrapper launches `csrc/ssd.cu` (it replaces
repro/kernels/ssd_scan.py:ssd_scan and also writes the final state, which
the TPU kernel kept in scratch and dropped; the design note is in the
source): one launch a call, which writes y in x's dtype with the D skip
added, and nothing else runs.  Two routes, chosen by `ssd_route(dtype, p,
n)` and counted in `ROUTES`:
- `tensor_core`: bfloat16 at the (P, N) of the repo's configurations
  (`TC_SHAPES`) runs the mma.sync kernel on the bf16 tensor cores, its
  float32 operands (M, w o B, the carried state) split into bf16 hi + lo
  pairs.  cp.async reads 16 bytes at a time: x, B and C need 16-byte
  aligned bases and batch and sequence strides of a multiple of 8
  elements, and the wrapper raises on anything else rather than copy.
- `simt`: float32, and bfloat16 at any other P, N <= 128, run the
  float32 FMA kernel on the CUDA cores.
On CPU tensors it runs `ssd_scan_plain`, which is `ssd_chunked`.  The
call is one operator, `torch.ops.repro_torch.ssd_scan`, whatever number
of launches it makes, with an implementation for each of the CPU, CUDA
and meta devices (`torch.library.Library`, as kernel 11's): a dispatch
mode such as the dry run's cost counter (`launch/cost.CostCounter`) sees
it once, and not the operations it runs inside; on meta tensors it takes
the card's path, checks included, and returns its outputs unwritten in
place of each launch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._common import count_launch, one_device

LAUNCHES = {"ssd_scan": 0}
# launches per route (the tensor-core and the float32 SIMT kernel)
ROUTES = {"tensor_core": 0, "simt": 0}
_ROUTE_CODES = {"simt": 0, "tensor_core": 1}
MAX_STATE = 128         # N, the kernels' shared-memory tiles
MAX_HEADDIM = 128       # P
# (P, N) the tensor-core kernel is compiled for: Zamba2-7B, Mamba2-370m and
# their smoke variants (csrc/ssd.cu's launch_tc instantiations).  A new
# configuration adds its (P, N) here and there; a CPU test fails until it
# does (tests/test_torch_kernel_plans.py)
TC_SHAPES = frozenset({(112, 64), (64, 128), (16, 16)})


def ssd_route(dtype: torch.dtype, p: int, n: int) -> str:
    """The kernel a CUDA call takes: `tensor_core` for bfloat16 at a (P, N)
    of `TC_SHAPES`, `simt` for float32 and any other bfloat16 shape; raises
    past P or N of 128, which neither kernel's tiles hold."""
    if not (1 <= p <= MAX_HEADDIM and 1 <= n <= MAX_STATE):
        raise ValueError(f"ssd kernels take 1 <= P <= {MAX_HEADDIM} and "
                         f"1 <= N <= {MAX_STATE}; got P={p}, N={n}")
    return ("tensor_core" if dtype == torch.bfloat16 and (p, n) in TC_SHAPES
            else "simt")


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, chunk: int = 128,
                   d: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (any device): `ssd_chunked`."""
    from ..models.mamba2 import ssd_chunked
    if d is None:
        d = torch.zeros(x.shape[2], dtype=torch.float32, device=x.device)
    if b.dim() == 3:
        b, c = b[:, :, None], c[:, :, None]
    return ssd_chunked(x, dt, a, b, c, d, chunk)


def _check(x, dt, a, b, c, d) -> None:
    if x.dim() != 4 or b.dim() != 3 or c.shape != b.shape:
        raise ValueError(f"ssd_scan takes x (B, S, H, P) and b, c (B, S, N); "
                         f"got {tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bsz, s, h, p = x.shape
    if b.shape[:2] != x.shape[:2] or dt.shape != (bsz, s, h) \
            or a.shape != (h,) or (d is not None and d.shape != (h,)):
        raise ValueError(f"ssd_scan shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    if not (x.dtype == b.dtype == c.dtype
            and x.dtype in (torch.bfloat16, torch.float32)):
        raise TypeError(f"x, b, c must share bfloat16 or float32, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32 \
            or (d is not None and d.dtype != torch.float32):
        raise TypeError("dt, a and d must be float32")
    if s < 1:
        raise ValueError("ssd_scan needs S >= 1")
    if x.stride(3) != 1 or x.stride(2) != p:
        raise ValueError("x's (H, P) dims must be dense")
    if b.stride(2) != 1 or c.stride(2) != 1:
        raise ValueError("b's and c's state dim must be contiguous")
    if not (dt.is_contiguous() and a.is_contiguous()
            and (d is None or d.is_contiguous())):
        raise ValueError("dt, a and d must be contiguous")


def _check_tc(x, b, c) -> None:
    """cp.async's rules on the tensor-core route: 16-byte aligned bases,
    and in the batch and sequence dims, where longer than 1, strides of a
    positive multiple of 8 elements (16 bytes)."""
    for t, name in ((x, "x"), (b, "b"), (c, "c")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} starts at an address that is not "
                             f"16-byte aligned; the tensor-core route reads "
                             f"it 16 bytes at a time")
        for dim in range(2):
            st = t.stride(dim)
            if t.shape[dim] > 1 and (st <= 0 or st % 8):
                raise ValueError(
                    f"{name}'s stride {st} in dim {dim} is not a positive "
                    f"multiple of 8 elements; the tensor-core route reads "
                    f"it 16 bytes at a time")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int = 128,
             d: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.ops.repro_torch.ssd_scan(x, dt, a, b, c, chunk, d)


def _plain_op(x, dt, a, b, c, chunk: int, d
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CPU's (y, state): the plain version, both dense as the kernel
    writes them."""
    one_device(x, dt, a, b, c, *(() if d is None else (d,)))
    _check_groups(x, b, c, chunk)
    y, state = ssd_scan_plain(x, dt, a, b, c, chunk, d)
    return y.contiguous(), state.contiguous()


def _launch_op(x, dt, a, b, c, chunk: int, d
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _scan(x, dt, a, b, c, chunk, d, launch=True)


def _meta_op(x, dt, a, b, c, chunk: int, d
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _scan(x, dt, a, b, c, chunk, d, launch=False)


def _check_groups(x, b, c, chunk: int) -> None:
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    grouped = b.dim() == 4
    if grouped and (c.shape != b.shape or x.dim() != 4 or b.shape[2] < 1
                    or x.shape[2] % b.shape[2]):
        raise ValueError(f"ssd_scan takes b, c (B, S, G, N) with G dividing "
                         f"x's H; got x {tuple(x.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}")


def _scan(x, dt, a, b, c, chunk: int, d, launch: bool
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The card's path: one launch a group of heads (none without
    `launch`: the outputs unwritten)."""
    one_device(x, dt, a, b, c, *(() if d is None else (d,)))
    _check_groups(x, b, c, chunk)
    if b.dim() == 3:
        return _launch(x, dt, a, b, c, d, launch)
    g, h = int(b.shape[2]), int(x.shape[2])
    if g == 1:
        return _launch(x, dt, a, b[:, :, 0], c[:, :, 0], d, launch)
    hg = h // g
    # dt (B, S, H) -> (G, B, S, H / G): each group's columns contiguous
    dtg = dt.unflatten(2, (g, hg)).movedim(2, 0).contiguous()
    outs = [_launch(x[:, :, k * hg:(k + 1) * hg], dtg[k],
                    a[k * hg:(k + 1) * hg], b[:, :, k], c[:, :, k],
                    d[k * hg:(k + 1) * hg] if d is not None else None,
                    launch)
            for k in range(g)]
    return (torch.cat([y for y, _ in outs], 2),
            torch.cat([st for _, st in outs], 1))


def _launch(x, dt, a, b, c, d, launch: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch: b and c (B, S, N), one group (its outputs
    unwritten without `launch`)."""
    _check(x, dt, a, b, c, d)
    bsz, s, h, p = (int(v) for v in x.shape)
    n = int(b.shape[2])
    route = ssd_route(x.dtype, p, n)
    if route == "tensor_core":
        _check_tc(x, b, c)
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32,
                        device=x.device)
    if not launch:
        return y, state
    rc = _build.kernel_fn("ssd")(
        x.data_ptr(), _build.dtype_code(x), _ROUTE_CODES[route], x.stride(0),
        x.stride(1), dt.data_ptr(), a.data_ptr(),
        d.data_ptr() if d is not None else None, b.data_ptr(), b.stride(0),
        b.stride(1), c.data_ptr(), c.stride(0), c.stride(1), bsz, s, h, p, n,
        y.data_ptr(), state.data_ptr(), _build.stream_handle(x.device))
    _build.check_launch("ssd_scan", rc)
    count_launch(LAUNCHES, "ssd_scan")
    count_launch(ROUTES, route)
    return y, state


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("ssd_scan(Tensor x, Tensor dt, Tensor a, Tensor b, Tensor c, "
            "int chunk, Tensor? d) -> (Tensor, Tensor)")
_LIB.impl("ssd_scan", _plain_op, "CPU")
_LIB.impl("ssd_scan", _launch_op, "CUDA")
_LIB.impl("ssd_scan", _meta_op, "Meta")
