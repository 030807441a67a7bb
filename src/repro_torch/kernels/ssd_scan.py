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

Backward: `ssd_scan_bwd(x, dt, a, b, c, d, chunk, dy, dstate)` returns
the gradients (dx, ddt, da, db, dc, dd) of the scan at the same inputs,
given dy and dstate, those of y and the final state; one operator,
`torch.ops.repro_torch.ssd_scan_bwd`, with CPU, CUDA and meta
implementations.  Two routes, chosen by `ssd_bwd_route(dtype, p, n)` and
counted in `BWD_ROUTES` on the card:
- `tensor_core`: bfloat16 at a (P, N) of `TC_SHAPES` launches
  `csrc/ssd_bwd.cu` once a group (its design note is in the source): dx
  in x's dtype, ddt, and each (batch, head)'s da and dD, which the wrapper
  sums over the batch; dB and dC summed over the group's heads in float32
  by atomics, cast once to b's dtype.  The wrapper allocates the outputs
  and the kernel's scratch (the chunk states, B H (ceil(S / 64) - 1) 2 N P
  bf16) and counts `LAUNCHES["ssd_scan_bwd"]`;
- `plain`: float32 and every other shape run `models/mamba2.ssd_scan_vjp`
  (the plain scan recomputed under autograd), as the CPU always does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._common import count_launch, one_device

LAUNCHES = {"ssd_scan": 0, "ssd_scan_bwd": 0}
# launches per route (the tensor-core and the float32 SIMT kernel)
ROUTES = {"tensor_core": 0, "simt": 0}
# backward calls on the card per route (the tensor-core kernel and the
# plain VJP)
BWD_ROUTES = {"tensor_core": 0, "plain": 0}
_ROUTE_CODES = {"simt": 0, "tensor_core": 1}
MAX_STATE = 128         # N, the kernels' shared-memory tiles
MAX_HEADDIM = 128       # P
_TILE = 64              # rows a chunk in both kernels
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


def ssd_bwd_route(dtype: torch.dtype, p: int, n: int) -> str:
    """The backward a CUDA call takes: `tensor_core` for bfloat16 at a
    (P, N) of `TC_SHAPES` (csrc/ssd_bwd.cu is compiled for the forward's
    shapes), `plain` for float32 and any other shape."""
    return ("tensor_core" if dtype == torch.bfloat16 and (p, n) in TC_SHAPES
            else "plain")


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


# ---------------------------------------------------------------- backward

def ssd_scan_bwd(x, dt, a, b, c, d, chunk: int, dy, dstate):
    return torch.ops.repro_torch.ssd_scan_bwd(x, dt, a, b, c, d, chunk, dy,
                                              dstate)


# the dispatch keys of code outside any operator: under a dispatch mode
# (the cost counter's) an implementation runs below autograd, and the plain
# VJP records its own graph
_PLAIN_KEYS = (torch._C._dispatch_tls_local_include_set(),
               torch._C._dispatch_tls_local_exclude_set())


def _bwd_plain_op(x, dt, a, b, c, d, chunk: int, dy, dstate):
    """The CPU's gradients: `ssd_scan_vjp`."""
    from ..models.mamba2 import ssd_scan_vjp
    one_device(x, dt, a, b, c, d, dy, dstate)
    with torch._C._ForceDispatchKeyGuard(*_PLAIN_KEYS):
        return ssd_scan_vjp(x, dt, a, b, c, d, chunk, dy, dstate)


def _bwd_launch_op(x, dt, a, b, c, d, chunk: int, dy, dstate):
    if ssd_bwd_route(x.dtype, int(x.shape[3]), int(b.shape[-1])) == "plain":
        out = _bwd_plain_op(x, dt, a, b, c, d, chunk, dy, dstate)
        count_launch(BWD_ROUTES, "plain")
        return out
    return _bwd(x, dt, a, b, c, d, chunk, dy, dstate, launch=True)


def _bwd_meta_op(x, dt, a, b, c, d, chunk: int, dy, dstate):
    if ssd_bwd_route(x.dtype, int(x.shape[3]), int(b.shape[-1])) == "plain":
        one_device(x, dt, a, b, c, d, dy, dstate)
        _check_groups(x, b, c, chunk)
        return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                     for t in (x, dt, a, b, c, d))
    return _bwd(x, dt, a, b, c, d, chunk, dy, dstate, launch=False)


def _bwd(x, dt, a, b, c, d, chunk: int, dy, dstate, launch: bool):
    """The card's `tensor_core` path: one launch a group of heads (none
    without `launch`: the outputs unwritten)."""
    one_device(x, dt, a, b, c, d, dy, dstate)
    _check_groups(x, b, c, chunk)
    bsz, s, h, p = (int(v) for v in x.shape)
    bg, cg = (b, c) if b.dim() == 4 else (b[:, :, None], c[:, :, None])
    g, n = int(bg.shape[2]), int(bg.shape[3])
    hg = h // g
    if dy.shape != x.shape or dy.dtype != x.dtype \
            or dstate.shape != (bsz, h, p, n) or dstate.dtype != torch.float32:
        raise ValueError(f"ssd_scan_bwd takes dy like x {tuple(x.shape)} "
                         f"and a float32 dstate (B, H, P, N); got "
                         f"{tuple(dy.shape)} {dy.dtype}, "
                         f"{tuple(dstate.shape)} {dstate.dtype}")
    for k in range(g):
        _check(x, dt, a, bg[:, :, k], cg[:, :, k], d)
        _check_tc(x, bg[:, :, k], cg[:, :, k])
    # dense (H, P) rows of 16-byte aligned groups: cp.async's rules hold
    dy, dstate = dy.contiguous(), dstate.contiguous()
    dev, f32 = x.device, torch.float32
    dx = torch.empty((bsz, s, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((bsz, s, h), dtype=f32, device=dev)
    # each (batch, head)'s da and dD, summed over the batch below
    parts = torch.empty((2, bsz, h), dtype=f32, device=dev)
    db = torch.zeros((bsz, s, g, n), dtype=f32, device=dev)
    dc = torch.zeros((bsz, s, g, n), dtype=f32, device=dev)
    chunks = -(-s // _TILE)
    scratch = torch.empty(bsz * hg * (chunks - 1) * 2 * n * p,
                          dtype=torch.bfloat16, device=dev)
    if launch:
        fn = _build.kernel_fn("ssd_bwd")
        stream = _build.stream_handle(dev)
        for k in range(g):
            h0 = k * hg
            rc = fn(x[:, :, h0:].data_ptr(), x.stride(0), x.stride(1),
                    dy[:, :, h0:].data_ptr(), dy.stride(0), dy.stride(1),
                    dt[:, :, h0:].data_ptr(), dt.stride(0), dt.stride(1),
                    a[h0:].data_ptr(), d[h0:].data_ptr(),
                    bg[:, :, k].data_ptr(), bg.stride(0), bg.stride(1),
                    cg[:, :, k].data_ptr(), cg.stride(0), cg.stride(1),
                    dstate[:, h0:].data_ptr(), dstate.stride(0), bsz, s, hg,
                    p, n, dx[:, :, h0:].data_ptr(), dx.stride(0), dx.stride(1),
                    ddt[:, :, h0:].data_ptr(), ddt.stride(0), ddt.stride(1),
                    parts[0, :, h0:].data_ptr(), parts[1, :, h0:].data_ptr(),
                    h, db[:, :, k].data_ptr(), db.stride(0), db.stride(1),
                    dc[:, :, k].data_ptr(), dc.stride(0), dc.stride(1),
                    scratch.data_ptr(), stream)
            _build.check_launch("ssd_scan_bwd", rc)
            count_launch(LAUNCHES, "ssd_scan_bwd")
        count_launch(BWD_ROUTES, "tensor_core")
    return (dx, ddt, parts[0].sum(0), db.to(b.dtype).reshape(b.shape),
            dc.to(c.dtype).reshape(c.shape), parts[1].sum(0))


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("ssd_scan(Tensor x, Tensor dt, Tensor a, Tensor b, Tensor c, "
            "int chunk, Tensor? d) -> (Tensor, Tensor)")
_LIB.impl("ssd_scan", _plain_op, "CPU")
_LIB.impl("ssd_scan", _launch_op, "CUDA")
_LIB.impl("ssd_scan", _meta_op, "Meta")
_LIB.define("ssd_scan_bwd(Tensor x, Tensor dt, Tensor a, Tensor b, Tensor c, "
            "Tensor d, int chunk, Tensor dy, Tensor dstate) -> (Tensor, "
            "Tensor, Tensor, Tensor, Tensor, Tensor)")
_LIB.impl("ssd_scan_bwd", _bwd_plain_op, "CPU")
_LIB.impl("ssd_scan_bwd", _bwd_launch_op, "CUDA")
_LIB.impl("ssd_scan_bwd", _bwd_meta_op, "Meta")
