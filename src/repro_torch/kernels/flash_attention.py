"""Causal flash attention, forward (the prefill attention of every `dense`
layer and of the `hybrid` family's shared block).

`flash_attention_fwd(q, k, v, causal)` returns `softmax(q k^T / sqrt(hd))
v` with the causal mask `col <= row` (absolute indices), for q (B, H, S,
hd) and k, v (B, KV, T, hd) in the reference kernel's layout, with H a
multiple of KV: grouped-query attention, query head h reading kv head
h // (H // KV), the reference model's grouping (KV == H is MHA).  k and v
are read as they are, never repeated; any other head count raises.  Scores,
running max, running denominator and the output accumulator are float32;
the output has q's dtype and is divided by `max(l, 1e-30)`, as the
reference kernel's finalize does.  bfloat16 and float32 inputs; hd up to
128; any S and T (the ragged last tile is masked, where the reference
wrapper asserts `s % block_q == 0`).  With `return_lse=True` it also
returns each row's log-sum-exp of its scaled, masked scores (m + log l of
the online softmax, natural log), float32 (B, H, S): what the backward
(`models/flash.py`) recomputes the probabilities from, as the reference's
oracle `_flash_fwd_impl` returns it (its Pallas kernel keeps it in
scratch).  The kernel writes it only when asked.

On CUDA tensors the wrapper launches `csrc/flash.cu` (it replaces
repro/kernels/flash_attention.py:flash_attention_fwd; the design note is in
the source) on one of two routes, chosen by `flash_route(dtype, hd)` and
counted in `ROUTES`:
- `tensor_core`: bfloat16 with hd % 8 == 0 (hd <= 128) runs the TMA and
  wgmma kernel on the bf16 tensor cores, P rounded to bfloat16 before the
  P V product as flash kernels do.  TMA needs 16-byte aligned bases and
  strides of a multiple of 8 elements, checked on each operand's own
  shape: the wrapper raises on anything else rather than copy.
- `simt`: float32 (bf16 tensor cores would lose its 1e-4 tolerance, TF32
  keeps about three digits), and bfloat16 at any other hd, run the float32
  FMA kernel on the CUDA cores.
Both take each operand's batch, head and sequence strides, so a (B, S, H,
hd) tensor seen through `.transpose(1, 2)` needs no copy; the output is
allocated in q's layout.  On CPU tensors the wrapper runs
`flash_attention_fwd_plain`, the masked softmax in float32 over the
queries grouped by kv head.  The call is one operator,
`torch.ops.repro_torch.flash_attention_fwd`, with an implementation for
each of the CPU, CUDA and meta devices: a dispatch mode such as the dry
run's cost counter (`launch/cost.CostCounter`) sees it once, and not the
operations it runs inside; on meta tensors it makes the card's checks
and returns the card's outputs, unwritten.  It is defined with
`torch.library.Library`: `torch.library.custom_op` would import
`torch._dynamo` at its first call (about 10 s on an H100 host, paid by a
fresh server's first prefill).
"""

from __future__ import annotations

import math
from typing import List

import torch

from . import _build
from ._common import count_launch, one_device

LAUNCHES = {"flash_attention_fwd": 0}
# launches per route (the tensor-core and the float32 SIMT kernel)
ROUTES = {"tensor_core": 0, "simt": 0}
_ROUTE_CODES = {"simt": 0, "tensor_core": 1}
MAX_HEAD_DIM = 128      # flash.cu's shared-memory tiles
NEG_INF = -1e30


def flash_route(dtype: torch.dtype, hd: int) -> str:
    """The kernel a CUDA call takes: `tensor_core` for bfloat16 with a head
    dim that is a multiple of 8 (the TMA boxes' 16-byte rule), `simt` for
    float32 and any other bfloat16 head dim."""
    return ("tensor_core" if dtype == torch.bfloat16 and hd % 8 == 0
            else "simt")


def _groups(q: torch.Tensor, k: torch.Tensor) -> int:
    """Query heads per kv head; raises unless k's heads divide q's."""
    h, kv = q.shape[1], k.shape[1]
    if kv < 1 or h % kv:
        raise ValueError(f"flash_attention_fwd groups query heads by kv "
                         f"head: q's {h} heads are no multiple of k's {kv}")
    return h // kv


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              return_lse: bool = False):
    """Plain PyTorch version (any device): the full masked softmax in
    float32, cast to q's dtype.  GQA the reference model's way: q seen as
    (B, KV, H / KV, S, hd) against the raw k and v.  With `return_lse`,
    also each row's log-sum-exp of its scaled, masked scores, float32
    (B, H, S)."""
    b, h, s, hd = q.shape
    kv, t = k.shape[1], k.shape[2]
    g = _groups(q, k)
    qf = q.float().reshape(b, kv, g, s, hd) / math.sqrt(hd)
    sc = torch.einsum("bkgsd,bktd->bkgst", qf, k.float())
    if causal:
        mask = torch.ones(s, t, dtype=torch.bool, device=q.device).tril()
        sc = torch.where(mask, sc, torch.tensor(NEG_INF, device=q.device))
    out = torch.einsum("bkgst,bktd->bkgsd", torch.softmax(sc, dim=-1),
                       v.float())
    out = out.reshape(b, h, s, hd).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(sc, dim=-1).reshape(b, h, s)
    return out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_fwd takes q (B, H, S, hd) and k, v "
                         f"(B, KV, T, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    _groups(q, k)
    if not (q.dtype == k.dtype == v.dtype
            and q.dtype in (torch.bfloat16, torch.float32)):
        raise TypeError(f"q, k, v must share bfloat16 or float32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= q.shape[3] <= MAX_HEAD_DIM:
        raise ValueError(f"flash kernel takes head dim 1..{MAX_HEAD_DIM}, "
                         f"got {q.shape[3]}")
    if min(q.shape[2], k.shape[2]) < 1:
        raise ValueError("flash_attention_fwd needs S >= 1 and T >= 1")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")


def _check_tma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """TMA's rules on the tensor-core route: 16-byte aligned bases, and in
    every dimension longer than 1 a positive stride of a multiple of 8
    elements (16 bytes)."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} starts at an address that is not "
                             f"16-byte aligned; the tensor-core route "
                             f"reads it with TMA")
        for dim in range(3):
            st = t.stride(dim)
            if t.shape[dim] > 1 and (st <= 0 or st % 8):
                raise ValueError(
                    f"{name}'s stride {st} in dim {dim} is not a positive "
                    f"multiple of 8 elements; the tensor-core route reads "
                    f"it with TMA")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, return_lse: bool = False):
    got = torch.ops.repro_torch.flash_attention_fwd(q, k, v, causal,
                                                    return_lse)
    return (got[0], got[1]) if return_lse else got[0]


def _outputs(q, k, v, return_lse: bool) -> List[torch.Tensor]:
    """The card's checks, and its outputs allocated: o in q's layout when
    dense, else contiguous, and the (B, H, S) log-sum-exp if asked."""
    one_device(q, k, v)
    _check(q, k, v)
    if flash_route(q.dtype, int(q.shape[3])) == "tensor_core":
        _check_tma(q, k, v)
    b, h, s = (int(x) for x in q.shape[:3])
    return [torch.empty_like(q)] + (
        [torch.empty((b, h, s), dtype=torch.float32, device=q.device)]
        if return_lse else [])


def _plain_op(q, k, v, causal: bool, return_lse: bool) -> List[torch.Tensor]:
    """The CPU's [o] or [o, lse]: the plain version, o in q's layout as
    the kernel writes it."""
    one_device(q, k, v)
    got = flash_attention_fwd_plain(q, k, v, causal, return_lse)
    o = got[0] if return_lse else got
    return [torch.empty_like(q).copy_(o)] + ([got[1]] if return_lse else [])


def _launch_op(q, k, v, causal: bool, return_lse: bool
               ) -> List[torch.Tensor]:
    """The card's [o] or [o, lse]: one launch of csrc/flash.cu."""
    outs = _outputs(q, k, v, return_lse)
    out, lse = outs[0], (outs[1] if return_lse else None)
    b, h, s, hd = (int(x) for x in q.shape)
    kv, t = int(k.shape[1]), int(k.shape[2])
    route = flash_route(q.dtype, hd)
    rc = _build.kernel_fn("flash")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None, _build.dtype_code(q),
        _ROUTE_CODES[route], b, h, kv, s, t, hd,
        int(causal), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], _build.stream_handle(q.device))
    _build.check_launch("flash_attention_fwd", rc)
    count_launch(LAUNCHES, "flash_attention_fwd")
    count_launch(ROUTES, route)
    return outs


def _meta_op(q, k, v, causal: bool, return_lse: bool) -> List[torch.Tensor]:
    return _outputs(q, k, v, return_lse)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "bool return_lse) -> Tensor[]")
_LIB.impl("flash_attention_fwd", _plain_op, "CPU")
_LIB.impl("flash_attention_fwd", _launch_op, "CUDA")
_LIB.impl("flash_attention_fwd", _meta_op, "Meta")
