"""Top-k dot-product similarity search (DESIGN.md §15.3).

`topk_similarity(x, q, k)` returns `(scores, rows)`: the m = min(k, n)
rows of x (n, d) with the highest `x_i . q`, as float64 scores and int64
row ids, ordered by score descending, then row ascending — exactly
`np.argsort(-s, kind="stable")[:k]` over the float64 scores.  NaN scores
rank below every number, as numpy's argsort puts them last.  x is float32
or float64, q float64; the score is summed lane by lane in float64, each
product and sum rounded on its own, on both versions, so they agree to
the bit.  Any k >= 1 is allowed, including k > n.

`topk_similarity_lanes(lanes, weights, k)` is the same function over d
1-D lane columns (x's columns, read where they lie) and host-side
weights: it equals `topk_similarity(torch.stack(lanes, 1), q, k)` to the
bit.  The search path calls it for up to MAX_LANES lanes of one float
dtype; `search_route` names the choice and the caller counts it in
`ROUTES`.

On CUDA tensors the wrappers launch `csrc/topk.cu` (it replaces
repro/kernels/topk_similarity.py:topk_similarity; the design note is in
the source).  Two routes, chosen by `topk_plan(n, d, k, dtype)` and
counted in `ROUTES` at each launch:
- `fused` (m <= FUSED_MAX_K): one launch; blocks keep a running top m
  over their tiles and the last block folds the block lists, so a call is
  one allocation (outputs and scratch) and one ctypes call, its plan word
  cached per shape.  The lanes entry passes the lane addresses and q's
  weights in the kernel's parameters: no stack, no copy of q;
- `rounds` (larger m): a scoring launch, then ceil(log2(tiles)) merge
  launches; the lanes entry stacks its lanes first.
The fold's ticket is a word per (device, stream), allocated at the first
call on that stream (`_common.stream_ticket`): warm a call up on the
stream that will capture a CUDA graph around it.  On CPU tensors they run
`topk_similarity_plain`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import _build
from ._common import count_launch, on_cpu, stream_ticket

LAUNCHES = {"topk_similarity": 0}
# the kernel's launches by route (on the card), and the search path's
# operands by route (any device): its lanes in place, or stacked
ROUTES = {"fused": 0, "rounds": 0, "lanes": 0, "stacked": 0}
TILE = 256              # rows per tile, one a thread (topk.cu)
MAX_DIMS = 4096         # q in shared memory
MAX_K = 1 << 23         # merge launches take 2 * min(k, n) threads a list
FUSED_MAX_K = 2048      # topk.cu kMaxFusedK
FUSED_MAX_BLOCKS = 132  # one block on each of the H100's SMs
# lane columns the lanes entry's kernel parameters hold: 256 addresses and
# 256 float64 weights, 4 KB, inside CUDA 12.1+'s 32,764-byte limit on sm_90
MAX_LANES = 256
# topk.cu's shared-memory layout (struct Layout): a stage ring of two
# 256-row tiles of 128-byte row chunks, each row padded by 16 bytes
CHUNK_BYTES, STAGES = 128, 2
STAGE_BYTES = TILE * (CHUNK_BYTES + 16)
SURVIVOR_CAP = 256
PREFIX = 16                     # entries of each list the fold reads first
SMEM_LIMIT = 232448 - 1024      # dynamic shared memory a block may ask for
FOLDS = ("threshold", "rounds")


def fused_smem(d: int, lanes: bool, m: int, g: int) -> int:
    """Bytes of dynamic shared memory of a fused launch (topk.cu's
    Layout): the scoring part (q, the stage ring, a tile's scores, sort
    exchange and list, two running lists) or, when larger, the last
    block's fold (the larger of the fast path's prefixes, subset and
    survivors and the merge rounds' full lists and half set, then lengths,
    counts and offsets)."""
    score = 0 if lanes else 8 * d
    score = -(-score // 16) * 16 + (0 if lanes else STAGES * STAGE_BYTES)
    score += 32 * TILE + 24 * m
    fast = 32 * g * PREFIX + 24 * SURVIVOR_CAP
    rounds = 12 * g * m + 12 * ((g + 1) // 2) * m
    fold = max(fast, rounds) + 4 * (3 * g + 1) + 4 * PREFIX
    return max(score, fold)


class TopkPlan(NamedTuple):
    route: str          # "fused" or "rounds"
    m: int              # rows returned, min(k, n)
    tiles: int          # 256-row tiles of x
    blocks: int         # fused: G, the blocks whose lists the last folds
    # fused: "threshold" (the plan's), or "rounds", which skips the fold's
    # fast path (the card tests and kernel_probe.py use it)
    fold: str

    def word(self) -> int:
        """topk.cu's fused plan word: bits 0-11 the blocks, bit 12 the
        fold."""
        return self.blocks | FOLDS.index(self.fold) << 12

    def buffer_words(self) -> int:
        """int64 words of the call's one allocation: out_r and out_s (m
        each), then the fused route's G lists of m float64 scores and m
        int32 rows, or the rounds route's two pairs of lists of tiles *
        min(k, 256) entries."""
        if self.route == "fused":
            return 2 * self.m + self.blocks * self.m \
                + -(-(self.blocks * self.m) // 2)
        return 2 * self.m + 4 * self.tiles * min(self.m, TILE)


def max_fused_blocks(d: int, lanes: bool, m: int) -> int:
    """The most blocks whose lists one block can fold in shared memory, at
    most FUSED_MAX_BLOCKS; 0 when not even one fits."""
    g = FUSED_MAX_BLOCKS
    while g and fused_smem(d, lanes, m, g) > SMEM_LIMIT:
        g -= 1
    return g


@functools.lru_cache(maxsize=4096)
def topk_plan(n: int, d: int, k: int, dtype: torch.dtype,
              lanes: bool = False) -> TopkPlan:
    """The launch of a top-k over n rows of d lanes: route `fused` for
    m = min(k, n) <= FUSED_MAX_K, with G = min(tiles, the blocks one fold
    holds) blocks (a function of (n, d, k) only, so the fold's order and
    the answer are the same on every run); route `rounds` above."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x must be float32 or float64, got {dtype}")
    if not 1 <= d <= (MAX_LANES if lanes else MAX_DIMS):
        raise ValueError(f"topk_similarity kernel takes 1.."
                         f"{MAX_LANES if lanes else MAX_DIMS} lanes, got {d}")
    if not 1 <= n < 2 ** 31 - 1 or k < 1:
        raise ValueError(f"topk_similarity kernel takes 1..2**31 - 2 rows "
                         f"and k >= 1, got n={n}, k={k}")
    m = min(k, n)
    if m > MAX_K:
        raise ValueError(f"topk_similarity kernel keeps at most {MAX_K} "
                         f"rows, got k={k}")
    tiles = -(-n // TILE)
    if m <= FUSED_MAX_K:
        g = min(tiles, max_fused_blocks(d, lanes, m))
        if g >= 1:
            return TopkPlan("fused", m, tiles, g, "threshold")
    return TopkPlan("rounds", m, tiles, 0, "threshold")


def scores_plain(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """float64 `x . q`, summed lane by lane as the kernel does."""
    s = torch.zeros(x.shape[0], dtype=torch.float64, device=x.device)
    q64 = q.to(torch.float64)
    for j in range(x.shape[1]):
        s = s + x[:, j].to(torch.float64) * q64[j]
    return s


def topk_similarity_plain(x: torch.Tensor, q: torch.Tensor, k: int):
    """Plain PyTorch version of the kernel (any device)."""
    s = scores_plain(x, q)
    nan = torch.isnan(s)
    clean = torch.where(nan, torch.full_like(s, -float("inf")), s)
    order = torch.sort(-clean, stable=True).indices
    order = order[torch.sort(nan[order].to(torch.int8), stable=True).indices]
    rows = order[:min(int(k), s.shape[0])]
    return s[rows], rows


_TICKETS = {}


def _ticket(device: torch.device) -> torch.Tensor:
    """The fold ticket of `device`'s current stream."""
    return stream_ticket(_TICKETS, device, _build.stream_handle(device),
                         "topk_similarity")


def _launch(plan: TopkPlan, x, lanes_desc, dt_code: int, q, n: int, d: int,
            k: int, dev: torch.device):
    """One call on `plan`'s route: (out_s, out_r) views of its one
    allocation."""
    m = plan.m
    buf = torch.empty(plan.buffer_words(), dtype=torch.int64, device=dev)
    out_r, out_s = buf[:m], buf[m:2 * m].view(torch.float64)
    stream = _build.stream_handle(dev)
    if plan.route == "fused":
        ticket = _ticket(dev) if plan.blocks > 1 else None
        rc = _build.kernel_fn("topk_fused")(
            x, lanes_desc, dt_code, q, n, d, m, plan.word(), buf.data_ptr(),
            ticket.data_ptr() if ticket is not None else None, stream)
    else:
        slots = plan.tiles * min(m, TILE)
        base, f64 = buf.data_ptr(), 8
        rc = _build.kernel_fn("topk")(
            x, dt_code, q, n, d, k,
            *(base + f64 * (2 * m + i * slots) for i in range(4)),
            out_s.data_ptr(), out_r.data_ptr(), stream)
    _build.check_launch("topk_similarity", rc)
    count_launch(LAUNCHES, "topk_similarity")
    count_launch(ROUTES, plan.route)
    return out_s, out_r


def topk_similarity(x: torch.Tensor, q: torch.Tensor, k: int):
    if int(k) < 1:
        raise ValueError(f"topk_similarity: k must be >= 1, got {k}")
    if on_cpu(x, q):
        return topk_similarity_plain(x, q, k)
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (n, d) matrix, got shape "
                         f"{tuple(x.shape)}")
    n, d = (int(s) for s in x.shape)
    if q.shape != (d,) or q.dtype != torch.float64 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous ({d},) float64 vector, got "
                         f"{q.dtype} {tuple(q.shape)}")
    if n == 0:
        return (torch.empty(0, dtype=torch.float64, device=x.device),
                torch.empty(0, dtype=torch.int64, device=x.device))
    plan = topk_plan(n, d, int(k), x.dtype)
    return _launch(plan, x.data_ptr(), None, _build.dtype_code(x),
                   q.data_ptr(), n, d, int(k), x.device)


def search_route(lanes: Sequence[torch.Tensor]) -> str:
    """The search path's operand: "lanes" (`topk_similarity_lanes` reads
    the columns in place) for 1..MAX_LANES 1-D contiguous columns of one
    float32 or float64 dtype, length and device, else "stacked"
    (`topk_similarity` over their stack)."""
    if not 1 <= len(lanes) <= MAX_LANES:
        return "stacked"
    first = lanes[0]
    dtype, shape, dev = first.dtype, first.shape, first.get_device()
    if dtype not in (torch.float32, torch.float64) or len(shape) != 1:
        return "stacked"
    dense = (1,) if shape[0] > 1 else None     # one row: any stride
    for t in lanes:
        if t.dtype is not dtype or t.shape != shape \
                or t.get_device() != dev \
                or (dense is not None and t.stride() != dense):
            return "stacked"
    return "lanes"


def pack_lane_descriptors(lanes: Sequence[torch.Tensor],
                          weights) -> np.ndarray:
    """topk.cu's lanes operand: the d lane addresses, then the d float64
    weights' bits, as 2 d int64 words (host memory, copied into the
    kernel's parameters at the launch)."""
    w = np.ascontiguousarray(weights, dtype=np.float64).reshape(-1)
    if not 1 <= len(lanes) <= MAX_LANES or w.shape[0] != len(lanes):
        raise ValueError(f"the lanes entry takes 1..{MAX_LANES} lanes with "
                         f"one weight each, got {len(lanes)} lanes and "
                         f"{w.shape[0]} weights")
    out = np.empty(2 * len(lanes), dtype=np.int64)
    out[:len(lanes)] = [t.data_ptr() for t in lanes]
    out[len(lanes):] = w.view(np.int64)
    return out


def topk_similarity_lanes(lanes: Sequence[torch.Tensor], weights, k: int):
    """`topk_similarity(torch.stack(lanes, 1), q, k)` with q the float64
    `weights` (a host sequence): on the card the lanes are read where they
    lie, on the `fused` route in one launch."""
    lanes = list(lanes)
    on_card = not (lanes and not lanes[0].is_cuda and on_cpu(*lanes))
    if on_card and search_route(lanes) != "lanes":
        raise ValueError(f"the lanes entry takes 1..{MAX_LANES} contiguous "
                         f"1-D float32 or float64 lanes of one dtype, length "
                         f"and device")
    return lanes_checked(lanes, weights, k)


def lanes_checked(lanes: Sequence[torch.Tensor], weights, k: int):
    """`topk_similarity_lanes` for lanes that `search_route` has named
    "lanes" (the search path checks them once, not twice)."""
    if int(k) < 1:
        raise ValueError(f"topk_similarity: k must be >= 1, got {k}")
    n, d, dev = int(lanes[0].shape[0]), len(lanes), lanes[0].device
    if dev.type == "cpu":
        q = torch.as_tensor(np.asarray(weights, dtype=np.float64))
        return topk_similarity_plain(torch.stack(list(lanes), 1), q, k)
    desc = pack_lane_descriptors(lanes, weights)
    if n == 0:
        return (torch.empty(0, dtype=torch.float64, device=dev),
                torch.empty(0, dtype=torch.int64, device=dev))
    plan = topk_plan(n, d, int(k), lanes[0].dtype, lanes=True)
    if plan.route != "fused":
        q = torch.from_numpy(desc[d:].view(np.float64).copy()).to(dev)
        return topk_similarity(torch.stack(list(lanes), 1), q, k)
    return _launch(plan, None, desc.ctypes.data, _build.dtype_code(lanes[0]),
                   None, n, d, int(k), dev)
