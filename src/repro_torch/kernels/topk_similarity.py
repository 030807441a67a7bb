"""Top-k dot-product similarity search (DESIGN.md §15.3).

`topk_similarity(x, q, k)` returns `(scores, rows)`: the m = min(k, n)
rows of x (n, d) with the highest `x_i . q`, as float64 scores and int64
row ids, ordered by score descending, then row ascending — exactly
`np.argsort(-s, kind="stable")[:k]` over the float64 scores.  NaN scores
rank below every number, as numpy's argsort puts them last.  x is float32
or float64, q float64; the score is summed lane by lane in float64, each
product and sum rounded on its own, on both versions, so they agree to
the bit.  Any k >= 1 is allowed, including k > n.

On CUDA tensors the wrapper launches `csrc/topk.cu` (it replaces
repro/kernels/topk_similarity.py:topk_similarity, whose running top-k
across a sequential grid has no counterpart on Hopper: per-tile ranking,
then rounds of pairwise merges, see the note in the source).  On CPU
tensors it runs `topk_similarity_plain`.
"""

from __future__ import annotations

import torch

from . import _build
from ._common import count_launch, on_cpu

LAUNCHES = {"topk_similarity": 0}
TILE = 256              # rows per block of the scoring launch (topk.cu)
MAX_DIMS = 4096         # q in shared memory
MAX_K = 1 << 23         # merge launches take 2 * min(k, n) threads a list


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


def topk_similarity(x: torch.Tensor, q: torch.Tensor, k: int):
    if int(k) < 1:
        raise ValueError(f"topk_similarity: k must be >= 1, got {k}")
    if on_cpu(x, q):
        return topk_similarity_plain(x, q, k)
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (n, d) matrix, got shape "
                         f"{tuple(x.shape)}")
    n, d = (int(s) for s in x.shape)
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    if q.shape != (d,) or q.dtype != torch.float64 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous ({d},) float64 vector, got "
                         f"{q.dtype} {tuple(q.shape)}")
    if not 1 <= d <= MAX_DIMS or n >= 2 ** 31:
        raise ValueError(f"topk_similarity kernel takes 1..{MAX_DIMS} lanes "
                         f"and fewer than 2**31 rows, got ({n}, {d})")
    m = min(int(k), n)
    if m > MAX_K:
        raise ValueError(f"topk_similarity kernel keeps at most {MAX_K} "
                         f"rows, got k={k}")
    dev = x.device
    out_s = torch.empty(m, dtype=torch.float64, device=dev)
    out_r = torch.empty(m, dtype=torch.int64, device=dev)
    if n == 0:
        return out_s, out_r
    slots = -(-n // TILE) * min(int(k), TILE)
    buf = [torch.empty(slots, dtype=dt, device=dev)
           for dt in (torch.float64, torch.int64) * 2]
    rc = _build.kernel_fn("topk")(
        x.data_ptr(), _build.dtype_code(x), q.data_ptr(), n, d, int(k),
        *(b.data_ptr() for b in buf), out_s.data_ptr(), out_r.data_ptr(),
        _build.stream_handle(dev))
    _build.check_launch("topk_similarity", rc)
    count_launch(LAUNCHES, "topk_similarity")
    return out_s, out_r
