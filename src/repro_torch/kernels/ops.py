"""Engine-facing wrappers of the hand-written kernels.

Every wrapper takes torch tensors.  On CPU tensors it runs the kernel's
plain PyTorch version (what interpret mode is to the reference's Pallas kernels);
on CUDA tensors it launches the CUDA kernel or raises.  The engine routes
to the kernels when its session device is a GPU (`on_gpu`), or when
`PDEConfig.segment_force_kernels` forces the routes on the CPU.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import colscan as _colscan
from . import dictdecode as _dd
from . import flash_attention as _fa
from . import groupby_mxu as _gb
from . import radix_partition as _rp
from . import segmented_merge as _sm
from . import ssd_scan as _ssd
from . import topk_similarity as _tk
from . import train_grad as _tg

# kernel name -> the module whose LAUNCHES counts it (dictdecode holds four)
KERNEL_MODULES = {
    "colscan": _colscan,
    "fused_decode_scan": _dd,
    "groupby_sum": _gb,
    "radix_partition": _rp,
    "segmented_merge": _sm,
    "dict_decode": _dd,
    "bitpack_decode": _dd,
    "rle_decode": _dd,
    "topk_similarity": _tk,
    "train_grad": _tg,
    "flash_attention_fwd": _fa,
    "ssd_scan": _ssd,
    "ssd_scan_bwd": _ssd,
}


def on_gpu(device) -> bool:
    """True when `device` (the session's) is a CUDA device."""
    return device is not None and torch.device(device).type == "cuda"


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: m.LAUNCHES[name] for name, m in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for name, m in KERNEL_MODULES.items():
        m.LAUNCHES[name] = 0


def colscan(filter_col, agg_col, lo, hi) -> torch.Tensor:
    """[count, sum, min, max] of agg_col where lo <= filter_col <= hi."""
    return _colscan.colscan(filter_col, agg_col, lo, hi)


def fused_decode_scan(codes, dictionary, agg_col, lo, hi) -> torch.Tensor:
    return _dd.fused_decode_scan(codes, dictionary, agg_col, lo, hi)


def dict_decode(codes, dictionary) -> torch.Tensor:
    """`dictionary[codes]` (jnp's indexing rule for out-of-range codes)."""
    return _dd.dict_decode(codes, dictionary)


def bitpack_decode(words, bit_width: int, bias: int, n: int) -> torch.Tensor:
    """The first n int32 lanes of the packed words, plus `bias`."""
    return _dd.bitpack_decode(words, bit_width, bias, n)


def bitpack_decode_into(blocks, dests, n: int) -> None:
    """Each `dictdecode.BitpackBlock`'s n rows, plus its int64 bias and cast
    to its dtype, into its (n,) destination: one launch per
    MAX_BITPACK_COLUMNS blocks."""
    _dd.bitpack_decode_into(blocks, dests, n)


def rle_decode(run_values, run_ends, n: int) -> torch.Tensor:
    """Runs expanded to n positions; run_ends cumulative exclusive."""
    return _dd.rle_decode(run_values, run_ends, n)


def rle_decode_into(run_values, run_ends, n: int, dst,
                    orig_dtype=None) -> None:
    """Runs expanded to n positions, cast to `orig_dtype` (default the
    values' own), then into the (n,) destination `dst`: one launch."""
    _dd.rle_decode_into(run_values, run_ends, n, dst, orig_dtype)


def groupby_sum(codes, values, num_groups: int) -> torch.Tensor:
    """(num_groups, 2) per-group [sum, count]."""
    return _gb.groupby_sum(codes, values, num_groups)


def segmented_merge(codes, values, num_groups: int) -> torch.Tensor:
    """(num_groups, 4) per-group [sum, count, min, max] — the reduce-side
    merge of one aggregate state column (DESIGN.md §11)."""
    return _sm.segmented_merge(codes, values, num_groups)


def radix_partition(keys_u32, num_buckets: int, with_counts: bool = True):
    """(bucket_ids, per-bucket counts) for folded 32-bit key hashes;
    `with_counts=False` skips the histogram (ids-only callers)."""
    return _rp.radix_partition(keys_u32, num_buckets=num_buckets,
                               with_counts=with_counts)


def topk_similarity(x, q, k: int):
    """(scores, row ids) of the min(k, rows) rows of `x` most similar to
    `q` by dot product: scores descending, ties by ascending row, exactly
    `np.argsort(-scores, kind="stable")[:k]` (DESIGN.md §15.3)."""
    return _tk.topk_similarity(x, q, k)


def topk_similarity_lanes(lanes, weights, k: int):
    """`topk_similarity(torch.stack(lanes, 1), weights, k)`, its lane
    columns read in place and its float64 weights a host sequence."""
    return _tk.topk_similarity_lanes(lanes, weights, k)


def train_grad(x, y, w, kind: str = "logistic") -> torch.Tensor:
    """Unnormalised batch gradient `x.T @ (pred(x @ w) - y)` as a float64
    (d,) tensor — the kernel route of `pde.decide_train_backend`."""
    return _tg.train_grad(x, y, w, kind)


def flash_attention_fwd(q, k, v, causal: bool = True,
                        return_lse: bool = False):
    """Causal attention forward, q (B, H, S, hd), k, v (B, KV, T, hd), H a
    multiple of KV (GQA; KV == H is MHA); float32 softmax, output in q's
    dtype (every GQA prefill's attention); with `return_lse`, also the
    rows' log-sum-exp (B, H, S) float32, for the backward."""
    return _fa.flash_attention_fwd(q, k, v, causal, return_lse)


def ssd_scan(x, dt, a, b, c, chunk: int = 128, d=None):
    """(y, final_state) of the Mamba2 SSD scan, b and c (B, S, N) or
    (B, S, G, N) for G B/C groups: y in x's dtype (plus the D skip when
    `d` is given), final_state (B, H, P, N) float32 (every Mamba2
    prefill)."""
    return _ssd.ssd_scan(x, dt, a, b, c, chunk, d)


def ssd_scan_bwd(x, dt, a, b, c, d, chunk: int, dy, dstate):
    """The SSD scan's gradients (dx, ddt, da, db, dc, dd) given dy and
    dstate, those of y and the final state (every Mamba2 training step's
    backward): kernel 12's backward for bf16 at a (P, N) the kernels are
    compiled for, the plain VJP otherwise."""
    return _ssd.ssd_scan_bwd(x, dt, a, b, c, d, chunk, dy, dstate)


# -- double-buffered kernel dispatch (DESIGN.md §14) --------------------
#
# PyTorch launches asynchronously on the current stream: a kernel call
# returns its output tensor before the device work completes, and only the
# copy to host blocks.  double_buffer_map uses that to overlap chunk i+1's
# dispatch (including the host-side staging of its inputs) with chunk i's
# compute: one launch is kept in flight while the previous result drains.
# DOUBLE_BUFFER["dispatches"] counts launches so tests can assert the
# chunked path ran.

DOUBLE_BUFFER = {"chunk_rows": 131072, "dispatches": 0}


def _to_numpy(x):
    if isinstance(x, tuple):
        return tuple(_to_numpy(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def double_buffer_map(fn, chunks):
    """Map `fn` over `chunks`, keeping one dispatch in flight.

    `fn(chunk)` returns a tensor (or a tuple of them); results come back as
    numpy, in order.  With one chunk this is a plain call."""
    out = []
    inflight = None
    for chunk in chunks:
        nxt = fn(chunk)              # asynchronous launch
        DOUBLE_BUFFER["dispatches"] += 1
        if inflight is not None:
            out.append(_to_numpy(inflight))
        inflight = nxt
    if inflight is not None:
        out.append(_to_numpy(inflight))
    return out
