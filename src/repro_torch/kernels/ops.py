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
from . import groupby_mxu as _gb
from . import radix_partition as _rp
from . import segmented_merge as _sm

KERNEL_MODULES = {
    "colscan": _colscan,
    "fused_decode_scan": _dd,
    "groupby_sum": _gb,
    "radix_partition": _rp,
    "segmented_merge": _sm,
}


def on_gpu(device) -> bool:
    """True when `device` (the session's) is a CUDA device."""
    return device is not None and torch.device(device).type == "cuda"


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: m.LAUNCHES["count"] for name, m in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for m in KERNEL_MODULES.values():
        m.LAUNCHES["count"] = 0


def colscan(filter_col, agg_col, lo, hi) -> torch.Tensor:
    """[count, sum, min, max] of agg_col where lo <= filter_col <= hi."""
    return _colscan.colscan(filter_col, agg_col, lo, hi)


def fused_decode_scan(codes, dictionary, agg_col, lo, hi) -> torch.Tensor:
    return _dd.fused_decode_scan(codes, dictionary, agg_col, lo, hi)


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
