"""Join algorithms (paper §3.1.1, Figure 4).

Two communication patterns:
  * shuffle join — both inputs hash-partitioned by key; each reducer joins
    corresponding partitions with a *local* algorithm chosen from runtime
    statistics (build hash over the small side; symmetric if both large);
  * map (broadcast) join — the small input is broadcast to all nodes and
    joined against each partition of the large input, skipping the shuffle.

PDE selects between them at run time from observed input sizes (§3.1.1); the
co-partitioned case (§3.4) degenerates to a zip of corresponding partitions.

The local algorithm is sort/searchsorted-based (vectorized "hash join" —
numpy has no cheap per-row hash table; sorted probe is its vector analogue,
and on the GPU the probe is sorts and gathers).  `_match_pairs` is the
interpreted oracle; `CompiledProbe` runs the same sort/searchsorted/expand
pipeline as torch operations on the session's device (a stable `argsort`,
`searchsorted`, `repeat_interleave`; DESIGN.md §11) — the reduce-side
router (physical.ReduceRunner) picks between them per bucket group.

String join keys never materialize strings: both sides' dictionary codes are
remapped into the union of the two (small) dictionaries and the probe runs
on int codes — the join-side half of the dictionary-preserving exchange.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .batch import PartitionBatch, merge_string_dicts
from .expr import ColumnVal, to_tensor

Matcher = Callable[[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]


def _match_pairs(lkeys: np.ndarray, rkeys: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Equi-join row index pairs (vectorized, duplicate-correct).

    Sorts the build side once, probes with searchsorted, expands duplicate
    ranges with repeat arithmetic.  The semantic oracle for CompiledProbe:
    both must emit the same pairs in the same order."""
    order = np.argsort(rkeys, kind="stable")
    rs = rkeys[order]
    lo = np.searchsorted(rs, lkeys, side="left")
    hi = np.searchsorted(rs, lkeys, side="right")
    counts = hi - lo
    lidx = np.repeat(np.arange(len(lkeys)), counts)
    if len(lidx) == 0:
        return lidx, lidx.copy()
    # offsets within each left row's match range
    starts = np.repeat(lo, counts)
    cum = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(len(lidx)) - np.repeat(cum, counts)
    ridx = order[starts + within]
    return lidx, ridx


# ---------------------------------------------------------------------------
# Compiled probe: the sort/searchsorted join as torch operations.  The match
# is data-dependent in its output size only; torch sizes that eagerly, so
# no padding is needed.
# ---------------------------------------------------------------------------


class CompiledProbe:
    """`_match_pairs` as torch operations on `device`: same pairs, same
    order (the stable sort keeps duplicate build rows in row order)."""

    def __init__(self, device="cpu"):
        self.device = device

    def __call__(self, lkeys: np.ndarray, rkeys: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        import torch
        n_l, n_r = len(lkeys), len(rkeys)
        if n_l == 0 or n_r == 0:
            empty = np.zeros(0, np.int64)
            return empty, empty.copy()
        dt = np.result_type(lkeys.dtype, rkeys.dtype)
        if dt.kind in ("U", "S", "O", "b"):
            # callers fall back to the numpy oracle on TypeError
            raise TypeError("CompiledProbe takes numeric/code keys")
        if dt.kind == "f" and (np.isnan(lkeys).any() or np.isnan(rkeys).any()):
            # NaN ordering in sort/searchsorted is not the oracle's concern
            # to match; callers fall back to it on TypeError
            raise TypeError("CompiledProbe takes no NaN float keys")
        if dt.kind == "u":
            dt = np.dtype(np.int64)
        lk = to_tensor(np.asarray(lkeys, dt), self.device)
        rk = to_tensor(np.asarray(rkeys, dt), self.device)
        order = torch.sort(rk, stable=True).indices
        rs = rk[order]
        lo = torch.searchsorted(rs, lk, right=False)
        counts = torch.searchsorted(rs, lk, right=True) - lo
        total = int(counts.sum())
        if total == 0:
            empty = np.zeros(0, np.int64)
            return empty, empty.copy()
        lidx = torch.repeat_interleave(
            torch.arange(n_l, device=lk.device), counts)
        cum = torch.cumsum(counts, 0) - counts
        within = (torch.arange(total, device=lk.device)
                  - torch.repeat_interleave(cum, counts))
        ridx = order[torch.repeat_interleave(lo, counts) + within]
        return lidx.cpu().numpy(), ridx.cpu().numpy()


_COMPILED_PROBES: Dict[str, CompiledProbe] = {}
_PROBE_LOCK = threading.Lock()


def compile_probe(device="cpu") -> CompiledProbe:
    """The process-wide compiled matcher of `device`."""
    key = str(device)
    with _PROBE_LOCK:
        probe = _COMPILED_PROBES.get(key)
        if probe is None:
            probe = _COMPILED_PROBES[key] = CompiledProbe(device)
        return probe


# ---------------------------------------------------------------------------
# Key extraction — decode-free for dictionary-coded strings
# ---------------------------------------------------------------------------


def _key_arrays(lbatch: PartitionBatch, rbatch: PartitionBatch,
                lkey: str, rkey: str) -> Tuple[np.ndarray, np.ndarray]:
    """Join keys comparable across the two sides.  String keys stay codes:
    both sides remap into the union of their (small) dictionaries, so no row
    ever materializes a string."""
    lv, rv = lbatch.col(lkey), rbatch.col(rkey)
    if lv.is_string and rv.is_string:
        _, (lmap, rmap) = merge_string_dicts([lv.sdict, rv.sdict])
        return (lmap.astype(np.int64)[np.asarray(lv.arr)],
                rmap.astype(np.int64)[np.asarray(rv.arr)])
    lk = lv.decoded() if lv.is_string else np.asarray(lv.arr)
    rk = rv.decoded() if rv.is_string else np.asarray(rv.arr)
    return lk, rk


def _key_array(batch: PartitionBatch, key: str) -> np.ndarray:
    """Single-side key materialization (legacy helper, kept for callers
    outside the two-sided join path)."""
    v = batch.col(key)
    return v.decoded() if v.is_string else np.asarray(v.arr)


def _combine(lbatch: PartitionBatch, lidx: np.ndarray,
             rbatch: PartitionBatch, ridx: np.ndarray,
             rsuffix: str = "_r") -> PartitionBatch:
    out: Dict[str, ColumnVal] = {}
    for n, v in lbatch.cols.items():
        out[n] = ColumnVal(np.asarray(v.arr)[lidx], v.sdict, v.sorted_dict)
    for n, v in rbatch.cols.items():
        name = n if n not in out else n + rsuffix
        out[name] = ColumnVal(np.asarray(v.arr)[ridx], v.sdict, v.sorted_dict)
    return PartitionBatch(out)


def _null_pad_right(out: PartitionBatch, lbatch: PartitionBatch,
                    rbatch: PartitionBatch, n_match: int,
                    n_miss: int) -> PartitionBatch:
    """NULL emulation for the unmatched tail of a left join: right-side
    numeric columns zero, right-side STRING columns get the reserved null
    code — the empty string joins the (sorted) dictionary and miss rows
    remap to it, matching the zero-partition pad_right path.  Without this,
    string miss rows silently kept whatever row the pad gather hit."""
    if n_miss == 0:
        return out
    for n, v in rbatch.cols.items():
        name = n if n not in lbatch.cols else n + "_r"
        cv = out.cols[name]
        if cv.is_string:
            base = cv.sdict if cv.sdict.size else np.zeros(0, np.str_)
            nd = np.unique(np.concatenate(
                [base, np.array([""], dtype=base.dtype if base.size
                                else np.str_)]))
            remap = np.searchsorted(nd, base).astype(np.int32)
            null_code = np.int32(np.searchsorted(nd, ""))
            codes = np.empty(n_match + n_miss, np.int32)
            codes[:n_match] = remap[np.asarray(cv.arr)[:n_match]]
            codes[n_match:] = null_code
            out.cols[name] = ColumnVal(codes, nd, True)
            continue
        arr = np.asarray(cv.arr).copy()
        if np.issubdtype(arr.dtype, np.number):
            arr[n_match:] = 0
        elif arr.dtype.kind in ("U", "S"):
            arr[n_match:] = ""   # raw strings (legacy decoded exchange)
        out.cols[name] = ColumnVal(arr, cv.sdict, cv.sorted_dict)
    return out


def join_local(lbatch: PartitionBatch, rbatch: PartitionBatch,
               lkey: str, rkey: str, how: str = "inner",
               matcher: Optional[Matcher] = None) -> PartitionBatch:
    """Local join of two co-located partitions.

    Mirrors the paper's reducer policy: probe from the larger side into the
    sorted smaller side (building over the small input); the symmetric case
    falls out naturally since sorted probe is order-symmetric.  `matcher`
    selects the pair-matching implementation (`_match_pairs` oracle by
    default, `CompiledProbe` when the reduce router picks the jit route)."""
    match = matcher if matcher is not None else _match_pairs
    lk, rk = _key_arrays(lbatch, rbatch, lkey, rkey)
    if how == "inner":
        if len(rk) <= len(lk):
            lidx, ridx = match(lk, rk)
        else:
            ridx, lidx = match(rk, lk)
        return _combine(lbatch, lidx, rbatch, ridx)
    if how == "left":
        lidx, ridx = match(lk, rk)
        matched = np.zeros(len(lk), bool)
        matched[lidx] = True
        miss = np.flatnonzero(~matched)
        if len(rk) == 0:
            # no right rows at all: emit left rows + null-padded right cols
            out = _combine(lbatch, miss,
                           PartitionBatch.empty_like(rbatch),
                           np.zeros(0, np.int64))
            for n, v in rbatch.cols.items():
                name = n if n not in lbatch.cols else n + "_r"
                cv = out.cols[name]
                if cv.is_string:
                    out.cols[name] = ColumnVal(
                        np.zeros(len(miss), np.int32),
                        np.array([""], np.str_), True)
                else:
                    out.cols[name] = ColumnVal(
                        np.zeros(len(miss), np.asarray(v.arr).dtype))
            return out
        all_l = np.concatenate([lidx, miss])
        # right side for misses: gather row 0, then rewrite to NULL
        # emulation (zeros / reserved null code) below
        pad = np.zeros(len(miss), np.int64)
        all_r = np.concatenate([ridx, pad])
        out = _combine(lbatch, all_l, rbatch, all_r)
        return _null_pad_right(out, lbatch, rbatch, len(lidx), len(miss))
    raise NotImplementedError(how)


def broadcast_join(part: PartitionBatch, small: PartitionBatch,
                   part_key: str, small_key: str,
                   how: str = "inner",
                   matcher: Optional[Matcher] = None) -> PartitionBatch:
    """Map join: `small` is the broadcast table (already collected to the
    master and shipped to every task)."""
    return join_local(part, small, part_key, small_key, how, matcher=matcher)
