"""Hash aggregation (paper §6.2.2, §6.3.1).

Like Shark (and Hive), aggregations run in two phases: task-local partial
aggregation on each partition, then a shuffle of the partial states by group
key and a final merge on the reduce side.  Spark's hash-based distributed
aggregation (no sort before shuffle, §7.1) is reproduced: grouping is
hash/unique-based, never a global sort.

Integer aggregates stay integer end to end: SUM/MIN/MAX over integer
columns accumulate in int64 (value-exact above 2^53, where a float64
round-trip silently loses precision); float aggregates accumulate in
float64.  String group keys are dictionary codes throughout — with the
dictionary-preserving exchange (DESIGN.md §11) the reduce side groups on
codes into the unified dictionary and never materializes strings.

`partial_aggregate` / `merge_aggregate` are the interpreted (numpy) oracle.
`CompiledMerge` lowers the reduce-side merge into ONE torch segmented-
reduce function over all aggregate states (`index_add_` and
`scatter_reduce` on the session's device, cached per state signature),
mirroring what expr.compile_expr does for scan-side expressions; the
reduce router (physical.ReduceRunner) picks between them per reduce
task.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .batch import PartitionBatch
from .expr import (ColumnVal, Evaluator, ExprCompileError, evaluate,
                   to_tensor)
from .plan import AggFunc, AggSpec


def group_indices(keys: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Group rows by composite key.  Returns (representative row indices of
    each group, inverse mapping row -> group id).  Hash-based (np.unique),
    not sort-order dependent."""
    n = len(keys[0]) if keys else 0
    if not keys:
        return np.zeros(1, np.int64), np.zeros(n, np.int64)
    if len(keys) == 1:
        _, first, inverse = np.unique(keys[0], return_index=True,
                                      return_inverse=True)
        return first, inverse
    # composite: unique over a void view of stacked columns
    cols = [np.asarray(k) for k in keys]
    rec = np.empty(n, dtype=[(f"k{i}", c.dtype) for i, c in enumerate(cols)])
    for i, c in enumerate(cols):
        rec[f"k{i}"] = c
    _, first, inverse = np.unique(rec, return_index=True, return_inverse=True)
    return first, inverse


# -- integer-exact segmented reductions (the numpy oracle) -------------------

INT64_MIN_IDENT = np.iinfo(np.int64).max   # MIN identity for empty groups
INT64_MAX_IDENT = np.iinfo(np.int64).min


def seg_sum(inverse: np.ndarray, val: np.ndarray,
            num_groups: int) -> np.ndarray:
    """Per-group sum; int64 accumulation for integer inputs (bincount's
    float64 weights would round above 2^53), float64 otherwise."""
    if np.issubdtype(val.dtype, np.integer) or val.dtype.kind == "b":
        acc = np.zeros(num_groups, np.int64)
        np.add.at(acc, inverse, val.astype(np.int64))
        return acc
    return np.bincount(inverse, weights=val.astype(np.float64),
                       minlength=num_groups)


def seg_minmax(inverse: np.ndarray, val: np.ndarray, num_groups: int,
               is_min: bool) -> np.ndarray:
    """Per-group min/max with dtype-preserving accumulators: int64 with
    iinfo sentinels for integer inputs, float64 with ±inf otherwise."""
    if np.issubdtype(val.dtype, np.integer):
        fill = INT64_MIN_IDENT if is_min else INT64_MAX_IDENT
        acc = np.full(num_groups, fill, np.int64)
        v = val.astype(np.int64)
    else:
        acc = np.full(num_groups, np.inf if is_min else -np.inf, np.float64)
        v = val.astype(np.float64)
    (np.minimum if is_min else np.maximum).at(acc, inverse, v)
    return acc


def combine_colscan_stats(stats: Sequence[Sequence[float]]
                          ) -> Tuple[float, float, float, float]:
    """Combine per-chunk colscan [count, sum, min, max] states into one.

    Count/min/max combine exactly; the sum stays in the same float64
    rounding class as a single-pass accumulation (DESIGN.md §14: the
    double-buffered chunked colscan must be a semantic no-op)."""
    cnt = 0.0
    s = np.float64(0.0)
    mn = np.inf
    mx = -np.inf
    for st in stats:
        cnt += float(st[0])
        s = s + np.float64(st[1])
        if float(st[0]) > 0:
            mn = min(mn, float(st[2]))
            mx = max(mx, float(st[3]))
    return cnt, float(s), mn, mx


# State columns per aggregate: AVG keeps (sum, count); COUNT_DISTINCT defers
# to the reduce side (map side emits distinct (group, value) pairs).

def _state_cols(spec: AggSpec) -> List[str]:
    if spec.func == AggFunc.AVG:
        return [f"__{spec.out_name}__sum", f"__{spec.out_name}__cnt"]
    if spec.func == AggFunc.COUNT:
        return [f"__{spec.out_name}__cnt"]
    if spec.func == AggFunc.COUNT_DISTINCT:
        return [f"__{spec.out_name}__val"]
    return [f"__{spec.out_name}__acc"]


def _group_key_cols(batch: PartitionBatch, group_cols: Sequence[str],
                    first: np.ndarray) -> Dict[str, ColumnVal]:
    """Representative group-key columns (codes stay codes) — shared by
    every merge/partial output assembly."""
    out: Dict[str, ColumnVal] = {}
    for g in group_cols:
        v = batch.col(g)
        out[g] = ColumnVal(np.asarray(v.arr)[first], v.sdict, v.sorted_dict)
    return out


def _partial_states(spec: AggSpec, inverse: np.ndarray,
                    val: Optional[np.ndarray], num_groups: int,
                    out: Dict[str, ColumnVal]) -> None:
    """One spec's partial state columns for a pre-grouped partition."""
    if spec.func == AggFunc.COUNT:
        acc = np.bincount(inverse, minlength=num_groups).astype(np.int64)
        out[_state_cols(spec)[0]] = ColumnVal(acc)
    elif spec.func == AggFunc.SUM:
        out[_state_cols(spec)[0]] = ColumnVal(seg_sum(inverse, val,
                                                      num_groups))
    elif spec.func == AggFunc.AVG:
        s = np.bincount(inverse, weights=val.astype(np.float64),
                        minlength=num_groups)
        c = np.bincount(inverse, minlength=num_groups).astype(np.int64)
        sc, cc = _state_cols(spec)
        out[sc] = ColumnVal(s)
        out[cc] = ColumnVal(c)
    elif spec.func in (AggFunc.MIN, AggFunc.MAX):
        out[_state_cols(spec)[0]] = ColumnVal(
            seg_minmax(inverse, val, num_groups,
                       spec.func == AggFunc.MIN))
    else:
        raise NotImplementedError(spec.func)


def partial_aggregate(batch: PartitionBatch, group_cols: Sequence[str],
                      aggs: Sequence[AggSpec]) -> PartitionBatch:
    """Task-local aggregation: one output row per group in this partition."""
    n = batch.num_rows
    keys = [np.asarray(batch.col(g).arr) for g in group_cols]
    # string group keys: group locally on codes (cheap), the reduce side
    # unifies dictionaries — representative rows stay codes end to end.
    first, inverse = group_indices(keys) if group_cols else \
        (np.zeros(1, np.int64), np.zeros(n, np.int64))
    num_groups = len(first)

    out: Dict[str, ColumnVal] = _group_key_cols(batch, group_cols, first)

    distinct_specs = [a for a in aggs if a.func == AggFunc.COUNT_DISTINCT]
    plain_specs = [a for a in aggs if a.func != AggFunc.COUNT_DISTINCT]

    for spec in plain_specs:
        if spec.arg is not None:
            ctx = {name: batch.col(name) for name in batch.names()}
            val = np.asarray(evaluate(spec.arg, ctx).arr)
        else:
            val = None
        _partial_states(spec, inverse, val, num_groups, out)

    if distinct_specs:
        # Exact distinct: partial rows become per-(group, value) instead of
        # per-group.  Plain aggregates stay correct because their states are
        # additive across the finer grouping; the reduce side re-merges by
        # group and counts unique (group, value) pairs.
        if len(distinct_specs) > 1:
            raise NotImplementedError("multiple COUNT(DISTINCT) columns")
        spec = distinct_specs[0]
        ctx = {name: batch.col(name) for name in batch.names()}
        val = evaluate(spec.arg, ctx)
        pair_keys = keys + [np.asarray(val.arr)]
        pfirst, pinverse = group_indices(pair_keys)
        num_pairs = len(pfirst)
        out = _group_key_cols(batch, group_cols, pfirst)
        out[_state_cols(spec)[0]] = ColumnVal(
            np.asarray(val.arr)[pfirst], val.sdict, val.sorted_dict)
        for pspec in plain_specs:
            if pspec.arg is not None:
                pval = np.asarray(evaluate(pspec.arg, ctx).arr)
            else:
                pval = None
            _partial_states(pspec, pinverse, pval, num_pairs, out)

    return PartitionBatch(out)


def merge_aggregate(batch: PartitionBatch, group_cols: Sequence[str],
                    aggs: Sequence[AggSpec]) -> PartitionBatch:
    """Reduce-side final merge of partial states (one row per group) — the
    interpreted oracle for CompiledMerge."""
    keys = [np.asarray(batch.col(g).arr) for g in group_cols]
    n = batch.num_rows
    first, inverse = group_indices(keys) if group_cols else \
        (np.zeros(1, np.int64), np.zeros(n, np.int64))
    num_groups = len(first)

    out: Dict[str, ColumnVal] = _group_key_cols(batch, group_cols, first)

    for spec in aggs:
        if spec.func == AggFunc.COUNT_DISTINCT:
            vc = batch.col(_state_cols(spec)[0])
            pair_keys = keys + [np.asarray(vc.arr)]
            _, pair_inv = group_indices(pair_keys)
            # count unique (group, value) pairs per group
            uniq_pairs, pair_first = np.unique(pair_inv, return_index=True)
            grp_of_pair = inverse[pair_first]
            cnt = np.bincount(grp_of_pair, minlength=num_groups).astype(np.int64)
            out[spec.out_name] = ColumnVal(cnt)
            continue
        cols = _state_cols(spec)
        if spec.func == AggFunc.COUNT:
            v = np.asarray(batch.col(cols[0]).arr)
            out[spec.out_name] = ColumnVal(
                seg_sum(inverse, v, num_groups).astype(np.int64))
        elif spec.func == AggFunc.SUM:
            v = np.asarray(batch.col(cols[0]).arr)
            out[spec.out_name] = ColumnVal(seg_sum(inverse, v, num_groups))
        elif spec.func == AggFunc.AVG:
            s = np.bincount(inverse,
                            weights=np.asarray(batch.col(cols[0]).arr,
                                               dtype=np.float64),
                            minlength=num_groups)
            c = np.bincount(inverse,
                            weights=np.asarray(batch.col(cols[1]).arr,
                                               dtype=np.float64),
                            minlength=num_groups)
            out[spec.out_name] = ColumnVal(s / np.maximum(c, 1))
        elif spec.func in (AggFunc.MIN, AggFunc.MAX):
            v = np.asarray(batch.col(cols[0]).arr)
            out[spec.out_name] = ColumnVal(
                seg_minmax(inverse, v, num_groups,
                           spec.func == AggFunc.MIN))
        else:
            raise NotImplementedError(spec.func)
    return PartitionBatch(out)


# ---------------------------------------------------------------------------
# Compiled reduce-side merge (DESIGN.md §11).
#
# The grouping itself (np.unique over the, typically few, partial-state
# rows) stays host-side: its output shape is data-dependent.  Everything
# after it — every aggregate's segmented reduction — is ONE torch function
# over (inverse, state columns) on the session's device, cached
# process-wide per state signature.  Integer states reduce in int64
# (`index_add_` and `scatter_reduce` on int64 are exact above 2^53);
# MIN/MAX start from their identities with include_self=True, so an empty
# group keeps them.
# ---------------------------------------------------------------------------


_MERGE_FNS: Dict[Tuple, Callable] = {}
_MERGE_FNS_LOCK = threading.Lock()


def _merge_fn(sig: Tuple) -> Callable:
    with _MERGE_FNS_LOCK:
        fn = _MERGE_FNS.get(sig)
        if fn is not None:
            return fn
        import torch

        def merge(inv, cols, num_groups: int):
            dev = inv.device
            outs = []
            i = 0
            for kind, is_int in sig:
                if kind in ("count", "sum"):
                    dt = torch.int64 if is_int else torch.float64
                    acc = torch.zeros(num_groups, dtype=dt, device=dev)
                    acc.index_add_(0, inv, cols[i].to(dt))
                    i += 1
                    outs.append(acc)
                elif kind == "avg":
                    f64 = torch.float64
                    s = torch.zeros(num_groups, dtype=f64, device=dev)
                    s.index_add_(0, inv, cols[i].to(f64))
                    c = torch.zeros(num_groups, dtype=f64, device=dev)
                    c.index_add_(0, inv, cols[i + 1].to(f64))
                    i += 2
                    outs.append(s / torch.clamp(c, min=1.0))
                elif kind in ("min", "max"):
                    if is_int:
                        fill = (INT64_MIN_IDENT if kind == "min"
                                else INT64_MAX_IDENT)
                        dt = torch.int64
                    else:
                        fill = float("inf") if kind == "min" else float("-inf")
                        dt = torch.float64
                    acc = torch.full((num_groups,), fill, dtype=dt,
                                     device=dev)
                    acc = acc.scatter_reduce(
                        0, inv, cols[i].to(dt),
                        "amin" if kind == "min" else "amax",
                        include_self=True)
                    i += 1
                    outs.append(acc)
                else:
                    raise ValueError(kind)
            return tuple(outs)

        _MERGE_FNS[sig] = merge
        return merge


_KIND_OF = {AggFunc.COUNT: "count", AggFunc.SUM: "sum", AggFunc.AVG: "avg",
            AggFunc.MIN: "min", AggFunc.MAX: "max"}


class CompiledMerge:
    """`merge_aggregate` lowered to one torch function per reduce task on
    `device`.  Bit-exact with the oracle on integer states (int64 segment
    adds); float reductions agree to rounding (the card's atomics
    reorder them)."""

    def __init__(self, group_cols: Sequence[str], aggs: Sequence[AggSpec],
                 device="cpu"):
        if any(a.func == AggFunc.COUNT_DISTINCT for a in aggs):
            raise ExprCompileError(
                "COUNT(DISTINCT) merge is pair-regrouping, not a segmented "
                "reduce — interpreted path")
        self.group_cols = list(group_cols)
        self.aggs = list(aggs)
        self.device = device

    def _signature(self, batch: PartitionBatch) -> Tuple:
        sig = []
        for spec in self.aggs:
            kind = _KIND_OF[spec.func]
            state = np.asarray(batch.col(_state_cols(spec)[0]).arr)
            is_int = bool(np.issubdtype(state.dtype, np.integer))
            sig.append((kind, is_int))
        return tuple(sig)

    def __call__(self, batch: PartitionBatch) -> PartitionBatch:
        keys = [np.asarray(batch.col(g).arr) for g in self.group_cols]
        n = batch.num_rows
        first, inverse = group_indices(keys) if self.group_cols else \
            (np.zeros(1, np.int64), np.zeros(n, np.int64))
        num_groups = len(first)
        inv = to_tensor(np.asarray(inverse, np.int64), self.device)
        cols = tuple(to_tensor(batch.col(sc).arr, self.device)
                     for spec in self.aggs for sc in _state_cols(spec))

        fn = _merge_fn(self._signature(batch))
        outs = fn(inv, cols, num_groups)

        out = _group_key_cols(batch, self.group_cols, first)
        for spec, o in zip(self.aggs, outs):
            arr = o.cpu().numpy()
            if spec.func == AggFunc.COUNT:
                arr = arr.astype(np.int64)
            out[spec.out_name] = ColumnVal(arr)
        return PartitionBatch(out)


def merge_from_lanes(batch: PartitionBatch, group_cols: Sequence[str],
                     aggs: Sequence[AggSpec], first: np.ndarray,
                     lanes: Dict[str, np.ndarray]) -> PartitionBatch:
    """Assemble the final merge output from per-state-column (G, 4)
    [sum, count, min, max] lanes — the shape the `segmented_merge` kernel
    produces.  Lives here (next to merge_aggregate and
    CompiledMerge) so the per-AggFunc output policy has one home."""
    out = _group_key_cols(batch, group_cols, first)
    for spec in aggs:
        cols = _state_cols(spec)
        if spec.func == AggFunc.COUNT:
            out[spec.out_name] = ColumnVal(
                np.round(lanes[cols[0]][:, 0]).astype(np.int64))
        elif spec.func == AggFunc.SUM:
            out[spec.out_name] = ColumnVal(lanes[cols[0]][:, 0])
        elif spec.func == AggFunc.AVG:
            s = lanes[cols[0]][:, 0]
            c = lanes[cols[1]][:, 0]
            out[spec.out_name] = ColumnVal(s / np.maximum(c, 1.0))
        elif spec.func == AggFunc.MIN:
            out[spec.out_name] = ColumnVal(lanes[cols[0]][:, 2])
        elif spec.func == AggFunc.MAX:
            out[spec.out_name] = ColumnVal(lanes[cols[0]][:, 3])
        else:
            raise ExprCompileError(str(spec.func))
    return PartitionBatch(out)
