"""Run-time statistics for Partial DAG Execution (paper §3.1).

While map output materializes, each task gathers customizable statistics at
global and per-partition granularity through a pluggable accumulator API:

  1. partition sizes and record counts (skew detection),
  2. "heavy hitters" — frequently occurring keys,
  3. approximate histograms of the key distribution.

Workers send these to the master, which aggregates them and hands them to the
optimizer.  The paper bounds their size to 1–2 KB per task using lossy
compression: partition sizes are *logarithmically encoded*, representing up
to 32 GB in one byte with at most 10% error.  We reproduce that encoding
exactly (base such that 255 steps cover 32 GiB at ≤10% relative error) and
the accumulator API.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

# --------------------------------------------------------------------------
# Logarithmic size encoding: value -> one unsigned byte.
# With base b, code k represents b^k; max relative error is (b-1)/2 per
# rounding step.  b = 1.1 gives codes up to 1.1^255 ≈ 3.6e10 > 32 GiB with
# ≤10% error, exactly the paper's claim.
# --------------------------------------------------------------------------

LOG_BASE = 1.1


def encode_size(nbytes: int) -> int:
    """code k in 1..255 represents 1.1^(k-1) bytes; 0 means empty."""
    if nbytes <= 0:
        return 0
    code = int(round(math.log(nbytes, LOG_BASE))) + 1
    return max(1, min(255, code))


def decode_size(code: int) -> float:
    if code == 0:
        return 0.0
    return LOG_BASE ** (code - 1)


# --------------------------------------------------------------------------
# Pluggable accumulator API
# --------------------------------------------------------------------------


class Accumulator:
    """One statistic gathered while a map task materializes its output."""

    name: str = "accumulator"

    def update(self, bucket: int, batch) -> None:
        raise NotImplementedError

    def payload(self) -> Any:
        """Lossy-compressed bytes-bounded summary sent to the master."""
        raise NotImplementedError


class SizeAccumulator(Accumulator):
    """Per-output-bucket byte sizes + record counts (log-encoded)."""

    name = "sizes"

    def __init__(self, num_buckets: int):
        self.codes = np.zeros(num_buckets, np.uint8)
        self.records = np.zeros(num_buckets, np.int64)

    def update(self, bucket: int, batch) -> None:
        raw = decode_size(int(self.codes[bucket])) + batch.nbytes
        self.codes[bucket] = encode_size(int(raw))
        self.records[bucket] += batch.num_rows

    def payload(self):
        return {"codes": self.codes.copy(), "records": self.records.copy()}


class HeavyHitterAccumulator(Accumulator):
    """Misra–Gries top-k sketch over join/group keys (paper example 2)."""

    name = "heavy_hitters"

    def __init__(self, key_col: str, k: int = 64):
        self.key_col = key_col
        self.k = k
        self.counters: Dict[Any, int] = {}

    def update(self, bucket: int, batch) -> None:
        if self.key_col not in batch.cols:
            return
        v = batch.col(self.key_col)
        if v.is_string:
            # sketch on codes, decode only the (few) DISTINCT values — the
            # map side of the dictionary-preserving exchange never
            # materializes a string column row-wise
            codes, counts = np.unique(np.asarray(v.arr), return_counts=True)
            keys = v.sdict[codes]
        else:
            keys, counts = np.unique(np.asarray(v.arr), return_counts=True)
        for key, c in zip(keys.tolist(), counts.tolist()):
            if key in self.counters:
                self.counters[key] += c
            elif len(self.counters) < self.k:
                self.counters[key] = c
            else:
                dec = min(c, min(self.counters.values()))
                self.counters = {k2: v - dec for k2, v in self.counters.items()
                                 if v - dec > 0}
                if c - dec > 0:
                    self.counters[key] = c - dec

    def payload(self):
        return dict(sorted(self.counters.items(), key=lambda kv: -kv[1]))


class HistogramAccumulator(Accumulator):
    """Approximate equi-width histogram of a numeric key (paper example 3)."""

    name = "histogram"

    def __init__(self, key_col: str, lo: float, hi: float, bins: int = 64):
        self.key_col = key_col
        self.lo, self.hi, self.bins = lo, hi, bins
        self.counts = np.zeros(bins, np.int64)

    def update(self, bucket: int, batch) -> None:
        if self.key_col not in batch.cols:
            return
        v = np.asarray(batch.col(self.key_col).arr, dtype=np.float64)
        idx = np.clip(((v - self.lo) / max(self.hi - self.lo, 1e-12)
                       * self.bins).astype(np.int64), 0, self.bins - 1)
        np.add.at(self.counts, idx, 1)

    def payload(self):
        # lossy: log-encode bin counts to one byte each
        return np.array([encode_size(int(c)) for c in self.counts], np.uint8)


@dataclasses.dataclass
class TaskStats:
    """What one map task reports to the master (bounded to ~1–2 KB)."""
    task_id: int
    stage_id: int
    payloads: Dict[str, Any]

    def nbytes(self) -> int:
        total = 0
        for v in self.payloads.values():
            if isinstance(v, np.ndarray):
                total += v.nbytes
            elif isinstance(v, dict):
                total += sum(np.asarray(x).nbytes if isinstance(x, np.ndarray)
                             else 16 for x in v.values())
            else:
                total += 16
        return total


@dataclasses.dataclass
class StageStats:
    """Master-side aggregation of all TaskStats of a finished stage."""
    stage_id: int
    per_task: List[TaskStats] = dataclasses.field(default_factory=list)

    def add(self, ts: TaskStats) -> None:
        self.per_task.append(ts)

    # -- derived views used by the PDE optimizer ---------------------------

    def output_bytes_per_bucket(self, num_buckets: int) -> np.ndarray:
        """Decoded (approximate) bytes destined for each reduce bucket."""
        total = np.zeros(num_buckets, np.float64)
        for ts in self.per_task:
            p = ts.payloads.get("sizes")
            if p is None:
                continue
            total += np.array([decode_size(int(c)) for c in p["codes"]])
        return total

    def records_per_bucket(self, num_buckets: int) -> np.ndarray:
        total = np.zeros(num_buckets, np.int64)
        for ts in self.per_task:
            p = ts.payloads.get("sizes")
            if p is not None:
                total += p["records"]
        return total

    def total_output_bytes(self) -> float:
        total = 0.0
        for ts in self.per_task:
            p = ts.payloads.get("sizes")
            if p is not None:
                total += float(sum(decode_size(int(c)) for c in p["codes"]))
        return total

    def heavy_hitters(self, top: int = 16) -> Dict[Any, int]:
        merged: Dict[Any, int] = {}
        for ts in self.per_task:
            p = ts.payloads.get("heavy_hitters")
            if not p:
                continue
            for k, v in p.items():
                merged[k] = merged.get(k, 0) + v
        return dict(sorted(merged.items(), key=lambda kv: -kv[1])[:top])


# --------------------------------------------------------------------------
# Catalog / partition statistics for cost-based join ordering.
#
# The paper's PDE re-plans from *observed* statistics at run time; the
# initial join order, however, must be chosen before anything has executed.
# These estimators derive that prior from what the columnar store already
# piggybacks on load (§3.3, §3.5): per-partition row counts, byte sizes,
# min/max ranges, and small distinct-value sets.
# --------------------------------------------------------------------------


def predicate_selectivity(pred) -> float:
    """System-R-style selectivity heuristic for a filter predicate.

    Used only to *rank* candidate join orders, so coarse class-based factors
    are enough; PDE corrects any misestimate at the shuffle boundary."""
    from .expr import (And, Between, Cmp, Expr, InList, Not, Or)
    if pred is None:
        return 1.0
    if isinstance(pred, And):
        return predicate_selectivity(pred.left) * predicate_selectivity(pred.right)
    if isinstance(pred, Or):
        s = (predicate_selectivity(pred.left)
             + predicate_selectivity(pred.right))
        return min(1.0, s)
    if isinstance(pred, Not):
        return max(0.05, 1.0 - predicate_selectivity(pred.child))
    if isinstance(pred, Cmp):
        return 0.1 if pred.op == "=" else (0.9 if pred.op == "!=" else 0.33)
    if isinstance(pred, Between):
        return 0.25
    if isinstance(pred, InList):
        return min(1.0, 0.05 * max(len(pred.values), 1))
    return 0.5


def table_column_ndv(table, col: str) -> Optional[int]:
    """Number of distinct values of `col`, from the per-partition distinct
    sets piggybacked on loading — exact when every partition kept its set
    (enum-ish columns), else None (caller falls back to row count)."""
    union: set = set()
    for p in table.partitions:
        block = p.columns.get(col)
        if block is None or block.stats.distinct is None:
            return None
        union.update(block.stats.distinct)
    return len(union) if union else None


def block_ndv(block) -> Optional[int]:
    """Distinct-value count of one partition's column block, from what the
    store already holds: the string dictionary, the DICT-encoding
    dictionary, or the piggybacked distinct set (§3.3).  None when unknown
    — the caller (compiled-segment backend selection) then avoids the
    one-hot-matmul group-by, whose tile width scales with NDV."""
    sd = getattr(block, "str_dict", None)
    if sd is not None:
        return len(sd)
    enc = getattr(block, "enc", None)
    if enc is not None and getattr(enc, "dictionary", None) is not None:
        return len(enc.dictionary)
    stats = getattr(block, "stats", None)
    if stats is not None and stats.distinct is not None:
        return len(stats.distinct)
    return None


def surviving_partition_fraction(table, pred) -> float:
    """Fraction of partitions whose piggybacked stats could satisfy `pred`
    (the same refutation test map pruning uses, §3.5) — a second, data-aware
    selectivity signal for the join-order prior."""
    from .pruning import may_match
    total = table.num_partitions
    if total == 0:
        return 1.0
    kept = sum(1 for p in table.partitions if may_match(pred, p.stats()))
    return kept / total


@dataclasses.dataclass
class RelEstimate:
    """Pre-execution size estimate of one relation (a join input subtree)."""
    rows: float
    nbytes: float
    # table backing a bare scan (for NDV lookups / co-partition checks);
    # None once the subtree contains anything but Scan/Filter/Project
    table: Optional[Any] = None

    @property
    def bytes_per_row(self) -> float:
        return self.nbytes / self.rows if self.rows > 0 else 0.0


# --------------------------------------------------------------------------
# Greedy bin-packing used for reducer coalescing / skew mitigation (§3.1.2)
# --------------------------------------------------------------------------


def greedy_bin_pack(sizes: Sequence[float], num_bins: int) -> List[List[int]]:
    """Assign fine-grained partitions to `num_bins` coalesced partitions,
    equalizing bin totals: sort descending, place each into the lightest bin."""
    order = np.argsort(-np.asarray(sizes, dtype=np.float64))
    bins: List[List[int]] = [[] for _ in range(num_bins)]
    loads = np.zeros(num_bins, np.float64)
    for i in order.tolist():
        b = int(np.argmin(loads))
        bins[b].append(i)
        loads[b] += sizes[i]
    return bins


def choose_num_reducers(bucket_bytes: np.ndarray,
                        target_bytes_per_reducer: float = 64 << 20,
                        min_reducers: int = 1,
                        max_reducers: int = 4096) -> int:
    total = float(bucket_bytes.sum())
    n = int(math.ceil(total / max(target_bytes_per_reducer, 1.0)))
    return max(min_reducers, min(max_reducers, n))
