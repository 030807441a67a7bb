"""PartitionBatch: the unit of data flowing between physical operators.

One batch = one partition's columns.  Numeric columns are arrays; string
columns stay dictionary-encoded (codes + partition-local dictionary) end to
end — including ACROSS shuffles (DESIGN.md §11): a shuffle block ships each
string column as (codes, partition-local dictionary), and the reduce side
unifies the per-piece dictionaries with a vectorized merge-remap
(`merge_string_dicts`) instead of decoding rows.  The engine only
materializes strings at result collection.  This mirrors Shark's columnar
store, where a block of tuples is a single object and per-row
materialization never happens.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

import time as _time

from .columnar import Partition
from .expr import ColumnVal
from .types import DType, Schema

# Wall-clock spent on the exchange path, summed across worker threads
# (plain dict adds under the GIL — diagnostics, not exact accounting):
#   hash     — shuffle key hashing / join-key materialization,
#   decode   — map-side raw-string materialization (legacy exchange only),
#   assemble — reduce-side piece assembly (concat + dictionary unification).
# benchmarks/shuffle_bench.py resets and reads these to price the exchange
# separately from the (shared) scan/aggregate work around it.
EXCHANGE_TIMERS = {"hash": 0.0, "decode": 0.0, "assemble": 0.0}


def reset_exchange_timers() -> None:
    for k in EXCHANGE_TIMERS:
        EXCHANGE_TIMERS[k] = 0.0


def merge_string_dicts(dicts: Sequence[np.ndarray]
                       ) -> "tuple[np.ndarray, List[np.ndarray]]":
    """Unify several partition-local string dictionaries into one sorted,
    unique dictionary plus a per-input code remap — the reduce-side half of
    the dictionary-preserving exchange.  Vectorized over the (small)
    dictionaries only; row data is never touched.  Input dictionaries may be
    unsorted and may contain duplicates (string-function transforms);
    `searchsorted` maps every entry by value, so the remapped codes are
    always codes into the sorted unified dictionary."""
    if len(dicts) == 1:
        d = dicts[0]
        if len(d) <= 1 or bool(np.all(d[:-1] < d[1:])):
            return d, [np.arange(len(d), dtype=np.int32)]
    unified = np.unique(np.concatenate(dicts)) if dicts \
        else np.zeros(0, np.str_)
    remaps = [np.searchsorted(unified, d).astype(np.int32) for d in dicts]
    return unified, remaps


@dataclasses.dataclass
class PartitionBatch:
    cols: Dict[str, ColumnVal]

    @property
    def num_rows(self) -> int:
        if not self.cols:
            return 0
        v = next(iter(self.cols.values()))
        if not v.materialized and v.block is not None:
            return v.block.n
        return int(np.asarray(v.arr).shape[0])

    @property
    def nbytes(self) -> int:
        total = 0
        for v in self.cols.values():
            if not v.materialized and v.block is not None:
                # still encoded in the column store: account encoded bytes
                # rather than forcing a decode just to size the batch
                total += v.block.nbytes
                continue
            total += np.asarray(v.arr).nbytes
            if v.sdict is not None:
                total += v.sdict.nbytes
        return total

    def names(self) -> List[str]:
        return list(self.cols)

    def col(self, name: str) -> ColumnVal:
        return self.cols[name]

    def mask(self, m: np.ndarray) -> "PartitionBatch":
        m = np.asarray(m)
        return PartitionBatch({
            n: ColumnVal(np.asarray(v.arr)[m], v.sdict, v.sorted_dict)
            for n, v in self.cols.items()})

    def take(self, idx: np.ndarray) -> "PartitionBatch":
        return PartitionBatch({
            n: ColumnVal(np.asarray(v.arr)[idx], v.sdict, v.sorted_dict)
            for n, v in self.cols.items()})

    def head(self, n: int) -> "PartitionBatch":
        return PartitionBatch({
            k: ColumnVal(np.asarray(v.arr)[:n], v.sdict, v.sorted_dict)
            for k, v in self.cols.items()})

    def select(self, names: Sequence[str]) -> "PartitionBatch":
        return PartitionBatch({n: self.cols[n] for n in names})

    def with_col(self, name: str, v: ColumnVal) -> "PartitionBatch":
        d = dict(self.cols)
        d[name] = v
        return PartitionBatch(d)

    def rename(self, mapping: Dict[str, str]) -> "PartitionBatch":
        return PartitionBatch({mapping.get(n, n): v for n, v in self.cols.items()})

    def decoded(self) -> Dict[str, np.ndarray]:
        """Materialize logical values (strings decoded)."""
        return {n: v.decoded() for n, v in self.cols.items()}

    def decode_strings(self) -> "PartitionBatch":
        """Replace dictionary-coded strings with raw string arrays — the
        LEGACY exchange's map-side step (exchange="decoded"); the
        dictionary-preserving exchange never calls this."""
        t0 = _time.perf_counter()
        out = {}
        for n, v in self.cols.items():
            if v.is_string:
                out[n] = ColumnVal(v.decoded(), None)
            else:
                out[n] = v
        EXCHANGE_TIMERS["decode"] += _time.perf_counter() - t0
        return PartitionBatch(out)

    @staticmethod
    def from_partition(p: Partition, columns: Optional[Sequence[str]] = None
                       ) -> "PartitionBatch":
        """Block-backed batch: columns stay encoded until something reads
        `.arr` (memoized decode) — the compiled segment executor evaluates
        predicates on dictionary codes and may never materialize them."""
        names = list(columns) if columns is not None else list(p.columns)
        out = {}
        for n in names:
            b = p.columns[n]
            out[n] = ColumnVal(None, b.str_dict, True, block=b)
        return PartitionBatch(out)

    @staticmethod
    def from_numpy(d: Dict[str, np.ndarray]) -> "PartitionBatch":
        out = {}
        for n, v in d.items():
            v = np.asarray(v)
            if v.dtype.kind in ("U", "S", "O"):
                out[n] = ColumnVal(v.astype(np.str_), None)
                # raw string array: represent as codes over itself lazily
                sdict, codes = np.unique(v.astype(np.str_), return_inverse=True)
                out[n] = ColumnVal(codes.astype(np.int32), sdict, True)
            else:
                out[n] = ColumnVal(v, None)
        return PartitionBatch(out)

    @staticmethod
    def concat(batches: Sequence["PartitionBatch"]) -> "PartitionBatch":
        """Merge fetched shuffle pieces into one reduce input.

        Row offsets are computed once and every column is assembled into a
        single preallocated output array (one copy per piece, no
        intermediate concatenations).  String columns stay dictionary
        codes: the per-piece dictionaries are unified with a vectorized
        merge-remap (`merge_string_dicts`) — rows are never decoded, which
        is what keeps the exchange decode-free end to end."""
        batches = [b for b in batches if b is not None]
        if not batches:
            return PartitionBatch({})
        if len(batches) == 1 and all(
                (not v.is_string) or v.sorted_dict
                for v in batches[0].cols.values()):
            # single piece with order-preserving dictionaries: nothing to
            # unify (a lone unsorted-dict column still needs the remap below
            # so downstream code-space grouping sees one code per value)
            return batches[0]
        t0 = _time.perf_counter()
        names = batches[0].names()
        sizes = [b.num_rows for b in batches]
        total = int(sum(sizes))
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        out: Dict[str, ColumnVal] = {}
        for n in names:
            vals = [b.cols[n] for b in batches]
            if all(v.is_string for v in vals):
                # compact each piece's dictionary to the codes it actually
                # references first: a shuffle bucket keeps its map
                # partition's FULL dictionary, so merging uncompacted dicts
                # would redo |dict| work per bucket instead of per row
                sdicts, code_arrays = [], []
                for v in vals:
                    codes = np.asarray(v.arr)
                    nd = len(v.sdict)
                    used = np.zeros(nd, bool)
                    used[codes] = True
                    if used.all():
                        sdicts.append(v.sdict)
                        code_arrays.append(codes)
                    else:
                        new_of_old = np.cumsum(used) - 1
                        sdicts.append(v.sdict[used])
                        code_arrays.append(
                            new_of_old[codes].astype(np.int32))
                sdict, remaps = merge_string_dicts(sdicts)
                codes = np.empty(total, np.int32)
                for c, remap, lo, hi in zip(code_arrays, remaps, offsets,
                                            offsets[1:]):
                    codes[lo:hi] = remap[c]
                out[n] = ColumnVal(codes, sdict, True)
            elif any(v.is_string for v in vals):
                # mixed coded/raw pieces (legacy decoded-exchange blocks):
                # fall back to decode + re-encode to a fresh dictionary
                raw = np.concatenate([v.decoded() for v in vals])
                sdict, codes = np.unique(raw, return_inverse=True)
                out[n] = ColumnVal(codes.astype(np.int32), sdict, True)
            else:
                arrs = [np.asarray(v.arr) for v in vals]
                dt = np.result_type(*arrs)
                merged = np.empty(total, dt)
                for a, lo, hi in zip(arrs, offsets, offsets[1:]):
                    merged[lo:hi] = a
                out[n] = ColumnVal(merged)
        EXCHANGE_TIMERS["assemble"] += _time.perf_counter() - t0
        return PartitionBatch(out)

    @staticmethod
    def empty_like(b: "PartitionBatch") -> "PartitionBatch":
        return b.head(0)
