"""Columnar memory store (paper §3.2, §3.3, §3.5).

A cached table is a list of `Partition`s; each partition stores one
`ColumnBlock` per column: a single contiguous array per column (the paper's
"each column creates only one JVM object"), compressed per-partition, plus
piggybacked statistics collected during the load task:

  * min / max range of each column,
  * the distinct-value set when small (enum columns),
  * row count and encoded byte size.

These stats flow back to the master and drive *map pruning*: the master never
launches scan tasks for partitions whose stats refute the query predicate.

String columns are dictionary-encoded at load; the engine computes on int32
codes and only materializes strings at the result boundary.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from .compression import (DECODE_MEMO_CHANGES, Encoded, Encoding,
                          decode_np, device_stream, encode, recompress)
from .types import DType, Field, Schema

ENUM_DISTINCT_LIMIT = 64  # paper: keep distinct values "if the number is small"


@dataclasses.dataclass
class ColumnStats:
    """Per-partition, per-column statistics piggybacked on data loading."""
    min: Optional[float] = None
    max: Optional[float] = None
    distinct: Optional[frozenset] = None   # only when |distinct| small
    count: int = 0
    nbytes: int = 0
    null_count: int = 0

    def may_satisfy_range(self, lo: Optional[float], hi: Optional[float]) -> bool:
        """Could any row of this partition fall inside [lo, hi]?"""
        if self.count == 0:
            return False
        if lo is not None and self.max is not None and self.max < lo:
            return False
        if hi is not None and self.min is not None and self.min > hi:
            return False
        return True

    def may_contain(self, value) -> bool:
        if self.distinct is not None:
            return value in self.distinct
        return self.may_satisfy_range(value, value)


@dataclasses.dataclass
class ColumnBlock:
    field: Field
    enc: Encoded
    stats: ColumnStats
    # For STRING columns: the partition-local string dictionary; values()
    # returns int32 codes into it.
    str_dict: Optional[np.ndarray] = None

    def values(self) -> np.ndarray:
        """Raw stored values (int32 dictionary codes for STRING columns)."""
        return decode_np(self.enc)

    @property
    def encoding(self) -> Encoding:
        return self.enc.encoding

    def code_space(self):
        """Encoded-aware access for the compiled execution path: when this
        block's *stored values* are DICT-encoded, return (codes, sorted
        dictionary) so predicates can be evaluated on int32 codes without
        decoding — `np.unique` dictionaries are sorted and unique, so code
        order is value order and range/equality predicates translate to
        code-bound compares.  Returns None for other encodings (their
        streams are not order-preserving code streams) and for float
        dictionaries containing NaN: np.unique sorts NaN to the tail, so a
        code-bound `>=` would include NaN rows that every value-space
        comparison excludes."""
        if self.enc.encoding != Encoding.DICT:
            return None
        d = self.enc.dictionary
        if d.dtype.kind == "f" and len(d) and np.isnan(d[-1]):
            return None
        return self.enc.codes, d

    def frame_space(self):
        """Encoded-aware access for frame-of-reference blocks: (codes, bias)
        where `value = code + bias` exactly (integer columns only), so the
        code stream is order-preserving and range/equality predicates
        translate to code-bound compares on the narrow resident lane —
        the FOR twin of `code_space()` (DESIGN.md §12).  None for every
        other encoding."""
        enc = self.enc
        if enc.encoding != Encoding.FOR or self.str_dict is not None:
            return None
        return enc.codes, enc.bias

    def run_space(self):
        """Encoded-aware access for RLE blocks: (run_values, run_lengths) in
        stored-value space, for run-level predicate/aggregate evaluation
        without expanding the runs.  None for every other encoding."""
        enc = self.enc
        if enc.encoding != Encoding.RLE:
            return None
        return enc.run_values, enc.run_lengths

    def pack_space(self):
        """Encoded-aware access for bit-packed blocks:
        (words, bit_width, bias, n) where the uint32 words hold
        `value - bias` lanes at `bit_width` bits.  Like FOR, the biased code
        stream is order-preserving, so range/equality predicates translate
        to code bounds host-side and the scan unpacks + compares the narrow
        lanes without ever widening to the logical dtype — the BITPACK twin
        of `frame_space()` (DESIGN.md §12).  None for every other encoding
        and for dictionary-string blocks (their code order is dictionary
        order, not value order of the packed lane)."""
        enc = self.enc
        if enc.encoding != Encoding.BITPACK or self.str_dict is not None:
            return None
        return enc.words, enc.bit_width, enc.bias, enc.n

    def device_array(self, what: str, device):
        """This block's `what` as a torch tensor on `device`, copied there
        once and memoized on the encoded block, so repeated queries and
        training steps read it from device memory instead of over PCIe.
        `what` is "values" (the stored values), "group_codes" (the int32
        ids of `group_space()`), or an encoded stream of
        `compression.device_stream`: "codes", "dictionary", "words",
        "run_values" or "run_ends" (uint32 words cross as int32 bits, run
        lengths as int32 cumulative ends).  On the CPU the tensor shares the numpy array's
        memory."""
        import torch
        if what == "values" and self.enc.encoding == Encoding.PLAIN:
            what = "data"            # one device copy of a PLAIN block
        if what not in ("values", "group_codes"):
            return device_stream(self.enc, what, device)
        key = (what, str(device))
        memo = self.enc._device
        t = memo.get(key)
        if t is None:
            arr = (self.values() if what == "values"
                   else self.group_space()[1])
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
            if not self.enc._cold:
                memo[key] = t
        return t

    def group_space(self):
        """(distinct values, int32 group id per row) of the stored values —
        `np.unique(values, return_inverse=True)`, memoized on the encoded
        block with the host decode."""
        hit = self.enc._group_space
        if hit is None:
            reps, inv = np.unique(self.values(), return_inverse=True)
            hit = (reps, inv.astype(np.int32))
            self.enc._group_space = hit
        return hit

    def recompress(self) -> int:
        """Adaptive WARM-tier recompression (pressure hook): re-encode with
        the scheme `choose_recompression` picks from run-length/span/NDV
        signals; keeps the block only if strictly smaller.  Returns bytes
        freed (encoded delta plus any decoded cache released).  A block
        already its own recompression is not decoded again: the memory
        manager's WARM pass visits every resident block on each pass."""
        old = self.enc
        pre_decoded = old.decoded_nbytes
        new = old if old._settled else recompress(old)
        old.drop_decoded()
        new.drop_decoded()
        freed = pre_decoded
        if new is old:
            old._settled = True
        else:
            # the device copies are of the old encoding's streams
            old.drop_device()
            freed += old.nbytes - new.nbytes
            self.enc = new
            self.stats.nbytes = new.nbytes
        return freed

    def drop_decoded(self) -> int:
        return self.enc.drop_decoded()

    def drop_device(self) -> None:
        self.enc.drop_device()

    def decoded(self) -> np.ndarray:
        """Logical values: maps codes through the partition-local string
        dictionary.  Used at shuffle/join/result boundaries where values must
        compare consistently across partitions."""
        v = decode_np(self.enc)
        if self.str_dict is not None:
            return self.str_dict[v]
        return v

    @property
    def n(self) -> int:
        return self.enc.n

    @property
    def nbytes(self) -> int:
        base = self.enc.nbytes
        if self.str_dict is not None:
            base += self.str_dict.nbytes
        return base


def _make_stats(values: np.ndarray, nbytes: int,
                logical: Optional[np.ndarray] = None) -> ColumnStats:
    n = len(values)
    if n == 0:
        return ColumnStats(count=0, nbytes=nbytes)
    src = logical if logical is not None else values
    uniq = np.unique(src[: 65536])
    distinct = frozenset(uniq.tolist()) if len(uniq) <= ENUM_DISTINCT_LIMIT else None
    if src.dtype.kind in ("U", "S", "O"):
        # string column: range stats are lexicographic on the logical values
        return ColumnStats(min=None, max=None, distinct=distinct, count=n,
                           nbytes=nbytes)
    return ColumnStats(
        min=float(src.min()), max=float(src.max()),
        distinct=distinct, count=n, nbytes=nbytes)


def make_block(field: Field, values: np.ndarray,
               encoding: Optional[Encoding] = None) -> ColumnBlock:
    """One data-loading task's work for one column: marshal to columnar form,
    pick a compression scheme locally, collect stats (paper §3.3, §3.5)."""
    str_dict = None
    logical = None
    if field.dtype == DType.STRING and values.dtype.kind in ("U", "S", "O"):
        logical = np.asarray(values, dtype=np.str_)
        str_dict, codes = np.unique(logical, return_inverse=True)
        values = codes.astype(np.int32)
    values = np.asarray(values, dtype=field.dtype.np_dtype)
    enc = encode(values, encoding)
    return ColumnBlock(field, enc, _make_stats(values, enc.nbytes, logical),
                       str_dict)


# Monotonic access clock for the storage tier's coldest-first spill policy
# (DESIGN.md §12): the scan path stamps partitions on every read.
_ACCESS_CLOCK = itertools.count(1)


class Partition:
    """One horizontal slice of a table, held in the memory store.

    Storage-tier states (DESIGN.md §12): a partition is *resident* (HOT with
    decoded caches, WARM once recompressed/caches dropped) or *cold* — its
    column blocks spilled to disk (or dropped outright) by the server's
    StorageManager under memory pressure.  `columns` faults a cold partition
    back in transparently: spill-file read first, recompute-from-lineage on
    a lost or corrupt file.  Stats are snapshotted at build time so map
    pruning and byte accounting never fault a cold partition."""

    def __init__(self, index: int, columns: Dict[str, ColumnBlock]):
        self.index = index
        self._columns: Optional[Dict[str, ColumnBlock]] = columns
        self._stats = {n: b.stats for n, b in columns.items()}
        self._num_rows = next(iter(columns.values())).n if columns else 0
        self.last_access = 0        # _ACCESS_CLOCK stamp (0 = never scanned)
        # cold-tier bookkeeping, owned by storage.StorageManager
        self.spill_ref = None       # storage.SpillRef while cold-on-disk
        self.storage = None         # StorageManager once it ever evicted us
        self.lineage: Optional[Callable[[], Dict[str, ColumnBlock]]] = None

    # -- tier state -----------------------------------------------------------

    @property
    def resident(self) -> bool:
        return self._columns is not None

    @property
    def columns(self) -> Dict[str, ColumnBlock]:
        if self._columns is None:
            self.storage.fault_in(self)
        return self._columns

    def touch(self) -> None:
        self.last_access = next(_ACCESS_CLOCK)

    def release_columns(self) -> int:
        """Go cold: drop the resident column blocks (the StorageManager has
        already serialized them if this is a spill, not a drop).  Returns
        resident bytes freed (encoded + decoded caches).  The blocks'
        device copies go with them, and are never memoized again: a cached
        scan batch may hold the blocks on, but the card holds nothing of a
        cold partition."""
        if self._columns is None:
            return 0
        memo = sum(b.enc.decoded_nbytes for b in self._columns.values())
        freed = memo + sum(b.nbytes for b in self._columns.values())
        for b in self._columns.values():
            b.enc._cold = True
            b.drop_device()
        self._columns = None
        if memo:
            # the decode memos left the catalog's sum with the blocks
            DECODE_MEMO_CHANGES[0] += 1
        return freed

    def restore_columns(self, columns: Dict[str, ColumnBlock]) -> None:
        self._columns = columns
        self._stats = {n: b.stats for n, b in columns.items()}
        if any(b.enc.decoded_nbytes for b in columns.values()):
            DECODE_MEMO_CHANGES[0] += 1

    # -- sizes / stats (never fault) -----------------------------------------

    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def nbytes(self) -> int:
        """Logical encoded size: the last known resident footprint while
        cold (size hints must not fault a spilled partition back in)."""
        if self._columns is None:
            return sum(s.nbytes for s in self._stats.values())
        return sum(b.nbytes for b in self._columns.values())

    @property
    def resident_nbytes(self) -> int:
        """Encoded bytes actually held in memory (0 while cold)."""
        if self._columns is None:
            return 0
        return sum(b.nbytes for b in self._columns.values())

    def column(self, name: str) -> ColumnBlock:
        return self.columns[name]

    def drop_decoded(self) -> int:
        """Release all memoized decode caches in this partition."""
        if self._columns is None:
            return 0
        return sum(b.drop_decoded() for b in self._columns.values())

    def drop_device(self) -> None:
        """Release all memoized device copies in this partition."""
        for b in (self._columns or {}).values():
            b.drop_device()

    def recompress(self) -> int:
        """WARM transition: adaptively recompress every resident block;
        returns bytes freed."""
        if self._columns is None:
            return 0
        return sum(b.recompress() for b in self._columns.values())

    @property
    def decoded_cache_nbytes(self) -> int:
        if self._columns is None:
            return 0
        return sum(b.enc.decoded_nbytes for b in self._columns.values())

    def arrays(self, names: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
        cols = self.columns
        names = names if names is not None else list(cols)
        return {n: cols[n].values() for n in names}

    def decoded_arrays(self, names: Optional[Sequence[str]] = None
                       ) -> Dict[str, np.ndarray]:
        cols = self.columns
        names = names if names is not None else list(cols)
        return {n: cols[n].decoded() for n in names}

    def stats(self) -> Dict[str, ColumnStats]:
        return dict(self._stats)


def build_partition(index: int, schema: Schema,
                    data: Dict[str, np.ndarray]) -> Partition:
    cols = {f.name: make_block(f, data[f.name]) for f in schema.fields}
    ns = {b.n for b in cols.values()}
    assert len(ns) <= 1, f"ragged partition: {ns}"
    return Partition(index, cols)


@dataclasses.dataclass
class Table:
    """A cached, partitioned, columnar table (shark.cache=true semantics)."""
    name: str
    schema: Schema
    partitions: List[Partition]
    # Co-partitioning metadata (§3.4): set when the table was DISTRIBUTE'd BY
    # a key; two tables sharing (key-column, num_partitions) join shuffle-free.
    distribute_key: Optional[str] = None
    # Vector analytics metadata (DESIGN.md §15.3): embedding name -> its
    # fixed-width float lane columns ("emb" -> ["emb_0", "emb_1", ...]).
    # Lanes are ordinary FLOAT32 columns — they prune, compress, and project
    # like any other — the mapping just lets `similarity_join` resolve a
    # logical vector column back to its lanes.
    embeddings: Dict[str, List[str]] = dataclasses.field(default_factory=dict)

    @property
    def num_rows(self) -> int:
        return sum(p.num_rows for p in self.partitions)

    @property
    def num_partitions(self) -> int:
        return len(self.partitions)

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.partitions)

    def drop_decoded(self) -> int:
        """Release every partition's memoized decode cache (MemoryManager
        pressure hook): bytes freed."""
        return sum(p.drop_decoded() for p in self.partitions)

    def drop_device(self) -> None:
        """Release every partition's memoized device copies (the table left
        the catalog, or its server shut down)."""
        for p in self.partitions:
            p.drop_device()

    @property
    def decoded_cache_nbytes(self) -> int:
        return sum(p.decoded_cache_nbytes for p in self.partitions)

    @property
    def resident_nbytes(self) -> int:
        """Encoded bytes currently held in memory (cold partitions count 0)."""
        return sum(p.resident_nbytes for p in self.partitions)

    def column_np(self, name: str) -> np.ndarray:
        """Materialize a full column, logically decoded (testing / results)."""
        parts = [p.columns[name].decoded() for p in self.partitions]
        return np.concatenate(parts) if parts else np.zeros(0)

    def to_dict(self) -> Dict[str, np.ndarray]:
        return {n: self.column_np(n) for n in self.schema.names}

    def co_partitioned_with(self, other: "Table", key_self: str,
                            key_other: str) -> bool:
        return (self.distribute_key == key_self
                and other.distribute_key == key_other
                and self.num_partitions == other.num_partitions
                and self.num_partitions > 0)


def hash_key_values(values: np.ndarray) -> np.ndarray:
    """Deterministic int64 hash of key values, identical across the whole
    engine so DISTRIBUTE BY tables and shuffle buckets align (§3.4).
    Strings hash via crc32 of each *distinct* value (vectorized through the
    dictionary); numerics hash by value."""
    import zlib
    v = np.asarray(values)
    if v.dtype.kind in ("U", "S", "O"):
        uniq, inv = np.unique(v.astype(np.str_), return_inverse=True)
        hd = np.array([zlib.crc32(s.encode()) for s in uniq.tolist()],
                      dtype=np.int64)
        return hd[inv]
    if v.dtype.kind == "f":
        return v.astype(np.int64)
    return v.astype(np.int64)


def hash_partition_arrays(key: np.ndarray, num_partitions: int) -> np.ndarray:
    """Deterministic hash partitioning used by DISTRIBUTE BY and shuffles.

    Must be identical everywhere so co-partitioned tables align (§3.4)."""
    k = hash_key_values(key)
    h = k.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    h ^= h >> np.uint64(29)
    return (h % np.uint64(num_partitions)).astype(np.int32)


def from_arrays(name: str, schema: Schema, data: Dict[str, np.ndarray],
                num_partitions: int = 8,
                distribute_by: Optional[str] = None) -> Table:
    """Distributed data loading (§3.3): split rows into partitions, each
    'load task' builds its columnar blocks independently.

    Embedding columns (DESIGN.md §15.3): a data key that is NOT in the
    schema and holds a 2-D float array `(rows, width)` is an embedding —
    it explodes into `width` FLOAT32 lane columns `{key}_{i}` appended to
    the schema, and the lane mapping is recorded on `Table.embeddings` so
    `similarity_join` can resolve the vector back to its lanes."""
    n = len(next(iter(data.values()))) if data else 0
    embeddings: Dict[str, List[str]] = {}
    schema_names = set(schema.names)
    extra_fields: List[Field] = []
    for key in list(data):
        if key in schema_names:
            continue
        v = np.asarray(data[key])
        if v.ndim != 2:
            continue        # non-schema 1-D keys stay ignored (legacy)
        lanes = [f"{key}_{i}" for i in range(v.shape[1])]
        clash = [l for l in lanes if l in schema_names or l in data]
        if clash:
            raise ValueError(
                f"from_arrays: embedding {key!r} lane column(s) "
                f"{clash} collide with existing columns")
        for i, lane in enumerate(lanes):
            data[lane] = np.ascontiguousarray(v[:, i], dtype=np.float32)
            extra_fields.append(Field(lane, DType.FLOAT32))
        embeddings[key] = lanes
        del data[key]
    if extra_fields:
        schema = Schema(schema.fields + tuple(extra_fields))
    # STRING columns: encode to global codes first so DISTRIBUTE BY and joins
    # on strings hash consistently across partitions.
    norm: Dict[str, np.ndarray] = {}
    for f in schema.fields:
        v = np.asarray(data[f.name])
        norm[f.name] = v
    if distribute_by is not None:
        keyv = norm[distribute_by]
        pids = hash_partition_arrays(np.asarray(keyv), num_partitions)
        order = np.argsort(pids, kind="stable")
        bounds = np.searchsorted(pids[order], np.arange(num_partitions + 1))
        parts = []
        for i in range(num_partitions):
            sel = order[bounds[i]: bounds[i + 1]]
            parts.append(build_partition(
                i, schema, {k: v[sel] for k, v in norm.items()}))
        return Table(name, schema, parts, distribute_key=distribute_by,
                     embeddings=embeddings)
    # round-robin contiguous split
    edges = np.linspace(0, n, num_partitions + 1, dtype=np.int64)
    parts = []
    for i in range(num_partitions):
        lo, hi = int(edges[i]), int(edges[i + 1])
        parts.append(build_partition(
            i, schema, {k: v[lo:hi] for k, v in norm.items()}))
    return Table(name, schema, parts, embeddings=embeddings)


def table_from_encoded(name: str, schema_fields: Sequence, partitions:
                       Sequence[Dict[str, dict]],
                       distribute_key: Optional[str] = None,
                       embeddings: Optional[Dict[str, List[str]]] = None
                       ) -> Table:
    """Build a Table from another engine's per-partition encoded blocks, so
    both scan byte-identical data.

    `schema_fields` is a sequence of (column name, DType value string).
    Each partition maps column name -> plain attributes of its encoded
    block: "encoding" (Encoding value string), any of "data", "codes",
    "dictionary", "run_values", "run_lengths", "words" (numpy arrays),
    "bit_width", "bias", "n", "orig_dtype", and "str_dict" (the
    partition's string dictionary, STRING columns only).  Statistics are
    recomputed from the decoded values exactly as a load task computes
    them."""
    schema = Schema(tuple(Field(n, DType(d)) for n, d in schema_fields))
    parts: List[Partition] = []
    for i, cols in enumerate(partitions):
        blocks: Dict[str, ColumnBlock] = {}
        for f in schema.fields:
            a = dict(cols[f.name])
            arrays = {k: (None if a.get(k) is None else np.asarray(a[k]))
                      for k in ("data", "codes", "dictionary", "run_values",
                                "run_lengths", "words")}
            enc = Encoded(Encoding(a["encoding"]), **arrays,
                          bit_width=int(a.get("bit_width", 0)),
                          bias=int(a.get("bias", 0)), n=int(a["n"]),
                          orig_dtype=np.dtype(a["orig_dtype"]))
            str_dict = a.get("str_dict")
            values = decode_np(enc)
            logical = None
            if str_dict is not None:
                str_dict = np.asarray(str_dict)
                logical = str_dict[values]
            blocks[f.name] = ColumnBlock(
                f, enc, _make_stats(values, enc.nbytes, logical), str_dict)
        parts.append(Partition(i, blocks))
    return Table(name, schema, parts, distribute_key=distribute_key,
                 embeddings=dict(embeddings or {}))
