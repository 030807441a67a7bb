"""Out-of-core storage tier: spill-to-disk with adaptive recompression
(DESIGN.md §12), the port of `repro.core.storage`.

Shark's memory store is a *cache* over recomputable data (paper §3.2); the
only pressure valve the server had was LRU eviction + recompute-from-lineage,
which thrashes once the working set exceeds the budget.  This module adds the
storage hierarchy between "in memory decoded" and "gone":

  HOT   resident column blocks, memoized decode caches allowed;
  WARM  resident but squeezed — decode caches dropped, blocks adaptively
        *recompressed* (RLE / BITPACK / frame-of-reference picked from
        run-length, span and NDV signals, `compression.choose_recompression`);
  COLD  spilled to disk as a self-describing compressed segment with a
        checksum (or dropped outright in `mode="drop"`, the
        eviction+recompute baseline the spill bench compares against).

Cold partitions fault back in transparently through `Partition.columns`:
the spill segment is read and checksum-verified first; a lost or corrupt
file falls back to recompute-from-lineage — never a wrong answer, exactly
the fault contract of the BlockManager's cached batches.

Spill writes are *write-behind*: `evict()` serializes synchronously (the
bytes must exist before the blocks are released) but performs the file I/O
on a background writer thread; until the flush lands, reads are served from
the in-flight payload (read-your-writes).

Spill segment format (little-endian):

    b"SHRKSPL1" | u32 header_len | header JSON | array payload | u32 crc32

The header describes every column block (field, encoding, per-array dtype
and shape, bias/bit width, string dictionary, stats snapshot); the crc32
covers everything before it.  Segments are self-describing: a reader needs
no catalog state to reconstruct the partition.  The layout is the
reference's byte for byte, so a segment written by either package reads
back in the other.

The tier is host code over numpy and files; the write-behind thread only
writes bytes.  A partition going cold drops its blocks' device copies with
them (`Partition.release_columns`), and a faulted-in partition comes back
as new blocks whose device copies are made again on their next scan.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import queue
import shutil
import struct
import tempfile
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .columnar import ColumnBlock, ColumnStats, Partition
from .compression import Encoded, Encoding
from .types import DType, Field

MAGIC = b"SHRKSPL1"

_ARRAY_FIELDS = ("data", "codes", "dictionary", "run_values", "run_lengths",
                 "words")


class SpillCorrupt(Exception):
    """A spill segment failed structural or checksum validation."""


@dataclasses.dataclass
class SpillRef:
    """Handle to one cold partition's on-disk (or in-flight) segment."""
    path: str
    nbytes: int


# ---------------------------------------------------------------------------
# Segment serialization
# ---------------------------------------------------------------------------


def _py(v):
    """JSON-safe scalar (numpy scalars -> python)."""
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.str_, np.bool_)):
        return v.item()
    return v


def _host(a) -> np.ndarray:
    """`a` as a numpy array: a torch tensor (a column a kernel route left
    on the device) is copied to the host first."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _stats_to_json(s: ColumnStats) -> dict:
    return {"min": s.min, "max": s.max, "count": s.count, "nbytes": s.nbytes,
            "null_count": s.null_count,
            "distinct": (sorted(_py(v) for v in s.distinct)
                         if s.distinct is not None else None)}


def _stats_from_json(d: dict) -> ColumnStats:
    distinct = frozenset(d["distinct"]) if d["distinct"] is not None else None
    return ColumnStats(min=d["min"], max=d["max"], distinct=distinct,
                       count=d["count"], nbytes=d["nbytes"],
                       null_count=d["null_count"])


def serialize_partition(index: int, columns: Dict[str, ColumnBlock]) -> bytes:
    """Encode a partition's column blocks as one self-describing segment."""
    cols_meta: List[dict] = []
    chunks: List[bytes] = []
    for name, block in columns.items():
        enc = block.enc
        arrays = []
        for fld in _ARRAY_FIELDS:
            a = getattr(enc, fld)
            if a is None:
                continue
            raw = np.ascontiguousarray(a).tobytes()
            arrays.append({"field": fld, "dtype": a.dtype.str,
                           "shape": list(a.shape), "nbytes": len(raw)})
            chunks.append(raw)
        meta = {"name": name, "dtype": block.field.dtype.value,
                "encoding": enc.encoding.value, "n": enc.n,
                "bit_width": enc.bit_width, "bias": enc.bias,
                "orig_dtype": (np.dtype(enc.orig_dtype).str
                               if enc.orig_dtype is not None else None),
                "arrays": arrays, "stats": _stats_to_json(block.stats),
                "str_dict": None}
        if block.str_dict is not None:
            raw = np.ascontiguousarray(block.str_dict).tobytes()
            meta["str_dict"] = {"dtype": block.str_dict.dtype.str,
                                "shape": list(block.str_dict.shape),
                                "nbytes": len(raw)}
            chunks.append(raw)
        cols_meta.append(meta)
    header = json.dumps({"kind": "partition", "index": index,
                         "columns": cols_meta}).encode()
    body = b"".join([MAGIC, struct.pack("<I", len(header)), header] + chunks)
    return body + struct.pack("<I", zlib.crc32(body))


def _take(payload: bytes, offset: int, spec: dict) -> Tuple[np.ndarray, int]:
    nbytes = spec["nbytes"]
    raw = payload[offset: offset + nbytes]
    if len(raw) != nbytes:
        raise SpillCorrupt("truncated array payload")
    arr = np.frombuffer(raw, dtype=np.dtype(spec["dtype"]))
    return arr.reshape(spec["shape"]).copy(), offset + nbytes


def deserialize_partition(data: bytes) -> Tuple[int, Dict[str, ColumnBlock]]:
    """Validate and decode one spill segment; raises SpillCorrupt on any
    structural or checksum mismatch (the caller treats that as a lost file
    and recomputes from lineage)."""
    if len(data) < len(MAGIC) + 8 or data[: len(MAGIC)] != MAGIC:
        raise SpillCorrupt("bad magic")
    body, (crc,) = data[:-4], struct.unpack("<I", data[-4:])
    if zlib.crc32(body) != crc:
        raise SpillCorrupt("checksum mismatch")
    (hlen,) = struct.unpack_from("<I", body, len(MAGIC))
    hstart = len(MAGIC) + 4
    try:
        header = json.loads(body[hstart: hstart + hlen].decode())
    except ValueError as e:
        raise SpillCorrupt(f"bad header: {e}") from e
    offset = hstart + hlen
    if header.get("kind", "partition") != "partition":
        raise SpillCorrupt(f"not a partition segment: {header.get('kind')}")
    columns: Dict[str, ColumnBlock] = {}
    for meta in header["columns"]:
        kwargs = {}
        for spec in meta["arrays"]:
            kwargs[spec["field"]], offset = _take(body, offset, spec)
        enc = Encoded(Encoding(meta["encoding"]), n=meta["n"],
                      bit_width=meta["bit_width"], bias=meta["bias"],
                      orig_dtype=(np.dtype(meta["orig_dtype"])
                                  if meta["orig_dtype"] is not None else None),
                      **kwargs)
        str_dict = None
        if meta["str_dict"] is not None:
            str_dict, offset = _take(body, offset, meta["str_dict"])
        field = Field(meta["name"], DType(meta["dtype"]))
        columns[meta["name"]] = ColumnBlock(field, enc,
                                            _stats_from_json(meta["stats"]),
                                            str_dict)
    return header["index"], columns


def serialize_batch(batch) -> bytes:
    """Encode one shuffle block (PartitionBatch) as a self-describing
    segment — the SHUFFLE sibling of `serialize_partition`, sharing the
    container framing (magic | header | arrays | crc32).  Columns
    materialize on serialization (shuffle blocks are already materialized
    row views; block-backed columns decode once here), and string columns
    keep their dictionary-preserving (codes, dictionary) form so a faulted
    block is byte-identical to the in-memory one the reduce side expects."""
    cols_meta: List[dict] = []
    chunks: List[bytes] = []
    for name, v in batch.cols.items():
        arr = np.ascontiguousarray(_host(v.arr))
        raw = arr.tobytes()
        meta = {"name": name, "dtype": arr.dtype.str,
                "shape": list(arr.shape), "nbytes": len(raw),
                "sorted_dict": bool(v.sorted_dict), "sdict": None}
        chunks.append(raw)
        if v.sdict is not None:
            sraw = np.ascontiguousarray(v.sdict).tobytes()
            meta["sdict"] = {"dtype": v.sdict.dtype.str,
                             "shape": list(v.sdict.shape),
                             "nbytes": len(sraw)}
            chunks.append(sraw)
        cols_meta.append(meta)
    header = json.dumps({"kind": "shuffle", "columns": cols_meta}).encode()
    body = b"".join([MAGIC, struct.pack("<I", len(header)), header] + chunks)
    return body + struct.pack("<I", zlib.crc32(body))


def deserialize_batch(data: bytes):
    """Validate and decode one shuffle segment; raises SpillCorrupt on any
    structural or checksum mismatch (the caller treats that as a lost map
    output: FetchFailed -> recompute from lineage)."""
    from .batch import PartitionBatch
    from .expr import ColumnVal
    if len(data) < len(MAGIC) + 8 or data[: len(MAGIC)] != MAGIC:
        raise SpillCorrupt("bad magic")
    body, (crc,) = data[:-4], struct.unpack("<I", data[-4:])
    if zlib.crc32(body) != crc:
        raise SpillCorrupt("checksum mismatch")
    (hlen,) = struct.unpack_from("<I", body, len(MAGIC))
    hstart = len(MAGIC) + 4
    try:
        header = json.loads(body[hstart: hstart + hlen].decode())
    except ValueError as e:
        raise SpillCorrupt(f"bad header: {e}") from e
    if header.get("kind") != "shuffle":
        raise SpillCorrupt(f"not a shuffle segment: {header.get('kind')}")
    offset = hstart + hlen
    cols: Dict[str, "ColumnVal"] = {}
    for meta in header["columns"]:
        arr, offset = _take(body, offset, meta)
        sdict = None
        if meta["sdict"] is not None:
            sdict, offset = _take(body, offset, meta["sdict"])
        cols[meta["name"]] = ColumnVal(arr, sdict,
                                       sorted_dict=meta["sorted_dict"])
    return PartitionBatch(cols)


# ---------------------------------------------------------------------------
# StorageManager — the tier orchestrator
# ---------------------------------------------------------------------------


class StorageManager:
    """Owns the cold tier: spill directory, write-behind thread, checksummed
    reads with lineage fallback, and the WARM recompression hook.  Attached
    to the server's MemoryManager, which decides *when* to change tiers;
    this class knows *how*.

    `mode="spill"` is the real storage tier; `mode="drop"` releases cold
    partitions without writing anything (every fault recomputes from
    lineage) — the eviction+recompute baseline `benchmarks/spill_bench.py`
    measures against."""

    def __init__(self, spill_dir: Optional[str] = None, mode: str = "spill",
                 async_write: bool = True, policy=None):
        assert mode in ("spill", "drop"), mode
        self.mode = mode
        self.policy = policy       # core.resilience.ResiliencePolicy | None
        self.chaos = None          # core.faults.ChaosEngine, when installed
        env_dir = os.environ.get("SHARK_SPILL_DIR")
        self._own_dir = spill_dir is None and env_dir is None
        self.dir = spill_dir or env_dir or tempfile.mkdtemp(
            prefix="shark-spill-")
        os.makedirs(self.dir, exist_ok=True)
        self.lock = threading.RLock()
        self._seq = itertools.count()
        self._pending: Dict[str, bytes] = {}   # enqueued, not yet flushed
        self._live: set = set()                # paths of live segments
        # counters (monotonic unless noted; exposed via stats())
        self.spills = 0                 # cold transitions that wrote a segment
        self.drops = 0                  # cold transitions in drop mode
        self.spill_bytes = 0            # CURRENT live segment bytes (disk+pending)
        self.spill_write_bytes = 0      # total segment bytes ever written
        self.spill_reads = 0            # faults served from a segment
        self.spill_read_bytes = 0
        self.spill_lost = 0             # fault found the file missing
        self.spill_corrupt = 0          # fault found the file corrupt
        self.lineage_faults = 0         # faults that recomputed from lineage
        self.shuffle_spills = 0         # shuffle blocks written to a segment
        self.shuffle_faults = 0         # shuffle blocks read back from disk
        self.shuffle_lost = 0           # shuffle faults that found no segment
        self.recompressions = 0         # blocks shrunk by the WARM hook
        self.recompressed_bytes = 0
        self.released_bytes = 0         # resident bytes freed by cold transitions
        self._queue: "queue.Queue" = queue.Queue()
        self._writer: Optional[threading.Thread] = None
        if async_write and mode == "spill":
            self._writer = threading.Thread(target=self._writer_loop,
                                            name="shark-spill-writer",
                                            daemon=True)
            self._writer.start()

    # -- WARM: adaptive recompression ----------------------------------------

    def recompress_partition(self, part: Partition) -> int:
        """Apply the WARM transition to one partition; returns bytes freed."""
        freed = part.recompress()
        if freed > 0:
            with self.lock:
                self.recompressions += 1
                self.recompressed_bytes += freed
        return freed

    # -- COLD: spill / drop ---------------------------------------------------

    def evict(self, table_name: str, part: Partition) -> int:
        """Transition one resident partition to the cold tier.  In spill
        mode the segment is serialized now and flushed by the write-behind
        thread; in drop mode the blocks are simply released.  Returns
        resident bytes freed."""
        with self.lock:
            if not part.resident:
                return 0
            if self.mode == "spill":
                # chaos seam "spill.write": the segment write silently
                # vanishes (never reaches disk); only armed for partitions
                # with lineage — the read side then degrades to
                # recompute-from-lineage, never to data loss
                trip = None
                if self.chaos is not None and part.lineage is not None:
                    trip = self.chaos.fire("spill.write")
                payload = serialize_partition(part.index, part._columns)
                path = os.path.join(
                    self.dir,
                    f"spill-{next(self._seq):06d}-{table_name}"
                    f"-p{part.index}.shk")
                part.spill_ref = SpillRef(path, len(payload))
                self._live.add(path)
                self.spills += 1
                self.spill_bytes += len(payload)
                self.spill_write_bytes += len(payload)
                if trip is None:
                    self._pending[path] = payload
                    if self._writer is not None:
                        self._queue.put((path, payload))
                    else:
                        self._flush_one(path, payload)
            else:
                part.spill_ref = None
                self.drops += 1
            part.storage = self
            freed = part.release_columns()
            self.released_bytes += freed
            return freed

    def fault_in(self, part: Partition) -> None:
        """Bring a cold partition back: segment read (verify checksum) with
        recompute-from-lineage fallback on a lost or corrupt file."""
        with self.lock:
            if part.resident:
                return
            columns = None
            ref = part.spill_ref
            if ref is not None:
                # chaos seam "spill.read": kind "lost" pretends the file
                # vanished, "corrupt" flips a payload byte so the checksum
                # rejects it; armed only with lineage to recompute from
                trip = None
                if self.chaos is not None and part.lineage is not None:
                    trip = self.chaos.fire("spill.read")
                if trip is not None and trip.kind != "corrupt":
                    data = None
                    self.spill_lost += 1
                else:
                    data = self._pending.get(ref.path)
                    if data is None:
                        try:
                            with open(ref.path, "rb") as f:
                                data = f.read()
                        except OSError:
                            self.spill_lost += 1
                    if trip is not None and data is not None:
                        data = data[:-1] + bytes([data[-1] ^ 0xFF])
                if data is not None:
                    try:
                        _, columns = deserialize_partition(data)
                        self.spill_reads += 1
                        self.spill_read_bytes += len(data)
                    except SpillCorrupt:
                        self.spill_corrupt += 1
                self._forget(part)
            if columns is None:
                if part.lineage is None:
                    raise RuntimeError(
                        "cold partition lost its spill segment and has no "
                        "lineage to recompute from")
                self.lineage_faults += 1
                columns = part.lineage()
            part.restore_columns(columns)

    def _forget(self, part: Partition) -> None:
        """Retire a partition's segment (fault-in consumed it, or the table
        was dropped): release the path, payload bytes, and the file."""
        ref = part.spill_ref
        if ref is None:
            return
        part.spill_ref = None
        self._pending.pop(ref.path, None)
        self._live.discard(ref.path)
        self.spill_bytes -= ref.nbytes
        try:
            os.remove(ref.path)
        except OSError:
            pass

    # -- COLD: shuffle blocks -------------------------------------------------

    def spill_shuffle(self, key: Tuple, batch) -> Optional[SpillRef]:
        """Write one shuffle block to the cold tier (spill mode only —
        dropping shuffle output mid-query forces recompute storms, so drop
        mode never evicts shuffle blocks).  Same write-behind path as
        partition segments; the block key lands in the file name for
        operator forensics."""
        if self.mode != "spill":
            return None
        # chaos seam "spill.write": a lost shuffle segment degrades to
        # FetchFailed -> lineage recompute on the read side, always safe
        trip = self.chaos.fire("spill.write") if self.chaos is not None \
            else None
        payload = serialize_batch(batch)
        path = os.path.join(
            self.dir,
            f"shuf-{next(self._seq):06d}"
            f"-s{key[1]}-m{key[2]}-b{key[3]}.shk")
        with self.lock:
            self._live.add(path)
            self.shuffle_spills += 1
            self.spills += 1
            self.spill_bytes += len(payload)
            self.spill_write_bytes += len(payload)
            if trip is None:
                self._pending[path] = payload
                if self._writer is not None:
                    self._queue.put((path, payload))
                else:
                    self._flush_one(path, payload)
        return SpillRef(path, len(payload))

    def fault_shuffle(self, ref: SpillRef):
        """Read one spilled shuffle block back; returns None when the
        segment is lost or corrupt — the caller reports the map output
        missing (FetchFailed) and the scheduler recomputes it from lineage,
        the same fault contract as partition segments."""
        # chaos seam "spill.read" (shuffle side): both kinds surface as a
        # missing segment — the caller raises FetchFailed and the scheduler
        # recomputes the map output from lineage
        if self.chaos is not None:
            trip = self.chaos.fire("spill.read")
            if trip is not None:
                with self.lock:
                    self.shuffle_lost += 1
                    if trip.kind == "corrupt":
                        self.spill_corrupt += 1
                    else:
                        self.spill_lost += 1
                return None
        with self.lock:
            data = self._pending.get(ref.path)
        if data is None:
            try:
                with open(ref.path, "rb") as f:
                    data = f.read()
            except OSError:
                with self.lock:
                    self.shuffle_lost += 1
                    self.spill_lost += 1
                return None
        try:
            batch = deserialize_batch(data)
        except SpillCorrupt:
            with self.lock:
                self.spill_corrupt += 1
                self.shuffle_lost += 1
            return None
        with self.lock:
            self.shuffle_faults += 1
            self.spill_reads += 1
            self.spill_read_bytes += len(data)
        return batch

    def forget_shuffle(self, ref: SpillRef) -> None:
        """Retire one shuffle segment (its shuffle finished, or its block
        was recomputed): release path, pending payload, and file."""
        with self.lock:
            self._pending.pop(ref.path, None)
            self._live.discard(ref.path)
            self.spill_bytes -= ref.nbytes
        try:
            os.remove(ref.path)
        except OSError:
            pass

    # -- write-behind ---------------------------------------------------------

    def _flush_one(self, path: str, payload: bytes) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        with self.lock:
            if path in self._live:
                os.replace(tmp, path)
                self._pending.pop(path, None)
            else:
                # faulted in (or dropped) before the flush landed
                try:
                    os.remove(tmp)
                except OSError:
                    pass

    def _writer_loop(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                self._flush_one(*item)
            finally:
                self._queue.task_done()

    def flush(self) -> None:
        """Block until every enqueued segment write has landed (tests and
        deterministic chaos injection)."""
        self._queue.join()

    # -- reporting / lifecycle ------------------------------------------------

    def stats(self) -> Dict[str, int]:
        with self.lock:
            return {
                "mode": self.mode,
                "spills": self.spills,
                "drops": self.drops,
                "spill_bytes": self.spill_bytes,
                "spill_write_bytes": self.spill_write_bytes,
                "spill_reads": self.spill_reads,
                "spill_read_bytes": self.spill_read_bytes,
                "spill_lost": self.spill_lost,
                "spill_corrupt": self.spill_corrupt,
                "lineage_faults": self.lineage_faults,
                "shuffle_spills": self.shuffle_spills,
                "shuffle_faults": self.shuffle_faults,
                "shuffle_lost": self.shuffle_lost,
                "recompressions": self.recompressions,
                "recompressed_bytes": self.recompressed_bytes,
                "released_bytes": self.released_bytes,
            }

    def shutdown(self) -> None:
        if self._writer is not None:
            join_s = (self.policy.spill_join_timeout_s
                      if self.policy is not None else 10.0)
            self._queue.put(None)
            self._writer.join(timeout=join_s)
            self._writer = None
        with self.lock:
            for path in list(self._live):
                try:
                    os.remove(path)
                except OSError:
                    pass
            self._live.clear()
            self._pending.clear()
        if self._own_dir:
            shutil.rmtree(self.dir, ignore_errors=True)
