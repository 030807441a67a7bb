"""Unified memory manager for the server tier (DESIGN.md §6.3), the port of
`repro.server.memory`.

Shark's cached tables are a *cache*, not primary storage (paper §3.2): any
cached partition can be dropped under memory pressure and transparently
recomputed from RDD lineage on the next access.  The MemoryManager does
unified byte accounting over everything the BlockManager holds (cached
partitions + in-flight shuffle output) plus the query result cache, and
enforces a configurable budget.

The budget governs *evictable cache bytes* — cached partition blocks,
result-cache entries, the column store's host decode memos and, with a
StorageManager attached (DESIGN.md §12), the catalog's resident encoded
bytes, since the storage tier can release those — exactly as in the
reference.  Without a storage tier catalog blocks are primary storage and
never counted.  Shuffle map outputs are working memory, not cache: a
running reducer holds a fetch dependency on them.  They are accounted and
reported (`working_bytes`), and the server releases them when their query
completes (`BlockManager.drop_shuffle`).  With a spill-mode StorageManager
attached the working set obeys the budget too: when the cache rungs cannot
satisfy it, shuffle blocks spill (largest first) to checksummed segments
and fault back in on fetch.

Eviction policy (deterministic, documented order):
  1. cached partition blocks, least-recently-used first — always
     recomputable from lineage;
  2. the column store's host decode memos (`Encoded._decoded`): derived
     state that re-materializes on the next decode;
  3. with a StorageManager attached, adaptive recompression of resident
     catalog partitions (WARM), then
  4. spilling the least-recently-scanned catalog partition (COLD: to disk,
     or dropped in drop mode);
  5. query-result-cache entries, LRU — tiny (final aggregates) and costly
     to recompute, so evicted only when nothing else can satisfy the
     budget;
  6. the bypass (below);
  7. with a spill-mode StorageManager, the working-set rung: shuffle blocks
     spill, largest first.
The reference's order is 1, 5, 2, 3, 4, 6, 7 (ROADMAP C.6, C.7): there a
result entry of a few hundred bytes goes before megabytes of memos or of
a partition that faults back with one read, and a catalog over budget
evicts every result first.  The partition rung, the bypass and what the
budget governs are the reference's.

If the just-inserted partition alone exceeds what the budget can hold even
after evicting everything else, it is itself dropped — a cache-admission
*bypass*: the query that computed it already has the batch in hand, so
correctness is unaffected.

Device memory is reported, not budgeted (`device_bytes`): the bytes of the
resident catalog blocks' device memos (`Encoded._device`, filled by
`compression.device_stream` and `ColumnBlock.device_array`) and of any
cached batch that holds CUDA tensors.  The memos are derived copies of
catalog blocks, so they are bounded by the catalog's encoded bytes; the
decode-memo rung drops the host memo only (`Encoded.drop_decoded`), never
a device copy it does not count.  A block's device memo goes when its
encoding changes or it leaves memory (`Encoded.drop_device`), a COLD
transition included.  On the CPU `device_bytes` reads 0: the memos share
the numpy arrays there.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Set, Tuple

from ..core.compression import DECODE_MEMO_CHANGES
from ..core.runtime import BlockManager


def _cuda_bytes(obj, seen: Set[int]) -> int:
    """Bytes of the CUDA tensors in `obj` (a tensor, or a tuple / list of
    them), each storage counted once across calls sharing `seen`."""
    if isinstance(obj, (tuple, list)):
        return sum(_cuda_bytes(o, seen) for o in obj)
    if not getattr(obj, "is_cuda", False):
        return 0
    storage = obj.untyped_storage()
    ptr = storage.data_ptr()
    if ptr in seen:
        return 0
    seen.add(ptr)
    return storage.nbytes()


class MemoryManager:
    def __init__(self, block_manager: BlockManager,
                 budget_bytes: Optional[int] = None):
        self.bm = block_manager
        self.budget_bytes = budget_bytes
        self.lock = threading.RLock()
        self._result_cache = None  # attached by the server
        self._evicted: Set[Tuple] = set()
        # counters (all monotonic; exposed via stats())
        self.evictions = 0
        self.evicted_bytes = 0
        self.recomputes = 0
        self.result_evictions = 0
        self.bypasses = 0
        self.over_budget_events = 0
        self.decode_cache_drops = 0
        self.decode_cache_dropped_bytes = 0
        self.chaos_pressure_drops = 0
        self._catalog = None
        # (catalog epoch, memo changes) -> the decode memos' bytes then
        self._decoded_sum = (None, 0)
        self.storage = None        # core.storage.StorageManager, optional
        self.chaos = None          # core.faults.ChaosEngine, when installed
        self.bm.memory_manager = self

    def attach_result_cache(self, result_cache) -> None:
        self._result_cache = result_cache

    def attach_catalog(self, catalog) -> None:
        """Register the catalog whose tables' memoized decode caches
        (`Encoded._decoded`, see core/compression.py) this manager may
        release under pressure, and whose device memos it reports."""
        self._catalog = catalog

    def attach_storage(self, storage) -> None:
        """Attach the out-of-core storage tier (DESIGN.md §12): enables the
        recompression and spill rungs of `enforce()` and adds the catalog's
        resident encoded bytes to the governed budget.  In spill mode the
        BlockManager gains the shuffle spill/fault path too (drop mode
        keeps shuffle output pinned — dropping it mid-query just forces
        recompute storms)."""
        self.storage = storage
        if storage is not None and storage.mode == "spill":
            self.bm.shuffle_storage = storage

    def drop_decoded_caches(self) -> int:
        """Release every catalog table's memoized host decode cache — pure
        derived state that re-materializes on the next decode.  Device
        memos stay.  Returns bytes freed."""
        cat = self._catalog
        if cat is None:
            return 0
        freed = 0
        for table in list(cat._tables.values()):
            freed += table.drop_decoded()
        if freed:
            self.decode_cache_drops += 1
            self.decode_cache_dropped_bytes += freed
        return freed

    # -- accounting ----------------------------------------------------------

    def accounted_bytes(self) -> int:
        """Everything tracked: cache bytes + in-flight shuffle output."""
        rc = self._result_cache
        return (self.bm.nbytes() + (rc.nbytes if rc is not None else 0)
                + self.decoded_cache_bytes() + self.catalog_resident_bytes())

    def decoded_cache_bytes(self) -> int:
        """Memoized host decode caches across catalog tables — real memory
        the budget governs.  The sum is kept until a memo is set or
        released or the catalog changes: every block put asks for it."""
        cat = self._catalog
        if cat is None:
            return 0
        # read the stamp before summing: a change during the sum leaves a
        # stale stamp, so the next call sums again
        stamp = (cat.epoch, DECODE_MEMO_CHANGES[0])
        kept, total = self._decoded_sum
        if kept != stamp:
            total = sum(t.decoded_cache_nbytes
                        for t in list(cat._tables.values()))
            self._decoded_sum = (stamp, total)
        return total

    def catalog_resident_bytes(self) -> int:
        """Resident encoded bytes of catalog tables.  Governed only when a
        storage tier is attached — without one these bytes are primary
        storage the manager cannot release, so counting them would just
        burn the budget on unevictable state."""
        if self.storage is None or self._catalog is None:
            return 0
        return sum(t.resident_nbytes
                   for t in list(self._catalog._tables.values()))

    def cache_bytes(self) -> int:
        """Evictable bytes the budget governs: partition blocks + results +
        host decode memos (+ catalog resident bytes when spillable)."""
        rc = self._result_cache
        return (self.bm.part_bytes + (rc.nbytes if rc is not None else 0)
                + self.decoded_cache_bytes() + self.catalog_resident_bytes())

    def device_bytes(self) -> int:
        """Device memory held by the catalog blocks' device memos and by
        cached batches' CUDA tensors (reported, not budgeted)."""
        seen: Set[int] = set()
        total = 0
        cat = self._catalog
        if cat is not None:
            for table in list(cat._tables.values()):
                for part in table.partitions:
                    cols = part._columns
                    for blk in (cols or {}).values():
                        total += _cuda_bytes(list(blk.enc._device.values()),
                                             seen)
        with self.bm.lock:
            held = list(self.bm.blocks.values())
        for _, batch in held:
            for v in getattr(batch, "cols", {}).values():
                total += _cuda_bytes(getattr(v, "_arr", None), seen)
        return total

    # -- BlockManager hooks ---------------------------------------------------

    def on_put(self, key: Tuple) -> None:
        """A block was just inserted: enforce the budget, protecting it."""
        with self.lock:
            self._evicted.discard(key)
        self.enforce(protect=key)

    def on_miss(self, key: Tuple) -> None:
        """A cached-partition read missed.  If we evicted that block, this
        miss is the paper's recompute-from-lineage fallback in action."""
        with self.lock:
            if key in self._evicted:
                self._evicted.discard(key)
                self.recomputes += 1

    # -- enforcement ----------------------------------------------------------

    def enforce(self, protect: Optional[Tuple] = None) -> None:
        # chaos seam "memory.enforce": simulated memory pressure drops one
        # unprotected LRU cached partition — always recoverable (cached
        # partitions recompute from lineage on the next miss, exactly the
        # real eviction path below)
        if self.chaos is not None:
            trip = self.chaos.fire("memory.enforce")
            if trip is not None:
                with self.lock:
                    for key in self.bm.lru_partition_keys():
                        if key == protect:
                            continue
                        freed = self.bm.drop_block(key)
                        if freed:
                            self.evictions += 1
                            self.evicted_bytes += freed
                            self.chaos_pressure_drops += 1
                            self._evicted.add(key)
                        break
        if self.budget_bytes is None:
            return
        with self.lock:
            while self.cache_bytes() > self.budget_bytes:
                victim = None
                for key in self.bm.lru_partition_keys():
                    if key != protect:
                        victim = key
                        break
                if victim is not None:
                    freed = self.bm.drop_block(victim)
                    if freed:
                        self.evictions += 1
                        self.evicted_bytes += freed
                        self._evicted.add(victim)
                    continue
                # release the column store's host decode memos (derived
                # state that re-materializes on the next decode)
                if self.drop_decoded_caches() > 0:
                    continue
                if self.storage is not None:
                    # WARM: adaptively recompress resident catalog
                    # partitions (RLE / BITPACK / FOR from stats)
                    if self._recompress_pass() > 0:
                        continue
                    # WARM -> COLD: spill the least-recently-scanned
                    # partition to disk (or drop it, in drop mode)
                    if self._spill_coldest() > 0:
                        continue
                rc = self._result_cache
                if rc is not None and rc.nbytes > 0:
                    if rc.evict_lru() > 0:
                        self.result_evictions += 1
                        continue
                if (protect is not None and protect[0] == "part"
                        and protect in self.bm.sizes):
                    # the new block alone exceeds the budget: refuse
                    # admission rather than blow it
                    self.bm.drop_block(protect)
                    self.bypasses += 1
                    self._evicted.add(protect)
                self.over_budget_events += (
                    self.cache_bytes() > self.budget_bytes)
                break
            self._enforce_working_set(protect)

    def _enforce_working_set(self, protect: Optional[Tuple]) -> None:
        """Working-set rung: with a spill-mode storage tier attached, total
        accounted bytes (cache + shuffle output) obey the budget too —
        shuffle blocks spill largest-first and fault back in on fetch.
        Runs after the cache rungs so catalog state always yields before
        mid-query working memory does."""
        if (self.storage is None or self.storage.mode != "spill"
                or self.bm.shuffle_storage is None):
            return
        if self.accounted_bytes() <= self.budget_bytes:
            return
        for key in self.bm.shuffle_spill_candidates():
            if key == protect:
                continue
            self.bm.spill_shuffle_block(key)
            if self.accounted_bytes() <= self.budget_bytes:
                return

    # -- storage-hierarchy rungs (DESIGN.md §12) ------------------------------

    def _recompress_pass(self) -> int:
        """One WARM pass: recompress every resident catalog partition.
        Idempotent — a second pass over already-recompressed blocks frees
        nothing, so enforce() falls through to the spill rung."""
        cat = self._catalog
        if cat is None:
            return 0
        freed = 0
        for table in list(cat._tables.values()):
            for part in table.partitions:
                if part.resident:
                    freed += self.storage.recompress_partition(part)
        return freed

    def _spill_coldest(self) -> int:
        """One COLD transition: evict the least-recently-scanned resident
        catalog partition.  Lineage-bearing partitions go first (their
        recovery story is complete even if the segment is later lost); in
        drop mode they are the only candidates, since dropping without
        lineage would lose data outright."""
        cat = self._catalog
        if cat is None:
            return 0
        candidates = []
        for name, table in list(cat._tables.items()):
            for part in table.partitions:
                if part.resident and part.resident_nbytes > 0:
                    candidates.append((part.lineage is None,
                                       part.last_access, name, part))
        if self.storage.mode == "drop":
            candidates = [c for c in candidates if not c[0]]
        if not candidates:
            return 0
        _, _, name, part = min(candidates, key=lambda c: (c[0], c[1]))
        return self.storage.evict(name, part)

    # -- reporting -------------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        rc = self._result_cache
        part_bytes = self.bm.part_bytes
        st = self.storage.stats() if self.storage is not None else {}
        return {
            "budget_bytes": self.budget_bytes or 0,
            "partition_bytes": part_bytes,
            "working_bytes": self.bm.nbytes() - part_bytes,  # shuffle
            "result_cache_bytes": rc.nbytes if rc is not None else 0,
            "decoded_cache_bytes": self.decoded_cache_bytes(),
            "catalog_resident_bytes": self.catalog_resident_bytes(),
            "cache_bytes": self.cache_bytes(),
            "accounted_bytes": self.accounted_bytes(),
            "device_bytes": self.device_bytes(),
            "partition_hits": self.bm.part_hits,
            "partition_misses": self.bm.part_misses,
            "evictions": self.evictions,
            "evicted_bytes": self.evicted_bytes,
            "recomputes": self.recomputes,
            "result_evictions": self.result_evictions,
            "bypasses": self.bypasses,
            "over_budget_events": self.over_budget_events,
            "decode_cache_drops": self.decode_cache_drops,
            "decode_cache_dropped_bytes": self.decode_cache_dropped_bytes,
            "chaos_pressure_drops": self.chaos_pressure_drops,
            # storage tier (zeros when no StorageManager is attached, so
            # the keys are always there)
            "spills": st.get("spills", 0),
            "spill_bytes": st.get("spill_bytes", 0),
            "spill_reads": st.get("spill_reads", 0),
            "recompressions": st.get("recompressions", 0),
            "lineage_faults": st.get("lineage_faults", 0),
            "shuffle_spills": st.get("shuffle_spills", 0),
            "shuffle_faults": st.get("shuffle_faults", 0),
            "shuffle_lost": st.get("shuffle_lost", 0),
        }
