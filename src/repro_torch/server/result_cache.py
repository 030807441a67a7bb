"""Plan-fingerprint query result cache (DESIGN.md §6.4), the port of
`repro.server.result_cache`.

Interactive warehouse traffic is heavily repetitive — the same dashboard
aggregates hit the warehouse from many analysts.  The server caches *final
query results* keyed by a fingerprint of the optimized logical plan plus
the catalog versions of every base table the plan reads:

    fingerprint = sha1(explain(optimized_plan) | table@version, ...)

Two queries that bind+optimize to the same plan over the same table
versions share one entry, regardless of SQL text differences — and
regardless of *surface*: a fluent SharkFrame query submits its bound plan
object and lands on the same fingerprint as its SQL-text twin, because
both surfaces emit identical logical plans (core/frame.py, DESIGN.md §7)
and the fingerprint hashes the optimized plan, not query text.  Catalog
epochs make invalidation exact: any CREATE TABLE / load / drop bumps the
mutated table's version, which (a) changes the fingerprint of future
queries, and (b) fires a subscription that eagerly drops entries depending
on the table.  Entry bytes are charged to the unified MemoryManager budget
and evicted LRU (after cached partitions — results are small and precious).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional

from ..core.catalog import Catalog
from ..core.physical import ExecResult
# defined beside `explain` in core/plan.py; both import paths work
from ..core.plan import plan_fingerprint, plan_tables

__all__ = ["CacheEntry", "ResultCache", "plan_fingerprint", "plan_tables"]


@dataclass
class CacheEntry:
    result: ExecResult
    nbytes: int
    deps: Dict[str, int]


class ResultCache:
    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._lock = threading.RLock()
        self._entries: "OrderedDict[str, CacheEntry]" = OrderedDict()
        self._nbytes = 0
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.invalidations = 0
        self.evictions = 0

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._nbytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, fingerprint: str, catalog: Catalog) -> Optional[ExecResult]:
        with self._lock:
            entry = self._entries.get(fingerprint)
            if entry is not None:
                # versions are baked into the fingerprint, but re-validate in
                # case a mutation slipped between bind and lookup
                if all(catalog.version(t) == v
                       for t, v in entry.deps.items()):
                    self._entries.move_to_end(fingerprint)
                    self.hits += 1
                    return entry.result
                self._drop(fingerprint)
                self.invalidations += 1
            self.misses += 1
            return None

    def put(self, fingerprint: str, result: ExecResult,
            deps: Dict[str, int]) -> None:
        nbytes = int(sum(b.nbytes for b in result.batches))
        with self._lock:
            if fingerprint in self._entries:
                self._drop(fingerprint)
            self._entries[fingerprint] = CacheEntry(result, nbytes, deps)
            self._nbytes += nbytes
            self.puts += 1
            while len(self._entries) > self.max_entries:
                self.evict_lru()

    def invalidate_table(self, name: str) -> int:
        """Drop every entry whose plan read `name`; returns count dropped."""
        with self._lock:
            stale = [fp for fp, e in self._entries.items() if name in e.deps]
            for fp in stale:
                self._drop(fp)
            self.invalidations += len(stale)
            return len(stale)

    def evict_lru(self) -> int:
        """Drop the least-recently-used entry; returns bytes freed."""
        with self._lock:
            if not self._entries:
                return 0
            fp = next(iter(self._entries))
            freed = self._entries[fp].nbytes
            self._drop(fp)
            self.evictions += 1
            return freed

    def _drop(self, fingerprint: str) -> None:
        entry = self._entries.pop(fingerprint, None)
        if entry is not None:
            self._nbytes -= entry.nbytes

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries), "nbytes": self._nbytes,
                    "hits": self.hits, "misses": self.misses,
                    "puts": self.puts, "evictions": self.evictions,
                    "invalidations": self.invalidations}
