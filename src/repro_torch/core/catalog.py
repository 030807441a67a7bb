"""Table catalog — the warehouse metadata store (paper Figure 2).

Shark keeps warehouse metadata in an external transactional database (the
Hive metastore); here the catalog is an in-process registry of cached
columnar tables plus "external" tables (loaded lazily from generator
functions, standing in for HDFS data the engine can also query directly).

For the server tier (DESIGN.md §6) the catalog is also the *versioning*
authority: every mutation (CREATE TABLE / load / drop) bumps a global epoch
and stamps the mutated table with it.  Query-result cache entries record the
versions of the tables they read; a version mismatch (or an invalidation
callback) means the cached result may be stale and must not be served.
Lazy materialization of an external source does NOT bump the version — the
loader is deterministic, so the logical table content is unchanged.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from .columnar import Table, build_partition, from_arrays
from .types import Schema


@dataclasses.dataclass
class ExternalSource:
    """Stands in for an HDFS/S3 table: schema + a loader that yields raw
    column arrays.  Loading into the memory store == CREATE TABLE ...
    TBLPROPERTIES ('shark.cache'='true') AS SELECT ..."""
    name: str
    schema: Schema
    loader: Callable[[], Dict[str, np.ndarray]]
    num_partitions: int = 8


def _external_partition_lineage(src: ExternalSource, index: int):
    """Recompute-from-lineage closure for ONE partition of a materialized
    external table (storage tier, DESIGN.md §12): re-run the deterministic
    loader and rebuild exactly the contiguous slice `from_arrays` assigned
    to this partition.  A spilled partition whose segment is lost or corrupt
    restores from here — same content, because loader and split edges are
    both deterministic."""
    def rebuild():
        data = src.loader()
        n = len(next(iter(data.values()))) if data else 0
        edges = np.linspace(0, n, src.num_partitions + 1, dtype=np.int64)
        lo, hi = int(edges[index]), int(edges[index + 1])
        sliced = {f.name: np.asarray(data[f.name])[lo:hi]
                  for f in src.schema.fields}
        return build_partition(index, src.schema, sliced).columns
    return rebuild


class Catalog:
    def __init__(self):
        self._tables: Dict[str, Table] = {}
        self._external: Dict[str, ExternalSource] = {}
        self._lock = threading.RLock()
        self._epoch = 0
        self._versions: Dict[str, int] = {}
        self._listeners: List[Callable[[str, int], None]] = []

    # -- versioning (server result-cache invalidation) ----------------------

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def version(self, name: str) -> int:
        """Epoch at which `name` last changed (0 = never registered)."""
        with self._lock:
            return self._versions.get(name, 0)

    def subscribe(self, fn: Callable[[str, int], None]) -> None:
        """`fn(table_name, new_epoch)` fires on every catalog mutation."""
        with self._lock:
            self._listeners.append(fn)

    def _bump_locked(self, name: str):
        # caller holds self._lock; returns the notification to fire AFTER
        # the lock is released (listeners may take their own locks that
        # also call back into the catalog — holding ours would AB-BA)
        self._epoch += 1
        self._versions[name] = self._epoch
        return list(self._listeners), name, self._epoch

    @staticmethod
    def _fire(notification) -> None:
        listeners, name, epoch = notification
        for fn in listeners:
            fn(name, epoch)

    def adopt_version(self, name: str, version: int) -> None:
        """Force `name`'s version to a peer catalog's (the fleet epoch
        protocol, DESIGN.md §13.2): the global epoch advances to at least
        `version` and listeners fire, so dependent result-cache entries
        invalidate exactly as they would for a local mutation.  Idempotent
        when the versions already agree."""
        with self._lock:
            if self._versions.get(name, 0) == version:
                return
            self._epoch = max(self._epoch, version)
            self._versions[name] = version
            note = (list(self._listeners), name, version)
        self._fire(note)

    # -- registry ------------------------------------------------------------

    def register_table(self, table: Table) -> None:
        with self._lock:
            self._tables[table.name] = table
            note = self._bump_locked(table.name)
        self._fire(note)

    def register_external(self, src: ExternalSource) -> None:
        with self._lock:
            self._external[src.name] = src
            note = self._bump_locked(src.name)
        self._fire(note)

    def get(self, name: str) -> Table:
        return self.get_versioned(name)[0]

    def get_versioned(self, name: str):
        """(table, version) read atomically — a concurrent mutation cannot
        pair the old table object with the new version (the server's scan
        cache keys blocks by version, so a torn read would poison it)."""
        with self._lock:
            if name in self._tables:
                return self._tables[name], self._versions.get(name, 0)
            if name in self._external:
                src = self._external[name]
                # schema-on-read load path: materialize as columnar partitions
                # (deterministic loader -> logical content unchanged, no bump)
                table = from_arrays(name, src.schema, src.loader(),
                                    src.num_partitions)
                for part in table.partitions:
                    part.lineage = _external_partition_lineage(src, part.index)
                self._tables[name] = table
                return table, self._versions.get(name, 0)
        raise KeyError(f"unknown table {name!r}")

    def schema(self, name: str) -> Schema:
        with self._lock:
            if name in self._tables:
                return self._tables[name].schema
            if name in self._external:
                return self._external[name].schema
        raise KeyError(f"unknown table {name!r}")

    def exists(self, name: str) -> bool:
        with self._lock:
            return name in self._tables or name in self._external

    def drop(self, name: str) -> None:
        note = None
        with self._lock:
            existed = name in self._tables or name in self._external
            self._tables.pop(name, None)
            self._external.pop(name, None)
            if existed:
                note = self._bump_locked(name)
        if note is not None:
            self._fire(note)

    def tables(self):
        with self._lock:
            return dict(self._tables)
