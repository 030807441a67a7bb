"""Resilient Distributed Datasets with lineage (paper §2.2, §2.3).

RDDs are immutable, partitioned collections created only through
deterministic coarse-grained operators.  Instead of replicating data, the
engine remembers each dataset's *lineage* — the operator graph that built it
— and recovers lost partitions by recomputing them, in parallel, on other
workers.  This module defines the dataset graph; `runtime.py` is the
scheduler that executes it, injects failures, and performs lineage recovery
and speculative execution.

The host runtime plays the role of Spark's cluster: logical workers hold
block stores (cached partitions + shuffle map outputs), and per-partition
tasks execute compiled columnar kernels on the session's device.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .batch import PartitionBatch
from .columnar import Table
from .stats import Accumulator

_rdd_counter = itertools.count()
_shuffle_counter = itertools.count()


class Dependency:
    def __init__(self, parent: "RDD"):
        self.parent = parent


class OneToOneDependency(Dependency):
    def parents_of(self, split: int) -> List[int]:
        return [split]


class RangeDependency(Dependency):
    """Narrow dependency on an explicit list of parent partitions per split
    (used for PDE's reducer coalescing: one coarse partition reads many
    fine-grained map buckets)."""

    def __init__(self, parent: "RDD", groups: List[List[int]]):
        super().__init__(parent)
        self.groups = groups

    def parents_of(self, split: int) -> List[int]:
        return self.groups[split]


class ShuffleDependency(Dependency):
    """Wide dependency: every output partition reads from every map task.

    `partitioner(batch) -> np.ndarray[int]` assigns each row to a bucket.
    `map_side_combine` optionally pre-aggregates each bucket before it is
    materialized (Shark/Hive task-local aggregation).
    `accumulators()` builds the PDE statistics gathered while map output
    materializes (§3.1).
    """

    def __init__(self, parent: "RDD", num_buckets: int,
                 partitioner: Callable[[PartitionBatch], np.ndarray],
                 map_side_combine: Optional[Callable[[PartitionBatch], PartitionBatch]] = None,
                 accumulators: Optional[Callable[[], List[Accumulator]]] = None):
        super().__init__(parent)
        self.shuffle_id = next(_shuffle_counter)
        self.num_buckets = num_buckets
        self.partitioner = partitioner
        self.map_side_combine = map_side_combine
        self.accumulators = accumulators or (lambda: [])


@dataclasses.dataclass
class TaskContext:
    worker_id: int
    stage_id: int
    split: int
    attempt: int = 0


class RDD:
    def __init__(self, ctx: "SharkContext", num_partitions: int,
                 deps: Sequence[Dependency]):
        self.ctx = ctx
        self.id = next(_rdd_counter)
        self._num_partitions = num_partitions
        self.deps = list(deps)
        self.cached = False
        # optional per-split artificial delay (seconds) for straggler tests
        self.delay_fn: Optional[Callable[[int], float]] = None

    # -- graph -------------------------------------------------------------

    @property
    def num_partitions(self) -> int:
        return self._num_partitions

    def compute(self, split: int, tc: TaskContext) -> PartitionBatch:
        raise NotImplementedError

    def iterator(self, split: int, tc: TaskContext) -> PartitionBatch:
        """Cache-aware access: reuse a materialized block if present, else
        compute from lineage (and cache if marked).

        This is the paper's fallback-to-recompute path (§3.2): a cached
        partition may have been dropped at any time — worker loss, or the
        MemoryManager evicting under a cache budget — and the query still
        succeeds by recomputing the partition from its lineage.  The re-put
        below re-admits the block, subject to the same budget."""
        if self.cached:
            hit = self.ctx.block_manager.get_partition(self.id, split)
            if hit is not None:
                return hit
        if self.delay_fn is not None:
            import time
            time.sleep(self.delay_fn(split))
        out = self.compute(split, tc)
        if self.cached:
            self.ctx.block_manager.put_partition(self.id, split, out,
                                                 tc.worker_id)
        return out

    def cache(self) -> "RDD":
        self.cached = True
        return self

    def unpersist(self) -> "RDD":
        """Unmark and drop any materialized blocks from the block store."""
        self.cached = False
        for split in range(self.num_partitions):
            self.ctx.block_manager.drop_block(("part", self.id, split))
        return self

    # -- functional API (paper §2.2 operators) ------------------------------

    def map_partitions(self, f: Callable[[int, PartitionBatch], PartitionBatch]
                       ) -> "MapPartitionsRDD":
        return MapPartitionsRDD(self, f)

    def zip_partitions(self, other: "RDD",
                       f: Callable[[int, PartitionBatch, PartitionBatch], PartitionBatch]
                       ) -> "ZipPartitionsRDD":
        return ZipPartitionsRDD(self, other, f)

    def collect(self) -> List[PartitionBatch]:
        return self.ctx.scheduler.run_job(self)

    def __repr__(self):
        return f"{type(self).__name__}(id={self.id}, parts={self.num_partitions})"


class TableScanRDD(RDD):
    """Source RDD over the columnar memory store.  `selected` is the list of
    partition indices that survived map pruning — the master simply does not
    create tasks for pruned partitions (§3.5)."""

    def __init__(self, ctx, table: Table, columns: Optional[Sequence[str]] = None,
                 selected: Optional[List[int]] = None):
        self.table = table
        self.columns = list(columns) if columns is not None else None
        self.selected = selected if selected is not None \
            else list(range(table.num_partitions))
        super().__init__(ctx, len(self.selected), [])

    def compute(self, split: int, tc: TaskContext) -> PartitionBatch:
        part = self.table.partitions[self.selected[split]]
        part.touch()    # access recency drives coldest-first spill (§12)
        return PartitionBatch.from_partition(part, self.columns)


class ParallelCollectionRDD(RDD):
    def __init__(self, ctx, batches: List[PartitionBatch]):
        self.batches = batches
        super().__init__(ctx, len(batches), [])

    def compute(self, split: int, tc: TaskContext) -> PartitionBatch:
        return self.batches[split]


class MapPartitionsRDD(RDD):
    def __init__(self, parent: RDD, f: Callable[[int, PartitionBatch], PartitionBatch]):
        self.f = f
        super().__init__(parent.ctx, parent.num_partitions,
                         [OneToOneDependency(parent)])

    def compute(self, split: int, tc: TaskContext) -> PartitionBatch:
        parent = self.deps[0].parent
        return self.f(split, parent.iterator(split, tc))


class ZipPartitionsRDD(RDD):
    """Narrow two-parent dependency — the co-partitioned join (§3.4) compiles
    to this: corresponding partitions join with *no shuffle*."""

    def __init__(self, left: RDD, right: RDD,
                 f: Callable[[int, PartitionBatch, PartitionBatch], PartitionBatch]):
        assert left.num_partitions == right.num_partitions, \
            "zip requires equal partitioning"
        self.f = f
        super().__init__(left.ctx, left.num_partitions,
                         [OneToOneDependency(left), OneToOneDependency(right)])

    def compute(self, split: int, tc: TaskContext) -> PartitionBatch:
        l = self.deps[0].parent.iterator(split, tc)
        r = self.deps[1].parent.iterator(split, tc)
        return self.f(split, l, r)


class ShuffledRDD(RDD):
    """Reduce side of a shuffle.  Each split fetches its bucket group from
    every map task's materialized output (memory-based shuffle, §5), then
    applies `reduce_fn` (e.g. final aggregation or the reduce-side join).

    `bucket_groups` defaults to the identity [ [0], [1], ... ]; PDE's
    coalescing replaces it with greedy-bin-packed groups of fine-grained
    buckets (§3.1.2).
    """

    def __init__(self, dep: ShuffleDependency,
                 bucket_groups: Optional[List[List[int]]] = None,
                 reduce_fn: Optional[Callable[[int, PartitionBatch], PartitionBatch]] = None):
        self.dep = dep
        self.bucket_groups = bucket_groups if bucket_groups is not None \
            else [[b] for b in range(dep.num_buckets)]
        self.reduce_fn = reduce_fn
        super().__init__(dep.parent.ctx, len(self.bucket_groups), [dep])

    def compute(self, split: int, tc: TaskContext) -> PartitionBatch:
        buckets = self.bucket_groups[split]
        pieces = self.ctx.block_manager.fetch_shuffle(
            self.dep.shuffle_id, self.dep.parent.num_partitions, buckets)
        merged = PartitionBatch.concat(pieces)
        if self.reduce_fn is not None:
            merged = self.reduce_fn(split, merged)
        return merged


class PipelinedShuffledRDD(ShuffledRDD):
    """ShuffledRDD whose splits may already have been computed by the
    pipelined scheduler (DESIGN.md §14): `Scheduler.run_map_stage_pipelined`
    ran the reduce concurrently with the map stage and deposits the results
    here via `offer_precomputed`.  `compute` consumes each precomputed
    result exactly once — speculative re-runs and lineage recomputes of the
    same split fall through to the ordinary fetch-from-blocks path, which
    yields an identical batch because reduce tasks are deterministic."""

    def __init__(self, dep: ShuffleDependency,
                 bucket_groups: Optional[List[List[int]]] = None,
                 reduce_fn: Optional[Callable[[int, PartitionBatch],
                                              PartitionBatch]] = None):
        super().__init__(dep, bucket_groups, reduce_fn)
        self._precomputed: Dict[int, PartitionBatch] = {}
        self._pre_lock = threading.Lock()
        self.pipelined_hits = 0

    def offer_precomputed(self, results: Dict[int, PartitionBatch]) -> None:
        with self._pre_lock:
            self._precomputed.update(results)

    def compute(self, split: int, tc: TaskContext) -> PartitionBatch:
        with self._pre_lock:
            hit = self._precomputed.pop(split, None)
            if hit is not None:
                self.pipelined_hits += 1
        if hit is not None:
            return hit
        return super().compute(split, tc)


class UnionRDD(RDD):
    def __init__(self, parents: List[RDD]):
        self.offsets = []
        total = 0
        deps = []
        for p in parents:
            self.offsets.append(total)
            total += p.num_partitions
            deps.append(OneToOneDependency(p))
        super().__init__(parents[0].ctx, total, deps)
        self.parents = parents

    def compute(self, split: int, tc: TaskContext) -> PartitionBatch:
        for p, off in zip(self.parents, self.offsets):
            if split < off + p.num_partitions:
                return p.iterator(split - off, tc)
        raise IndexError(split)


def lineage_string(rdd: RDD, indent: int = 0) -> str:
    """Debug view of the lineage graph (Figure 3 of the paper)."""
    pad = "  " * indent
    lines = [f"{pad}{rdd!r}{' [cached]' if rdd.cached else ''}"]
    for d in rdd.deps:
        kind = type(d).__name__
        lines.append(f"{pad} <-{kind}")
        lines.append(lineage_string(d.parent, indent + 1))
    return "\n".join(lines)
