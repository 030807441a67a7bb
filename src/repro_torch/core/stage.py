"""Whole-stage compilation v2 (DESIGN.md §14).

A StageRunner drives ONE map stage — scan→filter→project→radix_partition→
map-side aggregate — as a single program per partition, without
returning to host between the compiled segment and the shuffle:

  * the segment + partial aggregate run through the SegmentRunner's routed
    backends (colscan / groupby_mxu kernels / compiled torch segment),
    exactly as the
    segment-at-a-time path would;
  * the bucket assignment (the SAME partitioner closure the scheduler would
    call) and the per-bucket slicing (the scheduler's exact stable-argsort /
    searchsorted / take code, via `split_bucket_pieces`) run inside the map
    task, so the task hands the scheduler a `BucketedBatch` of finished
    shuffle pieces — byte-identical to the blocks the seam-by-seam path
    produces, including under lineage recovery (tasks are deterministic);
  * sort/limit stages ship their single-reducer output as a zero-copy
    one-piece BucketedBatch — no host re-assembly copy for pass-through
    columns (the BENCH_exec_engine "transfer-bound" seam).

Fallback ladder (any rung keeps results identical):
  1. PDE gate (`decide_stage_fusion`): numpy backend, decoded exchange,
     `stage_fusion="off"`, or a partition under the row threshold → the
     unfused segment-at-a-time path;
  2. the routed segment itself picks the numpy oracle (tiny partition or
     ExprCompileError fallback) → the plain batch is returned and the
     scheduler applies the legacy partition/slice seam;
  3. anything downstream (pipelined reduce failure, worker death) falls
     back to pull-based reduces over the same shuffle blocks.

Fusion is physical-layer only: `explain()` and `plan_fingerprint` never see
it (asserted by the §14 test tier).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .batch import PartitionBatch
from .pde import PDEConfig, decide_segment_backend, decide_stage_fusion
from .plan import AggSpec
from .shuffle import BucketedBatch, split_bucket_pieces


class StageRunner:
    """Fused map-stage driver wrapping one SegmentRunner (physical.py)."""

    def __init__(self, runner, partitioner: Callable, num_buckets: int,
                 mode: str, cfg: PDEConfig, topk=None):
        self.runner = runner
        self.partitioner = partitioner
        self.num_buckets = num_buckets
        self.mode = mode                     # "on" | "force"
        self.cfg = cfg
        # (lane columns, query weights) when the sort stage's key is a
        # dot-product similarity score (physical._match_topk): partitions
        # the PDE routes there take the topk_similarity kernel
        # (DESIGN.md §15.3)
        self.topk = topk

    def _gate(self, num_rows: int) -> bool:
        d = decide_stage_fusion(num_rows, self.mode, self.runner.backend,
                                "coded", self.cfg)
        return d.route == "whole-stage"

    # -- aggregate stages ----------------------------------------------------

    def run_aggregate_stage(self, batch: PartitionBatch,
                            group_cols: Sequence[str],
                            aggs: Sequence[AggSpec]):
        """Segment + partial aggregate + bucketing, one stage program.
        Returns a BucketedBatch of finished shuffle pieces, or a plain
        batch when a fallback rung kept the host seam."""
        if not self._gate(batch.num_rows):
            return self.runner.run_aggregate(batch, group_cols, aggs)
        out, route = self.runner._aggregate_routed(
            batch, group_cols, aggs, fused=True,
            force_compiled=(self.mode == "force"))
        if route == "numpy":
            return out          # oracle fallback: scheduler applies the seam
        bucket_of = self.partitioner(out)
        return BucketedBatch(
            split_bucket_pieces(out, bucket_of, self.num_buckets))

    # -- sort / limit stages (single-reducer boundaries) ---------------------

    def run_sort_stage(self, batch: PartitionBatch,
                       keys: List[Tuple[str, bool]],
                       limit: Optional[int]):
        """Segment + per-partition top-k; the sorted prefix ships as one
        zero-copy piece (single reducer) — no host-assembly copy.

        Similarity-scored stages (self.topk set) route eligible partitions
        to the topk_similarity kernel: per-tile ranking plus pairwise
        merges select the same rows, in the same order, as the lexsort
        oracle (ties broken by row index, both paths)."""
        if not self._gate(batch.num_rows):
            b = self.runner.run(batch)
            return b.take(self._sort_limit_indices(b, keys, limit))
        b, route = self.runner.run_routed(batch, fused=True)
        b = b.take(self._sort_limit_indices(b, keys, limit))
        if route == "numpy":
            return b
        return BucketedBatch([b])

    def _sort_limit_indices(self, b: PartitionBatch,
                            keys: List[Tuple[str, bool]],
                            limit: Optional[int]) -> np.ndarray:
        from .physical import _sort_indices
        if self.topk is not None and limit is not None and b.num_rows:
            idx = self._topk_kernel_indices(b, limit)
            if idx is not None:
                return idx
        idx = _sort_indices(b, keys)
        if limit is not None:
            idx = idx[:limit]
        return idx

    def _topk_kernel_indices(self, b: PartitionBatch,
                             k: int) -> Optional[np.ndarray]:
        """Row indices of the top-k similarity candidates via the
        topk_similarity kernel, or None when the PDE routes this partition
        to the host lexsort.  The lane columns are the runner's device
        tensors (block-backed lanes from their memoized device copies):
        read in place by `topk_similarity_lanes` when they qualify
        (`search_route` "lanes"), else stacked ("stacked"); the route is
        counted in `topk_similarity.ROUTES`."""
        import torch

        from ..kernels import ops
        from ..kernels import topk_similarity as tk
        from ..kernels._common import count_launch
        d = decide_segment_backend(b.num_rows, "topk_similarity", None,
                                   ops.on_gpu(self.runner.device), self.cfg)
        if d.route != "topk_similarity":
            return None
        lanes, weights = self.topk
        cols = [b.col(n) for n in lanes]
        if any(c.is_string for c in cols):
            return None
        ts = [self.runner._tensor(c) for c in cols]
        route = tk.search_route(ts)
        count_launch(tk.ROUTES, route)
        if route == "lanes":
            _scores, idx = tk.lanes_checked(ts, weights, k)
        else:
            if not all(t.dtype == ts[0].dtype for t in ts) \
                    or ts[0].dtype not in (torch.float32, torch.float64):
                # the kernel reads float32 or float64 lanes; other lanes
                # widen exactly to float64 (integers below 2**53)
                ts = [t.to(torch.float64) for t in ts]
            x = torch.stack(ts, dim=1)
            q = torch.from_numpy(np.asarray(weights, np.float64)).to(
                x.device)
            _scores, idx = ops.topk_similarity(x, q, k)
        self.runner._note_route("topk_similarity")
        return idx.cpu().numpy()

    def run_limit_stage(self, batch: PartitionBatch, n: int):
        """Segment + head(n), shipped as one zero-copy piece: surviving
        columns stay encoded end-to-end into the shuffle block — the
        pass-through seam fix (ISSUE 8 satellite)."""
        if not self._gate(batch.num_rows):
            return self.runner.run(batch).head(n)
        b, route = self.runner.run_routed(batch, fused=True)
        b = b.head(n)
        if route == "numpy":
            return b
        return BucketedBatch([b])
