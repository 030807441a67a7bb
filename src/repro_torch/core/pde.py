"""Partial DAG Execution (paper §3.1) — the paper's central contribution.

The query plan DAG is *altered while the query runs*, based on statistics
gathered at shuffle boundaries:

  §3.1.1 Join optimization — run the pre-shuffle map stages, observe the
  materialized sizes, then choose: map (broadcast) join if one side is small,
  else shuffle join.  With a prior that one side will be small (e.g. a
  filtered dimension table), pre-shuffle ONLY that side first and skip the
  big table's map stage entirely when the broadcast decision lands (the 3x
  win of §6.3.2).

  §3.1.2 Degree of parallelism & skew — coalesce many fine-grained map
  buckets into fewer reduce partitions by greedy bin-packing on observed
  bucket sizes, equalizing reducer load.

Decisions are pure functions of StageStats, so they are unit-testable and
the dry-run can replay them.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np

from .stats import StageStats, choose_num_reducers, greedy_bin_pack


class JoinChoice(enum.Enum):
    SHUFFLE = "shuffle"
    BROADCAST_LEFT = "broadcast_left"    # left side is small -> broadcast it
    BROADCAST_RIGHT = "broadcast_right"


@dataclasses.dataclass
class PDEConfig:
    # broadcast threshold: map-join if one side's observed materialized size
    # is below this (Hive's default autoconvert threshold era: tens of MB).
    broadcast_threshold_bytes: float = 32 << 20
    # target bytes per reduce task when coalescing
    target_reduce_bytes: float = 64 << 20
    min_reducers: int = 1
    max_reducers: int = 4096
    # skew: a bucket this many times the mean is "skewed"
    skew_factor: float = 4.0
    # -- compiled pipeline segments (DESIGN.md §10) --------------------------
    # below this row count the compiled (torch) dispatch overhead outweighs
    # the fused kernel: evaluate the partition with the numpy oracle instead
    segment_min_compiled_rows: int = 64
    # CUDA kernels (colscan / fused_decode_scan / groupby_mxu) only beat
    # the generic compiled segment on partitions at least this large
    segment_kernel_min_rows: int = 4096
    # group-by keys with more distinct values than this stay on the
    # sort/segment-sum path (one-hot matmul tiles scale with NDV)
    segment_groupby_max_ndv: int = 512
    # a kernel's plain version on CPU is a correctness tool, not a fast
    # path: kernels are only routed to on a CUDA device unless forced
    # (tests force this to exercise the kernel routes on CPU)
    segment_force_kernels: bool = False
    # -- compiled exchange / reduce side (DESIGN.md §11) ---------------------
    # below this many partial-state rows the reduce-side merge / join probe
    # runs the interpreted numpy oracle (dispatch dominates tiny bucket
    # groups); at or above it, the compiled reduce kernels
    reduce_min_compiled_rows: int = 2048
    # force the compiled reduce path regardless of size (differential tests
    # drive the oracle grid with this on and off)
    reduce_force_compiled: bool = False
    # -- whole-stage fusion (DESIGN.md §14) ----------------------------------
    # below this many rows the fused stage program gains nothing over the
    # segment-at-a-time path (the partition routes to the numpy oracle
    # anyway); partitions at/above it fuse map-side work and bucketing into
    # the stage program when the session allows
    stage_fusion_min_rows: int = 64
    # the pipelined map→reduce overlap adds one runnable thread per reduce
    # split; it can only shorten the critical path when the executor pool
    # keeps at least this many slots free of map tasks — a saturated pool
    # means the overlap thread steals time from the maps (GIL + block-store
    # lock convoy), so the boundary falls back to the sequential pull fetch
    pipeline_reduce_slack_threads: int = 1
    # -- compressed-domain execution (DESIGN.md §12) -------------------------
    # evaluate range predicates on frame-of-reference codes and run-level
    # predicates/aggregates on RLE runs without widening the column; off
    # forces the decode-then-evaluate routes (differential tests drive the
    # oracle grid both ways)
    compressed_domain: bool = True


@dataclasses.dataclass
class JoinDecision:
    choice: JoinChoice
    left_bytes: float
    right_bytes: float
    reason: str


def decide_join(left_stats: Optional[StageStats],
                right_stats: Optional[StageStats],
                cfg: PDEConfig = PDEConfig()) -> JoinDecision:
    """§3.1.1: pick join strategy from observed (or partially observed)
    map-output sizes.  Either side's stats may be missing when the optimizer
    scheduled only the likely-small side first."""
    lb = left_stats.total_output_bytes() if left_stats else float("inf")
    rb = right_stats.total_output_bytes() if right_stats else float("inf")
    if lb <= cfg.broadcast_threshold_bytes and lb <= rb:
        return JoinDecision(JoinChoice.BROADCAST_LEFT, lb, rb,
                            f"left observed {lb:.0f}B <= "
                            f"{cfg.broadcast_threshold_bytes:.0f}B threshold")
    if rb <= cfg.broadcast_threshold_bytes:
        return JoinDecision(JoinChoice.BROADCAST_RIGHT, lb, rb,
                            f"right observed {rb:.0f}B <= "
                            f"{cfg.broadcast_threshold_bytes:.0f}B threshold")
    return JoinDecision(JoinChoice.SHUFFLE, lb, rb,
                        "both sides above broadcast threshold")


@dataclasses.dataclass
class ParallelismDecision:
    num_reducers: int
    bucket_groups: List[List[int]]
    skewed_buckets: List[int]
    reason: str


def decide_parallelism(stats: StageStats, num_buckets: int,
                       cfg: PDEConfig = PDEConfig()) -> ParallelismDecision:
    """§3.1.2: choose the reduce degree of parallelism at run time by
    coalescing fine-grained buckets with greedy bin-packing, equalizing
    coalesced partition sizes."""
    sizes = stats.output_bytes_per_bucket(num_buckets)
    n = choose_num_reducers(sizes, cfg.target_reduce_bytes,
                            cfg.min_reducers,
                            min(cfg.max_reducers, num_buckets))
    groups = greedy_bin_pack(sizes.tolist(), n)
    groups = [g for g in groups if g]  # drop empty bins
    mean = float(sizes.mean()) if len(sizes) else 0.0
    skewed = [i for i, s in enumerate(sizes.tolist())
              if mean > 0 and s > cfg.skew_factor * mean]
    return ParallelismDecision(
        len(groups), groups, skewed,
        f"total {sizes.sum():.0f}B -> {len(groups)} reducers "
        f"(target {cfg.target_reduce_bytes:.0f}B each), "
        f"{len(skewed)} skewed buckets bin-packed")


# ---------------------------------------------------------------------------
# Skew-aware shuffle-join splitting (§3.1.2, "data skew" paragraph).
#
# Bin-packing equalizes reducer loads only down to the granularity of one
# hash bucket; a heavy-hitter join key puts its whole bucket on one reducer
# no matter how buckets are grouped.  The runtime fix: *split* a skewed
# bucket's probe-side rows across several reducers and replicate the other
# (build) side's bucket to each — every probe row still meets every matching
# build row exactly once, so the join is unchanged but the hot key's work is
# parallelized.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SkewShard:
    """One reduce split handling 1/num_shards of a skewed bucket: the
    `shard_side` input's bucket is partitioned across shards at MAP-OUTPUT
    granularity (shard s reads map tasks s, s+num_shards, ... — each map
    output is read exactly once across shards, so splitting adds no fetch
    amplification on the big side); the other side's bucket is replicated
    to every shard (broadcast-within-bucket)."""
    bucket: int
    shard: int
    num_shards: int
    shard_side: str  # "left" | "right": the probe side being partitioned


@dataclasses.dataclass
class SkewJoinDecision:
    """Reduce-side plan of one shuffle-join boundary: plain bin-packed
    bucket groups plus SkewShard splits for heavy-hitter buckets."""
    splits: List[object]            # List[int] group | SkewShard
    skewed_buckets: List[int]
    num_reducers: int
    hot_keys: List[object]          # merged heavy-hitter sketch (top keys)
    reason: str


def _skew_side_maps(lsz, rsz, b: int, how: str,
                    left_maps: Optional[int],
                    right_maps: Optional[int]) -> int:
    """Map-task count of the side that would be sharded for bucket `b` —
    the upper bound on how many ways the bucket can split."""
    if how == "inner":
        side_maps = left_maps if lsz[b] >= rsz[b] else right_maps
    else:
        side_maps = left_maps
    return side_maps if side_maps is not None else 1 << 30


def decide_skew_join(left_stats: StageStats, right_stats: StageStats,
                     num_buckets: int, how: str = "inner",
                     cfg: PDEConfig = PDEConfig(),
                     left_maps: Optional[int] = None,
                     right_maps: Optional[int] = None) -> SkewJoinDecision:
    """§3.1.2 applied to joins: bin-pack the well-behaved buckets, split the
    skewed ones.  A bucket is skewed when its combined materialized size
    exceeds `skew_factor`× the mean AND the reducer byte target (splitting
    tiny buckets only adds task overhead).  Shards partition the probe side
    at map-output granularity, so a bucket splits at most as many ways as
    its probe side has map tasks.  For outer joins only the preserved
    (left) side may be strided — striding the NULL-padding side would
    duplicate unmatched left rows per shard."""
    lsz = left_stats.output_bytes_per_bucket(num_buckets)
    rsz = right_stats.output_bytes_per_bucket(num_buckets)
    combined = lsz + rsz
    mean = float(combined.mean()) if num_buckets else 0.0
    skewed = [b for b in range(num_buckets)
              if mean > 0 and combined[b] > cfg.skew_factor * mean
              and combined[b] > cfg.target_reduce_bytes
              and _skew_side_maps(lsz, rsz, b, how, left_maps,
                                  right_maps) >= 2]
    skew_set = set(skewed)
    normal = [b for b in range(num_buckets) if b not in skew_set]

    splits: List[object] = []
    if normal:
        sizes = combined[normal]
        n = choose_num_reducers(sizes, cfg.target_reduce_bytes,
                                cfg.min_reducers,
                                min(cfg.max_reducers, len(normal)))
        groups = greedy_bin_pack(sizes.tolist(), n)
        splits.extend([[normal[i] for i in g] for g in groups if g])

    for b in skewed:
        if how == "inner":
            side = "left" if lsz[b] >= rsz[b] else "right"
        else:
            side = "left"
        cap = _skew_side_maps(lsz, rsz, b, how, left_maps, right_maps)
        num_shards = max(2, int(np.ceil(combined[b]
                                        / cfg.target_reduce_bytes)))
        num_shards = min(num_shards, cfg.max_reducers, cap)
        splits.extend(SkewShard(b, s, num_shards, side)
                      for s in range(num_shards))

    hot = list(left_stats.heavy_hitters(4)) + list(right_stats.heavy_hitters(4))
    reason = (f"{combined.sum():.0f}B over {num_buckets} buckets -> "
              f"{len(splits)} reducers; {len(skewed)} skewed bucket(s) "
              f"split" + (f" (hot keys {hot[:4]})" if skewed and hot else ""))
    return SkewJoinDecision(splits, skewed, len(splits), hot, reason)


# ---------------------------------------------------------------------------
# Compiled-segment backend selection (DESIGN.md §10).
#
# Every pipeline segment executes per partition, and each partition picks
# its evaluation engine at run time from what the columnar store knows about
# it: row count, per-column encodings, and group-key NDV — the same
# piggybacked statistics map pruning uses (§3.3/§3.5).  Pure function of its
# inputs, so unit-testable and replayable, like the join/parallelism
# decisions above.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SegmentBackendDecision:
    route: str        # numpy | jit | colscan | fused_decode_scan | groupby_mxu
    reason: str


def decide_segment_backend(num_rows: int,
                           kernel_eligible: Optional[str] = None,
                           group_ndv: Optional[int] = None,
                           on_gpu: bool = False,
                           cfg: PDEConfig = PDEConfig()
                           ) -> SegmentBackendDecision:
    """Choose how one partition of a pipeline segment executes.

    `kernel_eligible` names the CUDA kernel the segment's shape could
    lower to (decided by the executor from the plan: range-filter+aggregate
    -> colscan / fused_decode_scan, small-group aggregate -> groupby_mxu);
    this function decides whether the partition should actually take it."""
    if num_rows < cfg.segment_min_compiled_rows:
        return SegmentBackendDecision(
            "numpy", f"{num_rows} rows < {cfg.segment_min_compiled_rows} "
            "compiled threshold")
    if kernel_eligible is not None:
        if (kernel_eligible == "groupby_mxu" and group_ndv is not None
                and group_ndv > cfg.segment_groupby_max_ndv):
            return SegmentBackendDecision(
                "jit", f"group NDV {group_ndv} > "
                f"{cfg.segment_groupby_max_ndv}: sort/segment-sum path")
        if num_rows < cfg.segment_kernel_min_rows:
            return SegmentBackendDecision(
                "jit", f"{num_rows} rows < {cfg.segment_kernel_min_rows} "
                "kernel threshold")
        if on_gpu or cfg.segment_force_kernels:
            return SegmentBackendDecision(
                kernel_eligible,
                f"{num_rows} rows, kernel-shaped segment -> "
                f"{kernel_eligible}"
                + ("" if on_gpu else " (forced: plain version on CPU)"))
        return SegmentBackendDecision(
            "jit", "kernel-shaped but no GPU: the kernel's plain version is a "
            "correctness tool, the fused compiled segment is the CPU fast "
            "path")
    return SegmentBackendDecision("jit", f"{num_rows} rows -> fused jit")


def decide_reduce_backend(num_rows: int,
                          kernel_eligible: Optional[str] = None,
                          group_ndv: Optional[int] = None,
                          on_gpu: bool = False,
                          cfg: PDEConfig = PDEConfig()
                          ) -> SegmentBackendDecision:
    """Reduce-side twin of `decide_segment_backend` (DESIGN.md §11): choose
    how one reduce task's merge-aggregate or join probe executes.

    `num_rows` is the task's fetched input size (partial-state rows for a
    merge, combined build+probe rows for a join).  `kernel_eligible` names
    the CUDA kernel the shape could lower to (`segmented_merge` for
    float-state merges with modest group cardinality).  Routing: tiny
    bucket groups always stay on the numpy oracle; on a GPU (or forced)
    the compiled/kernel reduce runs, but on CPU numpy is the fast path —
    after dictionary compaction the reduce states are small host-resident
    arrays (DESIGN.md §11)."""
    if not cfg.reduce_force_compiled \
            and num_rows < cfg.reduce_min_compiled_rows:
        return SegmentBackendDecision(
            "numpy", f"{num_rows} rows < {cfg.reduce_min_compiled_rows} "
            "reduce compiled threshold")
    if not (on_gpu or cfg.reduce_force_compiled):
        return SegmentBackendDecision(
            "numpy", "no GPU: host numpy is the reduce fast path "
            "(compiled reduce engages on a GPU or when forced)")
    if kernel_eligible is not None and (on_gpu or cfg.segment_force_kernels):
        if (group_ndv is not None
                and group_ndv > cfg.segment_groupby_max_ndv):
            return SegmentBackendDecision(
                "jit", f"group NDV {group_ndv} > "
                f"{cfg.segment_groupby_max_ndv}: compiled segmented reduce")
        return SegmentBackendDecision(
            kernel_eligible,
            f"{num_rows} rows, kernel-shaped reduce -> {kernel_eligible}"
            + ("" if on_gpu else " (forced: plain version on CPU)"))
    return SegmentBackendDecision(
        "jit", f"{num_rows} rows -> compiled reduce")


def decide_train_backend(num_rows: int, dims: int,
                         kernel_eligible: Optional[str] = None,
                         on_gpu: bool = False,
                         cfg: PDEConfig = PDEConfig()
                         ) -> SegmentBackendDecision:
    """Training twin of `decide_segment_backend` (DESIGN.md §15): choose how
    one cached feature partition computes its per-iteration statistics
    (gradient / centroid assignment).

    `kernel_eligible` names the CUDA kernel the algorithm's update shape
    could lower to (`train_grad` for logistic/linear gradients — the
    groupby_mxu-style tiled-partials kernel); k-means assignment has no
    kernel form yet and passes None.  Routing mirrors the segment rule:
    tiny partitions stay on the numpy oracle (jit dispatch dominates), the
    kernel engages on a GPU or when forced and the partition is large enough,
    and the fused assemble+train jit — which decodes DICT/FOR/BITPACK/RLE
    feature blocks in-trace — is the default compiled path."""
    if num_rows < cfg.segment_min_compiled_rows:
        return SegmentBackendDecision(
            "numpy", f"{num_rows} rows < {cfg.segment_min_compiled_rows} "
            "compiled threshold: numpy oracle gradient")
    if kernel_eligible is not None:
        if num_rows < cfg.segment_kernel_min_rows:
            return SegmentBackendDecision(
                "jit", f"{num_rows} rows < {cfg.segment_kernel_min_rows} "
                "kernel threshold")
        if on_gpu or cfg.segment_force_kernels:
            return SegmentBackendDecision(
                kernel_eligible,
                f"{num_rows}x{dims} partition, gradient-shaped update -> "
                f"{kernel_eligible}"
                + ("" if on_gpu else " (forced: plain version on CPU)"))
        return SegmentBackendDecision(
            "jit", "kernel-shaped but no GPU: the kernel's plain version is a "
            "correctness tool, the fused assemble+train jit is the CPU "
            "fast path")
    return SegmentBackendDecision(
        "jit", f"{num_rows}x{dims} partition -> fused assemble+train jit")


def decide_stage_fusion(num_rows: int, mode: str = "on",
                        backend: str = "compiled", exchange: str = "coded",
                        cfg: PDEConfig = PDEConfig()
                        ) -> SegmentBackendDecision:
    """Whole-stage fusion decision (DESIGN.md §14): should this partition's
    map-side work run as ONE fused stage program — segment + partial
    aggregate + radix bucketing with no host seam before the shuffle — or
    stay on the segment-at-a-time path?

    Routes: "whole-stage" or "segment".  The fused program requires the
    compiled backend and the dictionary-preserving exchange (the decoded
    exchange re-materializes strings between the segment and the shuffle,
    a host seam by definition); `mode="force"` bypasses the row threshold
    (differential tests drive the oracle grid with it), `mode="off"` is
    the semantic-oracle escape hatch."""
    if mode == "off":
        return SegmentBackendDecision("segment", "stage fusion disabled")
    if backend != "compiled":
        return SegmentBackendDecision(
            "segment", "numpy backend: the interpreted oracle keeps every "
            "host seam")
    if exchange != "coded":
        return SegmentBackendDecision(
            "segment", "decoded exchange re-materializes strings before "
            "the shuffle: host seam required")
    if mode != "force" and num_rows < cfg.stage_fusion_min_rows:
        return SegmentBackendDecision(
            "segment", f"{num_rows} rows < {cfg.stage_fusion_min_rows} "
            "stage-fusion threshold")
    return SegmentBackendDecision(
        "whole-stage", f"{num_rows} rows -> fused stage program")


def decide_pipelined_reduce(num_map_splits: int, max_threads: int,
                            mode: str = "on",
                            cfg: PDEConfig = PDEConfig()
                            ) -> SegmentBackendDecision:
    """Should a single-bucket boundary start its reduce DURING the map stage
    (DESIGN.md §14)?  The overlap is an admission decision: the reduce runs
    as an extra runnable thread, so it only shortens the critical path when
    the executor pool has slots the map stage is not using — on a pool the
    map splits saturate, the thread can only steal time from the maps.
    Routes: "pipelined" or "pull".  `mode="force"` bypasses the slack check
    (the §14 chaos/differential tiers drive the overlap machinery
    deterministically at any scale)."""
    if mode == "force":
        return SegmentBackendDecision(
            "pipelined", "stage fusion forced -> overlapped reduce")
    slack = max_threads - num_map_splits
    if slack >= cfg.pipeline_reduce_slack_threads:
        return SegmentBackendDecision(
            "pipelined", f"{slack} spare pool threads -> overlapped reduce")
    return SegmentBackendDecision(
        "pull", f"{num_map_splits} map splits saturate {max_threads} pool "
        "threads -> sequential fetch")


def likely_small_side(left_hint_bytes: Optional[float],
                      right_hint_bytes: Optional[float],
                      left_filtered: bool, right_filtered: bool) -> Optional[str]:
    """Static prior used to order pre-shuffle stages (§6.3.2): a side that is
    initially smaller AND carries a filter predicate is likely to come out
    small, so schedule its map stage first and hope to skip the other side's
    pre-shuffle entirely."""
    def score(hint, filtered):
        s = 0.0
        if filtered:
            s += 1.0
        if hint is not None:
            s += 1.0 / (1.0 + hint / (64 << 20))
        return s
    ls, rs = score(left_hint_bytes, left_filtered), score(right_hint_bytes, right_filtered)
    if ls == rs:
        if left_hint_bytes is not None and right_hint_bytes is not None:
            return "left" if left_hint_bytes <= right_hint_bytes else "right"
        return None
    return "left" if ls > rs else "right"
