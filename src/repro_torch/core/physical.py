"""Physical plan compilation and PDE-driven execution (paper §2.4, §3).

The logical plan compiles into RDD transformations (not MapReduce jobs).
Narrow chains (scan -> filter -> project -> partial aggregate -> local limit)
pipeline inside one task; blocking shuffle boundaries become explicit stages
the scheduler runs one at a time, which is where Partial DAG Execution
re-plans:

  * AGGREGATE: map stage materializes partial aggregates per hash bucket
    while gathering size stats; PDE coalesces buckets into the right number
    of reducers by greedy bin-packing (§3.1.2).
  * JOIN (AUTO): the optimizer orders pre-shuffle stages by the static
    "likely small" prior (§6.3.2), observes materialized sizes, and either
    broadcasts the small side (map join — the large table is never
    pre-shuffled) or falls back to a shuffle join with aligned buckets.
  * Map pruning (§3.5) removes partitions refuted by per-partition stats
    before ANY task launches.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .aggregate import (CompiledMerge, combine_colscan_stats, group_indices,
                        merge_aggregate, partial_aggregate)
from .batch import PartitionBatch
from .catalog import Catalog
from .columnar import Table
from .expr import (_FLIP_CMP, Between, BinOp, Cmp, Col, ColumnVal,
                   CompiledExprSet, Expr, ExprCompileError, Lit,
                   evaluate, split_conjuncts, to_tensor)
from .joins import broadcast_join, compile_probe, join_local
from .pde import (JoinChoice, PDEConfig, SkewShard, decide_join,
                  decide_parallelism, decide_pipelined_reduce,
                  decide_reduce_backend, decide_segment_backend,
                  decide_skew_join, decide_stage_fusion, likely_small_side)
from .plan import (AggFunc, AggregateNode, AggSpec, FilterNode, JoinNode,
                   JoinStrategy, LimitNode, Node, PipelineSegment,
                   ProjectNode, ScanNode, SortNode, fold_pipeline, optimize,
                   required_columns)
from .pruning import may_match
from .rdd import (RDD, MapPartitionsRDD, PipelinedShuffledRDD,
                  ShuffleDependency, ShuffledRDD, TaskContext,
                  ZipPartitionsRDD)
from .runtime import SharkContext
from .shuffle import (BucketedBatch, bucket_by_composite, bucket_by_hash,
                      single_bucket, split_bucket_pieces)
from .stats import (HeavyHitterAccumulator, SizeAccumulator, StageStats,
                    block_ndv)
from .types import DType
from ..kernels.colscan import colscan_plain
from ..kernels.groupby_mxu import groupby_sum_plain


@dataclasses.dataclass
class ExecResult:
    batches: List[PartitionBatch]
    schema_names: List[str]
    # the executing Executor's per-query ExecMetrics — attached by the
    # server tier, where the executor itself is not reachable from a handle
    metrics: Optional["ExecMetrics"] = None

    def to_numpy(self) -> Dict[str, np.ndarray]:
        merged = PartitionBatch.concat(self.batches)
        return merged.decoded()

    @property
    def num_rows(self) -> int:
        return sum(b.num_rows for b in self.batches)


@dataclasses.dataclass
class JoinBoundaryDecision:
    """What PDE actually chose at ONE join shuffle boundary — recorded in
    execution order so tests (and explain tooling) can assert the runtime
    re-planning: strategy per boundary, observed sizes, reducer count, and
    any skew splits."""
    boundary: int                   # 0-based, in execution order
    strategy: str                   # broadcast | shuffle | copartition | empty
    build_side: Optional[str]       # broadcast: which input was broadcast
    # bytes per side: observed map-output sizes where the strategy
    # materialized them (broadcast small side, shuffle both sides);
    # catalog/hint estimates otherwise (copartition zips without
    # materializing anything, so there is nothing observed to report)
    left_bytes: float
    right_bytes: float
    num_reducers: int
    skewed_buckets: List[int]
    skew_shards: int                # total SkewShard reduce splits
    hot_keys: List[object]
    reason: str

    def describe(self) -> str:
        extra = ""
        if self.strategy == "broadcast":
            extra = f" build={self.build_side}"
        if self.skew_shards:
            extra += (f" skew={len(self.skewed_buckets)}bucket(s)/"
                      f"{self.skew_shards}shards hot={self.hot_keys[:2]}")
        return (f"join#{self.boundary}: {self.strategy}{extra} "
                f"l={self.left_bytes:.0f}B r={self.right_bytes:.0f}B "
                f"reducers={self.num_reducers}")


@dataclasses.dataclass
class SegmentRecord:
    """Runtime record of ONE PipelineSegment: which logical operators were
    fused, and — per executed partition — which backend route ran it
    (`numpy` oracle, generic compiled `jit`, or a CUDA kernel).  Updated by
    worker threads; counters are guarded by the owning runner's lock."""
    table: str
    depth: int                      # logical operators folded into the segment
    consumer: str                   # collect | aggregate | sort | limit
    outputs: List[str]
    pred: Optional[str]             # repr of the folded predicate
    partitions: int = 0
    rows_in: int = 0
    rows_out: int = 0
    bytes_in: float = 0.0
    routes: Dict[str, int] = dataclasses.field(default_factory=dict)
    fallbacks: int = 0              # ExprCompileError -> numpy fallbacks
    kept_code_cols: List[str] = dataclasses.field(default_factory=list)
    # whole-stage fusion (DESIGN.md §14): partitions whose map side ran as
    # ONE stage program — segment + partial aggregate + radix bucketing with
    # no host seam before the shuffle.  Keyed by the inner kernel route
    # (colscan / groupby_mxu / jit / ...) so kernel-routing assertions keep
    # holding; every count here is ALSO counted in `routes` above.
    fused_routes: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def compiled_partitions(self) -> int:
        return sum(n for r, n in self.routes.items() if r != "numpy")

    @property
    def fused_partitions(self) -> int:
        return sum(self.fused_routes.values())

    def describe(self) -> str:
        routes = ",".join(f"{r}:{n}" for r, n in sorted(self.routes.items()))
        fused = ""
        if self.fused_routes:
            fused = " whole-stage=" + ",".join(
                f"{r}:{n}" for r, n in sorted(self.fused_routes.items()))
        return (f"segment[{self.table}->{self.consumer} depth={self.depth}] "
                f"parts={self.partitions} rows={self.rows_in}->"
                f"{self.rows_out} routes={{{routes}}}{fused}")


@dataclasses.dataclass
class ExecMetrics:
    """Observable decisions, for tests and EXPERIMENTS.md."""
    pruned_partitions: int = 0
    scanned_partitions: int = 0
    join_decisions: List[str] = dataclasses.field(default_factory=list)
    reducer_decisions: List[str] = dataclasses.field(default_factory=list)
    pipeline_decisions: List[str] = dataclasses.field(default_factory=list)
    join_boundaries: List[JoinBoundaryDecision] = dataclasses.field(
        default_factory=list)
    shuffled_bytes: float = 0.0
    broadcast_bytes: float = 0.0
    # compiled vectorized execution (DESIGN.md §10)
    segments: List[SegmentRecord] = dataclasses.field(default_factory=list)
    # standalone interpreted filter/project operators, split by whether the
    # operator chain bottoms out at a table scan (the tentpole invariant:
    # the scan path never runs interpreted operator-at-a-time)
    interpreted_ops: int = 0
    interpreted_scan_ops: int = 0
    # storage tier (DESIGN.md §12): per-query deltas of the StorageManager
    # counters — partitions spilled / bytes written while this query ran,
    # spill segments read back, warm recompressions taken
    spills: int = 0
    spill_bytes: float = 0.0
    spill_reads: int = 0
    recompressions: int = 0
    # cluster tier (DESIGN.md §13): partitions whose map side ran on the
    # device mesh, mesh slots at dispatch, rows the cross-slot exchange
    # shipped off their source slot (no interconnect bytes when slots
    # share a card), and dispatches recomputed after a device loss
    mesh_partitions: int = 0
    mesh_devices: int = 0
    mesh_shipped_rows: int = 0
    mesh_retries: int = 0
    # compiled analytics tier (DESIGN.md §15): one entry per training
    # iteration — {"iteration", "seconds", "rows", "routes"} — appended by
    # ml.trainer.IterativeTrainer next to its per-iteration SegmentRecords
    train_iterations: List[Dict] = dataclasses.field(default_factory=list)
    # resilience tier (DESIGN.md §16): faults the chaos engine injected
    # while this query ran — (site, ordinal, kind) tuples, replayable via
    # FaultSchedule.replay — and the scheduler's recovery-counter deltas
    # (retries / backoffs / app_probes / fast_fails / reaps)
    fault_trips: List[Tuple[str, int, str]] = dataclasses.field(
        default_factory=list)
    resilience_events: Dict[str, int] = dataclasses.field(
        default_factory=dict)

    def describe_joins(self) -> str:
        """One line per join boundary, execution order — the runtime twin of
        the static explain() output."""
        return "\n".join(b.describe() for b in self.join_boundaries)

    def describe_segments(self) -> str:
        return "\n".join(s.describe() for s in self.segments)

    def segment_routes(self) -> Dict[str, int]:
        """Aggregate partition counts per backend route across segments.
        Partitions that ran as a fused stage program additionally appear
        under the synthetic `whole-stage` key (they keep their inner kernel
        route in the per-route counts — dual recording, DESIGN.md §14)."""
        out: Dict[str, int] = {}
        for s in self.segments:
            for r, n in s.routes.items():
                out[r] = out.get(r, 0) + n
            if s.fused_routes:
                out["whole-stage"] = (out.get("whole-stage", 0)
                                      + s.fused_partitions)
        return out

    def compiled_partitions(self) -> int:
        return sum(s.compiled_partitions for s in self.segments)

    def fused_partitions(self) -> int:
        """Partitions whose map stage ran as one fused stage program."""
        return sum(s.fused_partitions for s in self.segments)


def _bitpack_colscan(words, a, n: int, width: int, lo, hi):
    """Unpack+filter+aggregate for BITPACK filter columns: the packed
    words are unpacked to biased codes inside the function (per-lane
    shift/mask), compared against code bounds translated host-side (code =
    value - bias is order-preserving, same arithmetic as the FOR route),
    and the value column aggregated — the filter column never widens to its
    logical dtype.  Same [count, sum, min, max] contract as
    `colscan_plain`; the tail lanes of the last word read NaN, which fails
    both bounds.  Words arrive as int64 (torch has no CPU `>>` for
    uint32)."""
    import torch
    per_word = 32 // width
    shifts = torch.arange(per_word, dtype=torch.int64,
                          device=words.device) * width
    codes = ((words[:, None] >> shifts[None, :]) & ((1 << width) - 1))
    codes = codes.reshape(-1).to(torch.float64)
    valid = torch.arange(codes.shape[0], device=words.device) < n
    codes = torch.where(valid, codes, torch.full_like(codes, float("nan")))
    return colscan_plain(codes, a, lo, hi)


def _kernel_operand(t):
    """Kernels read int32 / int64 / float32 / float64 lanes; other column
    dtypes (bool, narrow ints) widen on the device first."""
    import torch
    if t.dtype in (torch.int32, torch.int64, torch.float32, torch.float64):
        return t
    return t.to(torch.float64 if t.is_floating_point() else torch.int64)


def _is_int(t) -> bool:
    """An integer (not bool) column: its SUM state stays int64, as the
    numpy oracle's `np.issubdtype(dtype, np.integer)` decides."""
    import torch
    return not t.is_floating_point() and t.dtype != torch.bool


def _host(t) -> np.ndarray:
    """A kernel or torch result back on the host as numpy."""
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


def _range_of_pred(pred: Optional[Expr], schema) -> Optional[Tuple]:
    """Normalize a predicate to a single-column closed range (col, lo, hi)
    when every conjunct is a literal comparison / BETWEEN on ONE numeric
    column — the shape the fused colscan kernel evaluates.  Strict bounds
    tighten to closed ones (next representable value / next integer)."""
    if pred is None:
        return None
    col: Optional[str] = None
    lo, hi = -np.inf, np.inf

    def col_of(name: str) -> bool:
        nonlocal col
        if col is None:
            col = name
        return col == name

    def is_int(name: str) -> bool:
        return schema.dtype(name) in (DType.INT32, DType.INT64)

    for c in split_conjuncts(pred):
        if isinstance(c, Between):
            if not (isinstance(c.child, Col) and _is_num(c.lo)
                    and _is_num(c.hi) and col_of(c.child.name)):
                return None
            lo, hi = max(lo, c.lo), min(hi, c.hi)
            continue
        if not isinstance(c, Cmp):
            return None
        if isinstance(c.left, Col) and isinstance(c.right, Lit):
            name, op, v = c.left.name, c.op, c.right.value
        elif isinstance(c.right, Col) and isinstance(c.left, Lit):
            if c.op not in _FLIP_CMP or c.op == "!=":
                return None
            name, op, v = c.right.name, _FLIP_CMP[c.op], c.left.value
        else:
            return None
        if not (_is_num(v) and col_of(name)):
            return None
        if op == "=":
            lo, hi = max(lo, v), min(hi, v)
        elif op == ">=":
            lo = max(lo, v)
        elif op == "<=":
            hi = min(hi, v)
        elif op == ">":
            lo = max(lo, float(np.floor(v)) + 1 if is_int(name)
                     else float(np.nextafter(v, np.inf)))
        elif op == "<":
            hi = min(hi, float(np.ceil(v)) - 1 if is_int(name)
                     else float(np.nextafter(v, -np.inf)))
        else:
            return None
    if col is None or schema.dtype(col) == DType.STRING:
        return None
    return col, float(lo), float(hi)


def _is_num(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) \
        and not isinstance(v, bool)


class SegmentRunner:
    """Executes one PipelineSegment per partition.

    The whole scan→filter→project chain is ONE function of the scan batch:
      * `jit` route — predicate + computed projections lower into a single
        torch function on the session's device (expr.CompiledExprSet);
        dictionary-coded columns are evaluated on int32 codes and only
        decoded at the segment boundary, after the filter, when logical
        values are needed;
      * kernel routes — filter+aggregate segments lower to the colscan /
        fused_decode_scan CUDA kernels, small-group aggregates to
        groupby_mxu (their plain versions when forced on the CPU; float64
        accumulation either way, so the oracle parity holds to rounding);
      * `numpy` route — the evaluate()-based oracle, used for tiny
        partitions, `backend="numpy"` sessions, and ExprCompileError
        fallbacks.
    Per-partition choices are recorded in the shared SegmentRecord."""

    def __init__(self, seg: PipelineSegment, schema, backend: str,
                 cfg: PDEConfig, record: SegmentRecord, device="cpu"):
        self.seg = seg
        self.device = device              # where compiled routes compute
        self.schema = schema              # scan schema (dtype lookups)
        self.backend = backend
        self.cfg = cfg
        self.record = record
        self._lock = threading.Lock()
        self._exprset: Optional[CompiledExprSet] = None
        self._exprset_failed = False
        self._agg_shape_cache: Dict[Tuple, Optional[Tuple]] = {}
        # outputs: None = all scan columns pass through
        self.outputs = seg.exprs

    def _on_gpu(self) -> bool:
        from ..kernels.ops import on_gpu
        return on_gpu(self.device)

    def _tensor(self, v: ColumnVal, what: str = "values"):
        """Column operand on this runner's device: block-backed columns use
        the block's memoized device copy, others cross once per call."""
        if v.block is not None and not v.materialized:
            return v.block.device_array(what, self.device)
        if what != "values":
            raise ValueError(what)
        return to_tensor(v.arr, self.device)

    # -- bookkeeping -----------------------------------------------------------

    def _note(self, route: str, rows_in: int, rows_out: int,
              bytes_in: float, fallback: bool = False,
              kept_codes: Sequence[str] = (), fused: bool = False) -> None:
        rec = self.record
        with self._lock:
            rec.partitions += 1
            rec.rows_in += rows_in
            rec.rows_out += rows_out
            rec.bytes_in += bytes_in
            rec.routes[route] = rec.routes.get(route, 0) + 1
            rec.fallbacks += int(fallback)
            if fused:
                rec.fused_routes[route] = rec.fused_routes.get(route, 0) + 1
            for n in kept_codes:
                if n not in rec.kept_code_cols:
                    rec.kept_code_cols.append(n)

    def _note_fused(self, route: str) -> None:
        """Promote the partition most recently noted under `route` to the
        whole-stage tally — used when the fused wrapper sits OUTSIDE the
        routed call (exchange bucketing around run())."""
        rec = self.record
        with self._lock:
            rec.fused_routes[route] = rec.fused_routes.get(route, 0) + 1

    def _note_route(self, route: str) -> None:
        """Tally an auxiliary route taken ON TOP of the partition's segment
        route — e.g. the topk_similarity selection that replaces the host
        lexsort after a similarity segment ran under `jit`.  Routes only;
        partition/row counts stay with the primary `_note`."""
        rec = self.record
        with self._lock:
            rec.routes[route] = rec.routes.get(route, 0) + 1

    # -- compiled expression set ----------------------------------------------

    def _computed_exprs(self) -> List[Expr]:
        exprs: List[Expr] = []
        if self.seg.pred is not None:
            exprs.append(self.seg.pred)
        if self.outputs is not None:
            exprs.extend(e for _, e in self.outputs
                         if not isinstance(e, Col))
        return exprs

    def _get_exprset(self) -> Optional[CompiledExprSet]:
        if self._exprset_failed:
            raise ExprCompileError("segment marked uncompilable")
        if self._exprset is None:
            exprs = self._computed_exprs()
            if not exprs:
                return None
            try:
                self._exprset = CompiledExprSet(
                    exprs, compressed_domain=self.cfg.compressed_domain,
                    device=self.device)
            except ExprCompileError:
                self._exprset_failed = True
                raise
        return self._exprset

    # -- routes ----------------------------------------------------------------

    def run(self, batch: PartitionBatch) -> PartitionBatch:
        """Plain narrow segment: filter + project, one fused step."""
        return self.run_routed(batch)[0]

    def run_routed(self, batch: PartitionBatch,
                   fused: bool = False) -> Tuple[PartitionBatch, str]:
        """run() returning (output, route) — the whole-stage wrapper
        (DESIGN.md §14) needs the route to decide whether the host seam
        was kept (numpy oracle) or the output may ship pre-bucketed.
        `fused=True` tallies compiled partitions under fused_routes."""
        rows = batch.num_rows
        nbytes = float(batch.nbytes)
        if self.backend == "numpy":
            out = self._run_numpy(batch)
            self._note("numpy", rows, out.num_rows, nbytes)
            return out, "numpy"
        decision = decide_segment_backend(rows, None, None, self._on_gpu(),
                                          self.cfg)
        if decision.route == "numpy":
            out = self._run_numpy(batch)
            self._note("numpy", rows, out.num_rows, nbytes)
            return out, "numpy"
        try:
            out, kept = self._run_jit(batch)
            self._note("jit", rows, out.num_rows, nbytes, kept_codes=kept,
                       fused=fused)
            return out, "jit"
        except ExprCompileError:
            self._exprset_failed = True
            out = self._run_numpy(batch)
            self._note("numpy", rows, out.num_rows, nbytes, fallback=True)
            return out, "numpy"

    def _run_numpy(self, batch: PartitionBatch) -> PartitionBatch:
        """The evaluate()-based oracle — operator semantics identical to the
        pre-segmentation interpreted executor."""
        if self.seg.pred is not None:
            ctx = {n: batch.col(n) for n in batch.names()}
            mask = np.asarray(evaluate(self.seg.pred, ctx).arr)
            if mask.ndim == 0:
                mask = np.full(batch.num_rows, bool(mask))
            batch = batch.mask(mask)
        if self.outputs is None:
            return batch
        ctx = {n: batch.col(n) for n in batch.names()}
        out: Dict[str, ColumnVal] = {}
        for name, e in self.outputs:
            v = evaluate(e, ctx)
            arr = v.arr
            if np.isscalar(arr) or (hasattr(arr, "shape")
                                    and arr.shape == ()):
                arr = np.full(batch.num_rows, arr)
                v = ColumnVal(arr, v.sdict, v.sorted_dict)
            out[name] = v
        return PartitionBatch(out)

    def _run_jit(self, batch: PartitionBatch
                 ) -> Tuple[PartitionBatch, List[str]]:
        ctx = {n: batch.col(n) for n in batch.names()}
        exprset = self._get_exprset()
        results = exprset(ctx) if exprset is not None else []
        i = 0
        mask = None
        if self.seg.pred is not None:
            mask = np.asarray(results[0].arr)
            if mask.ndim == 0:
                mask = np.full(batch.num_rows, bool(mask))
            i = 1
        kept: List[str] = []
        out: Dict[str, ColumnVal] = {}
        n_out = int(mask.sum()) if mask is not None else batch.num_rows
        if self.outputs is None:
            for name in batch.names():
                out[name] = self._mask_source(batch.col(name), mask, name,
                                              kept)
        else:
            for name, e in self.outputs:
                if isinstance(e, Col):
                    out[name] = self._mask_source(batch.col(e.name), mask,
                                                  name, kept)
                    continue
                v = results[i]
                i += 1
                arr = v.arr
                if np.isscalar(arr) or (hasattr(arr, "shape")
                                        and arr.shape == ()):
                    out[name] = ColumnVal(np.full(n_out, arr), v.sdict,
                                          v.sorted_dict)
                    continue
                arr = np.asarray(arr)
                if mask is not None:
                    arr = arr[mask]
                out[name] = ColumnVal(arr, v.sdict, v.sorted_dict)
        return PartitionBatch(out), kept

    def _mask_source(self, v: ColumnVal, mask: Optional[np.ndarray],
                     out_name: str, kept: List[str]) -> ColumnVal:
        """Filter a pass-through column.  Strings stay dictionary codes
        (sdict shared, so a projection that merely renames a dict-encoded
        column never forces decode); DICT-encoded numerics are filtered in
        code space and decoded at the boundary (gather after the mask —
        `dictdecode` fused where logical values are first required)."""
        if mask is None:
            return v        # pass through, lazily decoded if never touched
        if v.is_string:
            kept.append(out_name)
            return ColumnVal(np.asarray(v.arr)[mask], v.sdict, v.sorted_dict)
        if v.block is not None and not v.materialized:
            cs = v.block.code_space()
            if cs is not None:
                codes, d = cs
                kept.append(out_name)
                return ColumnVal(d[codes[mask]])
            if self.cfg.compressed_domain:
                fs = v.block.frame_space()
                if fs is not None:
                    # FOR codes filtered narrow; only survivors widen
                    codes, bias = fs
                    kept.append(out_name)
                    orig = v.block.enc.orig_dtype
                    sel = codes[mask].astype(np.int64) + int(bias)
                    return ColumnVal(sel.astype(orig))
        return ColumnVal(np.asarray(v.arr)[mask])

    # -- fused aggregation -----------------------------------------------------

    def _source_col(self, name: str) -> Optional[str]:
        """Scan column behind segment output `name`, if it is a bare Col."""
        if self.outputs is None:
            return name if name in self.schema else None
        for n, e in self.outputs:
            if n == name:
                return e.name if isinstance(e, Col) else None
        return None

    def _agg_kernel_shape(self, group_cols: Sequence[str],
                          aggs: Sequence[AggSpec]) -> Optional[Tuple]:
        """Plan-level kernel eligibility of this segment+aggregate shape.
        Returns ("colscan", filter_col, lo, hi, value_col) or
        ("groupby_mxu", group_col, value_col) or None."""
        key = (tuple(group_cols), tuple(id(a) for a in aggs))
        if key in self._agg_shape_cache:
            return self._agg_shape_cache[key]
        shape = self._agg_kernel_shape_uncached(list(group_cols), list(aggs))
        self._agg_shape_cache[key] = shape
        return shape

    def _agg_kernel_shape_uncached(self, group_cols, aggs):
        value_col: Optional[str] = None
        for a in aggs:
            if a.func == AggFunc.COUNT_DISTINCT:
                return None
            if a.func == AggFunc.COUNT and a.arg is None:
                continue
            if a.arg is None or not isinstance(a.arg, Col):
                return None
            src = self._source_col(a.arg.name)
            if src is None or self.schema.dtype(src) == DType.STRING:
                return None
            if (self.schema.dtype(src) == DType.INT64
                    and a.func in (AggFunc.SUM, AggFunc.MIN, AggFunc.MAX)):
                # int64 aggregates keep integer accumulators (exact above
                # 2^53); the float-accumulating kernel shapes would round
                return None
            if value_col is None:
                value_col = src
            elif value_col != src:
                return None     # one value column per kernel pass
        if not group_cols:
            rng = _range_of_pred(self.seg.pred, self.schema)
            if rng is None:
                return None     # the kernel shape is filter+aggregate
            fcol, lo, hi = rng
            if value_col is None:
                value_col = fcol    # COUNT-only: count the filter column
            return ("colscan", fcol, lo, hi, value_col)
        if len(group_cols) != 1 or self.seg.pred is not None:
            return None
        if any(a.func in (AggFunc.MIN, AggFunc.MAX) for a in aggs):
            return None     # groupby_mxu produces [sum, count] only
        gsrc = self._source_col(group_cols[0])
        if gsrc is None:
            return None
        return ("groupby_mxu", gsrc, value_col)

    def run_aggregate(self, batch: PartitionBatch,
                      group_cols: Sequence[str],
                      aggs: Sequence[AggSpec]) -> PartitionBatch:
        """Fused map side of an aggregation: segment + partial aggregate in
        one step, lowered to a CUDA kernel when the shape and the
        partition statistics allow."""
        return self._aggregate_routed(batch, group_cols, aggs)[0]

    def _aggregate_routed(self, batch: PartitionBatch,
                          group_cols: Sequence[str],
                          aggs: Sequence[AggSpec], fused: bool = False,
                          force_compiled: bool = False
                          ) -> Tuple[PartitionBatch, str]:
        """run_aggregate() returning (partial states, route) — the
        whole-stage wrapper (DESIGN.md §14) consumes the route to decide
        whether the output ships pre-bucketed.  `force_compiled` upgrades a
        small-partition numpy decision to the jit route (the differential
        grid forces fusion on tiny seeds); empty partitions stay numpy."""
        rows = batch.num_rows
        nbytes = float(batch.nbytes)
        if self.backend == "numpy":
            out = partial_aggregate(self._run_numpy(batch), group_cols, aggs)
            self._note("numpy", rows, out.num_rows, nbytes)
            return out, "numpy"
        shape = self._agg_kernel_shape(group_cols, aggs)
        ndv = None
        if shape is not None and shape[0] == "groupby_mxu":
            gblock = batch.col(shape[1]).block
            ndv = block_ndv(gblock) if gblock is not None else None
            if ndv is None:
                shape = None
        decision = decide_segment_backend(
            rows, shape[0] if shape is not None else None, ndv,
            self._on_gpu(), self.cfg)
        route = decision.route
        if route == "numpy" and force_compiled and rows > 0:
            route = "jit"
        try:
            if route == "colscan":
                out, route = self._run_colscan(batch, shape, aggs,
                                               kernel=True)
            elif route == "groupby_mxu":
                out, route = self._run_groupby(batch, shape, group_cols,
                                               aggs, ndv, kernel=True)
            elif route == "jit":
                if shape is not None and shape[0] == "colscan":
                    # the same fused filter+aggregate as the kernel, as
                    # torch operations — no mask batch is ever
                    # materialized
                    out, route = self._run_colscan(batch, shape, aggs,
                                                   kernel=False)
                elif shape is not None and shape[0] == "groupby_mxu":
                    # CPU fast path for the small-NDV group-by shape: group
                    # directly on dictionary codes — no np.unique pass
                    out, route = self._run_groupby(batch, shape, group_cols,
                                                   aggs, ndv, kernel=False)
                else:
                    filtered, _ = self._run_jit(batch)
                    out = partial_aggregate(filtered, group_cols, aggs)
            else:
                out = partial_aggregate(self._run_numpy(batch), group_cols,
                                        aggs)
        except ExprCompileError:
            self._exprset_failed = True
            out = partial_aggregate(self._run_numpy(batch), group_cols, aggs)
            self._note("numpy", rows, out.num_rows, nbytes, fallback=True)
            return out, "numpy"
        self._note(route, rows, out.num_rows, nbytes,
                   fused=fused and route != "numpy")
        return out, route

    def _run_colscan(self, batch: PartitionBatch, shape, aggs,
                     kernel: bool) -> Tuple[PartitionBatch, str]:
        import torch

        from ..kernels import ops as kernel_ops
        _, fcol, lo, hi, vcol = shape
        fv = batch.col(fcol)
        if (self.cfg.compressed_domain and not kernel
                and fv.block is not None and not fv.materialized
                and not fv.is_string and fv.block.run_space() is not None):
            # run-level RLE scan: predicate on run VALUES, never widened
            return self._run_rle_scan(batch, fcol, lo, hi, vcol, aggs)
        raw = self._tensor(batch.col(vcol))
        int_sum = _is_int(raw)
        vals = _kernel_operand(raw)
        coded = (fv.block is not None and not fv.materialized
                 and fv.block.code_space() is not None)
        framed = (not coded and self.cfg.compressed_domain
                  and fv.block is not None and not fv.materialized
                  and fv.block.frame_space() is not None)
        packed = (not coded and not framed and not kernel
                  and self.cfg.compressed_domain
                  and fv.block is not None and not fv.materialized
                  and fv.block.pack_space() is not None)
        if kernel and coded:
            # decode fused into the scan: the filter column is read as
            # codes, its dictionary gathered inside the kernel
            d = _kernel_operand(self._tensor(fv, "dictionary"))
            res = self._kernel_colscan_chunked(
                lambda c, v: kernel_ops.fused_decode_scan(c, d, v, lo, hi),
                self._tensor(fv, "codes"), vals)
            route = "fused_decode_scan"
        elif kernel:
            # a filter on the aggregated column passes one tensor twice:
            # the kernel reads it once
            res = self._kernel_colscan_chunked(
                lambda f, v: kernel_ops.colscan(f, v, lo, hi),
                vals if fcol == vcol else _kernel_operand(self._tensor(fv)),
                vals)
            route = "colscan"
        elif coded:
            # value bounds translate to CODE bounds host-side (sorted
            # dictionary, same trick as expr._Lowering._dict_cmp): the
            # scan compares int32 codes — no per-row dictionary gather,
            # which is what made this route lose to numpy (the
            # BENCH_exec_engine filter_agg_dict regression)
            codes, d = fv.block.code_space()
            clo = float(np.searchsorted(d, lo, side="left"))
            chi = float(np.searchsorted(d, hi, side="right") - 1)
            res = colscan_plain(self._tensor(fv, "codes"), vals, clo, chi)
            route = "jit-colscan"
        elif framed:
            # frame-of-reference: value bounds translate to CODE bounds
            # by pure integer arithmetic (code = value - bias is order-
            # preserving); the scan compares the narrow code lane and
            # the filter column never widens (DESIGN.md §12)
            codes, bias = fv.block.frame_space()
            clo = (float(int(math.ceil(lo)) - int(bias))
                   if math.isfinite(lo) else -np.inf)
            chi = (float(int(math.floor(hi)) - int(bias))
                   if math.isfinite(hi) else np.inf)
            res = colscan_plain(to_tensor(codes, self.device), vals, clo,
                                chi)
            route = "for-colscan"
        elif packed:
            # bit-packed: value bounds translate to biased-code bounds
            # host-side exactly like FOR, and the packed words unpack
            # inside the fused scan — no host-side widening of the
            # filter column (DESIGN.md §12)
            ps = fv.block.pack_space()
            if ps is None:      # recompressed since the route check
                raise ExprCompileError("BITPACK words gone (recompressed)")
            words, width, bias, nrows = ps
            clo = (float(int(math.ceil(lo)) - int(bias))
                   if math.isfinite(lo) else -np.inf)
            chi = (float(int(math.floor(hi)) - int(bias))
                   if math.isfinite(hi) else np.inf)
            pad = words.shape[0] * (32 // width) - nrows
            a = vals.to(torch.float64)
            if pad:
                a = torch.cat([a, a.new_zeros(pad)])
            res = _bitpack_colscan(to_tensor(words, self.device), a, nrows,
                                   width, clo, chi)
            route = "bitpack-colscan"
        else:
            res = colscan_plain(self._tensor(fv), vals, lo, hi)
            route = "jit-colscan"
        res = _host(res)
        cnt, s, mn, mx = (float(res[0]), float(res[1]), float(res[2]),
                          float(res[3]))
        return self._colscan_result(aggs, cnt, s, mn, mx, int_sum), route

    def _kernel_colscan_chunked(self, fn, fcol, vals):
        """Double-buffered kernel colscan (DESIGN.md §14): large partitions
        split into DOUBLE_BUFFER chunks, each chunk's launch overlapping the
        previous chunk's copy back (asynchronous launch), with the per-
        chunk [count, sum, min, max] states combined in the same float64
        rounding class as one pass.  Small partitions take one call."""
        from ..kernels import ops as kernel_ops
        chunk = kernel_ops.DOUBLE_BUFFER["chunk_rows"]
        n = int(fcol.shape[0])
        if n < 2 * chunk:
            return fn(fcol, vals)
        states = kernel_ops.double_buffer_map(
            lambda fv_pair: fn(fv_pair[0], fv_pair[1]),
            [(fcol[i:i + chunk], vals[i:i + chunk])
             for i in range(0, n, chunk)])
        cnt, s, mn, mx = combine_colscan_stats(states)
        return np.array([cnt, s, mn, mx], np.float64)

    def _run_rle_scan(self, batch: PartitionBatch, fcol: str, lo, hi,
                      vcol: str, aggs) -> Tuple[PartitionBatch, str]:
        """Run-level RLE scan (DESIGN.md §12): the predicate is evaluated
        once per RUN on the run values.  When the aggregate reads the same
        column the whole filter+aggregate is run-level (O(runs), never
        expanded); otherwise the run mask expands via np.repeat and only
        the value column is touched row-wise.  float64 accumulation
        (numpy-oracle parity)."""
        rs = batch.col(fcol).block.run_space()
        if rs is None:      # recompressed since the route check
            raise ExprCompileError("RLE runs gone (recompressed)")
        run_values, run_lengths = rs
        rl = np.asarray(run_lengths, np.int64)
        rmask = (run_values >= lo) & (run_values <= hi)
        if vcol == fcol:
            sel_v = np.asarray(run_values[rmask], np.float64)
            sel_l = rl[rmask]
            cnt = float(sel_l.sum())
            s = float((sel_v * sel_l).sum())
            mn = float(sel_v.min()) if sel_v.size else float("inf")
            mx = float(sel_v.max()) if sel_v.size else float("-inf")
            int_sum = np.issubdtype(np.asarray(run_values).dtype, np.integer)
        else:
            mask = np.repeat(rmask, rl)
            vraw = np.asarray(batch.col(vcol).arr)
            int_sum = np.issubdtype(vraw.dtype, np.integer)
            sel = vraw[mask].astype(np.float64)
            cnt = float(sel.shape[0])
            s = float(sel.sum())
            mn = float(sel.min()) if sel.size else float("inf")
            mx = float(sel.max()) if sel.size else float("-inf")
        return self._colscan_result(aggs, cnt, s, mn, mx, int_sum), "rle-scan"

    @staticmethod
    def _colscan_result(aggs, cnt: float, s: float, mn: float, mx: float,
                        int_sum: bool) -> PartitionBatch:
        out: Dict[str, ColumnVal] = {}
        for spec in aggs:
            sc = _agg_state_cols(spec)
            if spec.func == AggFunc.COUNT:
                out[sc[0]] = ColumnVal(np.array([cnt], np.int64))
            elif spec.func == AggFunc.SUM:
                arr = np.array([s], np.int64 if int_sum else np.float64)
                out[sc[0]] = ColumnVal(arr)
            elif spec.func == AggFunc.AVG:
                out[sc[0]] = ColumnVal(np.array([s], np.float64))
                out[sc[1]] = ColumnVal(np.array([cnt], np.int64))
            elif spec.func == AggFunc.MIN:
                out[sc[0]] = ColumnVal(np.array([mn], np.float64))
            elif spec.func == AggFunc.MAX:
                out[sc[0]] = ColumnVal(np.array([mx], np.float64))
            else:
                raise ExprCompileError(str(spec.func))
        return PartitionBatch(out)

    def _run_groupby(self, batch: PartitionBatch, shape, group_cols, aggs,
                     ndv: int, kernel: bool = True
                     ) -> Tuple[PartitionBatch, str]:
        import torch

        from ..kernels import ops as kernel_ops
        _, gsrc, vcol = shape
        gv = batch.col(gsrc)
        block = (gv.block if gv.block is not None and not gv.materialized
                 else None)
        if gv.is_string:
            codes = self._tensor(gv)
            reps: Optional[np.ndarray] = None      # group i == code i
            num_groups = len(gv.sdict)
        elif block is not None and block.code_space() is not None:
            codes = self._tensor(gv, "codes")
            reps = block.code_space()[1]
            num_groups = len(reps)
        elif block is not None:
            # group ids of the stored values, memoized on the block
            reps = block.group_space()[0]
            codes = self._tensor(gv, "group_codes")
            num_groups = len(reps)
        else:
            reps, inv = np.unique(np.asarray(gv.arr), return_inverse=True)
            codes = to_tensor(inv, self.device)
            num_groups = len(reps)
        raw = (self._tensor(batch.col(vcol)) if vcol is not None
               else torch.zeros(batch.num_rows, dtype=torch.float64,
                                device=self.device))
        int_sum = _is_int(raw)
        vals = _kernel_operand(raw)
        if kernel:
            res = kernel_ops.groupby_sum(codes, vals, num_groups)
            route = "groupby_mxu"
        else:
            # group directly on dictionary codes: no np.unique pass (codes
            # ARE group ids when the dictionary is the group space)
            res = groupby_sum_plain(codes, vals, num_groups)
            route = "code-groupby"
        if gv.is_string:
            def keys_of(sel):
                return ColumnVal(np.flatnonzero(sel).astype(np.int32),
                                 gv.sdict, True)
        else:
            def keys_of(sel):
                return ColumnVal(reps[sel])
        return (_group_states(_host(res), group_cols[0], keys_of, aggs,
                              int_sum), route)


def slot_groupby(keys, values, key_dtype, group_cols, aggs,
                 cfg: PDEConfig) -> PartitionBatch:
    """Partial states of one mesh slot's received rows (`keys` int64,
    `values` or None, both on the slot's device), reduced there: the
    group ids come from the keys on the device (`torch.unique`), then
    the rows take the route the single-host group-by takes for as many
    rows and groups (`decide_segment_backend`): kernel 3
    (`groupby_sum`) on a card, its plain version on the CPU or past the
    kernel's NDV, the numpy oracle for a tiny slot.  Only the states
    (a row a group) come back to the host."""
    import torch

    from ..kernels import ops as kernel_ops
    n = int(keys.shape[0])
    on_gpu = keys.is_cuda
    if n == 0 or decide_segment_backend(
            n, "groupby_mxu", None, on_gpu, cfg).route == "numpy":
        cols = {group_cols[0]: ColumnVal(
            _host(keys).astype(key_dtype, copy=False))}
        if values is not None:
            for a in aggs:
                if a.arg is not None:
                    cols[a.arg.name] = ColumnVal(_host(values))
        return partial_aggregate(PartitionBatch(cols), group_cols, aggs)
    reps, codes = torch.unique(keys, sorted=True, return_inverse=True)
    num_groups = int(reps.shape[0])
    raw = (values if values is not None
           else torch.zeros(n, dtype=torch.float64, device=keys.device))
    vals = _kernel_operand(raw)
    route = decide_segment_backend(n, "groupby_mxu", num_groups, on_gpu,
                                   cfg).route
    if route == "groupby_mxu":
        res = kernel_ops.groupby_sum(codes, vals, num_groups)
    else:
        res = groupby_sum_plain(codes, vals, num_groups)
    reps = _host(reps).astype(key_dtype, copy=False)
    return _group_states(_host(res), group_cols[0],
                         lambda sel: ColumnVal(reps[sel]), aggs,
                         _is_int(raw))


def _group_states(res: np.ndarray, gname: str, keys_of, aggs,
                  int_sum: bool) -> PartitionBatch:
    """Partial-state batch of a (groups, 2) [sum, count] group-by result:
    present groups only, their key column from `keys_of(present)`."""
    sums = res[:, 0]
    cnts = np.round(res[:, 1]).astype(np.int64)
    sel = cnts > 0      # partial states carry only present groups
    out: Dict[str, ColumnVal] = {gname: keys_of(sel)}
    for spec in aggs:
        sc = _agg_state_cols(spec)
        if spec.func == AggFunc.COUNT:
            out[sc[0]] = ColumnVal(cnts[sel])
        elif spec.func == AggFunc.SUM:
            arr = (np.round(sums[sel]).astype(np.int64) if int_sum
                   else sums[sel].astype(np.float64))
            out[sc[0]] = ColumnVal(arr)
        elif spec.func == AggFunc.AVG:
            out[sc[0]] = ColumnVal(sums[sel].astype(np.float64))
            out[sc[1]] = ColumnVal(cnts[sel])
        else:
            raise ExprCompileError(str(spec.func))
    return PartitionBatch(out)


def _agg_state_cols(spec: AggSpec) -> List[str]:
    from .aggregate import _state_cols
    return _state_cols(spec)


class ReduceRunner:
    """Routes ONE reduce-side operator — the final aggregation merge or the
    local join probe — per reduce task (DESIGN.md §11), mirroring what
    SegmentRunner does for scan-side segments:

      * `numpy` route — merge_aggregate / _match_pairs, the interpreted
        oracle (tiny bucket groups, `backend="numpy"` sessions, fallbacks);
      * `jit` route — aggregate.CompiledMerge (one segmented-reduce torch
        function over all aggregate states) / joins.CompiledProbe (the
        sort-searchsorted probe as torch operations), on the session's
        device;
      * `segmented_merge` route — the CUDA kernel, per float state
        column, on a GPU (its plain version when forced on the CPU).

    Every per-task choice lands in the shared SegmentRecord, so
    ExecMetrics.segments exposes the reduce side exactly like the scan
    side."""

    def __init__(self, backend: str, cfg: PDEConfig, record: SegmentRecord,
                 device="cpu"):
        self.backend = backend
        self.cfg = cfg
        self.device = device
        self.record = record
        self._lock = threading.Lock()
        self._merge: Optional[CompiledMerge] = None
        self._merge_failed = False

    def _on_gpu(self) -> bool:
        from ..kernels.ops import on_gpu
        return on_gpu(self.device)

    def _note(self, route: str, rows_in: int, rows_out: int,
              bytes_in: float, fallback: bool = False) -> None:
        rec = self.record
        with self._lock:
            rec.partitions += 1
            rec.rows_in += rows_in
            rec.rows_out += rows_out
            rec.bytes_in += bytes_in
            rec.routes[route] = rec.routes.get(route, 0) + 1
            rec.fallbacks += int(fallback)

    # -- final aggregation merge ----------------------------------------------

    def _kernel_merge_eligible(self, batch: PartitionBatch,
                               aggs: Sequence[AggSpec]) -> bool:
        """The segmented_merge kernel accumulates in float: only merges
        whose every state column is float-typed (and present) qualify —
        integer states stay on the int64-exact compiled route."""
        for spec in aggs:
            if spec.func == AggFunc.COUNT_DISTINCT:
                return False
            for sc in _agg_state_cols(spec):
                if sc not in batch.cols:
                    return False
                if not np.issubdtype(
                        np.asarray(batch.col(sc).arr).dtype, np.floating):
                    return False
        return True

    def merge(self, batch: PartitionBatch, group_cols: Sequence[str],
              aggs: Sequence[AggSpec]) -> PartitionBatch:
        rows = batch.num_rows
        nbytes = float(batch.nbytes)
        if self.backend == "numpy":
            out = merge_aggregate(batch, group_cols, aggs)
            self._note("numpy", rows, out.num_rows, nbytes)
            return out
        kernel_eligible = ("segmented_merge"
                           if self._kernel_merge_eligible(batch, aggs)
                           else None)
        decision = decide_reduce_backend(rows, kernel_eligible, None,
                                         self._on_gpu(), self.cfg)
        route = decision.route
        try:
            if route == "segmented_merge":
                out, route = self._merge_kernel(batch, group_cols, aggs)
            elif route == "jit":
                out = self._merge_jit(batch, group_cols, aggs)
            else:
                out = merge_aggregate(batch, group_cols, aggs)
        except ExprCompileError:
            out = merge_aggregate(batch, group_cols, aggs)
            self._note("numpy", rows, out.num_rows, nbytes, fallback=True)
            return out
        self._note(route, rows, out.num_rows, nbytes)
        return out

    def _merge_jit(self, batch: PartitionBatch, group_cols, aggs
                   ) -> PartitionBatch:
        if self._merge_failed:
            raise ExprCompileError("merge marked uncompilable")
        if self._merge is None:
            try:
                self._merge = CompiledMerge(group_cols, aggs,
                                            device=self.device)
            except ExprCompileError:
                self._merge_failed = True
                raise
        return self._merge(batch)

    def _merge_kernel(self, batch: PartitionBatch, group_cols, aggs
                      ) -> Tuple[PartitionBatch, str]:
        """Host grouping + one segmented_merge kernel pass per state
        column; each spec consumes the lane(s) it needs (assembly shared
        with the oracle in aggregate.merge_from_lanes)."""
        from ..kernels import ops as kernel_ops
        from .aggregate import merge_from_lanes
        keys = [np.asarray(batch.col(g).arr) for g in group_cols]
        n = batch.num_rows
        first, inverse = group_indices(keys) if group_cols else \
            (np.zeros(1, np.int64), np.zeros(n, np.int64))
        num_groups = len(first)
        # re-decide with the NOW-KNOWN group cardinality: the NDV policy
        # lives in decide_reduce_backend, not here
        redecide = decide_reduce_backend(n, "segmented_merge", num_groups,
                                         self._on_gpu(), self.cfg)
        if num_groups == 0 or redecide.route != "segmented_merge":
            return self._merge_jit(batch, group_cols, aggs), "jit"
        inv = to_tensor(np.asarray(inverse, np.int64), self.device)
        lanes: Dict[str, np.ndarray] = {}
        for spec in aggs:
            for sc in _agg_state_cols(spec):
                if sc in lanes:
                    continue
                values = _kernel_operand(to_tensor(batch.col(sc).arr,
                                                   self.device))
                lanes[sc] = _host(kernel_ops.segmented_merge(
                    inv, values, num_groups))
        return (merge_from_lanes(batch, group_cols, aggs, first, lanes),
                "segmented_merge")

    # -- local join probe -----------------------------------------------------

    def join(self, lbatch: PartitionBatch, rbatch: PartitionBatch,
             lkey: str, rkey: str, how: str) -> PartitionBatch:
        rows = lbatch.num_rows + rbatch.num_rows
        nbytes = float(lbatch.nbytes + rbatch.nbytes)
        if self.backend == "numpy":
            out = join_local(lbatch, rbatch, lkey, rkey, how)
            self._note("numpy", rows, out.num_rows, nbytes)
            return out
        decision = decide_reduce_backend(rows, None, None, self._on_gpu(),
                                         self.cfg)
        if decision.route == "numpy":
            out = join_local(lbatch, rbatch, lkey, rkey, how)
            self._note("numpy", rows, out.num_rows, nbytes)
            return out
        try:
            out = join_local(lbatch, rbatch, lkey, rkey, how,
                             matcher=compile_probe(self.device))
            self._note("jit", rows, out.num_rows, nbytes)
        except TypeError:
            # non-numeric key layout the probe cannot take: oracle fallback
            out = join_local(lbatch, rbatch, lkey, rkey, how)
            self._note("numpy", rows, out.num_rows, nbytes, fallback=True)
        return out


class JoinShuffledRDD(RDD):
    """Reduce side of a shuffle join.  Each split is either a plain bucket
    group (fetch the group from BOTH parents' map outputs, join locally) or
    a `SkewShard`: one stripe of a heavy-hitter bucket, where the sharded
    (probe) side fetches only map outputs shard, shard+n, ... and the other
    side's bucket is replicated to each stripe — the skew-splitting half of
    §3.1.2.  Across the stripes every probe map output is read exactly
    once, so splitting adds no fetch amplification on the big side, and a
    recomputed-after-failure stripe deterministically sees the same rows
    (map tasks are deterministic)."""

    def __init__(self, ldep: ShuffleDependency, rdep: ShuffleDependency,
                 bucket_groups: List[object], lkey: str, rkey: str,
                 how: str = "inner", runner: Optional["ReduceRunner"] = None):
        self.ldep, self.rdep = ldep, rdep
        self.bucket_groups = bucket_groups
        self.lkey, self.rkey, self.how = lkey, rkey, how
        self.runner = runner
        super().__init__(ldep.parent.ctx, len(bucket_groups), [ldep, rdep])

    def _fetch(self, dep: ShuffleDependency, buckets: List[int],
               maps=None) -> PartitionBatch:
        pieces = self.ctx.block_manager.fetch_shuffle(
            dep.shuffle_id, dep.parent.num_partitions, buckets, maps)
        return PartitionBatch.concat(pieces)

    def _join(self, l: PartitionBatch, r: PartitionBatch) -> PartitionBatch:
        if self.runner is not None:
            return self.runner.join(l, r, self.lkey, self.rkey, self.how)
        return join_local(l, r, self.lkey, self.rkey, self.how)

    def compute(self, split: int, tc: TaskContext) -> PartitionBatch:
        spec = self.bucket_groups[split]
        if isinstance(spec, SkewShard):
            sdep, odep = ((self.ldep, self.rdep)
                          if spec.shard_side == "left"
                          else (self.rdep, self.ldep))
            stripe = range(spec.shard, sdep.parent.num_partitions,
                           spec.num_shards)
            sharded = self._fetch(sdep, [spec.bucket], list(stripe))
            other = self._fetch(odep, [spec.bucket])
            l, r = ((sharded, other) if spec.shard_side == "left"
                    else (other, sharded))
            return self._join(l, r)
        l = self._fetch(self.ldep, spec)
        r = self._fetch(self.rdep, spec)
        return self._join(l, r)


@dataclasses.dataclass
class Compiled:
    rdd: RDD
    names: List[str]
    table: Optional[Table] = None            # set when rdd is a bare scan
    scan_filtered: bool = False              # a filter applies at/below scan
    size_hint: Optional[float] = None        # bytes prior (for join ordering)
    # the SegmentRunner producing this RDD's partitions, when the RDD is a
    # segment map — join boundaries use it to tally fused exchanges under
    # the whole-stage route (DESIGN.md §14)
    runner: Optional["SegmentRunner"] = None


class ScanCache:
    """Shared registry of *cached* TableScanRDDs (server tier, DESIGN.md §6).

    Plain sessions build a fresh TableScanRDD per query, so its RDD id — and
    therefore its block-manager keys — never repeat and nothing is reused.
    The server shares one ScanCache across all per-query Executors: scans of
    the same (table, version, columns, surviving partitions) resolve to ONE
    RDD marked `.cache()`, so materialized scan blocks are shared across
    queries and clients, live under the MemoryManager's budget, and are
    recomputed from the column store on eviction miss."""

    def __init__(self):
        self._lock = threading.RLock()
        self._rdds: Dict[Tuple, RDD] = {}

    def get_or_create(self, ctx: SharkContext, table: Table, version: int,
                      cols: List[str], selected: List[int]) -> RDD:
        key = (table.name, version, tuple(cols), tuple(selected))
        with self._lock:
            rdd = self._rdds.get(key)
            if rdd is None:
                # a version bump invalidates all older scans of this table;
                # drop their RDDs and any blocks they pinned in the store
                for k in [k for k in self._rdds
                          if k[0] == table.name and k[1] != version]:
                    stale = self._rdds.pop(k)
                    stale.unpersist()
                rdd = ctx.scan(table, cols, selected).cache()
                self._rdds[key] = rdd
            return rdd

    def clear(self) -> None:
        with self._lock:
            for rdd in self._rdds.values():
                rdd.unpersist()
            self._rdds.clear()


class Executor:
    def __init__(self, ctx: SharkContext, catalog: Catalog,
                 pde: PDEConfig = PDEConfig(), enable_pde: bool = True,
                 enable_map_pruning: bool = True,
                 default_shuffle_buckets: int = 64,
                 scan_cache: Optional[ScanCache] = None,
                 backend: str = "compiled", exchange: str = "coded",
                 mesh=None, stage_fusion: str = "on", device="cpu"):
        assert backend in ("compiled", "numpy"), backend
        if mesh is not None:
            mesh.check_device(device)
        assert exchange in ("coded", "decoded"), exchange
        assert stage_fusion in ("on", "off", "force"), stage_fusion
        self.ctx = ctx
        self.catalog = catalog
        # the device compiled routes and kernels compute on
        self.device = device
        # cluster tier (DESIGN.md §13.1): when set, eligible aggregate map
        # sides run sharded over the mesh's device slots and the compiled
        # exchange ships buckets across slots
        self.mesh = mesh
        self.pde = pde
        self.enable_pde = enable_pde
        self.enable_map_pruning = enable_map_pruning
        self.default_shuffle_buckets = default_shuffle_buckets
        self.scan_cache = scan_cache
        # "compiled": pipeline segments pick jit/kernel routes per partition;
        # "numpy": segments run the evaluate() oracle (differential testing)
        self.backend = backend
        # "coded": dictionary-preserving exchange — string columns cross
        # shuffles as (codes, partition dictionary) and the reduce side
        # merge-remaps dictionaries (DESIGN.md §11); "decoded": the legacy
        # exchange that materializes raw strings before hashing, kept as
        # the semantic oracle for differential tests and shuffle_bench
        self.exchange = exchange
        # whole-stage fusion (DESIGN.md §14): "on" fuses eligible map
        # stages into one program ending in pre-bucketed shuffle
        # output; "force" bypasses the PDE row threshold (test grids);
        # "off" is the segment-at-a-time semantic oracle.  Fusion requires
        # the compiled backend and the dictionary-preserving exchange —
        # the decoded exchange's string re-materialization IS a host seam,
        # and the numpy oracle must keep every seam — so it self-disables
        # otherwise.
        self._fusion_mode = (stage_fusion
                             if backend == "compiled" and exchange == "coded"
                             else "off")
        # map-side radix bucketing through the radix_partition kernel (on a
        # GPU, or forced): the device it runs on, else None for the host
        # partitioner; fixed per executor so every map task of a shuffle
        # agrees
        from ..kernels.ops import on_gpu
        self._radix_kernel = (device if backend == "compiled"
                              and (pde.segment_force_kernels
                                   or on_gpu(device)) else None)
        # shuffle ids this executor created: the server releases their map
        # outputs from the block store once the query completes
        self.created_shuffles: List[int] = []
        self.metrics = ExecMetrics()

    def _prep_exchange(self, rdd: RDD) -> RDD:
        """Map-side exchange prep.  The legacy ('decoded') exchange
        materializes raw strings so the shuffle hashes raw values; the
        dictionary-preserving exchange ships (codes, partition-local
        dictionary) through the shuffle block untouched — hashing runs on
        the dictionary (one crc32 per distinct value) and the reduce side
        unifies dictionaries instead of decoding."""
        if self.exchange == "decoded":
            return rdd.map_partitions(lambda s, b: b.decode_strings())
        return rdd

    def _reduce_runner(self, consumer: str, outputs: List[str]
                       ) -> ReduceRunner:
        """Reduce-side runner + metrics record for one shuffle boundary."""
        record = SegmentRecord(table="<exchange>", depth=1,
                               consumer=consumer, outputs=outputs, pred=None)
        self.metrics.segments.append(record)
        return ReduceRunner(self.backend, self.pde, record, self.device)

    def _new_shuffle(self, parent: RDD, num_buckets: int, partitioner,
                     **kw) -> ShuffleDependency:
        dep = ShuffleDependency(parent, num_buckets, partitioner, **kw)
        self.created_shuffles.append(dep.shuffle_id)
        return dep

    # ---------------------------------------------------------------- public

    def _storage(self):
        mm = self.ctx.block_manager.memory_manager
        return getattr(mm, "storage", None) if mm is not None else None

    def execute(self, plan: Node) -> ExecResult:
        self.metrics = ExecMetrics()
        storage = self._storage()
        before = storage.stats() if storage is not None else None
        chaos = getattr(self.ctx, "chaos", None)
        trips_before = chaos.trip_count() if chaos is not None else 0
        res_before = dict(self.ctx.scheduler.resilience_counters)
        plan = optimize(plan, self.catalog)
        compiled = self._compile(plan)
        batches = self.ctx.scheduler.run_result_stage(compiled.rdd)
        if storage is not None:
            after = storage.stats()
            m = self.metrics
            m.spills = after["spills"] - before["spills"]
            m.spill_bytes = (after["spill_write_bytes"]
                             - before["spill_write_bytes"])
            m.spill_reads = after["spill_reads"] - before["spill_reads"]
            m.recompressions = (after["recompressions"]
                                - before["recompressions"])
        if chaos is not None:
            self.metrics.fault_trips = [tuple(t) for t in
                                        chaos.trips_since(trips_before)]
        res_after = self.ctx.scheduler.resilience_counters
        self.metrics.resilience_events = {
            k: res_after[k] - res_before.get(k, 0)
            for k in res_after if res_after[k] - res_before.get(k, 0)}
        return ExecResult(batches, compiled.names)

    # ------------------------------------------------------------- internals

    def _compile(self, node: Node) -> Compiled:
        if isinstance(node, ScanNode):
            return self._compile_scan(node, pred=None)
        if isinstance(node, (FilterNode, ProjectNode)):
            seg = fold_pipeline(node)
            if seg is not None:
                return self._compile_segment(seg)
        if isinstance(node, FilterNode):
            return self._compile_filter(node)
        if isinstance(node, ProjectNode):
            return self._compile_project(node)
        if isinstance(node, AggregateNode):
            return self._compile_aggregate(node)
        if isinstance(node, JoinNode):
            return self._compile_join(node)
        if isinstance(node, SortNode):
            return self._compile_sort(node, limit=None)
        if isinstance(node, LimitNode):
            return self._compile_limit(node)
        raise NotImplementedError(type(node))

    def _compile_scan(self, node: ScanNode, pred: Optional[Expr],
                      columns: Optional[Sequence[str]] = None) -> Compiled:
        table, version = self.catalog.get_versioned(node.table)
        selected = list(range(table.num_partitions))
        if pred is not None and self.enable_map_pruning:
            kept = []
            for i in selected:
                if may_match(pred, table.partitions[i].stats()):
                    kept.append(i)
            self.metrics.pruned_partitions += len(selected) - len(kept)
            selected = kept
        self.metrics.scanned_partitions += len(selected)
        cols = list(columns) if columns is not None else list(table.schema.names)
        if self.scan_cache is not None:
            rdd = self.scan_cache.get_or_create(
                self.ctx, table, version, cols, selected)
        else:
            rdd = self.ctx.scan(table, cols, selected)
        return Compiled(rdd, cols, table=table,
                        scan_filtered=pred is not None,
                        size_hint=float(table.nbytes))

    # -- compiled pipeline segments (DESIGN.md §10) ---------------------------

    def _make_runner(self, seg: PipelineSegment, consumer: str
                     ) -> Tuple[Compiled, SegmentRunner]:
        """Compile the scan under a segment (map pruning against the folded
        predicate, §3.5) and build its per-partition runner + metrics
        record."""
        scanc = self._compile_scan(seg.scan, seg.pred)
        record = SegmentRecord(
            table=seg.scan.table, depth=seg.depth, consumer=consumer,
            outputs=seg.output_names(self.catalog),
            pred=repr(seg.pred) if seg.pred is not None else None)
        self.metrics.segments.append(record)
        runner = SegmentRunner(seg, seg.scan.schema(self.catalog),
                               self.backend, self.pde, record, self.device)
        return scanc, runner

    def _segment_source_rdd(self, scanc: Compiled, seg: PipelineSegment,
                            ensure_nonempty: bool) -> RDD:
        """The scan RDD a segment maps over; blocking consumers (aggregate /
        sort / limit) need at least one partition even when map pruning
        refuted all of them, so substitute a zero-row scan-schema batch."""
        if scanc.rdd.num_partitions > 0 or not ensure_nonempty:
            return scanc.rdd
        schema = seg.scan.schema(self.catalog)
        return self.ctx.parallelize([_empty_batch(list(schema.names),
                                                  schema)])

    def _compile_segment(self, seg: PipelineSegment,
                         consumer: str = "collect") -> Compiled:
        scanc, runner = self._make_runner(seg, consumer)
        rdd = scanc.rdd.map_partitions(lambda s, b: runner.run(b))
        return Compiled(rdd, seg.output_names(self.catalog), None,
                        seg.pred is not None, scanc.size_hint, runner=runner)

    # -- interpreted operators (only ever above shuffle boundaries now) -------

    def _note_interpreted(self, node: Node) -> None:
        self.metrics.interpreted_ops += 1
        n = node
        while isinstance(n, (FilterNode, ProjectNode)):
            n = n.child
        if isinstance(n, ScanNode):
            # the tentpole invariant: this must never happen — scan-path
            # chains always fold into a PipelineSegment
            self.metrics.interpreted_scan_ops += 1

    def _compile_filter(self, node: FilterNode) -> Compiled:
        pred = node.pred
        self._note_interpreted(node)
        if isinstance(node.child, ScanNode):
            child = self._compile_scan(node.child, pred)
        else:
            child = self._compile(node.child)
            child = Compiled(child.rdd, child.names, child.table, True,
                             child.size_hint)

        def apply_filter(split: int, batch: PartitionBatch) -> PartitionBatch:
            ctx = {n: batch.col(n) for n in batch.names()}
            mask = np.asarray(evaluate(pred, ctx).arr)
            return batch.mask(mask)

        rdd = child.rdd.map_partitions(apply_filter)
        return Compiled(rdd, child.names, None, True, child.size_hint)

    def _compile_project(self, node: ProjectNode) -> Compiled:
        self._note_interpreted(node)
        child = self._compile(node.child)
        exprs = node.exprs

        def apply_project(split: int, batch: PartitionBatch) -> PartitionBatch:
            ctx = {n: batch.col(n) for n in batch.names()}
            out = {}
            for name, e in exprs:
                v = evaluate(e, ctx)
                arr = v.arr
                if np.isscalar(arr) or (hasattr(arr, "shape") and arr.shape == ()):
                    arr = np.full(batch.num_rows, arr)
                    v = ColumnVal(arr, v.sdict, v.sorted_dict)
                out[name] = v
            return PartitionBatch(out)

        rdd = child.rdd.map_partitions(apply_project)
        return Compiled(rdd, [n for n, _ in exprs], None, child.scan_filtered,
                        child.size_hint)

    def _materialize_empty(self, compiled: Compiled, child_node: Node
                           ) -> Compiled:
        """Blocking operators (aggregate/sort/limit) need at least one input
        partition to produce their (possibly identity-valued) output; a
        scan whose partitions were ALL map-pruned compiles to a 0-partition
        RDD, so substitute a single zero-row batch with the right schema."""
        if compiled.rdd.num_partitions > 0:
            return compiled
        schema = child_node.schema(self.catalog)
        rdd = self.ctx.parallelize([_empty_batch(compiled.names, schema)])
        return Compiled(rdd, compiled.names, None, compiled.scan_filtered,
                        compiled.size_hint)

    # -- aggregation ---------------------------------------------------------

    def _compile_aggregate(self, node: AggregateNode) -> Compiled:
        group_cols = node.group_by
        aggs = node.aggs
        names = group_cols + [a.out_name for a in aggs]

        seg = fold_pipeline(node.child)
        partitioner = None
        if seg is not None:
            # fused map side: scan→filter→project→partial-aggregate is ONE
            # function per partition, kernel-lowered when the shape allows
            scanc, runner = self._make_runner(seg, "aggregate")
            src = self._segment_source_rdd(scanc, seg, ensure_nonempty=True)
            mesh_partials = None
            if self.mesh is not None and self.backend == "compiled":
                # cluster tier: run the map side sharded over the device
                # mesh; the partial states feed the SAME shuffle/merge
                # reduce below, so semantics and row order match the
                # single-host path by construction
                mesh_partials = self._mesh_partials(src, runner, group_cols,
                                                    aggs)
            if mesh_partials is not None:
                map_rdd = self._prep_exchange(
                    self.ctx.parallelize(mesh_partials))
            elif self._fusion_mode != "off":
                # whole-stage (DESIGN.md §14): the bucket layout is fixed
                # BEFORE the map fn exists because radix bucketing runs
                # inside the stage program — one call per partition
                # from scan to pre-bucketed shuffle pieces
                num_buckets, partitioner = self._bucket_layout(
                    group_cols, src.num_partitions)
                from .stage import StageRunner
                stage = StageRunner(runner, partitioner, num_buckets,
                                    self._fusion_mode, self.pde)
                map_rdd = src.map_partitions(
                    lambda s, b: stage.run_aggregate_stage(b, group_cols,
                                                           aggs))
            else:
                map_rdd = self._prep_exchange(src.map_partitions(
                    lambda s, b: runner.run_aggregate(b, group_cols, aggs)))
        else:
            child = self._materialize_empty(self._compile(node.child),
                                            node.child)

            def map_side(split: int, batch: PartitionBatch) -> PartitionBatch:
                return partial_aggregate(batch, group_cols, aggs)

            map_rdd = self._prep_exchange(child.rdd.map_partitions(map_side))

        if partitioner is None:
            num_buckets, partitioner = self._bucket_layout(
                group_cols, map_rdd.num_partitions)

        dep = self._new_shuffle(
            map_rdd, num_buckets, partitioner,
            accumulators=lambda: [SizeAccumulator(num_buckets)] + (
                [HeavyHitterAccumulator(group_cols[0])] if group_cols else []))

        if (not group_cols and self._fusion_mode != "off"
                and self._pipeline_gate(dep)):
            # single-bucket boundary: no PDE re-planning consumes the map
            # stats, so the reduce can start as soon as pieces land —
            # pipelined map→reduce overlap (DESIGN.md §14)
            rrunner = self._reduce_runner("merge_aggregate", names)
            reduce_fn = lambda split, b: rrunner.merge(b, group_cols, aggs)
            return self._pipelined_single_reduce(dep, names, reduce_fn)

        stats = self.ctx.scheduler.run_map_stage(dep)
        self.metrics.shuffled_bytes += stats.total_output_bytes()

        if self.enable_pde and group_cols:
            decision = decide_parallelism(stats, num_buckets, self.pde)
            self.metrics.reducer_decisions.append(decision.reason)
            groups = decision.bucket_groups
        else:
            groups = [[b] for b in range(num_buckets)]

        rrunner = self._reduce_runner("merge_aggregate", names)
        reduce_fn = lambda split, b: rrunner.merge(b, group_cols, aggs)
        rdd = ShuffledRDD(dep, groups, reduce_fn)
        return Compiled(rdd, names)

    def _bucket_layout(self, group_cols: Sequence[str], num_maps: int):
        """(num_buckets, partitioner) for an aggregation boundary — split
        out so the fused path can fix the layout before building map fns;
        byte-identical to the legacy inline computation."""
        if not group_cols:
            return 1, single_bucket()
        num_buckets = max(self.default_shuffle_buckets, num_maps)
        return num_buckets, bucket_by_composite(list(group_cols), num_buckets,
                                                kernel=self._radix_kernel)

    def _pipeline_gate(self, dep: ShuffleDependency) -> bool:
        """Admission check for the map→reduce overlap (DESIGN.md §14): the
        boundary pipelines only when the executor pool has slots free of
        map tasks; otherwise it takes the sequential pull fetch over the
        SAME shuffle blocks (the fused map side is unaffected)."""
        d = decide_pipelined_reduce(dep.parent.num_partitions,
                                    self.ctx.scheduler.max_threads,
                                    self._fusion_mode, self.pde)
        self.metrics.pipeline_decisions.append(d.reason)
        return d.route == "pipelined"

    def _pipelined_single_reduce(self, dep: ShuffleDependency,
                                 names: List[str], reduce_fn) -> Compiled:
        """Run a single-bucket boundary with the pipelined scheduler: the
        reduce thread consumes map pieces as they land, and the result RDD
        serves the precomputed batch (falling back to the ordinary fetch
        path if the pipelined attempt lost a race with a failure)."""
        groups = [[0]]
        pipe_fn = (lambda split, pieces:
                   reduce_fn(split, PartitionBatch.concat(pieces)))
        stats, pre = self.ctx.scheduler.run_map_stage_pipelined(
            dep, groups, pipe_fn)
        self.metrics.shuffled_bytes += stats.total_output_bytes()
        rdd = PipelinedShuffledRDD(dep, groups, reduce_fn)
        rdd.offer_precomputed(pre)
        return Compiled(rdd, names)

    # -- mesh-sharded map side (cluster tier, DESIGN.md §13.1) ----------------

    def _mesh_partials(self, src: RDD, runner: "SegmentRunner",
                       group_cols, aggs) -> Optional[List[PartitionBatch]]:
        """Compute the aggregate's partial states on the device mesh.

        Eligibility is the kernel shape check the single-host routes use
        (`_agg_kernel_shape`) narrowed to numeric columns; anything else
        returns None and the single-host map side runs (a route of the
        plan, not a device fallback).  The colscan shape launches one
        `colscan` a partition on its slot; the group-by shape runs the
        radix exchange across slots and partial-aggregates each slot's
        received rows.  Either way the output is a list of partial-state
        batches that feed the standard shuffle + merge, so the final rows
        (and their order) are produced by exactly the single-host reduce
        path.
        """
        shape = runner._agg_kernel_shape(group_cols, aggs)
        if shape is None:
            return None
        from ..cluster import shard_exec
        mesh = self.mesh
        before = mesh.retries
        batches = self.ctx.scheduler.run_result_stage(src)
        try:
            if shape[0] == "colscan":
                _, fcol, lo, hi, vcol = shape
                fvals, avals, int_sum = [], [], False
                for b in batches:
                    fv, vv = b.col(fcol), b.col(vcol)
                    if fv.is_string or vv.is_string:
                        return None
                    varr = np.asarray(vv.arr)
                    int_sum = int_sum or np.issubdtype(varr.dtype, np.integer)
                    fvals.append(np.asarray(fv.arr, np.float64))
                    avals.append(varr.astype(np.float64, copy=False))
                stats, report = shard_exec.mesh_colscan(
                    mesh, fvals, avals, float(lo), float(hi))
                out = []
                for (cnt, s, mn, mx), b in zip(stats, batches):
                    out.append(runner._colscan_result(
                        aggs, float(cnt), float(s), float(mn), float(mx),
                        int_sum))
                    runner._note("mesh-colscan", b.num_rows, 1,
                                 float(b.nbytes))
            else:                                   # ("groupby_mxu", g, v)
                _, gsrc, vcol = shape
                keys, vals = [], ([] if vcol is not None else None)
                kdt = None
                for b in batches:
                    gv = b.col(gsrc)
                    karr = np.asarray(gv.arr)
                    if gv.is_string or not np.issubdtype(karr.dtype,
                                                         np.integer):
                        return None     # exchange hashes integer key lanes
                    kdt = karr.dtype
                    keys.append(karr)
                    if vcol is not None:
                        vv = b.col(vcol)
                        if vv.is_string:
                            return None
                        vals.append(np.asarray(vv.arr))
                # each slot reduces its received rows on its device; only
                # the partial states come back
                per_dev, report = shard_exec.mesh_group_exchange(
                    mesh, keys, vals,
                    reduce=lambda kd, vd: (
                        slot_groupby(kd, vd, kdt, group_cols, aggs,
                                     runner.cfg),
                        int(kd.shape[0])))
                self.metrics.mesh_shipped_rows += report["shipped_rows"]
                out = []
                for pb, rows in per_dev:
                    # bytes of the received keys in their own dtype
                    runner._note("mesh-exchange", rows, pb.num_rows,
                                 float(rows * np.dtype(kdt).itemsize))
                    out.append(pb)
        except ExprCompileError:
            return None
        self.metrics.mesh_partitions += len(batches)
        self.metrics.mesh_devices = report["devices"]
        self.metrics.mesh_retries += mesh.retries - before
        return out

    # -- joins ----------------------------------------------------------------

    def _fetch_shuffle_recovering(self, dep, buckets) -> List[PartitionBatch]:
        """Master-side shuffle fetch with lineage recovery: a worker lost
        between the map stage and this fetch (e.g. mid multi-way join) only
        costs recomputation of its map tasks (§2.3)."""
        from .runtime import FetchFailed
        retries = self.ctx.scheduler.max_stage_retries
        for attempt in range(retries + 1):
            try:
                return self.ctx.block_manager.fetch_shuffle(
                    dep.shuffle_id, dep.parent.num_partitions, buckets)
            except FetchFailed as ff:
                if attempt == retries:
                    raise RuntimeError(
                        "exceeded max stage retries fetching broadcast "
                        "side") from ff
                self.ctx.scheduler._recover_map_outputs(dep, ff.missing_maps)
        raise AssertionError("unreachable")

    def _record_boundary(self, strategy: str, build_side: Optional[str],
                         left_bytes: float, right_bytes: float,
                         num_reducers: int, reason: str,
                         skewed_buckets: Optional[List[int]] = None,
                         skew_shards: int = 0,
                         hot_keys: Optional[List[object]] = None
                         ) -> JoinBoundaryDecision:
        dec = JoinBoundaryDecision(
            boundary=len(self.metrics.join_boundaries), strategy=strategy,
            build_side=build_side, left_bytes=left_bytes,
            right_bytes=right_bytes, num_reducers=num_reducers,
            skewed_buckets=skewed_buckets or [], skew_shards=skew_shards,
            hot_keys=hot_keys or [], reason=reason)
        self.metrics.join_boundaries.append(dec)
        return dec

    def _fused_exchange(self, side: Compiled, partitioner,
                        num_buckets: int) -> RDD:
        """Map-side exchange for one join input.  When the side is a
        compiled segment map and whole-stage fusion is on, bucket
        assignment + per-bucket slicing chain into the segment's map task
        (MapPartitionsRDD composes in-task): the task ships a BucketedBatch
        of finished pieces, skipping the scheduler's host-assembly copy
        (DESIGN.md §14).  `partitioner` MUST be the same closure the
        ShuffleDependency carries, so fused and seam-by-seam pieces are
        byte-identical.  Falls back to the legacy prep for interpreted /
        non-segment sides and small partitions.

        Bare unfiltered scans have no SegmentRunner (the PR-8 legacy-seam
        gap): synthesize a pass-through segment for them so their exchange
        buckets in-task too — observable as a `<table>->exchange-passthrough`
        record in ExecMetrics.segments."""
        if self._fusion_mode == "off":
            return self._prep_exchange(side.rdd)
        if side.runner is None:
            if side.table is None:
                return self._prep_exchange(side.rdd)
            side = dataclasses.replace(
                side, runner=self._passthrough_runner(side.table))
        runner = side.runner
        mode = self._fusion_mode
        cfg = self.pde

        def bucketize(split: int, batch: PartitionBatch):
            d = decide_stage_fusion(batch.num_rows, mode, runner.backend,
                                    "coded", cfg)
            if d.route != "whole-stage":
                return batch
            bucket_of = partitioner(batch)
            pieces = split_bucket_pieces(batch, bucket_of, num_buckets)
            if getattr(runner, "_passthrough", False):
                # synthesized bare-scan segment: no run_routed() ever fires,
                # so tally the partition here for the route assertion
                runner._note("passthrough", batch.num_rows, batch.num_rows,
                             float(batch.nbytes))
            runner._note_fused("exchange")
            return BucketedBatch(pieces)

        return side.rdd.map_partitions(bucketize)

    def _passthrough_runner(self, table: Table) -> SegmentRunner:
        """Compiled pass-through segment for a bare unfiltered scan feeding
        an exchange: no predicate, no projections — it exists so the fused
        exchange can bucket the scan batch in-task instead of falling back
        to the scheduler's host-assembly seam (PR-8 follow-up)."""
        seg = PipelineSegment(ScanNode(table.name), None, None, 0)
        record = SegmentRecord(
            table=table.name, depth=0, consumer="exchange-passthrough",
            outputs=list(table.schema.names), pred=None)
        self.metrics.segments.append(record)
        runner = SegmentRunner(seg, table.schema, self.backend, self.pde,
                               record, self.device)
        runner._passthrough = True
        return runner

    def _compile_join(self, node: JoinNode) -> Compiled:
        """One join boundary.  Because _compile recurses left-then-right and
        every boundary runs its map stage(s) eagerly, an N-way join is
        re-planned boundary by boundary: each decision below sees the
        *materialized* output of all upstream joins, not compile-time
        guesses (paper §3.1 — the DAG is altered while the query runs)."""
        left = self._compile(node.left)
        right = self._compile(node.right)
        lkey, rkey = node.left_key, node.right_key
        names = left.names + [n if n not in left.names else n + "_r"
                              for n in right.names]
        hint = ((left.size_hint or 0.0) + (right.size_hint or 0.0)
                if (left.size_hint is not None or right.size_hint is not None)
                else None)
        # the output of this boundary is a materialized intermediate: its
        # selectivity has been OBSERVED, so it must not carry the
        # "filtered, likely small" prior into the next boundary
        filtered = False

        # a side with zero compiled partitions (map pruning refuted every
        # partition, §3.5): the inner join is provably empty — skip the
        # boundary entirely; a left join keeps left rows, zero-padding the
        # right columns (the dialect's NULL emulation)
        if left.rdd.num_partitions == 0 or right.rdd.num_partitions == 0:
            self.metrics.join_decisions.append(
                "pruned-empty side: join short-circuited")
            self._record_boundary("empty", None, 0.0, 0.0, 0,
                                  "a side was pruned to zero partitions")
            if node.how == "inner" or left.rdd.num_partitions == 0:
                return Compiled(self.ctx.parallelize([]), names)
            rschema = node.right.schema(self.catalog)
            lnames = list(left.names)

            def pad_right(split: int, batch: PartitionBatch) -> PartitionBatch:
                out = dict(batch.cols)
                n = batch.num_rows
                for f in rschema.fields:
                    name = f.name if f.name not in lnames else f.name + "_r"
                    empty = _empty_batch([f.name], rschema).cols[f.name]
                    arr = np.zeros(n, np.asarray(empty.arr).dtype)
                    sdict = (np.array([""]) if empty.sdict is not None
                             else None)
                    out[name] = ColumnVal(arr, sdict, True)
                return PartitionBatch(out)

            return Compiled(left.rdd.map_partitions(pad_right), names,
                            size_hint=hint)

        # §3.4 co-partitioned tables: zip corresponding partitions, no shuffle
        if (node.strategy in (JoinStrategy.AUTO, JoinStrategy.COPARTITION)
                and left.table is not None and right.table is not None
                and left.table.co_partitioned_with(right.table, lkey, rkey)):
            self.metrics.join_decisions.append("copartition: zip, no shuffle")
            self._record_boundary(
                "copartition", None, left.size_hint or 0.0,
                right.size_hint or 0.0, left.rdd.num_partitions,
                "co-partitioned zip, no shuffle")
            zrunner = self._reduce_runner("join_probe", names)
            rdd = ZipPartitionsRDD(
                left.rdd, right.rdd,
                lambda s, l, r: zrunner.join(l, r, lkey, rkey, node.how))
            return Compiled(rdd, names, size_hint=hint, scan_filtered=filtered)

        if node.strategy == JoinStrategy.BROADCAST:
            return self._broadcast(left, right, lkey, rkey, node.how,
                                   "planner-forced broadcast", names,
                                   broadcast_side="right")
        if node.strategy == JoinStrategy.SHUFFLE or not self.enable_pde:
            return self._shuffle_join(left, right, lkey, rkey, node.how,
                                      names, note="planner-forced shuffle")

        # ---- AUTO: Partial DAG Execution (§3.1.1 + §6.3.2) ----
        num_buckets = max(self.default_shuffle_buckets,
                          left.rdd.num_partitions,
                          right.rdd.num_partitions)
        first = likely_small_side(left.size_hint, right.size_hint,
                                  left.scan_filtered, right.scan_filtered)
        first = first or "right"
        a, b = (left, right) if first == "left" else (right, left)
        akey, bkey = (lkey, rkey) if first == "left" else (rkey, lkey)

        apart = bucket_by_hash(akey, num_buckets, kernel=self._radix_kernel)
        adep = self._new_shuffle(
            self._fused_exchange(a, apart, num_buckets), num_buckets, apart,
            accumulators=lambda: [SizeAccumulator(num_buckets),
                                  HeavyHitterAccumulator(akey)])
        astats = self.ctx.scheduler.run_map_stage(adep)
        decision = decide_join(astats, None, self.pde)
        # broadcasting the non-preserved side of an outer join is invalid
        broadcast_ok = node.how == "inner" or (node.how == "left"
                                               and first == "right")
        if decision.choice == JoinChoice.BROADCAST_LEFT and broadcast_ok:
            # observed small: broadcast `a`, never pre-shuffle `b` (the 3x
            # win — the large table sees exactly one wave of map tasks).
            self.metrics.join_decisions.append(
                f"PDE map-join: broadcast {'left' if first == 'left' else 'right'} "
                f"({decision.left_bytes:.0f}B observed); large side not shuffled")
            small = PartitionBatch.concat(
                self._fetch_shuffle_recovering(adep, list(range(num_buckets))))
            self.metrics.broadcast_bytes += small.nbytes
            observed = float(small.nbytes)
            lb, rb = ((observed, right.size_hint or 0.0) if first == "left"
                      else (left.size_hint or 0.0, observed))
            self._record_boundary(
                "broadcast", first, lb, rb, b.rdd.num_partitions,
                decision.reason)
            brunner = self._reduce_runner("join_probe", names)
            if first == "left":
                # inner join is symmetric; emit left-major column order
                rdd = b.rdd.map_partitions(
                    lambda s, big: _reorder(brunner.join(
                        small, big, akey, bkey, node.how), names))
            else:
                rdd = b.rdd.map_partitions(
                    lambda s, big: _reorder(brunner.join(
                        big, small, bkey, akey, node.how), names))
            return Compiled(rdd, names, size_hint=hint, scan_filtered=filtered)

        # not small: pre-shuffle the other side too, aligned buckets
        self.metrics.join_decisions.append(
            f"PDE shuffle-join: first side observed {decision.left_bytes:.0f}B "
            f"> threshold; shuffling both")
        self.metrics.shuffled_bytes += astats.total_output_bytes()
        bpart = bucket_by_hash(bkey, num_buckets, kernel=self._radix_kernel)
        bdep = self._new_shuffle(
            self._fused_exchange(b, bpart, num_buckets), num_buckets, bpart,
            accumulators=lambda: [SizeAccumulator(num_buckets),
                                  HeavyHitterAccumulator(bkey)])
        bstats = self.ctx.scheduler.run_map_stage(bdep)
        self.metrics.shuffled_bytes += bstats.total_output_bytes()

        lstats, rstats = (astats, bstats) if first == "left" else (bstats, astats)
        ldep, rdep = (adep, bdep) if first == "left" else (bdep, adep)
        sdecision = decide_skew_join(lstats, rstats, num_buckets, node.how,
                                     self.pde,
                                     left_maps=ldep.parent.num_partitions,
                                     right_maps=rdep.parent.num_partitions)
        self.metrics.reducer_decisions.append(sdecision.reason)
        self._record_boundary(
            "shuffle", None, lstats.total_output_bytes(),
            rstats.total_output_bytes(), sdecision.num_reducers,
            sdecision.reason, skewed_buckets=sdecision.skewed_buckets,
            skew_shards=sum(1 for s in sdecision.splits
                            if isinstance(s, SkewShard)),
            hot_keys=sdecision.hot_keys)

        rdd = JoinShuffledRDD(ldep, rdep, sdecision.splits, lkey, rkey,
                              node.how,
                              runner=self._reduce_runner("join_probe", names))
        return Compiled(rdd, names, size_hint=hint, scan_filtered=filtered)

    def _broadcast(self, left: Compiled, right: Compiled, lkey: str,
                   rkey: str, how: str, note: str, names: List[str],
                   broadcast_side: str) -> Compiled:
        small, big = (right, left) if broadcast_side == "right" else (left, right)
        skey, bkey = (rkey, lkey) if broadcast_side == "right" else (lkey, rkey)
        self.metrics.join_decisions.append(note)
        collected = PartitionBatch.concat(
            self.ctx.scheduler.run_result_stage(
                self._prep_exchange(small.rdd)))
        self.metrics.broadcast_bytes += collected.nbytes
        observed = float(collected.nbytes)
        lb, rb = ((observed, big.size_hint or 0.0)
                  if broadcast_side == "left"
                  else (big.size_hint or 0.0, observed))
        self._record_boundary("broadcast", broadcast_side, lb, rb,
                              big.rdd.num_partitions, note)
        brunner = self._reduce_runner("join_probe", names)
        if broadcast_side == "right":
            rdd = big.rdd.map_partitions(
                lambda s, part: _reorder(
                    brunner.join(part, collected, bkey, skey, how), names))
        else:
            rdd = big.rdd.map_partitions(
                lambda s, part: _reorder(
                    brunner.join(collected, part, skey, bkey, how), names))
        return Compiled(rdd, names)

    def _shuffle_join(self, left: Compiled, right: Compiled, lkey: str,
                      rkey: str, how: str, names: List[str],
                      note: str) -> Compiled:
        num_buckets = max(self.default_shuffle_buckets,
                          left.rdd.num_partitions, right.rdd.num_partitions)
        self.metrics.join_decisions.append(note)
        lpart = bucket_by_hash(lkey, num_buckets, kernel=self._radix_kernel)
        ldep = self._new_shuffle(
            self._fused_exchange(left, lpart, num_buckets), num_buckets,
            lpart, accumulators=lambda: [SizeAccumulator(num_buckets)])
        rpart = bucket_by_hash(rkey, num_buckets, kernel=self._radix_kernel)
        rdep = self._new_shuffle(
            self._fused_exchange(right, rpart, num_buckets), num_buckets,
            rpart, accumulators=lambda: [SizeAccumulator(num_buckets)])
        ls = self.ctx.scheduler.run_map_stage(ldep)
        rs = self.ctx.scheduler.run_map_stage(rdep)
        self.metrics.shuffled_bytes += (ls.total_output_bytes()
                                        + rs.total_output_bytes())
        self._record_boundary("shuffle", None, ls.total_output_bytes(),
                              rs.total_output_bytes(), num_buckets, note)
        groups = [[b] for b in range(num_buckets)]
        rdd = JoinShuffledRDD(ldep, rdep, groups, lkey, rkey, how,
                              runner=self._reduce_runner("join_probe", names))
        return Compiled(rdd, names)

    # -- sort / limit ----------------------------------------------------------

    def _compile_sort(self, node: SortNode, limit: Optional[int]) -> Compiled:
        keys = node.keys
        seg = fold_pipeline(node.child)
        if seg is not None:
            # fused sort prefix: segment + per-partition top-k in one step
            scanc, runner = self._make_runner(seg, "sort")
            src = self._segment_source_rdd(scanc, seg, ensure_nonempty=True)
            names = seg.output_names(self.catalog)
            # ORDER BY <dot-product score> DESC LIMIT k over a segment
            # whose lanes survive projection: the per-partition top-k is
            # the topk_similarity kernel's route (DESIGN.md §15.3)
            topk = (_match_topk(seg, keys[0][0], names)
                    if limit is not None and len(keys) == 1 and keys[0][1]
                    else None)

            if self._fusion_mode != "off":
                # whole-stage (DESIGN.md §14): the sorted prefix ships as
                # one zero-copy piece straight into the shuffle block
                from .stage import StageRunner
                stage = StageRunner(runner, single_bucket(), 1,
                                    self._fusion_mode, self.pde, topk=topk)
                map_rdd = src.map_partitions(
                    lambda s, b: stage.run_sort_stage(b, keys, limit))
            else:
                def seg_sort(split: int,
                             batch: PartitionBatch) -> PartitionBatch:
                    b = runner.run(batch)
                    idx = _sort_indices(b, keys)
                    if limit is not None:
                        idx = idx[:limit]
                    return b.take(idx)

                map_rdd = self._prep_exchange(
                    src.map_partitions(seg_sort))
            child = Compiled(map_rdd, names)
        else:
            child = self._materialize_empty(self._compile(node.child),
                                            node.child)

            def local_sort(split: int, batch: PartitionBatch) -> PartitionBatch:
                idx = _sort_indices(batch, keys)
                if limit is not None:
                    idx = idx[:limit]
                return batch.take(idx)

            # per-partition top-k, then single merge task (ORDER BY ... LIMIT)
            map_rdd = self._prep_exchange(
                child.rdd.map_partitions(local_sort))
        dep = self._new_shuffle(map_rdd, 1, single_bucket(),
                                accumulators=lambda: [SizeAccumulator(1)])

        def final(split: int, batch: PartitionBatch) -> PartitionBatch:
            idx = _sort_indices(batch, keys)
            if limit is not None:
                idx = idx[:limit]
            return batch.take(idx)

        if self._fusion_mode != "off" and self._pipeline_gate(dep):
            pipe_fn = (lambda split, pieces:
                       final(split, PartitionBatch.concat(pieces)))
            _stats, pre = self.ctx.scheduler.run_map_stage_pipelined(
                dep, [[0]], pipe_fn)
            rdd = PipelinedShuffledRDD(dep, [[0]], final)
            rdd.offer_precomputed(pre)
            return Compiled(rdd, child.names)

        self.ctx.scheduler.run_map_stage(dep)
        rdd = ShuffledRDD(dep, [[0]], final)
        return Compiled(rdd, child.names)

    def _compile_limit(self, node: LimitNode) -> Compiled:
        if isinstance(node.child, SortNode):
            return self._compile_sort(node.child, node.n)
        n = node.n
        seg = fold_pipeline(node.child)
        if seg is not None:
            # fused pushed-down limit: segment + head(n) in one step
            scanc, runner = self._make_runner(seg, "limit")
            src = self._segment_source_rdd(scanc, seg, ensure_nonempty=True)
            if self._fusion_mode != "off":
                # whole-stage (DESIGN.md §14): surviving columns ship
                # encoded straight into the shuffle block as one zero-copy
                # piece — the pass-through host-assembly seam fix
                from .stage import StageRunner
                stage = StageRunner(runner, single_bucket(), 1,
                                    self._fusion_mode, self.pde)
                head_rdd = src.map_partitions(
                    lambda s, b: stage.run_limit_stage(b, n))
            else:
                head_rdd = src.map_partitions(
                    lambda s, b: runner.run(b).head(n))
            child = Compiled(head_rdd, seg.output_names(self.catalog))
            prepped = (head_rdd if self._fusion_mode != "off"
                       else self._prep_exchange(head_rdd))
        else:
            child = self._materialize_empty(self._compile(node.child),
                                            node.child)

            # §2.4: LIMIT pushed to partitions, final limit at collect
            head_rdd = child.rdd.map_partitions(lambda s, b: b.head(n))
            prepped = self._prep_exchange(head_rdd)

        # wrap as a one-partition RDD via shuffle to a single bucket
        dep = self._new_shuffle(prepped, 1, single_bucket())
        final = lambda s, b: b.head(n)
        if self._fusion_mode != "off" and self._pipeline_gate(dep):
            pipe_fn = (lambda split, pieces:
                       final(split, PartitionBatch.concat(pieces)))
            _stats, pre = self.ctx.scheduler.run_map_stage_pipelined(
                dep, [[0]], pipe_fn)
            rdd = PipelinedShuffledRDD(dep, [[0]], final)
            rdd.offer_precomputed(pre)
            return Compiled(rdd, child.names)
        self.ctx.scheduler.run_map_stage(dep)
        rdd = ShuffledRDD(dep, [[0]], final)
        return Compiled(rdd, child.names)


def _match_topk(seg: PipelineSegment, key: str,
                output_names: List[str]) -> Optional[Tuple[List[str],
                                                           np.ndarray]]:
    """(lane columns, query weights) when the sort key is a dot-product
    score — a sum of Col*Lit products over distinct numeric lanes, the
    shape `SharkFrame.similarity_join` (and its SQL twin) emits.  The lanes
    must survive the segment's projection: the kernel recomputes the tiled
    dot product from the lane columns of the segment output.  Returns None
    for anything else, keeping the generic lexsort path."""
    if seg.exprs is None:
        return None
    expr = next((e for n, e in seg.exprs if n == key), None)
    if expr is None:
        return None
    terms: List[Tuple[str, float]] = []

    def walk(e: Expr) -> bool:
        if isinstance(e, BinOp) and e.op == "+":
            return walk(e.left) and walk(e.right)
        if isinstance(e, BinOp) and e.op == "*":
            a, b = e.left, e.right
            if isinstance(a, Col) and isinstance(b, Lit) and _is_num(b.value):
                terms.append((a.name, float(b.value)))
                return True
            if isinstance(b, Col) and isinstance(a, Lit) and _is_num(a.value):
                terms.append((b.name, float(a.value)))
                return True
        return False

    if not walk(expr) or len(terms) < 2:
        return None
    lanes = [n for n, _ in terms]
    out = set(output_names)
    if len(set(lanes)) != len(lanes) or not all(n in out for n in lanes):
        return None
    return lanes, np.asarray([w for _, w in terms], np.float64)


def _empty_batch(names: List[str], schema) -> PartitionBatch:
    """A zero-row batch carrying the right columns (and string-ness), so
    blocking operators behave identically whether their input is empty
    because rows were filtered or because map pruning refuted every
    partition (§3.5)."""
    from .types import DType
    cols: Dict[str, ColumnVal] = {}
    for name in names:
        field = schema.field(name) if name in schema else None
        if field is not None and field.dtype == DType.STRING:
            cols[name] = ColumnVal(np.zeros(0, np.int32),
                                   np.array([], dtype=np.str_), True)
        else:
            dt = field.dtype.np_dtype if field is not None else np.float64
            cols[name] = ColumnVal(np.zeros(0, dt), None, True)
    return PartitionBatch(cols)


def _reorder(batch: PartitionBatch, names: List[str]) -> PartitionBatch:
    cols = {}
    for n in names:
        if n in batch.cols:
            cols[n] = batch.cols[n]
    for n, v in batch.cols.items():
        if n not in cols:
            cols[n] = v
    return PartitionBatch(cols)


def _sort_indices(batch: PartitionBatch, keys: List[Tuple[str, bool]]
                  ) -> np.ndarray:
    arrays = []
    for name, desc in reversed(keys):
        v = batch.col(name)
        if v.is_string and v.sorted_dict:
            # sorted dictionaries make code order string order: ORDER BY on
            # a dict-coded column never decodes (dictionary-preserving
            # exchange keeps this true across the shuffle)
            a = np.asarray(v.arr)
        elif v.is_string:
            a = v.decoded()
        else:
            a = np.asarray(v.arr)
        if desc:
            if a.dtype.kind in ("U", "S"):
                # lexsort has no descending: sort by negated rank
                _, inv = np.unique(a, return_inverse=True)
                a = -inv
            else:
                a = -a
        arrays.append(a)
    return np.lexsort(arrays) if arrays else np.arange(batch.num_rows)


def _stats_from_sizes(sizes: np.ndarray) -> StageStats:
    from .stats import TaskStats, encode_size
    st = StageStats(-1)
    st.add(TaskStats(0, -1, {
        "sizes": {"codes": np.array([encode_size(int(s)) for s in sizes],
                                    np.uint8),
                  "records": np.zeros(len(sizes), np.int64)}}))
    return st
