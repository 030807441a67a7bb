"""PDE-scheduled iterative training (DESIGN.md §15.2).

Each training iteration is a real map stage under the Scheduler — the
same `run_map_stage` machinery SQL shuffles use — not a private loop:

  * the per-partition step maps over the CACHED FeatureRDD, so iteration
    i > 0 reads worker-resident (encoded, byte-accounted) blocks whose
    streams already sit in device memory;
  * the step's gradient/stats payload materializes as single-bucket
    shuffle output; the master fetches the per-map pieces and reduces
    them host-side (an O(dims) sum — the paper's map(gradient).reduce(+));
  * chaos mid-iteration is survivable for free: a dead worker's map task
    retries elsewhere (WorkerLost), its lost cache blocks recompute from
    lineage, and lost shuffle pieces recover via `_recover_lineage` — the
    steps are deterministic, so the final model is identical to a
    failure-free run (asserted by tests/test_torch_ml.py);
  * each partition routes through `pde.decide_train_backend`: the numpy
    oracle for tiny partitions, the fused assemble+train step (decode on
    the device, then the gradient in torch), or the `train_grad` kernel on
    large partitions on a GPU or when forced.

Training runs on the device of the context that built the features RDD
(`rdd.ctx.device`, the session's): a `device="cpu"` session trains on the
CPU on a host that has a card, and a session on the card never trains on
the CPU beyond the PDE's numpy route for tiny partitions.

Observability mirrors the SQL executor: one `SegmentRecord` per iteration
(table `<train:name>`, consumer "train") tallies partitions/rows/routes,
and `ExecMetrics.train_iterations` records per-iteration wall-clock —
the estimators expose the ExecMetrics as `.metrics` after fit().
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.batch import PartitionBatch
from ..core.expr import ColumnVal
from ..core.pde import PDEConfig, decide_train_backend
from ..core.physical import ExecMetrics, SegmentRecord
from ..core.rdd import RDD, ShuffleDependency, ShuffledRDD
from ..core.runtime import FetchFailed
from ..core.shuffle import single_bucket
from ..kernels.ops import on_gpu
from .featurize import (FeatureRDD, fused_train_step, partition_recipes,
                        partition_xy_host)


def _np_sigmoid(z: np.ndarray) -> np.ndarray:
    out = np.empty_like(z)
    pos = z >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-z[pos]))
    ez = np.exp(z[~pos])
    out[~pos] = ez / (1.0 + ez)
    return out


def _on(device, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def partition_grad(batch: PartitionBatch, w: np.ndarray, kind: str,
                   cfg: PDEConfig, dtype, feature_cols, label_col, device,
                   w_dev: Optional[torch.Tensor] = None):
    """(route, unnormalized gradient) for one feature partition, routed by
    the PDE.  All three routes compute the same sum-of-residual-weighted
    features; they differ only in where the decode and the products run.
    `w_dev` is `w` on `device`, when the caller already copied it there."""
    n = batch.num_rows
    d = decide_train_backend(n, len(w), "train_grad", on_gpu(device), cfg)
    if d.route == "numpy":
        x, y = partition_xy_host(batch, feature_cols, label_col, dtype)
        z = x @ w.astype(dtype)
        p = _np_sigmoid(z) if kind == "logistic" else z
        return "numpy", (x.T @ (p - y.astype(dtype))).astype(dtype)
    if w_dev is None:
        w_dev = _on(device, w)
    sigs, col_args, lsig, largs = partition_recipes(batch, feature_cols,
                                                    label_col, device)
    if d.route == "train_grad":
        from ..kernels import ops
        # x and y stay on the device: the kernel reads the assembled matrix
        x, y = fused_train_step("assemble", sigs, lsig, dtype)(
            w_dev, col_args, largs)
        g = ops.train_grad(x, y, w_dev.to(x.dtype), kind)
        return "train_grad", g.cpu().numpy().astype(dtype)
    g = fused_train_step(kind, sigs, lsig, dtype)(w_dev, col_args, largs)
    return "jit", g.cpu().numpy()


def partition_kmeans_stats(batch: PartitionBatch, centroids: np.ndarray,
                           cfg: PDEConfig, dtype, feature_cols, device,
                           c_dev: Optional[torch.Tensor] = None):
    """(route, sums, counts, objective) for one partition's assignment
    step.  No dedicated kernel (the reference leaves the assignment's
    products to XLA; here `torch.matmul` computes x @ c.T), so
    kernel_eligible is None."""
    n = batch.num_rows
    d = decide_train_backend(n, centroids.shape[1], None, on_gpu(device),
                             cfg)
    if d.route == "numpy":
        x, _ = partition_xy_host(batch, feature_cols, None, dtype)
        c = centroids.astype(dtype)
        d2 = ((x * x).sum(1, keepdims=True) - 2.0 * (x @ c.T)
              + (c * c).sum(1)[None, :])
        assign = np.argmin(d2, axis=1)
        obj = float(np.min(d2, axis=1).sum())
        sums = np.zeros_like(c)
        np.add.at(sums, assign, x)
        counts = np.bincount(assign, minlength=c.shape[0]).astype(dtype)
        return "numpy", sums, counts, obj
    if c_dev is None:
        c_dev = _on(device, centroids)
    sigs, col_args, lsig, largs = partition_recipes(batch, feature_cols,
                                                    None, device)
    sums, counts, obj = fused_train_step("kmeans", sigs, None, dtype)(
        c_dev, col_args, ())
    return ("jit", sums.cpu().numpy(), counts.cpu().numpy(),
            float(obj.cpu()))


class IterativeTrainer:
    """Drives an estimator's iterations as scheduled map stages over a
    cached features RDD (module docstring)."""

    def __init__(self, features_rdd: RDD, name: str,
                 cfg: Optional[PDEConfig] = None,
                 metrics: Optional[ExecMetrics] = None,
                 dtype=np.float32):
        self.rdd = features_rdd
        self.name = name
        self.cfg = cfg or PDEConfig()
        self.metrics = metrics or ExecMetrics()
        self.sched = features_rdd.ctx.scheduler
        self.bm = features_rdd.ctx.block_manager
        self.device = features_rdd.ctx.device
        self.iteration = 0
        if isinstance(features_rdd, FeatureRDD):
            self.feature_cols = features_rdd.feature_cols
            self.label_col = features_rdd.label_col
            if features_rdd.map_rows is None:
                self.dtype = features_rdd.dtype
            else:
                self.dtype = np.dtype(dtype)
        else:
            # legacy featurized RDD: dense 'features'/'label' layout
            self.feature_cols = None
            self.label_col = None
            self.dtype = np.dtype(dtype)

    def run_stage(self, make_payload: Callable[[int, PartitionBatch],
                                               Dict[str, ColumnVal]]
                  ) -> List[PartitionBatch]:
        """One iteration: map `make_payload` over every feature partition
        as a scheduled single-bucket map stage, return the per-map payload
        pieces (master reduces them).  `make_payload` must be
        deterministic — lineage recovery re-runs it."""
        record = SegmentRecord(table=f"<train:{self.name}>", depth=0,
                               consumer="train", outputs=[], pred=None)
        self.metrics.segments.append(record)
        lock = threading.Lock()

        def note(route: str, rows: int) -> None:
            with lock:
                record.partitions += 1
                record.rows_in += rows
                record.routes[route] = record.routes.get(route, 0) + 1

        def step(split: int, batch: PartitionBatch) -> PartitionBatch:
            route, payload = make_payload(split, batch)
            note(route, batch.num_rows)
            return PartitionBatch(payload)

        payload_rdd = self.rdd.map_partitions(step)
        dep = ShuffleDependency(payload_rdd, 1, single_bucket())
        # recovery anchor: _recover_lineage locates lost shuffles by walking
        # an RDD's dependency DAG, and `dep` only appears BELOW a reduce-side
        # RDD — the payload rdd is dep's parent, not its consumer
        fetch_root = ShuffledRDD(dep)
        t0 = time.perf_counter()
        self.sched.run_map_stage(dep)
        pieces: List[PartitionBatch] = []
        for _ in range(self.sched.max_stage_retries):
            try:
                pieces = self.bm.fetch_shuffle(
                    dep.shuffle_id, payload_rdd.num_partitions, [0])
                break
            except FetchFailed as ff:     # worker died after the map stage
                self.sched._recover_lineage(fetch_root, ff)
        else:
            raise RuntimeError("exceeded max stage retries (train fetch)")
        elapsed = time.perf_counter() - t0
        # per-iteration shuffle output is consumed exactly once: drop it so
        # a 100-iteration fit doesn't pin 100 generations of (tiny) blocks
        self.bm.drop_shuffle(dep.shuffle_id)
        self.metrics.train_iterations.append({
            "iteration": self.iteration, "seconds": elapsed,
            "rows": record.rows_in, "routes": dict(record.routes)})
        self.iteration += 1
        return pieces

    def gradient_iteration(self, w: np.ndarray, kind: str):
        """(summed gradient, total rows) across all partitions."""
        w_dev = _on(self.device, w)       # one copy per iteration

        def payload(split, batch):
            route, g = partition_grad(batch, w, kind, self.cfg, self.dtype,
                                      self.feature_cols, self.label_col,
                                      self.device, w_dev)
            return route, {"grad": ColumnVal(g[None, :]),
                           "count": ColumnVal(
                               np.array([batch.num_rows], np.int64))}

        pieces = self.run_stage(payload)
        g = np.sum([np.asarray(p.col("grad").arr)[0] for p in pieces],
                   axis=0)
        n = int(sum(np.asarray(p.col("count").arr)[0] for p in pieces))
        return g, n

    def kmeans_iteration(self, centroids: np.ndarray):
        """(per-centroid sums, counts, total objective)."""
        c_dev = _on(self.device, centroids)

        def payload(split, batch):
            route, sums, counts, obj = partition_kmeans_stats(
                batch, centroids, self.cfg, self.dtype, self.feature_cols,
                self.device, c_dev)
            return route, {"sums": ColumnVal(sums[None]),
                           "counts": ColumnVal(counts[None]),
                           "obj": ColumnVal(np.array([obj]))}

        pieces = self.run_stage(payload)
        sums = np.sum([np.asarray(p.col("sums").arr)[0] for p in pieces],
                      axis=0)
        counts = np.sum([np.asarray(p.col("counts").arr)[0]
                         for p in pieces], axis=0)
        obj = float(sum(np.asarray(p.col("obj").arr)[0] for p in pieces))
        return sums, counts, obj
