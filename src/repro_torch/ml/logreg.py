"""Distributed logistic regression over RDD partitions (paper §4.1 Listing 1,
§6.5 Figure 11; DESIGN.md §15.2).

Each iteration is a PDE-scheduled map stage over the cached feature RDD:
every partition routes through `decide_train_backend` — numpy oracle,
fused assemble+train (decode of encoded blocks on the device, then the
gradient in torch), or the `train_grad` kernel — and the master reduces
the per-partition gradients, exactly the paper's
`data.map(gradient).reduce(+)` loop.  A lost worker only recomputes its
partitions (lineage), even mid-iteration.

After `fit()`, `self.metrics` (an ExecMetrics) carries one SegmentRecord
per iteration with the routes taken, plus `train_iterations` timings.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..kernels.train_grad import stable_sigmoid
from ._device import as_tensor, promoted, returned


def _loss_kernel(w: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    logits = x @ w
    return torch.sum(torch.logaddexp(torch.zeros_like(logits), logits)
                     - y * logits)


class LogisticRegression:
    def __init__(self, dims: int, lr: float = 0.1, iterations: int = 10,
                 seed: int = 0):
        self.dims = dims
        self.lr = lr
        self.iterations = iterations
        rng = np.random.default_rng(seed)
        self.w = rng.normal(scale=0.01, size=dims).astype(np.float32)
        self.loss_history: List[float] = []
        self.metrics = None
        # the device of the session fit() ran on: predict's default
        self.device = None

    def fit(self, data, feature_cols=None, label_col=None,
            map_rows=None, dtype=np.float32) -> "LogisticRegression":
        """Train over feature partitions.  `data` is a FeatureRDD (or a
        legacy featurized RDD), or a SharkFrame / TableRDD with
        `feature_cols`/`label_col` naming the columns to featurize — the
        paper's Listing-1 pipeline as one fluent chain on one lineage
        graph.  `dtype` sets the feature compute dtype when featurizing
        here (float32 default; see featurize module docstring).  Training
        runs on the device of the session that built `data`."""
        from .featurize import as_features_rdd
        from .trainer import IterativeTrainer
        features_rdd = as_features_rdd(data, feature_cols, label_col,
                                       map_rows, dtype)
        features_rdd.cache()
        trainer = IterativeTrainer(features_rdd, "logreg", dtype=dtype)
        self.metrics = trainer.metrics
        self.device = features_rdd.ctx.device
        for _ in range(self.iterations):
            g, n = trainer.gradient_iteration(self.w, "logistic")
            self.w = self.w - self.lr * (g / max(n, 1)).astype(self.w.dtype)
        return self

    def loss(self, data, feature_cols=None, label_col=None) -> float:
        from ..core.batch import PartitionBatch
        from ..core.expr import ColumnVal
        from .featurize import as_features_rdd, partition_xy_host
        features_rdd = as_features_rdd(data, feature_cols, label_col)
        fcols = getattr(features_rdd, "feature_cols", None)
        lcol = getattr(features_rdd, "label_col", None)
        sched = features_rdd.ctx.scheduler
        dev = features_rdd.ctx.device
        w = torch.from_numpy(self.w).to(dev)

        def map_loss(split: int, batch: PartitionBatch) -> PartitionBatch:
            x, y = partition_xy_host(batch, fcols, lcol, np.float32)
            val = float(_loss_kernel(
                w, torch.from_numpy(x).to(dev),
                torch.from_numpy(y.astype(np.float32)).to(dev)))
            return PartitionBatch({
                "loss": ColumnVal(np.array([val])),
                "count": ColumnVal(np.array([x.shape[0]], np.int64))})

        parts = sched.run_result_stage(features_rdd.map_partitions(map_loss))
        total = sum(float(np.asarray(b.col("loss").arr)[0]) for b in parts)
        n = sum(int(np.asarray(b.col("count").arr)[0]) for b in parts)
        return total / max(n, 1)

    def predict_proba(self, x, device=None):
        """sigmoid(x @ w) on x's device (numpy x: on `device`, by default the
        device it was fitted on); numpy in, numpy out."""
        xt, from_np = as_tensor(x, device, self.device)
        xt, w = promoted(xt, self.w)
        return returned(stable_sigmoid(xt @ w), from_np)

    def predict(self, x, device=None):
        xt, from_np = as_tensor(x, device, self.device)
        return returned((self.predict_proba(xt) >= 0.5).to(torch.int32),
                        from_np)
