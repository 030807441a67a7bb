"""Distributed linear regression (paper §4.1: "We have implemented ... linear
regression, logistic regression, and k-means").

Gradient-descent least squares over cached feature partitions, same
PDE-scheduled map-stage / master-reduce structure as logistic regression
(DESIGN.md §15.2) — routes: numpy oracle / fused assemble+train on the
device / `train_grad` kernel.
"""

from __future__ import annotations

import numpy as np

from ._device import as_tensor, promoted, returned


class LinearRegression:
    def __init__(self, dims: int, lr: float = 0.05, iterations: int = 20,
                 seed: int = 0):
        self.dims = dims
        self.lr = lr
        self.iterations = iterations
        self.w = np.zeros(dims, np.float32)
        self.metrics = None
        # the device of the session fit() ran on: predict's default
        self.device = None

    def fit(self, data, feature_cols=None, label_col=None,
            map_rows=None, dtype=np.float32) -> "LinearRegression":
        """`data`: a features RDD, or a SharkFrame / TableRDD plus
        `feature_cols`/`label_col` (featurized on the same lineage
        graph)."""
        from .featurize import as_features_rdd
        from .trainer import IterativeTrainer
        features_rdd = as_features_rdd(data, feature_cols, label_col,
                                       map_rows, dtype)
        features_rdd.cache()
        trainer = IterativeTrainer(features_rdd, "linreg", dtype=dtype)
        self.metrics = trainer.metrics
        self.device = features_rdd.ctx.device
        for _ in range(self.iterations):
            g, n = trainer.gradient_iteration(self.w, "linear")
            self.w = self.w - self.lr * (g / max(n, 1)).astype(self.w.dtype)
        return self

    def predict(self, x, device=None):
        """x @ w on x's device (numpy x: on `device`, by default the
        device it was fitted on); numpy in, numpy out."""
        xt, from_np = as_tensor(x, device, self.device)
        xt, w = promoted(xt, self.w)
        return returned(xt @ w, from_np)
