"""Distributed k-means clustering (paper §6.5, Figure 12; DESIGN.md §15.2).

Per iteration, every cached feature partition computes its per-centroid
point sums/counts and objective in one assemble+assign step on the
session's device (assignment via expansion-trick distances, x @ c.T in
`torch.matmul`; encoded block decode in the same step), scheduled as a
map stage under the PDE; the master reduces the stats and recomputes
centroids.  The workflow is the paper's: SQL select -> feature extraction
-> 10 iterations, all in-memory.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ._device import as_tensor, promoted, returned


class KMeans:
    def __init__(self, k: int, dims: int, iterations: int = 10, seed: int = 0):
        self.k = k
        self.dims = dims
        self.iterations = iterations
        rng = np.random.default_rng(seed)
        self.centroids = rng.normal(size=(k, dims)).astype(np.float32)
        self.objective_history: List[float] = []
        self.metrics = None
        # the device of the session fit() ran on: predict's default
        self.device = None

    def fit(self, data, feature_cols=None, label_col=None,
            map_rows=None, dtype=np.float32) -> "KMeans":
        """`data`: a features RDD, or a SharkFrame / TableRDD plus
        `feature_cols` (featurized on the same lineage graph).  Clustering
        ignores labels, but `label_col` still excludes that column from the
        default feature set when `feature_cols` is omitted."""
        from .featurize import as_features_rdd
        from .trainer import IterativeTrainer
        features_rdd = as_features_rdd(data, feature_cols, label_col,
                                       map_rows, dtype)
        features_rdd.cache()
        trainer = IterativeTrainer(features_rdd, "kmeans", dtype=dtype)
        self.metrics = trainer.metrics
        self.device = features_rdd.ctx.device
        for _ in range(self.iterations):
            sums, counts, obj = trainer.kmeans_iteration(self.centroids)
            self.objective_history.append(obj)
            nonzero = counts > 0
            self.centroids = self.centroids.copy()
            self.centroids[nonzero] = (
                sums[nonzero] / counts[nonzero, None]).astype(np.float32)
        return self

    def predict(self, x, device=None):
        """Nearest centroid of each row, on x's device (numpy x: on
        `device`, by default the device it was fitted on); numpy in, numpy
        out."""
        xt, from_np = as_tensor(x, device, self.device)
        xt, c = promoted(xt, self.centroids)
        d2 = (torch.sum(xt * xt, 1, keepdim=True) - 2 * xt @ c.T
              + torch.sum(c * c, 1)[None, :])
        return returned(torch.argmin(d2, dim=1), from_np)
