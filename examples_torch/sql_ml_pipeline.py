"""Paper Listing 1 via the fluent SharkFrame API on the PyTorch port:
relational selection -> feature extraction -> distributed logistic
regression, one lineage graph end to end (with a node failure in the
middle of training to prove it) — and zero SQL-string plumbing between
stages.  The reference's `examples/sql_ml_pipeline.py` on `repro_torch`,
with its seeds, sizes and printed lines.

    PYTHONPATH=src python examples_torch/sql_ml_pipeline.py [--device cpu]

It computes on the card unless `--device cpu` is given, and raises
without one; the estimators train where the session computes.
"""

import argparse

import numpy as np

from repro_torch.core import DType, Schema, SharkSession, col
from repro_torch.ml import KMeans, LogisticRegression


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    n, d = 50_000, 10
    w_true = rng.normal(size=d)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ w_true + rng.normal(scale=0.2, size=n) > 0).astype(np.float32)

    sess = SharkSession(num_workers=4, max_threads=4, device=args.device)
    cols = {f"f{i}": X[:, i] for i in range(d)}
    cols["is_spammer"] = y
    sess.create_table("users", Schema.of(
        **{f"f{i}": DType.FLOAT32 for i in range(d)},
        is_spammer=DType.FLOAT32), cols, num_partitions=8)

    # the frame is the query plan — lazy, composable, same lineage graph the
    # executor and the ML layer extend
    users = sess.table("users").filter(col("f0") > -3)
    print("SharkFrame columns:", users.columns)
    print(users.explain())

    # .to_features() leaves the final narrow stage lazy (Listing 1's
    # mapRows); the cached feature RDD is reused across .fit() calls below
    feature_cols = [f"f{i}" for i in range(d)]
    feats = users.to_features(feature_cols, "is_spammer")
    clf = LogisticRegression(dims=d, lr=0.5, iterations=5).fit(feats)
    print(f"after 5 iters: accuracy = {(clf.predict(X) == y).mean():.4f}")

    # node failure mid-training: lineage recomputes that worker's partitions
    sess.ctx.scheduler.kill_worker(1)
    clf.iterations = 10
    clf.fit(feats)
    print(f"after failure + 10 more iters: accuracy = "
          f"{(clf.predict(X) == y).mean():.4f} "
          f"(recomputed {sess.ctx.scheduler.tasks_recomputed} tasks)")

    # k-means over the same cached features — no data movement; estimators
    # also accept the frame directly: KMeans(...).fit(users, feature_cols=...)
    km = KMeans(k=4, dims=d, iterations=10).fit(feats)
    print(f"k-means objective: {km.objective_history[0]:.0f} -> "
          f"{km.objective_history[-1]:.0f}")
    sess.shutdown()


if __name__ == "__main__":
    main()
