"""Quickstart on the PyTorch port: the Shark engine in 60 lines — columnar
store, the fluent SharkFrame API (and its SQL twin), map pruning, PDE join
selection, and mid-query fault tolerance.  The reference's
`examples/quickstart.py` on `repro_torch`, with its seeds, sizes and
printed lines.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

It computes on the card unless `--device cpu` is given, and raises
without one.
"""

import argparse

import numpy as np

from repro_torch.core import DType, Schema, SharkSession, col, count, sum_


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    sess = SharkSession(num_workers=4, max_threads=4, default_partitions=8,
                        device=args.device)
    rng = np.random.default_rng(0)

    # -- load a warehouse table into the columnar memory store ---------------
    n = 200_000
    sess.create_table(
        "visits",
        Schema.of(day=DType.INT32, url=DType.STRING, revenue=DType.FLOAT64),
        {"day": np.sort(rng.integers(0, 30, n)).astype(np.int32),  # clustered
         "url": np.array([f"url{i}" for i in rng.integers(0, 5000, n)]),
         "revenue": rng.uniform(0, 10, n)},
        num_partitions=16)

    # -- selection with map pruning: only partitions overlapping day 7 scan --
    r = (sess.table("visits").filter(col("day") == 7)
         .select("url", "revenue").to_numpy())
    m = sess.metrics()
    print(f"day=7 rows: {len(r['url'])}  "
          f"(pruned {m.pruned_partitions}/16 partitions without launching "
          f"tasks)")

    # -- aggregation with PDE reducer coalescing; HAVING trims small groups --
    daily = (sess.table("visits").group_by(col("day"))
             .agg(count().alias("n"), sum_(col("revenue")).alias("rev"))
             .having(col("rev") > 100))
    r = daily.to_numpy()
    print(f"{len(r['day'])} groups; PDE: "
          f"{sess.metrics().reducer_decisions[-1]}")

    # -- join: PDE observes the filtered dim table is small -> broadcast join
    # (SQL text binds to the identical plan: sess.sql("SELECT lang, ...") )
    sess.create_table(
        "pages", Schema.of(purl=DType.STRING, lang=DType.STRING),
        {"purl": np.array([f"url{i}" for i in range(5000)]),
         "lang": np.array(["en", "de", "fr", "jp"])[rng.integers(0, 4, 5000)]})
    r = (sess.table("visits").join("pages", on=("url", "purl"))
         .filter(col("lang") == "de")
         .group_by(col("lang")).agg(sum_(col("revenue")).alias("rev"))
         .to_numpy())
    print(f"join result: {dict(zip(r['lang'], np.round(r['rev'], 1)))}")
    print(f"join plan: {sess.metrics().join_decisions[-1]}")

    # -- kill a worker mid-session: lineage recomputes lost partitions -------
    # .cache(name) is the fluent CREATE TABLE ... AS — materialize + register
    sess.table("visits").filter(col("day") < 10).select("day", "revenue") \
        .cache("cache_demo")
    sess.ctx.scheduler.kill_worker(0)
    r = sess.table("cache_demo").agg(count().alias("c")).to_numpy()
    print(f"after killing worker 0: COUNT = {r['c'][0]} "
          f"(recomputed {sess.ctx.scheduler.tasks_recomputed} tasks via "
          f"lineage)")

    sess.shutdown()


if __name__ == "__main__":
    main()
