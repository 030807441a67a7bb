"""Multi-tenant SharkServer demo (DESIGN.md §6) on the PyTorch port: the
reference's `examples/multi_tenant.py` on `repro_torch`, with its seeds,
sizes and printed lines.

One shared warehouse, two tenants:

  * `etl`   — weight 1, floods the server with scan-heavy group-bys;
  * `dash`  — weight 4, fires small interactive point queries.

The weighted fair scheduler keeps the dashboard's latency low while the
flood is in progress; the unified memory manager runs the cached working
set under a budget smaller than the data (evicting + recomputing from
lineage); repeated dashboard queries are served from the plan-fingerprint
result cache until an ETL `CREATE TABLE` bumps the catalog epoch and
invalidates exactly the dependent entries.

    PYTHONPATH=src python examples_torch/multi_tenant.py [--device cpu]

It computes on the card unless `--device cpu` is given, and raises
without one.  The server's counters differ from the reference's where
its memory manager's rungs do (ROADMAP C.6, C.7).
"""

import argparse
import json
import time

import numpy as np

from repro_torch.core import DType, Schema
from repro_torch.server import SharkServer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(11)
    n = 300_000
    data = {
        "user": rng.integers(0, 5_000, n).astype(np.int64),
        "lat_ms": rng.gamma(2.0, 30.0, n),
        "status": rng.choice(np.array([200, 200, 200, 404, 500],
                                      np.int32), n),
    }

    srv = SharkServer(num_workers=8, max_threads=8,
                      cache_budget_bytes=2 << 20,   # < working set
                      max_concurrent_queries=4, max_queue_depth=64,
                      default_partitions=16, default_shuffle_buckets=16,
                      device=args.device)
    srv.create_table("logs", Schema.of(user=DType.INT64,
                                       lat_ms=DType.FLOAT64,
                                       status=DType.INT32), data)

    etl = srv.session("etl", weight=1.0)
    dash = srv.session("dash", weight=4.0)

    # ETL tenant floods the queue with heavy aggregations (async handles)
    flood = [etl.submit("SELECT user, SUM(lat_ms) AS total, COUNT(*) AS c "
                        f"FROM logs WHERE status < {s} GROUP BY user")
             for s in (300, 401, 404, 500, 501, 502)]

    # interactive tenant: small repeated dashboard queries
    dash_latencies = []
    for _ in range(8):
        t0 = time.perf_counter()
        errors = dash.sql_np(
            "SELECT COUNT(*) AS c FROM logs WHERE status = 500")
        dash_latencies.append(time.perf_counter() - t0)
    print(f"dashboard: {int(errors['c'][0])} errors; per-query latency "
          f"{[round(t * 1e3, 2) for t in dash_latencies]} ms "
          "(first is cold, rest are result-cache hits)")

    for h in flood:
        h.result()
    print(f"etl flood done: {len(flood)} heavy queries")

    # an ETL load mutates the warehouse -> dependent cache entries drop
    srv.sql("CREATE TABLE errors_only AS SELECT user, lat_ms FROM logs "
            "WHERE status = 500")
    t0 = time.perf_counter()
    dash.sql_np("SELECT COUNT(*) AS c FROM logs WHERE status = 500")
    print(f"after CREATE TABLE (epoch bump, logs untouched): "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms "
          "(still a hit: only tables a plan READS invalidate it)")

    print(json.dumps(srv.stats(), indent=2, default=str))
    srv.shutdown()


if __name__ == "__main__":
    main()
