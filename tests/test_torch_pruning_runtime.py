"""Map pruning soundness and the fault-tolerant runtime on the torch port
against the JAX reference: the twin of tests/test_pruning_runtime.py.

Each body runs on both packages (`torch_twin.twin`; the port's sessions on
`device="cpu"`); its answers and what it returns (pruning verdicts, row
counts, recovered groups) must equal the reference's.  The Hypothesis
property runs derandomized, so every run draws the same examples.
"""

import time

import numpy as np
import pytest

pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st

from torch_twin import P, twin


# ---------------------------------------------------------------------------
# Map pruning
# ---------------------------------------------------------------------------

def _property_pruning_sound(values, lo, hi):
    """If may_match says False, the partition truly has no matching row —
    pruning must never drop results (paper §3.5 is an optimization, not an
    approximation)."""
    lo, hi = min(lo, hi), max(lo, hi)
    schema = P.Schema.of(x=P.DType.INT64)
    t = P.m("core.columnar").from_arrays("t", schema, {"x": np.asarray(values, np.int64)},
                    num_partitions=3)
    preds = [
        P.m("core.expr").Between(P.Col("x"), lo, hi),
        P.m("core.expr").Cmp(">", P.Col("x"), P.m("core.expr").Lit(lo)),
        P.m("core.expr").Cmp("=", P.Col("x"), P.m("core.expr").Lit(lo)),
        P.m("core.expr").And(P.m("core.expr").Cmp(">=", P.Col("x"), P.m("core.expr").Lit(lo)), P.m("core.expr").Cmp("<=", P.Col("x"), P.m("core.expr").Lit(hi))),
        P.m("core.expr").Or(P.m("core.expr").Cmp("<", P.Col("x"), P.m("core.expr").Lit(lo)), P.m("core.expr").Cmp(">", P.Col("x"), P.m("core.expr").Lit(hi))),
        P.m("core.expr").Not(P.m("core.expr").Cmp("=", P.Col("x"), P.m("core.expr").Lit(lo))),
        P.m("core.expr").InList(P.Col("x"), (lo, hi)),
    ]
    verdicts = []
    for pred in preds:
        for p in t.partitions:
            verdicts.append(P.m("core.pruning").may_match(pred, p.stats()))
            if not verdicts[-1]:
                ctx = {"x": P.m("core.expr").ColumnVal(
                    p.columns["x"].values())}
                mask = np.asarray(P.m("core.expr").evaluate(pred, ctx).arr)
                assert not mask.any(), (pred, p.index)
    return verdicts


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.lists(st.integers(0, 1000), min_size=1, max_size=200),
       st.integers(0, 1000), st.integers(0, 1000))
def test_property_pruning_sound(values, lo, hi):
    twin(_property_pruning_sound, values, lo, hi)


def _pruning_clustered_scan_reduction():
    sess = P.SharkSession(num_workers=2, max_threads=2)
    n = 64000
    sess.create_table("logs", P.Schema.of(ts=P.DType.INT64, v=P.DType.FLOAT64),
                      {"ts": np.arange(n, dtype=np.int64),
                       "v": np.random.default_rng(0).normal(size=n)},
                      num_partitions=32)
    r = sess.sql_np("SELECT ts FROM logs WHERE ts BETWEEN 1000 AND 3000")
    assert len(r["ts"]) == 2001
    m = sess.metrics()
    assert m.pruned_partitions >= 30  # only 1-2 of 32 partitions overlap
    sess.shutdown()
    return m.pruned_partitions


def test_pruning_clustered_scan_reduction():
    twin(_pruning_clustered_scan_reduction)


def _pruning_enum_distinct():
    sess = P.SharkSession(num_workers=2, max_threads=2)
    country = np.repeat(np.array(["US", "CA", "DE", "FR"]), 1000)
    sess.create_table("t", P.Schema.of(c=P.DType.STRING),
                      {"c": country}, num_partitions=4)
    r = sess.sql_np("SELECT COUNT(*) AS n FROM t WHERE c = 'DE'")
    assert r["n"][0] == 1000
    assert sess.metrics().pruned_partitions == 3  # loaded in order -> 1 hit
    sess.shutdown()
    return sess.metrics().pruned_partitions


def test_pruning_enum_distinct():
    twin(_pruning_enum_distinct)


# ---------------------------------------------------------------------------
# Fault tolerance (paper §2.3, §6.3.3)
# ---------------------------------------------------------------------------

def _mk_session():
    rng = np.random.default_rng(7)
    sess = P.SharkSession(num_workers=4, max_threads=4, default_partitions=8)
    sess.create_table("lineitem", P.Schema.of(k=P.DType.INT64, v=P.DType.FLOAT64),
                      {"k": rng.integers(0, 40, 30000).astype(np.int64),
                       "v": rng.normal(size=30000)})
    return sess


def _worker_loss_cached_table():
    sess = _mk_session()
    scan = sess.ctx.scan(sess.catalog.get("lineitem")).cache()
    sess.ctx.scheduler.run_result_stage(scan)  # materialize cache
    dropped = sess.ctx.scheduler.kill_worker(0)
    assert dropped > 0
    batches = sess.ctx.scheduler.run_result_stage(scan)
    assert sum(b.num_rows for b in batches) == 30000
    sess.shutdown()
    return sorted(np.concatenate([np.asarray(b.col("k").arr)
                                  for b in batches]).tolist())


def test_worker_loss_cached_table():
    twin(_worker_loss_cached_table)


def _midquery_shuffle_recovery():
    """Lose map outputs AFTER the map stage, BEFORE reduce: the reduce's
    FetchFailed triggers lineage recompute of exactly the lost maps."""
    sess = _mk_session()
    optimize = P.m("core.plan").optimize
    Binder = P.m("core.sql").Binder
    parse = P.m("core.sql").parse
    node = Binder(sess.catalog).bind(
        parse("SELECT k, COUNT(*) AS c, SUM(v) AS s FROM lineitem GROUP BY k"))
    node = optimize(node, sess.catalog)
    compiled = sess.executor._compile(node)   # map stage runs here
    sess.ctx.scheduler.kill_worker(1)
    sess.ctx.scheduler.kill_worker(2)
    batches = sess.ctx.scheduler.run_result_stage(compiled.rdd)
    merged = P.m("core.batch").PartitionBatch.concat(batches).decoded()
    d = sess.catalog.get("lineitem").to_dict()
    import collections
    refc = collections.Counter(d["k"].tolist())
    got = dict(zip(merged["k"].tolist(), merged["c"].tolist()))
    assert got == dict(refc)
    assert sess.ctx.scheduler.tasks_recomputed > 0
    sess.shutdown()
    return sorted(zip(merged["k"].tolist(), merged["c"].tolist(),
                      merged["s"].tolist()))


def test_midquery_shuffle_recovery():
    twin(_midquery_shuffle_recovery)


def _straggler_speculation():
    """A task 50x slower than its peers gets a speculative backup copy that
    finishes first (paper §2.3 item 3)."""
    sess = P.SharkSession(num_workers=4, max_threads=8, speculation=True)
    sess.ctx.scheduler.speculation_multiplier = 3.0
    batches = [P.m("core.batch").PartitionBatch.from_numpy({"x": np.arange(100)})
               for _ in range(8)]
    rdd = sess.ctx.parallelize(batches)
    slow_calls = {"n": 0}

    def delay(split):
        if split == 7:
            slow_calls["n"] += 1
            return 2.0 if slow_calls["n"] == 1 else 0.0
        return 0.01

    rdd.delay_fn = delay
    t0 = time.monotonic()
    out = sess.ctx.scheduler.run_result_stage(rdd)
    elapsed = time.monotonic() - t0
    assert sum(b.num_rows for b in out) == 800
    assert sess.ctx.scheduler.tasks_speculated >= 1
    assert elapsed < 1.9, f"speculation should beat the 2s straggler, took {elapsed}"
    sess.shutdown()
    return sum(b.num_rows for b in out)


def test_straggler_speculation():
    twin(_straggler_speculation)


def _elastic_add_worker():
    sess = _mk_session()
    sess.ctx.scheduler.kill_worker(0)
    sess.ctx.scheduler.kill_worker(1)
    sess.ctx.scheduler.kill_worker(2)
    w = sess.ctx.scheduler.add_worker()
    assert w >= 4
    r = sess.sql_np("SELECT COUNT(*) AS c FROM lineitem")
    assert r["c"][0] == 30000
    sess.shutdown()


def test_elastic_add_worker():
    twin(_elastic_add_worker)


def _tolerates_loss_of_any_worker_set():
    sess = _mk_session()
    r1 = sess.sql_np("SELECT SUM(v) AS s FROM lineitem")
    for w in (0, 2):
        sess.ctx.scheduler.kill_worker(w)
    r2 = sess.sql_np("SELECT SUM(v) AS s FROM lineitem")
    assert abs(r1["s"][0] - r2["s"][0]) < 1e-6
    sess.shutdown()


def test_tolerates_loss_of_any_worker_set():
    twin(_tolerates_loss_of_any_worker_set)


