"""Plan equivalence between the two query surfaces on the torch port
against the JAX reference: the twin of tests/test_frame_sql_equivalence.py,
with its two SharkServer result-cache cases.

Each body runs on both packages (`torch_twin.twin`; the port's sessions
and servers on `device="cpu"`) and asserts what its reference test
asserts; its answers, the plans' `explain()` text and `plan_fingerprint`
(byte-identical across the packages) and the result cache's counters must
equal the reference's.  The reference's docstring follows.

Plan equivalence between the two query surfaces (DESIGN.md §7).

A frame-built query and its SQL-text twin must be *the same query from bind
onward*: identical `explain()` output, identical `plan_fingerprint`, and —
the acceptance bar — one shared result-cache entry on SharkServer (one miss
then one hit across the two surfaces)."""

import numpy as np
import pytest

from torch_twin import P, note, observed, per_pkg, twin


@pytest.fixture(scope="module")
def sess():
    built = per_pkg(_make_sess)
    yield built
    for v in built.values():
        v.shutdown()


def _make_sess():
    rng = np.random.default_rng(0)
    s = P.SharkSession(num_workers=2, max_threads=2, default_partitions=4,
                     default_shuffle_buckets=4)
    n = 500
    s.create_table("t", P.Schema.of(a=P.DType.INT64, b=P.DType.INT64,
                                  v=P.DType.FLOAT64),
                   {"a": rng.integers(0, 20, n).astype(np.int64),
                    "b": rng.integers(0, 50, n).astype(np.int64),
                    "v": rng.uniform(0, 1, n)})
    s.create_table("u", P.Schema.of(a=P.DType.INT64, w=P.DType.FLOAT64),
                   {"a": rng.integers(0, 20, 300).astype(np.int64),
                    "w": rng.uniform(0, 1, 300)})
    return s


def assert_twins(sess, sql_text, frame):
    """Same explain, same fingerprint, for a SQL text and its fluent twin."""
    assert frame.explain() == sess.explain(sql_text), (
        f"plans diverge for {sql_text!r}:\n--- frame ---\n{frame.explain()}"
        f"\n--- sql ---\n{sess.explain(sql_text)}")
    sql_node = P.m("core.plan").optimize(sess.plan(sql_text), sess.catalog)
    fp_sql, _ = P.m("server.result_cache").plan_fingerprint(sql_node, sess.catalog)
    fp_frame, _ = P.m("server.result_cache").plan_fingerprint(frame.optimized_plan(), sess.catalog)
    assert fp_sql == fp_frame
    note(explain=frame.explain(), fingerprint=fp_sql)


# -- fixed representative twins ---------------------------------------------


def _twin_filter_project(sess):
    assert_twins(
        sess, "SELECT a, b FROM t WHERE v > 0.5",
        sess.table("t").filter(P.col("v") > 0.5).select("a", "b"))
    return observed(locals())


def test_twin_filter_project(sess):
    twin(_twin_filter_project, sess)


def _twin_groupby(sess):
    assert_twins(
        sess,
        "SELECT a, SUM(v) AS s, COUNT(*) AS c FROM t WHERE b < 25 "
        "GROUP BY a ORDER BY s DESC LIMIT 5",
        sess.table("t").filter(P.col("b") < 25).group_by(P.col("a"))
        .agg(P.sum_(P.col("v")).alias("s"), P.count().alias("c"))
        .order_by("s", desc=True).limit(5))
    return observed(locals())


def test_twin_groupby(sess):
    twin(_twin_groupby, sess)


def _twin_join_aggregate(sess):
    assert_twins(
        sess,
        "SELECT t.a, SUM(w) AS sw FROM t JOIN u ON t.a = u.a GROUP BY a",
        sess.table("t").join(sess.table("u"), on="a")
        .group_by(P.col("a")).agg(P.sum_(P.col("w")).alias("sw")))
    return observed(locals())


def test_twin_join_aggregate(sess):
    twin(_twin_join_aggregate, sess)


def _twin_having(sess):
    assert_twins(
        sess,
        "SELECT a, COUNT(*) AS c FROM t GROUP BY a HAVING c > 20",
        sess.table("t").group_by(P.col("a")).agg(P.count().alias("c"))
        .having(P.col("c") > 20))
    return observed(locals())


def test_twin_having(sess):
    twin(_twin_having, sess)


def _twin_group_expr_alias(sess):
    assert_twins(
        sess,
        "SELECT a % 3 AS g, AVG(v) AS m FROM t GROUP BY a % 3",
        sess.table("t").group_by((P.col("a") % 3).alias("g"))
        .agg(P.avg(P.col("v")).alias("m")))
    return observed(locals())


def test_twin_group_expr_alias(sess):
    twin(_twin_group_expr_alias, sess)


# (the generated-query property test lives in test_frame_property.py, which
# importorskips hypothesis — this module must run everywhere)


# -- acceptance: one result-cache entry across both surfaces -----------------


def _frame_and_sql_share_one_cache_entry():
    rng = np.random.default_rng(5)
    srv = P.m("server").SharkServer(num_workers=2, max_threads=2, default_partitions=4,
                      default_shuffle_buckets=4)
    try:
        srv.create_table("t", P.Schema.of(a=P.DType.INT64, b=P.DType.FLOAT64),
                         {"a": rng.integers(0, 10, 6000).astype(np.int64),
                          "b": rng.uniform(0, 1, 6000)})
        sess = srv.session("mixed")

        # surface 1: fluent frame — submitted as a bound plan
        frame = (sess.table("t").filter(P.col("a") < 8).group_by(P.col("a"))
                 .agg(P.sum_(P.col("b")).alias("s"), P.count().alias("c")))
        r1 = frame.to_numpy()
        stats = srv.stats()["result_cache"]
        assert stats["misses"] == 1 and stats["hits"] == 0

        # surface 2: the SQL-text twin — must HIT the frame's entry
        h = sess.submit("SELECT a, SUM(b) AS s, COUNT(*) AS c FROM t "
                        "WHERE a < 8 GROUP BY a")
        r2 = h.result().to_numpy()
        assert h.cached, "SQL twin must be served from the frame's entry"
        stats = srv.stats()["result_cache"]
        assert stats["misses"] == 1 and stats["hits"] == 1
        assert stats["entries"] == 1, "both surfaces must share ONE entry"

        # and the reverse direction: a fresh identical frame also hits
        again = (sess.table("t").filter(P.col("a") < 8).group_by(P.col("a"))
                 .agg(P.sum_(P.col("b")).alias("s"), P.count().alias("c")))
        again.collect()
        assert srv.stats()["result_cache"]["hits"] == 2

        assert sorted(r1["a"].tolist()) == sorted(r2["a"].tolist())
        assert np.allclose(sorted(r1["s"]), sorted(r2["s"]))

        # frame queries ride the fair scheduler like any other query
        served = srv.stats()["scheduler"]["clients"]["mixed"]["served"]
        assert served == 3
    finally:
        srv.shutdown()
    return observed(locals())


def test_frame_and_sql_share_one_cache_entry():
    twin(_frame_and_sql_share_one_cache_entry)


def _frame_cache_entry_invalidated_by_catalog_epoch():
    rng = np.random.default_rng(6)
    srv = P.m("server").SharkServer(num_workers=2, max_threads=2, default_partitions=4,
                      default_shuffle_buckets=4)
    try:
        srv.create_table("t", P.Schema.of(a=P.DType.INT64, b=P.DType.FLOAT64),
                         {"a": rng.integers(0, 10, 2000).astype(np.int64),
                          "b": rng.uniform(0, 1, 2000)})
        sess = srv.session("w")
        frame = sess.table("t").group_by(P.col("a")).agg(
            P.count().alias("c"))
        n1 = int(frame.to_numpy()["c"].sum())
        assert n1 == 2000
        # mutate t: epoch bump must invalidate the frame's cache entry
        srv.create_table("t", P.Schema.of(a=P.DType.INT64, b=P.DType.FLOAT64),
                         {"a": rng.integers(0, 10, 999).astype(np.int64),
                          "b": rng.uniform(0, 1, 999)})
        fresh = sess.table("t").group_by(P.col("a")).agg(P.count().alias("c"))
        assert int(fresh.to_numpy()["c"].sum()) == 999
    finally:
        srv.shutdown()
    return observed(locals())


def test_frame_cache_entry_invalidated_by_catalog_epoch():
    twin(_frame_cache_entry_invalidated_by_catalog_epoch)


