"""The frame / SQL plan property on the torch port against the JAX
reference: a deterministic twin of tests/test_frame_property.py.

Its derandomized Hypothesis examples (the same on every run) each build
the query on both packages (`torch_twin.twin_given`); the two surfaces
must give one plan in each, and the port's `explain()` text and
`plan_fingerprint` must equal the reference's byte for byte.  The
reference's docstring follows.

Property test (hypothesis): any generated filter+group+agg query built
through the fluent SharkFrame API and through SQL text optimizes to an
identical plan — same `explain()`, same `plan_fingerprint` — so the two
surfaces share result-cache entries by construction (DESIGN.md §7)."""

import numpy as np
import pytest

pytest.importorskip("hypothesis")

from hypothesis import strategies as st

from torch_twin import P, per_pkg, twin_given


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
    s.create_table("t", P.Schema.of(a=P.DType.INT64, b=P.DType.INT64,
                                  v=P.DType.FLOAT64),
                   {"a": rng.integers(0, 20, 500).astype(np.int64),
                    "b": rng.integers(0, 50, 500).astype(np.int64),
                    "v": rng.uniform(0, 1, 500)})
    return s


AGGS = {"SUM": "sum_", "AVG": "avg", "MIN": "min_", "MAX": "max_"}

CMP_OPS = {">": lambda c, v: c > v, "<": lambda c, v: c < v,
           ">=": lambda c, v: c >= v, "<=": lambda c, v: c <= v,
           "=": lambda c, v: c == v, "!=": lambda c, v: c != v}


def _property_frame_sql_same_plan(sess, pred_col, op, threshold,
                                      group_col, agg_name, agg_col,
                                      distinct_count, limit):
    sql_text = (f"SELECT {group_col}, {agg_name}({agg_col}) AS x, "
                + (f"COUNT(DISTINCT {pred_col}) AS u, " if distinct_count
                   else "")
                + f"COUNT(*) AS c FROM t WHERE {pred_col} {op} {threshold} "
                f"GROUP BY {group_col}")
    if limit is not None:
        sql_text += f" ORDER BY c DESC LIMIT {limit}"

    aggs = [getattr(P, AGGS[agg_name])(P.col(agg_col)).alias("x")]
    if distinct_count:
        aggs.append(P.count_distinct(P.col(pred_col)).alias("u"))
    aggs.append(P.count().alias("c"))
    frame = (sess.table("t")
             .filter(CMP_OPS[op](P.col(pred_col), threshold))
             .group_by(P.col(group_col))
             .agg(*aggs))
    if limit is not None:
        frame = frame.order_by("c", desc=True).limit(limit)

    assert frame.explain() == sess.explain(sql_text), (
        f"plans diverge for {sql_text!r}:\n--- frame ---\n{frame.explain()}"
        f"\n--- sql ---\n{sess.explain(sql_text)}")
    sql_node = P.m("core.plan").optimize(sess.plan(sql_text), sess.catalog)
    fp_sql, deps_sql = P.m("server.result_cache").plan_fingerprint(sql_node, sess.catalog)
    fp_frame, deps_frame = P.m("server.result_cache").plan_fingerprint(frame.optimized_plan(),
                                            sess.catalog)
    assert fp_sql == fp_frame and deps_sql == deps_frame
    return {"explain": frame.explain(), "fingerprint": fp_sql,
            "deps": deps_sql}


def test_property_frame_sql_same_plan(sess):
    twin_given(lambda: (
        st.sampled_from(["a", "b"]),                         # pred_col
        st.sampled_from(sorted(CMP_OPS)),                    # op
        st.integers(min_value=0, max_value=50),              # threshold
        st.sampled_from(["a", "b"]),                         # group_col
        st.sampled_from(sorted(AGGS)),                       # agg_name
        st.sampled_from(["v", "b"]),                         # agg_col
        st.booleans(),                                       # distinct_count
        st.one_of(st.none(), st.integers(min_value=1, max_value=10)),
    ), _property_frame_sql_same_plan, sess, max_examples=40)
