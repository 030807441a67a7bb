"""Whole-stage fusion's invariants on the torch port against the JAX
reference: a deterministic twin of tests/test_stage_fusion_property.py.

The fixed grid and the derandomized Hypothesis examples (the same on every
run; `torch_twin.twin_given`) run on both packages, fused and not; in each
package fusion must leave `explain()`, `plan_fingerprint` and the rows as
they are, and the port's plans, fingerprints and rows must equal the
reference's (rows as multisets, floats to rtol 1e-12; a LIMIT without
ORDER BY may pick other rows, so there only the row count is compared).
The reference's docstring follows.

Property test (hypothesis): whole-stage fusion (DESIGN.md §14) is a
physical-layer rewrite — for ANY generated scan→filter→project→aggregate
chain it never changes the optimizer `plan_fingerprint` or the `explain()`
text, and the fused output is row-identical to the segment-at-a-time path.

The hypothesis grid is importorskip-gated; `test_fusion_invariants_sweep`
runs the same invariant check over a fixed grid so the property is still
exercised when hypothesis is absent.
"""

import numpy as np
import pytest

from torch_twin import P, per_pkg, twin, twin_given


AGGS = ("SUM", "AVG", "MIN", "MAX", "COUNT")
CMPS = (">", "<", ">=", "<=", "=", "!=")


@pytest.fixture(scope="module")
def sessions():
    built = per_pkg(_make_sessions)
    yield built
    for out in built.values():
        for sess in out.values():
            sess.shutdown()


def _make_sessions():
    rng = np.random.default_rng(0)
    data = {
        "a": rng.integers(0, 20, 900).astype(np.int64),
        "b": rng.integers(-40, 40, 900).astype(np.int64),
        "v": rng.uniform(0, 10, 900),
        "s": np.array([f"g{i}" for i in rng.integers(0, 6, 900)]),
    }
    schema = P.Schema.of(a=P.DType.INT64, b=P.DType.INT64, v=P.DType.FLOAT64,
                       s=P.DType.STRING)
    out = {}
    for mode in ("off", "force"):
        sess = P.SharkSession(num_workers=2, max_threads=4,
                            default_partitions=3, default_shuffle_buckets=4,
                            stage_fusion=mode)
        sess.create_table("t", schema, data)
        out[mode] = sess
    return out


def _gen_sql(pred_col, op, threshold, shape, group_col, agg_name, agg_col,
             limit):
    where = f"WHERE {pred_col} {op} {threshold}"
    if shape == "groupby":
        agg = (f"{agg_name}({agg_col})" if agg_name != "COUNT"
               else "COUNT(*)")
        return (f"SELECT {group_col}, {agg} AS x, COUNT(*) AS c "
                f"FROM t {where} GROUP BY {group_col}")
    if shape == "agg":
        agg = (f"{agg_name}({agg_col})" if agg_name != "COUNT"
               else "COUNT(*)")
        return f"SELECT {agg} AS x, COUNT(*) AS c FROM t {where}"
    if shape == "sort":
        return (f"SELECT a, b, v FROM t {where} "
                f"ORDER BY v DESC, a LIMIT {limit}")
    return f"SELECT a, b + a AS ba, v FROM t {where} LIMIT {limit}"


def _rows(got):
    cols = [np.asarray(got[k]).tolist() for k in sorted(got)]
    return sorted(zip(*cols)) if cols else []


def _check_one(sessions, sql):
    fps, plans, results = {}, {}, {}
    for mode, sess in sessions.items():
        plans[mode] = sess.explain(sql)
        node = P.m("core.plan").optimize(sess.plan(sql), sess.catalog)
        fps[mode] = P.m("server.result_cache").plan_fingerprint(node, sess.catalog)[0]
        results[mode] = sess.sql_np(sql)
    assert plans["force"] == plans["off"], \
        f"fusion changed explain()\n  {sql}"
    assert fps["force"] == fps["off"], \
        f"fusion changed plan_fingerprint\n  {sql}"
    rows_f, rows_o = _rows(results["force"]), _rows(results["off"])
    assert len(rows_f) == len(rows_o), sql
    for rf, ro in zip(rows_f, rows_o):
        for vf, vo in zip(rf, ro):
            if isinstance(vo, float):
                assert vf == vo or abs(vf - vo) <= 1e-9 + 1e-9 * abs(vo), \
                    f"{vf!r} != {vo!r}\n  {sql}"
            else:
                assert vf == vo, f"{vf!r} != {vo!r}\n  {sql}"
    assert sessions["off"].metrics().fused_partitions() == 0
    unordered_limit = "LIMIT" in sql and "ORDER BY" not in sql
    return {"explain": plans["off"], "fingerprint": fps["off"],
            "rows": (len(rows_o) if unordered_limit
                     else results["off"])}


def _fusion_invariants_sweep(sessions):
    """Deterministic grid over every query shape (runs even without
    hypothesis installed)."""
    cases = [
        ("a", ">", 5, "groupby", "s", "SUM", "v", None),
        ("b", "<=", 0, "groupby", "a", "MIN", "b", None),
        ("v", ">=", 3, "agg", None, "AVG", "v", None),
        ("s", "=", "'g2'", "agg", None, "COUNT", None, None),
        ("a", "!=", 7, "sort", None, None, None, 9),
        ("b", "<", 10, "limit", None, None, None, 5),
    ]
    checked = []
    for pred_col, op, thr, shape, gcol, agg, acol, limit in cases:
        checked.append(_check_one(sessions, _gen_sql(
            pred_col, op, thr, shape, gcol, agg, acol, limit or 7)))
    assert sessions["force"].metrics().fused_partitions() > 0
    return checked


def test_fusion_invariants_sweep(sessions):
    twin(_fusion_invariants_sweep, sessions, rows=True, record=False)


def _property_fusion_never_changes_plan_or_rows(
        sessions, pred_col, op, threshold, shape, group_col, agg_name,
        agg_col, limit):
    return _check_one(sessions, _gen_sql(pred_col, op, threshold, shape,
                                         group_col, agg_name, agg_col,
                                         limit))


def test_property_fusion_never_changes_plan_or_rows(sessions):
    pytest.importorskip("hypothesis")
    from hypothesis import strategies as st
    twin_given(lambda: (
        st.sampled_from(["a", "b", "v"]),                  # pred_col
        st.sampled_from(CMPS),                             # op
        st.integers(min_value=-40, max_value=40),          # threshold
        st.sampled_from(["groupby", "agg", "sort", "limit"]),  # shape
        st.sampled_from(["a", "s"]),                       # group_col
        st.sampled_from(AGGS),                             # agg_name
        st.sampled_from(["v", "b"]),                       # agg_col
        st.integers(min_value=1, max_value=20),            # limit
    ), _property_fusion_never_changes_plan_or_rows, sessions,
        max_examples=40, rows=True)
