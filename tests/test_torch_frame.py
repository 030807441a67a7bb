"""The SharkFrame API on the torch port against the JAX reference: the
twin of tests/test_frame.py (frame-built plans, HAVING on both surfaces,
eager binding errors that name the operation, to_rdd shuffle release on a
shared SharkServer, and ML from a frame).

Each body runs on both packages (`torch_twin.twin`; the port's sessions
and servers on `device="cpu"`), asserts what its reference test asserts,
and its answers and plain-data locals must equal the reference's:
integers and strings exactly, floats to rtol 1e-12.  Models fitted from a
frame are compared to rtol 1e-4: both train in float32 and sum their
gradients in another order, and the reference test's own bar (accuracy
above 0.9) is looser still.  An estimator fitted on a `device="cpu"`
session predicts there with no `device=`.
"""

import collections

import numpy as np
import pytest

from torch_twin import P, observed, per_pkg, raises, twin


@pytest.fixture(scope="module")
def sess():
    built = per_pkg(_make_sess)
    yield built
    for v in built.values():
        v.shutdown()


def _make_sess():
    rng = np.random.default_rng(0)
    s = P.SharkSession(num_workers=4, max_threads=4, default_partitions=6,
                     default_shuffle_buckets=8)
    n = 20000
    s.create_table("rankings", P.Schema.of(
        pageURL=P.DType.STRING, pageRank=P.DType.INT32, avgDuration=P.DType.INT32),
        {"pageURL": np.array([f"url{i % 997}" for i in range(n)]),
         "pageRank": rng.integers(0, 1000, n).astype(np.int32),
         "avgDuration": rng.integers(1, 100, n).astype(np.int32)})
    m = 5000
    s.create_table("uservisits", P.Schema.of(
        sourceIP=P.DType.STRING, destURL=P.DType.STRING,
        adRevenue=P.DType.FLOAT64, visitDate=P.DType.INT32),
        {"sourceIP": np.array([f"10.0.{i % 50}.{i % 7}" for i in range(m)]),
         "destURL": np.array([f"url{i % 997}" for i in range(m)]),
         "adRevenue": rng.uniform(0, 10, m),
         "visitDate": rng.integers(10000, 12000, m).astype(np.int32)})
    return s


def ref(sess, table):
    return sess.catalog.get(table).to_dict()


# -- relational operators ----------------------------------------------------


def _filter_select(sess):
    r = (sess.table("rankings")
         .filter((P.col("pageRank") > 500) & (P.col("avgDuration") < 50))
         .select("pageURL", P.col("pageRank"))
         .to_numpy())
    d = ref(sess, "rankings")
    mask = (d["pageRank"] > 500) & (d["avgDuration"] < 50)
    assert len(r["pageRank"]) == mask.sum()
    assert sorted(r["pageRank"].tolist()) == sorted(
        d["pageRank"][mask].tolist())
    return observed(locals())


def test_filter_select(sess):
    twin(_filter_select, sess)


def _select_expression_alias(sess):
    r = (sess.table("rankings")
         .select((P.col("pageRank") * 2).alias("doubled"))
         .to_numpy())
    d = ref(sess, "rankings")
    assert sorted(r["doubled"].tolist()) == sorted(
        (d["pageRank"] * 2).tolist())
    return observed(locals())


def test_select_expression_alias(sess):
    twin(_select_expression_alias, sess)


def _group_by_agg(sess):
    r = (sess.table("rankings")
         .group_by((P.col("pageRank") % 5).alias("g"))
         .agg(P.count().alias("c"), P.sum_(P.col("avgDuration")).alias("s"),
              P.avg(P.col("avgDuration")).alias("a"))
         .to_numpy())
    d = ref(sess, "rankings")
    g = d["pageRank"] % 5
    for gi, c, s_, a in zip(r["g"], r["c"], r["s"], r["a"]):
        m = g == gi
        assert c == m.sum()
        assert s_ == d["avgDuration"][m].sum()
        assert abs(a - d["avgDuration"][m].mean()) < 1e-9
    return observed(locals())


def test_group_by_agg(sess):
    twin(_group_by_agg, sess)


def _global_agg(sess):
    r = (sess.table("rankings")
         .agg(P.count().alias("c"), P.min_(P.col("pageRank")).alias("mn"),
              P.max_(P.col("pageRank")).alias("mx"),
              P.count_distinct(P.col("pageURL")).alias("u"))
         .to_numpy())
    d = ref(sess, "rankings")
    assert r["c"][0] == len(d["pageRank"])
    assert r["mn"][0] == d["pageRank"].min()
    assert r["mx"][0] == d["pageRank"].max()
    assert r["u"][0] == len(np.unique(d["pageURL"]))
    return observed(locals())


def test_global_agg(sess):
    twin(_global_agg, sess)


def _join_order_limit(sess):
    top = (sess.table("rankings")
           .join(sess.table("uservisits"), on=("pageURL", "destURL"))
           .group_by(P.col("destURL"))
           .agg(P.sum_(P.col("adRevenue")).alias("rev"))
           .order_by("rev", desc=True)
           .limit(10))
    r = top.to_numpy()
    dr, dv = ref(sess, "rankings"), ref(sess, "uservisits")
    url_count = collections.Counter(dr["pageURL"].tolist())
    rev = collections.defaultdict(float)
    for u, a in zip(dv["destURL"], dv["adRevenue"]):
        if url_count[u]:
            rev[u] += a * url_count[u]
    expect = sorted(rev.values(), reverse=True)[:10]
    assert np.allclose(sorted(r["rev"], reverse=True), expect)
    return observed(locals())


def test_join_order_limit(sess):
    twin(_join_order_limit, sess)


def _join_on_expr_and_string_table(sess):
    r = (sess.table("uservisits")
         .join("rankings", on=P.col("destURL") == P.col("pageURL"))
         .filter(P.col("visitDate") > 11500)
         .agg(P.count().alias("c"))
         .to_numpy())
    dr, dv = ref(sess, "rankings"), ref(sess, "uservisits")
    url_count = collections.Counter(dr["pageURL"].tolist())
    vmask = dv["visitDate"] > 11500
    expected = sum(url_count[u] for u in dv["destURL"][vmask])
    assert r["c"][0] == expected
    return observed(locals())


def test_join_on_expr_and_string_table(sess):
    twin(_join_on_expr_and_string_table, sess)


def _substr_groupby_frame(sess):
    r = (sess.table("uservisits")
         .group_by(P.substr(P.col("sourceIP"), 1, 6).alias("p"))
         .agg(P.sum_(P.col("adRevenue")).alias("s"))
         .to_numpy())
    d = ref(sess, "uservisits")
    refsum = collections.defaultdict(float)
    for ip, rv in zip(d["sourceIP"], d["adRevenue"]):
        refsum[ip[:6]] += rv
    got = dict(zip(r["p"].tolist(), r["s"].tolist()))
    assert set(got) == set(refsum)
    return observed(locals())


def test_substr_groupby_frame(sess):
    twin(_substr_groupby_frame, sess)


def _cache_registers_table(sess):
    f = (sess.table("rankings").filter(P.col("pageRank") > 900)
         .cache("high_rank_frame"))
    assert f.columns == ["pageURL", "pageRank", "avgDuration"]
    d = ref(sess, "rankings")
    assert f.count() == (d["pageRank"] > 900).sum()
    # the cached table is a first-class catalog table: SQL sees it too
    r = sess.sql_np("SELECT COUNT(*) AS c FROM high_rank_frame")
    assert r["c"][0] == (d["pageRank"] > 900).sum()
    return observed(locals())


def test_cache_registers_table(sess):
    twin(_cache_registers_table, sess)


# -- HAVING: both surfaces ---------------------------------------------------


def _having_sql_alias_and_aggcall(sess):
    d = ref(sess, "rankings")
    counts = collections.Counter((d["pageRank"] % 7).tolist())
    expect = sorted(g for g, c in counts.items() if c > len(d["pageRank"]) / 7)
    r1 = sess.sql_np("SELECT pageRank % 7 AS g, COUNT(*) AS c FROM rankings "
                     f"GROUP BY pageRank % 7 HAVING c > "
                     f"{len(d['pageRank']) // 7}")
    assert sorted(r1["g"].tolist()) == expect
    # aggregate call form resolves to its SELECT alias
    r2 = sess.sql_np("SELECT pageRank % 7 AS g, COUNT(*) AS c FROM rankings "
                     f"GROUP BY pageRank % 7 HAVING COUNT(*) > "
                     f"{len(d['pageRank']) // 7}")
    assert sorted(r2["g"].tolist()) == expect
    return observed(locals())


def test_having_sql_alias_and_aggcall(sess):
    twin(_having_sql_alias_and_aggcall, sess)


def _having_frame_matches_sql(sess):
    sql = ("SELECT pageRank % 7 AS g, SUM(avgDuration) AS s FROM rankings "
           "GROUP BY pageRank % 7 HAVING s > 100000")
    frame = (sess.table("rankings")
             .group_by((P.col("pageRank") % 7).alias("g"))
             .agg(P.sum_(P.col("avgDuration")).alias("s"))
             .having(P.col("s") > 100000))
    assert frame.explain() == sess.explain(sql)
    got_sql = sess.sql_np(sql)
    got_frame = frame.to_numpy()
    assert sorted(got_sql["g"].tolist()) == sorted(got_frame["g"].tolist())
    return observed(locals())


def test_having_frame_matches_sql(sess):
    twin(_having_frame_matches_sql, sess)


def _having_accepts_aggregate_calls(sess):
    # .having(count() > N) resolves the agg call to its .agg() output,
    # exactly like SQL's HAVING COUNT(*) > N
    d = ref(sess, "rankings")
    counts = collections.Counter((d["pageRank"] % 7).tolist())
    cut = len(d["pageRank"]) // 7
    expect = sorted(g for g, c in counts.items() if c > cut)
    r = (sess.table("rankings")
         .group_by((P.col("pageRank") % 7).alias("g"))
         .agg(P.count().alias("c"))
         .having(P.count() > cut)
         .to_numpy())
    assert sorted(r["g"].tolist()) == expect
    r2 = (sess.table("rankings")
          .group_by((P.col("pageRank") % 7).alias("g"))
          .agg(P.sum_(P.col("avgDuration")).alias("s"))
          .having(P.sum_(P.col("avgDuration")) > 100000)
          .to_numpy())
    ref_sql = sess.sql_np("SELECT pageRank % 7 AS g, SUM(avgDuration) AS s "
                          "FROM rankings GROUP BY pageRank % 7 "
                          "HAVING s > 100000")
    assert sorted(r2["g"].tolist()) == sorted(ref_sql["g"].tolist())
    # an aggregate NOT in the .agg() output is an eager, named error
    with raises(P.FrameBindError, match=r"having\(\).*not in this "
                                             r"frame's \.agg\(\)"):
        (sess.table("rankings").group_by(P.col("pageURL"))
         .agg(P.count().alias("c")).having(P.sum_(P.col("pageRank")) > 5))
    return observed(locals())


def test_having_accepts_aggregate_calls(sess):
    twin(_having_accepts_aggregate_calls, sess)


def _having_on_sql_built_frame(sess):
    # sess.sql() frames are real frames: .having() composes onto them
    f = sess.sql("SELECT pageRank % 7 AS g, COUNT(*) AS c FROM rankings "
                 "GROUP BY pageRank % 7", lazy=True)
    cut = 20000 // 7
    r = f.having(P.col("c") > cut).to_numpy()
    d = ref(sess, "rankings")
    counts = collections.Counter((d["pageRank"] % 7).tolist())
    assert sorted(r["g"].tolist()) == sorted(
        g for g, c in counts.items() if c > cut)
    return observed(locals())


def test_having_on_sql_built_frame(sess):
    twin(_having_on_sql_built_frame, sess)


def _having_errors(sess):
    with raises(ValueError, match="HAVING requires GROUP BY"):
        sess.sql("SELECT pageRank FROM rankings HAVING pageRank > 1")
    with raises(ValueError, match="not a GROUP BY column"):
        sess.sql("SELECT pageRank % 2 AS g, COUNT(*) AS c FROM rankings "
                 "GROUP BY pageRank % 2 HAVING avgDuration > 5")
    with raises(ValueError, match="must also appear in the SELECT"):
        sess.sql("SELECT pageRank % 2 AS g, COUNT(*) AS c FROM rankings "
                 "GROUP BY pageRank % 2 HAVING SUM(avgDuration) > 5")
    return observed(locals())


def test_having_errors(sess):
    twin(_having_errors, sess)


# -- eager binding errors name the operation and column ----------------------


def _unknown_table_error(sess):
    with raises(P.FrameBindError, match=r"table\(\): unknown table "
                                             r"'nope'"):
        sess.table("nope")
    return observed(locals())


def test_unknown_table_error(sess):
    twin(_unknown_table_error, sess)


def _filter_error_names_op_and_column(sess):
    with raises(P.FrameBindError, match=r"filter\(\).*'pageRnk'"):
        sess.table("rankings").filter(P.col("pageRnk") > 1)
    # the message lists what IS available
    with raises(P.FrameBindError, match="pageURL, pageRank"):
        sess.table("rankings").filter(P.col("pageRnk") > 1)
    return observed(locals())


def test_filter_error_names_op_and_column(sess):
    twin(_filter_error_names_op_and_column, sess)


def _agg_and_group_by_errors(sess):
    with raises(P.FrameBindError, match=r"agg\(\).*'revenue'"):
        (sess.table("rankings").group_by(P.col("pageURL"))
         .agg(P.sum_(P.col("revenue")).alias("s")))
    with raises(P.FrameBindError, match=r"group_by\(\).*'nope'"):
        sess.table("rankings").group_by(P.col("nope"))
    with raises(P.FrameBindError, match=r"agg\(\).*not an aggregate"):
        sess.table("rankings").group_by(P.col("pageURL")).agg(P.col("pageRank"))
    with raises(P.FrameBindError, match=r"select\(\).*not in"):
        sess.table("rankings").select(P.col("pageURL"), P.count().alias("c"))
    return observed(locals())


def test_agg_and_group_by_errors(sess):
    twin(_agg_and_group_by_errors, sess)


def _nested_aggregate_rejected_eagerly(sess):
    with raises(P.FrameBindError, match=r"select\(\).*top-level"):
        sess.table("rankings").select(P.sum_(P.col("pageRank")) / P.count())
    with raises(P.FrameBindError, match=r"filter\(\).*\.having\(\)"):
        sess.table("rankings").filter(P.count() > 5)
    with raises(P.FrameBindError, match=r"group_by\(\).*aggregate"):
        sess.table("rankings").group_by(P.col("pageRank") + P.count())
    return observed(locals())


def test_nested_aggregate_rejected_eagerly(sess):
    twin(_nested_aggregate_rejected_eagerly, sess)


def _ml_featurize_bad_column_is_named_error(sess):
    LogisticRegression = P.m("ml").LogisticRegression
    with raises(P.FrameBindError, match=r"to_features\(\).*'typo'"):
        LogisticRegression(dims=2, iterations=1).fit(
            sess.table("rankings"), feature_cols=["typo"],
            label_col="pageRank")
    return observed(locals())


def test_ml_featurize_bad_column_is_named_error(sess):
    twin(_ml_featurize_bad_column_is_named_error, sess)


def _server_submit_rejects_junk_eagerly():
    srv = P.m("server").SharkServer(num_workers=2, max_threads=2)
    try:
        srv.create_table("t", P.Schema.of(x=P.DType.INT64),
                         {"x": np.arange(50, dtype=np.int64)})
        with raises(TypeError, match="SQL text, a SharkFrame"):
            srv.submit(42)
        # a SharkFrame submits its bound plan
        sess = srv.session("c")
        h = srv.submit(sess.table("t").agg(P.count().alias("c")), client="c")
        assert h.result().to_numpy()["c"][0] == 50
    finally:
        srv.shutdown()
    return observed(locals())


def test_server_submit_rejects_junk_eagerly():
    twin(_server_submit_rejects_junk_eagerly)


def _having_order_by_errors(sess):
    with raises(P.FrameBindError, match=r"having\(\).*no preceding"):
        sess.table("rankings").having(P.col("pageRank") > 1)
    with raises(P.FrameBindError, match=r"order_by\(\).*'nope'"):
        sess.table("rankings").order_by("nope")
    return observed(locals())


def test_having_order_by_errors(sess):
    twin(_having_order_by_errors, sess)


# -- sql() back-compat + laziness -------------------------------------------


def _sql_returns_frame_acting_as_result(sess):
    f = sess.sql("SELECT COUNT(*) AS c FROM rankings")
    # old ExecResult surface still works
    assert f.schema_names == ["c"]
    assert f.num_rows == 1
    assert f.to_numpy()["c"][0] == 20000
    # ... and it is a real frame: same plan as the fluent twin
    assert f.explain() == sess.table("rankings").agg(
        P.count().alias("c")).explain()
    return observed(locals())


def test_sql_returns_frame_acting_as_result(sess):
    twin(_sql_returns_frame_acting_as_result, sess)


def _sql_lazy_defers_execution(sess):
    before = sess.ctx.scheduler.tasks_launched
    f = sess.sql("SELECT pageURL FROM rankings LIMIT 5", lazy=True)
    assert sess.ctx.scheduler.tasks_launched == before, "lazy must not run"
    assert len(f.to_numpy()["pageURL"]) == 5
    assert sess.ctx.scheduler.tasks_launched > before
    # speculative task copies make the task count timing-dependent
    return observed(locals(), skip=("before",))


def test_sql_lazy_defers_execution(sess):
    twin(_sql_lazy_defers_execution, sess)


def _sql2rdd_deprecated_shim(sess):
    with pytest.warns(DeprecationWarning):
        rdd, names = sess.sql2rdd("SELECT pageURL FROM rankings LIMIT 7")
    assert names == ["pageURL"]
    total = sum(b.num_rows for b in rdd.collect())
    assert total == 7
    return observed(locals())


def test_sql2rdd_deprecated_shim(sess):
    twin(_sql2rdd_deprecated_shim, sess)


# -- to_rdd shuffle release on a shared server ------------------------------


def _frame_to_rdd_releases_shuffles_on_server():
    rng = np.random.default_rng(3)
    srv = P.m("server").SharkServer(num_workers=2, max_threads=2, default_partitions=4,
                      default_shuffle_buckets=4)
    try:
        srv.create_table("t", P.Schema.of(a=P.DType.INT64, b=P.DType.FLOAT64),
                         {"a": rng.integers(0, 8, 4000).astype(np.int64),
                          "b": rng.uniform(0, 1, 4000)})
        sess = srv.session("ml")
        rdd = (sess.table("t").group_by(P.col("a"))
               .agg(P.sum_(P.col("b")).alias("s")).to_rdd())
        assert sum(b.num_rows for b in rdd.collect()) == 8
        bm = srv.ctx.block_manager
        with bm.lock:
            held = [k for k in bm.blocks if k[0] == "shuf"]
        assert held, "aggregation must have materialized map output"
        sess.release_shuffles()
        with bm.lock:
            held = [k for k in bm.blocks if k[0] == "shuf"]
        assert not held, f"leaked shuffle blocks: {held[:3]}"
    finally:
        srv.shutdown()
    return observed(locals())


def test_frame_to_rdd_releases_shuffles_on_server():
    twin(_frame_to_rdd_releases_shuffles_on_server)


# -- ML accepts frames -------------------------------------------------------


def _ml_fit_from_frame():
    KMeans = P.m("ml").KMeans
    LogisticRegression = P.m("ml").LogisticRegression
    rng = np.random.default_rng(1)
    n, d = 4000, 4
    w_true = rng.normal(size=d)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ w_true > 0).astype(np.float32)
    sess = P.SharkSession(num_workers=2, max_threads=2)
    cols = {f"f{i}": X[:, i] for i in range(d)}
    cols["label"] = y
    sess.create_table("users", P.Schema.of(
        **{f"f{i}": P.DType.FLOAT32 for i in range(d)}, label=P.DType.FLOAT32),
        cols)
    try:
        frame = sess.table("users").filter(P.col("f0") > -10)
        clf = LogisticRegression(dims=d, lr=0.5, iterations=8).fit(
            frame, feature_cols=[f"f{i}" for i in range(d)],
            label_col="label")
        assert (clf.predict(X) == y).mean() > 0.9
        # feature_cols defaults to everything but the label
        clf2 = LogisticRegression(dims=d, lr=0.5, iterations=8).fit(
            frame, label_col="label")
        assert (clf2.predict(X) == y).mean() > 0.9
        km = KMeans(k=3, dims=d, iterations=3).fit(
            frame, feature_cols=[f"f{i}" for i in range(d)])
        assert len(km.objective_history) == 3
        # label_col excludes the label from the default feature set
        km2 = KMeans(k=3, dims=d, iterations=2).fit(frame, label_col="label")
        assert len(km2.objective_history) == 2
        # to_features keeps the cached-RDD reuse pattern available
        feats = frame.to_features([f"f{i}" for i in range(d)], "label")
        clf3 = LogisticRegression(dims=d, lr=0.5, iterations=4).fit(feats)
        clf3.fit(feats)
        assert (clf3.predict(X) == y).mean() > 0.9
    finally:
        sess.shutdown()
    return {"w": [clf.w, clf2.w, clf3.w],
            "centroids": [km.centroids, km2.centroids],
            "objective": [km.objective_history, km2.objective_history]}


def test_ml_fit_from_frame():
    twin(_ml_fit_from_frame, rtol=1e-4)


