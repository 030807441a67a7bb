"""End-to-end SQL engine tests on the torch port against the JAX
reference: the twin of tests/test_sql.py.

Each test body runs on both packages (`torch_twin.twin`; the port's
session on `device="cpu"`), asserts what its reference test asserts
against numpy, and every answer it collects is held to the reference's:
integers and strings exactly, floats to rtol 1e-12, as row multisets.
"""

import collections

import numpy as np
import pytest

from torch_twin import P, per_pkg, twin


@pytest.fixture(scope="module")
def sess():
    sessions = per_pkg(_make_session)
    yield sessions
    for s in sessions.values():
        s.shutdown()


def _make_session():
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


def _selection(sess):
    r = sess.sql_np("SELECT pageURL, pageRank FROM rankings "
                    "WHERE pageRank > 500")
    d = ref(sess, "rankings")
    mask = d["pageRank"] > 500
    assert len(r["pageRank"]) == mask.sum()
    assert sorted(r["pageRank"].tolist()) == sorted(
        d["pageRank"][mask].tolist())


def test_selection(sess):
    twin(_selection, sess)


def _compound_predicate(sess):
    r = sess.sql_np("SELECT pageRank FROM rankings WHERE "
                    "pageRank > 100 AND avgDuration < 50 OR pageRank = 7")
    d = ref(sess, "rankings")
    mask = (d["pageRank"] > 100) & (d["avgDuration"] < 50) | (d["pageRank"] == 7)
    assert len(r["pageRank"]) == mask.sum()


def test_compound_predicate(sess):
    twin(_compound_predicate, sess)


def _string_predicate(sess):
    r = sess.sql_np("SELECT pageURL FROM rankings WHERE pageURL = 'url13'")
    d = ref(sess, "rankings")
    assert len(r["pageURL"]) == (d["pageURL"] == "url13").sum()
    assert set(r["pageURL"]) == {"url13"}


def test_string_predicate(sess):
    twin(_string_predicate, sess)


def _aggregation_groups(sess):
    r = sess.sql_np("SELECT pageRank % 5 AS g, COUNT(*) AS c, "
                    "SUM(avgDuration) AS s, AVG(avgDuration) AS a "
                    "FROM rankings GROUP BY pageRank % 5")
    d = ref(sess, "rankings")
    g = d["pageRank"] % 5
    for gi, c, s_, a in zip(r["g"], r["c"], r["s"], r["a"]):
        m = g == gi
        assert c == m.sum()
        assert s_ == d["avgDuration"][m].sum()
        assert abs(a - d["avgDuration"][m].mean()) < 1e-9
    assert len(r["g"]) == 5


def test_aggregation_groups(sess):
    twin(_aggregation_groups, sess)


def _global_aggregate(sess):
    r = sess.sql_np("SELECT COUNT(*) AS c, MIN(pageRank) AS mn, "
                    "MAX(pageRank) AS mx FROM rankings")
    d = ref(sess, "rankings")
    assert r["c"][0] == len(d["pageRank"])
    assert r["mn"][0] == d["pageRank"].min()
    assert r["mx"][0] == d["pageRank"].max()


def test_global_aggregate(sess):
    twin(_global_aggregate, sess)


def _count_distinct(sess):
    r = sess.sql_np("SELECT COUNT(DISTINCT pageURL) AS u FROM rankings")
    d = ref(sess, "rankings")
    assert r["u"][0] == len(np.unique(d["pageURL"]))


def test_count_distinct(sess):
    twin(_count_distinct, sess)


def _count_distinct_grouped_with_count(sess):
    r = sess.sql_np("SELECT pageRank % 3 AS g, COUNT(*) AS c, "
                    "COUNT(DISTINCT pageURL) AS u FROM rankings "
                    "GROUP BY pageRank % 3")
    d = ref(sess, "rankings")
    g = d["pageRank"] % 3
    for gi, c, u in zip(r["g"], r["c"], r["u"]):
        m = g == gi
        assert c == m.sum()
        assert u == len(np.unique(d["pageURL"][m]))


def test_count_distinct_grouped_with_count(sess):
    twin(_count_distinct_grouped_with_count, sess)


def _substr_groupby(sess):
    r = sess.sql_np("SELECT SUBSTR(sourceIP, 1, 6) AS p, "
                    "SUM(adRevenue) AS s FROM uservisits "
                    "GROUP BY SUBSTR(sourceIP, 1, 6)")
    d = ref(sess, "uservisits")
    refsum = collections.defaultdict(float)
    for ip, rev in zip(d["sourceIP"], d["adRevenue"]):
        refsum[ip[:6]] += rev
    got = dict(zip(r["p"].tolist(), r["s"].tolist()))
    assert set(got) == set(refsum)
    for k in got:
        assert abs(got[k] - refsum[k]) < 1e-6


def test_substr_groupby(sess):
    twin(_substr_groupby, sess)


def _join_with_filter(sess):
    r = sess.sql_np(
        "SELECT sourceIP, pageRank, adRevenue FROM rankings R, uservisits UV "
        "WHERE R.pageURL = UV.destURL AND UV.visitDate BETWEEN 10500 AND 11000")
    dr, dv = ref(sess, "rankings"), ref(sess, "uservisits")
    vmask = (dv["visitDate"] >= 10500) & (dv["visitDate"] <= 11000)
    url_count = collections.Counter(dr["pageURL"].tolist())
    expected = sum(url_count[u] for u in dv["destURL"][vmask])
    assert len(r["sourceIP"]) == expected


def test_join_with_filter(sess):
    twin(_join_with_filter, sess)


def _join_aggregate(sess):
    r = sess.sql_np(
        "SELECT sourceIP, AVG(pageRank) AS avgRank, SUM(adRevenue) AS rev "
        "FROM rankings R JOIN uservisits UV ON R.pageURL = UV.destURL "
        "GROUP BY sourceIP")
    dr, dv = ref(sess, "rankings"), ref(sess, "uservisits")
    # reference join
    by_url = collections.defaultdict(list)
    for u, pr in zip(dr["pageURL"], dr["pageRank"]):
        by_url[u].append(pr)
    sums = collections.defaultdict(float)
    ranks = collections.defaultdict(list)
    for ip, u, rev in zip(dv["sourceIP"], dv["destURL"], dv["adRevenue"]):
        for pr in by_url.get(u, ()):
            sums[ip] += rev
            ranks[ip].append(pr)
    got = dict(zip(r["sourceIP"].tolist(), r["rev"].tolist()))
    assert set(got) == set(sums)
    for k in list(sums)[:20]:
        assert abs(got[k] - sums[k]) < 1e-6
    gotr = dict(zip(r["sourceIP"].tolist(), r["avgRank"].tolist()))
    for k in list(ranks)[:20]:
        assert abs(gotr[k] - np.mean(ranks[k])) < 1e-9


def test_join_aggregate(sess):
    twin(_join_aggregate, sess)


def _order_by_limit(sess):
    r = sess.sql_np("SELECT pageURL, pageRank FROM rankings "
                    "ORDER BY pageRank DESC LIMIT 25")
    d = ref(sess, "rankings")
    top = np.sort(d["pageRank"])[-25:][::-1]
    np.testing.assert_array_equal(r["pageRank"], top)


def test_order_by_limit(sess):
    twin(_order_by_limit, sess)


def _limit_pushdown(sess):
    r = sess.sql_np("SELECT pageURL FROM rankings LIMIT 10")
    assert len(r["pageURL"]) == 10


def test_limit_pushdown(sess):
    twin(_limit_pushdown, sess)


def _ctas_and_query(sess):
    sess.sql("CREATE TABLE high_rank AS SELECT pageURL, pageRank "
             "FROM rankings WHERE pageRank > 900")
    r = sess.sql_np("SELECT COUNT(*) AS c FROM high_rank")
    d = ref(sess, "rankings")
    assert r["c"][0] == (d["pageRank"] > 900).sum()


def test_ctas_and_query(sess):
    twin(_ctas_and_query, sess)


def _copartition_join(sess):
    sess.sql("CREATE TABLE r_mem TBLPROPERTIES ('shark.cache'='true') AS "
             "SELECT pageURL, pageRank FROM rankings DISTRIBUTE BY pageURL")
    sess.sql("CREATE TABLE v_mem TBLPROPERTIES ('shark.cache'='true', "
             "'copartition'='r_mem') AS SELECT destURL, adRevenue "
             "FROM uservisits DISTRIBUTE BY destURL")
    before = len(sess.metrics().join_decisions)
    r = sess.sql_np("SELECT pageRank, adRevenue FROM r_mem "
                    "JOIN v_mem ON r_mem.pageURL = v_mem.destURL")
    decisions = sess.metrics().join_decisions
    assert any("copartition" in d for d in decisions)
    dr, dv = ref(sess, "rankings"), ref(sess, "uservisits")
    url_count = collections.Counter(dr["pageURL"].tolist())
    expected = sum(url_count[u] for u in dv["destURL"])
    assert len(r["pageRank"]) == expected


def test_copartition_join(sess):
    twin(_copartition_join, sess)


def _explain(sess):
    plan = sess.explain("SELECT pageURL FROM rankings WHERE pageRank > 10")
    assert "Filter" in plan and "Scan" in plan
    return plan


def test_explain(sess):
    twin(_explain, sess)


