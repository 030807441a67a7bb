"""Multi-way joins on the torch port against the JAX reference: the twin of
tests/test_multiway_join.py (cost-based initial ordering, per-boundary PDE
re-optimization, skew splitting, SQL / frame plan parity).

The same seeded star schema — `fact` (40k rows) referencing the dims
`small_d` (tiny), `mid_d`, `big_d`, with a heavy-hitter key in `fact.hot`
— is loaded into a reference session and into a port session on
`device="cpu"` with the kernel routes forced (`segment_force_kernels`), so
every shuffle of the port, the joins' and the aggregations', splits its
map tasks through `radix_split`'s plain version.  Each test asserts what
its reference twin asserts, on the port, and compares the port's rows
with the reference's: integers exactly, floats to rtol 1e-12, as
multisets of rows (the radix kernel's 32-bit mix buckets differently from
the reference's host partitioner, so rows arrive in another order).
Plans must be byte-identical across the two packages too.
"""

import collections
import itertools

import numpy as np
import pytest

from repro.core import SharkSession as JaxSession
from repro.core.pde import PDEConfig as JaxPDEConfig
from repro.core.plan import explain as jax_explain
from repro.core.plan import optimize as jax_optimize
from repro.server.result_cache import plan_fingerprint as jax_fingerprint
from repro_torch.core import DType, Schema, SharkSession, col, sum_
from repro_torch.core.pde import PDEConfig
from repro_torch.core.plan import (JoinNode, ScanNode, estimate_plan_cost,
                                   explain, optimize, plan_fingerprint)
from repro_torch.core.shuffle import RADIX_KERNEL_CALLS

N_FACT = 40_000
SESSION_KW = dict(num_workers=4, max_threads=4, default_partitions=6,
                  default_shuffle_buckets=8)


def _star(rng):
    hot = rng.integers(0, 200, N_FACT)
    hot[: N_FACT // 2] = 13          # heavy hitter: half the fact table
    return [
        ("fact", dict(sk="INT64", mk="INT64", bk="INT64", hot="INT64",
                      rev="FLOAT64"),
         {"sk": rng.integers(0, 8, N_FACT).astype(np.int64),
          "mk": rng.integers(0, 500, N_FACT).astype(np.int64),
          "bk": rng.integers(0, 5000, N_FACT).astype(np.int64),
          "hot": hot.astype(np.int64),
          "rev": rng.uniform(0, 10, N_FACT)}),
        ("small_d", dict(skey="INT64", sval="INT64"),
         {"skey": np.arange(8, dtype=np.int64),
          "sval": rng.integers(0, 3, 8).astype(np.int64)}),
        ("mid_d", dict(mkey="INT64", mval="INT64"),
         {"mkey": np.arange(500, dtype=np.int64),
          "mval": rng.integers(0, 9, 500).astype(np.int64)}),
        ("big_d", dict(bkey="INT64", bval="INT64"),
         {"bkey": np.arange(5000, dtype=np.int64),
          "bval": rng.integers(0, 7, 5000).astype(np.int64)}),
    ]


def _load(sess, tables, package):
    """Create `tables` in `sess`, with the schema types of `package`'s
    DType ("jax" or "torch")."""
    if package == "jax":
        from repro.core import DType as D, Schema as S
    else:
        D, S = DType, Schema
    for name, types, data in tables:
        sess.create_table(name, S.of(**{c: getattr(D, t)
                                        for c, t in types.items()}), data)


def _pair(tables, **pde):
    js = JaxSession(pde_config=JaxPDEConfig(**pde), **SESSION_KW)
    _load(js, tables, "jax")
    ts = SharkSession(device="cpu", pde_config=PDEConfig(
        segment_force_kernels=True, **pde), **SESSION_KW)
    _load(ts, tables, "torch")
    return js, ts


@pytest.fixture(scope="module")
def sessions():
    js, ts = _pair(_star(np.random.default_rng(42)))
    yield js, ts
    js.shutdown()
    ts.shutdown()


def ref(sess, table):
    return sess.catalog.get(table).to_dict()


def _ref_join_rows(sess, tables_keys):
    """Reference inner-join row count: fact against listed (dim, fk, pk)."""
    d = ref(sess, "fact")
    mult = np.ones(len(d["sk"]), np.int64)
    for t, fk, pk in tables_keys:
        cnt = collections.Counter(ref(sess, t)[pk].tolist())
        mult *= np.array([cnt[v] for v in d[fk].tolist()])
    return int(mult.sum())


def assert_same_rows(got, want):
    """Equal multisets of rows: integers exactly, floats to rtol 1e-12."""
    assert sorted(got) == sorted(want)
    names = sorted(want)
    cols_w = [np.asarray(want[c]) for c in names]
    cols_g = [np.asarray(got[c]) for c in names]
    assert all(g.shape == w.shape for g, w in zip(cols_g, cols_w))
    ow = np.lexsort(cols_w[::-1]) if cols_w and len(cols_w[0]) else []
    og = np.lexsort(cols_g[::-1]) if cols_g and len(cols_g[0]) else []
    for name, g, w in zip(names, cols_g, cols_w):
        g, w = g[og], w[ow]
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


THREE_WAY = ("SELECT rev, sval, mval FROM fact "
             "JOIN small_d ON fact.sk = small_d.skey "
             "JOIN mid_d ON fact.mk = mid_d.mkey")
FOUR_WAY = ("SELECT rev, sval, mval, bval FROM fact "
            "JOIN small_d ON fact.sk = small_d.skey "
            "JOIN mid_d ON fact.mk = mid_d.mkey "
            "JOIN big_d ON fact.bk = big_d.bkey")


def _assert_plans_match(js, ts, sql):
    tp = optimize(ts.plan(sql), ts.catalog)
    jp = jax_optimize(js.plan(sql), js.catalog)
    assert explain(tp) == jax_explain(jp)
    assert plan_fingerprint(tp, ts.catalog) == jax_fingerprint(jp,
                                                               js.catalog)


# -- end-to-end correctness, both surfaces, byte-identical plans ------------


def test_three_way_join_runs_and_matches_reference(sessions):
    js, ts = sessions
    r = ts.sql_np(THREE_WAY)
    expected = _ref_join_rows(ts, [("small_d", "sk", "skey"),
                                   ("mid_d", "mk", "mkey")])
    assert len(r["rev"]) == expected
    assert len(ts.metrics().join_boundaries) == 2
    assert_same_rows(r, js.sql_np(THREE_WAY))
    _assert_plans_match(js, ts, THREE_WAY)


def test_four_way_join_runs_and_matches_reference(sessions):
    js, ts = sessions
    r = ts.sql_np(FOUR_WAY)
    expected = _ref_join_rows(ts, [("small_d", "sk", "skey"),
                                   ("mid_d", "mk", "mkey"),
                                   ("big_d", "bk", "bkey")])
    assert len(r["rev"]) == expected
    assert len(ts.metrics().join_boundaries) == 3
    assert_same_rows(r, js.sql_np(FOUR_WAY))
    _assert_plans_match(js, ts, FOUR_WAY)


@pytest.mark.parametrize("q_sql,frame_fn", [
    (THREE_WAY, lambda s: (
        s.table("fact").join("small_d", on=("sk", "skey"))
         .join("mid_d", on=("mk", "mkey")).select("rev", "sval", "mval"))),
    (FOUR_WAY, lambda s: (
        s.table("fact").join("small_d", on=("sk", "skey"))
         .join("mid_d", on=("mk", "mkey")).join("big_d", on=("bk", "bkey"))
         .select("rev", "sval", "mval", "bval"))),
])
def test_frame_and_sql_emit_byte_identical_plans(sessions, q_sql, frame_fn):
    js, ts = sessions
    sql_plan = optimize(ts.plan(q_sql), ts.catalog)
    frame_plan = frame_fn(ts).optimized_plan()
    assert explain(sql_plan) == explain(frame_plan)
    assert (plan_fingerprint(sql_plan, ts.catalog)[0]
            == plan_fingerprint(frame_plan, ts.catalog)[0])
    assert (plan_fingerprint(frame_plan, ts.catalog)[0]
            == jax_fingerprint(frame_fn(js).optimized_plan(), js.catalog)[0])


def test_frame_and_sql_parity_with_aggregation(sessions):
    js, ts = sessions
    q = ("SELECT sval, SUM(rev) AS total FROM fact "
         "JOIN small_d ON fact.sk = small_d.skey "
         "JOIN mid_d ON fact.mk = mid_d.mkey "
         "WHERE mval > 4 GROUP BY sval")
    fr = (ts.table("fact").join("small_d", on=("sk", "skey"))
          .join("mid_d", on=("mk", "mkey")).filter(col("mval") > 4)
          .group_by("sval").agg(sum_(col("rev")).alias("total")))
    sql_plan = optimize(ts.plan(q), ts.catalog)
    assert explain(sql_plan) == explain(fr.optimized_plan())
    assert (plan_fingerprint(sql_plan, ts.catalog)[0]
            == plan_fingerprint(fr.optimized_plan(), ts.catalog)[0])
    before = RADIX_KERNEL_CALLS["count"]
    r_sql = ts.sql_np(q)
    assert RADIX_KERNEL_CALLS["count"] > before   # the GROUP BY's shuffle
    r_frame = fr.to_numpy()
    assert dict(zip(r_sql["sval"].tolist(), r_sql["total"].tolist())) \
        == pytest.approx(dict(zip(r_frame["sval"].tolist(),
                                  r_frame["total"].tolist())))
    assert_same_rows(r_sql, js.sql_np(q))
    _assert_plans_match(js, ts, q)


# -- cost-based initial ordering --------------------------------------------


def test_order_joins_puts_smallest_relation_first(sessions):
    js, ts = sessions
    q = ("SELECT rev, sval, bval FROM fact "
         "JOIN big_d ON fact.bk = big_d.bkey "
         "JOIN small_d ON fact.sk = small_d.skey")
    plan = optimize(ts.plan(q), ts.catalog)

    def leftmost(n):
        while True:
            if isinstance(n, JoinNode):
                n = n.left
            elif hasattr(n, "child"):
                n = n.child
            else:
                return n

    assert isinstance(leftmost(plan), ScanNode)
    assert leftmost(plan).table == "small_d"
    _assert_plans_match(js, ts, q)


def test_order_joins_never_increases_estimated_cost(sessions):
    js, ts = sessions
    ordered = optimize(ts.plan(FOUR_WAY), ts.catalog)
    assert (estimate_plan_cost(ordered, ts.catalog)
            <= estimate_plan_cost(ts.plan(FOUR_WAY), ts.catalog) + 1e-9)
    from repro.core.plan import estimate_plan_cost as jax_cost
    assert estimate_plan_cost(ordered, ts.catalog) == pytest.approx(
        jax_cost(jax_optimize(js.plan(FOUR_WAY), js.catalog), js.catalog),
        rel=1e-12)


def test_all_three_way_orders_row_identical_and_chosen_not_worst(sessions):
    """Every valid join order of the same 3-table query returns the same
    rows on the port as on the reference, and the optimizer's pick never
    loses to the worst order on estimated cost."""
    js, ts = sessions
    perms = list(itertools.permutations(
        [("small_d", "sk", "skey"), ("mid_d", "mk", "mkey")]))
    counts, costs = set(), []
    for perm in perms:
        fr, jfr = ts.table("fact"), js.table("fact")
        for t, fk, pk in perm:
            fr = fr.join(t, on=(fk, pk))
            jfr = jfr.join(t, on=(fk, pk))
        fr = fr.select("rev", "sval", "mval")
        jfr = jfr.select("rev", "sval", "mval")
        costs.append(estimate_plan_cost(fr.logical_plan(), ts.catalog))
        counts.add(fr.count())
        assert_same_rows(fr.to_numpy(), jfr.to_numpy())
    assert len(counts) == 1, f"join orders disagree on row count: {counts}"
    chosen = estimate_plan_cost(
        optimize(ts.plan(THREE_WAY), ts.catalog), ts.catalog)
    assert chosen <= max(costs) + 1e-9


def test_order_joins_prefers_copartitioned_pair(sessions):
    q = ("SELECT rev, mval, bval FROM big_d, cp_a, cp_b "
         "WHERE cp_a.mk = cp_b.mkey AND big_d.bkey = cp_a.mk")
    got = []
    for sess in sessions:
        sess.sql("CREATE TABLE cp_a TBLPROPERTIES ('shark.cache'='true') AS "
                 "SELECT mk, rev FROM fact DISTRIBUTE BY mk")
        sess.sql("CREATE TABLE cp_b TBLPROPERTIES ('shark.cache'='true', "
                 "'copartition'='cp_a') AS SELECT mkey, mval FROM mid_d "
                 "DISTRIBUTE BY mkey")
        got.append(sess.sql_np(q))
        boundaries = sess.metrics().join_boundaries
        assert boundaries, "no join boundaries recorded"
        assert boundaries[0].strategy == "copartition", \
            sess.metrics().describe_joins()
    assert_same_rows(got[1], got[0])


# -- per-boundary PDE decisions ---------------------------------------------


def test_pde_broadcasts_small_build_side_per_boundary(sessions):
    js, ts = sessions
    ts.sql_np(FOUR_WAY)
    m = ts.metrics()
    assert len(m.join_boundaries) == 3
    b0 = m.join_boundaries[0]
    assert b0.strategy == "broadcast", m.describe_joins()
    small_side = min(b0.left_bytes, b0.right_bytes)
    assert small_side <= PDEConfig().broadcast_threshold_bytes
    assert all(b.strategy == "broadcast" for b in m.join_boundaries), \
        m.describe_joins()
    assert m.shuffled_bytes == 0.0
    js.sql_np(FOUR_WAY)
    assert ([b.strategy for b in m.join_boundaries]
            == [b.strategy for b in js.metrics().join_boundaries])


def test_pde_skew_splits_heavy_hitter_key():
    """The shuffle path (tiny broadcast threshold): the hot key's bucket
    is split across reducers, the rows equal the reference's, and the
    port's map tasks split through the radix kernel's route."""
    rng = np.random.default_rng(7)
    n = 30_000
    hot = rng.integers(0, 64, n)
    hot[: n // 2] = 13
    tables = [
        ("l", dict(hk="INT64", lv="FLOAT64"),
         {"hk": hot.astype(np.int64), "lv": rng.uniform(0, 1, n)}),
        ("r", dict(rk="INT64", rv="FLOAT64"),
         {"rk": rng.integers(0, 64, 2000).astype(np.int64),
          "rv": rng.uniform(0, 1, 2000)})]
    js, ts = _pair(tables, broadcast_threshold_bytes=256,
                   target_reduce_bytes=32 << 10, skew_factor=2.0)
    try:
        q = "SELECT lv, rv FROM l JOIN r ON l.hk = r.rk"
        before = RADIX_KERNEL_CALLS["count"]
        res = ts.sql_np(q)
        # both sides' map tasks (6 partitions each) through the kernel; a
        # speculative backup task splits its partition once more
        assert RADIX_KERNEL_CALLS["count"] - before >= 12
        cnt = collections.Counter(ref(ts, "r")["rk"].tolist())
        expected = sum(cnt[v] for v in ref(ts, "l")["hk"].tolist())
        assert len(res["lv"]) == expected
        m = ts.metrics()
        assert len(m.join_boundaries) == 1
        b = m.join_boundaries[0]
        assert b.strategy == "shuffle", m.describe_joins()
        assert b.skewed_buckets, "heavy-hitter bucket not detected"
        assert b.skew_shards >= 2, m.describe_joins()
        assert 13 in b.hot_keys, f"hot key not in sketch: {b.hot_keys}"
        assert_same_rows(res, js.sql_np(q))
    finally:
        js.shutdown()
        ts.shutdown()


def test_skew_split_left_outer_join_correct():
    """Outer joins may only stride the preserved side; unmatched left rows
    appear exactly once, on the port as on the reference."""
    rng = np.random.default_rng(3)
    n = 20_000
    hot = rng.integers(0, 32, n)
    hot[: n // 2] = 5
    hot[n - 50:] = 999           # unmatched keys
    tables = [
        ("l", dict(hk="INT64", lv="FLOAT64"),
         {"hk": hot.astype(np.int64), "lv": rng.uniform(0, 1, n)}),
        ("r", dict(rk="INT64", rv="FLOAT64"),
         {"rk": np.arange(32, dtype=np.int64), "rv": rng.uniform(0, 1, 32)})]
    kw = dict(num_workers=2, max_threads=2, default_partitions=4,
              default_shuffle_buckets=4)
    pde = dict(broadcast_threshold_bytes=64, target_reduce_bytes=8 << 10,
               skew_factor=2.0)
    js = JaxSession(pde_config=JaxPDEConfig(**pde), **kw)
    ts = SharkSession(device="cpu", pde_config=PDEConfig(
        segment_force_kernels=True, **pde), **kw)
    try:
        _load(js, tables, "jax")
        _load(ts, tables, "torch")
        q = "SELECT lv, rv FROM l LEFT JOIN r ON l.hk = r.rk"
        before = RADIX_KERNEL_CALLS["count"]
        res = ts.sql_np(q)
        assert RADIX_KERNEL_CALLS["count"] > before
        assert len(res["lv"]) == n     # every left row exactly once
        assert_same_rows(res, js.sql_np(q))
    finally:
        js.shutdown()
        ts.shutdown()


def test_describe_joins_is_assertable_text(sessions):
    js, ts = sessions
    ts.sql_np(THREE_WAY)
    text = ts.metrics().describe_joins()
    assert "join#0" in text and "broadcast" in text
    js.sql_np(THREE_WAY)
    assert text == js.metrics().describe_joins()
