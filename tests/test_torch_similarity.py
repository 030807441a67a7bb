"""Vector analytics on the torch port (DESIGN.md §15.3): twins of
tests/test_similarity.py on `SharkSession(device="cpu")` — embedding lane
columns in the catalog, `similarity_join` on the frame surface, its
SQL-twin plan and the topk_similarity route (its plain version on the
CPU) — plus the same searches through the JAX reference, and concurrent
filtered searches through each package's SharkServer.

Both packages load the same numpy arrays, made from a seed; result ids
must equal the numpy oracle's exactly.  The score column is float32 in
both packages (a float32 lane times a float literal stays float32), summed
in different orders, so scores agree with each other and with the float64
oracle to float32 rounding: rtol 1e-6.
"""

import numpy as np
import pytest

from repro.core import DType as JDType
from repro.core import Schema as JSchema
from repro.core import SharkSession as JaxSession
from repro.core.functions import col as jcol
from repro_torch.core import DType, Schema, SharkSession
from repro_torch.core.frame import FrameBindError
from repro_torch.core.functions import col
from repro_torch.core.pde import PDEConfig
from repro_torch.kernels import ops

N, DIM = 6000, 8


def _docs(rows=N):
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(rows, DIM)).astype(np.float32)
    cat = rng.integers(0, 4, rows).astype(np.int64)
    return emb, cat


def _docs_session(rows=N, **kw):
    emb, cat = _docs(rows)
    sess = SharkSession(num_workers=2, device="cpu", **kw)
    sess.create_table("docs", Schema.of(id=DType.INT64, cat=DType.INT64),
                      {"id": np.arange(rows, dtype=np.int64), "cat": cat,
                       "emb": emb}, num_partitions=4)
    return sess, emb, cat


def _oracle(emb, cat, c, q, k):
    s = emb.astype(np.float64) @ q
    idx = np.nonzero(cat == c)[0] if c is not None else np.arange(len(s))
    return idx[np.argsort(-s[idx], kind="stable")[:k]]


def test_embedding_lanes_in_catalog():
    sess, emb, _ = _docs_session()
    t = sess.catalog.get("docs")
    assert t.embeddings == {"emb": [f"emb_{i}" for i in range(DIM)]}
    got = sess.sql_np("SELECT emb_3 FROM docs")["emb_3"]
    np.testing.assert_array_equal(got, emb[:, 3])
    sess.shutdown()


def test_embedding_lane_name_collision_rejected():
    from repro_torch.core.columnar import from_arrays
    with pytest.raises(ValueError, match="emb_0"):
        from_arrays("t", Schema.of(emb_0=DType.FLOAT32),
                    {"emb_0": np.zeros(4, np.float32),
                     "emb": np.zeros((4, 2), np.float32)}, 1)


def test_similarity_join_matches_oracle_with_filter_below():
    sess, emb, cat = _docs_session()
    rng = np.random.default_rng(1)
    q = rng.normal(size=DIM)
    f = sess.table("docs").filter(col("cat") == 2).similarity_join(
        "emb", q, 25)
    plan = f.explain()
    # the filter sits BELOW the score projection: it prunes before scoring
    assert plan.index("Filter") > plan.index("Project")
    res = f.to_numpy()
    np.testing.assert_array_equal(res["id"], _oracle(emb, cat, 2, q, 25))
    np.testing.assert_allclose(res["score"],
                               emb.astype(np.float64)[res["id"]] @ q,
                               rtol=1e-6)
    sess.shutdown()


def test_similarity_join_sql_twin_same_plan():
    """The frame call lowers to the exact plan of its SQL twin — one
    fingerprint (non-negative weights: the SQL parser desugars unary minus
    to `0 - x`, which would differ textually)."""
    sess, emb, cat = _docs_session()
    q = np.array([1.5, 0.25, 2.0, 0.5, 1.0, 0.75, 3.0, 0.125])
    f = sess.table("docs").filter(col("cat") == 1).similarity_join(
        "emb", q, 10)
    lanes = " + ".join(f"emb_{i} * {float(w)!r}" for i, w in enumerate(q))
    cols = ", ".join(["id", "cat"] + [f"emb_{i}" for i in range(DIM)])
    twin = sess.sql(
        f"SELECT {cols}, {lanes} AS score FROM docs WHERE cat = 1 "
        f"ORDER BY score DESC LIMIT 10", lazy=True)
    assert f.explain() == twin.explain()
    np.testing.assert_array_equal(twin.to_numpy()["id"],
                                  _oracle(emb, cat, 1, q, 10))
    sess.shutdown()


def test_similarity_join_topk_kernel_route():
    ops.reset_launch_counts()
    sess, emb, cat = _docs_session(
        rows=20_000,
        pde_config=PDEConfig(segment_force_kernels=True))
    q = np.random.default_rng(2).normal(size=DIM)
    f = sess.table("docs").similarity_join("emb", q, 12)
    res = f.to_numpy()
    routes = sess.metrics().segment_routes()
    assert routes.get("topk_similarity", 0) > 0, routes
    np.testing.assert_array_equal(res["id"], _oracle(emb, cat, None, q, 12))
    # the CPU session ran the kernel's plain version: no launch
    assert ops.launch_counts()["topk_similarity"] == 0
    sess.shutdown()


def test_similarity_join_reads_lanes_in_place_and_counts_the_route(
        monkeypatch):
    """Each kernel-routed partition search takes route `lanes` (its 8
    float32 lane columns read in place, no stack); with the lanes entry's
    limit below 8 it takes `stacked`; the ids are the oracle's both
    times."""
    from repro_torch.kernels import topk_similarity as tk
    sess, emb, cat = _docs_session(
        rows=20_000, pde_config=PDEConfig(segment_force_kernels=True))
    q = np.random.default_rng(5).normal(size=DIM)
    want = _oracle(emb, cat, None, q, 12)
    for route, limit in (("lanes", tk.MAX_LANES), ("stacked", DIM - 1)):
        monkeypatch.setattr(tk, "MAX_LANES", limit)
        before = dict(tk.ROUTES)
        res = sess.table("docs").similarity_join("emb", q, 12).to_numpy()
        searches = sess.metrics().segment_routes()["topk_similarity"]
        counted = {k: tk.ROUTES[k] - before[k] for k in tk.ROUTES}
        assert searches > 0
        assert counted == {"fused": 0, "rounds": 0, "lanes": 0,
                           "stacked": 0, route: searches}
        np.testing.assert_array_equal(res["id"], want)
    sess.shutdown()


def test_similarity_join_error_paths():
    sess, _, _ = _docs_session(rows=200)
    q = np.zeros(DIM)
    with pytest.raises(FrameBindError, match="no embedding"):
        sess.table("docs").similarity_join("nope", q, 5)
    with pytest.raises(FrameBindError, match="lanes"):
        sess.table("docs").similarity_join("emb", q[:3], 5)
    with pytest.raises(FrameBindError, match="already exists"):
        sess.table("docs").similarity_join("emb", q, 5, score_col="id")
    with pytest.raises(FrameBindError, match="1 lanes"):
        # projecting away lanes breaks the embedding: the prefix fallback
        # finds only emb_0 and the 8-component query no longer fits
        sess.table("docs").select("id", "emb_0").similarity_join(
            "emb", q, 5)
    with pytest.raises(FrameBindError, match="no embedding"):
        sess.table("docs").select("id").similarity_join("emb", q, 5)
    sess.shutdown()


def test_similarity_join_prefix_fallback_after_projection():
    """A derived frame that keeps ALL lanes (but is no longer a bare scan
    walkable to the catalog) resolves lanes by name prefix."""
    from repro_torch.core.functions import count
    sess, emb, cat = _docs_session()
    q = np.random.default_rng(3).normal(size=DIM)
    base = sess.table("docs").filter(col("cat") == 0)
    agg = (sess.table("docs").group_by(col("cat"))
           .agg(count(col("id")).alias("n")))
    joined = base.join(agg, on=("cat", "cat"))
    res = joined.similarity_join("emb", q, 8).to_numpy()
    np.testing.assert_array_equal(res["id"], _oracle(emb, cat, 0, q, 8))
    sess.shutdown()


@pytest.mark.parametrize("cat_filter", [None, 3])
@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("k", [1, 12, 40])
def test_similarity_join_matches_reference(cat_filter, forced, k):
    """The same search through both packages: ids equal (and equal the
    oracle's), scores to rtol 1e-6, explain() identical."""
    emb, cat = _docs(rows=10_000)

    def data():            # create_table takes the embedding out of it
        return {"id": np.arange(len(cat), dtype=np.int64), "cat": cat,
                "emb": emb}

    js = JaxSession(num_workers=2)
    js.create_table("docs", JSchema.of(id=JDType.INT64, cat=JDType.INT64),
                    data(), num_partitions=2)
    ts = SharkSession(num_workers=2, device="cpu", pde_config=PDEConfig(
        segment_force_kernels=forced, segment_kernel_min_rows=256))
    ts.create_table("docs", Schema.of(id=DType.INT64, cat=DType.INT64),
                    data(), num_partitions=2)
    q = np.random.default_rng(k).normal(size=DIM)
    jf, tf = js.table("docs"), ts.table("docs")
    if cat_filter is not None:
        jf = jf.filter(jcol("cat") == cat_filter)
        tf = tf.filter(col("cat") == cat_filter)
    jf, tf = jf.similarity_join("emb", q, k), tf.similarity_join("emb", q, k)
    assert tf.explain() == jf.explain()
    want, got = jf.to_numpy(), tf.to_numpy()
    np.testing.assert_array_equal(got["id"], want["id"])
    np.testing.assert_array_equal(got["id"],
                                  _oracle(emb, cat, cat_filter, q, k))
    np.testing.assert_allclose(got["score"], want["score"], rtol=1e-6)
    routes = ts.metrics().segment_routes()
    assert (routes.get("topk_similarity", 0) > 0) == forced, routes
    js.shutdown()
    ts.shutdown()


def test_similarity_search_under_server_concurrency():
    """3 concurrent sessions storm filtered similarity searches through the
    fair scheduler, on both packages' servers — zero wrong results, and
    each session's ids equal the reference's."""
    import threading

    from repro.core import SharkSession as JaxSessionCls
    from repro.server import SharkServer as JaxServer
    from repro_torch.server import SharkServer

    rng = np.random.default_rng(4)
    rows = 4000
    emb = rng.normal(size=(rows, DIM)).astype(np.float32)
    cat = rng.integers(0, 3, rows).astype(np.int64)
    found = {}
    for pkg in ("jax", "torch"):
        kw = dict(num_workers=2, max_threads=4, max_concurrent_queries=3,
                  enable_result_cache=False, default_partitions=4)
        if pkg == "jax":
            srv = JaxServer(**kw)
            srv.create_table("docs", JSchema.of(id=JDType.INT64,
                                                cat=JDType.INT64),
                             {"id": np.arange(rows, dtype=np.int64),
                              "cat": cat, "emb": emb})
            session, column = JaxSessionCls, jcol
        else:
            srv = SharkServer(device="cpu", **kw)
            srv.create_table("docs", Schema.of(id=DType.INT64,
                                               cat=DType.INT64),
                             {"id": np.arange(rows, dtype=np.int64),
                              "cat": cat, "emb": emb})
            session, column = SharkSession, col
        wrong = [0, 0, 0]
        ids = [[], [], []]

        def storm(slot):
            sess = session(server=srv, client_id=f"sim-{slot}")
            srng = np.random.default_rng(50 + slot)
            for _ in range(3):
                c = int(srng.integers(0, 3))
                q = srng.normal(size=DIM)
                got = (sess.table("docs").filter(column("cat") == c)
                       .similarity_join("emb", q, 15).to_numpy())
                ids[slot].append(got["id"])
                if not np.array_equal(got["id"],
                                      _oracle(emb, cat, c, q, 15)):
                    wrong[slot] += 1

        threads = [threading.Thread(target=storm, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sum(wrong) == 0, (pkg, wrong)
        srv.shutdown()
        found[pkg] = ids
    for slot in range(3):
        for g, w in zip(found["torch"][slot], found["jax"][slot]):
            np.testing.assert_array_equal(g, w)
