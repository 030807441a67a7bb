"""Server tier on the torch port against the JAX reference: the twin of
tests/test_server.py (concurrent sessions, unified memory budget with LRU
eviction and lineage recompute, plan-fingerprint result cache with epoch
invalidation, weighted fair scheduling, admission control).

Each test body runs on both packages (`torch_twin.PKGS`; the port's
server on `device="cpu"`), asserts what its reference test asserts, and
returns what it observed: answers, and the memory manager's counters
(`evictions`, `recomputes`, `bypasses`, `partition_misses`,
`decode_cache_drops`), which must equal the reference's on the same
inputs.  The storage tier's own twins are in test_torch_storage.py; here
`spill_dir=` / `spill_mode=` must build and attach it.
"""

import gc
import glob
import os
import threading
import time

import numpy as np
import pytest

from torch_twin import PKGS, TORCH, assert_same, twin

N = 60_000
QUERY = "SELECT a, SUM(b) AS s, COUNT(*) AS c FROM t GROUP BY a"
COUNTERS = ("evictions", "recomputes", "bypasses", "partition_misses",
            "partition_hits", "decode_cache_drops", "result_evictions",
            "cache_bytes", "partition_bytes", "decoded_cache_bytes")


def make_data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.integers(0, 40, n).astype(np.int64),
            "b": rng.uniform(0, 1, n)}


def make_server(pk, **kw):
    """A server of `pk` holding table t.  The tests that hold launch or
    memory counters equal across packages pass `speculation=False`: under
    a loaded host a task can run past 4x the median, and its speculative
    backup scans, misses and splits its partition again (the abandoned
    attempt too, at times after the query has returned), so the counters
    would follow task timing."""
    kw.setdefault("num_workers", 4)
    kw.setdefault("max_threads", 4)
    kw.setdefault("default_partitions", 8)
    kw.setdefault("default_shuffle_buckets", 8)
    srv = pk.server(**kw)
    srv.create_table("t", pk.schema(a="INT64", b="FLOAT64"), make_data())
    return srv


def groupby_ref(data):
    out = {}
    for a, b in zip(data["a"].tolist(), data["b"].tolist()):
        s, c = out.get(a, (0.0, 0))
        out[a] = (s + b, c + 1)
    return out


def check_result(res, ref):
    got = res.to_numpy()
    assert len(got["a"]) == len(ref)
    for a, s, c in zip(got["a"].tolist(), got["s"].tolist(),
                       got["c"].tolist()):
        assert c == ref[a][1]
        assert abs(s - ref[a][0]) < 1e-6
    return got


def counters(srv):
    mem = srv.stats()["memory"]
    return {k: mem[k] for k in COUNTERS}


# -- eviction + lineage recompute ------------------------------------------


def _eviction(pk):
    # budget holds ~2 of 8 scan partitions: the working set does not fit,
    # so caching churns and re-runs recompute from lineage.  One thread a
    # server, and no speculative copies of queued tasks (which a loaded
    # host would launch), keep the LRU order, and so the counters,
    # deterministic.
    srv = make_server(pk, cache_budget_bytes=300_000,
                      enable_result_cache=False, max_threads=1,
                      speculation=False)
    try:
        ref = groupby_ref(make_data())
        first = check_result(srv.sql(QUERY), ref)
        stats1 = counters(srv)
        assert stats1["evictions"] > 0, "budget < working set must evict"
        assert stats1["cache_bytes"] <= 300_000
        second = check_result(srv.sql(QUERY), ref)
        stats2 = counters(srv)
        assert stats2["recomputes"] > 0
        assert stats2["partition_misses"] > stats1["partition_misses"]
        return first, second, stats1, stats2
    finally:
        srv.shutdown()


def test_eviction_and_lineage_recompute():
    twin(_eviction, rows=True)


def test_eviction_under_concurrent_tasks():
    # the reference test's own setting: four task threads a server, so the
    # LRU order (and the counters) follow task timing; answers must agree
    # and both packages must evict and recompute
    def body(pk):
        srv = make_server(pk, cache_budget_bytes=300_000,
                          enable_result_cache=False)
        try:
            ref = groupby_ref(make_data())
            out = [check_result(srv.sql(QUERY), ref) for _ in range(2)]
            mem = counters(srv)
            assert mem["evictions"] > 0 and mem["recomputes"] > 0
            assert mem["cache_bytes"] <= 300_000
            return out
        finally:
            srv.shutdown()
    twin(body, rows=True)


def test_unlimited_budget_caches_scans():
    def body(pk):
        srv = make_server(pk, enable_result_cache=False, speculation=False)
        try:
            ref = groupby_ref(make_data())
            out = [check_result(srv.sql(QUERY), ref) for _ in range(2)]
            mem = counters(srv)
            assert mem["evictions"] == 0 and mem["recomputes"] == 0
            assert mem["partition_hits"] > 0, \
                "second run must hit cached scans"
            return out, mem
        finally:
            srv.shutdown()
    twin(body, rows=True)


def test_bypass_when_partition_exceeds_budget():
    def body(pk):
        srv = make_server(pk, cache_budget_bytes=10_000,  # < one partition
                          enable_result_cache=False, max_threads=1,
                          speculation=False)
        try:
            got = check_result(srv.sql(QUERY), groupby_ref(make_data()))
            mem = counters(srv)
            assert mem["bypasses"] > 0
            assert mem["cache_bytes"] <= 10_000
            return got, mem
        finally:
            srv.shutdown()
    twin(body, rows=True)


# -- result cache -----------------------------------------------------------


def test_result_cache_hit():
    def body(pk):
        srv = make_server(pk)
        try:
            ref = groupby_ref(make_data())
            h1 = srv.submit(QUERY)
            got = check_result(h1.result(), ref)
            assert not h1.cached
            h2 = srv.submit(QUERY)
            check_result(h2.result(), ref)
            assert h2.cached, \
                "identical plan over same table versions must hit"
            # different SQL text, same plan -> same fingerprint
            h3 = srv.submit("SELECT a, SUM(b) AS s, COUNT(*) AS c "
                            "FROM t GROUP BY a")
            assert h3.result() is not None and h3.cached
            rc = srv.stats()["result_cache"]
            assert rc["hits"] == 2
            return got, rc
        finally:
            srv.shutdown()
    twin(body, rows=True)


def test_result_cache_invalidated_by_create_table():
    def body(pk):
        srv = make_server(pk)
        try:
            check_result(srv.sql(QUERY), groupby_ref(make_data()))
            assert srv.submit(QUERY).result() is not None
            # mutate the input table: epoch bumps, entries must not be
            # served
            data2 = make_data(n=30_000, seed=7)
            srv.create_table("t", pk.schema(a="INT64", b="FLOAT64"), data2)
            h = srv.submit(QUERY)
            got = check_result(h.result(), groupby_ref(data2))
            assert not h.cached, "stale result served after catalog mutation"
            rc = srv.stats()["result_cache"]
            assert rc["invalidations"] > 0
            return got, rc
        finally:
            srv.shutdown()
    twin(body, rows=True)


def test_result_cache_invalidated_by_ctas():
    def body(pk):
        srv = make_server(pk)
        try:
            srv.sql("CREATE TABLE big AS SELECT a, b FROM t WHERE a < 20")
            r1 = srv.sql_np("SELECT COUNT(*) AS c FROM big")
            srv.sql("CREATE TABLE big AS SELECT a, b FROM t WHERE a < 10")
            r2 = srv.sql_np("SELECT COUNT(*) AS c FROM big")
            assert r2["c"][0] < r1["c"][0]
            return r1, r2
        finally:
            srv.shutdown()
    twin(body)


# -- concurrency, fairness, admission ---------------------------------------


def test_concurrent_clients_zero_wrong_results():
    def body(pk):
        srv = make_server(pk, max_concurrent_queries=4)
        try:
            ref = groupby_ref(make_data())
            count_ref = int((make_data()["a"] < 20).sum())
            errors, counts = [], []

            def client(name, reps):
                sess = srv.session(name)
                for i in range(reps):
                    try:
                        if i % 2 == 0:
                            check_result(sess.sql(QUERY), ref)
                        else:
                            r = sess.sql_np(
                                "SELECT COUNT(*) AS c FROM t WHERE a < 20")
                            assert r["c"][0] == count_ref
                            counts.append(int(r["c"][0]))
                    except Exception as e:  # surface across threads
                        errors.append((name, e))

            threads = [threading.Thread(target=client, args=(f"c{i}", 6))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not errors, errors
            return sorted(counts)
        finally:
            srv.shutdown()
    twin(body)


def test_weighted_fair_share():
    # a heavy tenant floods the queue; the high-weight interactive tenant
    # must still get service proportional to its weight
    def body(pk):
        srv = make_server(pk, max_concurrent_queries=1, max_queue_depth=64)
        try:
            heavy = srv.session("heavy", weight=1.0)
            inter = srv.session("inter", weight=8.0)
            flood = [heavy.submit(QUERY + f" LIMIT {40 - i}")
                     for i in range(12)]
            time.sleep(0.01)
            quick = [inter.submit(
                f"SELECT COUNT(*) AS c FROM t WHERE a < {k}")
                for k in (5, 10, 15)]
            answers = [int(h.result(timeout=120).to_numpy()["c"][0])
                       for h in quick]
            done_heavy = sum(h.done() for h in flood)
            assert done_heavy < len(flood), \
                "fair share should interleave, not drain the flood first"
            sizes = [len(h.result(timeout=120).to_numpy()["a"])
                     for h in flood]
            clients = srv.stats()["scheduler"]["clients"]
            assert clients["inter"]["served"] == 3
            assert clients["heavy"]["served"] == 12
            return answers, sizes
        finally:
            srv.shutdown()
    twin(body)


def test_admission_control_backpressure():
    def body(pk):
        srv = make_server(pk, max_concurrent_queries=1, max_queue_depth=2)
        try:
            handles = []
            with pytest.raises(pk.mod("server").AdmissionError):
                for _ in range(40):  # far beyond queue depth
                    handles.append(srv.submit(QUERY + " LIMIT 40",
                                              block=False))
            assert srv.stats()["scheduler"]["rejected"] >= 1
            for h in handles:
                h.result(timeout=120)
            # space freed: a blocking submit now succeeds
            res = srv.submit(QUERY).result(timeout=120)
            return check_result(res, groupby_ref(make_data()))
        finally:
            srv.shutdown()
    twin(body, rows=True)


def test_shuffle_blocks_released_after_query():
    def body(pk):
        srv = make_server(pk, enable_result_cache=False)
        try:
            got = srv.sql(QUERY).to_numpy()
            bm = srv.ctx.block_manager
            with bm.lock:
                shuf = [k for k in bm.blocks if k[0] == "shuf"]
            assert not shuf, f"leaked shuffle blocks: {shuf[:3]}"
            return got
        finally:
            srv.shutdown()
    twin(body, rows=True)


# -- attached sessions -------------------------------------------------------


def test_attached_sessions_share_warehouse():
    def body(pk):
        srv = make_server(pk)
        try:
            a = pk.SharkSession(server=srv, client_id="a")
            b = srv.session("b")
            a.create_table("u", pk.schema(x="INT32"),
                           {"x": np.arange(100, dtype=np.int32)})
            r = b.sql_np("SELECT COUNT(*) AS c FROM u")
            assert r["c"][0] == 100
            # sql2rdd still works against the shared catalog/lineage graph
            with pytest.warns(DeprecationWarning):
                rdd, names = a.sql2rdd("SELECT x FROM u WHERE x < 10")
            total = sum(batch.num_rows for batch in rdd.collect())
            assert total == 10 and names == ["x"]
            a.shutdown()  # must NOT kill the shared server context
            after = b.sql_np("SELECT COUNT(*) AS c FROM u")
            assert after["c"][0] == 100
            return r, total, after
        finally:
            srv.shutdown()
    twin(body)


# -- the port's own surface --------------------------------------------------


def test_server_exports():
    import repro_torch.server as ts
    for name in ("SharkServer", "MemoryManager", "FairScheduler",
                 "AdmissionError", "QueryHandle", "ResultCache",
                 "plan_fingerprint"):
        assert hasattr(ts, name), name
    from repro_torch.core.plan import plan_fingerprint
    from repro_torch.server.result_cache import plan_fingerprint as rc_fp
    assert rc_fp is plan_fingerprint


@pytest.mark.parametrize("kw", [{"spill_dir": "x"}, {"spill_mode": "spill"},
                                {"spill_mode": "drop"}])
def test_spill_tier_raises_until_ported(kw, tmp_path):
    """(Named when the tier raised.)  `spill_dir=` / `spill_mode=` build a
    StorageManager of the asked mode (`spill` for a directory alone),
    attach it to the memory manager (its shuffle path in spill mode), and
    `shutdown()` retires it: its writer joined, no segment left."""
    from repro_torch.core.storage import StorageManager
    from repro_torch.server import SharkServer
    if "spill_dir" in kw:
        kw = {"spill_dir": str(tmp_path / kw["spill_dir"])}
    srv = SharkServer(device="cpu", **kw)
    storage = srv.storage
    mode = kw.get("spill_mode", "spill")
    assert isinstance(storage, StorageManager) and storage.mode == mode
    assert srv.memory.storage is storage
    assert (srv.ctx.block_manager.shuffle_storage is storage) == \
        (mode == "spill")
    writer = storage._writer
    assert (writer is not None and writer.is_alive()) == (mode == "spill")
    srv.shutdown()
    assert storage._writer is None
    if writer is not None:
        assert not writer.is_alive()
    assert not glob.glob(os.path.join(storage.dir, "*.shk*"))


def test_mesh_serves_a_group_by_on_cpu_slots():
    import torch
    from repro_torch.cluster import MeshContext
    from repro_torch.server import SharkServer
    srv = SharkServer(device="cpu", default_partitions=4,
                      mesh=MeshContext(devices=[torch.device("cpu")] * 2))
    try:
        rng = np.random.default_rng(4)
        k = rng.integers(0, 9, 4_000).astype(np.int64)
        v = rng.uniform(0.0, 10.0, 4_000)
        srv.create_table("t", TORCH.schema(k="INT64", v="FLOAT64"),
                         {"k": k, "v": v})
        res = srv.sql("SELECT k, SUM(v) AS s FROM t GROUP BY k")
        got = res.to_numpy()
        assert res.metrics.mesh_devices == 2
        assert res.metrics.mesh_partitions == 4
        order = np.argsort(got["k"])
        assert np.array_equal(got["k"][order], np.arange(9))
        np.testing.assert_allclose(
            got["s"][order], np.bincount(k, weights=v, minlength=9),
            rtol=1e-9)
    finally:
        srv.shutdown()


def test_session_on_server_computes_on_its_device():
    srv = make_server(TORCH)
    try:
        sess = TORCH.SharkSession(server=srv, client_id="s")
        assert str(sess.device) == "cpu" and sess.server is srv
        assert srv.stats()["memory"]["device_bytes"] == 0
    finally:
        srv.shutdown()


def test_decode_rung_keeps_device_memos():
    """The decode-memo rung frees host memos it counts and leaves every
    block's device memo; a replaced table and shutdown drop the device
    memos."""
    srv = make_server(TORCH, enable_result_cache=False)
    try:
        srv.sql(QUERY)
        table = srv.catalog.get("t")
        for part in table.partitions:
            for blk in part.columns.values():
                blk.device_array("values", "cpu")
                blk.values()
        memos = {id(b): dict(b.enc._device) for p in table.partitions
                 for b in p.columns.values()}
        assert srv.memory.drop_decoded_caches() > 0
        assert srv.memory.decoded_cache_bytes() == 0
        for part in table.partitions:
            for blk in part.columns.values():
                assert blk.enc._device == memos[id(blk)]
        srv.create_table("t", TORCH.schema(a="INT64", b="FLOAT64"),
                         make_data(n=1000, seed=3))
        assert all(not b.enc._device for p in table.partitions
                   for b in p.columns.values())
        new = srv.catalog.get("t")
        new.partitions[0].columns["a"].device_array("values", "cpu")
    finally:
        srv.shutdown()
    assert not new.partitions[0].columns["a"].enc._device
    del srv
    gc.collect()


def test_counters_match_reference_across_a_budget_sweep():
    """The eviction order is the reference's: the same counters at every
    budget, from no pressure to less than one partition."""
    def body(pk, budget):
        # one thread, no speculative copies: a deterministic LRU order
        srv = make_server(pk, cache_budget_bytes=budget, max_threads=1,
                          enable_result_cache=False, speculation=False)
        try:
            for q in (QUERY, "SELECT COUNT(*) AS c FROM t WHERE a < 7",
                      QUERY):
                srv.sql(q)
            return counters(srv)
        finally:
            srv.shutdown()
    for budget in (5_000, 150_000, 600_000, 2_000_000):
        want, got = (body(pk, budget) for pk in PKGS)
        assert_same(got, want)


def test_two_clients_at_once_on_forced_kernel_routes():
    """Two clients run queries at once with every SQL kernel route forced
    (the wrappers' plain versions on the CPU, the radix split on the
    executor's threads): their answers equal the reference server's, and
    every map task's split is counted."""
    from repro_torch.core.shuffle import RADIX_KERNEL_CALLS
    queries = [QUERY, "SELECT COUNT(*) AS c, SUM(b) AS s FROM t "
               "WHERE b BETWEEN 0.2 AND 0.6"]

    def body(pk):
        cfg = pk.mod("core.pde").PDEConfig(
            segment_force_kernels=True, reduce_force_compiled=True,
            segment_kernel_min_rows=256)
        srv = make_server(pk, pde_config=cfg, enable_result_cache=False,
                          max_concurrent_queries=2, speculation=False)
        try:
            out, errors = {}, []

            def client(name):
                try:
                    sess = srv.session(name)
                    out[name] = [sess.sql_np(q) for q in queries * 2]
                except Exception as e:        # surfaced below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(f"c{i}",))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not errors, errors
            return [out["c0"], out["c1"]]
        finally:
            srv.shutdown()

    before = RADIX_KERNEL_CALLS["count"]
    twin(body, rows=True)
    # the port's group-by splits one map task a partition, 4 runs of it
    assert RADIX_KERNEL_CALLS["count"] - before == 4 * 8



@pytest.mark.parametrize("budget", [200_000, 240_500])
def test_decode_memos_go_before_result_entries(budget):
    """ROADMAP C.6: under pressure the port drops the host decode memos
    before any result entry; the reference evicts result entries first.
    At 200,000 bytes the group-by's decode memo of `a` (240,000 bytes)
    alone exceeds the budget, and the reference empties the result cache
    and drops the memo all the same; at 240,500 the memo fits and the
    reference gives up the results to keep it.  Up to that point the
    counters are equal."""
    count_q = "SELECT COUNT(*) AS c FROM t WHERE a < 7"

    def body(pk):
        srv = make_server(pk, cache_budget_bytes=budget, max_threads=1,
                          speculation=False)
        try:
            first = srv.sql_np(count_q)
            srv.sql(QUERY)
            mem = counters(srv)
            again = srv.submit(count_q)
            return first, again.result().to_numpy(), again.cached, mem
        finally:
            srv.shutdown()

    want, got = (body(pk) for pk in PKGS)
    assert_same(got[:2], want[:2])
    assert got[2] and not want[2]
    same = ("evictions", "recomputes", "bypasses", "partition_misses")
    assert {k: got[3][k] for k in same} == {k: want[3][k] for k in same}
    assert got[3]["result_evictions"] == 0 < want[3]["result_evictions"]


def test_decode_memo_bytes_follow_every_change():
    """The manager keeps its sum of the decode memos' bytes between block
    puts; it must still follow every memo set or released and every
    catalog change, and equal a fresh sum after queries."""
    srv = make_server(TORCH, enable_result_cache=False)
    try:
        mm = srv.memory

        def fresh():
            return sum(t.decoded_cache_nbytes
                       for t in srv.catalog.tables().values())

        assert mm.decoded_cache_bytes() == 0
        blk = srv.catalog.get("t").partitions[0].columns["a"]
        blk.values()
        assert mm.decoded_cache_bytes() == blk.enc.decoded_nbytes > 0
        blk.drop_decoded()
        assert mm.decoded_cache_bytes() == 0
        blk.values()
        held = mm.decoded_cache_bytes()
        srv.create_table("t", TORCH.schema(a="INT64", b="FLOAT64"),
                         make_data(n=1000, seed=5))
        assert held > 0 and mm.decoded_cache_bytes() == fresh() == 0
        srv.sql(QUERY)
        assert mm.decoded_cache_bytes() == fresh() > 0
    finally:
        srv.shutdown()
