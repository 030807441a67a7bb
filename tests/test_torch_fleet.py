"""The replicated SharkServer fleet on the torch port against the JAX
reference: the twin of tests/test_fleet.py.

Each body runs on both packages (`torch_twin.twin`; the port's replicas on
`device="cpu"`), asserts what its reference test asserts, and its answers
(row multisets) and plain-data observations must equal the reference's.
Where a count depends on thread timing (which replica a least-loaded pick
or a kill lands on, how many handles reroute) each package asserts the
reference's bound and the count is not compared.  The reference's
docstring follows.

Replicated SharkServer fleet (DESIGN.md §13.2): routing, the
catalog-epoch protocol that keeps plan-fingerprint result caches coherent
across replicas, and replica-loss re-routing with identical results.
"""

import time

import numpy as np
import pytest

from torch_twin import P, twin

TABLE = "visits"


def _schema():
    return P.Schema.of(k=P.DType.INT64, x=P.DType.FLOAT64, v=P.DType.FLOAT64)


def _data(n=30_000, seed=3):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 32, n).astype(np.int64),
            "x": rng.uniform(-100.0, 100.0, n),
            "v": rng.uniform(0.0, 10.0, n)}


def _fleet(n=2, routing="round_robin", **kw):
    kw.setdefault("num_workers", 2)
    kw.setdefault("max_threads", 2)
    kw.setdefault("max_concurrent_queries", 2)
    kw.setdefault("enable_result_cache", False)
    kw.setdefault("default_partitions", 6)
    fleet = P.m("cluster").SharkFleet(num_replicas=n, routing=routing, **kw)
    fleet.create_table(TABLE, _schema(), _data())
    return fleet


def _canon(res):
    names = sorted(res)
    cols = [np.round(np.asarray(res[c]), 6).astype(str) for c in names]
    nrows = len(cols[0]) if cols else 0
    return (tuple(names),
            tuple(sorted(tuple(c[i] for c in cols) for i in range(nrows))))


def _queries(n):
    out = []
    for i in range(n):
        lo = -80 + 9 * (i % 16)
        if i % 3 == 2:
            out.append(f"SELECT k, SUM(v) AS s FROM {TABLE} GROUP BY k")
        else:
            out.append(f"SELECT COUNT(*) AS c, SUM(v) AS s FROM {TABLE} "
                       f"WHERE x BETWEEN {lo} AND {lo + 40}")
    return out


def _optimized(server, sql):
    optimize = P.m("core.plan").optimize
    sess = server.session()
    return optimize(sess.plan(sql), server.catalog)


class TestRouting:
    def _round_robin_spreads_served_queries(self):
        fleet = _fleet(n=3, routing="round_robin")
        try:
            for q in _queries(9):
                fleet.sql_np(q)
            served = fleet.stats()["served"]
            assert sum(served.values()) == 9
            assert all(served[i] == 3 for i in range(3)), served
            return served
        finally:
            fleet.shutdown()

    def test_round_robin_spreads_served_queries(self):
        twin(self._round_robin_spreads_served_queries)

    def _least_loaded_avoids_busy_replica(self):
        fleet = _fleet(n=2, routing="least_loaded",
                       task_launch_overhead_s=5e-3)
        try:
            r0, r1 = fleet.replicas
            # park work on replica 0 directly, behind the fleet's back
            h = r0.server.submit(_queries(3)[2])
            deadline = time.monotonic() + 5
            while r0.server.scheduler.load() == 0:
                assert time.monotonic() < deadline, "query never enqueued"
                time.sleep(0.001)
            picked = fleet._pick(None)
            assert picked is r1, "least-loaded routed to the busy replica"
            h.result(timeout=60).to_numpy()
            return picked.index
        finally:
            fleet.shutdown()

    def test_least_loaded_avoids_busy_replica(self):
        twin(self._least_loaded_avoids_busy_replica)

    def _results_match_plain_server(self):
        fleet = _fleet(n=3, routing="least_loaded")
        try:
            ref = fleet.replicas[0].server      # same deterministic tables
            out = []
            for q in _queries(6):
                got = _canon(fleet.sql_np(q))
                assert got == _canon(ref.sql_np(q)), q
                out.append(got)
            return out
        finally:
            fleet.shutdown()

    def test_results_match_plain_server(self):
        twin(self._results_match_plain_server)


class TestEpochProtocol:
    def _create_and_ctas_align_epochs(self):
        fleet = _fleet(n=3)
        try:
            assert len(set(fleet.epochs(TABLE))) == 1
            fleet.sql(f"CREATE TABLE hot AS SELECT k, SUM(v) AS s "
                      f"FROM {TABLE} GROUP BY k")
            assert len(set(fleet.epochs("hot"))) == 1
            a = _canon(fleet.sql_np("SELECT k, s FROM hot"))
            for r in fleet.alive_replicas():
                assert _canon(r.server.sql_np("SELECT k, s FROM hot")) == a
            return [fleet.epochs(TABLE), fleet.epochs("hot"), a]
        finally:
            fleet.shutdown()

    def test_create_and_ctas_align_epochs(self):
        twin(self._create_and_ctas_align_epochs)

    def _fingerprints_identical_across_replicas(self):
        plan_fingerprint = P.m("server.result_cache").plan_fingerprint
        fleet = _fleet(n=3)
        try:
            out = []
            for q in _queries(4):
                fps = set()
                for r in fleet.alive_replicas():
                    fp, deps = plan_fingerprint(_optimized(r.server, q),
                                                r.server.catalog)
                    fps.add(fp)
                    assert deps == {TABLE: r.server.catalog.version(TABLE)}
                assert len(fps) == 1, q
                out.append(fps.pop())
            return out
        finally:
            fleet.shutdown()

    def test_fingerprints_identical_across_replicas(self):
        twin(self._fingerprints_identical_across_replicas)

    def _adopt_version_invalidates_stale_result_cache(self):
        plan_fingerprint = P.m("server.result_cache").plan_fingerprint
        fleet = _fleet(n=2, enable_result_cache=True)
        try:
            q = f"SELECT k, SUM(v) AS s FROM {TABLE} GROUP BY k"
            r0, r1 = fleet.replicas
            for r in (r0, r1):          # populate both replica caches
                r.server.sql_np(q)
            assert r1.server.result_cache.stats()["entries"] >= 1
            before = r1.server.result_cache.invalidations
            # replica 0 sees a local mutation; the fleet protocol must drag
            # replica 1's version (and cache) into the same epoch
            r0.server.create_table(TABLE, _schema(), _data())
            fleet._align_epochs(TABLE)
            assert len(set(fleet.epochs(TABLE))) == 1
            assert r1.server.result_cache.invalidations > before
            # a cache hit on either replica now reflects the new epoch:
            # fingerprints re-agree, so cross-replica staleness is impossible
            fp0, _ = plan_fingerprint(_optimized(r0.server, q),
                                      r0.server.catalog)
            fp1, _ = plan_fingerprint(_optimized(r1.server, q),
                                      r1.server.catalog)
            assert fp0 == fp1
            return [fleet.epochs(TABLE), fp0,
                    r1.server.result_cache.invalidations - before]
        finally:
            fleet.shutdown()

    def test_adopt_version_invalidates_stale_result_cache(self):
        twin(self._adopt_version_invalidates_stale_result_cache)


class TestReplicaLoss:
    def _drain_shuffles(self, fleet, timeout=60):
        deadline = time.monotonic() + timeout
        while True:
            leaked = [k for r in fleet.replicas
                      for k in r.server.ctx.block_manager.blocks
                      if k[0] == "shuf"]
            if not leaked:
                return
            assert time.monotonic() < deadline, \
                f"shuffle blocks leaked: {leaked[:5]}"
            time.sleep(0.02)

    def _replica_kill_mid_query_reroutes_with_identical_results(self):
        fleet = _fleet(n=2, task_launch_overhead_s=5e-3)
        try:
            queries = _queries(8)
            answers = {q: _canon(fleet.sql_np(q)) for q in sorted(set(
                queries))}
            handles = [(q, fleet.submit(q)) for q in queries]
            # kill the replica serving the first in-flight query
            fleet.kill_replica(handles[0][1].replica_index)
            wrong = [q for q, h in handles
                     if _canon(h.result(timeout=120).to_numpy()) != answers[q]]
            assert not wrong, wrong
            assert fleet.reroutes >= 1, "kill landed after the storm drained"
            assert len(fleet.alive_replicas()) == 1
            # dead replica's threads drain in the background and release
            # their shuffle blocks — nothing may leak fleet-wide
            self._drain_shuffles(fleet)
            return [wrong, len(fleet.alive_replicas()),
                    sorted(answers.values())]
        finally:
            fleet.shutdown()

    def test_replica_kill_mid_query_reroutes_with_identical_results(self):
        twin(self._replica_kill_mid_query_reroutes_with_identical_results)

    def _queries_after_kill_route_to_survivors_only(self):
        fleet = _fleet(n=3)
        try:
            fleet.kill_replica(1)
            for q in _queries(6):
                h = fleet.submit(q)
                assert h.replica_index != 1
                h.result(timeout=60).to_numpy()
            assert fleet.stats()["served"][1] == 0
            return fleet.stats()["served"]
        finally:
            fleet.shutdown()

    def test_queries_after_kill_route_to_survivors_only(self):
        twin(self._queries_after_kill_route_to_survivors_only)

    def _cannot_kill_last_replica(self):
        fleet = _fleet(n=2)
        try:
            fleet.kill_replica(0)
            with pytest.raises(RuntimeError):
                fleet.kill_replica(1)
            return fleet.stats()["alive"]
        finally:
            fleet.shutdown()

    def test_cannot_kill_last_replica(self):
        twin(self._cannot_kill_last_replica)
