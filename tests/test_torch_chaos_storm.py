"""The chaos storm on the torch port against the JAX reference: the twin
of tests/test_chaos_storm.py.

Each body runs on both packages (`torch_twin.twin`; the port's server on
`device="cpu"`, its storage tier in spill mode under the reference's
budget), asserts what its reference test asserts, and its answers must
equal the reference's, byte for byte after a deterministic row sort.
`TestFleetStorm` runs its fleets' replicas on the CPU.  The reference's
`TestMeshStorm` needs two XLA devices and skips on one; its body runs
here on the port alone, on 4 CPU slots (`MeshContext(devices=[cpu] * 4)`),
its answers held to the port's own fault-free baseline.  The reference's
docstring follows.

Chaos storm (DESIGN.md §16): the unified fault-injection engine drives
EVERY fault site against a live server over many seeds, and the answers
must be byte-identical to the fault-free run — injection is a performance
event, never a correctness event.

One long-lived spill-tier SharkServer takes the whole storm: per seed a
fresh seeded ChaosEngine installs over the previous one, the oracle query
grid runs, results are compared exactly (dtype + bytes after a
deterministic row sort), the per-query shuffle blocks must have drained
from the shared store, and the trip log must replay exactly.  Cumulative
trip and recovery counters prove every site actually fired and every
recovery path actually ran — a storm that never trips is vacuous.

Separate storms cover the fleet seams (replica death at submit and
mid-poll, fresh fleet per seed — dead replicas stay dead) and the mesh
dispatch seam (device loss; the cluster
tier's documented contract is exact ints/strings and 1e-9 floats, since
fewer devices regroup the float reduction tree).
"""

import numpy as np

from torch_twin import TORCH, P, twin

N_SEEDS = 20
N_FACT = 30_000


def _fact_loader():
    """Deterministic stand-in for an HDFS fact table: same seed -> same
    arrays -> same partition slices, which is what makes recompute-from-
    lineage (scheduler and storage tier alike) exact."""
    def load():
        rng = np.random.default_rng(17)
        return {"sk": rng.integers(0, 8, N_FACT).astype(np.int64),
                "gk": rng.integers(0, 40, N_FACT).astype(np.int64),
                "rev": rng.uniform(0.0, 100.0, N_FACT)}
    return load


def _make_server():
    srv = P.m("server").SharkServer(
        num_workers=4, max_threads=4,
        cache_budget_bytes=300_000,   # forces spill traffic
        max_concurrent_queries=2,
        enable_result_cache=False, speculation=False,
        default_partitions=6, default_shuffle_buckets=8,
        spill_mode="spill")
    srv.register_external(P.m("core.catalog").ExternalSource(
        "fact", P.Schema.of(sk=P.DType.INT64, gk=P.DType.INT64,
                            rev=P.DType.FLOAT64),
        _fact_loader(), 6))
    srv.create_table("dim", P.Schema.of(skey=P.DType.INT64,
                                        sval=P.DType.INT64),
                     {"skey": np.arange(8, dtype=np.int64),
                      "sval": np.arange(8, dtype=np.int64) % 3})
    return srv


GRID = [
    "SELECT gk, SUM(rev) AS s, COUNT(*) AS c FROM fact GROUP BY gk",
    "SELECT sk, AVG(rev) AS a FROM fact WHERE rev > 25 GROUP BY sk",
    "SELECT sval, SUM(rev) AS s FROM fact JOIN dim ON sk = skey "
    "GROUP BY sval",
    "SELECT gk, MAX(rev) AS m FROM fact WHERE gk < 20 GROUP BY gk "
    "ORDER BY m DESC LIMIT 10",
]


def _canon(res):
    """Deterministic row order so comparisons are content-exact: sort rows
    by the tuple of all columns."""
    cols = sorted(res)
    order = np.lexsort(tuple(res[c].astype("U32") if res[c].dtype.kind
                             in "OU" else res[c] for c in reversed(cols)))
    return {c: res[c][order] for c in cols}


def _assert_identical(base, got, label):
    assert sorted(base) == sorted(got), label
    for c in base:
        b, g = base[c], got[c]
        assert b.dtype == g.dtype, (label, c, b.dtype, g.dtype)
        assert b.shape == g.shape, (label, c)
        assert b.tobytes() == g.tobytes(), (label, c)


def _assert_shuffles_released(srv):
    leaked = [k for k in srv.ctx.block_manager.blocks if k[0] == "shuf"]
    assert not leaked, f"shuffle blocks leaked: {leaked[:5]}"


def _storm_specs(seed):
    """Per-seed spec grid: one deterministic fire per site (warmup ordinal
    varies with the seed so different passes trip) plus a low-probability
    seeded background of extra worker kills."""
    corrupt = "corrupt" if seed % 2 else "lost"
    return [
        P.FaultSpec("task.body", count=1, after=seed % 6),
        P.FaultSpec("task.body", p=0.02, count=1),
        P.FaultSpec("shuffle.fetch", count=1, after=seed % 3),
        P.FaultSpec("spill.read", kind=corrupt, count=2, after=seed % 4),
        P.FaultSpec("spill.write", count=1, after=seed % 5),
        P.FaultSpec("memory.enforce", count=1, after=(seed * 7) % 50),
    ]


class TestServerStorm:
    def _storm_results_byte_identical_over_seeds(self):
        srv = _make_server()
        try:
            baseline = [_canon(srv.sql_np(q)) for q in GRID]
            by_site = {}
            total_trips = 0
            for seed in range(N_SEEDS):
                engine = P.ChaosEngine(P.FaultSchedule(
                    seed=seed, specs=_storm_specs(seed)))
                engine.install(srv)
                try:
                    for qi, q in enumerate(GRID):
                        got = _canon(srv.sql_np(q))
                        _assert_identical(baseline[qi], got,
                                          (seed, qi, engine.stats()))
                    _assert_shuffles_released(srv)
                    # the trip log must rebuild an identical schedule
                    replay = P.FaultSchedule.replay(engine.trips)
                    fired = {}
                    for t in engine.trips:
                        assert replay.fault_at(t.site, t.ordinal, fired) \
                            == (None, t.kind), t
                finally:
                    engine.uninstall()
                total_trips += engine.trip_count()
                for site, n in engine.stats()["by_site"].items():
                    by_site[site] = by_site.get(site, 0) + n

            # the storm must actually storm: every instrumented site fired
            # at least once across the seed sweep ...
            for site in ("task.body", "shuffle.fetch", "spill.read",
                         "spill.write", "memory.enforce"):
                assert by_site.get(site, 0) > 0, (site, by_site)
            assert total_trips >= 4 * N_SEEDS, (total_trips, by_site)
            # ... and every recovery path must have actually run
            res = srv.stats()["resilience"]
            assert res["retries"] > 0, res
            st = srv.storage.stats()
            assert st["lineage_faults"] > 0, st
            assert st["spill_lost"] + st["spill_corrupt"] > 0, st
            return baseline
        finally:
            srv.shutdown()

    def test_storm_results_byte_identical_over_seeds(self):
        twin(self._storm_results_byte_identical_over_seeds)

    def _chaos_trips_land_in_exec_metrics(self):
        """ExecMetrics.fault_trips carries the per-query delta of the trip
        log (the replay handle for one query's chaos)."""
        srv = _make_server()
        try:
            sess = srv.session("metrics")
            engine = P.ChaosEngine(P.FaultSchedule(seed=1, specs=[
                P.FaultSpec("task.body", count=1)]))
            engine.install(srv)
            try:
                res = sess.submit(GRID[0]).result()
                trips = res.metrics.fault_trips
                assert trips and trips[0][0] == "task.body"
                assert res.metrics.resilience_events.get("retries", 0) > 0
                return trips[0][0]
            finally:
                engine.uninstall()
        finally:
            srv.shutdown()

    def test_chaos_trips_land_in_exec_metrics(self):
        twin(self._chaos_trips_land_in_exec_metrics)

    def _uninstall_detaches_every_seam(self):
        srv = _make_server()
        try:
            engine = P.ChaosEngine(P.FaultSchedule(seed=0))
            engine.install(srv)
            holders = [srv, srv.ctx, srv.ctx.block_manager, srv.memory,
                       srv.storage]
            assert all(h.chaos is engine for h in holders)
            engine.uninstall()
            assert all(h.chaos is None for h in holders)
            return len(holders)
        finally:
            srv.shutdown()

    def test_uninstall_detaches_every_seam(self):
        twin(self._uninstall_detaches_every_seam)


class TestFleetStorm:
    def _replica_death_at_submit_and_mid_poll(self):
        SharkFleet = P.m("cluster.fleet").SharkFleet
        rng = np.random.default_rng(5)
        data = {"k": rng.integers(0, 16, 20_000).astype(np.int64),
                "v": rng.uniform(0.0, 10.0, 20_000)}
        schema = P.Schema.of(k=P.DType.INT64, v=P.DType.FLOAT64)
        q = "SELECT k, SUM(v) AS s, COUNT(*) AS c FROM t GROUP BY k"
        baseline = None
        submit_kills = poll_kills = 0
        for seed in range(4):
            # fresh fleet per seed: dead replicas stay dead
            fleet = SharkFleet(
                num_replicas=3, num_workers=2, enable_result_cache=False,
                speculation=False, default_partitions=4,
                default_shuffle_buckets=8,
                resilience=P.ResiliencePolicy(fleet_poll_s=0.002))
            try:
                fleet.create_table("t", schema, data)
                if baseline is None:
                    baseline = _canon(fleet.sql_np(q))
                engine = P.ChaosEngine(P.FaultSchedule(seed=seed, specs=[
                    P.FaultSpec("fleet.submit", count=1, after=seed % 2),
                    P.FaultSpec("fleet.poll", count=1, after=seed % 3),
                ]))
                engine.install(fleet)
                try:
                    for _ in range(4):
                        _assert_identical(baseline, _canon(fleet.sql_np(q)),
                                          (seed, engine.stats()))
                finally:
                    engine.uninstall()
                sites = engine.stats()["by_site"]
                submit_kills += sites.get("fleet.submit", 0)
                poll_kills += sites.get("fleet.poll", 0)
                assert len(fleet.alive_replicas()) >= 1
            finally:
                fleet.shutdown()
        assert submit_kills > 0
        assert poll_kills > 0
        return baseline

    def test_replica_death_at_submit_and_mid_poll(self):
        twin(self._replica_death_at_submit_and_mid_poll)


class TestMeshStorm:
    def test_device_loss_storm(self):
        """The reference body on the port's 4 CPU slots."""
        P.pkg = TORCH
        mesh = TORCH.mesh(4)
        srv = TORCH.server(num_workers=4, enable_result_cache=False,
                           speculation=False, default_partitions=8,
                           mesh=mesh)
        try:
            rng = np.random.default_rng(9)
            srv.create_table(
                "t", P.Schema.of(k=P.DType.INT64, v=P.DType.FLOAT64),
                {"k": rng.integers(0, 12, 40_000).astype(np.int64),
                 "v": rng.uniform(0.0, 10.0, 40_000)})
            q = "SELECT k, SUM(v) AS s, COUNT(*) AS c FROM t GROUP BY k"
            baseline = _canon(srv.sql_np(q))
            kills = 0
            for seed in range(6):
                mesh.revive_all()
                engine = P.ChaosEngine(P.FaultSchedule(seed=seed, specs=[
                    P.FaultSpec("mesh.dispatch", count=1, after=seed % 2)]))
                engine.install(srv)
                try:
                    got = _canon(srv.sql_np(q))
                finally:
                    engine.uninstall()
                # cluster-tier contract: ints exact, floats to 1e-9 (device
                # loss regroups the float reduction tree)
                for c in baseline:
                    if baseline[c].dtype.kind in "iuUO":
                        assert np.array_equal(baseline[c], got[c]), (seed, c)
                    else:
                        assert np.allclose(baseline[c], got[c],
                                           rtol=1e-9, atol=1e-9), (seed, c)
                kills += engine.stats()["by_site"].get("mesh.dispatch", 0)
            assert kills > 0
            assert mesh.stats()["retries"] > 0
        finally:
            srv.shutdown()
