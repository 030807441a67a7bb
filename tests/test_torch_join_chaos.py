"""Chaos under a SharkServer on the torch port against the JAX reference:
the twin of tests/test_join_chaos.py.

Each body runs on both packages (`torch_twin.twin`; the port's servers on
`device="cpu"`), asserts what its reference test asserts (worker loss at
every shuffle boundary of a star join, during the reduce, inside a fused
exchange stage with a pipelined reduce, and with the working set spilled
and a spill segment deleted under it), and its answers must equal the
reference's; `test_replica_loss_mid_star_join_reroutes_identically`
runs the storm on a `SharkFleet` of two replicas on the CPU.  The
reference's docstring follows.

Chaos testing: worker loss at EVERY shuffle boundary of a multi-way join
(and during the reduce phase), under a SharkServer with concurrent sessions.

A 3-way star join + aggregation crosses several PDE boundaries (one
pre-shuffle map stage per join decision, one for the aggregate); this suite
kills a worker right after each one — dropping that worker's cached scan
partitions AND shuffle map outputs — and asserts:

  * every concurrent client still gets results identical to the
    failure-free run (lineage recovery, paper §2.3);
  * shuffle map outputs are released from the shared block store once the
    queries complete (no leak even when recovery re-materialized them).
"""

import glob
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from torch_twin import PKGS, P, PerPkg, twin

N_FACT = 15_000

QUERY = ("SELECT sval, COUNT(*) AS c, SUM(rev) AS total FROM fact "
         "JOIN small_d ON fact.sk = small_d.skey "
         "JOIN mid_d ON fact.mk = mid_d.mkey "
         "GROUP BY sval")


def _make_server():
    rng = np.random.default_rng(11)
    srv = P.m("server").SharkServer(
        num_workers=4, max_threads=4,
        enable_result_cache=False,  # every run must execute
        max_concurrent_queries=2, default_partitions=6,
        default_shuffle_buckets=8)
    srv.create_table("fact", P.Schema.of(
        sk=P.DType.INT64, mk=P.DType.INT64, rev=P.DType.FLOAT64),
        {"sk": rng.integers(0, 8, N_FACT).astype(np.int64),
         "mk": rng.integers(0, 300, N_FACT).astype(np.int64),
         "rev": rng.uniform(0, 10, N_FACT)})
    srv.create_table("small_d", P.Schema.of(skey=P.DType.INT64,
                                            sval=P.DType.INT64,
                                            sname=P.DType.STRING),
                     {"skey": np.arange(8, dtype=np.int64),
                      "sval": np.arange(8, dtype=np.int64) % 3,
                      "sname": np.array([f"grp-{i % 3}" for i in range(8)])})
    srv.create_table("mid_d", P.Schema.of(mkey=P.DType.INT64,
                                          mval=P.DType.INT64),
                     {"mkey": np.arange(300, dtype=np.int64),
                      "mval": np.arange(300, dtype=np.int64) % 9})
    return srv


def _canon(result) -> dict:
    out = {}
    for sval, c, total in zip(result["sval"].tolist(), result["c"].tolist(),
                              result["total"].tolist()):
        out[int(sval)] = (int(c), round(float(total), 6))
    return out


def _run_concurrent(srv, n_clients: int = 2):
    sessions = [srv.session(f"chaos-{i}") for i in range(n_clients)]
    with ThreadPoolExecutor(max_workers=n_clients) as pool:
        futs = [pool.submit(lambda s=s: _canon(s.sql_np(QUERY)))
                for s in sessions]
        return [f.result(timeout=120) for f in futs]


def _assert_shuffles_released(srv):
    leaked = [k for k in srv.ctx.block_manager.blocks if k[0] == "shuf"]
    assert not leaked, f"shuffle blocks leaked: {leaked[:5]}"


QUERY_DICT = ("SELECT sname, COUNT(*) AS c, SUM(rev) AS total FROM fact "
              "JOIN small_d ON fact.sk = small_d.skey "
              "GROUP BY sname ORDER BY sname")


def _worker_loss_with_dictionary_preserving_shuffle():
    """The dictionary-preserving shuffle block format survives recompute-
    from-lineage: a STRING group key crosses both join and aggregate
    boundaries as (codes, partition dictionary); killing a worker after
    each map stage forces lost blocks — including their dictionaries — to
    be recomputed, and the merged result must be identical to the
    failure-free run."""
    srv = _make_server()
    try:
        scheduler = srv.ctx.scheduler
        orig_map_stage = scheduler.run_map_stage
        calls = []
        scheduler.run_map_stage = lambda dep: (calls.append(dep),
                                               orig_map_stage(dep))[1]
        sess = srv.session("dict-chaos")
        baseline = sess.sql_np(QUERY_DICT)
        scheduler.run_map_stage = orig_map_stage
        n_boundaries = len(calls)
        assert n_boundaries >= 2
        base_rows = list(zip(baseline["sname"].tolist(),
                             baseline["c"].tolist(),
                             [round(float(t), 6)
                              for t in baseline["total"].tolist()]))
        assert base_rows and all(isinstance(s, str) and s
                                 for s, _, _ in base_rows)
        _assert_shuffles_released(srv)

        def kill_one():
            w = sorted(scheduler.alive)[0]
            scheduler.kill_worker(w)
            scheduler.add_worker()

        for k in range(n_boundaries):
            state = {"i": 0}
            lock = threading.Lock()

            def chaotic_map_stage(dep, _k=k):
                stats = orig_map_stage(dep)
                with lock:
                    fire = state["i"] == _k
                    state["i"] += 1
                if fire:
                    kill_one()
                return stats

            scheduler.run_map_stage = chaotic_map_stage
            try:
                got = sess.sql_np(QUERY_DICT)
            finally:
                scheduler.run_map_stage = orig_map_stage
            got_rows = list(zip(got["sname"].tolist(), got["c"].tolist(),
                                [round(float(t), 6)
                                 for t in got["total"].tolist()]))
            assert got_rows == base_rows, \
                f"boundary {k}: dict-shuffle result diverged after recompute"
            _assert_shuffles_released(srv)
        assert scheduler.tasks_recomputed > 0
        return base_rows
    finally:
        srv.shutdown()


N_EXT = 60_000


def _ext_fact_loader():
    """Deterministic stand-in for an HDFS fact table: same seed -> same
    arrays -> same partition slices, which is what makes recompute-from-
    lineage (both the scheduler's and the storage tier's) exact."""
    def load():
        rng = np.random.default_rng(11)
        return {"sk": rng.integers(0, 8, N_EXT).astype(np.int64),
                "mk": rng.integers(0, 300, N_EXT).astype(np.int64),
                "rev": rng.uniform(0, 10, N_EXT)}
    return load


def _make_spill_server(budget=None, spill_mode=None, spill_dir=None):
    srv = P.m("server").SharkServer(
        num_workers=4, max_threads=4, cache_budget_bytes=budget,
        max_concurrent_queries=2, default_partitions=6,
        default_shuffle_buckets=8, spill_mode=spill_mode,
        spill_dir=spill_dir)
    srv.register_external(P.m("core.catalog").ExternalSource(
        "fact", P.Schema.of(sk=P.DType.INT64, mk=P.DType.INT64,
                            rev=P.DType.FLOAT64),
        _ext_fact_loader(), 6))
    srv.create_table("small_d", P.Schema.of(skey=P.DType.INT64,
                                            sval=P.DType.INT64),
                     {"skey": np.arange(8, dtype=np.int64),
                      "sval": np.arange(8, dtype=np.int64) % 3})
    srv.create_table("mid_d", P.Schema.of(mkey=P.DType.INT64,
                                          mval=P.DType.INT64),
                     {"mkey": np.arange(300, dtype=np.int64),
                      "mval": np.arange(300, dtype=np.int64) % 9})
    return srv


def _spill_query(i: int) -> str:
    # rev is uniform(0, 10): the WHERE keeps every row, but each variant has
    # its own plan fingerprint so repeated rounds execute instead of hitting
    # the result cache (pressure -> spill must actually happen each round).
    return ("SELECT sval, COUNT(*) AS c, SUM(rev) AS total FROM fact "
            "JOIN small_d ON fact.sk = small_d.skey "
            "JOIN mid_d ON fact.mk = mid_d.mkey "
            f"WHERE rev >= -{i + 1} GROUP BY sval")


def _worker_loss_while_blocks_spilled_and_spill_file_deleted(tmp_path):
    """Storage-tier chaos (DESIGN.md §12): with the working set spilled to
    disk under memory pressure, kill a worker mid-query AND delete a spill
    segment out from under the store.  The scheduler re-runs lost tasks from
    RDD lineage; the storage tier restores the missing segment from
    partition lineage (the external loader).  Either way the answer must be
    identical to the failure-free run — a lost spill file is a performance
    event, never a correctness event."""
    base_srv = _make_spill_server()           # no budget, no storage tier
    try:
        baseline = _canon(base_srv.session("base").sql_np(_spill_query(0)))
    finally:
        base_srv.shutdown()
    assert baseline, "baseline produced no groups"

    spill_dir = str(tmp_path / "chaos-spill")
    srv = _make_spill_server(budget=200_000, spill_mode="spill",
                             spill_dir=spill_dir)
    try:
        sess = srv.session("spill-chaos")
        assert _canon(sess.sql_np(_spill_query(0))) == baseline
        srv.storage.flush()
        assert srv.storage.stats()["spills"] > 0, "working set never spilled"
        assert glob.glob(os.path.join(spill_dir, "*.shk"))

        scheduler = srv.ctx.scheduler
        orig_map_stage = scheduler.run_map_stage
        state = {"fired": False}
        lock = threading.Lock()

        def chaotic_map_stage(dep):
            stats = orig_map_stage(dep)
            with lock:
                fire = not state["fired"]
                state["fired"] = True
            if fire:
                w = sorted(scheduler.alive)[0]
                scheduler.kill_worker(w)
                scheduler.add_worker()
                srv.storage.flush()
                files = sorted(glob.glob(os.path.join(spill_dir, "*.shk")))
                if files:
                    os.remove(files[0])      # segment vanishes mid-query
            return stats

        scheduler.run_map_stage = chaotic_map_stage
        try:
            got = _canon(sess.sql_np(_spill_query(1)))
        finally:
            scheduler.run_map_stage = orig_map_stage
        assert state["fired"]
        assert got == baseline, "worker loss + spill-file loss diverged"
        _assert_shuffles_released(srv)

        # total spill loss: every segment deleted -> every cold partition
        # must come back through partition lineage, not the disk tier
        srv.storage.flush()
        for f in glob.glob(os.path.join(spill_dir, "*.shk")):
            os.remove(f)
        assert _canon(sess.sql_np(_spill_query(2))) == baseline
        st = srv.storage.stats()
        assert st["spill_lost"] + st["lineage_faults"] > 0, \
            f"expected lineage recovery after deleting spill files: {st}"
        return baseline
    finally:
        srv.shutdown()


def _worker_loss_at_each_shuffle_boundary_and_during_reduce():
    srv = _make_server()
    try:
        # ---- failure-free baseline + count this query's shuffle boundaries
        scheduler = srv.ctx.scheduler
        orig_map_stage = scheduler.run_map_stage
        calls = []
        scheduler.run_map_stage = lambda dep: (calls.append(dep),
                                               orig_map_stage(dep))[1]
        baseline = _run_concurrent(srv, n_clients=1)[0]
        scheduler.run_map_stage = orig_map_stage
        n_boundaries = len(calls)
        assert n_boundaries >= 3, \
            f"expected >=3 map stages (2 joins + aggregate), saw {n_boundaries}"
        assert baseline, "baseline produced no groups"
        _assert_shuffles_released(srv)

        def kill_one():
            w = sorted(scheduler.alive)[0]
            scheduler.kill_worker(w)
            scheduler.add_worker()

        # ---- kill a worker right AFTER each shuffle boundary in turn
        for k in range(n_boundaries):
            state = {"i": 0}
            lock = threading.Lock()

            def chaotic_map_stage(dep, _k=k):
                stats = orig_map_stage(dep)
                with lock:
                    fire = state["i"] == _k
                    state["i"] += 1
                if fire:
                    kill_one()
                return stats

            scheduler.run_map_stage = chaotic_map_stage
            try:
                results = _run_concurrent(srv)
            finally:
                scheduler.run_map_stage = orig_map_stage
            for r in results:
                assert r == baseline, \
                    f"boundary {k}: result diverged after worker loss"
            _assert_shuffles_released(srv)

        # ---- kill a worker DURING the reduce (before the result stage)
        orig_result_stage = scheduler.run_result_stage
        fired = {"done": False}
        lock = threading.Lock()

        def chaotic_result_stage(rdd):
            with lock:
                fire = not fired["done"]
                fired["done"] = True
            if fire:
                kill_one()
            return orig_result_stage(rdd)

        scheduler.run_result_stage = chaotic_result_stage
        try:
            results = _run_concurrent(srv)
        finally:
            scheduler.run_result_stage = orig_result_stage
        for r in results:
            assert r == baseline, "reduce-phase worker loss diverged"
        _assert_shuffles_released(srv)
        assert scheduler.tasks_recomputed > 0 or scheduler.tasks_launched > 0
        return baseline
    finally:
        srv.shutdown()


QUERY_FUSED = ("SELECT COUNT(*) AS c, SUM(rev) AS total FROM fact "
               "JOIN mid_d ON fact.mk = mid_d.mkey WHERE rev >= 0.5")


def _make_shuffle_join_server():
    """Like _make_server but with a broadcast threshold low enough that the
    fact⋈mid_d join truly SHUFFLES both sides: the filtered fact side ships
    through the fused exchange (whole-stage program, DESIGN.md §14) and the
    join reduce splits consume its pieces inside the aggregate map stage."""
    PDEConfig = P.m("core.pde").PDEConfig
    rng = np.random.default_rng(11)
    # max_threads leaves slack over the 8 join-reduce splits so the final
    # aggregate boundary passes the pipelined-reduce admission gate — the
    # kill must land while the overlapped reduce is already fetching
    srv = P.m("server").SharkServer(
        num_workers=4, max_threads=12, enable_result_cache=False,
        max_concurrent_queries=2, default_partitions=6,
        default_shuffle_buckets=8,
        pde_config=PDEConfig(broadcast_threshold_bytes=1024,
                             target_reduce_bytes=16384))
    srv.create_table("fact", P.Schema.of(
        sk=P.DType.INT64, mk=P.DType.INT64, rev=P.DType.FLOAT64),
        {"sk": rng.integers(0, 8, N_FACT).astype(np.int64),
         "mk": rng.integers(0, 300, N_FACT).astype(np.int64),
         "rev": rng.uniform(0, 10, N_FACT)})
    srv.create_table("mid_d", P.Schema.of(mkey=P.DType.INT64,
                                          mval=P.DType.INT64),
                     {"mkey": np.arange(300, dtype=np.int64),
                      "mval": np.arange(300, dtype=np.int64) % 9})
    return srv


def _worker_loss_mid_fused_stage_with_reduce_started():
    """Whole-stage fusion chaos (DESIGN.md §14): the filtered fact side of
    the join ships through a FUSED exchange stage (scan→filter→partition
    inside one stage program per map task), and the downstream global
    aggregate runs its reduce PIPELINED — started while the aggregate's
    map stage is still draining.

    Phase 1 kills the worker holding fused exchange pieces at the worst
    moment: the pipelined reduce has already fetched its first map's
    output, and straggler aggregate maps — whose join fetch needs the
    dropped fused blocks — are still running, so lineage recovery re-runs
    the fused stage program *while the pipelined reduce is in flight*.
    Phase 2 deterministically kills the owner of a fused block right after
    the exchange stage completes.  Both runs must produce results
    identical to the failure-free run, recovery must observably climb
    through the fused stage, and no shuffle blocks may leak."""
    BucketedBatch = P.m("core.shuffle").BucketedBatch
    srv = _make_shuffle_join_server()
    try:
        scheduler = srv.ctx.scheduler
        bm = srv.ctx.block_manager
        orig_map_stage = scheduler.run_map_stage
        orig_pieces = scheduler._map_output_pieces
        fused = {"n": 0}
        fused_sids = set()
        lock = threading.Lock()

        def counting_pieces(dep, batch):
            if isinstance(batch, BucketedBatch):
                with lock:
                    fused["n"] += 1
                    fused_sids.add(dep.shuffle_id)
            return orig_pieces(dep, batch)

        scheduler._map_output_pieces = counting_pieces

        # ---- failure-free baseline; count shuffle boundaries
        calls = []
        scheduler.run_map_stage = lambda dep: (calls.append(dep),
                                               orig_map_stage(dep))[1]
        sess = srv.session("fused-chaos")
        res = sess.sql_np(QUERY_FUSED)
        baseline = (int(res["c"][0]), round(float(res["total"][0]), 6))
        scheduler.run_map_stage = orig_map_stage
        n_boundaries = len(calls)
        assert n_boundaries >= 3   # both join exchanges + the aggregate
        assert fused["n"] > 0, "no map task shipped fused stage pieces"
        _assert_shuffles_released(srv)

        # ---- phase 1: kill the fused-block owner mid-aggregate-stage,
        # after the pipelined reduce observably started
        last = n_boundaries - 1     # the aggregate's (pipelined) boundary
        state = {"i": 0, "killed": None, "sid": None}
        recomputed_before = scheduler.tasks_recomputed
        fused_before = fused["n"]

        def kill_fused_owner_after_reduce_fetch(agg_sid):
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                if any(e[1] == "reduce-fetch" and e[2] == agg_sid
                       for e in scheduler.stage_events):
                    break
                time.sleep(0.005)
            victim = None
            while time.monotonic() < deadline and victim is None:
                with lock:
                    sids = set(fused_sids)
                with bm.lock:
                    # the fused block for the HIGHEST bucket: that bucket
                    # is joined by a (delayed) straggler split, so dropping
                    # it guarantees a post-kill FetchFailed
                    cands = [(key[3], worker)
                             for key, (worker, _b) in bm.blocks.items()
                             if key[0] == "shuf" and key[1] in sids]
                    if cands:
                        victim = max(cands)[1]
                time.sleep(0.005)
            if victim is not None:
                scheduler.kill_worker(victim)
                scheduler.add_worker()
                with lock:
                    state["killed"] = victim

        def chaotic_map_stage(dep):
            with lock:
                fire = state["i"] == last
                state["i"] += 1
            if not fire:
                return orig_map_stage(dep)
            state["sid"] = dep.shuffle_id
            dep.parent.delay_fn = lambda split: 0.0 if split == 0 else 0.5
            t = threading.Thread(
                target=kill_fused_owner_after_reduce_fetch,
                args=(dep.shuffle_id,), daemon=True)
            t.start()
            try:
                return orig_map_stage(dep)
            finally:
                t.join(timeout=15.0)

        scheduler.run_map_stage = chaotic_map_stage
        try:
            res = sess.sql_np(QUERY_FUSED)
        finally:
            scheduler.run_map_stage = orig_map_stage
        got = (int(res["c"][0]), round(float(res["total"][0]), 6))
        assert state["killed"] is not None, "kill never fired mid-stage"
        assert got == baseline, "mid-fused-stage worker loss diverged"
        _assert_shuffles_released(srv)
        ev = scheduler.stage_events
        fetches = [e for e in ev
                   if e[1] == "reduce-fetch" and e[2] == state["sid"]]
        dones = [e for e in ev
                 if e[1] == "map-done" and e[2] == state["sid"]]
        assert fetches and dones
        assert fetches[0][0] < max(d[0] for d in dones), \
            "reduce was not in flight when the worker died"
        assert scheduler.tasks_recomputed > recomputed_before, \
            "straggler maps never lineage-recovered the fused blocks"
        assert fused["n"] > fused_before, \
            "recovery did not climb through the fused stage program"

        # ---- phase 2: deterministic loss of a fused exchange block right
        # after its map stage completes — the downstream fetch must
        # FetchFail and recovery re-runs the fused stage program
        recomputed_before = scheduler.tasks_recomputed
        fused_before = fused["n"]
        state2 = {"fired": False}

        def chaotic_first_boundary(dep):
            stats = orig_map_stage(dep)
            with lock:
                fire = (not state2["fired"]
                        and dep.shuffle_id in fused_sids)
                if fire:
                    state2["fired"] = True
            if fire:
                with bm.lock:
                    owners = [w for key, (w, _b) in bm.blocks.items()
                              if key[0] == "shuf"
                              and key[1] == dep.shuffle_id]
                assert owners, "fused exchange materialized no blocks"
                scheduler.kill_worker(owners[0])
                scheduler.add_worker()
            return stats

        scheduler.run_map_stage = chaotic_first_boundary
        try:
            res = sess.sql_np(QUERY_FUSED)
        finally:
            scheduler.run_map_stage = orig_map_stage
            scheduler._map_output_pieces = orig_pieces
        got = (int(res["c"][0]), round(float(res["total"][0]), 6))
        assert state2["fired"], "no fused exchange boundary in chaos run"
        assert got == baseline, "fused-exchange block loss diverged"
        _assert_shuffles_released(srv)
        assert scheduler.tasks_recomputed > recomputed_before, \
            "lineage recovery never re-ran the lost fused map task"
        assert fused["n"] > fused_before, \
            "recovery did not climb through the fused stage program"
        return baseline
    finally:
        srv.shutdown()


def _replica_loss_mid_star_join_reroutes_identically():
    """Cluster-tier chaos (DESIGN.md §13.2): run the star-join storm on a
    2-replica fleet and kill the replica serving the first in-flight query.
    Every handle bound to the dead replica must re-route to the survivor and
    recompute the full multi-boundary join from that replica's own lineage —
    results identical to the failure-free run, and the dead replica's
    draining threads must still release their shuffle blocks."""
    SharkFleet = P.m("cluster").SharkFleet
    rng = np.random.default_rng(11)
    fleet = SharkFleet(num_replicas=2, routing="least_loaded",
                       num_workers=4, max_threads=4,
                       enable_result_cache=False, max_concurrent_queries=2,
                       default_partitions=6, default_shuffle_buckets=8,
                       task_launch_overhead_s=5e-3)
    try:
        fleet.create_table("fact", P.Schema.of(
            sk=P.DType.INT64, mk=P.DType.INT64, rev=P.DType.FLOAT64),
            {"sk": rng.integers(0, 8, N_FACT).astype(np.int64),
             "mk": rng.integers(0, 300, N_FACT).astype(np.int64),
             "rev": rng.uniform(0, 10, N_FACT)})
        fleet.create_table("small_d", P.Schema.of(
            skey=P.DType.INT64, sval=P.DType.INT64, sname=P.DType.STRING),
            {"skey": np.arange(8, dtype=np.int64),
             "sval": np.arange(8, dtype=np.int64) % 3,
             "sname": np.array([f"grp-{i % 3}" for i in range(8)])})
        fleet.create_table("mid_d", P.Schema.of(
            mkey=P.DType.INT64, mval=P.DType.INT64),
            {"mkey": np.arange(300, dtype=np.int64),
             "mval": np.arange(300, dtype=np.int64) % 9})

        baseline = _canon(fleet.sql_np(QUERY))
        assert baseline, "baseline produced no groups"

        handles = [fleet.submit(QUERY) for _ in range(6)]
        fleet.kill_replica(handles[0].replica_index)
        for h in handles:
            assert _canon(h.result(timeout=120).to_numpy()) == baseline, \
                "replica loss mid-join diverged from the failure-free run"
        assert fleet.reroutes >= 1, "kill landed after the storm drained"

        deadline = time.monotonic() + 60
        while True:
            leaked = [k for r in fleet.replicas
                      for k in r.server.ctx.block_manager.blocks
                      if k[0] == "shuf"]
            if not leaked:
                break
            assert time.monotonic() < deadline, \
                f"shuffle blocks leaked after replica loss: {leaked[:5]}"
            time.sleep(0.02)
        return sorted(baseline.items())
    finally:
        fleet.shutdown()


def test_replica_loss_mid_star_join_reroutes_identically():
    twin(_replica_loss_mid_star_join_reroutes_identically)


def test_worker_loss_with_dictionary_preserving_shuffle():
    twin(_worker_loss_with_dictionary_preserving_shuffle)


def test_worker_loss_while_blocks_spilled_and_spill_file_deleted(tmp_path):
    dirs = PerPkg({pk.name: tmp_path / pk.name for pk in PKGS})
    twin(_worker_loss_while_blocks_spilled_and_spill_file_deleted, dirs)


def test_worker_loss_at_each_shuffle_boundary_and_during_reduce():
    twin(_worker_loss_at_each_shuffle_boundary_and_during_reduce)


def test_worker_loss_mid_fused_stage_with_reduce_started():
    twin(_worker_loss_mid_fused_stage_with_reduce_started)
