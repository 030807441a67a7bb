"""Whole-stage compilation and pipelined scheduling on the torch port
against the JAX reference: the twin of tests/test_stage_pipeline.py.

Each body runs on both packages (`torch_twin.twin`; the port's sessions on
`device="cpu"`), asserts what its reference test asserts, and its answers
and plain-data locals must equal the reference's (floats to rtol 1e-12);
event logs, whose order follows thread timing, are not compared.  The
reference's double-buffered `shuffle._kernel_buckets` has no port: the
port's map side splits with one `radix_split` (`shuffle.split_keys`), and
its twin holds that split's stable row order and bucket starts to the ones
the reference's double-buffered bucket ids give.  The reference's
docstring follows.

Whole-stage compilation + pipelined scheduling (DESIGN.md §14).

Deterministic probes of the fused-stage machinery, complementing the
seeded differential grid in test_oracle_differential.py:

  * the pipelined scheduler observably starts a reduce task BEFORE the map
    stage drains (event-order probe on `Scheduler.stage_events`, with a
    straggler injected on the later map splits);
  * the reduce result computed by the pipeline is consumed through
    `PipelinedShuffledRDD` (hit counter) and matches the pull path;
  * double-buffered Pallas dispatch (colscan chunking, radix-partition
    chunking) is bit-identical to single-shot dispatch
    (kernels_interpret-marked, runs on CPU in interpret mode);
  * fusion is physical-layer only: `explain()` text and the optimizer
    `plan_fingerprint` are byte-identical with stage_fusion on / off /
    force.
"""

import numpy as np
import pytest

from torch_twin import JAX, P, observed, twin


def _force_kernels():
    return P.m("core.pde").PDEConfig(segment_force_kernels=True,
                                     segment_kernel_min_rows=256,
                                     segment_min_compiled_rows=1)


def _star_session(backend="compiled", pde_config=None, rows=3000,
                  partitions=3, **kw):
    rng = np.random.default_rng(0)
    sess = P.SharkSession(num_workers=2, max_threads=4,
                        default_partitions=partitions, backend=backend,
                        pde_config=pde_config, **kw)
    data = {
        "fn": rng.integers(0, 100, rows).astype(np.int64),
        "fv": rng.uniform(0, 10, rows),
        "fd": rng.choice(np.round(np.linspace(0.0, 9.0, 37), 3), rows),
        "fs": np.array([f"g{i}" for i in rng.integers(0, 8, rows)]),
    }
    sess.create_table("t", P.Schema.of(fn=P.DType.INT64, fv=P.DType.FLOAT64,
                                     fd=P.DType.FLOAT64, fs=P.DType.STRING),
                      data)
    return sess, data


# ---------------------------------------------------------------------------
# PDE gate
# ---------------------------------------------------------------------------


def _stage_fusion_gate():
    cfg = P.m("core.pde").PDEConfig()
    big = cfg.stage_fusion_min_rows
    assert P.m("core.pde").decide_stage_fusion(big, "on", "compiled", "coded",
                               cfg).route == "whole-stage"
    assert P.m("core.pde").decide_stage_fusion(big, "off", "compiled", "coded",
                               cfg).route == "segment"
    assert P.m("core.pde").decide_stage_fusion(big, "on", "numpy", "coded",
                               cfg).route == "segment"
    assert P.m("core.pde").decide_stage_fusion(big, "on", "compiled", "decoded",
                               cfg).route == "segment"
    # row floor applies in "on" mode, not in "force"
    assert P.m("core.pde").decide_stage_fusion(big - 1, "on", "compiled", "coded",
                               cfg).route == "segment"
    assert P.m("core.pde").decide_stage_fusion(big - 1, "force", "compiled", "coded",
                               cfg).route == "whole-stage"
    return observed(locals())


def test_stage_fusion_gate():
    twin(_stage_fusion_gate)


def _pipelined_reduce_admission_gate():
    """The overlap thread is admitted only when the executor pool keeps a
    slot free of map tasks; "force" mode bypasses the check."""
    cfg = P.m("core.pde").PDEConfig()
    assert P.m("core.pde").decide_pipelined_reduce(3, 4, "on", cfg).route == "pipelined"
    # map splits saturate (or exceed) the pool -> sequential pull fetch
    assert P.m("core.pde").decide_pipelined_reduce(4, 4, "on", cfg).route == "pull"
    assert P.m("core.pde").decide_pipelined_reduce(8, 4, "on", cfg).route == "pull"
    assert P.m("core.pde").decide_pipelined_reduce(8, 4, "force", cfg).route == "pipelined"
    # the slack requirement is a PDE knob
    wide = P.m("core.pde").PDEConfig(pipeline_reduce_slack_threads=3)
    assert P.m("core.pde").decide_pipelined_reduce(3, 4, "on", wide).route == "pull"
    assert P.m("core.pde").decide_pipelined_reduce(1, 4, "on", wide).route == "pipelined"
    return [P.m("core.pde").decide_pipelined_reduce(m, 4, mode, c).route
            for m, mode, c in ((3, "on", cfg), (4, "on", cfg), (8, "on", cfg),
                               (8, "force", cfg), (3, "on", wide),
                               (1, "on", wide))]


def test_pipelined_reduce_admission_gate():
    twin(_pipelined_reduce_admission_gate)


def _pull_fallback_when_pool_is_saturated():
    """With map splits saturating the pool the boundary must skip the
    overlap thread (no reduce-fetch event) and still be row-identical."""
    sess, data = _star_session(partitions=4)   # 4 splits, 4 pool threads
    got = sess.sql_np("SELECT SUM(fv) AS s, COUNT(*) AS c FROM t")
    np.testing.assert_allclose(got["s"], [data["fv"].sum()], rtol=1e-9)
    assert int(got["c"][0]) == len(data["fv"])
    assert not any(e[1] == "reduce-fetch"
                   for e in sess.ctx.scheduler.stage_events)
    assert any("sequential fetch" in r
               for r in sess.metrics().pipeline_decisions)
    # the fused map side is unaffected by the reduce-side admission gate
    assert sess.metrics().fused_partitions() > 0
    sess.shutdown()
    return observed(locals())


def test_pull_fallback_when_pool_is_saturated():
    twin(_pull_fallback_when_pool_is_saturated)


# ---------------------------------------------------------------------------
# Pipelined scheduling: reduce starts before the map stage drains
# ---------------------------------------------------------------------------


def _reduce_starts_before_map_stage_drains(monkeypatch):
    """Straggle map splits 1..n; the pipelined reduce must fetch map 0's
    pieces (logging "reduce-fetch") while the stragglers are still
    running — i.e. at a lower event sequence than the last "map-done"."""
    sess, data = _star_session()
    sched = sess.ctx.scheduler
    orig = sched.run_map_stage

    def straggle_then_run(dep, *a, **kw):
        dep.parent.delay_fn = lambda split: 0.0 if split == 0 else 0.4
        return orig(dep, *a, **kw)

    monkeypatch.setattr(sched, "run_map_stage", straggle_then_run)
    got = sess.sql_np("SELECT SUM(fv) AS s, COUNT(*) AS c FROM t")
    np.testing.assert_allclose(got["s"], [data["fv"].sum()], rtol=1e-9)
    assert int(got["c"][0]) == len(data["fv"])

    ev = sched.stage_events
    fetches = [e for e in ev if e[1] == "reduce-fetch"]
    assert fetches, f"no pipelined reduce-fetch event: {ev}"
    shuffle_id = fetches[0][2]
    dones = [e for e in ev if e[1] == "map-done" and e[2] == shuffle_id]
    assert len(dones) == 3
    assert fetches[0][0] < max(d[0] for d in dones), \
        f"reduce never overlapped the map stage: {ev}"
    assert any(e[1] == "reduce-done" and e[2] == shuffle_id for e in ev)
    sess.shutdown()
    return observed(locals(), skip=("ev", "fetches", "dones", "shuffle_id"))


def test_reduce_starts_before_map_stage_drains(monkeypatch):
    twin(_reduce_starts_before_map_stage_drains, monkeypatch)


def _pipelined_reduce_result_is_consumed(monkeypatch):
    """The result stage must consume the pipeline-precomputed reduce output
    (PipelinedShuffledRDD hit) rather than recomputing it via pull."""
    phys = P.m("core.physical")
    captured = []
    base = phys.PipelinedShuffledRDD

    class Capture(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            captured.append(self)

    monkeypatch.setattr(phys, "PipelinedShuffledRDD", Capture)
    sess, data = _star_session()
    got = sess.sql_np("SELECT MIN(fn) AS mn, MAX(fn) AS mx FROM t")
    assert int(got["mn"][0]) == int(data["fn"].min())
    assert int(got["mx"][0]) == int(data["fn"].max())
    assert captured, "global aggregate did not build a PipelinedShuffledRDD"
    assert sum(r.pipelined_hits for r in captured) > 0
    sess.shutdown()
    return observed(locals())


def test_pipelined_reduce_result_is_consumed(monkeypatch):
    twin(_pipelined_reduce_result_is_consumed, monkeypatch)


def _pipelined_reduce_failure_falls_back_to_pull(monkeypatch):
    """A crashing pipelined reduce attempt is an overlap loss, never a
    correctness loss: the split recomputes on the standard pull path."""
    Scheduler = P.m("core.runtime").Scheduler
    orig = Scheduler._pipelined_reduce

    def crash(self, dep, split, buckets, reduce_fn, cancel, results, rlock):
        def boom(*a, **kw):
            raise RuntimeError("injected pipelined-reduce failure")
        return orig(self, dep, split, buckets, boom, cancel, results, rlock)

    monkeypatch.setattr(Scheduler, "_pipelined_reduce", crash)
    sess, data = _star_session()
    got = sess.sql_np("SELECT SUM(fv) AS s, COUNT(*) AS c FROM t")
    np.testing.assert_allclose(got["s"], [data["fv"].sum()], rtol=1e-9)
    assert int(got["c"][0]) == len(data["fv"])
    assert not any(e[1] == "reduce-done"
                   for e in sess.ctx.scheduler.stage_events)
    sess.shutdown()
    return observed(locals())


def test_pipelined_reduce_failure_falls_back_to_pull(monkeypatch):
    twin(_pipelined_reduce_failure_falls_back_to_pull, monkeypatch)


# ---------------------------------------------------------------------------
# Double-buffered Pallas dispatch (interpret mode on CPU)
# ---------------------------------------------------------------------------


def _double_buffered_colscan_matches_single_shot(monkeypatch):
    kernel_ops = P.m("kernels").ops
    sess_n, _ = _star_session(backend="numpy", rows=5000)
    want = sess_n.sql_np("SELECT COUNT(*) AS c, SUM(fv) AS s, MIN(fv) AS mn,"
                         " MAX(fv) AS mx FROM t WHERE fn BETWEEN 20 AND 80")
    sess_n.shutdown()

    monkeypatch.setitem(kernel_ops.DOUBLE_BUFFER, "chunk_rows", 512)
    monkeypatch.setitem(kernel_ops.DOUBLE_BUFFER, "dispatches", 0)
    sess_k, _ = _star_session(pde_config=_force_kernels(), rows=5000)
    got = sess_k.sql_np("SELECT COUNT(*) AS c, SUM(fv) AS s, MIN(fv) AS mn,"
                        " MAX(fv) AS mx FROM t WHERE fn BETWEEN 20 AND 80")
    assert sess_k.metrics().segment_routes().get("colscan", 0) > 0
    assert kernel_ops.DOUBLE_BUFFER["dispatches"] > 1, \
        "colscan never took the double-buffered chunk path"
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    sess_k.shutdown()
    return observed(locals())


@pytest.mark.kernels_interpret
def test_double_buffered_colscan_matches_single_shot(monkeypatch):
    twin(_double_buffered_colscan_matches_single_shot, monkeypatch)


def _double_buffered_radix_partition_is_bit_identical(monkeypatch):
    rng = np.random.default_rng(3)
    k = rng.integers(0, 1 << 40, 5000).astype(np.uint64)
    if P.pkg is not JAX:
        # one radix_split launch: (stable row order, bucket starts)
        split = P.m("core.shuffle").split_keys(k.astype(np.int64), 8, "cpu")
        return np.asarray(split.order), np.asarray(split.bounds)
    _kernel_buckets = P.m("core.shuffle")._kernel_buckets
    kernel_ops = P.m("kernels").ops
    full = _kernel_buckets(k, 8)
    monkeypatch.setitem(kernel_ops.DOUBLE_BUFFER, "chunk_rows", 512)
    monkeypatch.setitem(kernel_ops.DOUBLE_BUFFER, "dispatches", 0)
    chunked = _kernel_buckets(k, 8)
    assert kernel_ops.DOUBLE_BUFFER["dispatches"] == int(np.ceil(5000 / 512))
    np.testing.assert_array_equal(full, chunked)
    bounds = np.concatenate([[0], np.cumsum(np.bincount(chunked,
                                                        minlength=8))])
    return np.argsort(chunked, kind="stable"), bounds


@pytest.mark.kernels_interpret
def test_double_buffered_radix_partition_is_bit_identical(monkeypatch):
    twin(_double_buffered_radix_partition_is_bit_identical, monkeypatch)


# ---------------------------------------------------------------------------
# Fusion is invisible to the planner: explain + fingerprint parity
# ---------------------------------------------------------------------------

PLAN_SQLS = [
    "SELECT fn, fv FROM t WHERE fn > 50",
    "SELECT SUM(fv) AS s, COUNT(*) AS c FROM t WHERE fn < 30",
    "SELECT fs, SUM(fv) AS s FROM t GROUP BY fs",
    "SELECT fn, fv FROM t ORDER BY fv DESC LIMIT 7",
]


def _explain_and_fingerprint_identical_across_fusion_modes():
    optimize = P.m("core.plan").optimize
    plan_fingerprint = P.m("server.result_cache").plan_fingerprint
    sessions = {mode: _star_session(stage_fusion=mode)[0]
                for mode in ("on", "off", "force")}
    try:
        for sql in PLAN_SQLS:
            plans = {m: s.explain(sql) for m, s in sessions.items()}
            assert plans["on"] == plans["off"] == plans["force"], sql
            fps = {m: plan_fingerprint(
                       optimize(s.plan(sql), s.catalog), s.catalog)[0]
                   for m, s in sessions.items()}
            assert fps["on"] == fps["off"] == fps["force"], sql
            # and the plans actually execute identically
            got = {m: s.sql_np(sql) for m, s in sessions.items()}
            for k in got["off"]:
                np.testing.assert_array_equal(got["on"][k], got["off"][k])
                np.testing.assert_array_equal(got["force"][k],
                                              got["off"][k])
        assert sessions["off"].metrics().fused_partitions() == 0
        assert sessions["force"].metrics().fused_partitions() > 0
    finally:
        for s in sessions.values():
            s.shutdown()
    return observed(locals())


def test_explain_and_fingerprint_identical_across_fusion_modes():
    twin(_explain_and_fingerprint_identical_across_fusion_modes)


