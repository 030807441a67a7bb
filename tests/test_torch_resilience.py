"""The resilience policy layer on the torch port against the JAX
reference: the twin of tests/test_resilience.py.

Each body runs on both packages (`torch_twin.twin`; the port's sessions
on `device="cpu"`), asserts what its reference test asserts, and its
answers, errors and plain-data locals (policies, health and breaker
statistics, fault logs) must equal the reference's; the cluster tier's
`DeviceLost` and `ReplicaLost` included (`test_cluster_errors_are_retryable`).
The reference's docstring follows.

Unit tests for the resilience policy layer (DESIGN.md §16).

Covers the policy primitives in isolation — backoff schedule, error
classification, worker quarantine/re-admission, the fleet circuit
breaker, FaultSchedule determinism + replay — and the scheduler-level
behaviors the tentpole introduced: fail-fast on deterministic
application errors (the poison-partition regression) and the hung-task
reaper (the stage the seed scheduler deadlocked on forever).
"""

import threading
import time

import numpy as np
import pytest

from torch_twin import P, observed, raises, twin


# -- policy primitives --------------------------------------------------------


class TestBackoff:
    def _first_retry_is_immediate(self):
        p = P.ResiliencePolicy()
        assert p.backoff(0) == 0.0
        assert p.backoff(1) == 0.0
        return [p.backoff(0), p.backoff(1)]

    def test_first_retry_is_immediate(self):
        twin(self._first_retry_is_immediate)

    def _deterministic_exponential_schedule(self):
        p = P.ResiliencePolicy(backoff_base_s=0.01, backoff_factor=2.0,
                             backoff_max_s=0.05)
        assert [p.backoff(n) for n in range(2, 7)] == \
            [0.01, 0.02, 0.04, 0.05, 0.05]
        # pure function: same input, same delay
        assert p.backoff(4) == p.backoff(4)
        return [p.backoff(n) for n in range(8)]

    def test_deterministic_exponential_schedule(self):
        twin(self._deterministic_exponential_schedule)


class TestClassification:
    def _infra_errors_are_retryable(self):
        p = P.ResiliencePolicy()
        assert p.is_retryable(P.m("core.runtime").WorkerLost("w0"))
        assert p.is_retryable(P.m("core.runtime").FetchFailed(3, [1, 2]))
        assert p.is_retryable(P.m("core.storage").SpillCorrupt("bad checksum"))
        assert p.is_retryable(P.ShuffleWaitTimeout(3, [0], 1.0))
        return [p.is_retryable(e) for e in (
            P.m("core.runtime").WorkerLost("w0"),
            P.m("core.runtime").FetchFailed(3, [1, 2]),
            P.m("core.storage").SpillCorrupt("bad checksum"),
            P.ShuffleWaitTimeout(3, [0], 1.0))]

    def test_infra_errors_are_retryable(self):
        twin(self._infra_errors_are_retryable)

    def _cluster_errors_are_retryable(self):
        ReplicaLost = P.m("cluster.fleet").ReplicaLost
        DeviceLost = P.m("cluster.mesh").DeviceLost
        p = P.ResiliencePolicy()
        assert p.is_retryable(DeviceLost(1))
        assert p.is_retryable(ReplicaLost("all dead"))
        return [p.is_retryable(DeviceLost(1)),
                p.is_retryable(ReplicaLost("all dead")), str(DeviceLost(1))]

    def test_cluster_errors_are_retryable(self):
        twin(self._cluster_errors_are_retryable)

    def _app_errors_are_not(self):
        p = P.ResiliencePolicy()
        assert not p.is_retryable(ValueError("bad expression"))
        assert not p.is_retryable(ZeroDivisionError())
        assert not p.is_retryable(KeyError("col"))
        return [p.is_retryable(e) for e in (
            ValueError("bad expression"), ZeroDivisionError(), KeyError("col"))]

    def test_app_errors_are_not(self):
        twin(self._app_errors_are_not)

    def _escape_hatch(self):
        exc = RuntimeError("transient external store hiccup")
        exc.shark_retryable = True
        assert P.ResiliencePolicy().is_retryable(exc)
        return P.ResiliencePolicy().is_retryable(exc)

    def test_escape_hatch(self):
        twin(self._escape_hatch)


class TestWorkerHealth:
    def _quarantine_after_consecutive_failures(self):
        h = P.m("core.resilience").WorkerHealth(P.ResiliencePolicy(quarantine_threshold=3))
        assert not h.record_failure(0, now=0.0)
        assert not h.record_failure(0, now=0.0)
        assert h.record_failure(0, now=0.0)
        assert h.excluded(now=0.1) == {0}
        assert h.stats()["quarantines"] == 1
        return observed(locals())

    def test_quarantine_after_consecutive_failures(self):
        twin(self._quarantine_after_consecutive_failures)

    def _success_resets_consecutive_count(self):
        h = P.m("core.resilience").WorkerHealth(P.ResiliencePolicy(quarantine_threshold=2))
        h.record_failure(0, now=0.0)
        h.record_success(0)
        assert not h.record_failure(0, now=0.0)   # count restarted
        assert h.excluded(now=0.0) == set()
        return observed(locals())

    def test_success_resets_consecutive_count(self):
        twin(self._success_resets_consecutive_count)

    def _probation_then_readmission(self):
        h = P.m("core.resilience").WorkerHealth(P.ResiliencePolicy(quarantine_threshold=1,
                                          quarantine_probe_s=0.5))
        h.record_failure(0, now=0.0)
        assert h.excluded(now=0.4) == {0}       # still serving quarantine
        assert h.excluded(now=0.6) == set()     # probation: schedulable
        h.record_success(0)                     # probe succeeded
        assert h.stats()["readmissions"] == 1
        assert h.excluded(now=0.6) == set()
        return observed(locals())

    def test_probation_then_readmission(self):
        twin(self._probation_then_readmission)

    def _failed_probe_requarantines_with_fresh_clock(self):
        h = P.m("core.resilience").WorkerHealth(P.ResiliencePolicy(quarantine_threshold=1,
                                          quarantine_probe_s=0.5))
        h.record_failure(0, now=0.0)
        assert h.excluded(now=0.6) == set()     # probe window open
        assert h.record_failure(0, now=0.6)     # probe failed
        assert h.excluded(now=1.0) == {0}       # clock restarted at 0.6
        assert h.excluded(now=1.2) == set()
        assert h.stats()["quarantines"] == 2
        return observed(locals())

    def test_failed_probe_requarantines_with_fresh_clock(self):
        twin(self._failed_probe_requarantines_with_fresh_clock)

    def _forget_drops_state(self):
        h = P.m("core.resilience").WorkerHealth(P.ResiliencePolicy(quarantine_threshold=1))
        h.record_failure(0, now=0.0)
        h.forget(0)
        assert h.excluded(now=0.0) == set()
        return observed(locals())

    def test_forget_drops_state(self):
        twin(self._forget_drops_state)


class TestCircuitBreaker:
    def _breaker(self):
        return P.m("core.resilience").CircuitBreaker(P.ResiliencePolicy(breaker_failure_threshold=2,
                                               breaker_reset_s=0.5))

    def _opens_after_threshold(self):
        b = self._breaker()
        b.record_failure(now=0.0)
        assert b.routable(now=0.0)
        b.record_failure(now=0.0)
        assert b.stats()["state"] == "open"
        assert not b.routable(now=0.1)
        return observed(locals())

    def test_opens_after_threshold(self):
        twin(self._opens_after_threshold)

    def _half_open_probe_and_close(self):
        b = self._breaker()
        b.record_failure(now=0.0)
        b.record_failure(now=0.0)
        assert b.routable(now=0.6)              # reset window elapsed
        b.on_route(now=0.6)                     # this query IS the probe
        assert b.stats()["state"] == "half_open"
        assert not b.routable(now=0.6)          # one probe at a time
        b.record_success()
        assert b.stats()["state"] == "closed"
        assert b.stats()["closes"] == 1
        return observed(locals())

    def test_half_open_probe_and_close(self):
        twin(self._half_open_probe_and_close)

    def _failed_probe_reopens(self):
        b = self._breaker()
        b.record_failure(now=0.0)
        b.record_failure(now=0.0)
        b.on_route(now=0.6)
        b.record_failure(now=0.6)
        assert b.stats()["state"] == "open"
        assert not b.routable(now=1.0)          # fresh clock from 0.6
        assert b.routable(now=1.2)
        assert b.stats()["opens"] == 2
        return observed(locals())

    def test_failed_probe_reopens(self):
        twin(self._failed_probe_reopens)


# -- fault schedule / chaos engine --------------------------------------------


class TestFaultSchedule:
    def _pump(self, engine, passes):
        """Drive a synthetic pass sequence through an engine."""
        for site in passes:
            engine.fire(site)

    def _seeded_determinism(self):
        specs = [P.FaultSpec("task.body", p=0.25),
                 P.FaultSpec("spill.read", kind="corrupt", p=0.5)]
        passes = ["task.body"] * 40 + ["spill.read"] * 20
        e1 = P.ChaosEngine(P.FaultSchedule(seed=42, specs=specs))
        e2 = P.ChaosEngine(P.FaultSchedule(seed=42, specs=specs))
        self._pump(e1, passes)
        self._pump(e2, passes)
        assert e1.trips == e2.trips
        assert e1.trips                          # the seed actually fires
        e3 = P.ChaosEngine(P.FaultSchedule(seed=43, specs=specs))
        self._pump(e3, passes)
        assert e3.trips != e1.trips              # seed matters
        return observed(locals())

    def test_seeded_determinism(self):
        twin(self._seeded_determinism)

    def _count_and_after(self):
        e = P.ChaosEngine(P.FaultSchedule(seed=0, specs=[
            P.FaultSpec("task.body", count=2, after=3)]))
        self._pump(e, ["task.body"] * 10)
        assert [t.ordinal for t in e.trips] == [3, 4]
        return observed(locals())

    def test_count_and_after(self):
        twin(self._count_and_after)

    def _replay_round_trip(self):
        specs = [P.FaultSpec("task.body", p=0.3),
                 P.FaultSpec("shuffle.fetch", p=0.4, count=2)]
        passes = (["task.body"] * 25 + ["shuffle.fetch"] * 10) * 2
        original = P.ChaosEngine(P.FaultSchedule(seed=7, specs=specs))
        self._pump(original, passes)
        assert original.trips
        replayed = P.ChaosEngine(P.FaultSchedule.replay(original.trips))
        self._pump(replayed, passes)
        assert replayed.trips == original.trips
        return observed(locals())

    def test_replay_round_trip(self):
        twin(self._replay_round_trip)

    def _stats(self):
        e = P.ChaosEngine(P.FaultSchedule(seed=0, specs=[
            P.FaultSpec("task.body", count=1)]))
        self._pump(e, ["task.body"] * 3 + ["spill.read"] * 2)
        s = e.stats()
        assert s["trips"] == 1
        assert s["by_site"] == {"task.body": 1}
        assert s["passes"] == {"task.body": 3, "spill.read": 2}
        return observed(locals())

    def test_stats(self):
        twin(self._stats)


# -- scheduler behaviors ------------------------------------------------------


def _ctx(**kw):
    kw.setdefault("num_workers", 4)
    kw.setdefault("speculation", False)
    return P.m("core.runtime").SharkContext(**kw)


class TestFailFast:
    def _poison_partition_fails_fast_with_original_error(self):
        """The satellite regression: a deterministic app error on one split
        must surface as the ORIGINAL exception after exactly one cross-
        worker probe — not burn the whole attempt budget (the seed retried
        any exception max_task_attempts times)."""
        ctx = _ctx(policy=P.ResiliencePolicy(app_error_probes=1,
                                           max_task_attempts=8))
        try:
            sched = ctx.scheduler
            calls = []

            def run_one(split, tc):
                if split == 2:
                    calls.append(tc.attempt)
                    raise ValueError("poison partition 2")
                return split

            with raises(ValueError, match="poison partition 2"):
                sched._run_tasks(0, range(4), run_one)
            # initial attempt + one probe, nothing more
            assert calls == [0, 1]
            assert sched.resilience_counters["app_probes"] == 1
            assert sched.resilience_counters["fast_fails"] == 1
            assert sched.resilience_counters["retries"] == 0
        finally:
            ctx.shutdown()
        return observed(locals())

    def test_poison_partition_fails_fast_with_original_error(self):
        twin(self._poison_partition_fails_fast_with_original_error)

    def _probe_runs_on_a_different_worker(self):
        ctx = _ctx(policy=P.ResiliencePolicy(app_error_probes=1))
        try:
            workers = []

            def run_one(split, tc):
                if split == 0:
                    workers.append(tc.worker_id)
                    raise KeyError("bad column")
                return split

            with raises(KeyError):
                ctx.scheduler._run_tasks(0, range(2), run_one)
            assert len(workers) == 2 and workers[0] != workers[1]
        finally:
            ctx.shutdown()
        return observed(locals())

    def test_probe_runs_on_a_different_worker(self):
        twin(self._probe_runs_on_a_different_worker)

    def _infra_errors_still_retry(self):
        ctx = _ctx(policy=P.ResiliencePolicy(max_task_attempts=8))
        try:
            failed = []

            def run_one(split, tc):
                if split == 1 and tc.attempt < 2:
                    failed.append(tc.attempt)
                    raise P.m("core.runtime").WorkerLost("transient")
                return split

            out = ctx.scheduler._run_tasks(0, range(3), run_one)
            assert out == {0: 0, 1: 1, 2: 2}
            assert failed == [0, 1]
            assert ctx.scheduler.resilience_counters["retries"] == 2
            assert ctx.scheduler.resilience_counters["fast_fails"] == 0
        finally:
            ctx.shutdown()
        return observed(locals())

    def test_infra_errors_still_retry(self):
        twin(self._infra_errors_still_retry)


class TestHungTaskReaper:
    def _stage_where_every_task_hangs_completes(self):
        """The seed scheduler deadlocked here: speculation needs completed
        durations, so a stage whose EVERY first attempt hangs never made
        progress.  The reaper abandons attempts past the deadline and
        relaunches — the stage completes and the hung attempts' late
        results are never observed."""
        release = threading.Event()
        ctx = _ctx(policy=P.ResiliencePolicy(task_deadline_s=0.15))
        try:
            def run_one(split, tc):
                if tc.attempt == 0:
                    release.wait(10.0)      # first wave wedges
                    return ("late", split)
                return ("good", split)

            out = ctx.scheduler._run_tasks(0, range(3), run_one)
            assert out == {s: ("good", s) for s in range(3)}
            assert ctx.scheduler.resilience_counters["reaps"] >= 3
        finally:
            release.set()
            ctx.shutdown()
        return observed(locals())

    def test_stage_where_every_task_hangs_completes(self):
        twin(self._stage_where_every_task_hangs_completes)

    def _deadline_off_by_default(self):
        assert P.ResiliencePolicy().task_deadline_s is None
        return P.ResiliencePolicy().task_deadline_s is None

    def test_deadline_off_by_default(self):
        twin(self._deadline_off_by_default)

    def _reaper_gives_up_after_attempt_cap(self):
        ctx = _ctx(policy=P.ResiliencePolicy(task_deadline_s=0.05,
                                           max_task_attempts=2,
                                           backoff_base_s=0.0))
        release = threading.Event()
        try:
            def run_one(split, tc):
                release.wait(10.0)          # every attempt hangs
                return split

            with raises(RuntimeError, match="deadline"):
                ctx.scheduler._run_tasks(0, [0], run_one)
        finally:
            release.set()
            ctx.shutdown()
        return observed(locals())

    def test_reaper_gives_up_after_attempt_cap(self):
        twin(self._reaper_gives_up_after_attempt_cap)


class TestQuarantineScheduling:
    def _pick_worker_skips_quarantined(self):
        ctx = _ctx(policy=P.ResiliencePolicy(quarantine_threshold=1,
                                           quarantine_probe_s=30.0))
        try:
            sched = ctx.scheduler
            sched.health.record_failure(0)
            picks = {sched._pick_worker() for _ in range(16)}
            assert 0 not in picks and picks  # others still picked
        finally:
            ctx.shutdown()
        return 0 in picks

    def test_pick_worker_skips_quarantined(self):
        twin(self._pick_worker_skips_quarantined)

    def _all_quarantined_falls_back_to_full_pool(self):
        ctx = _ctx(num_workers=2,
                   policy=P.ResiliencePolicy(quarantine_threshold=1,
                                           quarantine_probe_s=30.0))
        try:
            sched = ctx.scheduler
            for w in (0, 1):
                sched.health.record_failure(w)
            assert sched._pick_worker() in (0, 1)   # degraded beats dead
        finally:
            ctx.shutdown()
        return observed(locals())

    def test_all_quarantined_falls_back_to_full_pool(self):
        twin(self._all_quarantined_falls_back_to_full_pool)

    def _flaky_worker_quarantined_then_readmitted_end_to_end(self):
        """Worker 0 fails its first task (threshold=1 keeps the quarantine
        independent of how concurrent successes interleave with the
        consecutive-failure count), then behaves; after the probation
        window a probe task re-admits it."""
        policy = P.ResiliencePolicy(quarantine_threshold=1,
                                  quarantine_probe_s=0.1)
        ctx = _ctx(policy=policy)
        try:
            sched = ctx.scheduler
            flaky_failures = []

            def run_one(split, tc):
                if tc.worker_id == 0 and len(flaky_failures) < 1:
                    flaky_failures.append(split)
                    raise P.m("core.runtime").WorkerLost("flaky NIC")
                return split

            # enough work that worker 0 sees a task
            out = sched._run_tasks(0, range(12), run_one)
            assert out == {s: s for s in range(12)}
            assert sched.health.stats()["quarantines"] >= 1
            time.sleep(0.15)                    # probation due
            out = sched._run_tasks(1, range(12), run_one)
            assert out == {s: s for s in range(12)}
            assert sched.health.stats()["readmissions"] >= 1
            assert sched.health.excluded() == set()
        finally:
            ctx.shutdown()
        return observed(locals())

    def test_flaky_worker_quarantined_then_readmitted_end_to_end(self):
        twin(self._flaky_worker_quarantined_then_readmitted_end_to_end)


class TestShuffleWaitTimeout:
    def _typed_timeout_names_shuffle_and_missing_maps(self):
        """Satellite: wait_shuffle used to return False after a hardcoded
        30s, which callers turned into an anonymous error.  Now it raises
        ShuffleWaitTimeout carrying the shuffle id and the missing splits."""
        ctx = _ctx(policy=P.ResiliencePolicy(shuffle_wait_timeout_s=0.05))
        try:
            with raises(P.ShuffleWaitTimeout) as ei:
                ctx.block_manager.wait_shuffle(99, maps=range(3),
                                               buckets=range(2))
            exc = ei.value
            assert exc.shuffle_id == 99
            assert exc.missing_maps == [0, 1, 2]
            assert isinstance(exc, TimeoutError)    # back-compat
            assert "99" in str(exc)
            assert P.ResiliencePolicy().is_retryable(exc)
        finally:
            ctx.shutdown()
        return observed(locals())

    def test_typed_timeout_names_shuffle_and_missing_maps(self):
        twin(self._typed_timeout_names_shuffle_and_missing_maps)

    def _cancel_still_returns_false(self):
        ctx = _ctx()
        try:
            cancel = threading.Event()
            cancel.set()
            waited = ctx.block_manager.wait_shuffle(
                99, maps=range(1), buckets=range(1), timeout=5.0,
                cancel=cancel)
            assert waited is False
        finally:
            ctx.shutdown()
        return waited

    def test_cancel_still_returns_false(self):
        twin(self._cancel_still_returns_false)


class TestDescribe:
    def _policy_and_scheduler_describe(self):
        ctx = _ctx()
        try:
            text = ctx.scheduler.describe_resilience()
            assert "ResiliencePolicy(" in text
            assert "events:" in text
            s = ctx.scheduler.resilience_stats()
            assert set(s) >= {"retries", "backoffs", "app_probes",
                              "fast_fails", "reaps", "quarantines",
                              "readmissions", "quarantined_now"}
        finally:
            ctx.shutdown()
        return observed(locals())

    def test_policy_and_scheduler_describe(self):
        twin(self._policy_and_scheduler_describe)

