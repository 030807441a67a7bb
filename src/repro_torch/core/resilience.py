"""Resilience policy layer (DESIGN.md §16).

One `ResiliencePolicy` object owns every failure-handling decision the
engine used to scatter across hardcoded constants: how errors are
classified (retryable infrastructure fault vs deterministic application
error), how retries back off, when a hung task is reaped and relaunched,
when a flaky worker is quarantined from scheduling, and when a fleet
replica's circuit breaker stops routing to it.  The policy is *consumed*
by `Scheduler._run_tasks`, `BlockManager.wait_shuffle`, `StorageManager`,
`MeshContext`, and `SharkFleet`; it makes no decisions at a distance — each
layer asks the policy and acts locally, so the decision points stay
greppable.

Error classification (the satellite bugfix this layer exists for): the
seed scheduler retried *any* task exception up to the attempt cap, so a
deterministic application error — a bad expression on one partition —
surfaced late, with a retry-mangled traceback, after burning every worker.
`is_retryable` draws the line: infrastructure faults (`WorkerLost`,
`FetchFailed`, `DeviceLost`, `SpillCorrupt`, `ShuffleWaitTimeout`,
`ReplicaLost`) retry with deterministic exponential backoff; anything else
is presumed deterministic and fails fast with the ORIGINAL traceback after
at most `app_error_probes` cross-worker probes (the probe distinguishes
"this partition's data is poison" from "that worker's environment is
poison" — a deterministic task failing identically elsewhere is an
application bug).

The hung-task reaper covers the case speculation structurally cannot:
speculative backups need completed-task durations to estimate a straggler
threshold, so a stage whose *every* task hangs (e.g. a worker wedged on a
lock) deadlocked the seed scheduler forever.  With `task_deadline_s` set,
a task running past the deadline is abandoned (its future is dropped, so a
late result is never observed; late shuffle writes are discarded by the
BlockManager's exactly-once released-shuffle guard) and relaunched on
another worker — even when zero tasks have completed.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Set


class ShuffleWaitTimeout(TimeoutError):
    """`BlockManager.wait_shuffle` gave up: names the shuffle and the map
    splits still missing, so lineage/fleet layers can act on it (the seed
    raised a bare timeout naming nothing).  Subclasses TimeoutError for
    back-compat with callers that catch the old type."""

    def __init__(self, shuffle_id: int, missing_maps: List[int],
                 waited_s: float):
        super().__init__(
            f"shuffle {shuffle_id} wait timed out after {waited_s:.1f}s; "
            f"map splits still missing: {missing_maps}")
        self.shuffle_id = shuffle_id
        self.missing_maps = missing_maps
        self.waited_s = waited_s


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Every failure-handling knob in one frozen, printable object."""

    # task retry (Scheduler._run_tasks)
    max_task_attempts: int = 8          # per-split attempt cap
    max_stage_retries: int = 6          # FetchFailed -> lineage retry cap
    app_error_probes: int = 1           # cross-worker probes before fail-fast
    # deterministic exponential backoff between retryable failures
    backoff_base_s: float = 0.005
    backoff_factor: float = 2.0
    backoff_max_s: float = 0.25
    # hung-task reaper (None = off; speculation remains the straggler path)
    task_deadline_s: Optional[float] = None
    # flaky-worker quarantine
    quarantine_threshold: int = 3       # consecutive failures -> quarantine
    quarantine_probe_s: float = 0.5     # probation delay before re-admission
    # shuffle wait (BlockManager.wait_shuffle)
    shuffle_wait_timeout_s: float = 30.0
    # fleet (SharkFleet / FleetHandle)
    fleet_poll_s: float = 0.02
    fleet_reroute_limit: int = 4
    breaker_failure_threshold: int = 3
    breaker_reset_s: float = 0.25
    # mesh (MeshContext dispatch retry budget)
    mesh_max_retries: int = 3
    # storage (StorageManager.shutdown writer join)
    spill_join_timeout_s: float = 10.0

    def backoff(self, n_failures: int) -> float:
        """Delay before the n-th retry of one task (deterministic schedule):
        the first retry is immediate — the common single-kill chaos case
        must not pay latency — then base * factor^(n-2), capped."""
        if n_failures <= 1:
            return 0.0
        return min(self.backoff_base_s
                   * self.backoff_factor ** (n_failures - 2),
                   self.backoff_max_s)

    def is_retryable(self, exc: BaseException) -> bool:
        """Infrastructure faults retry; deterministic application errors do
        not.  Lazy imports keep this module dependency-free (runtime,
        storage, and the cluster tier all import *us*)."""
        if isinstance(exc, ShuffleWaitTimeout):
            return True
        if getattr(exc, "shark_retryable", False):
            return True  # escape hatch for user-defined infra errors
        from .runtime import FetchFailed, WorkerLost
        if isinstance(exc, (FetchFailed, WorkerLost)):
            return True
        from .storage import SpillCorrupt
        if isinstance(exc, SpillCorrupt):
            return True
        from ..cluster.fleet import ReplicaLost
        from ..cluster.mesh import DeviceLost
        return isinstance(exc, (DeviceLost, ReplicaLost))

    def describe(self) -> str:
        pairs = ", ".join(f"{f.name}={getattr(self, f.name)}"
                          for f in dataclasses.fields(self))
        return f"ResiliencePolicy({pairs})"


class WorkerHealth:
    """Per-worker health scores with quarantine + probed re-admission.

    A worker accumulating `quarantine_threshold` CONSECUTIVE failures is
    quarantined: `excluded()` reports it and `_pick_worker` skips it.  After
    `quarantine_probe_s` the worker enters *probation* — it becomes
    schedulable again, but a single probe task decides: success re-admits
    (score reset), failure re-quarantines with a fresh clock.  Any success
    anywhere resets the consecutive-failure count (the score is about
    flakiness NOW, not history)."""

    def __init__(self, policy: ResiliencePolicy):
        self.policy = policy
        self.lock = threading.Lock()
        self.failures: Dict[int, int] = {}      # consecutive failures
        self.quarantined: Dict[int, float] = {}  # worker -> quarantine time
        self.quarantines = 0
        self.readmissions = 0

    def record_failure(self, worker: int, now: Optional[float] = None
                       ) -> bool:
        """Returns True when this failure (newly) quarantines the worker."""
        now = time.monotonic() if now is None else now
        with self.lock:
            n = self.failures.get(worker, 0) + 1
            self.failures[worker] = n
            if worker in self.quarantined:
                # failed its probation probe: fresh quarantine clock
                self.quarantined[worker] = now
                self.quarantines += 1
                return True
            if n >= self.policy.quarantine_threshold:
                self.quarantined[worker] = now
                self.quarantines += 1
                return True
            return False

    def record_success(self, worker: int) -> None:
        with self.lock:
            self.failures[worker] = 0
            if self.quarantined.pop(worker, None) is not None:
                self.readmissions += 1

    def excluded(self, now: Optional[float] = None) -> Set[int]:
        """Workers the scheduler must not pick: quarantined AND not yet due
        for their probation probe."""
        now = time.monotonic() if now is None else now
        probe = self.policy.quarantine_probe_s
        with self.lock:
            return {w for w, t in self.quarantined.items()
                    if now - t < probe}

    def forget(self, worker: int) -> None:
        """The worker left the cluster (killed): drop its health state."""
        with self.lock:
            self.failures.pop(worker, None)
            self.quarantined.pop(worker, None)

    def stats(self) -> Dict[str, int]:
        with self.lock:
            return {"quarantines": self.quarantines,
                    "readmissions": self.readmissions,
                    "quarantined_now": len(self.quarantined)}


class CircuitBreaker:
    """Per-replica breaker for SharkFleet routing (CLOSED / OPEN /
    HALF_OPEN).  `breaker_failure_threshold` consecutive failures open it;
    after `breaker_reset_s` ONE probe query is admitted (half-open): its
    success re-closes the breaker, its failure re-opens with a fresh clock.
    `routable()` is side-effect-free (the routing filter); `on_route()`
    consumes the half-open probe slot."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, policy: ResiliencePolicy):
        self.policy = policy
        self.lock = threading.Lock()
        self.state = self.CLOSED
        self.failures = 0
        self.opened_at = 0.0
        self._probe_inflight = False
        self.opens = 0
        self.closes = 0

    def routable(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self.lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                return now - self.opened_at >= self.policy.breaker_reset_s
            return not self._probe_inflight      # HALF_OPEN

    def on_route(self, now: Optional[float] = None) -> None:
        """A query was just routed here: if the breaker was open-and-due,
        this query IS the half-open probe."""
        now = time.monotonic() if now is None else now
        with self.lock:
            if (self.state == self.OPEN
                    and now - self.opened_at >= self.policy.breaker_reset_s):
                self.state = self.HALF_OPEN
                self._probe_inflight = True
            elif self.state == self.HALF_OPEN:
                self._probe_inflight = True

    def record_success(self) -> None:
        with self.lock:
            if self.state != self.CLOSED:
                self.closes += 1
            self.state = self.CLOSED
            self.failures = 0
            self._probe_inflight = False

    def record_failure(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self.lock:
            self.failures += 1
            if self.state == self.HALF_OPEN:
                self.state = self.OPEN          # probe failed: re-open
                self.opened_at = now
                self.opens += 1
            elif (self.state == self.CLOSED
                    and self.failures >= self.policy.breaker_failure_threshold):
                self.state = self.OPEN
                self.opened_at = now
                self.opens += 1
            self._probe_inflight = False

    def stats(self) -> Dict[str, object]:
        with self.lock:
            return {"state": self.state, "failures": self.failures,
                    "opens": self.opens, "closes": self.closes}


def describe_counters(counters: Dict[str, int], health: WorkerHealth,
                      policy: ResiliencePolicy,
                      extra: Optional[Sequence[str]] = None) -> str:
    """Shared `describe_resilience()` rendering: policy line, counter line,
    health line, plus caller-specific extra lines (breakers, trips)."""
    lines = [policy.describe()]
    if counters:
        lines.append("events: " + ", ".join(
            f"{k}={v}" for k, v in sorted(counters.items())))
    else:
        lines.append("events: none")
    hs = health.stats()
    lines.append(f"workers: quarantines={hs['quarantines']} "
                 f"readmissions={hs['readmissions']} "
                 f"quarantined_now={hs['quarantined_now']}")
    if extra:
        lines.extend(extra)
    return "\n".join(lines)
