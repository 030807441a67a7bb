"""Weighted fair-share query scheduler with admission control (DESIGN.md §6.2),
the port of `repro.server.scheduler`.

Many client sessions share one warehouse; a scan-heavy tenant must not
starve interactive ones.  Classic weighted fair queuing over *measured
execution time*: each client carries a virtual time

    vtime += elapsed_seconds / weight

and the dispatcher always runs the backlogged client with the smallest
vtime.  A weight-2 client therefore receives twice the execution share of a
weight-1 client under contention, and an idle client re-entering the system
is reset to the current virtual floor so it cannot monopolize the pool with
banked credit.

Admission control bounds the in-flight work: at most `max_concurrent`
queries execute at once (the worker pool size) and at most
`max_queue_depth` queries may wait.  A submit over the limit either blocks
(backpressure) until space frees or a timeout expires, or fails fast with
`AdmissionError` when `block=False`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple


class AdmissionError(RuntimeError):
    """Queue full: the server refused the query (backpressure)."""


class QueryHandle:
    """Async handle for a submitted query (a tiny Future with timings).

    A query is either SQL text (`sql`) or a bound logical plan (`plan`,
    a `core.plan.Node` — what `SharkFrame.collect()` submits).  Exactly one
    of the two is set; both run through the same admission control, fair
    scheduling, and plan-fingerprint result cache."""

    QUEUED, RUNNING, DONE, FAILED = "queued", "running", "done", "failed"

    def __init__(self, sql: Optional[str], client: str, plan=None):
        assert (sql is None) != (plan is None), \
            "QueryHandle takes SQL text or a logical plan, not both"
        self.sql = sql
        self.plan = plan
        self.client = client
        self.status = self.QUEUED
        self.cached = False          # served from the result cache
        self.submitted = time.monotonic()
        self.started: Optional[float] = None
        self.finished: Optional[float] = None
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    @property
    def describe(self) -> str:
        return self.sql if self.sql is not None else f"<plan {self.plan!r}>"

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"query not finished: {self.describe!r}")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def wait_s(self) -> float:
        return (self.started or self.submitted) - self.submitted

    @property
    def run_s(self) -> float:
        if self.started is None or self.finished is None:
            return 0.0
        return self.finished - self.started

    @property
    def latency_s(self) -> float:
        end = self.finished if self.finished is not None else time.monotonic()
        return end - self.submitted


class _ClientState:
    __slots__ = ("name", "weight", "vtime", "queue", "served", "service_s")

    def __init__(self, name: str, weight: float):
        self.name = name
        self.weight = max(weight, 1e-6)
        self.vtime = 0.0
        self.queue: deque = deque()
        self.served = 0
        self.service_s = 0.0


class FairScheduler:
    def __init__(self, run_fn: Callable[[QueryHandle], Tuple[object, bool]],
                 max_concurrent: int = 4, max_queue_depth: int = 32):
        self._run_fn = run_fn
        self.max_concurrent = max_concurrent
        self.max_queue_depth = max_queue_depth
        self._cv = threading.Condition()
        self._clients: Dict[str, _ClientState] = {}
        self._queued = 0
        self._inflight = 0
        self._vfloor = 0.0
        self._shutdown = False
        self.rejected = 0
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"shark-query-{i}")
            for i in range(max_concurrent)]
        for t in self._workers:
            t.start()

    # -- clients ---------------------------------------------------------------

    def register_client(self, name: str, weight: float = 1.0) -> None:
        with self._cv:
            state = self._clients.get(name)
            if state is None:
                self._clients[name] = _ClientState(name, weight)
            else:
                state.weight = max(weight, 1e-6)

    # -- submission ------------------------------------------------------------

    def submit(self, handle: QueryHandle, block: bool = True,
               timeout: Optional[float] = None) -> QueryHandle:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            if self._shutdown:
                raise RuntimeError("scheduler is shut down")
            while self._queued >= self.max_queue_depth:
                if not block:
                    self.rejected += 1
                    raise AdmissionError(
                        f"queue full ({self._queued}/{self.max_queue_depth})")
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    self.rejected += 1
                    raise AdmissionError("timed out waiting for queue space")
                self._cv.wait(remaining)
                if self._shutdown:
                    raise RuntimeError("scheduler is shut down")
            client = self._clients.get(handle.client)
            if client is None:
                client = _ClientState(handle.client, 1.0)
                self._clients[handle.client] = client
            if not client.queue:
                # idle client waking up: no banked credit from idle time
                client.vtime = max(client.vtime, self._vfloor)
            client.queue.append(handle)
            self._queued += 1
            self._cv.notify_all()
        return handle

    # -- dispatch --------------------------------------------------------------

    def _pick(self) -> Optional[Tuple[_ClientState, QueryHandle]]:
        # caller holds self._cv
        best = None
        for c in self._clients.values():
            if c.queue and (best is None or c.vtime < best.vtime):
                best = c
        if best is None:
            return None
        return best, best.queue.popleft()

    def _worker(self) -> None:
        while True:
            with self._cv:
                picked = self._pick()
                while picked is None and not self._shutdown:
                    self._cv.wait(0.5)
                    picked = self._pick()
                if picked is None:  # shutdown with empty queues
                    return
                client, handle = picked
                self._queued -= 1
                self._inflight += 1
                self._vfloor = max(self._vfloor, client.vtime)
                self._cv.notify_all()  # queue space freed: wake submitters
            handle.started = time.monotonic()
            handle.status = QueryHandle.RUNNING
            try:
                result, cached = self._run_fn(handle)
                handle._result = result
                handle.cached = cached
                handle.status = QueryHandle.DONE
            except BaseException as e:  # surfaces via handle.result()
                handle._error = e
                handle.status = QueryHandle.FAILED
            handle.finished = time.monotonic()
            elapsed = handle.finished - handle.started
            with self._cv:
                client.vtime += elapsed / client.weight
                client.served += 1
                client.service_s += elapsed
                self._inflight -= 1
            handle._event.set()

    # -- lifecycle / reporting -------------------------------------------------

    def load(self) -> int:
        """Queued + in-flight query count — the routing signal the fleet's
        least-loaded frontend uses (cluster/fleet.py)."""
        with self._cv:
            return self._queued + self._inflight

    def stats(self) -> Dict[str, object]:
        with self._cv:
            return {
                "queued": self._queued,
                "inflight": self._inflight,
                "rejected": self.rejected,
                "clients": {
                    name: {"weight": c.weight, "served": c.served,
                           "service_s": round(c.service_s, 6),
                           "vtime": round(c.vtime, 6),
                           "backlog": len(c.queue)}
                    for name, c in self._clients.items()},
            }

    def shutdown(self, wait: bool = True) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        if wait:
            for t in self._workers:
                t.join(timeout=5.0)
