"""Replicated SharkServer fleet (DESIGN.md §13.2), the port of
`repro.cluster.fleet` over the port's SharkServer.

N full SharkServer replicas — each with its own workers, block store,
memory budget, and result cache — behind a routing frontend:

    fleet = SharkFleet(num_replicas=4, routing="least_loaded", ...)
    fleet.create_table("rankings", schema, data)     # fanned to every replica
    h = fleet.submit("SELECT ...")                   # routed, async
    fleet.kill_replica(2)                            # chaos: h re-routes

Routing is round-robin or least-loaded (the replica scheduler's queued +
in-flight query count).  Base tables and DDL fan out to every replica under
one DDL lock, and the fleet runs ONE catalog-epoch protocol across them:
after a DDL lands everywhere, every replica's catalog version for the table
is forced to the fleet-wide maximum (`Catalog.adopt_version`), firing each
replica's invalidation listeners.  Plan fingerprints hash the optimized
plan text plus the versions of the tables it reads, so with aligned
versions the SAME query has the SAME fingerprint on every replica — a
result cached on one replica can never be served stale on another, and a
DDL invalidates the entry fleet-wide in one epoch bump.

Replica loss: `kill_replica(i)` marks the replica dead.  A `FleetHandle`
whose query is in flight there re-submits on a survivor, which recomputes
from its own replicated lineage — results are identical to the failure-free
run because every replica holds the same deterministic base tables.  The
dead replica's in-progress work still drains in the background (its
scheduler threads finish and release their shuffle blocks), so nothing
leaks from the shared store of a replica that died mid-query.

Each replica computes on the device its `server_kw` name (`device=`; the
GPU unless the caller asks for the CPU), and with `mesh_factory` over its
own MeshContext.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np

from ..core.plan import Node
from ..core.resilience import CircuitBreaker, ResiliencePolicy
from ..core.sql import CreateStmt, parse
from ..core.types import Schema
from ..server.server import SharkServer


class ReplicaLost(RuntimeError):
    """No alive replica can serve the query."""


class FleetEpochError(RuntimeError):
    """Replica catalog versions diverged after a DDL fan-out."""


class _Replica:
    __slots__ = ("index", "server", "alive", "served")

    def __init__(self, index: int, server: SharkServer):
        self.index = index
        self.server = server
        self.alive = True
        self.served = 0


class FleetHandle:
    """Async handle that survives replica loss: `result()` re-routes to a
    survivor if the replica serving the query dies before finishing.  Poll
    cadence and reroute budget come from the fleet's ResiliencePolicy; a
    retryable infrastructure error from an ALIVE replica also reroutes
    (scoring its circuit breaker), while deterministic application errors
    surface immediately — rerouting them would just fail N times."""

    def __init__(self, fleet: "SharkFleet", query, client: str):
        self._fleet = fleet
        self._query = query
        self._client = client
        self.reroutes = 0
        self._replica, self._inner = fleet._submit_on(None, query, client)

    @property
    def replica_index(self) -> int:
        return self._replica.index

    def done(self) -> bool:
        return self._inner.done()

    def result(self, timeout: Optional[float] = None):
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        policy = self._fleet.policy
        while True:
            try:
                out = self._inner.result(timeout=policy.fleet_poll_s)
            except TimeoutError:
                # chaos seam "fleet.poll": the serving replica dies
                # mid-query (only while a survivor exists to reroute to)
                chaos = self._fleet.chaos
                if (chaos is not None and self._replica.alive
                        and not self._inner.done()
                        and len(self._fleet.alive_replicas()) > 1):
                    if chaos.fire("fleet.poll") is not None:
                        self._fleet.kill_replica(self._replica.index)
                if not self._replica.alive and not self._inner.done():
                    self._reroute()     # died mid-query: recompute elsewhere
                    continue
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError("fleet query timed out")
            except Exception as exc:
                if not self._replica.alive:
                    # the dying replica surfaced an error — its failure must
                    # not become the fleet's answer
                    self._reroute()
                    continue
                self._fleet._record_failure(self._replica)
                if (policy.is_retryable(exc)
                        and self.reroutes < policy.fleet_reroute_limit):
                    self._reroute()
                    continue
                raise
            else:
                self._fleet._record_success(self._replica)
                return out

    def _reroute(self) -> None:
        self.reroutes += 1
        with self._fleet._lock:
            self._fleet.reroutes += 1
        self._replica, self._inner = self._fleet._submit_on(
            self._replica, self._query, self._client)


class SharkFleet:
    def __init__(self, num_replicas: int = 2, routing: str = "round_robin",
                 mesh_factory=None, resilience: Optional[ResiliencePolicy] = None,
                 **server_kw):
        """`mesh_factory`: optional callable `index -> MeshContext | None`
        giving each replica its OWN device mesh (DESIGN.md §13.3) — the
        composed cluster tier: a fleet of replicated servers, each of which
        shards its map stages across an intra-replica mesh.  A plain
        `mesh=` in `server_kw` would share one mesh object (and its
        health/retry state) across replicas; the factory keeps replica
        failure domains independent.

        `resilience`: ResiliencePolicy shared by the routing layer (poll
        cadence, reroute budget, circuit breakers) and every replica
        server's scheduler/storage."""
        assert routing in ("round_robin", "least_loaded"), routing
        self.routing = routing
        self.policy = resilience if resilience is not None else ResiliencePolicy()
        if resilience is not None:
            server_kw.setdefault("resilience", resilience)
        if mesh_factory is not None:
            assert "mesh" not in server_kw, "pass mesh_factory OR mesh"
            self.replicas = [
                _Replica(i, SharkServer(mesh=mesh_factory(i), **server_kw))
                for i in range(num_replicas)]
        else:
            self.replicas = [_Replica(i, SharkServer(**server_kw))
                             for i in range(num_replicas)]
        # one circuit breaker per replica: repeated failures open it and
        # routing skips the replica until its reset window elapses
        self.breakers = {r.index: CircuitBreaker(self.policy)
                         for r in self.replicas}
        self.chaos = None   # core.faults.ChaosEngine, when installed
        self._lock = threading.Lock()
        self._ddl_lock = threading.Lock()
        self._rr = 0
        self.reroutes = 0

    # -- routing --------------------------------------------------------------

    def alive_replicas(self) -> List[_Replica]:
        return [r for r in self.replicas if r.alive]

    def _pick(self, exclude: Optional[_Replica]) -> _Replica:
        cands = [r for r in self.replicas if r.alive and r is not exclude]
        if not cands:
            cands = self.alive_replicas()
        if not cands:
            raise ReplicaLost("every replica is dead")
        # health-probe routing: skip replicas whose breaker is OPEN; if every
        # candidate's breaker is open, route anyway (degraded beats dead)
        now = time.monotonic()
        routable = [r for r in cands if self.breakers[r.index].routable(now)]
        if routable:
            cands = routable
        if self.routing == "least_loaded":
            with self._lock:
                r = min(cands,
                        key=lambda c: (c.server.scheduler.load(), c.index))
        else:
            with self._lock:
                r = cands[self._rr % len(cands)]
                self._rr += 1
        self.breakers[r.index].on_route(now)    # consume half-open probe slot
        return r

    def _submit_on(self, exclude: Optional[_Replica], query, client: str):
        r = self._pick(exclude)
        # chaos seam "fleet.submit": the picked replica dies between routing
        # and submission (only while a survivor exists) — re-pick excluding it
        chaos = self.chaos
        if chaos is not None and len(self.alive_replicas()) > 1:
            trip = chaos.fire("fleet.submit")
            if trip is not None:
                try:
                    self.kill_replica(r.index)
                except RuntimeError:
                    pass        # raced down to one replica
                else:
                    self._record_failure(r)
                    r = self._pick(r)
        # plan objects are mutated by optimize(); each replica gets its own
        q = copy.deepcopy(query) if isinstance(query, Node) else query
        handle = r.server.submit(q, client=client)
        with self._lock:
            r.served += 1
        return r, handle

    # -- replica health ------------------------------------------------------

    def _record_failure(self, replica: _Replica) -> None:
        self.breakers[replica.index].record_failure(time.monotonic())

    def _record_success(self, replica: _Replica) -> None:
        self.breakers[replica.index].record_success()

    # -- queries --------------------------------------------------------------

    def submit(self, query: Union[str, Node], client: str = "default"
               ) -> FleetHandle:
        return FleetHandle(self, query, client)

    def sql(self, sql: str, client: str = "default"):
        stmt = parse(sql)
        if isinstance(stmt, CreateStmt):
            return self._ddl(sql, stmt, client)
        return self.submit(sql, client=client).result()

    def sql_np(self, sql: str, client: str = "default"):
        return self.sql(sql, client=client).to_numpy()

    # -- warehouse / epoch protocol -------------------------------------------

    def create_table(self, name: str, schema: Schema,
                     data: Dict[str, np.ndarray],
                     num_partitions: Optional[int] = None,
                     distribute_by: Optional[str] = None) -> None:
        """Load the same base table into every alive replica and align
        catalog epochs — the replicas must be indistinguishable sources of
        truth for the routing layer."""
        with self._ddl_lock:
            for r in self.alive_replicas():
                r.server.create_table(name, schema, data,
                                      num_partitions=num_partitions,
                                      distribute_by=distribute_by)
            self._align_epochs(name)

    def _ddl(self, sql: str, stmt: CreateStmt, client: str):
        """CTAS fan-out: every replica executes the (deterministic) DDL so
        their derived tables are identical, then epochs align fleet-wide."""
        with self._ddl_lock:
            results = [r.server.sql(sql, client=client)
                       for r in self.alive_replicas()]
            self._align_epochs(stmt.name)
            return results[0]

    def _align_epochs(self, name: str) -> None:
        """One epoch protocol across replicas: force every alive replica's
        version of `name` to the fleet-wide maximum.  `adopt_version` fires
        the replica's catalog listeners, so result-cache entries reading
        the table invalidate everywhere in the same logical epoch."""
        alive = self.alive_replicas()
        target = max(r.server.catalog.version(name) for r in alive)
        for r in alive:
            if r.server.catalog.version(name) != target:
                r.server.catalog.adopt_version(name, target)
        versions = {r.server.catalog.version(name) for r in alive}
        if len(versions) != 1:
            raise FleetEpochError(
                f"replica versions diverged for {name!r}: {versions}")

    def epochs(self, name: str) -> List[int]:
        return [r.server.catalog.version(name) for r in self.alive_replicas()]

    # -- chaos / lifecycle ----------------------------------------------------

    def kill_replica(self, index: int) -> None:
        """Chaos: the replica stops receiving queries; in-flight FleetHandles
        bound to it re-route to survivors.  Its scheduler threads drain in
        the background, releasing per-query shuffle blocks as usual."""
        r = self.replicas[index]
        if not r.alive:
            return
        if len(self.alive_replicas()) == 1:
            raise RuntimeError("cannot kill the last replica")
        r.alive = False

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "replicas": len(self.replicas),
                "alive": len(self.alive_replicas()),
                "reroutes": self.reroutes,
                "served": {r.index: r.served for r in self.replicas},
                "load": {r.index: r.server.scheduler.load()
                         for r in self.alive_replicas()},
                "breakers": {i: b.stats() for i, b in self.breakers.items()},
            }

    def describe_resilience(self) -> str:
        lines = [f"fleet: {len(self.alive_replicas())}/{len(self.replicas)} "
                 f"alive, reroutes={self.reroutes}"]
        for i, b in sorted(self.breakers.items()):
            s = b.stats()
            if s["opens"] or s["state"] != "closed":
                lines.append(f"  replica {i}: breaker {s['state']} "
                             f"(opens={s['opens']} closes={s['closes']})")
        return "\n".join(lines)

    def shutdown(self) -> None:
        for r in self.replicas:
            r.server.shutdown()
