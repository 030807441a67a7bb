"""Unified fault-injection engine (DESIGN.md §16) — chaos as a subsystem.

The repo grew five independent failure surfaces (worker death, shuffle
loss, spill corruption, mesh device loss, fleet replica loss), each poked
by hand-rolled monkeypatching in its own chaos test.  This module makes
injection a first-class, *deterministic* engine:

  * `FaultSpec` — one arming rule for one site: kind, probability, fire
    count cap, and an after-N warmup (skip the first N passes);
  * `FaultSchedule` — a seeded set of specs whose probabilistic decisions
    derive from sha256 over `(seed, site, ordinal)`: the same seed against
    the same pass sequence trips identically, on any host;
  * `ChaosEngine` — per-site ordinal counters + the trip log.  Each
    instrumented seam calls `engine.fire(site)` once per pass; a non-None
    `FaultTrip` back means "inject here, this kind, now".  Installable on a
    `SharkContext`, `SharkSession`, `SharkServer`, or `SharkFleet` via
    `install()` (duck-typed walk of the layers each owns).

Fault sites (the seams today's chaos tests poked by hand):

    task.body       scheduler task body start  -> worker death
    shuffle.fetch   BlockManager.fetch_shuffle -> map-output loss
    spill.read      StorageManager fault_in / fault_shuffle -> lost/corrupt
    spill.write     StorageManager evict / spill_shuffle -> write lost
    mesh.dispatch   MeshContext.fire_dispatch  -> DeviceLost
    fleet.submit    SharkFleet._submit_on      -> replica death at submit
    fleet.poll      FleetHandle.result poll    -> replica death mid-query
    memory.enforce  MemoryManager.enforce      -> simulated memory pressure

Every trip is logged as `(site, ordinal, kind)`; `ExecMetrics.fault_trips`
carries the per-query delta.  `FaultSchedule.replay(trips)` rebuilds an
exact schedule from a trip log — rerun the same workload under the replay
schedule and the same passes trip the same faults, the exact-repro
debugging loop.

Injection is NEVER allowed to be a correctness event: each seam only fires
when the layer can recover (a kill keeps >=1 survivor; spill loss requires
lineage), so a chaos run must produce byte-identical results to the
fault-free run — which is precisely what tests/test_chaos_storm.py asserts.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple


class FaultTrip(NamedTuple):
    site: str
    ordinal: int
    kind: str


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One arming rule.  `p` is the per-pass fire probability (1.0 =
    always), `count` caps total fires (None = unlimited), `after` skips the
    first N passes of the site (warmup — e.g. 'kill a worker on the 3rd
    task, not the 1st')."""
    site: str
    kind: str = "fault"
    p: float = 1.0
    count: Optional[int] = None
    after: int = 0


class FaultSchedule:
    """Deterministic PRNG over (site, ordinal): seeded mode draws a uniform
    from sha256(f"{seed}:{site}:{ordinal}:{spec_idx}") per spec, so a
    schedule is a pure function of (seed, specs) — no RNG state, no
    host-order dependence.  Exact mode (`replay`) fires precisely the
    (site, ordinal) -> kind pairs of a previous run's trip log."""

    def __init__(self, seed: int = 0,
                 specs: Sequence[FaultSpec] = (),
                 exact: Optional[Dict[Tuple[str, int], str]] = None):
        self.seed = int(seed)
        self.specs = tuple(specs)
        self.exact = dict(exact) if exact is not None else None

    @classmethod
    def replay(cls, trips: Sequence[Tuple[str, int, str]]) -> "FaultSchedule":
        """Rebuild an exact schedule from a trip log (`ChaosEngine.trips`
        or `ExecMetrics.fault_trips`): the round-trip contract is that
        pumping the same pass sequence through an engine under the replayed
        schedule yields an identical trip log."""
        return cls(exact={(t[0], t[1]): t[2] for t in trips})

    def _uniform(self, site: str, ordinal: int, idx: int) -> float:
        h = hashlib.sha256(
            f"{self.seed}:{site}:{ordinal}:{idx}".encode()).digest()
        return int.from_bytes(h[:8], "big") / float(1 << 64)

    def fault_at(self, site: str, ordinal: int,
                 fired: Dict[int, int]) -> Optional[Tuple[Optional[int], str]]:
        """Decide one pass: returns (spec_index, kind) to fire, else None.
        `fired` maps spec index -> fires so far (the engine owns it; exact
        mode returns index None — replay needs no count bookkeeping)."""
        if self.exact is not None:
            kind = self.exact.get((site, ordinal))
            return (None, kind) if kind is not None else None
        for idx, spec in enumerate(self.specs):
            if spec.site != site or ordinal < spec.after:
                continue
            if spec.count is not None and fired.get(idx, 0) >= spec.count:
                continue
            if spec.p >= 1.0 or self._uniform(site, ordinal, idx) < spec.p:
                return idx, spec.kind
        return None


class ChaosEngine:
    """Per-site pass counters + trip log around one FaultSchedule.

    Thread-safe: seams fire from scheduler pool threads, reduce threads,
    and fleet pollers concurrently.  Ordinals count *passes* (every fire()
    call advances the site's ordinal whether or not a fault trips), so a
    spec's `after`/`p` are expressed in the site's own event time."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self.lock = threading.Lock()
        self._ordinals: Dict[str, int] = {}
        self._fired: Dict[int, int] = {}
        self.trips: List[FaultTrip] = []
        self._installed: List[object] = []

    # -- the seam API ---------------------------------------------------------

    def fire(self, site: str) -> Optional[FaultTrip]:
        """One pass of `site`: advance its ordinal, consult the schedule,
        log and return the trip when a fault arms (else None)."""
        with self.lock:
            ordinal = self._ordinals.get(site, 0)
            self._ordinals[site] = ordinal + 1
            hit = self.schedule.fault_at(site, ordinal, self._fired)
            if hit is None:
                return None
            idx, kind = hit
            if idx is not None:
                self._fired[idx] = self._fired.get(idx, 0) + 1
            trip = FaultTrip(site, ordinal, kind)
            self.trips.append(trip)
            return trip

    # -- observation ----------------------------------------------------------

    def trip_count(self) -> int:
        with self.lock:
            return len(self.trips)

    def trips_since(self, n: int) -> List[FaultTrip]:
        with self.lock:
            return list(self.trips[n:])

    def stats(self) -> Dict[str, object]:
        with self.lock:
            by_site: Dict[str, int] = {}
            for t in self.trips:
                by_site[t.site] = by_site.get(t.site, 0) + 1
            return {"trips": len(self.trips), "by_site": by_site,
                    "passes": dict(self._ordinals)}

    # -- installation ---------------------------------------------------------

    def install(self, target) -> "ChaosEngine":
        """Attach this engine to every seam `target` owns (duck-typed):

        * SharkFleet  -> the fleet itself (fleet.submit / fleet.poll) plus
                         every replica server;
        * SharkServer / SharkSession -> its SharkContext, MemoryManager,
                         StorageManager, and mesh (when present);
        * SharkContext -> the scheduler's task bodies and the BlockManager
                         (plus any storage already attached to it).

        Installing over a previous engine replaces it (the storm test
        installs a fresh engine per seed on one long-lived server)."""
        self._installed.append(target)
        if hasattr(target, "replicas") and hasattr(target, "kill_replica"):
            target.chaos = self
            for r in target.replicas:
                self.install(r.server)
            return self
        ctx = getattr(target, "ctx", None)
        if ctx is not None and ctx is not target:
            target.chaos = self
            for attr in ("memory", "storage"):
                obj = getattr(target, attr, None)
                if obj is not None:
                    obj.chaos = self
            mesh = None
            exec_kw = getattr(target, "_exec_kw", None)
            if exec_kw:
                mesh = exec_kw.get("mesh")
            if mesh is None:
                mesh = getattr(getattr(target, "executor", None), "mesh", None)
            if mesh is not None:
                mesh.chaos = self
            self.install(ctx)
            return self
        # SharkContext (or anything exposing a block_manager)
        target.chaos = self
        bm = getattr(target, "block_manager", None)
        if bm is not None:
            bm.chaos = self
            storage = getattr(bm, "shuffle_storage", None)
            if storage is not None:
                storage.chaos = self
        return self

    def uninstall(self) -> None:
        """Detach from everything `install` touched (reverse walk)."""
        for target in self._installed:
            for obj in _chaos_holders(target):
                if getattr(obj, "chaos", None) is self:
                    obj.chaos = None
        self._installed.clear()


def _chaos_holders(target) -> List[object]:
    out = [target]
    for attr in ("memory", "storage", "ctx", "block_manager"):
        obj = getattr(target, attr, None)
        if obj is not None and obj is not target:
            out.append(obj)
    bm = getattr(target, "block_manager", None)
    if bm is not None and getattr(bm, "shuffle_storage", None) is not None:
        out.append(bm.shuffle_storage)
    exec_kw = getattr(target, "_exec_kw", None)
    if exec_kw and exec_kw.get("mesh") is not None:
        out.append(exec_kw["mesh"])
    mesh = getattr(getattr(target, "executor", None), "mesh", None)
    if mesh is not None:
        out.append(mesh)
    return out
