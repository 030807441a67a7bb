"""Fault-tolerant task scheduler (paper §2.3, §2.4, §3.1, §5, §7).

This is the "cluster" layer: logical workers with block stores, per-partition
tasks, memory-based shuffle, lineage recovery, speculative execution, and the
stage-by-stage execution hooks that Partial DAG Execution needs.

Fault-tolerance guarantees reproduced (paper §2.3):
  1. loss of any set of workers is tolerated — lost tasks re-execute and lost
     RDD partitions / shuffle outputs recompute from lineage, mid-query;
  2. recovery is parallelized across surviving workers;
  3. deterministic tasks allow speculative backup copies for stragglers;
  4. the same machinery covers SQL and ML stages (they share one lineage
     graph).

The scheduler executes *stages* delimited by shuffle boundaries.  Map stages
materialize their output in worker memory (memory-based shuffle, §5) while
collecting PDE statistics; the master aggregates those and may re-plan before
launching the next stage (§3.1) — the caller drives this via
`run_map_stage` / `run_result_stage`.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .batch import PartitionBatch
from .rdd import (RDD, ShuffleDependency, ShuffledRDD, TaskContext)
from .resilience import (ResiliencePolicy, ShuffleWaitTimeout, WorkerHealth,
                         describe_counters)
from .stats import Accumulator, StageStats, TaskStats

_stage_counter = itertools.count()


class FetchFailed(Exception):
    """A reduce task could not fetch some map outputs (worker lost them)."""

    def __init__(self, shuffle_id: int, missing_maps: List[int]):
        super().__init__(f"shuffle {shuffle_id} missing maps {missing_maps}")
        self.shuffle_id = shuffle_id
        self.missing_maps = missing_maps


class WorkerLost(Exception):
    pass


class BlockManager:
    """Cluster-wide registry of materialized blocks and which worker holds
    them.  Killing a worker drops every block it holds — cached partitions
    AND shuffle map outputs — exactly the failure surface of the paper.

    Byte accounting is unified: every block's size is tracked on insert so a
    `MemoryManager` (src/repro/server/memory.py) can enforce a cache budget
    with partition-granular LRU eviction.  Cached-partition reads record
    hit/miss so the recompute-from-lineage fallback (paper §3.2) is
    observable; `memory_manager`, when attached, is notified on every put
    (budget enforcement) and miss (recompute detection)."""

    def __init__(self):
        self.lock = threading.RLock()
        # failure-handling knobs (set by SharkContext; None = defaults)
        self.policy: Optional[ResiliencePolicy] = None
        # fault-injection engine (faults.ChaosEngine), when installed
        self.chaos = None
        # pipelined reduces block on this until their input pieces land
        # (put_shuffle notifies; DESIGN.md §14)
        self.shuffle_cond = threading.Condition(self.lock)
        # ("part", rdd_id, split) -> (worker, batch)
        # ("shuf", shuffle_id, map_split, bucket) -> (worker, batch)
        self.blocks: Dict[Tuple, Tuple[int, PartitionBatch]] = {}
        self.by_worker: Dict[int, Set[Tuple]] = {}
        self.sizes: Dict[Tuple, int] = {}
        self.total_bytes = 0
        self.part_bytes = 0  # cached-partition subset of total_bytes
        # LRU order over cached-partition keys only (shuffle blocks are
        # lifecycle-managed per query, not by recency)
        self.part_lru: "Dict[Tuple, None]" = {}
        self.part_hits = 0
        self.part_misses = 0
        # shuffles already released by drop_shuffle: straggler/speculative
        # task attempts finishing late must not resurrect their blocks
        self.released_shuffles: Set[int] = set()
        self.memory_manager = None  # attached by server.MemoryManager
        # shuffle blocks moved to the storage tier under memory pressure:
        # key -> SpillRef.  A spilled block leaves worker memory (and its
        # worker's block set — the segment is server-local disk, so worker
        # loss does not take it down); fetch_shuffle faults it back in, and
        # a lost/corrupt segment degrades to FetchFailed -> lineage
        # recompute, never a wrong answer.
        self.spilled_shuffle: Dict[Tuple, Any] = {}
        self.shuffle_storage = None  # attached by MemoryManager.attach_storage
        self.shuffle_spill_faults = 0
        self.shuffle_spill_lost = 0

    def _put_locked(self, key: Tuple, worker: int,
                    batch: PartitionBatch) -> None:
        # caller holds self.lock; must NOT call the memory manager (it takes
        # its own lock and calls back into us — see _put for the ordering)
        prev = self.sizes.get(key)
        if prev is not None:
            self.total_bytes -= prev
        nbytes = int(batch.nbytes)
        self.blocks[key] = (worker, batch)
        self.by_worker.setdefault(worker, set()).add(key)
        self.sizes[key] = nbytes
        self.total_bytes += nbytes
        if key[0] == "part":
            if prev is not None:
                self.part_bytes -= prev
            self.part_bytes += nbytes
            self.part_lru.pop(key, None)
            self.part_lru[key] = None  # most-recently-used at the end

    def _put(self, key: Tuple, worker: int, batch: PartitionBatch) -> None:
        with self.lock:
            self._put_locked(key, worker, batch)
            mm = self.memory_manager
        if mm is not None:
            mm.on_put(key)

    def put_partition(self, rdd_id: int, split: int, batch: PartitionBatch,
                      worker: int) -> None:
        self._put(("part", rdd_id, split), worker, batch)

    def get_partition(self, rdd_id: int, split: int) -> Optional[PartitionBatch]:
        key = ("part", rdd_id, split)
        mm = None
        with self.lock:
            hit = self.blocks.get(key)
            if hit is not None:
                self.part_hits += 1
                self.part_lru.pop(key, None)
                self.part_lru[key] = None
                return hit[1]
            self.part_misses += 1
            mm = self.memory_manager
        if mm is not None:
            mm.on_miss(key)
        return None

    def drop_block(self, key: Tuple) -> int:
        """Evict one block; returns bytes freed (0 if absent)."""
        with self.lock:
            hit = self.blocks.pop(key, None)
            if hit is None:
                return 0
            worker = hit[0]
            self.by_worker.get(worker, set()).discard(key)
            self.part_lru.pop(key, None)
            nbytes = self.sizes.pop(key, 0)
            self.total_bytes -= nbytes
            if key[0] == "part":
                self.part_bytes -= nbytes
            return nbytes

    def drop_shuffle(self, shuffle_id: int) -> int:
        """Release all map output of a finished shuffle — in-memory blocks
        AND spilled segments; returns bytes freed.  The release is sticky:
        later writes for this shuffle (straggler / speculative attempts
        outliving their query) are dropped on arrival."""
        with self.lock:
            self.released_shuffles.add(shuffle_id)
            keys = [k for k in self.blocks
                    if k[0] == "shuf" and k[1] == shuffle_id]
            spilled = [k for k in self.spilled_shuffle if k[1] == shuffle_id]
            storage = self.shuffle_storage
            for k in spilled:
                ref = self.spilled_shuffle.pop(k)
                if storage is not None:
                    storage.forget_shuffle(ref)
        return sum(self.drop_block(k) for k in keys)

    def lru_partition_keys(self) -> List[Tuple]:
        """Cached-partition keys, least-recently-used first."""
        with self.lock:
            return list(self.part_lru)

    def put_shuffle(self, shuffle_id: int, map_split: int, bucket: int,
                    batch: PartitionBatch, worker: int) -> None:
        with self.lock:
            if shuffle_id in self.released_shuffles:
                return  # late straggler write for a finished query
            # the released-check and the insert must be one atomic step: a
            # drop_shuffle between them would let this block leak forever
            self._put_locked(("shuf", shuffle_id, map_split, bucket),
                             worker, batch)
            self.shuffle_cond.notify_all()
            mm = self.memory_manager
        if mm is not None:
            mm.on_put(("shuf", shuffle_id, map_split, bucket))

    def wait_shuffle(self, shuffle_id: int, maps: Sequence[int],
                     buckets: Sequence[int], timeout: Optional[float] = None,
                     cancel: Optional[threading.Event] = None) -> bool:
        """Block until every (map, bucket) piece in `maps`×`buckets` is
        present (in memory or spilled); True on success, False on cancel.
        The timeout defaults to the ResiliencePolicy's
        `shuffle_wait_timeout_s` and expiry raises a typed
        `ShuffleWaitTimeout` carrying the shuffle id and the map splits
        still missing (the seed returned a bare False, indistinguishable
        from cancellation and naming nothing).  Availability is checked
        BEFORE cancellation so a waiter racing the map stage's completion
        signal still wins when its pieces already landed."""
        if timeout is None:
            pol = self.policy
            timeout = (pol.shuffle_wait_timeout_s if pol is not None
                       else ResiliencePolicy.shuffle_wait_timeout_s)
        deadline = time.monotonic() + timeout

        def _have(m: int, b: int) -> bool:
            return (("shuf", shuffle_id, m, b) in self.blocks
                    or ("shuf", shuffle_id, m, b) in self.spilled_shuffle)

        with self.lock:
            while True:
                if all(_have(m, b) for m in maps for b in buckets):
                    return True
                if cancel is not None and cancel.is_set():
                    return False
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    missing = sorted({m for m in maps
                                      if any(not _have(m, b)
                                             for b in buckets)})
                    raise ShuffleWaitTimeout(shuffle_id, missing, timeout)
                self.shuffle_cond.wait(min(remaining, 0.05))

    def has_map_output(self, shuffle_id: int, map_split: int) -> bool:
        with self.lock:
            return any(k[0] == "shuf" and k[1] == shuffle_id
                       and k[2] == map_split
                       for k in (*self.blocks, *self.spilled_shuffle))

    def spill_shuffle_block(self, key: Tuple) -> int:
        """Move one shuffle block from worker memory to the storage tier;
        returns resident bytes freed (0 when no storage is attached, the
        block is gone, or it is already spilled).  Called by the
        MemoryManager's working-set rung — shuffle output obeys the budget
        like everything else once a spill tier exists."""
        with self.lock:
            storage = self.shuffle_storage
            if storage is None:
                return 0
            hit = self.blocks.get(key)
            if hit is None:
                return 0
            if key in self.spilled_shuffle:
                # a deterministic recompute re-created a block whose segment
                # is still live: the bytes on disk are identical, just
                # release the memory copy
                return self.drop_block(key)
            ref = storage.spill_shuffle(key, hit[1])
            if ref is None:
                return 0
            self.spilled_shuffle[key] = ref
            return self.drop_block(key)

    def shuffle_spill_candidates(self) -> List[Tuple]:
        """Resident (non-spilled) shuffle block keys, largest first — the
        eviction order for the working-set rung."""
        with self.lock:
            keys = [k for k in self.blocks if k[0] == "shuf"]
            return sorted(keys, key=lambda k: -self.sizes.get(k, 0))

    def fetch_shuffle(self, shuffle_id: int, num_maps: int,
                      buckets: Sequence[int],
                      maps: Optional[Sequence[int]] = None
                      ) -> List[PartitionBatch]:
        """All pieces of `buckets` from every map task (or the subset in
        `maps` — used by skew-split reducers, each of which owns a disjoint
        stripe of map outputs); FetchFailed lists the missing map splits so
        the scheduler can recompute exactly those.

        Pieces are zero-copy views of the stored blocks, returned in
        deterministic (map, bucket) order: the reduce task sizes its output
        once from the piece offsets and assembles each column with a single
        preallocated concat (`PartitionBatch.concat`).  The block format is
        dictionary-preserving (DESIGN.md §11): a string column travels as
        (int32 codes, partition-local dictionary) — the dictionary rides in
        the block as the column's header — and the reduce side unifies
        dictionaries with a vectorized merge-remap instead of decoding.
        Recomputed-from-lineage blocks carry byte-identical dictionaries
        because map tasks are deterministic."""
        chaos = self.chaos
        if chaos is not None:
            trip = chaos.fire("shuffle.fetch")
            if trip is not None:
                # lose one present map split's blocks for this shuffle: the
                # scan below reports it missing -> FetchFailed -> the
                # scheduler recomputes exactly that map task from lineage
                with self.lock:
                    present = sorted({k[2] for k in self.blocks
                                      if k[0] == "shuf"
                                      and k[1] == shuffle_id})
                if present:
                    victim = present[trip.ordinal % len(present)]
                    with self.lock:
                        doomed = [k for k in self.blocks
                                  if k[0] == "shuf" and k[1] == shuffle_id
                                  and k[2] == victim]
                    for k in doomed:
                        self.drop_block(k)
        pieces, missing = [], set()
        with self.lock:
            for m in (range(num_maps) if maps is None else maps):
                for b in buckets:
                    key = ("shuf", shuffle_id, m, b)
                    hit = self.blocks.get(key)
                    if hit is not None:
                        pieces.append(hit[1])
                        continue
                    ref = self.spilled_shuffle.get(key)
                    if ref is not None and self.shuffle_storage is not None:
                        # spilled to the storage tier: fault the segment
                        # back in (checksum-verified).  A lost or corrupt
                        # segment degrades to a missing map output and the
                        # scheduler recomputes it from lineage.
                        batch = self.shuffle_storage.fault_shuffle(ref)
                        if batch is not None:
                            self.shuffle_spill_faults += 1
                            pieces.append(batch)
                            continue
                        self.shuffle_spill_lost += 1
                        self.spilled_shuffle.pop(key, None)
                    missing.add(m)
        if missing:
            raise FetchFailed(shuffle_id, sorted(missing))
        return pieces

    def drop_worker(self, worker: int) -> int:
        with self.lock:
            keys = self.by_worker.pop(worker, set())
            for k in keys:
                self.blocks.pop(k, None)
                self.part_lru.pop(k, None)
                nbytes = self.sizes.pop(k, 0)
                self.total_bytes -= nbytes
                if k[0] == "part":
                    self.part_bytes -= nbytes
            return len(keys)

    def nbytes(self) -> int:
        with self.lock:
            return self.total_bytes


@dataclasses.dataclass
class TaskRecord:
    split: int
    attempt: int
    worker: int
    started: float
    future: Optional[Future] = None
    speculative: bool = False


class Scheduler:
    """Master: assigns tasks to alive workers, retries on failure, launches
    speculative backups, and rebuilds lost shuffle output from lineage."""

    def __init__(self, ctx: "SharkContext", num_workers: int = 8,
                 max_threads: int = 8, speculation: bool = True,
                 speculation_multiplier: float = 4.0,
                 speculation_quantile: float = 0.5,
                 max_stage_retries: int = 6,
                 task_launch_overhead_s: float = 0.0,
                 policy: Optional[ResiliencePolicy] = None):
        self.ctx = ctx
        self.num_workers = num_workers
        self.alive: Set[int] = set(range(num_workers))
        self.max_threads = max_threads
        self.pool = ThreadPoolExecutor(max_workers=max_threads)
        self.speculation = speculation
        self.speculation_multiplier = speculation_multiplier
        self.speculation_quantile = speculation_quantile
        if policy is None:
            policy = ResiliencePolicy(max_stage_retries=max_stage_retries)
        self.policy = policy
        # kept as a plain attribute: external layers (ml.trainer, the
        # broadcast fetch in physical.py) read it directly
        self.max_stage_retries = policy.max_stage_retries
        self.task_launch_overhead_s = task_launch_overhead_s
        self.health = WorkerHealth(policy)
        self.lock = threading.RLock()
        self._rr = itertools.count()
        # metrics
        self.tasks_launched = 0
        self.tasks_speculated = 0
        self.tasks_recomputed = 0
        # resilience event counters (policy decisions, DESIGN.md §16)
        self.resilience_counters: Dict[str, int] = {
            "retries": 0, "backoffs": 0, "app_probes": 0,
            "fast_fails": 0, "reaps": 0}
        self.stage_stats: Dict[int, StageStats] = {}
        # pipelined-scheduling event log (DESIGN.md §14): monotonically
        # sequenced (seq, kind, shuffle_id, detail) tuples — the test
        # probe that reduce tasks observably start before the map stage
        # drains.  Bounded: trimmed from the front when it grows large.
        self.stage_events: List[Tuple[int, str, int, Any]] = []
        self._event_seq = itertools.count()

    def _log_event(self, kind: str, shuffle_id: int, detail: Any = None
                   ) -> None:
        with self.lock:
            self.stage_events.append(
                (next(self._event_seq), kind, shuffle_id, detail))
            if len(self.stage_events) > 4096:
                del self.stage_events[:2048]

    # -- cluster membership --------------------------------------------------

    def kill_worker(self, worker: int) -> int:
        """Simulate a node failure: the worker leaves and all its blocks
        (cached partitions + shuffle outputs) vanish."""
        with self.lock:
            self.alive.discard(worker)
        self.health.forget(worker)
        return self.ctx.block_manager.drop_worker(worker)

    def add_worker(self) -> int:
        """Elasticity (§7.2): a new worker joins and immediately receives
        pending work."""
        with self.lock:
            w = self.num_workers
            self.num_workers += 1
            self.alive.add(w)
            return w

    def _pick_worker(self, exclude: Optional[Set[int]] = None) -> int:
        quarantined = self.health.excluded()
        with self.lock:
            avoid = [w for w in sorted(self.alive)
                     if not exclude or w not in exclude]
            # quarantined workers are skipped until their probation probe is
            # due; an empty healthy pool falls back to the full one (a task
            # on a flaky worker beats no task at all)
            pool = [w for w in avoid if w not in quarantined] or avoid
            if not pool:
                pool = sorted(self.alive)
            if not pool:
                raise RuntimeError("no alive workers")
            return pool[next(self._rr) % len(pool)]

    # -- generic stage runner with retry + speculation ------------------------

    def _run_tasks(self, stage_id: int, splits: Sequence[int],
                   run_one: Callable[[int, TaskContext], Any]) -> Dict[int, Any]:
        """Run one task per split under the ResiliencePolicy; returns
        split -> result.  `run_one` must be deterministic and idempotent.

        Failure handling (DESIGN.md §16):
          * retryable infrastructure faults (policy.is_retryable) retry on
            another worker with deterministic exponential backoff, up to
            `max_task_attempts`; each failure scores against the worker's
            health and may quarantine it from `_pick_worker`;
          * deterministic application errors fail FAST: after at most
            `app_error_probes` cross-worker probes the ORIGINAL exception
            is re-raised (the seed retried any exception to the attempt
            cap, surfacing app bugs late with mangled context);
          * with `task_deadline_s` set, a task running past the deadline is
            reaped: its future is abandoned (a late result is never
            observed; late shuffle writes hit the exactly-once released-
            shuffle guard) and the split relaunches elsewhere — even when
            ZERO tasks have completed, the case duration-based speculation
            structurally cannot cover (the seed deadlocked forever here).
        """
        policy = self.policy
        results: Dict[int, Any] = {}
        pending: Set[int] = set(splits)
        durations: List[float] = []
        attempt_counter: Dict[int, int] = {s: 0 for s in splits}
        infra_failures: Dict[int, int] = {s: 0 for s in splits}
        app_probes: Dict[int, int] = {s: 0 for s in splits}
        first_app_error: Dict[int, BaseException] = {}
        # (due_time, split, exclude): backoff-delayed resubmits
        delayed: List[Tuple[float, int, Set[int]]] = []

        def submit(split: int, exclude: Optional[Set[int]] = None,
                   speculative: bool = False) -> TaskRecord:
            worker = self._pick_worker(exclude)
            tc = TaskContext(worker, stage_id, split,
                             attempt_counter[split])
            attempt_counter[split] += 1
            rec = TaskRecord(split, tc.attempt, worker, time.monotonic(),
                             speculative=speculative)

            def body():
                if self.task_launch_overhead_s:
                    time.sleep(self.task_launch_overhead_s)
                with self.lock:
                    if worker not in self.alive:
                        raise WorkerLost(f"worker {worker} is dead")
                chaos = getattr(self.ctx, "chaos", None)
                if chaos is not None:
                    trip = chaos.fire("task.body")
                    if trip is not None:
                        # chaos worker death: the node vanishes (all its
                        # blocks drop) and a fresh one joins — the exact
                        # surface the hand-rolled chaos tests poked
                        self.kill_worker(worker)
                        self.add_worker()
                        raise WorkerLost(
                            f"worker {worker} killed by chaos "
                            f"({trip.site}#{trip.ordinal})")
                out = run_one(split, tc)
                with self.lock:
                    if worker not in self.alive:
                        # results computed on a dead worker are discarded
                        raise WorkerLost(f"worker {worker} died mid-task")
                return out

            with self.lock:
                self.tasks_launched += 1
                if speculative:
                    self.tasks_speculated += 1
            rec.future = self.pool.submit(body)
            return rec

        def resubmit(split: int, exclude: Set[int]) -> None:
            """Retry with the policy's deterministic backoff schedule."""
            delay = policy.backoff(infra_failures[split])
            if delay > 0.0:
                with self.lock:
                    self.resilience_counters["backoffs"] += 1
                delayed.append((time.monotonic() + delay, split,
                                set(exclude)))
            else:
                running[split].append(submit(split, exclude=exclude))

        running: Dict[int, List[TaskRecord]] = {}
        for s in splits:
            running[s] = [submit(s)]

        while pending:
            now = time.monotonic()
            if delayed:
                due = [d for d in delayed if d[0] <= now]
                if due:
                    delayed[:] = [d for d in delayed if d[0] > now]
                    for _, split, exclude in due:
                        if split in pending:
                            running[split].append(
                                submit(split, exclude=exclude))
            all_futs = {rec.future: (s, rec)
                        for s, recs in running.items() for rec in recs
                        if rec.future is not None and s in pending}
            if not all_futs:
                if delayed:
                    # every in-flight attempt is backing off; sleep to the
                    # nearest due time instead of spinning
                    nearest = min(d[0] for d in delayed)
                    time.sleep(min(0.05, max(0.0, nearest - now)))
                    continue
                raise RuntimeError("scheduler deadlock: no running tasks")
            done, _ = wait(list(all_futs), timeout=0.05,
                           return_when=FIRST_COMPLETED)
            now = time.monotonic()
            for fut in done:
                split, rec = all_futs[fut]
                if split not in pending:
                    continue
                try:
                    res = fut.result()
                except FetchFailed:
                    raise  # stage-level recovery (lineage) handled above us
                except Exception as exc:
                    # Clear the handled future FIRST — it would otherwise be
                    # re-observed as "done" on every poll iteration while the
                    # retry waits for a pool thread, spawning a retry per
                    # poll until the attempt cap kills the whole stage.
                    rec.future = None
                    self.health.record_failure(rec.worker)
                    if policy.is_retryable(exc):
                        infra_failures[split] += 1
                        with self.lock:
                            self.resilience_counters["retries"] += 1
                        if attempt_counter[split] > policy.max_task_attempts:
                            raise
                        resubmit(split, {rec.worker})
                    elif app_probes[split] < policy.app_error_probes:
                        # deterministic app error?  one cross-worker probe
                        # tells a poison partition from a poison worker
                        first_app_error.setdefault(split, exc)
                        app_probes[split] += 1
                        with self.lock:
                            self.resilience_counters["app_probes"] += 1
                        running[split].append(
                            submit(split, exclude={rec.worker}))
                    else:
                        with self.lock:
                            self.resilience_counters["fast_fails"] += 1
                        raise first_app_error.get(split, exc)
                    continue
                self.health.record_success(rec.worker)
                results[split] = res
                pending.discard(split)
                durations.append(now - rec.started)
            # hung-task reaper: abandon any attempt past the deadline and
            # relaunch the split elsewhere (policy.task_deadline_s)
            if policy.task_deadline_s is not None and pending:
                for split in list(pending):
                    for rec in list(running[split]):
                        if (rec.future is None
                                or now - rec.started
                                <= policy.task_deadline_s):
                            continue
                        rec.future = None       # late result never observed
                        self.health.record_failure(rec.worker)
                        infra_failures[split] += 1
                        with self.lock:
                            self.resilience_counters["reaps"] += 1
                        if attempt_counter[split] > policy.max_task_attempts:
                            raise RuntimeError(
                                f"task {split} exceeded its "
                                f"{policy.task_deadline_s}s deadline "
                                f"{attempt_counter[split]} times")
                        resubmit(split, {rec.worker})
            # speculation: if a task runs far beyond the median of completed
            # tasks, launch a backup copy on another worker (§2.3 item 3)
            if self.speculation and durations and pending:
                frac_done = len(durations) / max(len(splits), 1)
                if frac_done >= self.speculation_quantile:
                    med = float(np.median(durations))
                    threshold = max(self.speculation_multiplier * med, 0.05)
                    for split in list(pending):
                        recs = running[split]
                        if any(r.speculative for r in recs):
                            continue
                        oldest = min(r.started for r in recs)
                        if now - oldest > threshold:
                            workers = {r.worker for r in recs}
                            running[split].append(
                                submit(split, exclude=workers,
                                       speculative=True))
        return results

    # -- map stages (shuffle writes + PDE statistics) -------------------------

    def run_map_stage(self, dep: ShuffleDependency) -> StageStats:
        """Materialize the map side of a shuffle in worker memory, gathering
        PDE statistics while doing so.  Returns the aggregated stats the
        optimizer uses to re-plan the downstream DAG (§3.1).

        Recovers from lost UPSTREAM shuffle output mid-stage: when the map
        tasks themselves read a parent shuffle (e.g. the sort boundary above
        an aggregation) and a worker died since that shuffle materialized,
        the missing parent map outputs recompute from lineage and the stage
        retries — the same policy run_result_stage applies (§2.3)."""
        for retry in range(self.max_stage_retries):
            try:
                return self._run_map_stage_attempt(dep)
            except FetchFailed as ff:
                self._recover_lineage(dep.parent, ff)
        raise RuntimeError("exceeded max stage retries (map stage)")

    def _recover_lineage(self, rdd: "RDD", ff: FetchFailed) -> None:
        """Recompute the map outputs `ff` reported missing; when the
        recovery tasks themselves hit a lost shuffle further up the chain,
        recover that one first, then CLIMB BACK DOWN and finish the
        original recovery — a stack of pending levels, so one call repairs
        a whole multi-level chain instead of burning one outer stage retry
        per level.  Bounded walk: the lineage DAG is finite; the budget
        covers a chain of max_stage_retries levels each re-lost a few
        times."""
        pending = [ff]
        for _ in range(self.max_stage_retries * 4):
            cur = pending[-1]
            dep = _find_shuffle_dep(rdd, cur.shuffle_id)
            if dep is None:
                raise cur
            try:
                self._recover_map_outputs(dep, cur.missing_maps)
            except FetchFailed as deeper:
                pending.append(deeper)
                continue
            pending.pop()
            if not pending:
                return
        raise ff

    def _map_output_pieces(self, dep: ShuffleDependency,
                           batch) -> List[PartitionBatch]:
        """Per-bucket pieces of one map task's output.  A fused stage
        program (DESIGN.md §14) hands back a BucketedBatch — already
        partitioned and combined inside the task's single stage program —
        whose pieces ship as-is; otherwise the scheduler applies the legacy
        partition→slice→combine seam.  Shared by the map attempt AND
        lineage recovery, so recomputation climbs through fused stages and
        re-derives byte-identical blocks (tasks are deterministic)."""
        from .shuffle import BucketedBatch
        if isinstance(batch, BucketedBatch):
            return batch.pieces
        from .shuffle import split_bucket_pieces
        bucket_of = dep.partitioner(batch)
        pieces = split_bucket_pieces(batch, bucket_of, dep.num_buckets)
        if dep.map_side_combine is not None:
            pieces = [dep.map_side_combine(p) for p in pieces]
        return pieces

    def _run_map_stage_attempt(self, dep: ShuffleDependency) -> StageStats:
        stage_id = next(_stage_counter)
        parent = dep.parent
        stats = StageStats(stage_id)
        stats_lock = threading.Lock()

        def run_one(split: int, tc: TaskContext):
            batch = parent.iterator(split, tc)
            accs = dep.accumulators()
            pieces = self._map_output_pieces(dep, batch)
            for b, piece in enumerate(pieces):
                for acc in accs:
                    acc.update(b, piece)
                self.ctx.block_manager.put_shuffle(
                    dep.shuffle_id, split, b, piece, tc.worker_id)
            self._log_event("map-done", dep.shuffle_id, split)
            ts = TaskStats(split, stage_id,
                           {a.name: a.payload() for a in accs})
            with stats_lock:
                stats.add(ts)
            return True

        self._run_tasks(stage_id, range(parent.num_partitions), run_one)
        self.stage_stats[stage_id] = stats
        return stats

    def _recover_map_outputs(self, dep: ShuffleDependency,
                             missing: List[int]) -> None:
        """Lineage recovery: recompute only the lost map tasks, in parallel
        across surviving workers (§2.3 items 1–2)."""
        stage_id = next(_stage_counter)
        parent = dep.parent

        def run_one(split: int, tc: TaskContext):
            batch = parent.iterator(split, tc)
            for b, piece in enumerate(self._map_output_pieces(dep, batch)):
                self.ctx.block_manager.put_shuffle(
                    dep.shuffle_id, split, b, piece, tc.worker_id)
            return True

        with self.lock:
            self.tasks_recomputed += len(missing)
        self._run_tasks(stage_id, missing, run_one)

    # -- pipelined map→reduce overlap (DESIGN.md §14) -------------------------

    def run_map_stage_pipelined(self, dep: ShuffleDependency,
                                groups: Sequence[Sequence[int]],
                                reduce_fn: Callable[[int, List[PartitionBatch]],
                                                    Any]
                                ) -> Tuple[StageStats, Dict[int, Any]]:
        """Run the map stage while reduce tasks start as soon as their input
        pieces land, overlapping shuffle fetch with upstream compute.

        `groups[r]` lists the buckets reduce split `r` consumes;
        `reduce_fn(split, pieces)` must be deterministic — pieces arrive in
        the same (map, bucket) order `fetch_shuffle` would return.  Returns
        (stats, precomputed): reduce splits whose pipelined attempt failed
        (worker death mid-stage, fetch races) are simply absent from
        `precomputed` and recompute on the standard pull path — the
        pipeline is an overlap optimization, never a correctness
        dependency.  The map stage itself runs via `self.run_map_stage`
        so chaos-test interceptions (and lineage retries) apply
        unchanged."""
        done = threading.Event()
        results: Dict[int, Any] = {}
        rlock = threading.Lock()
        threads = [
            threading.Thread(
                target=self._pipelined_reduce,
                args=(dep, r, list(buckets), reduce_fn, done, results, rlock),
                daemon=True)
            for r, buckets in enumerate(groups)]
        for t in threads:
            t.start()
        try:
            stats = self.run_map_stage(dep)
        finally:
            done.set()
        for t in threads:
            t.join(timeout=10.0)
        return stats, dict(results)

    def _pipelined_reduce(self, dep: ShuffleDependency, split: int,
                          buckets: List[int], reduce_fn, cancel, results,
                          rlock) -> None:
        num_maps = dep.parent.num_partitions
        bm = self.ctx.block_manager
        pieces: List[PartitionBatch] = []
        try:
            # In-order per-map waiting keeps piece order identical to the
            # pull path's fetch_shuffle and makes the event log
            # deterministic under a straggler on a later map split.
            for m in range(num_maps):
                if not bm.wait_shuffle(dep.shuffle_id, [m], buckets,
                                       cancel=cancel):
                    return
                pieces.extend(bm.fetch_shuffle(
                    dep.shuffle_id, num_maps, buckets, maps=[m]))
                if m == 0:
                    self._log_event("reduce-fetch", dep.shuffle_id, split)
            self._log_event("reduce-start", dep.shuffle_id, split)
            out = reduce_fn(split, pieces)
        except Exception:
            return  # fall back to the pull path (deterministic parity)
        with rlock:
            results[split] = out
        self._log_event("reduce-done", dep.shuffle_id, split)

    # -- result stages --------------------------------------------------------

    def run_result_stage(self, rdd: RDD) -> List[PartitionBatch]:
        """Compute the final RDD's partitions, transparently recovering from
        lost shuffle outputs mid-query via lineage recompute."""
        for retry in range(self.max_stage_retries):
            stage_id = next(_stage_counter)
            try:
                results = self._run_tasks(
                    stage_id, range(rdd.num_partitions),
                    lambda split, tc: rdd.iterator(split, tc))
                return [results[i] for i in range(rdd.num_partitions)]
            except FetchFailed as ff:
                self._recover_lineage(rdd, ff)
        raise RuntimeError("exceeded max stage retries")

    def run_job(self, rdd: RDD) -> List[PartitionBatch]:
        """Run all ancestor map stages (in lineage order), then the result
        stage.  This is the non-PDE path; PDE drives stages itself."""
        for dep in _all_shuffle_deps(rdd):
            if not self._map_outputs_complete(dep):
                self.run_map_stage(dep)
        return self.run_result_stage(rdd)

    def _map_outputs_complete(self, dep: ShuffleDependency) -> bool:
        return all(self.ctx.block_manager.has_map_output(dep.shuffle_id, m)
                   for m in range(dep.parent.num_partitions))

    # -- resilience reporting (DESIGN.md §16) ---------------------------------

    def resilience_stats(self) -> Dict[str, int]:
        with self.lock:
            out = dict(self.resilience_counters)
        out.update(self.health.stats())
        return out

    def describe_resilience(self) -> str:
        """explain()-adjacent one-stop report of every policy decision this
        scheduler took: counters, worker health, and the policy knobs."""
        with self.lock:
            counters = {k: v for k, v in self.resilience_counters.items()
                        if v}
        return describe_counters(counters, self.health, self.policy)


def _all_shuffle_deps(rdd: RDD, out: Optional[List[ShuffleDependency]] = None,
                      seen: Optional[Set[int]] = None) -> List[ShuffleDependency]:
    out = out if out is not None else []
    seen = seen if seen is not None else set()
    if rdd.id in seen:
        return out
    seen.add(rdd.id)
    for d in rdd.deps:
        _all_shuffle_deps(d.parent, out, seen)
        if isinstance(d, ShuffleDependency):
            out.append(d)
    return out


def _find_shuffle_dep(rdd: RDD, shuffle_id: int) -> Optional[ShuffleDependency]:
    for dep in _all_shuffle_deps(rdd):
        if dep.shuffle_id == shuffle_id:
            return dep
    return None


def resolve_device(device=None):
    """The torch device a session or a model computes on.  None means
    "cuda", which raises when no card is present: nothing moves to the CPU
    unless asked."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" "
            "to run on the CPU")
    return dev


class SharkContext:
    """The cluster handle: block manager + scheduler + RDD constructors.

    `device` is where the context's tasks compute (the GPU unless the
    caller asks for the CPU); every RDD reaches it through `rdd.ctx`, so
    work launched from an RDD — a training iteration over a FeatureRDD —
    runs where the session that built it runs."""

    def __init__(self, num_workers: int = 8, max_threads: int = 8,
                 speculation: bool = True,
                 task_launch_overhead_s: float = 0.0,
                 policy: Optional[ResiliencePolicy] = None, device=None):
        self.device = resolve_device(device)
        self.block_manager = BlockManager()
        self.scheduler = Scheduler(
            self, num_workers=num_workers, max_threads=max_threads,
            speculation=speculation,
            task_launch_overhead_s=task_launch_overhead_s,
            policy=policy)
        # one policy object governs the context's layers; the BlockManager
        # reads it for shuffle-wait timeouts
        self.policy = self.scheduler.policy
        self.block_manager.policy = self.policy
        # fault-injection engine (faults.ChaosEngine.install sets this)
        self.chaos = None

    def parallelize(self, batches: List[PartitionBatch]):
        from .rdd import ParallelCollectionRDD
        return ParallelCollectionRDD(self, batches)

    def scan(self, table, columns=None, selected=None):
        from .rdd import TableScanRDD
        return TableScanRDD(self, table, columns, selected)

    def shutdown(self):
        self.scheduler.pool.shutdown(wait=False)
