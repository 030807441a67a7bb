"""SharkServer — concurrent multi-session query service (DESIGN.md §6), the
port of `repro.server.server`.

One server owns ONE shared SharkContext (workers + block store), ONE
catalog, and the unified MemoryManager; many client sessions submit queries
concurrently:

    srv = SharkServer(cache_budget_bytes=64 << 20)
    srv.create_table("rankings", schema, data)
    etl = srv.session("etl", weight=1.0)        # scan-heavy tenant
    dash = srv.session("dash", weight=4.0)      # interactive tenant
    h = etl.submit("SELECT ... GROUP BY ...")   # async QueryHandle
    res = dash.sql("SELECT COUNT(*) FROM rankings")  # sync, fair-scheduled

Execution path per query (worker-pool thread):
  parse -> bind -> optimize -> fingerprint -> result-cache probe
        -> compile/execute on the shared runtime (cached scans under the
           memory budget; evicted partitions recompute from lineage)
        -> release the query's shuffle map outputs -> result-cache fill.

`submit()` also accepts a *bound logical plan* (what `SharkFrame.collect()`
sends): the plan path joins the pipeline at the optimize step, so frame
queries and SQL text get identical admission control, fair scheduling, and
result-cache behavior — one plan fingerprint, one cache entry.

Each query gets a fresh Executor (per-query metrics, no cross-query state)
but all executors share the context, catalog, scan cache, and therefore
the block store — that sharing is the whole point of the server tier.

The server computes on the GPU unless the caller asks for the CPU
(`device="cpu"`), and raises without a card, as `SharkSession` does.  The
out-of-core storage tier (`spill_dir=`, `spill_mode=`, DESIGN.md §12) is
opt-in, as in the reference, and so is the device mesh (`mesh=`, a
`cluster.MeshContext` whose slots are of the server's device type: every
executor shards eligible aggregate map sides over it).  A catalog block's
device copies (`Encoded._device`) live as long as the block serves queries: they are
released when its partition goes cold, when its table leaves the catalog
or is replaced, and at `shutdown()`.  A replaced or dropped table's spill
segments stay until `shutdown()`, as in the reference.
"""

from __future__ import annotations

import copy
import threading
from typing import Dict, Optional, Union

import numpy as np

from ..core.catalog import Catalog, ExternalSource
from ..core.columnar import Table, from_arrays
from ..core.pde import PDEConfig
from ..core.physical import ExecResult, Executor, ScanCache
from ..core.runtime import SharkContext, resolve_device
from ..core.sql import Binder, CreateStmt, parse
from ..core.plan import Node, optimize
from ..core.types import Schema
from .memory import MemoryManager
from .result_cache import ResultCache, plan_fingerprint
from .scheduler import AdmissionError, FairScheduler, QueryHandle

__all__ = ["SharkServer", "AdmissionError", "QueryHandle"]


class SharkServer:
    def __init__(self, num_workers: int = 8, max_threads: int = 8, *,
                 cache_budget_bytes: Optional[int] = None,
                 max_concurrent_queries: int = 4,
                 max_queue_depth: int = 32,
                 enable_result_cache: bool = True,
                 result_cache_entries: int = 256,
                 enable_pde: bool = True, enable_map_pruning: bool = True,
                 default_partitions: int = 8,
                 default_shuffle_buckets: int = 64,
                 pde_config: Optional[PDEConfig] = None,
                 speculation: bool = True,
                 task_launch_overhead_s: float = 0.0,
                 backend: str = "compiled", exchange: str = "coded",
                 spill_dir: Optional[str] = None,
                 spill_mode: Optional[str] = None,
                 mesh=None, stage_fusion: str = "on",
                 resilience=None, device=None):
        # the device compiled routes and kernels run on: the GPU unless the
        # caller asks for the CPU (the CPU tests pass device="cpu")
        self.device = resolve_device(device)
        if mesh is not None:
            mesh.check_device(self.device)
        self.ctx = SharkContext(num_workers=num_workers,
                                max_threads=max_threads,
                                speculation=speculation,
                                task_launch_overhead_s=task_launch_overhead_s,
                                policy=resilience, device=self.device)
        self.catalog = Catalog()
        self.memory = MemoryManager(self.ctx.block_manager,
                                    budget_bytes=cache_budget_bytes)
        # out-of-core storage tier (DESIGN.md §12): opt-in — without it the
        # server behaves exactly as before (LRU eviction + recompute only)
        self.storage = None
        if spill_mode is not None or spill_dir is not None:
            from ..core.storage import StorageManager
            self.storage = StorageManager(spill_dir=spill_dir,
                                          mode=spill_mode or "spill",
                                          policy=self.ctx.policy)
            self.memory.attach_storage(self.storage)
        self.scan_cache = ScanCache()
        self.result_cache = (ResultCache(result_cache_entries)
                             if enable_result_cache else None)
        if self.result_cache is not None:
            self.memory.attach_result_cache(self.result_cache)
        self.memory.attach_catalog(self.catalog)
        # the table object each name last held: its device copies go when a
        # change event replaces or drops it
        self._tables_seen: Dict[str, Table] = {}
        self.catalog.subscribe(self._on_catalog_change)
        self.default_partitions = default_partitions
        self._exec_kw = dict(
            pde=pde_config or PDEConfig(), enable_pde=enable_pde,
            enable_map_pruning=enable_map_pruning,
            default_shuffle_buckets=default_shuffle_buckets,
            backend=backend, exchange=exchange, mesh=mesh,
            stage_fusion=stage_fusion, device=self.device)
        self.scheduler = FairScheduler(
            self._run_query, max_concurrent=max_concurrent_queries,
            max_queue_depth=max_queue_depth)
        self._session_counter = 0
        self._lock = threading.Lock()

    def _on_catalog_change(self, name: str, epoch: int) -> None:
        """Catalog epoch bump: eagerly drop result-cache entries reading the
        mutated table (stale scan RDDs are retired lazily by version key),
        and the device copies of the table it replaced or dropped."""
        if self.result_cache is not None:
            self.result_cache.invalidate_table(name)
        current = self.catalog.tables().get(name)
        with self._lock:
            old = self._tables_seen.pop(name, None)
            if current is not None:
                self._tables_seen[name] = current
        if old is not None and old is not current:
            old.drop_device()

    # -- sessions -------------------------------------------------------------

    def session(self, client_id: Optional[str] = None, weight: float = 1.0):
        """A SharkSession attached to this server (shared warehouse, fair-
        scheduled execution)."""
        from ..core.session import SharkSession
        with self._lock:
            if client_id is None:
                client_id = f"client-{self._session_counter}"
            self._session_counter += 1
        return SharkSession(server=self, client_id=client_id, weight=weight)

    def register_client(self, client_id: str, weight: float = 1.0) -> None:
        self.scheduler.register_client(client_id, weight)

    # -- warehouse ------------------------------------------------------------

    def create_table(self, name: str, schema: Schema,
                     data: Dict[str, np.ndarray],
                     num_partitions: Optional[int] = None,
                     distribute_by: Optional[str] = None) -> Table:
        table = from_arrays(name, schema, data,
                            num_partitions or self.default_partitions,
                            distribute_by)
        self.catalog.register_table(table)
        return table

    def register_external(self, src: ExternalSource) -> None:
        self.catalog.register_external(src)

    # -- query submission -----------------------------------------------------

    def submit(self, query: Union[str, Node], client: str = "default",
               block: bool = True,
               timeout: Optional[float] = None) -> QueryHandle:
        """Enqueue a query for async execution; blocks (or raises
        AdmissionError) when the admission queue is full.

        `query` is SQL text, a SharkFrame, or a *bound logical plan* (a
        `core.plan.Node`, what `SharkFrame.collect()` submits).  All forms
        share admission control, fair scheduling, and — because the result
        cache is keyed by the fingerprint of the optimized plan — one cache
        entry: a frame query and its SQL-text twin hit each other's
        results."""
        from ..core.frame import SharkFrame
        if isinstance(query, SharkFrame):
            handle = QueryHandle(None, client, plan=query.logical_plan())
        elif isinstance(query, Node):
            handle = QueryHandle(None, client, plan=query)
        elif isinstance(query, str):
            handle = QueryHandle(query, client)
        else:
            raise TypeError(
                f"submit() takes SQL text, a SharkFrame, or a logical plan "
                f"Node; got {type(query).__name__}")
        return self.scheduler.submit(handle, block=block, timeout=timeout)

    def sql(self, sql: str, client: str = "default") -> ExecResult:
        return self.submit(sql, client=client).result()

    def sql_np(self, sql: str, client: str = "default"):
        return self.sql(sql, client=client).to_numpy()

    # -- execution (runs on scheduler worker threads) --------------------------

    def make_executor(self) -> Executor:
        return Executor(self.ctx, self.catalog,
                        scan_cache=self.scan_cache, **self._exec_kw)

    def _run_query(self, handle: QueryHandle):
        if handle.plan is not None:
            # frame submission: the plan object is owned by the (immutable,
            # possibly shared) frame — optimize a private copy
            node = optimize(copy.deepcopy(handle.plan), self.catalog)
            return self._execute_plan(node)

        stmt = parse(handle.sql)
        if isinstance(stmt, CreateStmt):
            from ..core.session import create_table_as
            executor = self.make_executor()
            try:
                result = create_table_as(executor, self.catalog, stmt,
                                         self.default_partitions)
            finally:
                self._release_shuffles(executor)
            return result, False

        node = optimize(Binder(self.catalog).bind(stmt), self.catalog)
        return self._execute_plan(node)

    def _execute_plan(self, node: Node):
        """Result-cache probe -> execute -> fill, for an optimized plan.
        Shared by the SQL-text and frame (plan-object) submission paths, so
        the two surfaces are indistinguishable from bind onward."""
        fingerprint = deps = None
        if self.result_cache is not None:
            fingerprint, deps = plan_fingerprint(node, self.catalog)
            hit = self.result_cache.get(fingerprint, self.catalog)
            if hit is not None:
                return hit, True

        executor = self.make_executor()
        try:
            result = executor.execute(node)
            result.metrics = executor.metrics
        finally:
            self._release_shuffles(executor)
        if self.result_cache is not None:
            self.result_cache.put(fingerprint, result, deps)
            self.memory.enforce()
        return result, False

    def _release_shuffles(self, executor: Executor) -> None:
        """Shuffle map outputs are query-scoped: the result stage has fully
        consumed them once execute returns, so release their memory."""
        for shuffle_id in executor.created_shuffles:
            self.ctx.block_manager.drop_shuffle(shuffle_id)

    # -- reporting / lifecycle --------------------------------------------------

    def stats(self) -> Dict[str, object]:
        out = {"memory": self.memory.stats(),
               "scheduler": self.scheduler.stats(),
               "resilience": self.ctx.scheduler.resilience_stats()}
        if self.result_cache is not None:
            out["result_cache"] = self.result_cache.stats()
        return out

    def describe_resilience(self) -> str:
        return self.ctx.scheduler.describe_resilience()

    def shutdown(self) -> None:
        """Stop the workers, retire the storage tier (its writer joined,
        its segments and own directory removed) and release the device:
        after it the catalog, the scan cache and the result cache hold no
        CUDA tensor."""
        self.scheduler.shutdown()
        self.scan_cache.clear()
        if self.storage is not None:
            self.storage.shutdown()
        for table in self.catalog.tables().values():
            table.drop_device()
        self.ctx.shutdown()
