"""SharkSession — the user-facing entry point (paper §2, §4.1; DESIGN.md §7).

    sess = SharkSession(num_workers=8)
    sess.create_table("logs", schema, data)          # load into memory store
    res = sess.sql("SELECT pageURL, pageRank FROM rankings WHERE pageRank > 100")
    top = sess.table("rankings").filter(col("pageRank") > 100)   # fluent

Both query surfaces return a `SharkFrame` over the same logical plan:
`sql()` executes eagerly (back-compat — the frame doubles as the old
ExecResult) unless `lazy=True`; `table()` starts a lazy fluent chain.
Either way `.to_rdd()` hands the *query plan as an RDD* rather than
collected rows: ML invokes distributed computation over it (Listing 1 of
the paper), the whole pipeline shares one lineage graph, and recovery
spans SQL and ML.

A session computes on the GPU unless the caller asks for the CPU
(`device="cpu"`).  Attaching to a shared SharkServer (`server=`, DESIGN.md
§6) waits for the server tier's port and raises until then.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from .catalog import Catalog, ExternalSource
from .columnar import Table, from_arrays
from .batch import PartitionBatch
from .frame import SharkFrame
from .pde import PDEConfig
from .physical import ExecResult, Executor
from .plan import Node, explain, optimize
from .rdd import RDD
from .runtime import SharkContext
from .sql import Binder, CreateStmt, SelectStmt, parse
from .types import Schema


def resolve_device(device=None):
    """The torch device a session computes on.  None means "cuda", which
    raises when no card is present: a session never moves to the CPU
    unless asked."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "SharkSession: no CUDA device is available; pass device=\"cpu\" "
            "to run on the CPU")
    return dev


class SharkSession:
    def __init__(self, num_workers: int = 8, max_threads: int = 8,
                 enable_pde: bool = True, enable_map_pruning: bool = True,
                 default_partitions: int = 8,
                 default_shuffle_buckets: int = 64,
                 pde_config: Optional[PDEConfig] = None,
                 speculation: bool = True,
                 task_launch_overhead_s: float = 0.0,
                 server=None, client_id: Optional[str] = None,
                 weight: float = 1.0, backend: str = "compiled",
                 exchange: str = "coded", mesh=None,
                 stage_fusion: str = "on", resilience=None, device=None):
        # the device compiled routes and kernels run on: the GPU unless the
        # caller asks for the CPU (the CPU tests pass device="cpu")
        self.device = resolve_device(device)
        self.server = None
        if server is not None:
            raise NotImplementedError(
                "server=: the server tier is not ported yet (ROADMAP queue A, "
                "server and storage tier)")
        self.client_id = client_id or "local"
        self.ctx = SharkContext(num_workers=num_workers,
                                max_threads=max_threads,
                                speculation=speculation,
                                task_launch_overhead_s=task_launch_overhead_s,
                                policy=resilience)
        self.catalog = Catalog()
        self.default_partitions = default_partitions
        self.executor = Executor(
            self.ctx, self.catalog, pde_config or PDEConfig(),
            enable_pde=enable_pde, enable_map_pruning=enable_map_pruning,
            default_shuffle_buckets=default_shuffle_buckets,
            backend=backend, exchange=exchange, mesh=mesh,
            stage_fusion=stage_fusion, device=self.device)

    # -- data loading ---------------------------------------------------------

    def create_table(self, name: str, schema: Schema,
                     data: Dict[str, np.ndarray],
                     num_partitions: Optional[int] = None,
                     distribute_by: Optional[str] = None) -> Table:
        """Distributed load into the columnar memory store (§3.3)."""
        table = from_arrays(name, schema, data,
                            num_partitions or self.default_partitions,
                            distribute_by)
        self.catalog.register_table(table)
        return table

    def register_external(self, src: ExternalSource) -> None:
        self.catalog.register_external(src)

    # -- query construction / execution -----------------------------------------

    def table(self, name: str) -> SharkFrame:
        """Start a fluent SharkFrame query over a catalog table."""
        return SharkFrame.table(self, name)

    def plan(self, sql: str) -> Node:
        stmt = parse(sql)
        if isinstance(stmt, CreateStmt):
            stmt = stmt.select
        return Binder(self.catalog).bind(stmt)

    def explain(self, sql: str) -> str:
        node = optimize(self.plan(sql), self.catalog)
        return explain(node)

    def sql(self, sql: str, lazy: bool = False) -> SharkFrame:
        """Parse + bind `sql` into a SharkFrame — text queries and fluent
        queries are the same object from bind onward.  By default the frame
        is executed eagerly (the historical contract: `sql()` returned a
        finished result); pass `lazy=True` to defer execution, e.g. to
        extend the plan or hand it to ML via `.to_rdd()`."""
        stmt = parse(sql)
        if isinstance(stmt, CreateStmt):
            result = self._create_table_as(stmt)
            node = Binder(self.catalog).bind(stmt.select)
            return SharkFrame(self, node, result=result)
        node = Binder(self.catalog).bind(stmt)
        frame = SharkFrame(self, node)
        if not lazy:
            frame.collect()
        return frame

    def sql_np(self, sql: str) -> Dict[str, np.ndarray]:
        return self.sql(sql).to_numpy()

    def sql2rdd(self, sql: str) -> Tuple[RDD, List[str]]:
        """Deprecated shim over `sess.sql(sql, lazy=True).to_rdd()`.

        Returns the query plan as a lazy TableRDD plus its column names
        (paper §4.1).  The frame path registers the RDD's shuffle map
        outputs on this session's executor, so `release_shuffles()` /
        `shutdown()` frees them."""
        warnings.warn(
            "sql2rdd() is deprecated; use sess.sql(query, lazy=True)"
            ".to_rdd() or a fluent sess.table(...) chain",
            DeprecationWarning, stacklevel=2)
        stmt = parse(sql)
        assert isinstance(stmt, SelectStmt), "sql2rdd takes a SELECT"
        frame = SharkFrame(self, Binder(self.catalog).bind(stmt))
        return frame.to_rdd(), frame.columns

    # -- CTAS / caching ---------------------------------------------------------

    def _create_table_as(self, stmt: CreateStmt) -> ExecResult:
        return create_table_as(self.executor, self.catalog, stmt,
                               self.default_partitions)

    def metrics(self):
        return self.executor.metrics

    def scheduler_metrics(self) -> Dict[str, int]:
        s = self.ctx.scheduler
        return {"tasks_launched": s.tasks_launched,
                "tasks_speculated": s.tasks_speculated,
                "tasks_recomputed": s.tasks_recomputed}

    def describe_resilience(self) -> str:
        return self.ctx.scheduler.describe_resilience()

    def release_shuffles(self):
        """Drop shuffle map outputs created by this session's executor
        (sql2rdd compilations).  Any RDD previously returned by sql2rdd must
        not be collect()ed again afterwards without re-running the query."""
        for shuffle_id in self.executor.created_shuffles:
            self.ctx.block_manager.drop_shuffle(shuffle_id)
        self.executor.created_shuffles.clear()

    def shutdown(self):
        self.ctx.shutdown()


def create_table_as(executor: Executor, catalog: Catalog, stmt: CreateStmt,
                    default_partitions: int) -> ExecResult:
    """CREATE TABLE ... AS SELECT: execute, re-partition, register.  The
    catalog registration bumps the table's version (epoch)."""
    sel = stmt.select
    node = Binder(catalog).bind(sel)
    result = executor.execute(node)
    num_parts = default_partitions
    distribute = sel.distribute_by
    if "copartition" in stmt.properties:
        other = catalog.get(stmt.properties["copartition"])
        num_parts = other.num_partitions
    if distribute is None and "copartition" in stmt.properties:
        raise ValueError("copartition requires DISTRIBUTE BY")
    # shark.cache => keep in the memory store (all our tables are
    # in-memory; uncached CTAS still registers but could be spilled)
    register_result_as_table(catalog, stmt.name, result, num_parts,
                             distribute)
    return result


def register_result_as_table(catalog: Catalog, name: str, result: ExecResult,
                             num_partitions: int,
                             distribute_by: Optional[str]) -> Table:
    """Re-partition a query result into the columnar store and register it
    (shared by CTAS and `SharkFrame.cache()`)."""
    merged = PartitionBatch.concat(result.batches)
    data = merged.decoded()
    schema = _infer_schema(data, result.schema_names)
    table = from_arrays(name, schema, data, num_partitions, distribute_by)
    catalog.register_table(table)
    return table


def _infer_schema(data: Dict[str, np.ndarray], names: List[str]) -> Schema:
    from .types import DType, Field
    fields = []
    for n in names:
        v = np.asarray(data[n])
        if v.dtype.kind in ("U", "S", "O"):
            dt = DType.STRING
        elif v.dtype.kind == "b":
            dt = DType.BOOL
        elif v.dtype.kind == "f":
            dt = DType.FLOAT64 if v.dtype.itemsize == 8 else DType.FLOAT32
        elif v.dtype.itemsize <= 4:
            dt = DType.INT32
        else:
            dt = DType.INT64
        fields.append(Field(n, dt))
    return Schema(tuple(fields))
