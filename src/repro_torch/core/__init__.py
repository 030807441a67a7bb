"""Shark core: columnar SQL engine with RDD lineage fault tolerance and
Partial DAG Execution — the PyTorch/CUDA port of `repro.core` (see DESIGN.md)."""

from .types import DType, Field, Schema
from .columnar import Table, from_arrays
from .expr import (Aliased, And, Between, BinOp, Cmp, Col, Expr, Func,
                   InList, Lit, Not, Or)
from .plan import (AggFunc, AggregateNode, AggSpec, FilterNode, JoinNode,
                   JoinStrategy, LimitNode, ProjectNode, ScanNode, SortNode)
from .frame import FrameBindError, GroupedFrame, SharkFrame
from .functions import (abs_, avg, ceil, col, count, count_distinct, exp,
                        floor, length, lit, log, lower, max_, min_, sqrt,
                        substr, sum_, upper, year)
from .session import SharkSession
from .runtime import SharkContext
from .resilience import (CircuitBreaker, ResiliencePolicy,
                         ShuffleWaitTimeout, WorkerHealth)
from .faults import ChaosEngine, FaultSchedule, FaultSpec, FaultTrip

__all__ = [
    "DType", "Field", "Schema", "Table", "from_arrays",
    "Aliased", "And", "Between", "BinOp", "Cmp", "Col", "Expr", "Func",
    "InList", "Lit", "Not", "Or",
    "AggFunc", "AggregateNode", "AggSpec", "FilterNode", "JoinNode",
    "JoinStrategy", "LimitNode", "ProjectNode", "ScanNode", "SortNode",
    "SharkFrame", "GroupedFrame", "FrameBindError",
    "col", "lit", "sum_", "avg", "min_", "max_", "count", "count_distinct",
    "substr", "lower", "upper", "length", "abs_", "sqrt", "log", "exp",
    "floor", "ceil", "year",
    "SharkSession", "SharkContext",
    "ResiliencePolicy", "ShuffleWaitTimeout", "WorkerHealth",
    "CircuitBreaker",
    "ChaosEngine", "FaultSchedule", "FaultSpec", "FaultTrip",
]
