"""Server tier: concurrent multi-session query service (DESIGN.md §6), the
port of `repro.server`.

`SharkServer` owns one shared context/catalog and serves many client
sessions with weighted fair scheduling, admission control, a unified
memory budget with partition-granular LRU eviction (recompute-from-lineage
on miss), an opt-in out-of-core storage tier (spill to disk or drop, with
recompression and lineage fault-in, DESIGN.md §12), and a plan-fingerprint
query result cache invalidated by catalog epochs.  It computes on the GPU
unless the caller asks for the CPU.
"""

from .memory import MemoryManager
from .result_cache import ResultCache, plan_fingerprint
from .scheduler import AdmissionError, FairScheduler, QueryHandle
from .server import SharkServer

__all__ = ["SharkServer", "MemoryManager", "ResultCache", "plan_fingerprint",
           "AdmissionError", "FairScheduler", "QueryHandle"]
