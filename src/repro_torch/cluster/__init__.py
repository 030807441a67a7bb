"""Cluster tier (DESIGN.md §13), the port of `repro.cluster`: mesh-sharded
execution + replicated SharkServer fleet.

Two independent scale-out axes over the single-host engine:

- `mesh` — a MeshContext places catalog partitions onto an ordered list of
  torch devices ("slots"; several may share one card) and runs the
  aggregate map side on them: the colscan kernel per partition on its
  slot, and a radix exchange that ships each slot's buckets to the slot
  owning them.  Device loss mid-query re-places and recomputes
  (`DeviceLost` -> new placement generation).
- `fleet` — N full SharkServer replicas behind a routing frontend with one
  catalog-epoch protocol, so plan-fingerprint result caches stay coherent
  across replicas; a replica dying mid-query re-routes to a survivor and
  recomputes from that replica's own lineage.
"""

from .mesh import DeviceLost, MeshContext, MeshPlacement
from .fleet import FleetEpochError, ReplicaLost, SharkFleet

__all__ = ["DeviceLost", "MeshContext", "MeshPlacement", "FleetEpochError",
           "ReplicaLost", "SharkFleet"]
