"""Mesh context (`compat.py`), the counterpart of the reference's
`repro/parallel/`: `Mesh`, `make_mesh`, `set_mesh`, `get_abstract_mesh`
and `current_axis_sizes` over device slots.

The reference's `sharding.py` (`act_shard`, `maybe_shard`,
`filter_spec`, `batch_spec`) has no counterpart.  Its helpers only
constrain where XLA places a tensor over a mesh; they change no function
the model computes, and the port places a tensor where it computes it.
So the pod meshes' per-device costs that the reference's dry run reads
from GSPMD's partitioned program stay out of the port's dry run too
(`launch/dryrun.py` counts one card's program).  The one module that
reads the mesh is `models/moe.moe_apply_ep`.
"""

from .compat import (Mesh, current_axis_sizes, get_abstract_mesh, make_mesh,
                     set_mesh, slot_devices)

__all__ = ["Mesh", "current_axis_sizes", "get_abstract_mesh", "make_mesh",
           "set_mesh", "slot_devices"]
