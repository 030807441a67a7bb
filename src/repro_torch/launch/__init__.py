"""Command-line entry points of the port.

`serve.py`, `train.py` and `mesh.py` are the counterparts of the
reference's `launch/serve.py`, `launch/train.py` and `launch/mesh.py`
(the last over device slots, `parallel/compat.py`).  The dry run is the
counterpart of the reference's `dryrun.py`, `specs.py`, `hlo_cost.py`,
`hlo_analysis.py` and `roofline.py`: `dryrun.py` counts each cell's own
program on the meta device (`specs.py`'s stand-ins, `cost.py`'s
counter, which replaces the two HLO modules) and `roofline.py` reports
the bounds.  What stays out has nothing to count on one card: the pod
meshes' per-device costs, which come from GSPMD's sharding (the
reference's `parallel/sharding.py` and `specs.py`'s PartitionSpec
trees; the port places every tensor whole where it computes it), and
the parsing of HLO text, which the port does not produce.
"""
