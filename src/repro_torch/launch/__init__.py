"""Command-line entry points of the port.

`serve.py`, `train.py` and `mesh.py` are the counterparts of the
reference's `launch/serve.py`, `launch/train.py` and `launch/mesh.py`
(the last over device slots, `parallel/compat.py`).  The reference's
other launchers — `dryrun.py`, `hlo_analysis.py`, `hlo_cost.py`,
`roofline.py`, `specs.py` — lower and cost XLA programs over TPU meshes
and have no counterpart on one card.
"""
