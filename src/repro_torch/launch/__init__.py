"""Command-line entry points of the port.

`serve.py` and `train.py` are the counterparts of the reference's
`launch/serve.py` and `launch/train.py`.  The reference's other launchers
— `dryrun.py`, `hlo_analysis.py`, `hlo_cost.py`, `mesh.py`, `roofline.py`,
`specs.py` — lower and cost XLA programs over TPU meshes and have no
counterpart on one card.
"""
