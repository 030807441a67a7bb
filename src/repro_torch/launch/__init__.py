"""Command-line entry points of the port.

`serve.py` is the counterpart of the reference's `launch/serve.py`.  The
reference's other launchers — `dryrun.py`, `hlo_analysis.py`, `hlo_cost.py`,
`mesh.py`, `roofline.py`, `specs.py` — lower and cost XLA programs over
TPU meshes and have no counterpart on one card; `train.py` waits for
training (ROADMAP A.5).
"""
