"""Shark on PyTorch and CUDA: the port of the JAX package `repro`.

Three slices are in: the SQL main path (`core/`), in-engine analytics
(`ml/`) and LM serving for the `dense`, `ssm` and `hybrid` families
(`configs/`, `models/`, `serving/`, `launch/serve.py`), over twelve
hand-written Hopper kernels (`kernels/`).  Sessions and models compute on
the GPU unless the caller asks for the CPU (`SharkSession(device="cpu")`,
`build_model(cfg, device="cpu")`)."""
