"""Carry the reference's parameters into the port.

`params_from_jax(np_params, cfg, model)` takes the reference's parameter
tree (`lm.init_params(cfg, key)[0]`) as nested dicts of numpy arrays — its
caller makes them with `jax.tree.map(np.asarray, params)` — unstacks the
leading layer axes onto the port's per-layer modules, and loads the result
into `model`, taking each array's dtype.  Names map one to one:
`{"group_mamba": {"mamba": {"in_proj": (G, n, d, o)}}}` becomes
`group_mamba.<g>.<i>.mamba.in_proj`, a dense tree's
`{"layers": {"ln1": {"w": (L, d)}}}` becomes `layers.<i>.ln1.w`, and a
vlm tree's `{"cross_layers": {"gate": (G,)}}` becomes the 0-d
`cross_layers.<g>.gate`.

numpy gives JAX's bfloat16 arrays the `ml_dtypes` bfloat16 dtype, which
`torch.from_numpy` refuses; such an array crosses as its uint16 bits and
is viewed as `torch.bfloat16` on the torch side.  `ml_dtypes` itself is
not imported (a host without JAX need not have it).

`opt_state_from_jax` carries the reference's AdamW state (step, master,
mu, nu) the same way, so a checkpoint the reference wrote restores into
the port and trains on.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from .lm import LM, check_ported

# reference tree keys whose arrays carry stacked leading layer axes
STACKED_AXES = {"layers": 1, "group_mamba": 2, "tail_mamba": 1,
                "self_layers": 2, "cross_layers": 1, "encoder": 1}


def to_torch(a) -> torch.Tensor:
    """A numpy array as a torch tensor of the same dtype and shape,
    bfloat16 and 0-d (a vlm gate) too; a tensor (a leaf restored from a
    checkpoint) as a contiguous copy."""
    if isinstance(a, torch.Tensor):
        return a.detach().clone().contiguous()
    # np.ascontiguousarray would make a 0-d array 1-d
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaves(tree, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, torch.Tensor):
        yield path, tree
    else:
        yield path, np.asarray(tree)


def state_from_jax(np_params: dict, cfg: ModelConfig
                   ) -> Dict[str, torch.Tensor]:
    """The port's state dict (CPU tensors) of a reference parameter tree."""
    check_ported(cfg)
    state = {}
    for (top, *rest), arr in _leaves(np_params):
        lead = STACKED_AXES.get(top, 0)
        for idx in np.ndindex(*arr.shape[:lead]):
            name = ".".join([top, *map(str, idx), *rest])
            state[name] = to_torch(arr[idx])
    return state


def params_from_jax(np_params: dict, cfg: ModelConfig, model: LM) -> LM:
    """Load a reference parameter tree into `model` (built from the same
    cfg), on the model's device; every parameter must be matched."""
    device = model.embed.tok.device
    state = {k: v.to(device) for k, v in state_from_jax(np_params,
                                                        cfg).items()}
    model.load_state_dict(state, strict=True, assign=True)
    return model


def opt_state_from_jax(np_opt: dict, cfg: ModelConfig, device=None
                       ) -> dict:
    """The port's AdamW state (`training.optim.init_opt_state`'s layout)
    of the reference's: its `step`, and its float32 `master`, `mu` and
    `nu` trees unstacked onto the port's parameter names as
    `state_from_jax` unstacks the parameters, on `device` (default the
    CPU).  Leaves may be numpy arrays or tensors (a restored
    checkpoint's)."""
    out = {"step": torch.as_tensor(np.asarray(np_opt["step"]),
                                   dtype=torch.int32, device=device)
           .reshape(())}
    for key in ("master", "mu", "nu"):
        out[key] = {n: t.to(device)
                    for n, t in state_from_jax(np_opt[key], cfg).items()}
    return out
