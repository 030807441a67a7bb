"""Where the estimators' host-facing helpers (`predict*`, `loss`) compute:
a tensor stays on its own device; numpy input moves to `device`, which
defaults to the device the estimator was fitted on (the session's), and
for an estimator never fitted to the card, as a `SharkSession` does."""

from __future__ import annotations

import numpy as np
import torch

from ..core.runtime import resolve_device


def as_tensor(x, device=None, fitted=None):
    """(tensor, came_from_numpy).  Numpy `x` goes to `device` when given,
    else to `fitted` (the device the estimator was fitted on), else to
    `resolve_device(None)`."""
    if isinstance(x, torch.Tensor):
        return x, False
    if device is None:
        device = fitted
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        resolve_device(device)), True


def promoted(x: torch.Tensor, p: np.ndarray):
    """x and the parameters `p` on x's device in their common dtype, as
    jnp promotes `x @ w`."""
    pt = torch.from_numpy(p).to(x.device)
    dt = torch.promote_types(x.dtype, pt.dtype)
    return x.to(dt), pt.to(dt)


def returned(t: torch.Tensor, to_numpy: bool):
    return t.cpu().numpy() if to_numpy else t
