"""Mesh definitions, the counterpart of the reference's `launch/mesh.py`
over device slots (`parallel/compat.py`).

Axes (DESIGN.md §5):
  single pod:  (data=16, model=16)            = 256 devices
  multi pod:   (pod=2, data=16, model=16)     = 512 devices

`make_production_mesh` takes every card and raises where there are fewer
than it needs, as the reference raises over too few host devices: one
machine here has one card.  `make_debug_mesh` puts all its slots on one
device, the card by default, so that the mesh's code runs at any size
on one card or on the CPU (`device="cpu"`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.runtime import resolve_device
from ..parallel.compat import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < n:
        raise RuntimeError(f"mesh {shape} needs {n} devices but only {cards} "
                           f"cards present; make_debug_mesh puts its slots "
                           f"on one device")
    return make_mesh(shape, axes,
                     [torch.device("cuda", i) for i in range(n)])


def make_debug_mesh(data: int = 2, model: int = 2, pod: Optional[int] = None,
                    device=None) -> Mesh:
    """A small mesh of `[device] * n` slots (default: the card, raising
    without one)."""
    if pod:
        shape, axes = (pod, data, model), ("pod", "data", "model")
    else:
        shape, axes = (data, model), ("data", "model")
    return make_mesh(shape, axes, [resolve_device(device)] * math.prod(shape))
