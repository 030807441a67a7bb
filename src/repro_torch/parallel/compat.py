"""The mesh context: the counterpart of the reference's
`repro/parallel/compat.py` over the port's device slots.

A `Mesh` names its axes and arranges torch devices (slots) in an n-d
array of those axes' sizes.  A device may repeat, as a `MeshContext`'s
slot may (ROADMAP, "Device slots, not ranks"): `make_mesh((2, 4),
("data", "model"), [torch.device("cpu")] * 8)` is the counterpart of the
reference's 8 host devices under
`XLA_FLAGS=--xla_force_host_platform_device_count=8`, and `[cuda:0] * 4`
is four slots sharing one card.  There is one process and no
`torch.distributed`: code that reads the mesh (`models/moe.moe_apply_ep`)
computes each slot's share on that slot's device, on its current stream.

`set_mesh(mesh)` enters a mesh for the calling thread;
`get_abstract_mesh()` returns the innermost one, or None.  Autograd may
run a backward on another thread (one per card), so code that recomputes
a forward there re-enters the mesh it saw (`models/lm._remat`).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_local = threading.local()


def slot_devices(devices: Sequence) -> list:
    """`devices` as torch devices: at least one, all of one device type
    (a ValueError otherwise), repeats allowed."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device slot")
    kinds = {d.type for d in devs}
    if len(kinds) != 1:
        raise ValueError(f"mesh slots of several device types: "
                         f"{sorted(kinds)}")
    return devs


class Mesh:
    """Named axes over an n-d array of device slots (numpy, dtype object,
    shape `axis_sizes`)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d slots for axes "
                             f"{tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {tuple(axis_names)}")
        self.devices = np.empty(devices.shape, dtype=object)
        self.devices.flat[:] = slot_devices(list(devices.flat))
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def axis_sizes(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def empty(self) -> bool:
        return self.size == 0

    def __repr__(self) -> str:
        kinds = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, slots on {kinds})"


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of `axis_shapes` over the first prod(axis_shapes) of
    `devices` (default: every card, raising without one), in order, as
    `jax.make_mesh` takes host devices.  Too few devices raise
    ValueError."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(): no CUDA device is available; pass devices="
                "[...] (e.g. [torch.device(\"cpu\")] * 8) to place slots "
                "on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = math.prod(axis_shapes)
    if n > len(devices):
        raise ValueError(f"Number of devices {len(devices)} must be >= the "
                         f"product of mesh_shape {tuple(axis_shapes)}")
    slots = np.empty(tuple(axis_shapes), dtype=object)
    slots.flat[:] = list(devices[:n])
    return Mesh(slots, axis_names)


def _stack() -> list:
    if not hasattr(_local, "meshes"):
        _local.meshes = []
    return _local.meshes


def get_abstract_mesh() -> Optional[Mesh]:
    """The mesh of the calling thread's innermost `set_mesh`, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def current_axis_sizes() -> dict:
    """axis name -> size of the active mesh ({} when no mesh is set)."""
    mesh = get_abstract_mesh()
    if mesh is None or mesh.empty:
        return {}
    return mesh.shape


@contextlib.contextmanager
def set_mesh(mesh: Optional[Mesh]):
    """Enter `mesh` for the calling thread (None: no mesh inside)."""
    stack = _stack()
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()
