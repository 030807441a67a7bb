"""Weights from the seed, drawn on the device in a few large calls.

The leaves (`spec.leaves`) are grouped into chunks of whole leaves of one
dtype, about `CHUNK` elements each; a chunk is one `torch.randn` or
`torch.rand` call of its own `torch.Generator`, seeded from (seed, chunk),
and each leaf is its slice, scaled or mapped as its `init` says.  So any
chunk can be drawn again alone: the training check reads the weights' change
after the first steps against the starting weights, drawn again a chunk at
a time, and the reference starts from the same values.

The program's model gets these values (`load`); it never draws its own.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, Tuple

import torch

from .spec import Leaf, Spec, leaves

CHUNK = 1 << 28
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def numel(leaf: Leaf) -> int:
    return math.prod(leaf.shape)


def chunks(spec: Spec) -> List[List[Leaf]]:
    """The leaves of one dtype and one kind of draw (normal or uniform) in
    their order, cut before a chunk would pass CHUNK elements (a leaf
    larger than CHUNK is a chunk of its own)."""
    out: List[List[Leaf]] = []
    size = 0
    for leaf in sorted(leaves(spec), key=_kind):
        n = numel(leaf)
        if (not out or _kind(out[-1][0]) != _kind(leaf)
                or size + n > CHUNK):
            out.append([])
            size = 0
        out[-1].append(leaf)
        size += n
    return out


def _kind(leaf: Leaf) -> Tuple[str, bool]:
    return leaf.dtype, leaf.init == "normal"


def _seed(seed: int, i: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * i + 1) % (1 << 63)


def _value(leaf: Leaf, z: torch.Tensor) -> torch.Tensor:
    """A leaf's float32 value from its slice z: N(0, 1) draws for "normal"
    leaves, U(0, 1) for the rest."""
    if leaf.init == "normal":
        return z * leaf.std
    if leaf.init == "norm":                   # norm weights and D: ~1
        return 0.8 + 0.4 * z
    if leaf.init == "conv_b":
        return 0.2 * (z - 0.5)
    if leaf.init == "A_log":                  # A = -exp(A_log) in [-16, -1]
        return torch.log(1.0 + 15.0 * z)
    if leaf.init == "dt_bias":                # softplus(dt_bias) in [1e-3, 0.1]
        dt = torch.exp(math.log(1e-3) + z * (math.log(0.1) - math.log(1e-3)))
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"{leaf.name}: unknown init {leaf.init!r}")


def draw_chunk(seed: int, i: int, group: List[Leaf], device
               ) -> Iterator[Tuple[Leaf, torch.Tensor]]:
    """(leaf, value in the leaf's dtype) for each leaf of chunk i."""
    g = torch.Generator(device=device).manual_seed(_seed(seed, i))
    draw = torch.randn if group[0].init == "normal" else torch.rand
    z = draw(sum(numel(l) for l in group), generator=g, device=device)
    off = 0
    for leaf in group:
        n = numel(leaf)
        yield leaf, _value(leaf, z[off:off + n]).view(leaf.shape).to(
            DTYPES[leaf.dtype])
        off += n


def each(spec: Spec, seed: int, device
         ) -> Iterator[Tuple[Leaf, torch.Tensor]]:
    """Every leaf with its starting value, chunk by chunk."""
    for i, group in enumerate(chunks(spec)):
        yield from draw_chunk(seed, i, group, device)


def draw_all(spec: Spec, seed: int, device, dtype=None
             ) -> Dict[str, torch.Tensor]:
    """{name: starting value}, each in its own dtype, or cast to `dtype`."""
    return {leaf.name: (v if dtype is None else v.to(dtype))
            for leaf, v in each(spec, seed, device)}


def load(spec: Spec, seed: int, params: Dict[str, torch.Tensor]) -> None:
    """Write the starting weights into the tensors `params` (the program's
    parameters by name), which must have each leaf's shape and dtype."""
    names = {leaf.name for leaf in leaves(spec)}
    if set(params) != names:
        raise ValueError(
            "the model's parameters are not the configuration's leaves: "
            f"missing {sorted(names - set(params))[:5]}, "
            f"extra {sorted(set(params) - names)[:5]}")
    device = next(iter(params.values())).device
    with torch.no_grad():
        for leaf, v in each(spec, seed, device):
            p = params[leaf.name]
            if tuple(p.shape) != leaf.shape or p.dtype != v.dtype:
                raise ValueError(f"{leaf.name}: the model has {p.dtype} "
                                 f"{tuple(p.shape)}, the configuration "
                                 f"{v.dtype} {leaf.shape}")
            p.copy_(v)


def per_leaf(spec: Spec, seed: int, device,
             fn: Callable[[Leaf, torch.Tensor], float]) -> Dict[str, float]:
    """{name: fn(leaf, starting value)}, drawing a chunk at a time."""
    return {leaf.name: fn(leaf, v) for leaf, v in each(spec, seed, device)}
