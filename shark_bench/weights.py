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

import functools
import math
from typing import Callable, Dict, Iterator, List, Tuple

import torch

from .spec import Leaf, Spec, family, leaves

CHUNK = 1 << 28
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def numel(leaf: Leaf) -> int:
    return math.prod(leaf.shape)


def chunks(spec: Spec) -> List[List[Leaf]]:
    """The leaves of one dtype and one kind of sample (normal or uniform)
    in their order, cut before a chunk would pass CHUNK elements (a leaf
    larger than CHUNK is a chunk of its own)."""
    out: List[List[Leaf]] = []
    size = 0
    kind = functools.partial(_kind, _inits(spec))
    for leaf in sorted(leaves(spec), key=kind):
        n = numel(leaf)
        if (not out or kind(out[-1][0]) != kind(leaf)
                or size + n > CHUNK):
            out.append([])
            size = 0
        out[-1].append(leaf)
        size += n
    return out


def _inits(spec: Spec) -> dict:
    """{init: (its sample, "normal" or "uniform"; the value from it)}:
    norm weights, and the family's own (its `INITS`).  A "normal" leaf is
    N(0, std^2)."""
    return {"norm": ("uniform", lambda z: 0.8 + 0.4 * z),   # ~1
            **getattr(family(spec), "INITS", {})}


def _kind(inits: dict, leaf: Leaf) -> Tuple[str, bool]:
    if leaf.init != "normal" and leaf.init not in inits:
        raise ValueError(f"{leaf.name}: unknown init {leaf.init!r}")
    return leaf.dtype, (leaf.init == "normal"
                        or inits[leaf.init][0] == "normal")


def _seed(seed: int, i: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * i + 1) % (1 << 63)


def _value(inits: dict, leaf: Leaf, z: torch.Tensor) -> torch.Tensor:
    """A leaf's float32 value from its slice z of its sample."""
    if leaf.init == "normal":
        return z * leaf.std
    return inits[leaf.init][1](z)


def draw_chunk(spec: Spec, seed: int, i: int, group: List[Leaf], device
               ) -> Iterator[Tuple[Leaf, torch.Tensor]]:
    """(leaf, value in the leaf's dtype) for each leaf of chunk i."""
    inits = _inits(spec)
    g = torch.Generator(device=device).manual_seed(_seed(seed, i))
    draw = torch.randn if _kind(inits, group[0])[1] else torch.rand
    z = draw(sum(numel(l) for l in group), generator=g, device=device)
    off = 0
    for leaf in group:
        n = numel(leaf)
        yield leaf, _value(inits, leaf, z[off:off + n]).view(
            leaf.shape).to(DTYPES[leaf.dtype])
        off += n


def each(spec: Spec, seed: int, device
         ) -> Iterator[Tuple[Leaf, torch.Tensor]]:
    """Every leaf with its starting value, chunk by chunk."""
    for i, group in enumerate(chunks(spec)):
        yield from draw_chunk(spec, seed, i, group, device)


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
