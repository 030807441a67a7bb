"""Mesh-sharded execution over a MeshContext's device slots (DESIGN.md
§13.1).

Two dispatches, each over every placed partition at once:

- `mesh_colscan` — the fused filter+aggregate colscan of DESIGN.md §10:
  each partition's filter and aggregate columns go as float64 onto its
  slot's device, and one `colscan` kernel launch reduces them to the
  ``[count, sum, min, max]`` partial state (NaN fails both bounds; an
  empty selection gives ``[0, 0, +inf, -inf]``).  No exchange is needed —
  the partial states feed the engine's standard shuffle/merge reduce, so
  the final result is computed by exactly the code path the single-host
  oracle uses.
- `mesh_group_exchange` — the compiled exchange of DESIGN.md §11 shipped
  ACROSS slots: each slot's rows are bucketed by one `radix_split` launch
  (``mix_u32(fold(k)) % n_slots`` and the stable order, bit for bit the
  reference's hash), each destination's chunk is the slot's rows of that
  bucket in row order, and receiver d concatenates the chunks from slots
  0..n-1 in that order.  The (src, dst) counts are the kernel's own bucket
  bounds.  A chunk moves with `Tensor.to(dst_device)`: a peer copy
  between two cards, and no copy at all between slots that share one
  (the receiver's `torch.cat` is then the exchange's only copy), so
  `shipped_rows` counts rows that left their source *slot*, not bytes
  over an interconnect.  The engine's group-by passes a `reduce` that
  aggregates each receiver's rows on its device (kernel 3,
  `groupby_sum`, on a card): only the partial states come back.

On CPU slots the kernel wrappers run their plain versions; on CUDA slots
they launch the kernels or raise.

Device loss: every public entry point re-reads the placement per attempt
and retries on `DeviceLost` (chaos hook) or a generation bump observed
mid-dispatch — recomputation from host-resident partitions, the same
lineage contract as worker loss in the runtime scheduler.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.radix_partition import radix_split
from .mesh import DeviceLost, MeshContext


def _dispatch(ctx: MeshContext, run):
    """Run `run()` (which must re-read the placement itself) with the
    device-loss retry contract."""
    last: Optional[BaseException] = None
    for _ in range(ctx.max_retries + 1):
        try:
            gen0 = ctx.fire_dispatch()
            out = run()
        except DeviceLost as e:
            last = e
            with ctx.lock:
                ctx.retries += 1
            continue
        if ctx.generation != gen0:
            # a device died while the dispatch ran: the placement we used
            # is stale — recompute over the survivors
            with ctx.lock:
                ctx.retries += 1
            continue
        return out
    raise RuntimeError(
        f"mesh dispatch failed after {ctx.max_retries + 1} attempts") from last


def _on(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


# -- colscan, one kernel launch a partition on its slot ------------------------

def mesh_colscan(ctx: MeshContext, fcols: Sequence[np.ndarray],
                 acols: Sequence[np.ndarray], lo: float, hi: float
                 ) -> Tuple[List[Tuple[float, float, float, float]], Dict]:
    """Fused filter+aggregate over every placed partition, one `colscan`
    launch each on its slot.  Returns per-partition ``(count, sum, min,
    max)`` partial states (same contract as the single-host colscan route)
    plus a dispatch report."""

    def run():
        placement = ctx.place(len(fcols))
        devs = ctx.slot_devices(placement)
        by_slot: List[List[Tuple[int, torch.Tensor]]] = [[] for _ in devs]
        for p, (f, a) in enumerate(zip(fcols, acols)):
            d = placement.device_of[p]
            ft = _on(np.asarray(f, np.float64), devs[d])
            # one column as filter and aggregate is read once (the
            # kernel's one-column route)
            at = ft if a is f else _on(np.asarray(a, np.float64), devs[d])
            by_slot[d].append((p, ops.colscan(ft, at, lo, hi)))
        states: List[Tuple] = [()] * len(fcols)
        for parts in by_slot:
            if parts:       # one copy back a slot
                res = torch.stack([r for _, r in parts]).cpu().numpy()
                for (p, _), row in zip(parts, res):
                    states[p] = tuple(row)
        report = {"devices": placement.n_devices, "partitions": len(fcols),
                  "generation": placement.generation}
        return states, report

    return _dispatch(ctx, run)


# -- cross-slot radix exchange ---------------------------------------------------

def mesh_group_exchange(ctx: MeshContext, keys: Sequence[np.ndarray],
                        vals: Optional[Sequence[np.ndarray]],
                        reduce: Optional[Callable] = None
                        ) -> Tuple[List, Dict]:
    """Radix-exchange the placed partitions' (key, value) rows across
    slots: afterwards each slot owns every row whose key hashes to it.
    Returns one ``(keys, values)`` pair per slot (host numpy in the key
    and value dtypes; values is None when no value column was shipped) and
    a report with the exact (src, dst) bucket counts.

    `reduce(keys, values)`, when given, runs on each slot's received rows
    where they are (int64 keys and the values, or None, on the slot's
    device), inside the dispatch so that a retry runs it again; its
    results stand in place of the host pairs and the rows never come
    back."""
    kdtype = keys[0].dtype if keys else np.dtype(np.int64)
    vdtype = (vals[0].dtype if vals is not None and len(vals)
              else np.dtype(np.float64))

    def run():
        placement = ctx.place(len(keys))
        devs = ctx.slot_devices(placement)
        n_dev = placement.n_devices
        # per-slot concat of the placed partitions' rows
        dev_keys: List[List[np.ndarray]] = [[] for _ in range(n_dev)]
        dev_vals: List[List[np.ndarray]] = [[] for _ in range(n_dev)]
        for p, k in enumerate(keys):
            d = placement.device_of[p]
            dev_keys[d].append(k)
            if vals is not None:
                dev_vals[d].append(vals[p])
        # every slot's copies and its one radix_split launch go out before
        # the first bounds come back
        splits = []
        for s in range(n_dev):
            k = _on(np.concatenate(dev_keys[s]).astype(np.int64)
                    if dev_keys[s] else np.zeros(0, np.int64), devs[s])
            v = None
            if vals is not None:
                v = _on(np.concatenate(dev_vals[s]).astype(vdtype, copy=False)
                        if dev_vals[s] else np.zeros(0, vdtype), devs[s])
            splits.append((k, v) + tuple(radix_split(k, n_dev)))
        counts = np.zeros((n_dev, n_dev), np.int64)
        sent: List[List[Tuple]] = []        # [src][dst] -> (keys, values)
        for s, (k, v, order, bounds) in enumerate(splits):
            b = bounds.cpu().numpy().astype(np.int64)
            counts[s] = np.diff(b)
            ks = k.index_select(0, order)
            vs = v.index_select(0, order) if v is not None else None
            sent.append([
                (ks[b[d]:b[d + 1]].to(devs[d]),
                 vs[b[d]:b[d + 1]].to(devs[d]) if vs is not None else None)
                for d in range(n_dev)])
        out = []
        for d in range(n_dev):
            kd = torch.cat([sent[s][d][0] for s in range(n_dev)])
            vd = (torch.cat([sent[s][d][1] for s in range(n_dev)])
                  if vals is not None else None)
            if reduce is not None:
                out.append(reduce(kd, vd))
            else:
                out.append((kd.cpu().numpy().astype(kdtype, copy=False),
                            vd.cpu().numpy() if vd is not None else None))
        shipped = int(counts.sum() - np.trace(counts))
        report = {"devices": n_dev, "counts": counts,
                  "shipped_rows": shipped,
                  "generation": placement.generation}
        return out, report

    return _dispatch(ctx, run)
