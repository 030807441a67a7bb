"""Mixture-of-Experts layer: top-k routing with capacity, shared experts,
and the routing statistics (PDE-style load: `expert_load` is the paper's
heavy-hitter statistic).

Dispatch is the reference's permutation form: token -> expert assignments
sort by expert id, each assignment's slot is its rank in its expert's run,
and an (E, C, D) capacity buffer goes through the experts as three batched
matrix products.  Plain PyTorch, as the reference's is plain JAX (no
Pallas kernel on this path).  Where torch's primitives promise less than
JAX's, the port pins the reference's choice down, since each changes which
tokens drop or what they add up to:
- top-k ties: `lax.top_k` puts the lower expert first among equal gates;
  the port takes the top k of a stable descending sort;
- the sort by expert is stable (`jnp.argsort`'s default), so the last
  tokens of an overloaded expert are the ones dropped;
- `mode="drop"`: dropped assignments are scattered into one spare row
  (a buffer of cap + 1 rows) that is sliced off, and their gathered rows
  are zeroed;
- the combine: each token has exactly k assignments in order, so the
  float32 sum over them is a sum over k of (T, k, D), which is
  deterministic on the card (`index_add_` there uses atomics);
- `cap` uses Python's `round` (half to even), as the reference does.

`moe_apply_ep` (`moe_impl="ep_shardmap"`) is the reference's expert
parallelism over the device slots of the active mesh
(`parallel.set_mesh`): each slot routes its own tokens at a capacity
counted per source slot, with the same pinned choices, and the slots
exchange capacity buffers along the `model` axis (ROADMAP A.5.4).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from ..parallel.compat import get_abstract_mesh
from .common import _param, exchange, named_scope, normal, swiglu


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int            # per-expert FFN width
    n_shared: int = 0        # always-on shared experts (DeepSeek style)
    capacity_factor: float = 1.25
    first_dense: bool = False  # layer 0 uses a dense MLP (DeepSeek-V2)
    dense_d_ff: int = 0


class MoE(nn.Module):
    """One layer of `moe_init`'s parameters, as the LM's stacked layers
    draw them: `router` (d, E) float32; `w_gate`, `w_up` (E, d, d_expert)
    and `w_down` (E, d_expert, d); with `n_shared > 0`, `shared_gate`,
    `shared_up` (d, n_shared * d_expert) and `shared_down`.  Every matrix
    is N(0, 1/in) (the reference's `stacked_dense_init`; its unstacked
    `moe_init` alone draws the router at std 0.02)."""

    def __init__(self, d_model: int, cfg: MoEConfig, dtype=torch.bfloat16,
                 device=None, generator=None):
        super().__init__()
        e = cfg.num_experts

        def mk(shape, dt=dtype):
            return _param(normal(shape, 1.0 / math.sqrt(shape[-2]), dt,
                                 device, generator))

        self.router = mk((d_model, e), torch.float32)
        self.w_gate = mk((e, d_model, cfg.d_expert))
        self.w_up = mk((e, d_model, cfg.d_expert))
        self.w_down = mk((e, cfg.d_expert, d_model))
        if cfg.n_shared > 0:
            sh_ff = cfg.d_expert * cfg.n_shared
            self.shared_gate = mk((d_model, sh_ff))
            self.shared_up = mk((d_model, sh_ff))
            self.shared_down = mk((sh_ff, d_model))


def capacity(t: int, cfg: MoEConfig, dropless: bool = False) -> int:
    """Slots an expert holds for t tokens: t when dropless, else
    max(1, round(t * k / E * capacity_factor))."""
    if dropless:
        return t
    return int(max(1, round(t * cfg.top_k / cfg.num_experts
                            * cfg.capacity_factor)))


def _route(xf: torch.Tensor, router: torch.Tensor, k: int):
    """The router over tokens xf (T, D): gates (T, E) float32, the top-k
    weights renormalized and the top-k expert ids (T, k)."""
    gates = torch.softmax(xf.float() @ router, dim=-1)          # (T, E)
    srt, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    topw, topi = srt[:, :k], idx[:, :k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return gates, topw, topi


def _slots(flat_e: torch.Tensor, cap: int):
    """Each assignment's slot, its rank in its expert's run after a stable
    sort by expert, and whether the slot is within `cap`."""
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first_idx = torch.searchsorted(sorted_e, sorted_e, side="left")
    slot_sorted = torch.arange(flat_e.numel(),
                               device=flat_e.device) - first_idx
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    return slot, slot < cap


def _dispatch(xf, flat_e, slot, keep, e: int, cap: int, k: int):
    """The (E, cap, D) capacity buffer: each kept assignment's token at
    its (expert, slot); the dropped ones all go to a spare row `cap`,
    which is then sliced off."""
    buf = torch.zeros((e, cap + 1, xf.shape[1]), dtype=xf.dtype,
                      device=xf.device)
    buf[flat_e, torch.where(keep, slot, cap)] = xf.repeat_interleave(k, 0)
    return buf[:, :cap]


def _combine(out_buf, flat_e, slot, keep, topw, k: int) -> torch.Tensor:
    """Each token's k expert outputs gathered back from (E, cap, D),
    zeroed where dropped, weighted and summed over k in float32 (k
    assignments a token, in order): (T, D) float32."""
    gathered = out_buf[flat_e, torch.where(keep, slot, 0)]     # (T*k, D)
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=out_buf.dtype,
                                       device=out_buf.device))
    weighted = gathered.float() * topw.reshape(-1)[:, None]
    return weighted.reshape(-1, k, out_buf.shape[-1]).sum(dim=1)


def _expert_load(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Assignments per expert, (E,) float32: the reference's bincount of
    length E, as an int64 scatter-add, which needs no host read of the
    largest id (so it runs on the meta device too)."""
    return torch.zeros(e, dtype=torch.int64, device=flat_e.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e)).float()


def _shared(p: MoE, x: torch.Tensor, cfg: MoEConfig, y: torch.Tensor):
    """y plus the shared experts over the whole x, where there are any."""
    if cfg.n_shared == 0:
        return y
    b, s, d = x.shape
    sh = swiglu(x.reshape(b * s, d), p.shared_gate, p.shared_up,
                p.shared_down)
    return y + sh.reshape(b, s, d)


@named_scope("moe")
def moe_apply(p: MoE, x: torch.Tensor, cfg: MoEConfig,
              return_stats: bool = False, dropless: bool = False):
    """x: (B, S, D) -> (B, S, D).  Permutation dispatch with capacity drop.

    `dropless=True` sizes every expert's buffer to the worst case (one
    slot per token) so nothing drops: decode uses it, where token counts
    are tiny and batch-dependent drops would break prefill/decode
    equivalence.  With `return_stats`, also {"expert_load" (E,) float32
    assignment counts, "frac_dropped" float32, "router_entropy"
    float32}."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    xf = x.reshape(t, d)
    gates, topw, topi = _route(xf, p.router, k)
    cap = capacity(t, cfg, dropless)
    flat_e = topi.reshape(-1)                                   # (T*k,)
    slot, keep = _slots(flat_e, cap)
    buf = _dispatch(xf, flat_e, slot, keep, e, cap, k)
    # expert FFN: batched matrix products over the expert axis
    out_buf = swiglu(buf, p.w_gate, p.w_up, p.w_down)
    y = _combine(out_buf, flat_e, slot, keep, topw, k)
    y = _shared(p, x, cfg, y.to(x.dtype).reshape(b, s, d))

    if not return_stats:
        return y
    load = _expert_load(flat_e, e)
    frac_dropped = 1.0 - keep.sum() / (t * k)
    entropy = -torch.mean(torch.sum(gates * torch.log(gates + 1e-9), -1))
    return y, {"expert_load": load, "frac_dropped": frac_dropped,
               "router_entropy": entropy}


# ---------------------------------------------------------------------------
# Expert parallelism over the mesh's slots (`moe_impl="ep_shardmap"`)
# ---------------------------------------------------------------------------

def ep_layout(shape, cfg: MoEConfig):
    """How `moe_apply_ep` splits an x of `shape` (B, S, D) over the active
    mesh: (slots, B_loc, S_loc, cap_src), slots an (nb, ep) array of
    devices indexed by (batch index, `model` index), the batch axes being
    ("pod", "data"), whichever exist; None where it falls back to
    `moe_apply` (no mesh, no `model` axis, or E or S not divisible by
    the `model` axis's size)."""
    mesh = get_abstract_mesh()
    if mesh is None or mesh.empty or "model" not in mesh.axis_names:
        return None
    sizes = mesh.shape
    ep = sizes["model"]
    b, s, _ = shape
    if cfg.num_experts % ep or s % ep:
        return None
    baxes = tuple(a for a in ("pod", "data") if a in sizes)
    nb = math.prod(sizes[a] for a in baxes)
    if b % nb:
        raise ValueError(f"batch {b} does not split over the mesh's batch "
                         f"axes {baxes} of {nb} slots")
    # slots by (batch axes, model); any other axis replicates: its index 0
    axes = mesh.axis_names
    lead = [axes.index(a) for a in (*baxes, "model")]
    rest = [i for i in range(len(axes)) if i not in lead]
    slots = np.transpose(mesh.devices, lead + rest).reshape(nb, ep, -1)
    t_dev = (b // nb) * (s // ep)
    cap_src = int(max(1, round(t_dev * cfg.top_k / cfg.num_experts
                                * cfg.capacity_factor)))
    return slots[:, :, 0], b // nb, s // ep, cap_src


@named_scope("moe")
def moe_apply_ep(p: MoE, x: torch.Tensor, cfg: MoEConfig,
                 return_stats: bool = False):
    """Expert-parallel MoE: the reference's `moe_apply_ep` over the active
    mesh's slots (`parallel.set_mesh`).

    Slot (i, j) takes x[i B_loc:(i + 1) B_loc, j S_loc:(j + 1) S_loc] to
    its device and routes its own t_dev = B_loc S_loc tokens at its own
    capacity, cap_src = round(t_dev k / E capacity_factor) a source slot
    and expert, into a send buffer (ep, E_loc, cap_src, D).  The exchange
    is the tiled all-to-all along `model` within each batch row of the
    mesh: slot j receives every source's chunk j (`Tensor.to`, a no-op
    between slots of one device) and stacks them in source order, runs
    its experts [j E_loc, (j + 1) E_loc) over (E_loc, ep cap_src, D), and
    the results go back the same way.  Each slot gathers, zeroes what it
    dropped, weights in float32 and sums over k.  Shared experts then run
    on the whole x.  So the function is `moe_apply`'s only where nothing
    drops: capacity is counted per source slot.  Gradients are autograd's
    through the slot loop.

    Statistics are the reference's replicated router pass over x:
    `expert_load`, with `frac_dropped` and `router_entropy` 0.  Without a
    mesh, a `model` axis, or where E or S does not divide by its size,
    this is `moe_apply`."""
    layout = ep_layout(x.shape, cfg)
    if layout is None:
        return moe_apply(p, x, cfg, return_stats=return_stats)
    slots, bl, sl, cap = layout
    nb, ep = slots.shape
    d = x.shape[2]
    e, k = cfg.num_experts, cfg.top_k
    e_loc = e // ep
    rows = []
    for i in range(nb):
        sends, routes = [], []
        for j in range(ep):
            dev = slots[i, j]
            xf = x[i * bl:(i + 1) * bl, j * sl:(j + 1) * sl].to(dev)
            xf = xf.reshape(bl * sl, d)
            _, topw, topi = _route(xf, p.router.to(dev), k)
            flat_e = topi.reshape(-1)
            slot, keep = _slots(flat_e, cap)
            send = _dispatch(xf, flat_e, slot, keep, e, cap, k)
            sends.append(send.reshape(ep, e_loc, cap, d))
            routes.append((flat_e, slot, keep, topw))
        exchange(sends, ep)
        # slot j: its experts over every source's chunk j, in source order
        outs = []
        for j in range(ep):
            dev = slots[i, j]
            recv = torch.stack([sends[src][j].to(dev) for src in range(ep)])
            buf = recv.transpose(0, 1).reshape(e_loc, ep * cap, d)
            w = slice(j * e_loc, (j + 1) * e_loc)
            out = swiglu(buf, p.w_gate[w].to(dev), p.w_up[w].to(dev),
                         p.w_down[w].to(dev))
            outs.append(out.reshape(e_loc, ep, cap, d).transpose(0, 1))
        exchange(outs, ep)
        # and back: source slot src takes chunk src of every expert slot
        row = []
        for src in range(ep):
            dev = slots[i, src]
            back = torch.cat([outs[j][src].to(dev) for j in range(ep)])
            y = _combine(back, *routes[src], k)
            row.append(y.to(x.dtype).reshape(bl, sl, d).to(x.device))
        rows.append(torch.cat(row, dim=1))
    y = _shared(p, x, cfg, torch.cat(rows, dim=0))

    if not return_stats:
        return y
    _, _, topi = _route(x.reshape(-1, d), p.router, k)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return y, {"expert_load": _expert_load(topi.reshape(-1), e),
               "frac_dropped": zero, "router_entropy": zero.clone()}


def load_balance_loss(logits_gates_load) -> torch.Tensor:
    """Switch-style aux loss from (gates, load)."""
    gates, load = logits_gates_load
    e = gates.shape[-1]
    me = torch.mean(gates, dim=0)
    pe = load / torch.clamp(torch.sum(load), min=1.0)
    return e * torch.sum(me * pe)
