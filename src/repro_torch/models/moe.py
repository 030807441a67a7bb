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

The DeepSeek-V3 router (Moonlight-16B-A3B; arXiv:2412.19437 §2.1.2, its
`noaux_tc` with one group) is the same top k over other scores: the
sigmoid of the router's logits, with a fixed per-expert `select_bias`
added for the choice alone, the k chosen scores renormalised to sum 1
(plus 1e-20) and multiplied by `routed_scale`.  `moe_apply_grouped` is the
layer of one expert-parallel rank: it holds the experts [held_offset,
held_offset + held), routes every token over all `num_experts`, and
computes its own experts' part of the result, dropless, grouped by expert
(`torch._grouped_mm` over one buffer of every assignment the held experts
can get, sized without reading the counts back to the host); the absent
experts' part is left out, as the other ranks would add it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.compat import get_abstract_mesh
from ..spans import span
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
    # the router's scores, "softmax" or "sigmoid" (DeepSeek-V3)
    score: str = "softmax"
    routed_scale: float = 1.0  # the routed experts' weights times this
    select_bias: bool = False  # a fixed per-expert bias in the choice alone
    held: int = 0              # experts this layer holds (0: all of them)
    held_offset: int = 0       # the first one's id among the num_experts


_DEFAULTS = {f.name: f.default for f in dataclasses.fields(MoEConfig)}


def setting(cfg, name: str):
    """A field of `MoEConfig`, or its default where `cfg` has no such
    field (the reference's configuration, which tests hand to the port,
    has only the fields both declare)."""
    return getattr(cfg, name, _DEFAULTS[name])


def n_held(cfg) -> int:
    """The experts a layer of `cfg` holds."""
    return setting(cfg, "held") or cfg.num_experts


def is_share(cfg) -> bool:
    """Whether a layer of `cfg` holds a share of the experts, not all."""
    return n_held(cfg) != cfg.num_experts


class MoE(nn.Module):
    """One layer of `moe_init`'s parameters, as the LM's stacked layers
    draw them: `router` (d, E) float32; `w_gate`, `w_up` (E, d, d_expert)
    and `w_down` (E, d_expert, d), E the experts held (`n_held`); with
    `n_shared > 0`, `shared_gate`, `shared_up` (d, n_shared * d_expert) and
    `shared_down`; with `select_bias`, `select_bias` (num_experts,) float32
    zeros, marked `untrained`: no gradient trains it
    (`training/train_step`).  Every matrix is N(0, 1/in) (the reference's
    `stacked_dense_init`; its unstacked `moe_init` alone draws the router
    at std 0.02)."""

    def __init__(self, d_model: int, cfg: MoEConfig, dtype=torch.bfloat16,
                 device=None, generator=None):
        super().__init__()
        e = n_held(cfg)

        def mk(shape, dt=dtype):
            return _param(normal(shape, 1.0 / math.sqrt(shape[-2]), dt,
                                 device, generator))

        self.router = mk((d_model, cfg.num_experts), torch.float32)
        self.w_gate = mk((e, d_model, cfg.d_expert))
        self.w_up = mk((e, d_model, cfg.d_expert))
        self.w_down = mk((e, cfg.d_expert, d_model))
        if cfg.n_shared > 0:
            sh_ff = cfg.d_expert * cfg.n_shared
            self.shared_gate = mk((d_model, sh_ff))
            self.shared_up = mk((d_model, sh_ff))
            self.shared_down = mk((sh_ff, d_model))
        if setting(cfg, "select_bias"):
            self.select_bias = _param(torch.zeros(
                cfg.num_experts, dtype=torch.float32, device=device))
            self.select_bias.untrained = True


def capacity(t: int, cfg: MoEConfig, dropless: bool = False) -> int:
    """Slots an expert holds for t tokens: t when dropless, else
    max(1, round(t * k / E * capacity_factor))."""
    if dropless:
        return t
    return int(max(1, round(t * cfg.top_k / cfg.num_experts
                            * cfg.capacity_factor)))


def _route(xf: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
           bias=None):
    """The router over tokens xf (T, D), in float32: the gates (T, E), the
    softmax or the sigmoid of the logits; the top-k expert ids (T, k) by
    gate, or by gate plus `bias` (E,) where given; their weights, the k
    gates renormalised (softmax: over their sum clamped at 1e-9; sigmoid:
    over their sum plus 1e-20, as DeepSeek-V3's router), then times
    `routed_scale`."""
    k = cfg.top_k
    logits = xf.float() @ router                                # (T, E)
    sigmoid = setting(cfg, "score") == "sigmoid"
    if sigmoid:
        gates = torch.sigmoid(logits)
    else:
        gates = torch.softmax(logits, dim=-1)
    choice = gates if bias is None else gates + bias
    srt, idx = torch.sort(choice, dim=-1, descending=True, stable=True)
    topi = idx[:, :k]
    topw = srt[:, :k] if bias is None else torch.gather(gates, 1, topi)
    total = topw.sum(-1, keepdim=True)
    topw = topw / (total + 1e-20 if sigmoid else torch.clamp(total, min=1e-9))
    return gates, topw * setting(cfg, "routed_scale"), topi


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
    float32}.  A layer that holds a share of the experts (`is_share`)
    runs `moe_apply_grouped` instead, dropless whatever `dropless` says."""
    if is_share(cfg):
        return moe_apply_grouped(p, x, cfg, return_stats)
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    xf = x.reshape(t, d)
    gates, topw, topi = _route(xf, p.router, cfg,
                               getattr(p, "select_bias", None))
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


def _group(topi: torch.Tensor, cfg: MoEConfig):
    """The assignments (T, k) of the held experts, grouped: `order`, the
    flat assignments sorted by held expert, each expert's run in token
    order, cut to the most the held experts can get, T min(k, held);
    `offs` (held,) int32, each run's end; `pos` (T, k), each assignment's
    place in the sorted order; `mine` (T, k), whether a held expert has
    it.  All on the device: nothing is read back to the host."""
    t, k = topi.shape
    h = n_held(cfg)
    local = topi - setting(cfg, "held_offset")
    mine = (local >= 0) & (local < h)
    key = torch.where(mine, local, h).reshape(-1)               # others last
    order = torch.argsort(key, stable=True)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(t * k, device=topi.device)
    counts = torch.zeros(h + 1, dtype=torch.int64, device=topi.device) \
        .scatter_add_(0, key, torch.ones_like(key))
    offs = torch.cumsum(counts[:h], 0).to(torch.int32)
    return order[:t * min(k, h)], offs, pos.reshape(t, k), mine


@named_scope("moe")
def moe_apply_grouped(p: MoE, x: torch.Tensor, cfg: MoEConfig,
                      return_stats: bool = False):
    """x: (B, S, D) -> (B, S, D): one rank's share of a dropless layer.

    Every token is routed over all `num_experts` (`_route`, with the
    layer's `select_bias` where it has one); the assignments that land on
    the held experts are gathered into one buffer, grouped by expert
    (`_group`; its rows past the last run are zeros, and the products'
    rows there, which `_grouped_mm` leaves unwritten, are never read),
    and each held expert's SwiGLU runs over its own run of rows
    (`torch._grouped_mm`, bf16 products, the activation in float32).  Each
    token's held assignments come back in k order, weighted and summed in
    float32, with no atomics; the shared experts are added once.  With
    `return_stats`, also {"expert_load" (num_experts,) float32 over every
    expert, "frac_dropped" 0, "router_entropy"}: nothing drops."""
    b, s, d = x.shape
    t, k = b * s, cfg.top_k
    xf = x.reshape(t, d)
    with span("moe.route"):
        gates, topw, topi = _route(xf, p.router, cfg,
                                   getattr(p, "select_bias", None))
        order, offs, pos, mine = _group(topi, cfg)
        rows = order.numel()
        live = torch.arange(rows, device=x.device) < offs[-1]
        xs = torch.where(live[:, None], xf[order // k],
                         torch.zeros((), dtype=x.dtype, device=x.device))
    with span("moe.experts"):
        g = torch._grouped_mm(xs, p.w_gate, offs=offs)
        u = torch._grouped_mm(xs, p.w_up, offs=offs)
        a = F.silu(g.float()).to(x.dtype) * u
        out = torch._grouped_mm(a, p.w_down, offs=offs)         # (rows, D)
        y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
        zero = torch.zeros((), dtype=out.dtype, device=x.device)
        for j in range(k):
            yj = torch.where(mine[:, j, None],
                             out[pos[:, j].clamp(max=rows - 1)], zero)
            y = y + yj.float() * topw[:, j, None]
        y = _shared(p, x, cfg, y.to(x.dtype).reshape(b, s, d))
    if not return_stats:
        return y
    load = _expert_load(topi.reshape(-1), cfg.num_experts)
    entropy = -torch.mean(torch.sum(gates * torch.log(gates + 1e-9), -1))
    return y, {"expert_load": load,
               "frac_dropped": torch.zeros((), dtype=torch.float32,
                                           device=x.device),
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
    if is_share(cfg):
        raise NotImplementedError("expert parallelism over the mesh takes "
                                  "a layer that holds every expert")
    layout = ep_layout(x.shape, cfg)
    if layout is None:
        return moe_apply(p, x, cfg, return_stats=return_stats)
    slots, bl, sl, cap = layout
    bias = getattr(p, "select_bias", None)
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
            _, topw, topi = _route(xf, p.router.to(dev), cfg,
                                   None if bias is None else bias.to(dev))
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
    _, _, topi = _route(x.reshape(-1, d), p.router, cfg, bias)
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
