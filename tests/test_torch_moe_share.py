"""The DeepSeek-V3 router and one rank's share of a dropless MoE layer
(`models/moe.py`: `_route`, `_group`, `moe_apply_grouped`), MLA's RoPE base
from its configuration, the float32 sum of the embedding's gradient
(`common.embed_lookup`), and a training step that leaves the selection
bias as it is.  Plain torch on the CPU."""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import attention as att
from repro_torch.models import common, lm
from repro_torch.models import moe as tmoe
from repro_torch.parallel import set_mesh
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

D, E, K, F = 64, 16, 3, 32
SIGMOID = tmoe.MoEConfig(num_experts=E, top_k=K, d_expert=F, n_shared=1,
                         score="sigmoid", routed_scale=2.446,
                         select_bias=True)


def _layer(cfg, seed=0, dtype=torch.float32):
    p = tmoe.MoE(D, cfg, dtype, "cpu", torch.Generator().manual_seed(seed))
    if hasattr(p, "select_bias"):
        with torch.no_grad():
            p.select_bias.copy_(0.1 * (torch.rand(
                E, generator=torch.Generator().manual_seed(seed + 1)) - 0.5))
    return p


def _share(full: tmoe.MoE, cfg, offset: int, held: int):
    """A layer holding experts [offset, offset + held) of `full`."""
    c = dataclasses.replace(cfg, held=held, held_offset=offset)
    p = tmoe.MoE(D, c, full.w_gate.dtype, "cpu")
    with torch.no_grad():
        for n, t in p.named_parameters():
            src = getattr(full, n)
            t.copy_(src[offset:offset + held] if n.startswith("w_") else src)
    return p, c


def _x(seed=3, shape=(2, 24, D)):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _plain(p, x, cfg):
    """Each token's held assignments one at a time, in float32, and the
    shared experts: what `moe_apply_grouped` computes."""
    xf = x.reshape(-1, D).float()
    _, w, idx = tmoe._route(xf, p.router, cfg, getattr(p, "select_bias",
                                                       None))
    y = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(cfg.top_k):
            e = int(idx[t, j]) - cfg.held_offset
            if 0 <= e < tmoe.n_held(cfg):
                h = torch.nn.functional.silu(xf[t] @ p.w_gate[e].float()) \
                    * (xf[t] @ p.w_up[e].float())
                y[t] += w[t, j] * (h @ p.w_down[e].float())
    sh = common.swiglu(xf, p.shared_gate.float(), p.shared_up.float(),
                       p.shared_down.float())
    return (y + sh).reshape(x.shape)


def test_default_router_is_the_softmax_one():
    """The defaults compute today's router bit for bit: softmax gates, the
    top k of a stable sort, renormalised over their sum clamped at 1e-9."""
    cfg = tmoe.MoEConfig(num_experts=E, top_k=K, d_expert=F)
    xf, router = _x().reshape(-1, D), torch.randn(D, E)
    gates, w, idx = tmoe._route(xf, router, cfg)
    want_g = torch.softmax(xf @ router, dim=-1)
    srt, order = torch.sort(want_g, dim=-1, descending=True, stable=True)
    assert torch.equal(gates, want_g) and torch.equal(idx, order[:, :K])
    assert torch.equal(w, srt[:, :K] / torch.clamp(
        srt[:, :K].sum(-1, keepdim=True), min=1e-9))


def test_bias_moves_the_choice_not_the_weights():
    p = _layer(SIGMOID)
    xf = _x().reshape(-1, D)
    s, w, idx = tmoe._route(xf, p.router, SIGMOID, p.select_bias)
    _, _, idx0 = tmoe._route(xf, p.router, SIGMOID)
    assert torch.equal(s, torch.sigmoid(xf @ p.router))
    assert not torch.equal(idx, idx0)          # the bias changes choices
    want = torch.sort(s + p.select_bias, dim=-1, descending=True,
                      stable=True).indices[:, :K]
    assert torch.equal(idx, want)
    # the weights are the chosen sigmoid scores, the bias not among them
    chosen = torch.gather(s, 1, idx)
    assert torch.allclose(w, 2.446 * chosen / (chosen.sum(-1, keepdim=True)
                                               + 1e-20), rtol=1e-6)


def test_renormalisation_then_scale():
    xf, router = _x().reshape(-1, D), torch.randn(D, E)
    _, w_norm, idx = tmoe._route(xf, router, dataclasses.replace(
        SIGMOID, routed_scale=1.0))
    s, w, _ = tmoe._route(xf, router, SIGMOID)
    raw = torch.gather(s, 1, idx)
    assert torch.allclose(w_norm.sum(-1), torch.ones(xf.shape[0]))
    assert torch.equal(w_norm, raw / (raw.sum(-1, keepdim=True) + 1e-20))
    assert torch.equal(w, w_norm * 2.446)


def test_ties_go_to_the_lower_expert():
    cfg = dataclasses.replace(SIGMOID, select_bias=False)
    router = torch.zeros(D, E)
    router[:, 5] = router[:, 9] = router[:, 2] = 1.0
    _, _, idx = tmoe._route(torch.ones(1, D), router, cfg)
    assert idx.tolist() == [[2, 5, 9]]


def test_group_sorts_the_held_assignments_by_expert():
    cfg = dataclasses.replace(SIGMOID, held=4, held_offset=8)
    topi = torch.tensor([[8, 1, 11], [3, 9, 8], [12, 11, 4], [0, 1, 2]])
    order, offs, pos, mine = tmoe._group(topi, cfg)
    assert order.numel() == 4 * 3 and offs.dtype == torch.int32
    assert offs.tolist() == [2, 3, 3, 5]       # experts 8, 9, 10, 11
    flat = topi.reshape(-1)
    assert flat[order[:5]].tolist() == [8, 8, 9, 11, 11]
    assert (order[:5] // 3).tolist() == [0, 1, 1, 0, 2]  # token order in a run
    assert torch.equal(mine, (topi >= 8) & (topi < 12))
    assert torch.equal(flat[order][pos.reshape(-1)], flat)


@pytest.mark.parametrize("offset,held", [(0, 16), (4, 4), (12, 4), (0, 8)])
def test_grouped_layer_is_the_plain_sum(offset, held):
    full = _layer(SIGMOID)
    p, cfg = _share(full, SIGMOID, offset, held)
    x = _x()
    got = tmoe.moe_apply_grouped(p, x, cfg)
    assert torch.allclose(got, _plain(p, x, cfg), rtol=1e-5, atol=1e-5)
    if held < E:                       # a share routes grouped by itself
        assert torch.equal(tmoe.moe_apply(p, x, cfg), got)


def test_shares_add_up_to_the_uncut_layer():
    """Four ranks of four experts: their outputs, each with the shared
    experts, less the shared experts counted three times too many, are the
    layer that holds all 16.  Each rank's router keeps all 16 outputs."""
    full = _layer(SIGMOID)
    x = _x()
    whole = tmoe.moe_apply_grouped(full, x, SIGMOID)
    shared = common.swiglu(x.reshape(-1, D), full.shared_gate,
                           full.shared_up,
                           full.shared_down).reshape(x.shape)
    total = torch.zeros_like(whole)
    for offset in (0, 4, 8, 12):
        p, cfg = _share(full, SIGMOID, offset, 4)
        assert p.router.shape == (D, E) and p.w_gate.shape[0] == 4
        total = total + tmoe.moe_apply(p, x, cfg)
    assert torch.allclose(total - 3 * shared, whole, rtol=1e-5, atol=1e-5)


def test_grouped_gradients_are_the_plain_ones():
    """The gradients through the grouped products, whose rows past the last
    run hold whatever the buffer held, are the plain sum's, and finite."""
    full = _layer(SIGMOID)
    p, cfg = _share(full, SIGMOID, 4, 4)
    x = _x().requires_grad_(True)
    params = [t.requires_grad_(True) for t in p.parameters()
              if t is not p.select_bias]
    got = torch.autograd.grad(tmoe.moe_apply(p, x, cfg).square().sum(),
                              [x] + params)
    want = torch.autograd.grad(_plain(p, x, cfg).square().sum(),
                               [x] + params)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.allclose(g, w, rtol=1e-4, atol=1e-4)


def test_bf16_grouped_layer_is_near_the_plain_sum():
    full = _layer(SIGMOID, dtype=torch.bfloat16)
    p, cfg = _share(full, SIGMOID, 8, 4)
    x = _x().to(torch.bfloat16)
    got = tmoe.moe_apply(p, x, cfg).float()
    want = _plain(p, x, cfg)
    assert float((got - want).norm() / want.norm()) < 2e-2


def test_share_over_the_mesh_is_refused():
    cfg = dataclasses.replace(SIGMOID, held=4)
    p = tmoe.MoE(D, cfg, torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="every expert"):
        tmoe.moe_apply_ep(p, _x(), cfg)


def test_mesh_routes_with_the_selection_bias():
    """Expert parallelism over a mesh of CPU slots chooses by score plus
    bias, as `moe_apply` does: where nothing drops the two agree."""
    cfg = dataclasses.replace(SIGMOID, capacity_factor=16.0)
    p = _layer(cfg)
    x = _x(shape=(2, 16, D))
    with set_mesh(make_debug_mesh(2, 4, device="cpu")):
        got, st = tmoe.moe_apply_ep(p, x, cfg, return_stats=True)
    want, want_st = tmoe.moe_apply(p, x, cfg, return_stats=True)
    assert float(want_st["frac_dropped"]) == 0.0
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(st["expert_load"], want_st["expert_load"])
    _, _, unbiased = tmoe._route(x.reshape(-1, D), p.router, cfg)
    assert not torch.equal(st["expert_load"], tmoe._expert_load(
        unbiased.reshape(-1), E))


def test_mla_rope_angles_at_the_configured_base():
    """q's RoPE part is rotated by halves at angle pos / theta^(2i / 64)
    with the configuration's base (Moonlight: 50,000), not 10,000."""
    g = torch.Generator().manual_seed(0)
    p = att.MLA(D, 2, 16, 8, 64, 8, torch.float32, "cpu", g)
    x = torch.randn(1, 40, D, generator=g)
    pos = torch.arange(40)[None]
    _, q_rope, _, k_rope = att._mla_qkv(p, x, pos, 2, 8, 64, 50000.0)
    q = (x @ p.wq).reshape(1, 40, 2, 72)[..., 8:]
    i = torch.arange(32, dtype=torch.float64)
    ang = torch.arange(40, dtype=torch.float64)[:, None] \
        * 50000.0 ** (-2.0 * i / 64)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    q1, q2 = q[..., :32].double(), q[..., 32:].double()
    want = torch.cat([q1 * cos - q2 * sin, q2 * cos + q1 * sin], dim=-1)
    assert torch.allclose(q_rope[0].double(), want[0], atol=1e-5)
    _, q10k, _, _ = att._mla_qkv(p, x, pos, 2, 8, 64, 10000.0)
    assert not torch.allclose(q10k, q_rope, atol=1e-2)
    assert k_rope.shape == (1, 40, 1, 64)


def test_mla_attention_reads_its_base():
    g = torch.Generator().manual_seed(0)
    p = att.MLA(D, 2, 16, 8, 8, 8, torch.float32, "cpu", g)
    x = torch.randn(1, 32, D, generator=g)
    pos = torch.arange(32)[None]
    default = att.mla_attention(p, x, pos, 2, 8, 8, 8)
    assert torch.equal(default, att.mla_attention(p, x, pos, 2, 8, 8, 8,
                                                  rope_theta=10000.0))
    assert not torch.allclose(default, att.mla_attention(
        p, x, pos, 2, 8, 8, 8, rope_theta=50000.0))


def test_embedding_gradient_sums_in_float32():
    """One id repeated 4,000 times: its bfloat16 gradient row is the float64
    sum of the 4,000 rows within one bfloat16 rounding (added into bfloat16
    one at a time it lost most of its sum)."""
    g = torch.Generator().manual_seed(0)
    table = torch.nn.Parameter(torch.randn(10, 256, generator=g)
                               .to(torch.bfloat16))
    emb = common.Embed.__new__(common.Embed)
    torch.nn.Module.__init__(emb)
    emb.tok = table
    tokens = torch.full((2, 2000), 3)
    tokens[0, :7] = 5
    up = (torch.rand(2, 2000, 256, generator=g) + 0.5).to(torch.bfloat16)
    (grad,) = torch.autograd.grad(common.embed_lookup(emb, tokens), [table],
                                  up)
    assert grad.dtype == torch.bfloat16
    want = up.double().reshape(-1, 256)[tokens.reshape(-1) == 3].sum(0)
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs())) - 7)
    assert ((grad[3].double() - want).abs() <= ulp).all()
    assert torch.equal(grad[0], torch.zeros(256, dtype=torch.bfloat16))
    assert torch.equal(common.embed_lookup(emb, tokens), table[tokens])


def test_training_leaves_the_selection_bias():
    cfg = ModelConfig(
        name="moonlight-tiny", family="moe", n_layers=3, d_model=D,
        n_heads=4, n_kv_heads=4, d_ff=F, vocab=128,
        mla=MLAConfig(kv_lora=32, nope_dim=16, rope_dim=8, v_dim=16,
                      rope_theta=50000.0),
        moe=dataclasses.replace(SIGMOID, first_dense=True, dense_d_ff=128,
                                held=4, held_offset=4))
    m = lm.build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in m.layers:
            layer.moe.select_bias.uniform_(-0.05, 0.05)
    bias = {n: p.clone() for n, p in m.named_parameters()
            if n.endswith("select_bias")}
    before = {n: p.clone() for n, p in m.named_parameters()}
    step = make_train_step(cfg, AdamWConfig())
    opt = init_opt_state(dict(m.named_parameters()))
    tok = torch.randint(0, 128, (2, 32), generator=torch.Generator()
                        .manual_seed(1))
    m, opt, met = step(m, opt, {"tokens": tok, "labels": tok})
    assert math.isfinite(float(met["loss"]))
    params = dict(m.named_parameters())
    assert len(bias) == 2
    for n, b in bias.items():
        assert torch.equal(params[n], b) and not params[n].requires_grad
        assert torch.equal(opt["master"][n], b)
    moved = [n for n in before if not torch.equal(params[n], before[n])]
    assert len(moved) == len(before) - len(bias)
