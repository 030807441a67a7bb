"""The port's MoE layer (`models/moe.py`), MLA (`models/attention.py`) and
the `moe` family's `check_ported` rules against the JAX reference, on the
CPU (expert parallelism under a mesh: tests/test_torch_moe_ep.py).

Each comparison feeds the same numpy inputs, made from a seed, to the
reference function (jitted, float32) and to the port's, with the
reference's parameters carried over.  Tolerances, relative to the
reference tensor's max magnitude: outputs and caches to 1e-5; the routing
statistics `expert_load` exactly equal and, where assignments drop,
`frac_dropped` exactly equal (they count which assignments the capacity
drops; where none drops, the port's is 0 and the jitted reference's is
within one float32 ulp of it), `router_entropy` to 1e-5.

The MoE layer runs at the DeepSeek-V2-Lite smoke size (d 64, 8 experts of
32, top-2) in four routings, each with 0 and 2 shared experts:
- `drops`: capacity factor 1.25 and an input that overloads experts (a
  shared direction in every token, so the router favours a few experts);
- `drop_free`: capacity factor E / k (the smoke variants' own);
- `dropless`: the overloaded input with `dropless=True` (decode's);
- `tied`: a zero router, so every gate ties and `lax.top_k`'s tie order
  (the lower expert first) decides, and the capacity drops the last
  tokens of experts 0 and 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jatt
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import attention as tatt
from repro_torch.models import convert, lm
from repro_torch.models import moe as tmoe

B, S = 2, 37
DS = "deepseek-v2-lite-16b-smoke"
PHI = "phi3.5-moe-42b-a6.6b-smoke"
ROUTINGS = ("drops", "drop_free", "dropless", "tied")


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


def _load(module, tree):
    module.load_state_dict({k: convert.to_torch(np.asarray(v))
                            for k, v in tree.items()}, strict=True)
    return module


@pytest.mark.parametrize("n_shared", [0, 2])
@pytest.mark.parametrize("routing", ROUTINGS)
def test_moe_apply_matches_reference(routing, n_shared):
    d = get_config(DS).d_model
    cfg = dataclasses.replace(get_config(DS).moe, n_shared=n_shared,
                              capacity_factor=1.25)
    if routing == "drop_free":
        cfg = dataclasses.replace(
            cfg, capacity_factor=float(cfg.num_experts) / cfg.top_k)
    params, _ = jmoe.moe_init(jax.random.PRNGKey(3), d, cfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    if routing == "tied":
        params["router"] = jnp.zeros_like(params["router"])
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    if routing in ("drops", "dropless"):
        x = x + 3.0 * rng.normal(size=(1, 1, d)).astype(np.float32)
    dropless = routing == "dropless"

    want_y, want = jax.jit(
        lambda p, v: jmoe.moe_apply(p, v, cfg, return_stats=True,
                                    dropless=dropless))(params,
                                                        jnp.asarray(x))
    p = _load(tmoe.MoE(d, cfg, torch.float32, "cpu"), params)
    got_y, got = tmoe.moe_apply(p, torch.from_numpy(x), cfg,
                                return_stats=True, dropless=dropless)

    assert got_y.shape == (B, S, d) and got_y.dtype == torch.float32
    assert _rel(got_y, want_y) < 1e-5
    np.testing.assert_array_equal(got["expert_load"].numpy(),
                                  np.asarray(want["expert_load"]))
    assert got["frac_dropped"].dtype == torch.float32
    assert _rel(got["router_entropy"], want["router_entropy"]) < 1e-5
    if routing in ("drops", "tied"):
        assert float(want["frac_dropped"]) > 0, \
            "the case must drop assignments"
        assert float(got["frac_dropped"]) == float(want["frac_dropped"])
    else:
        # nothing drops: the port's 1 - kept / (T k) is 0; the jitted
        # reference multiplies by a rounded reciprocal, 1 float32 ulp off
        assert float(got["frac_dropped"]) == 0.0
        assert abs(float(want["frac_dropped"])) <= 2.0 ** -23
    if routing == "tied":
        load = np.zeros(cfg.num_experts, np.float32)
        load[:cfg.top_k] = B * S
        np.testing.assert_array_equal(got["expert_load"].numpy(), load)
    # the output without statistics is the same tensor
    assert torch.equal(tmoe.moe_apply(p, torch.from_numpy(x), cfg,
                                      dropless=dropless), got_y)


def test_capacity_rounds_half_to_even():
    cfg = tmoe.MoEConfig(num_experts=8, top_k=2, d_expert=4,
                         capacity_factor=1.25)
    # 20 * 2 / 8 * 1.25 = 6.25 -> 6; 36 -> 11.25 -> 11; 4 -> 1.25 -> 1
    assert [tmoe.capacity(t, cfg) for t in (20, 36, 4)] == [6, 11, 1]
    half = dataclasses.replace(cfg, capacity_factor=1.0)
    # 10 * 2 / 8 = 2.5 -> 2 (half to even), 14 -> 3.5 -> 4
    assert [tmoe.capacity(t, half) for t in (10, 14)] == [2, 4]
    assert tmoe.capacity(3, cfg, dropless=True) == 3
    assert tmoe.capacity(1, dataclasses.replace(cfg, capacity_factor=0.1)) \
        == 1


def test_load_balance_loss_matches_reference():
    rng = np.random.default_rng(5)
    gates = rng.dirichlet(np.ones(8), size=40).astype(np.float32)
    load = rng.integers(0, 20, 8).astype(np.float32)
    want = jmoe.load_balance_loss((jnp.asarray(gates), jnp.asarray(load)))
    got = tmoe.load_balance_loss((torch.from_numpy(gates),
                                  torch.from_numpy(load)))
    assert _rel(got, want) < 1e-6


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla(seed, s):
    cfg = get_config(DS)
    m = cfg.mla
    params, _ = jatt.mla_init(jax.random.PRNGKey(seed), cfg.d_model,
                              cfg.n_heads, m.kv_lora, m.nope_dim, m.rope_dim,
                              m.v_dim)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    p = _load(tatt.MLA(cfg.d_model, cfg.n_heads, m.kv_lora, m.nope_dim,
                       m.rope_dim, m.v_dim, torch.float32, "cpu"), params)
    x = np.random.default_rng(seed + 1).normal(
        size=(B, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (B, s))
    return cfg, m, params, p, x, pos


@pytest.mark.parametrize("s, kv_chunk", [(32, 32), (32, 8), (36, 12),
                                         (37, 64)])
def test_mla_attention_matches_reference(s, kv_chunk):
    """One chunk (32 / 32; 37 under a chunk of 64, which the reference
    takes as one chunk of 37) and several (32 / 8, 36 / 12): the output
    and the compressed caches (c_kv, k_rope)."""
    cfg, m, params, p, x, pos = _mla(6, s)
    args = (cfg.n_heads, m.nope_dim, m.rope_dim, m.v_dim, kv_chunk, True)
    want_y, (want_c, want_r) = jax.jit(
        lambda pp, v, q: jatt.mla_attention(pp, v, q, *args))(
            params, jnp.asarray(x), jnp.asarray(pos))
    got_y, (got_c, got_r) = tatt.mla_attention(
        p, torch.from_numpy(x), torch.from_numpy(np.array(pos)), *args)
    assert got_y.shape == (B, s, cfg.d_model)
    assert got_c.shape == (B, s, m.kv_lora) and got_r.shape == (B, s,
                                                                m.rope_dim)
    assert _rel(got_y, want_y) < 1e-5
    assert _rel(got_c, want_c) < 1e-5
    assert _rel(got_r, want_r) < 1e-5


def test_mla_attention_takes_a_short_last_chunk():
    """S = 37 over chunks of 8 (the reference asserts S % kv_chunk == 0):
    the same function as one chunk, to float32 rounding."""
    cfg, m, params, p, x, pos = _mla(7, S)
    args = (cfg.n_heads, m.nope_dim, m.rope_dim, m.v_dim)
    xt, post = torch.from_numpy(x), torch.from_numpy(np.array(pos))
    one = tatt.mla_attention(p, xt, post, *args, kv_chunk=S)
    many = tatt.mla_attention(p, xt, post, *args, kv_chunk=8)
    assert _rel(many, one.numpy()) < 1e-6


@pytest.mark.parametrize("cur_len", [0, 20, 36])
def test_mla_decode_matches_reference(cur_len):
    """One token against caches of 40 rows holding cur_len valid entries
    (drawn from a seed; the rows past cur_len hold stale values, which the
    length mask must hide): the output and both updated caches."""
    cfg, m, params, p, x, _ = _mla(8, 1)
    rng = np.random.default_rng(9)
    ckv = rng.normal(size=(B, 40, m.kv_lora)).astype(np.float32)
    kr = rng.normal(size=(B, 40, m.rope_dim)).astype(np.float32)
    args = (cfg.n_heads, m.nope_dim, m.rope_dim, m.v_dim)
    want_y, (want_c, want_r) = jax.jit(
        lambda pp, v, c, r, n: jatt.mla_decode(pp, v, c, r, n, *args))(
            params, jnp.asarray(x), jnp.asarray(ckv), jnp.asarray(kr),
            jnp.int32(cur_len))
    got_c, got_r = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    got_y = tatt.mla_decode(p, torch.from_numpy(x), got_c, got_r, cur_len,
                            *args)
    assert got_y.shape == (B, 1, cfg.d_model)
    assert _rel(got_y, want_y) < 1e-5
    assert _rel(got_c, want_c) < 1e-5 and _rel(got_r, want_r) < 1e-5
    # only row cur_len was written, in place
    keep = np.ones(40, bool)
    keep[cur_len] = False
    np.testing.assert_array_equal(got_c.numpy()[:, keep], ckv[:, keep])


# ---------------------------------------------------------------------------
# check_ported on the moe family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [DS, PHI])
def test_expert_parallelism_raises(name):
    """Named for when expert parallelism raised: `moe_impl="ep_shardmap"`
    now builds, and with no mesh its prefill and decode are `moe_apply`'s
    bit for bit (tests/test_torch_moe_ep.py holds it to the reference's
    EP under a mesh)."""
    cfg = dataclasses.replace(get_config(name), moe_impl="ep_shardmap")
    model = lm.build_model(cfg, "cpu")
    lm.check_ported(cfg)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (B, 4)).astype(np.int64))
    outs = []
    for c in (cfg, get_config(name)):
        logits, caches = lm.prefill_fn(c, model, {"tokens": toks}, 8)
        step, _ = lm.decode_fn(c, model, toks[:, :1], caches, 4)
        outs.append((logits, step, *caches.values()))
    for got, want in zip(*outs):
        assert torch.equal(got, want)


@pytest.mark.parametrize("kw", [dict(kv_cache_quant=True),
                                dict(attn_scores_dtype="bf16")])
def test_mla_moe_reads_no_cache_option(kw):
    """An MLA model caches (c_kv, k_rope) and scores in float32 whatever
    the two fields say (the reference's `_grow_caches` quantizes only a
    `k` cache, and its decode takes the MLA branch first): the port builds
    it, and its logits and caches equal the reference's under the same
    configuration."""
    name = DS
    jcfg = dataclasses.replace(jget_config(name), **kw)
    cfg = dataclasses.replace(get_config(name), **kw)
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(11))
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                    lm.build_model(cfg, "cpu"))
    toks = np.random.default_rng(12).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    jl, jc = jlm.prefill_fn(jcfg, params, {"tokens": jnp.asarray(toks)},
                            S + 4)
    tl, tc = lm.prefill_fn(cfg, model, {"tokens": torch.from_numpy(toks)},
                           S + 4)
    assert sorted(tc) == sorted(jc) == ["ckv", "k0", "kr", "v0"]
    assert _rel(tl, jl) < 1e-4
    for k in jc:
        assert _rel(tc[k], jc[k]) < 1e-4, k
    tok = jnp.argmax(jl[:, 0], -1).astype(jnp.int32)[:, None]
    jd, _ = jlm.decode_fn(jcfg, params, tok, jc, jnp.int32(S))
    td, _ = lm.decode_fn(cfg, model, torch.from_numpy(np.array(tok)), tc, S)
    assert _rel(td, jd) < 1e-4


def test_router_statistics_are_collected_per_layer():
    """`_backbone_full(stats=[])` collects each MoE layer's statistics; at
    a capacity factor of 1.25 their `frac_dropped` sum (the reference's
    `aux`) equals the reference's, exactly."""
    name = DS
    jcfg, cfg = jget_config(name), get_config(name)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=1.25))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25))
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(13))
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                    lm.build_model(cfg, "cpu"))
    toks = np.random.default_rng(14).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    _, _, aux = jax.jit(lambda p, t: jlm._backbone_full(
        jcfg, p, t, {}, collect_kv=False))(params, jnp.asarray(toks))
    stats = []
    lm._backbone_full(cfg, model, torch.from_numpy(toks), stats=stats)
    assert len(stats) == cfg.n_layers - 1
    total = sum(float(st["frac_dropped"]) for st in stats)
    assert abs(total - float(aux)) < 1e-6
    for st in stats:
        assert float(st["expert_load"].sum()) == B * S * cfg.moe.top_k


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b-smoke",
                                  "deepseek-v2-lite-16b-smoke"])
def test_moe_loss_leaves_nothing_alive(name, backward):
    """A MoE model's training loss under remat frees the model once the
    model and the loss are dropped, with or without its backward.  The
    layers' statistics carry an autograd graph (`router_entropy`), whose
    checkpoint must not hold a closure that holds the statistics: such a
    cycle runs through autograd's C++ nodes, which the garbage collector
    cannot see, and kept every parameter alive."""
    import gc
    import weakref
    cfg = get_config(name)
    model = lm.build_model(cfg, "cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    refs = [weakref.ref(p) for p in model.parameters()]
    toks = torch.zeros(2, 16, dtype=torch.int32)
    loss = lm.loss_fn(cfg, model, {"tokens": toks, "labels": toks})
    if backward:
        loss.backward()
    del model, loss, p
    gc.collect()
    assert [r for r in refs if r() is not None] == []
