"""Twins of tests/test_pde_moe.py on the port: PDE-style MoE replanning,
where the observed expert loads (the paper's heavy hitters, §3.1) drive
the capacity factor and the dispatch.

Each body runs on the port's `training/pde_moe.py`; where the reference
sees the same loads, the port's plan must equal the reference's (the
same one-byte history, the same capacity bucket, hot experts and
reason)."""

import numpy as np

from repro.training.pde_moe import MoEReplanner as JMoEReplanner
from repro_torch.training.pde_moe import (CAPACITY_BUCKETS, MoEPlan,
                                          MoEReplanner)


def _same_plan(rp, loads, tokens, **kw):
    """The reference's replanner fed the same loads plans the same."""
    jrp = JMoEReplanner(rp.num_experts, rp.top_k, **kw)
    for load in loads:
        jrp.observe(load)
    got, want = rp.plan(tokens), jrp.plan(tokens)
    assert (got.capacity_factor, got.hot_experts, got.dense_hot,
            got.reason) == (want.capacity_factor, want.hot_experts,
                            want.dense_hot, want.reason)
    for a, b in zip(rp._codes, jrp._codes):
        np.testing.assert_array_equal(a, b)


def test_balanced_load_keeps_small_capacity():
    rp = MoEReplanner(num_experts=16, top_k=2)
    rng = np.random.default_rng(0)
    tokens = 4096
    loads = [rng.poisson(tokens * 2 / 16, 16).astype(float)
             for _ in range(8)]
    for load in loads:
        rp.observe(load)
    plan = rp.plan(tokens)
    assert plan.capacity_factor <= 1.5
    assert not plan.dense_hot
    _same_plan(rp, loads, tokens)


def test_skewed_load_raises_capacity_and_flags_hot_experts():
    rp = MoEReplanner(num_experts=16, top_k=2)
    tokens = 4096
    loads = []
    for _ in range(8):
        load = np.full(16, 100.0)
        load[3] = tokens * 1.2     # heavy hitter
        load[7] = tokens * 0.8
        loads.append(load)
        rp.observe(load)
    plan = rp.plan(tokens)
    assert plan.capacity_factor >= 2.0
    assert 3 in plan.hot_experts
    assert plan.dense_hot  # two experts carry most of the load
    _same_plan(rp, loads, tokens)


def test_capacity_buckets_bound_recompiles():
    rp = MoEReplanner(num_experts=8, top_k=2)
    jrp = JMoEReplanner(num_experts=8, top_k=2)
    rng = np.random.default_rng(1)
    caps = set()
    for step in range(30):
        load = rng.poisson(1000, 8).astype(float) * (1 + step % 3)
        rp.observe(load)
        jrp.observe(load)
        caps.add(rp.bucketed_capacity(4000))
        assert rp.bucketed_capacity(4000) == jrp.bucketed_capacity(4000)
    assert caps <= set(CAPACITY_BUCKETS)
    assert len(caps) <= 3  # bucketing keeps the variants few


def test_history_is_lossy_and_bounded():
    rp = MoEReplanner(num_experts=4, top_k=1, history=4)
    for i in range(20):
        rp.observe(np.full(4, 10.0 * (i + 1)))
    assert len(rp._codes) == 4
    assert rp._codes[0].dtype == np.uint8  # 1 byte/expert, paper's encoding


def test_integration_with_moe_stats():
    """The load vector the port's model emits (a tensor) feeds the
    replanner directly, and plans as the reference's loads do."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.models.moe import MoEConfig as JMoEConfig
    from repro.models.moe import moe_apply as jmoe_apply
    from repro.models.moe import moe_init
    from repro_torch.models import convert
    from repro_torch.models.moe import MoE, MoEConfig, moe_apply
    kw = dict(num_experts=8, top_k=2, d_expert=16, capacity_factor=2.0)
    p, _ = moe_init(jax.random.PRNGKey(0), 32, JMoEConfig(**kw))
    p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    x = np.random.default_rng(0).normal(size=(2, 64, 32)).astype(np.float32)
    mod = MoE(32, MoEConfig(**kw), torch.float32, "cpu")
    mod.load_state_dict({k: convert.to_torch(np.asarray(v))
                         for k, v in p.items()}, strict=True)
    _, stats = moe_apply(mod, torch.from_numpy(x), MoEConfig(**kw),
                         return_stats=True)
    rp = MoEReplanner(8, 2)
    rp.observe(stats["expert_load"])
    plan = rp.plan(tokens_per_step=128)
    assert isinstance(plan, MoEPlan)
    assert plan.capacity_factor in CAPACITY_BUCKETS
    _, jstats = jmoe_apply(p, jnp.asarray(x), JMoEConfig(**kw),
                           return_stats=True)
    np.testing.assert_array_equal(stats["expert_load"].numpy(),
                                  np.asarray(jstats["expert_load"]))
    _same_plan(rp, [np.asarray(jstats["expert_load"])], 128)
