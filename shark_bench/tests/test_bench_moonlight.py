"""The configuration moonlight-16b-a3b (family "moe_mla", `families/moe_mla.py`
and `reference/moe_mla.py`) and its cell moonlight-16b-a3b.train-2x8k: the
full-size leaves are the program's parameters; at a smoke size the program
in float32 is the plain reference (logits, loss, every gradient); the
shares of the experts add up to the uncut layer; and the cell, rehearsed
end to end on the CPU, is correct, and is not with a fault planted in the
timed path.

The smoke configuration: d 64, 4 heads, a latent of 32, no-RoPE part 16,
RoPE part 8, v 16, 16 routed experts of which 4 are held (rank 1 of 4:
experts 4-7), 3 per token, 1 shared expert, 3 layers (the dense layer 0
and two MoE layers), vocabulary 256, batches of 2 x 128.  Its limits are
read on the CPU as the cell's are on the card (PERF.md): over 18 seeds the
sound runs read at most loss 2.3e-3, grad_norm 1.9e-2, grad 3.1e-2 and
change 1.5e-2, a routing choice flipping here and there between the
program's bfloat16 and the reference's float32; each planted fault reads
grad 0.09 or more on 3 seeds, the float8 control 0.11 or more."""

from __future__ import annotations

import contextlib
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from conftest import BENCH, make_root, smoke_cell, smoke_run
from shark_bench import port, spec as S, weights, yardstick
from shark_bench.reference import lm as ref_lm

CELL = "moonlight-16b-a3b.train-2x8k"
SMOKE = CELL + "-smoke"
SMOKE_LIMITS = {"loss": 4e-3, "grad_norm": 0.04, "grad": 0.055,
                "change": 0.03}


def moon_smoke_config() -> dict:
    c = json.loads((BENCH / "configs/moonlight-16b-a3b.json").read_text())
    c.update(name="moonlight-smoke", num_hidden_layers=3, hidden_size=64,
             intermediate_size=128, moe_intermediate_size=32,
             num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             n_routed_experts=4, num_experts_per_tok=3, n_shared_experts=1,
             vocab_size=256,
             published={"n_routed_experts": 16, "vocab_size": 256},
             expert_parallel={"ranks": 4, "rank": 1})
    return c


def make_moon_root(root: Path) -> Path:
    """`conftest.make_root`, with the Moonlight cell on its own smoke
    configuration, traffic and limits (`make_root` puts every cell that is
    not Qwen's on the Mamba2 smoke configuration)."""
    make_root(root)
    b = root / "shark_bench"
    (b / "configs/moonlight-smoke.json").write_text(
        json.dumps(moon_smoke_config()))
    t = json.loads((BENCH / "traffic/train-2x8k.json").read_text())
    t.update(batch=2, seq=128, corpus=dict(t["corpus"], n_docs=20,
                                           mean_doc_len=256))
    (b / "traffic/train-moon-smoke.json").write_text(json.dumps(t))
    (b / f"workloads/{SMOKE}.json").write_text(
        json.dumps({"limits": SMOKE_LIMITS}))
    man = json.loads((root / "BENCHMARK.json").read_text())
    for w in man["workloads"]:
        if w["name"] == SMOKE:
            w.update(config="moonlight-smoke", traffic="train-moon-smoke")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


@pytest.fixture(scope="module")
def moon_root(tmp_path_factory) -> Path:
    return make_moon_root(tmp_path_factory.mktemp("moon"))


def full_spec():
    return S.load_spec(BENCH / "configs/moonlight-16b-a3b.json")


def test_full_size_is_the_programs_model():
    """Every leaf is a parameter of the program's model, built on the meta
    device, with its shape and dtype; 2.777e9 parameters; every width as
    published, 8 of the router's 64 experts held."""
    from repro_torch.models import lm
    spec = full_spec()
    cfg = port.model_config(spec)
    assert (cfg.moe.num_experts, cfg.moe.held, cfg.moe.held_offset,
            cfg.moe.top_k, cfg.moe.score, cfg.moe.routed_scale,
            cfg.mla.rope_theta) == (64, 8, 0, 6, "sigmoid", 2.446, 50000.0)
    m = lm.build_model(cfg, "meta")
    got = {n: (tuple(p.shape), p.dtype) for n, p in m.named_parameters()}
    want = {leaf.name: (leaf.shape, weights.DTYPES[leaf.dtype])
            for leaf in S.leaves(spec)}
    assert got == want
    assert S.n_params(spec) == 2_777_412_736
    # 6 of 64 experts a token, 8 held: 0.75 of an expert a token at the
    # expected load, with the shared experts and the router
    z = spec.sizes
    moe = 2.0 * (2048 * 64 + 3 * 2048 * 1408 * 2 + 0.75 * 3 * 2048 * 1408)
    dense = 2.0 * 3 * 2048 * 11264
    assert S.family(spec).flops_per_token(spec) == pytest.approx(
        (dense + 26 * moe) / 27)
    assert z.offset == 0 and spec.vocab == 20480 and not spec.tied
    assert 9e9 < yardstick.train_flops(spec, 2, 8192) / 16384 < 11e9


def test_configuration_file_states_its_cuts():
    c = json.loads((BENCH / "configs/moonlight-16b-a3b.json").read_text())
    assert c["reduced"] == ["n_routed_experts", "vocab_size"]
    assert c["published"] == {"n_routed_experts": 64, "vocab_size": 163840}
    assert c["n_routed_experts"] * c["expert_parallel"]["ranks"] == 64
    assert c["vocab_size"] * 8 == c["published"]["vocab_size"]
    assert set(c["program_departs"]) == {"bias_update", "seq_aux"}


@pytest.fixture
def smoke_spec(tmp_path):
    p = tmp_path / "moonlight-smoke.json"
    p.write_text(json.dumps(moon_smoke_config()))
    return S.load_spec(p)


def test_program_in_float32_is_the_reference(smoke_spec):
    """The program's model in float32 on the benchmark's weights: the
    logits, the loss and every gradient are the reference's, but for the
    order of float32 sums; the selection bias takes no gradient in
    either."""
    from repro_torch.models import lm
    spec = smoke_spec
    cfg = port.model_config(spec)
    m = port.model(spec, 2 ** 31 + 5, "cpu", cfg).float()
    g = torch.Generator().manual_seed(4)
    tok = torch.randint(0, spec.vocab, (2, 64), generator=g)
    lab = torch.randint(0, spec.vocab, (2, 64), generator=g)
    params = dict(m.named_parameters())
    trained = {n: p.requires_grad_(True) for n, p in params.items()
               if not n.endswith("select_bias")}
    loss = lm.loss_fn(cfg, m, {"tokens": tok, "labels": lab})
    got = dict(zip(trained, torch.autograd.grad(loss,
                                                list(trained.values()))))
    P = {n: v.requires_grad_(True) for n, v in weights.draw_all(
        spec, 2 ** 31 + 5, "cpu", torch.float32).items()}
    want_loss = ref_lm.loss(spec, P, tok, lab)
    want = dict(zip(P, torch.autograd.grad(want_loss, list(P.values()))))
    assert float(loss.detach()) == pytest.approx(float(want_loss.detach()),
                                                 rel=1e-6)
    assert set(want) == set(got) | {n for n in P if n.endswith("select_bias")}
    for n, gr in got.items():
        assert float((gr - want[n]).norm()) <= 1e-5 * float(
            want[n].norm()) + 1e-9, n
    assert all(float(want[n].abs().max()) == 0.0 for n in P
               if n.endswith("select_bias"))
    with torch.no_grad():
        h = lm._backbone_full(cfg, m, tok)
        logits = h[:, -1] @ m.lm_head
        ref = ref_lm.last_logits(spec, P, tok)
    assert float((logits - ref).abs().max()) <= 1e-5 * float(
        ref.abs().max())


def _share(spec, offset: int, held: int):
    return dataclasses.replace(spec, sizes=dataclasses.replace(
        spec.sizes, offset=offset, held=held))


def test_reference_shares_add_up_to_the_uncut_layer(smoke_spec):
    """The reference's MoE layer, held by four ranks of four experts: the
    four outputs, with the shared experts counted once, are the layer that
    holds all 16 (whose leaves are the four shares' stacked)."""
    from shark_bench.reference import moe_mla as ref
    spec = smoke_spec
    P = weights.draw_all(spec, 9, "cpu", torch.float32)
    p = "layers.0."
    # the uncut layer: 16 experts, each rank's slice its own draw
    ranks = [weights.draw_all(spec, 9 + r, "cpu", torch.float32)
             for r in range(4)]
    for w in ("w_gate", "w_up", "w_down"):
        P[p + "moe." + w] = torch.cat([Q[p + "moe." + w] for Q in ranks])
    h = torch.randn(2, 24, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        whole = ref.moe(_share(spec, 0, 16), ref_lm.FP32, P, p, h)
        shared = ref.swiglu(ref_lm.FP32, h, P[p + "moe.shared_gate"],
                            P[p + "moe.shared_up"], P[p + "moe.shared_down"])
        total = -3 * shared
        for r in range(4):
            Q = dict(P)
            for w in ("w_gate", "w_up", "w_down"):
                Q[p + "moe." + w] = ranks[r][p + "moe." + w]
            total = total + ref.moe(_share(spec, 4 * r, 4), ref_lm.FP32, Q,
                                    p, h)
    assert torch.allclose(total, whole, rtol=1e-5, atol=1e-5)


def test_moonlight_rehearsal(moon_root):
    out = smoke_run(moon_root, SMOKE)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "train_tokens_per_s"}
    traced = smoke_run(moon_root, SMOKE, traced=True)
    assert traced["correct"], traced["checks"]
    # on the CPU the device readers, the three spans' among them, see
    # nothing: the host-clock ones read
    assert set(traced["metrics"]) == {"batch_ms.train", "mfu.train"}


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def _router(**kw):
    """The router computes with another setting of the configuration."""
    from repro_torch.models import moe
    route = moe._route

    def other(xf, router, cfg, bias=None):
        return route(xf, router, dataclasses.replace(cfg, **kw), bias)
    return patched(moe, "_route", other)


def softmax_scores():
    return _router(score="softmax")


def no_renormalisation():
    """The weights are the chosen scores times the scale, not over their
    sum."""
    from repro_torch.models import moe
    route = moe._route

    def raw(xf, router, cfg, bias=None):
        gates, _, topi = route(xf, router, cfg, bias)
        return gates, torch.gather(gates, 1, topi) * cfg.routed_scale, topi
    return patched(moe, "_route", raw)


def no_routed_scale():
    return _router(routed_scale=1.0)


def no_bias():
    from repro_torch.models import moe
    route = moe._route
    return patched(moe, "_route",
                   lambda xf, router, cfg, bias=None: route(xf, router, cfg))


def every_expert():
    """No share: every assignment is computed, an absent expert's by a
    held one."""
    from repro_torch.models import moe
    group = moe._group

    def all_held(topi, cfg):
        return group(topi % moe.n_held(cfg) + cfg.held_offset, cfg)
    return patched(moe, "_group", all_held)


def rope_base_10000():
    from repro_torch.models import attention
    mla = attention.mla_attention

    def at_10000(*args, **kw):
        return mla(*args, **dict(kw, rope_theta=10000.0))
    return patched(attention, "mla_attention", at_10000)


FAULTS = [softmax_scores, no_bias, no_renormalisation, no_routed_scale,
          every_expert, rope_base_10000]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_moonlight_fault_is_not_correct(moon_root, fault):
    with fault():
        out = smoke_run(moon_root, SMOKE, seed=11, seconds=0.3)
    assert not out["correct"], out["checks"]


def test_moonlight_control_fails_the_limits(moon_root):
    cell = smoke_cell(moon_root, SMOKE)
    from shark_bench import bench
    out = bench.kind_of(cell).controls(cell, 5, torch.device("cpu"))
    assert any(out["fp8"][k] > lim for k, lim in cell.limits.items()), (
        out["fp8"], cell.limits)
