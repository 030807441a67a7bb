"""The port's LM serving path (`dense`, `ssm`, `hybrid`, `moe`, `vlm` and
`encdec` families) against the JAX reference, at smoke size on the CPU.

The reference's parameters (`lm.init_params`) are carried into the port by
`models/convert.params_from_jax`; the same numpy tokens, made from a seed,
go to both.  Configurations: `zamba2-7b-smoke` (2 groups of 1 shared
attention + 3 Mamba2 blocks, no tail), a tail variant of it (n_layers=10,
attn_every=4: 2 groups and 2 tail blocks, as the full model has a tail),
`mamba2-370m-smoke`, the four dense smoke variants (each with one kv head,
`smoke_variant`'s rule), `yi-9b-gqa`, yi-9b-smoke with 8 query heads
over 2 kv heads, so that grouped-query attention runs with real groups,
and the two MoE smoke variants: `deepseek-v2-lite-16b-smoke` (MLA, a
dense layer 0, 8 experts top-2 and 2 shared) and
`phi3.5-moe-42b-a6.6b-smoke` (GQA, 8 experts top-2), both drop-free
(`smoke_variant` sets capacity_factor = E / k); the MoE layer with drops
is held to the reference in tests/test_torch_moe.py; and the two
cross-attending smoke variants, `llama-3.2-vision-11b-smoke` (2 groups of
1 dense block + 1 gated cross layer over 16 image tokens) and
`whisper-base-smoke` (2 encoder and 2 decoder blocks over 32 frames),
fed the reference test's bf16 `image_embeds` / `frames` drawn from a seed
(float32 ones in `test_float32_extras_match_reference`, as the CLI
draws them).
The reference inits QKV biases, LayerNorm shifts and the GELU MLP's
biases to zero, LayerNorm scales to one and the vlm cross layers' gates
to zero (so that a fresh vlm model's cross layers add nothing); the bias
tests, and every vlm and encdec test, draw those leaves from a seed on
the reference's tree before conversion.
The reference's encdec model runs only op by op with float32 weights:
its encoder casts the frames to bf16 and the scanned block returns
float32, which `lax.scan` refuses under jit; so its float32 runs are
made under `jax.disable_jit()` too.

Tolerances, relative to the reference tensor's max magnitude:
- float32 weights (every bf16 leaf cast to float32 on both sides): prefill
  logits, every cache tensor and three decode steps' logits to 1e-4, and
  `ServeEngine.generate`'s greedy tokens identical;
- bf16 weights: 3e-2, against the reference run op by op
  (`jax.disable_jit()`).  Jitted, XLA fuses the reference's scanned layer
  bodies and drops bf16 round trips inside the fusions, which moves its
  own bf16 logits 2–5% from its op-by-op ones on these inputs; the port,
  like the op-by-op reference, rounds after every op.
"""

import contextlib
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import REGISTRY, get_config
from repro_torch.models import convert, lm
from repro_torch.models import moe as tmoe
from repro_torch.serving import ServeEngine

B, S, MAXS, NEW = 2, 37, 48, 6
VARIANTS = {
    "zamba2-7b-smoke": {},
    "zamba2-tail": dict(n_layers=10, attn_every=4),
    "mamba2-370m-smoke": {},
    "yi-9b-smoke": {},
    "phi3-medium-14b-smoke": {},
    "qwen2.5-3b-smoke": {},
    "starcoder2-15b-smoke": {},
    "yi-9b-gqa": dict(n_heads=8, n_kv_heads=2),
    "deepseek-v2-lite-16b-smoke": {},
    "phi3.5-moe-42b-a6.6b-smoke": {},
    "llama-3.2-vision-11b-smoke": {},
    "whisper-base-smoke": {},
}
# the registry configuration each variant changes
BASES = {"zamba2-tail": "zamba2-7b-smoke", "yi-9b-gqa": "yi-9b-smoke"}


def _configs(variant, ngroups=1):
    name = BASES.get(variant, variant)
    kw = VARIANTS[variant]

    def make(c):
        c = dataclasses.replace(c, **kw)
        if ngroups != 1:
            c = dataclasses.replace(c, ssm=dataclasses.replace(
                c.ssm, ngroups=ngroups))
        return c
    return make(jget_config(name)), make(get_config(name))


def _draw_zero_inits(params, seed):
    """The reference's constant-initialized leaves drawn from `seed`: QKV
    biases and the GELU MLP's biases N(0, 0.1^2), norm scales (LayerNorm
    and RMSNorm, the encoder's final norm too) 1 + N(0, 0.1^2) and
    LayerNorm shifts N(0, 0.1^2), the vlm cross layers' `gate` and
    `mlp_gate` N(0, 1), each in its own dtype."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        key, parent = path[-1].key, path[-2].key if len(path) > 1 else ""
        if key in ("gate", "mlp_gate") and parent == "cross_layers":
            return jnp.asarray(rng.normal(size=a.shape).astype(np.float32),
                               a.dtype)
        if key not in ("bq", "bk", "bv", "fc_b", "proj_b", "w", "b"):
            return a
        if key == "w" and not (parent.startswith("ln")
                               or parent in ("final_norm",
                                             "enc_final_norm")):
            return a
        x = rng.normal(scale=0.1, size=a.shape).astype(np.float32)
        return jnp.asarray(x + (1.0 if key == "w" else 0.0), a.dtype)
    return jax.tree_util.tree_map_with_path(draw, params)


def _models(variant, dtype, seed=0, ngroups=1, biases=False):
    """Both packages' models of `variant`; with `biases`, and always for a
    vlm or encdec model, the constant-initialized leaves drawn."""
    jcfg, cfg = _configs(variant, ngroups)
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    if biases or cfg.family in lm.CROSS_INPUTS:
        params = _draw_zero_inits(params, seed + 100)
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                    lm.build_model(cfg, "cpu"))
    return jcfg, cfg, params, model


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


def _tokens(cfg, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape) \
        .astype(np.int32)


def _extras(cfg, seed, dtype="bfloat16", b=B):
    """A vlm or encdec batch's stub frontend output N(0, 1) from `seed`,
    as (reference batch entries, port batch entries): bf16 as the
    reference test's batch gives them, or float32 as its CLI does; both
    empty for the other families."""
    if cfg.family not in lm.CROSS_INPUTS:
        return {}, {}
    t = cfg.n_frontend_tokens if cfg.family == "vlm" else cfg.enc_seq
    a = np.random.default_rng(seed).normal(size=(b, t, cfg.d_model)) \
        .astype(np.float32)
    key = lm.CROSS_INPUTS[cfg.family]
    return ({key: jnp.asarray(a).astype(getattr(jnp, dtype))},
            {key: torch.from_numpy(a).to(getattr(torch, dtype))})


def _reference_ctx(cfg, dtype):
    """How the reference runs: op by op in bf16 (see the module's
    docstring), and for an encdec model in float32 too; jitted
    otherwise."""
    if dtype == "float32" and cfg.family != "encdec":
        return contextlib.nullcontext()
    return jax.disable_jit()


def _assert_same_config(port, ref, where: str = "config"):
    """Every field both configurations declare is equal, nested ones
    compared field by field the same way; every field the port alone
    declares (`MLAConfig.rope_theta`, `MoEConfig`'s router and share
    settings) holds its default, which computes what the reference
    computes."""
    if not (dataclasses.is_dataclass(port) and dataclasses.is_dataclass(ref)):
        assert port == ref, where
        return
    ours = {f.name: f for f in dataclasses.fields(port)}
    theirs = {f.name for f in dataclasses.fields(ref)}
    assert theirs <= set(ours), (where, sorted(theirs - set(ours)))
    for name, f in ours.items():
        if name in theirs:
            _assert_same_config(getattr(port, name), getattr(ref, name),
                                f"{where}.{name}")
        else:
            assert getattr(port, name) == f.default, f"{where}.{name}"


@pytest.mark.parametrize("name", sorted(REGISTRY))
@pytest.mark.parametrize("smoke", [False, True])
def test_registry_matches_reference(name, smoke):
    full = name + ("-smoke" if smoke else "")
    _assert_same_config(get_config(full), jget_config(full))
    assert sorted(REGISTRY) == sorted(JREGISTRY)


@contextlib.contextmanager
def _moe_calls():
    """Record every MoE layer call of both packages, in call order: the
    reference's input, router gates, output and `dropless`, and the port's
    gates.  The reference's recorder reads values, so it must run op by op
    (`jax.disable_jit()`, with `remat=False`: remat changes only the
    backward)."""
    jcalls, tcalls = [], []
    jorig, torig = jmoe._moe_apply, tmoe.moe_apply

    def jspy(p, x, cfg, return_stats=False, dropless=False):
        out = jorig(p, x, cfg, return_stats, dropless)
        gates = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(jnp.float32)
                               @ p["router"], axis=-1)
        jcalls.append(dict(p=p, x=np.asarray(x), gates=np.asarray(gates),
                           dropless=dropless,
                           y=np.asarray(out[0] if return_stats else out,
                                        np.float32)))
        return out

    def tspy(p, x, cfg, return_stats=False, dropless=False):
        gates = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ p.router,
                              dim=-1)
        tcalls.append(dict(gates=gates.numpy()))
        return torig(p, x, cfg, return_stats, dropless)

    jmoe._moe_apply, tmoe.moe_apply = jspy, tspy
    try:
        yield jcalls, tcalls
    finally:
        jmoe._moe_apply, tmoe.moe_apply = jorig, torig


def _top_k(gates, k):
    """Each row's top-k experts, the lower index first among ties (as
    `lax.top_k` and the port's stable sort take them)."""
    return np.argsort(-gates, axis=-1, kind="stable")[:, :k]


def _router_flips(jcfg, cfg, model, jcalls, tcalls, tol):
    """The steps (0: prefill, i: decode step i) at which the port's router
    chose other experts than the reference's for some token, counted layer
    by layer.  Each flip must be a near-tie in the reference's own gates
    (the two experts within `tol` of each other, relative): bf16 rounding
    of the layer's input, not a fault.  Then every layer call is held on
    the reference's own input: the port's `moe_apply` with the
    reference's parameters picks the reference's experts and returns its
    output to `tol`."""
    k = cfg.moe.top_k
    n_moe = len(model.layers)
    assert len(jcalls) == len(tcalls) == 4 * n_moe
    flips = {}
    for c, (jc, tc) in enumerate(zip(jcalls, tcalls)):
        want, got = _top_k(jc["gates"], k), _top_k(tc["gates"], k)
        rows = np.nonzero((np.sort(want, -1) != np.sort(got, -1)).any(-1))[0]
        if len(rows):
            flips[(c // n_moe, c % n_moe)] = len(rows)
        for r in rows:
            g = jc["gates"][r]
            lost = sorted(set(want[r]) - set(got[r]))
            won = sorted(set(got[r]) - set(want[r]))
            assert (g[lost].min() - g[won].max()) / g[lost].min() < tol, \
                (c, r, g[lost], g[won])
    for jc in jcalls:
        p = tmoe.MoE(cfg.d_model, cfg.moe, torch.bfloat16, "cpu")
        p.load_state_dict({n: convert.to_torch(np.asarray(a))
                           for n, a in jc["p"].items()})
        x = convert.to_torch(jc["x"])
        gates = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ p.router,
                              dim=-1)
        np.testing.assert_array_equal(_top_k(gates.numpy(), k),
                                      _top_k(jc["gates"], k))
        y = tmoe.moe_apply(p, x, cfg.moe, dropless=jc["dropless"])
        assert _rel(y, jc["y"]) < tol
    return flips


def _match_prefill_and_decode(jcfg, cfg, params, model, dtype, toks,
                              extra=({}, {})):
    """Prefill logits, every cache tensor and three decode steps' logits
    of the port against the reference's, at the file's tolerances.

    In bf16 a near-tie in an MoE router can flip an expert choice between
    the packages, and the logits of that step and the steps after part by
    more than rounding.  So for a bf16 MoE model every layer's choices
    are counted (`_router_flips`): the steps before the first flip are
    held end to end, and the flips and every layer call as
    `_router_flips` says."""
    tol = 1e-4 if dtype == "float32" else 3e-2
    routed = dtype != "float32" and cfg.family == "moe"
    if routed:
        jcfg = dataclasses.replace(jcfg, remat=False)

    jextra, textra = extra

    def jrun():
        jl, jc = jlm.prefill_fn(jcfg, params,
                                {"tokens": jnp.asarray(toks), **jextra},
                                MAXS)
        out = [(jl, {k: np.asarray(v) for k, v in jc.items()})]
        for i in range(3):
            tok = jnp.argmax(jl[:, 0], -1).astype(jnp.int32)[:, None]
            jl, jc = jlm.decode_fn(jcfg, params, tok, jc, jnp.int32(S + i))
            out.append((jl, None))
        return out

    with _moe_calls() if routed else contextlib.nullcontext() as calls:
        with _reference_ctx(cfg, dtype):
            want = jrun()
        logits, caches = lm.prefill_fn(cfg, model,
                                       {"tokens": torch.from_numpy(toks),
                                        **textra}, MAXS)
        # decode updates the caches in place: keep the prefill's
        got = [(logits, {k: v.clone() for k, v in caches.items()})]
        for i in range(3):
            # the reference's own next token, so both decode the same
            # sequence
            tok = np.argmax(np.asarray(want[i][0])[:, 0], -1)
            logits, caches = lm.decode_fn(cfg, model,
                                          torch.from_numpy(tok)[:, None],
                                          caches, S + i)
            got.append((logits, None))
    held = len(got)
    if routed:
        flips = _router_flips(jcfg, cfg, model, *calls, tol)
        if flips:
            warnings.warn(f"{cfg.name}, bf16: router near-ties chose other "
                          f"experts (step, layer): tokens {flips}; the "
                          f"steps from {min(flips)[0]} on are held layer by "
                          f"layer on the reference's inputs")
            held = min(flips)[0]
    assert got[0][0].shape == (B, 1, cfg.vocab)
    assert got[0][0].dtype == torch.float32
    assert sorted(got[0][1]) == sorted(want[0][1])
    for i in range(held):
        assert _rel(got[i][0], want[i][0]) < tol, i
    for k, v in want[0][1].items():
        assert tuple(got[0][1][k].shape) == v.shape, k
        assert got[0][1][k].dtype == convert.to_torch(v[:0]).dtype, k
        if held:
            assert _rel(got[0][1][k], v) < tol, k


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_caches_and_decode_match_reference(variant, dtype):
    jcfg, cfg, params, model = _models(variant, dtype)
    _match_prefill_and_decode(jcfg, cfg, params, model, dtype,
                              _tokens(cfg, 1), _extras(cfg, 21))


@pytest.mark.parametrize("variant", ["llama-3.2-vision-11b-smoke",
                                     "whisper-base-smoke"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float32_extras_match_reference(variant, dtype):
    """float32 `image_embeds` / `frames`, as the CLI draws them: against
    bf16 weights a vlm model's cross k / v (and its xk / xv caches) are
    float32, JAX's promotion, which the port takes too; Whisper's encoder
    casts the frames to bf16 whatever they are."""
    jcfg, cfg, params, model = _models(variant, dtype, seed=22)
    _match_prefill_and_decode(jcfg, cfg, params, model, dtype,
                              _tokens(cfg, 23),
                              _extras(cfg, 24, "float32"))


@pytest.mark.parametrize("variant", ["qwen2.5-3b-smoke",
                                     "starcoder2-15b-smoke"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_drawn_biases_and_norms_match_reference(variant, dtype):
    """Qwen2.5's QKV biases, StarCoder2's QKV biases, LayerNorm scales and
    shifts and GELU MLP biases, drawn from a seed (not the zero / one
    init), through prefill, the caches and three decode steps; in float32
    `generate`'s greedy tokens too."""
    jcfg, cfg, params, model = _models(variant, dtype, seed=12, biases=True)
    assert cfg.qkv_bias
    drawn = [float(np.abs(np.asarray(a, np.float32)).min())
             for a in (params["layers"]["attn"]["bq"],
                       params["layers"]["attn"]["bv"])]
    assert min(drawn) > 0
    if cfg.norm == "ln":
        assert float(np.abs(np.asarray(params["layers"]["ln1"]["b"])).max()) \
            > 0
        assert float(np.abs(np.asarray(params["layers"]["mlp"]["fc_b"],
                                       np.float32)).max()) > 0
    _match_prefill_and_decode(jcfg, cfg, params, model, dtype,
                              _tokens(cfg, 13))
    if dtype == "float32":
        toks = _tokens(cfg, 14)
        want = JServeEngine(jcfg, params, max_seq=S + NEW).generate(toks, NEW)
        got = ServeEngine(cfg, model, max_seq=S + NEW).generate(toks, NEW)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", ["mamba2-370m-smoke", "zamba2-7b-smoke"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_group_prefill_and_decode_match_reference(variant, dtype,
                                                      monkeypatch):
    """ngroups = 2 (two B/C groups of heads): the prefill hands the SSD
    wrapper B and C as (B, S, 2, N), and its logits, caches and one decode
    step match the reference's, at the file's tolerances."""
    from repro_torch.kernels import ssd_scan as tss
    jcfg, cfg, params, model = _models(variant, dtype, seed=10, ngroups=2)
    assert cfg.ssm.ngroups == 2 and cfg.ssm.n_heads(cfg.d_model) % 2 == 0
    toks = _tokens(cfg, 11)
    tol = 1e-4 if dtype == "float32" else 3e-2

    def jrun():
        jl, jc = jlm.prefill_fn(jcfg, params, {"tokens": jnp.asarray(toks)},
                                MAXS)
        tok = jnp.argmax(jl[:, 0], -1).astype(jnp.int32)[:, None]
        jd, _ = jlm.decode_fn(jcfg, params, tok, jc, jnp.int32(S))
        return (jl, {k: np.asarray(v) for k, v in jc.items()}, np.array(tok),
                jd)

    if dtype == "float32":
        jl, jc, tok, jd = jrun()
    else:
        with jax.disable_jit():
            jl, jc, tok, jd = jrun()
    groups = []

    def plain(x, dt, a, b, c, chunk=128, d=None):
        groups.append(tuple(b.shape[2:]))
        return plain_scan(x, dt, a, b, c, chunk, d)

    plain_scan = tss.ssd_scan_plain
    monkeypatch.setattr(tss, "ssd_scan_plain", plain)
    logits, caches = lm.prefill_fn(cfg, model,
                                   {"tokens": torch.from_numpy(toks)}, MAXS)
    assert groups and set(groups) == {(2, cfg.ssm.d_state)}
    assert _rel(logits, jl) < tol
    assert sorted(caches) == sorted(jc)
    for k, v in jc.items():
        assert tuple(caches[k].shape) == v.shape, k
        assert _rel(caches[k], v) < tol, k
    logits, _ = lm.decode_fn(cfg, model, torch.from_numpy(tok), caches, S)
    assert _rel(logits, jd) < tol


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generate_greedy_tokens_match_reference(variant):
    jcfg, cfg, params, model = _models(variant, "float32", seed=2)
    toks = _tokens(cfg, 3)
    jextra, textra = _extras(cfg, 25)
    with _reference_ctx(cfg, "float32"):
        want = JServeEngine(jcfg, params, max_seq=S + NEW).generate(
            toks, NEW, jextra or None)
    got = ServeEngine(cfg, model, max_seq=S + NEW).generate(toks, NEW,
                                                            textra)
    assert got.dtype == np.int32 and got.shape == (B, NEW)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_matches_full_forward(variant):
    """decode(tok | prefill(S)) equals the full forward over S + 1 tokens,
    bf16 weights, rel 0.05 (tests/test_models_smoke.py's check)."""
    _, cfg, _, model = _models(variant, "bfloat16", seed=4)
    toks = torch.from_numpy(_tokens(cfg, 5))
    extra = _extras(cfg, 26)[1]
    logits, caches = lm.prefill_fn(cfg, model, {"tokens": toks, **extra},
                                   MAXS)
    nxt = torch.argmax(logits[:, 0], -1)[:, None]
    logits_d, _ = lm.decode_fn(cfg, model, nxt, caches, S)
    h = lm._backbone_full(cfg, model, torch.cat([toks.long(), nxt], dim=1),
                          extra=extra)
    full = (h[:, -1:] @ lm._unembed(cfg, model)).float()
    assert torch.isfinite(logits_d).all()
    assert _rel(logits_d, full.numpy()) < 0.05


def test_temperature_sampling_is_seeded():
    _, cfg, _, model = _models("mamba2-370m-smoke", "float32", seed=6)
    toks = _tokens(cfg, 7)

    def run(seed):
        return ServeEngine(cfg, model, max_seq=S + NEW, temperature=1.0,
                           seed=seed).generate(toks, NEW)

    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert ((a >= 0) & (a < cfg.vocab)).all()


def test_short_prompt_fills_the_conv_cache_tail():
    """A prompt shorter than d_conv - 1 leaves the conv cache's first rows
    zero (the causal conv's padding); its decode equals the full forward."""
    _, cfg, _, model = _models("mamba2-370m-smoke", "float32", seed=8)
    toks = torch.from_numpy(_tokens(cfg, 9, (B, 2)))
    logits, caches = lm.prefill_fn(cfg, model, {"tokens": toks}, 8)
    assert torch.all(caches["conv"][:, :, 0] == 0)
    nxt = torch.argmax(logits[:, 0], -1)[:, None]
    logits_d, _ = lm.decode_fn(cfg, model, nxt, caches, 2)
    h = lm._backbone_full(cfg, model, torch.cat([toks.long(), nxt], dim=1))
    full = (h[:, -1:] @ lm._unembed(cfg, model)).float()
    assert _rel(logits_d, full.numpy()) < 1e-4


def _draws_the_reference_init(name):
    cfg = get_config(name)
    jparams, _ = jlm.init_params(jget_config(name), jax.random.PRNGKey(0))
    want = convert.state_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    model = lm.build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        g, w = got[k].float(), v.float()
        if bool((w == w.flatten()[0]).all()):       # a constant leaf
            assert torch.equal(g, w), k
        else:
            tol = 5.0 / np.sqrt(w.numel())
            assert abs(float(g.std()) / float(w.std()) - 1) < tol, k


def test_build_model_draws_the_reference_init():
    """Each leaf has the reference's shape and dtype, and its draws the
    reference's distribution: constants exact, and the standard deviations
    of the two draws within 5 / sqrt(n) of each other, relative (each
    estimate's relative standard error is about 1 / sqrt(2n))."""
    _draws_the_reference_init("zamba2-7b-smoke")


@pytest.mark.parametrize("name", ["yi-9b-smoke", "qwen2.5-3b-smoke",
                                  "starcoder2-15b-smoke",
                                  "deepseek-v2-lite-16b-smoke",
                                  "phi3.5-moe-42b-a6.6b-smoke",
                                  "llama-3.2-vision-11b-smoke",
                                  "whisper-base-smoke"])
def test_build_model_draws_the_reference_init_dense(name):
    """The same for dense trees: RMSNorm and SwiGLU with an lm_head (Yi),
    QKV biases and tied embeddings (Qwen2.5), LayerNorm, GELU and QKV
    biases (StarCoder2); for MoE trees: MLA, the dense layer0, the
    float32 router, the (E, in, out) experts and the shared experts
    (DeepSeek-V2-Lite), GQA experts (Phi-3.5-MoE); for the vlm tree its
    (G, n_self) self layers and the cross layers with their zero float32
    gates (Llama-3.2-Vision), for the encdec tree the encoder, its final
    norm and the decoder's cross blocks (Whisper)."""
    _draws_the_reference_init(name)


def test_converter_carries_bfloat16_bits():
    x = jnp.asarray(np.random.default_rng(0).normal(size=(3, 5)),
                    jnp.bfloat16)
    arr = np.asarray(x)
    assert arr.dtype.name == "bfloat16"
    t = convert.to_torch(arr)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x, np.float32))


@pytest.mark.parametrize("name,kw,reads", [
    ("llama-3.2-vision-11b-smoke", dict(attn_scores_dtype="bf16"), True),
    ("llama-3.2-vision-11b-smoke", dict(kv_cache_quant=True), False),
    ("whisper-base-smoke", dict(attn_scores_dtype="bf16"), False),
    ("whisper-base-smoke", dict(kv_cache_quant=True), False),
])
def test_cross_family_options_follow_the_reference(name, kw, reads):
    """What the reference reads of the two cache and score fields: a vlm
    model's self layers score in `attn_scores_dtype`, so bf16 scores
    change its function, and the port's prefill logits and two decode
    steps equal the reference's under that configuration (op by op; 2^-7,
    the bf16 scores' rounding); its cache is never quantized and an encdec
    model reads neither field, so those configurations build and serve
    the function the plain configuration serves."""
    cfg = dataclasses.replace(get_config(name), **kw)
    if reads:
        jcfg, _, params, model = _models(name, "float32", seed=16)
        jcfg = dataclasses.replace(jcfg, **kw)
        toks = _tokens(cfg, 17)
        jx, tx = _extras(cfg, 18)
        with jax.disable_jit():
            jl, jc = jlm.prefill_fn(jcfg, params, {"tokens": jnp.asarray(
                toks), **jx}, MAXS)
        tl, tc = lm.prefill_fn(cfg, model, {"tokens": torch.from_numpy(
            toks), **tx}, MAXS)
        assert _rel(tl, jl) < 2 ** -7
        tok = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)[:, None]
        with jax.disable_jit():
            jd, _ = jlm.decode_fn(jcfg, params, jnp.asarray(tok), jc,
                                  jnp.int32(S))
        td, _ = lm.decode_fn(cfg, model, torch.from_numpy(tok), tc, S)
        assert _rel(td, jd) < 2 ** -7
        return
    jcfg, base, params, model = _models(name, "float32", seed=16)
    assert lm.build_model(cfg, "cpu").cfg == cfg
    toks = _tokens(cfg, 17)
    extra = _extras(cfg, 18)[1]
    got = ServeEngine(cfg, model, max_seq=S + NEW).generate(toks, NEW, extra)
    want = ServeEngine(base, model, max_seq=S + NEW).generate(toks, NEW,
                                                              extra)
    np.testing.assert_array_equal(got, want)
    logits, caches = lm.prefill_fn(cfg, model,
                                   {"tokens": torch.from_numpy(toks),
                                    **extra}, MAXS)
    assert sorted(caches) == ["k", "v", "xk", "xv"]
    assert caches["k"].dtype == torch.float32


@pytest.mark.parametrize("variant", ["llama-3.2-vision-11b-smoke",
                                     "whisper-base-smoke"])
def test_cross_layers_change_the_logits(variant):
    """The cross layers are not skipped: a vlm model with its drawn gates
    and one with the gates zeroed (the reference's init, where tanh(0) =
    0 hides the cross layers) part by far more than the float32
    tolerance; an encdec model fed other frames moves too."""
    _, cfg, _, model = _models(variant, "float32", seed=19)
    toks = torch.from_numpy(_tokens(cfg, 20))
    extra = _extras(cfg, 27)[1]
    drawn, _ = lm.prefill_fn(cfg, model, {"tokens": toks, **extra}, MAXS)
    if cfg.family == "vlm":
        gates = [g for cp in model.cross_layers
                 for g in (cp.gate, cp.mlp_gate)]
        assert min(abs(float(g)) for g in gates) > 0
        for g in gates:
            g.zero_()
        other, _ = lm.prefill_fn(cfg, model, {"tokens": toks, **extra},
                                 MAXS)
    else:
        other, _ = lm.prefill_fn(cfg, model, {"tokens": toks,
                                              **_extras(cfg, 28)[1]}, MAXS)
    assert _rel(other, drawn.numpy()) > 100 * 1e-4


@pytest.mark.parametrize("variant", ["llama-3.2-vision-11b-smoke",
                                     "whisper-base-smoke"])
def test_missing_frontend_input_raises_key_error(variant):
    """Prefill without `image_embeds` / `frames` raises `KeyError` naming
    the input, as the reference's lookup does."""
    _, cfg, _, model = _models(variant, "float32", seed=29)
    key = lm.CROSS_INPUTS[cfg.family]
    with pytest.raises(KeyError, match=key):
        lm.prefill_fn(cfg, model, {"tokens": torch.from_numpy(
            _tokens(cfg, 30))}, MAXS)
    with pytest.raises(KeyError, match=key):
        ServeEngine(cfg, model, max_seq=S + NEW).generate(_tokens(cfg, 30),
                                                          NEW)


def test_cli_serves_on_the_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "zamba2-7b-smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "9",
                      "--new-tokens", "3"])
    assert out.shape == (2, 3) and out.dtype == np.int32
    assert "on cpu" in capsys.readouterr().out


def test_cli_serves_a_dense_arch_on_the_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "yi-9b-smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "9",
                      "--new-tokens", "3"])
    assert out.shape == (2, 3) and out.dtype == np.int32
    assert "on cpu" in capsys.readouterr().out


def test_cli_serves_a_moe_arch_on_the_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "deepseek-v2-lite-16b-smoke", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "9",
                      "--new-tokens", "3"])
    assert out.shape == (2, 3) and out.dtype == np.int32
    assert "on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b-smoke",
                                  "whisper-base-smoke"])
def test_cli_serves_a_cross_attending_arch_on_the_cpu(arch, capsys):
    """The CLI draws float32 `image_embeds` / `frames` after the prompts
    from the same generator, as the reference's CLI does."""
    from repro_torch.launch import serve
    out = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "9", "--new-tokens", "3"])
    assert out.shape == (2, 3) and out.dtype == np.int32
    assert "on cpu" in capsys.readouterr().out
