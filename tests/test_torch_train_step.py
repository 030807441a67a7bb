"""The port's training step against the JAX reference, at smoke size on
the CPU: twins of tests/test_models_smoke.py's `test_smoke_train_step`
over all ten architectures, and, for every architecture's smoke variant
(all six families), the whole train step on float32 weights against the
reference's.

The reference's parameters (`lm.init_params`, PRNGKey(1) as its test
draws them) are carried into the port by `models/convert.params_from_jax`;
the same numpy tokens, labels and frontend inputs go to both.  The
constant-initialized leaves (biases, norm scales and shifts, the vlm
gates: zero gates hide the cross layers) are drawn from a seed, as
tests/test_torch_lm.py draws them.

Tolerances, relative to the reference tensor's largest entry:
- float32 weights: the loss and the gradient norm to 1e-4; every
  gradient (read as the first moment after one step, mu = (1 - b1) g
  clip) to 1e-4 under `attn_impl="blockwise"` (but Whisper's first
  encoder norm, which computes in bf16 in both packages: 1e-3), the
  second moment to twice that; the new float32 master
  weights, the second moments and the bf16-rounded parameters after the
  AdamW step to float32 rounding (rel 1e-6 of each tensor's largest
  entry), except where a gradient entry is so close to zero that its
  sign is below the comparison's resolution: there AdamW's first step
  moves the weight by +lr or -lr whichever the sign, and the test counts
  such entries and allows none past 2e-6 of a tensor's largest gradient;
- `attn_impl="flash"` (the reference's hand-written backward, which
  rounds to bf16) to 3e-2, as bf16 weights are held in
  tests/test_torch_lm.py.
The reference's encdec model runs op by op (`jax.disable_jit()`): its
float32 jitted scan refuses the bf16 encoder carry.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import _draw_zero_inits

from repro.configs import ARCH_NAMES as JARCH_NAMES
from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import init_opt_state as jinit_opt_state
from repro.training import make_train_step as jmake_train_step
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import convert, lm
from repro_torch.training import (AdamWConfig, init_opt_state,
                                  make_train_step)

B, S = 2, 32
LR = 1e-3
# every architecture's smoke variant: all six families, both MoE
# attentions (MLA and GQA), the four dense configurations
SMOKE_ARCHS = [a + "-smoke" for a in ARCH_NAMES]


def test_port_trains_every_reference_arch():
    assert ARCH_NAMES == JARCH_NAMES and len(ARCH_NAMES) == 10


def _batch(cfg, seed):
    """(reference batch, port batch): tokens, labels, and a vlm or encdec
    model's bf16 frontend input N(0, 1), from one numpy generator."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    if cfg.family in lm.CROSS_INPUTS:
        key = lm.CROSS_INPUTS[cfg.family]
        t = cfg.n_frontend_tokens if cfg.family == "vlm" else cfg.enc_seq
        a = rng.normal(size=(B, t, cfg.d_model)).astype(np.float32)
        jb[key] = jnp.asarray(a).astype(jnp.bfloat16)
        tb[key] = torch.from_numpy(a).bfloat16()
    return jb, tb


def _models(arch, dtype, impl="blockwise", seed=1):
    jcfg = dataclasses.replace(jget_config(arch), attn_impl=impl)
    cfg = dataclasses.replace(get_config(arch), attn_impl=impl)
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    params = _draw_zero_inits(params, seed + 100)
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                    lm.build_model(cfg, "cpu"))
    return jcfg, cfg, params, model


def _rel(got, want):
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_smoke_train_step(arch):
    """Twin of the reference test: one AdamW step of the smoke variant on
    the reference's bf16 parameters gives a finite loss and gradient
    norm, step 1, and moved parameters."""
    jcfg, cfg, _, model = _models(arch + "-smoke", "bfloat16")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt_state = init_opt_state(dict(model.named_parameters()))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))
    _, tb = _batch(cfg, 0)
    model, o2, m = step(model, opt_state, tb)
    assert np.isfinite(float(m["loss"]))
    assert np.isfinite(float(m["grad_norm"]))
    assert int(o2["step"]) == 1 and o2["step"].dtype == torch.int32
    moved = any(float((p.detach().float() - before[n].float()).abs().max())
                > 0 for n, p in model.named_parameters())
    assert moved
    # the random-init cross-entropy sanity of the forward test
    assert abs(float(m["loss"]) - np.log(cfg.vocab)) < 2.0


def _reference_step(jcfg, params, jb):
    ctx = (jax.disable_jit() if jcfg.family == "encdec"
           else contextlib.nullcontext())
    with ctx:
        step = jmake_train_step(jcfg, JAdamWConfig(lr=LR))
        if jcfg.family != "encdec":
            step = jax.jit(step)
        p2, o2, m = step(params, jinit_opt_state(params), jb)
    return p2, o2, m


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_float32_train_step_matches_reference(arch):
    jcfg, cfg, params, model = _models(arch, "float32")
    jb, tb = _batch(cfg, 3)
    p2, o2, m = _reference_step(jcfg, params, jb)
    opt_state = init_opt_state(dict(model.named_parameters()))
    model, t2, tm = make_train_step(cfg, AdamWConfig(lr=LR))(model,
                                                             opt_state, tb)
    assert _rel(tm["loss"], m["loss"]) < 1e-4
    assert _rel(tm["grad_norm"], m["grad_norm"]) < 1e-4
    assert _rel(tm["lr_scale"], m["lr_scale"]) < 1e-6
    assert int(t2["step"]) == int(o2["step"]) == 1

    def state(tree):
        return convert.state_from_jax(jax.tree.map(np.asarray, tree), cfg)
    mu, nu = state(o2["mu"]), state(o2["nu"])
    master, new = state(o2["master"]), state(p2)
    params_now = dict(model.named_parameters())
    for n in params_now:
        # the first moment is (1 - b1) clip g: the clipped gradient.  The
        # encoder's first norm takes the frames as bf16 and returns bf16
        # (the reference's cast), so its gradient is a sum of cotangents
        # rounded to bf16: 1e-3 there (measured 2.1e-4)
        tol = 1e-3 if n.startswith("encoder.0.ln1.") else 1e-4
        assert _rel(t2["mu"][n], mu[n]) < tol, n
        assert _rel(t2["nu"][n], nu[n]) < 2 * tol, n
        g = mu[n].float().numpy()
        # where |g| is below the gradients' resolution its sign, and so
        # AdamW's first step (lr * g / (|g| + eps)), is not determined
        near_zero = np.abs(g) < 2e-6 * (np.abs(g).max() + 1e-30)
        for got, want in ((t2["master"][n], master[n]),
                          (params_now[n].detach(), new[n])):
            got = got.float().numpy()
            want = want.float().numpy()
            scale = np.abs(want).max() + 1e-30
            bad = np.abs(got - want) > 1e-6 * scale + 1e-7
            assert not (bad & ~near_zero).any(), (n, np.abs(
                got - want)[bad & ~near_zero].max())


@pytest.mark.parametrize("arch", ["qwen2.5-3b-smoke",
                                  "llama-3.2-vision-11b-smoke"])
def test_flash_backward_train_step_close_to_reference(arch):
    """attn_impl="flash": the reference's hand-written backward on both
    sides (the port's forward is kernel 11's plain version, the
    reference's its bf16 oracle): loss and gradients within 3e-2."""
    jcfg, cfg, params, model = _models(arch, "float32", impl="flash")
    jb, tb = _batch(cfg, 4)
    with jax.disable_jit():
        jl, jg = jax.value_and_grad(lambda p: jlm.loss_fn(jcfg, p, jb))(
            params)
    for p in model.parameters():
        p.requires_grad_(True)
    tl = lm.loss_fn(cfg, model, tb)
    tg = torch.autograd.grad(tl, list(model.parameters()))
    assert _rel(tl.detach(), jl) < 3e-2
    want = convert.state_from_jax(jax.tree.map(np.asarray, jg), cfg)
    for (n, _), g in zip(model.named_parameters(), tg):
        assert _rel(g, want[n]) < 3e-2, n


def test_grad_accum_equivalence():
    """Twin of tests/test_training_substrate.py's: microbatches=2 gives
    (numerically close) the update of microbatches=1 on the same global
    batch, in the reference's tolerances."""
    cfg = get_config("qwen2.5-3b-smoke")
    params, _ = jlm.init_params(jget_config("qwen2.5-3b-smoke"),
                                jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    outs = []
    for mb in (1, 2):
        model = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                        cfg, lm.build_model(cfg, "cpu"))
        opt_state = init_opt_state(dict(model.named_parameters()))
        step = make_train_step(cfg, AdamWConfig(lr=1e-2), mb)
        model, _, m = step(model, opt_state, batch)
        outs.append(({n: p.detach().float() for n, p in
                      model.named_parameters()}, float(m["loss"])))
    assert abs(outs[0][1] - outs[1][1]) < 5e-3
    for n, a in outs[0][0].items():
        np.testing.assert_allclose(a.numpy(), outs[1][0][n].numpy(),
                                   rtol=2e-2, atol=2e-4)


def test_microbatched_float32_step_matches_reference():
    """microbatches=2 against the reference's `lax.scan` accumulation, on
    float32 weights: loss, gradient norm and moments to 1e-4."""
    arch = "yi-9b-smoke"
    jcfg, cfg, params, model = _models(arch, "float32")
    rng = np.random.default_rng(5)
    toks, labels = (rng.integers(0, cfg.vocab, (4, S)).astype(np.int32)
                    for _ in range(2))
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    step = jax.jit(jmake_train_step(jcfg, JAdamWConfig(lr=LR), 2))
    _, o2, m = step(params, jinit_opt_state(params), jb)
    opt_state = init_opt_state(dict(model.named_parameters()))
    _, t2, tm = make_train_step(cfg, AdamWConfig(lr=LR), 2)(model, opt_state,
                                                            tb)
    assert _rel(tm["loss"], m["loss"]) < 1e-4
    assert _rel(tm["grad_norm"], m["grad_norm"]) < 1e-4
    mu = convert.state_from_jax(jax.tree.map(np.asarray, o2["mu"]), cfg)
    for n, v in t2["mu"].items():
        assert _rel(v, mu[n]) < 1e-4, n


def test_eval_step_is_the_loss_without_gradients():
    from repro_torch.training import make_eval_step
    jcfg, cfg, params, model = _models("mamba2-370m-smoke", "float32")
    jb, tb = _batch(cfg, 6)
    got = make_eval_step(cfg)(model, tb)
    assert not got.requires_grad
    assert _rel(got, jlm.loss_fn(jcfg, params, jb)) < 1e-4


def test_remat_changes_nothing_but_memory():
    """cfg.remat (the default) checkpoints every block: the loss and the
    gradients equal those of the same step without it, bit for bit on the
    CPU (the recomputation repeats the same operations)."""
    _, cfg, _, model = _models("zamba2-7b-smoke", "float32")
    _, tb = _batch(cfg, 7)
    out = []
    for c in (cfg, dataclasses.replace(cfg, remat=False)):
        for p in model.parameters():
            p.requires_grad_(True)
        loss = lm.loss_fn(c, model, tb)
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_moe_loss_adds_the_dropped_fraction():
    """At capacity factor 1.25 the MoE layers drop assignments: the loss
    is the cross-entropy plus AUX_LOSS_WEIGHT times their summed
    `frac_dropped`, as the reference's (float32, rel 1e-4)."""
    arch = "phi3.5-moe-42b-a6.6b-smoke"

    def at125(c):
        return dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=1.25))
    jcfg, cfg, params, model = _models(arch, "float32")
    jcfg, cfg = at125(jcfg), at125(cfg)
    jb, tb = _batch(cfg, 8)
    stats = []
    h = lm._backbone_full(cfg, model, tb["tokens"].long(), stats=stats)
    aux = sum(float(st["frac_dropped"]) for st in stats)
    assert aux > 0
    assert lm.AUX_LOSS_WEIGHT == jlm.AUX_LOSS_WEIGHT
    got = float(lm.loss_fn(cfg, model, tb))
    want = float(jlm.loss_fn(jcfg, params, jb))
    assert abs(got - want) / abs(want) < 1e-4
    from repro_torch.models.common import chunked_softmax_xent
    ce = float(chunked_softmax_xent(h, lm._unembed(cfg, model),
                                    tb["labels"], cfg.loss_chunks))
    assert abs(got - (ce + lm.AUX_LOSS_WEIGHT * aux)) < 1e-5
