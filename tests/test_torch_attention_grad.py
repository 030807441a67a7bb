"""Attention's backward and A.5.3's options in the port, against the JAX
reference on the CPU: twins of tests/test_perf_variants.py's
`test_flash_matches_blockwise` (6 cases), `test_flash_gradients_match_
autodiff`, `test_scores_bf16_loss_close`, `test_flash_variant_full_model`
and `test_kv_int8_decode_close`, and direct checks of the pieces
(`models/flash.py`'s two backwards, kernel 11's log-sum-exp output,
`attention.quantize_kv` / `decode_attention_q8`, the bf16-score route).

The same numpy inputs, drawn from a seed, go to both packages.
Tolerances: the reference test's own bounds where it has them (0.05 on
flash vs blockwise outputs, 0.06 on their gradients, 0.02 on the bf16
score loss, TV 0.05 and the same argmax for the int8 cache); float32
against float32 at 1e-5 (the exact backward, the log-sum-exp); a bf16
computation against the reference's op by op at the bf16 step its
rounding allows, stated per test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jatt
from repro.models import flash as jflash
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as kf
from repro_torch.models import attention as tatt
from repro_torch.models import convert, lm
from repro_torch.models import flash as tflash


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _rel(got, want):
    got = np.asarray(got.detach().float().numpy()
                     if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _both(a, dtype):
    """(jax array, torch tensor) of numpy a in `dtype`."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


# ---------------------------------------------------------------------------
# twins of tests/test_perf_variants.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,kv_chunk", [(64, 16), (128, 64), (32, 32)])
def test_flash_matches_blockwise(causal, s, kv_chunk):
    """The port's flash route (kernel 11's plain version under the
    autograd Function) against its blockwise loop, at the reference
    test's bound; and both against the reference's outputs."""
    b, h, kv, hd = 2, 8, 2, 16
    qa, ka, va = _draw(s + int(causal), (b, s, h, hd), (b, s, kv, hd),
                       (b, s, kv, hd))
    (jq, q), (jk, k), (jv, v) = (_both(a, "bfloat16") for a in (qa, ka, va))
    pos = np.broadcast_to(np.arange(s)[None], (b, s))
    o1 = tflash.attention(q, k, v, causal, "flash", kv_chunk)
    o2 = tatt._blockwise_attention(q, k, v, torch.from_numpy(pos.copy()),
                                   kv_chunk, causal)
    np.testing.assert_allclose(o1.float().numpy(), o2.float().numpy(),
                               rtol=0.05, atol=0.05)
    want = jatt._blockwise_attention(jq, jk, jv, jnp.asarray(pos), kv_chunk,
                                     causal)
    assert _rel(o2, want) < 2e-2          # bf16 outputs, one rounding
    jo = jflash.flash_attention(jq, jk, jv, jnp.asarray(pos), kv_chunk,
                                causal)
    np.testing.assert_allclose(o1.float().numpy(), np.asarray(jo, np.float32),
                               rtol=0.05, atol=0.05)


def test_flash_gradients_match_autodiff():
    """The reference's hand-written backward (`bwd="flash"`) against
    autograd of the blockwise loop, the reference test's 0.06; and
    against the reference's own flash gradients."""
    b, s, h, kv, hd = 2, 64, 4, 2, 16
    qa, ka, va = _draw(1, (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    (jq, q), (jk, k), (jv, v) = (_both(a, "bfloat16") for a in (qa, ka, va))
    pos = np.broadcast_to(np.arange(s)[None], (b, s))
    tpos = torch.from_numpy(pos.copy())

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        loss = (fn(*ins).float() ** 2).sum()
        return torch.autograd.grad(loss, ins)
    gf = grads(lambda q, k, v: tflash.attention(q, k, v, True, "flash", 16))
    gr = grads(lambda q, k, v: tatt._blockwise_attention(q, k, v, tpos, 16,
                                                         True))
    for a, b_ in zip(gf, gr):
        assert _rel(a, b_.float().numpy()) < 0.06

    def jlf(q, k, v):
        return jnp.sum(jflash.flash_attention(q, k, v, jnp.asarray(pos), 16,
                                              True).astype(jnp.float32) ** 2)
    jg = jax.grad(jlf, argnums=(0, 1, 2))(jq, jk, jv)
    for a, b_ in zip(gf, jg):
        assert _rel(a, np.asarray(b_, np.float32)) < 0.06


def _smoke_models(name, dtype="bfloat16", seed=0, **kw):
    jcfg = dataclasses.replace(jget_config(name), **kw)
    cfg = dataclasses.replace(get_config(name), **kw)
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                    lm.build_model(cfg, "cpu"))
    return jcfg, cfg, params, model


def _lm_batch(cfg, seed, b=2, s=64):
    rng = np.random.default_rng(seed)
    toks, labels = (rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
                    for _ in range(2))
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def test_scores_bf16_loss_close():
    """bf16 scores move the loss by less than the reference test's 0.02;
    the port's bf16-score loss equals the reference's (op by op) to 1e-3
    relative."""
    jcfg, cfg, params, model = _smoke_models("yi-9b-smoke")
    cfg_bf = dataclasses.replace(cfg, attn_scores_dtype="bf16")
    jb, tb = _lm_batch(cfg, 2)
    with torch.no_grad():
        l1 = float(lm.loss_fn(cfg, model, tb))
        l2 = float(lm.loss_fn(cfg_bf, model, tb))
    assert abs(l1 - l2) < 0.02
    with jax.disable_jit():
        want = float(jlm.loss_fn(dataclasses.replace(
            jcfg, attn_scores_dtype="bf16"), params, jb))
    assert abs(l2 - want) / abs(want) < 1e-3


def test_flash_variant_full_model():
    """attn_impl="flash" computes the same forward as the default (kernel
    11 either way: only the backward differs), so the losses agree within
    the reference test's 0.02 (exactly, here), and its gradients agree
    with the exact ones within the flash-gradient bound 0.06."""
    _, base, _, model = _smoke_models("phi3-medium-14b-smoke")
    cfg = dataclasses.replace(base, attn_impl="flash")
    _, tb = _lm_batch(base, 3)
    for p in model.parameters():
        p.requires_grad_(True)
    out = []
    for c in (base, cfg):
        loss = lm.loss_fn(c, model, tb)
        out.append((float(loss), torch.autograd.grad(
            loss, list(model.parameters()))))
    assert abs(out[0][0] - out[1][0]) < 0.02, (out[0][0], out[1][0])
    for a, b_ in zip(out[1][1], out[0][1]):
        assert _rel(a, b_.float().numpy()) < 0.06


def test_kv_int8_decode_close():
    """The int8 cache: k int8, k_scale kept, one decode step within TV
    0.05 of the bf16 cache's with the same argmax (the reference test's
    bounds)."""
    _, cfg, _, model = _smoke_models("phi3-medium-14b-smoke")
    cfgq = dataclasses.replace(cfg, kv_cache_quant=True)
    b, s, maxs = 2, 48, 64
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (b, s)).astype(np.int32))
    lg1, c1 = lm.prefill_fn(cfg, model, {"tokens": toks}, maxs)
    lg2, c2 = lm.prefill_fn(cfgq, model, {"tokens": toks}, maxs)
    assert c2["k"].dtype == torch.int8 and c2["v"].dtype == torch.int8
    assert "k_scale" in c2 and c2["k_scale"].dtype == torch.bfloat16
    assert c2["k_scale"].shape == c2["k"].shape[:-1]
    tok = torch.argmax(lg1[:, 0], -1)[:, None]
    d1, _ = lm.decode_fn(cfg, model, tok, c1, s)
    d2, _ = lm.decode_fn(cfgq, model, tok, c2, s)
    p1, p2 = torch.softmax(d1[:, 0], -1), torch.softmax(d2[:, 0], -1)
    tv = float(0.5 * (p1 - p2).abs().sum(-1).max())
    assert tv < 0.05
    assert bool((d1[:, 0].argmax(-1) == d2[:, 0].argmax(-1)).all())


# ---------------------------------------------------------------------------
# the int8 cache and bf16 scores against the reference
# ---------------------------------------------------------------------------

def test_quantize_kv_matches_reference():
    (a,) = _draw(5, (2, 7, 3, 16))
    a[0, 0, 0] = 0.0                  # an all-zero row: scale 1e-8
    jq, js = jatt.quantize_kv(jnp.asarray(a))
    tq, ts = tatt.quantize_kv(torch.from_numpy(a))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js, np.float32))


@pytest.mark.parametrize("name", ["phi3-medium-14b-smoke",
                                  "phi3.5-moe-42b-a6.6b-smoke"])
def test_int8_cache_prefill_and_decode_match_reference(name):
    """A GQA dense and a GQA moe model with `kv_cache_quant`, float32
    weights: the prefill's int8 caches equal the reference's (values
    exactly but for a rounding tie in 1e-3 of them, scales to bf16
    rounding), and two decode steps' logits to rel 1e-3 (the decode
    rounds the scaled q and the scaled weights to bf16, so a flipped
    rounding moves a logit by about 2^-9 of a term; 3.1e-4 measured)."""
    jcfg, cfg, params, model = _smoke_models(name, "float32", seed=1,
                                             kv_cache_quant=True)
    b, s, maxs = 2, 37, 48
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)
    jl, jc = jlm.prefill_fn(jcfg, params, {"tokens": jnp.asarray(toks)},
                            maxs)
    tl, tc = lm.prefill_fn(cfg, model, {"tokens": torch.from_numpy(toks)},
                           maxs)
    assert sorted(tc) == sorted(jc) == ["k", "k_scale", "v", "v_scale"]
    assert _rel(tl, jl) < 1e-4
    for key in ("k", "v"):
        off = np.abs(tc[key].numpy().astype(int) - np.asarray(jc[key])
                     .astype(int))
        assert off.max() <= 1 and (off > 0).mean() < 1e-3, key
        assert _rel(tc[key + "_scale"], jc[key + "_scale"]) < 2 ** -8
    tok = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)[:, None]
    for i in range(2):
        jd, jc = jlm.decode_fn(jcfg, params, jnp.asarray(tok), jc,
                               jnp.int32(s + i))
        td, tc = lm.decode_fn(cfg, model, torch.from_numpy(tok), tc, s + i)
        assert _rel(td, jd) < 1e-3, i
        tok = np.asarray(jnp.argmax(jd[:, 0], -1)).astype(np.int32)[:, None]


@pytest.mark.parametrize("n_kv,s,kv_chunk", [(2, 64, 16), (8, 37, 16),
                                             (2, 40, 64)])
def test_blockwise_bf16_scores_match_reference(n_kv, s, kv_chunk):
    """`_blockwise_attention(scores_dtype="bf16")` against the
    reference's, op by op: one bf16 step of the output's largest entry
    (the score, probability and exp roundings are the reference's)."""
    b, h, hd = 2, 8, 16
    qa, ka, va = _draw(7 + s, (b, s, h, hd), (b, s, n_kv, hd),
                       (b, s, n_kv, hd))
    pos = np.broadcast_to(np.arange(s)[None], (b, s))
    for dtype in ("float32", "bfloat16"):
        (jq, q), (jk, k), (jv, v) = (_both(a, dtype) for a in (qa, ka, va))
        with jax.disable_jit():
            want = jatt._blockwise_attention(jq, jk, jv, jnp.asarray(pos),
                                             kv_chunk, True,
                                             scores_dtype="bf16")
        got = tatt._blockwise_attention(q, k, v, torch.from_numpy(pos.copy()),
                                        kv_chunk, True, scores_dtype="bf16")
        assert got.dtype == q.dtype
        assert _rel(got, want) < 2 ** -7, dtype


def test_bf16_score_route_runs_plain_and_flash_ignores_it(monkeypatch):
    """`attention_route` follows the reference: bf16 scores take the plain
    blockwise loop (kernel 11 never sees them), attn_impl="flash" takes
    kernel 11 whatever the score dtype where T divides into chunks, and
    the blockwise loop where it does not."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.flash_attention_fwd

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention_fwd", spy)
    assert tatt.attention_route("blockwise", "bf16", 64, 1024) == "bf16"
    assert tatt.attention_route("flash", "bf16", 64, 16) == "flash"
    assert tatt.attention_route("flash", "bf16", 40, 16) == "bf16"
    assert tatt.attention_route("flash", "f32", 40, 16) == "exact"
    assert tatt.attention_route("blockwise", "f32", 64, 16) == "exact"
    _, cfg, _, model = _smoke_models("yi-9b-smoke", attn_scores_dtype="bf16")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    lm.prefill_fn(cfg, model, {"tokens": toks}, 8)
    assert calls == []
    lm.prefill_fn(dataclasses.replace(cfg, attn_impl="flash", kv_chunk=8),
                  model, {"tokens": toks}, 8)
    assert len(calls) == cfg.n_layers


# ---------------------------------------------------------------------------
# models/flash.py's backwards and kernel 11's log-sum-exp
# ---------------------------------------------------------------------------

def _residuals(seed, b, s, t, h, kv, hd, dtype, causal):
    """The same (q, k, v, positions, o, lse, d_o) for both packages: o and
    lse from the reference's oracle, rounded through `dtype`."""
    qa, ka, va, da = _draw(seed, (b, s, h, hd), (b, t, kv, hd),
                           (b, t, kv, hd), (b, s, h, hd))
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    (jq, q), (jk, k), (jv, v), (jd, d) = (_both(a, dtype)
                                          for a in (qa, ka, va, da))
    # a chunk dividing T, for the reference's oracle and backward
    jo, jl = jflash._flash_fwd_impl(jq, jk, jv, jnp.asarray(pos), t, causal)
    o = torch.from_numpy(np.array(jo, np.float32)).to(q.dtype)
    lse = torch.from_numpy(np.array(jl))
    return ((jq, jk, jv, jnp.asarray(pos), jo, jl), jd,
            (q, k, v, torch.from_numpy(pos.copy()), o, lse), d)


@pytest.mark.parametrize("b,s,t,h,kv,hd,dtype,causal,chunk", [
    (2, 64, 64, 4, 2, 16, "bfloat16", True, 16),
    (1, 48, 48, 8, 8, 32, "float32", True, 48),
    (2, 40, 40, 6, 2, 16, "bfloat16", True, 16),     # ragged: 16 + 16 + 8
    (2, 24, 37, 4, 1, 16, "float32", False, 16),     # cross, ragged T
])
def test_flash_bwd_matches_reference(b, s, t, h, kv, hd, dtype, causal,
                                     chunk):
    """The port's `_flash_bwd` against the reference's on the same
    residuals.  The reference takes T / kv_chunk chunks (no ragged last
    one), so it runs with chunk = T; the chunking changes only the float32
    summation order, and with it a rare bf16 rounding of dS: rel 2^-8."""
    jres, jd, tres, d = _residuals(s + t + h, b, s, t, h, kv, hd, dtype,
                                   causal)
    want = jflash._flash_bwd(t, causal, jres, jd)[:3]
    got = tflash._flash_bwd(chunk, causal, tres, d)
    for g, w, x in zip(got, want, tres[:3]):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert _rel(g, np.asarray(w, np.float32)) < 2 ** -8


@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,chunk", [
    (2, 32, 32, 4, 4, 16, True, 8),
    (2, 33, 33, 8, 2, 16, True, 16),       # GQA, ragged
    (1, 20, 45, 4, 1, 8, False, 16),       # cross-attention, ragged T
])
def test_exact_bwd_matches_reference_autodiff(b, s, t, h, kv, hd, causal,
                                              chunk):
    """`_exact_bwd` is the gradient the reference's autodiff takes of its
    float32 blockwise forward: q, k, v gradients to 1e-5."""
    qa, ka, va, da = _draw(s * t, (b, s, h, hd), (b, t, kv, hd),
                           (b, t, kv, hd), (b, s, h, hd))
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)

    def jf(q, k, v):
        o = jatt._blockwise_attention(q, k, v, jnp.asarray(pos), chunk,
                                      causal)
        return jnp.sum(o * jnp.asarray(da))
    want = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (qa, ka, va)))
    q, k, v = (torch.from_numpy(a) for a in (qa, ka, va))
    o, lse = kf.flash_attention_fwd_plain(q.transpose(1, 2),
                                          k.transpose(1, 2),
                                          v.transpose(1, 2), causal,
                                          return_lse=True)
    lse = lse.transpose(1, 2).reshape(b, s, kv, h // kv)
    got = tflash._exact_bwd(chunk, causal, (q, k, v, torch.from_numpy(
        pos.copy()), o.transpose(1, 2), lse), torch.from_numpy(da))
    for g, w in zip(got, want):
        assert _rel(g, np.asarray(w)) < 1e-5


@pytest.mark.parametrize("causal", [True, False])
def test_attention_function_matches_plain_autograd(causal):
    """Through `FlashAttention` (kernel 11's plain version forward, the
    exact backward) the gradients of a loss equal autograd's through the
    plain masked softmax, float32, to 1e-5; the output is the plain
    version's bit for bit."""
    b, s, h, kv, hd = 2, 21, 6, 3, 8
    qa, ka, va, wa = _draw(11, (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd),
                           (b, s, h, hd))
    w = torch.from_numpy(wa)

    def run(fn):
        ins = [torch.from_numpy(a).requires_grad_(True) for a in (qa, ka, va)]
        o = fn(*ins)
        return o.detach(), torch.autograd.grad((o * w).sum(), ins)
    o1, g1 = run(lambda q, k, v: tflash.attention(q, k, v, causal, "exact",
                                                  8))
    o2, g2 = run(lambda q, k, v: kf.flash_attention_fwd_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal).transpose(1, 2))
    assert torch.equal(o1, o2)
    for a, b_ in zip(g1, g2):
        assert _rel(a, b_.numpy()) < 1e-5


@pytest.mark.parametrize("causal,s,t", [(True, 40, 40), (False, 24, 37)])
def test_lse_matches_reference(causal, s, t):
    """Kernel 11's plain version returns each row's log-sum-exp of its
    scaled, masked scores (B, H, S): float64 numpy's to 1e-5, and the
    reference oracle's (its (B, S, KV, G) layout, its l summing bf16
    probabilities) to 2e-3."""
    b, h, kv, hd = 2, 8, 2, 16          # 1 / sqrt(16): exact in bf16
    qa, ka, va = _draw(s + t, (b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd))
    qa, ka, va = (np.asarray(jnp.asarray(a).astype(jnp.bfloat16),
                             np.float32) for a in (qa, ka, va))
    q, k, v = (torch.from_numpy(a).transpose(1, 2) for a in (qa, ka, va))
    out, lse = kf.flash_attention_fwd_plain(q, k, v, causal, return_lse=True)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    assert torch.equal(out, kf.flash_attention_fwd_plain(q, k, v, causal))
    g = h // kv
    sc = np.einsum("bskgd,btkd->bkgst", qa.reshape(b, s, kv, g, hd)
                   .astype(np.float64), ka.astype(np.float64)) / np.sqrt(hd)
    if causal:
        sc = np.where(np.tril(np.ones((s, t), bool)), sc, -np.inf)
    m = sc.max(-1, keepdims=True)
    want = (m + np.log(np.exp(sc - m).sum(-1, keepdims=True)))[..., 0]
    assert np.abs(lse.numpy() - want.reshape(b, h, s)).max() < 1e-5
    if t % 8 == 0 or not causal:
        pos = np.broadcast_to(np.arange(s)[None], (b, s))
        _, jl = jflash._flash_fwd_impl(
            *(jnp.asarray(a).astype(jnp.bfloat16) for a in (qa, ka, va)),
            jnp.asarray(pos), t, causal)
        jl = np.asarray(jl).transpose(0, 2, 3, 1).reshape(b, h, s)
        assert np.abs(lse.numpy() - jl).max() < 2e-3


@pytest.mark.parametrize("name", ["phi3-medium-14b-smoke",
                                  "phi3.5-moe-42b-a6.6b-smoke"])
def test_bf16_scores_prefill_matches_reference(name):
    """A GQA dense and a GQA moe model with `attn_scores_dtype="bf16"`,
    float32 weights: prefill logits and caches equal the reference's run
    op by op under the same configuration, to 2^-7 (the bf16 scores'
    rounding)."""
    jcfg, cfg, params, model = _smoke_models(name, "float32", seed=2,
                                             attn_scores_dtype="bf16")
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 40)).astype(
        np.int32)
    with jax.disable_jit():
        jl, jc = jlm.prefill_fn(jcfg, params, {"tokens": jnp.asarray(toks)},
                                48)
    tl, tc = lm.prefill_fn(cfg, model, {"tokens": torch.from_numpy(toks)},
                           48)
    assert sorted(tc) == sorted(jc)
    assert _rel(tl, jl) < 2 ** -7
    for key in jc:
        assert _rel(tc[key], jc[key]) < 2 ** -7, key
