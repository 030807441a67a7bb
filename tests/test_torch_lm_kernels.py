"""The port's flash-attention and SSD-scan plain versions against the JAX
reference: twins of tests/test_kernels_flash.py and
tests/test_kernels_ssd.py; and the cross-attention of the vlm and encdec
families (`cross_kv`, `cross_attention`, `cross_attention_cached`), whose
prefill runs kernel 11 non-causally at S != T.

The same numpy inputs, made from a seed, go to the reference Pallas
kernel (interpret mode on the CPU) or its jnp oracle and to the port's
plain PyTorch version, which is what the port's wrappers run on CPU
tensors.  bf16 inputs are rounded from the same float32 values by both
frameworks (round to nearest even), so both sides see the same bits.
Tolerances: flash rel max error < 0.03 in bf16 and < 1e-4 in float32 (the
reference test's); SSD rtol = atol = 1e-3 on y and the final state (the
reference test's), 2e-3 against the sequential recurrence; float32 twins
of the same jnp algorithm to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as jflash
from repro.kernels.ssd_scan import ssd_scan as jssd
from repro.models import attention as jatt
from repro.models import flash as jmflash
from repro.models.mamba2 import ssd_chunked as jssd_chunked
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as tss
from repro_torch.models import attention as tatt
from repro_torch.models import flash as tmflash
from repro_torch.models.mamba2 import ssd_chunked

TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
JAX_DTYPES = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}


def _pair(a, dtype):
    """The same float32 array in both frameworks, at `dtype`."""
    a = np.asarray(a, np.float32)
    return (jnp.asarray(a, JAX_DTYPES[dtype]),
            torch.from_numpy(a).to(TORCH_DTYPES[dtype]))


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


def _np(t):
    return t.float().numpy()


# ---------------------------------------------------------------- flash

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,s,hd,bq,bk", [
    (2, 3, 128, 32, 32, 32),
    (1, 2, 256, 64, 64, 128),
    (1, 1, 512, 128, 128, 128),
    (1, 2, 128, 112, 64, 64),      # Zamba2's head dim
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_plain_matches_reference_kernel(causal, b, h, s, hd, bq, bk,
                                              dtype):
    rng = np.random.default_rng(s + hd)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.normal(size=(b, h, s, hd)),
                                          dtype) for _ in range(3))
    want = jflash(jq, jk, jv, causal, bq, bk, interpret=True)
    got = tfa.flash_attention_fwd_plain(tq, tk, tv, causal)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (b, h, s, hd)
    rel = _rel(_np(got), want)
    assert rel < (0.03 if dtype == "bfloat16" else 1e-4), rel


@pytest.mark.parametrize("s,hd", [(1000, 112), (77, 64), (300, 128)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_plain_ragged_matches_reference_blockwise(s, hd, dtype):
    """Ragged S (the reference kernel asserts s % block == 0, so the
    reference side is `_blockwise_attention`, the model's route)."""
    rng = np.random.default_rng(s)
    b, h = 1, 2
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.normal(size=(b, s, h, hd)),
                                          dtype) for _ in range(3))
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    want = jatt._blockwise_attention(jq, jk, jv, pos, 256, True)
    got = tfa.flash_attention_fwd_plain(tq.transpose(1, 2),
                                        tk.transpose(1, 2),
                                        tv.transpose(1, 2)).transpose(1, 2)
    rel = _rel(_np(got), want)
    assert rel < (0.03 if dtype == "bfloat16" else 1e-4), rel


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 2, 4, 8, 12])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_plain_gqa_matches_reference_kernel(causal, g, dtype):
    """Grouped-query attention: the plain version takes k and v with KV
    heads (query head h reads kv head h // g) and equals the reference's
    Pallas kernel fed k and v repeated g times on the reference side only
    (the kernel is MHA; the reference model groups its queries instead)."""
    rng = np.random.default_rng(100 + g)
    b, n_kv, s, hd = 1, 2, 128, 32
    h = n_kv * g
    jq, tq = _pair(rng.normal(size=(b, h, s, hd)), dtype)
    # each kv head offset apart, so that a wrong head cannot pass
    off = 3.0 * np.arange(n_kv)[None, :, None, None]
    jk, tk = _pair(rng.normal(size=(b, n_kv, s, hd)), dtype)
    jv, tv = _pair(rng.normal(size=(b, n_kv, s, hd)) + off, dtype)
    want = jflash(jq, jnp.repeat(jk, g, axis=1), jnp.repeat(jv, g, axis=1),
                  causal, 64, 64, interpret=True)
    got = tfa.flash_attention_fwd_plain(tq, tk, tv, causal)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (b, h, s, hd)
    rel = _rel(_np(got), want)
    assert rel < (0.03 if dtype == "bfloat16" else 1e-4), rel
    assert torch.equal(tops.flash_attention_fwd(tq, tk, tv, causal), got)


@pytest.mark.parametrize("s,g", [(77, 2), (300, 8), (1000, 12)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_plain_gqa_ragged_matches_reference_blockwise(s, g, dtype):
    """GQA at a ragged S against the reference model's
    `_blockwise_attention`, which groups its queries by kv head and never
    repeats k/v."""
    rng = np.random.default_rng(s + g)
    b, n_kv, hd = 1, 2, 64
    h = n_kv * g
    off = 3.0 * np.arange(n_kv)[None, None, :, None]
    jq, tq = _pair(rng.normal(size=(b, s, h, hd)), dtype)
    jk, tk = _pair(rng.normal(size=(b, s, n_kv, hd)), dtype)
    jv, tv = _pair(rng.normal(size=(b, s, n_kv, hd)) + off, dtype)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    want = jatt._blockwise_attention(jq, jk, jv, pos, 256, True)
    got = tfa.flash_attention_fwd_plain(tq.transpose(1, 2),
                                        tk.transpose(1, 2),
                                        tv.transpose(1, 2)).transpose(1, 2)
    rel = _rel(_np(got), want)
    assert rel < (0.03 if dtype == "bfloat16" else 1e-4), rel


@pytest.mark.parametrize("s,t,g", [(37, 16, 4), (64, 1601, 4),
                                   (300, 77, 1), (7, 1500, 1)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_plain_cross_matches_reference_blockwise(s, t, g, dtype):
    """Non-causal, S queries against T != S keys (cross-attention: S > T
    and S < T, ragged T = 1,601 and 1,500 as Llama-3.2-Vision's image
    tokens and Whisper's frames, GQA), against the reference model's
    `_blockwise_attention(..., causal=False)`."""
    rng = np.random.default_rng(s + t + g)
    b, n_kv, hd = 1, 2, 32
    h = n_kv * g
    off = 3.0 * np.arange(n_kv)[None, None, :, None]
    jq, tq = _pair(rng.normal(size=(b, s, h, hd)), dtype)
    jk, tk = _pair(rng.normal(size=(b, t, n_kv, hd)), dtype)
    jv, tv = _pair(rng.normal(size=(b, t, n_kv, hd)) + off, dtype)
    pos = jnp.zeros((b, s), jnp.int32)
    want = jatt._blockwise_attention(jq, jk, jv, pos, min(512, t), False)
    got = tops.flash_attention_fwd(tq.transpose(1, 2), tk.transpose(1, 2),
                                   tv.transpose(1, 2), False).transpose(1, 2)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (b, s, h, hd)
    rel = _rel(_np(got), want)
    assert rel < (0.03 if dtype == "bfloat16" else 1e-4), rel


def _cross_params(d, h, n_kv, hd, dtype, seed):
    """A reference `gqa_init` tree (as cross-attention's) at `dtype`, and
    the port's `GQA` holding the same values."""
    jp, _ = jatt.gqa_init(jax.random.PRNGKey(seed), d, h, n_kv, hd)
    jp = {k: v.astype(JAX_DTYPES[dtype]) for k, v in jp.items()}
    tp = tatt.GQA(d, h, n_kv, hd, dtype=TORCH_DTYPES[dtype], device="cpu")
    tp.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                        .to(TORCH_DTYPES[dtype]) for k, v in jp.items()})
    return jp, tp


# (weights, queries' source, kv source): one dtype, and the mixes the
# models meet (a bf16 batch's image embeddings against float32 weights, a
# float32 one against bf16 weights), which JAX's `@` promotes
CROSS_DTYPES = [("float32",) * 3, ("bfloat16",) * 3,
                ("float32", "float32", "bfloat16"),
                ("bfloat16", "bfloat16", "float32")]


@pytest.mark.parametrize("s,t,h,n_kv", [(5, 33, 4, 2), (40, 17, 8, 2),
                                        (1, 50, 4, 4)])
@pytest.mark.parametrize("wdt,xdt,sdt", CROSS_DTYPES)
def test_cross_attention_twins_match_reference(s, t, h, n_kv, wdt, xdt,
                                               sdt):
    """`cross_kv`, `cross_attention` (prefill, kernel 11's plain version,
    non-causal) and `cross_attention_cached` (decode against cross_kv's k
    and v) against the reference's, on the same parameters and inputs:
    outputs, dtypes and shapes; rel 1e-4 where everything is float32,
    3e-2 where bf16 enters."""
    d, hd = 32, 16
    jp, tp = _cross_params(d, h, n_kv, hd, wdt, s + t)
    rng = np.random.default_rng(s * t)
    jx, tx = _pair(rng.normal(size=(2, s, d)), xdt)
    jsrc, tsrc = _pair(rng.normal(size=(2, t, d)), sdt)
    tol = 1e-4 if wdt == xdt == sdt == "float32" else 3e-2

    jk, jv = jatt.cross_kv(jp, jsrc, n_kv, hd)
    tk, tv = tatt.cross_kv(tp, tsrc, n_kv, hd)
    for j, tt in ((jk, tk), (jv, tv)):
        assert tt.shape == j.shape == (2, t, n_kv, hd)
        assert str(tt.dtype).split(".")[-1] == str(j.dtype)
        assert _rel(_np(tt), j) < tol
    want = jatt.cross_attention(jp, jx, jsrc, h, n_kv, hd)
    got, (k2, v2) = tatt.cross_attention(tp, tx, tsrc, h, n_kv, hd,
                                         return_kv=True)
    assert got.shape == want.shape and str(got.dtype).split(".")[-1] \
        == str(want.dtype)
    assert _rel(_np(got), want) < tol
    assert torch.equal(k2, tk) and torch.equal(v2, tv)
    want = jatt.cross_attention_cached(jp, jx, jk, jv, h, n_kv, hd)
    got = tatt.cross_attention_cached(tp, tx, tk, tv, h, n_kv, hd)
    assert got.shape == want.shape and str(got.dtype).split(".")[-1] \
        == str(want.dtype)
    assert _rel(_np(got), want) < tol


def test_cross_attention_runs_kernel_11_non_causally(monkeypatch):
    """Cross-attention's prefill hands kernel 11 q (B, H, S, hd) and k, v
    (B, KV, T, hd) with T != S, unrepeated and uncopied, and
    `causal=False`."""
    seen = []

    def spy(q, k, v, causal=True):
        seen.append((tuple(q.shape), tuple(k.shape), k.is_contiguous(),
                     causal))
        return tfa.flash_attention_fwd_plain(q, k, v, causal)

    monkeypatch.setattr(tops, "flash_attention_fwd", spy)
    _, tp = _cross_params(64, 8, 2, 16, "bfloat16", 3)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 10, 64, generator=gen).bfloat16()
    src = torch.randn(2, 21, 64, generator=gen).bfloat16()
    y = tatt.cross_attention(tp, x, src, 8, 2, 16)
    assert y.shape == (2, 10, 64)
    assert seen == [((2, 8, 10, 16), (2, 2, 21, 16), False, False)]


@pytest.mark.parametrize("h,n_kv", [(6, 4), (8, 3), (4, 8)])
def test_flash_raises_unless_kv_heads_divide_query_heads(h, n_kv):
    """k's heads must divide q's (the wrapper's check and its plain
    version's); nothing is repeated or truncated to make them fit."""
    q = torch.zeros(1, h, 16, 32)
    kv = torch.zeros(1, n_kv, 16, 32)
    with pytest.raises(ValueError, match="multiple"):
        tops.flash_attention_fwd(q, kv, kv)
    with pytest.raises(ValueError, match="multiple"):
        tfa._check(q.bfloat16(), kv.bfloat16(), kv.bfloat16())


def test_model_attention_passes_kv_heads_unrepeated(monkeypatch):
    """`self_attention` hands the kernel k and v with KV heads, in the
    model's (B, S, KV, hd) storage seen as (B, KV, S, hd): no repeat and
    no copy."""
    seen = []

    def spy(q, k, v, causal=True):
        seen.append((tuple(q.shape), tuple(k.shape), k.is_contiguous()))
        return tfa.flash_attention_fwd_plain(q, k, v, causal)

    monkeypatch.setattr(tops, "flash_attention_fwd", spy)
    p = tatt.GQA(64, 8, 2, 16, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 10, 64, generator=torch.Generator().manual_seed(1)) \
        .bfloat16()
    pos = torch.arange(10, dtype=torch.int32)[None].expand(2, 10)
    y = tatt.self_attention(p, x, pos, 8, 2, 16, 10000.0)
    assert y.shape == (2, 10, 64)
    assert seen == [((2, 8, 10, 16), (2, 2, 10, 16), False)]


@pytest.mark.parametrize("kv_chunk,n_kv", [(32, 4), (48, 2), (1024, 1)])
def test_blockwise_attention_matches_reference(kv_chunk, n_kv):
    """The port's `_blockwise_attention` (GQA, ragged KV chunks) against
    the reference's, float32, rtol 1e-5 of the max."""
    rng = np.random.default_rng(kv_chunk)
    b, s, h, hd = 2, 100, 4, 16
    jq, tq = _pair(rng.normal(size=(b, s, h, hd)), "float32")
    jk, tk = _pair(rng.normal(size=(b, s, n_kv, hd)), "float32")
    jv, tv = _pair(rng.normal(size=(b, s, n_kv, hd)), "float32")
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    want = jatt._blockwise_attention(jq, jk, jv, jnp.asarray(pos), kv_chunk,
                                     True)
    got = tatt._blockwise_attention(tq, tk, tv, torch.from_numpy(pos.copy()),
                                    kv_chunk, True)
    assert _rel(_np(got), want) < 1e-5


def test_model_flash_forward_matches_reference():
    """models/flash.py `_flash_fwd_impl` (bf16 operands, float32
    statistics) against the reference's: o to rel 0.03 (bf16 output), the
    float32 log-sum-exp to rtol 1e-5."""
    rng = np.random.default_rng(1)
    b, s, h, hd = 2, 128, 4, 32
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.normal(size=(b, s, h, hd)),
                                          "bfloat16") for _ in range(3))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    jo, jlse = jmflash._flash_fwd_impl(jq, jk, jv, jnp.asarray(pos), 32, True)
    to, tlse = tmflash._flash_fwd_impl(tq, tk, tv,
                                       torch.from_numpy(pos.copy()), 32, True)
    assert _rel(_np(to), jo) < 0.03
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------- SSD

def _ssd_inputs(rng, b, s, h, p, n, groups=None):
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    a = -np.exp(rng.normal(size=h)).astype(np.float32)
    shape = (b, s, n) if groups is None else (b, s, groups, n)
    bm = rng.normal(size=shape).astype(np.float32)
    cm = rng.normal(size=shape).astype(np.float32)
    return x, dt, a, bm, cm


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 4, 16, 8, 16),
    (1, 128, 2, 32, 16, 32),
    (2, 256, 8, 64, 128, 64),   # mamba2-370m-like head geometry
    (1, 128, 4, 112, 64, 32),   # zamba2-like headdim/state
])
def test_ssd_plain_matches_reference_kernel(b, s, h, p, n, chunk):
    """y against the reference kernel (interpret mode), the final state
    against the reference's `ssd_chunked` (the kernel drops it)."""
    rng = np.random.default_rng(s * h)
    x, dt, a, bm, cm = _ssd_inputs(rng, b, s, h, p, n)
    want_y = jssd(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a),
                  jnp.asarray(bm), jnp.asarray(cm), chunk, interpret=True)
    _, want_state = jssd_chunked(jnp.asarray(x), jnp.asarray(dt),
                                 jnp.asarray(a), jnp.asarray(bm[:, :, None]),
                                 jnp.asarray(cm[:, :, None]), jnp.zeros(h),
                                 chunk)
    y, state = tss.ssd_scan_plain(_t(x), _t(dt), _t(a), _t(bm), _t(cm), chunk)
    assert y.dtype == torch.float32 and state.shape == (b, h, p, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("s,chunk", [(1000, 256), (37, 16), (256, 256)])
def test_ssd_plain_ragged_matches_reference_chunked(s, chunk):
    """Ragged S (padded with dt = 0 rows) with the D skip, against the
    reference's `ssd_chunked`: y and the final state, rtol = atol = 1e-3."""
    rng = np.random.default_rng(s)
    b, h, p, n = 1, 4, 112, 64
    x, dt, a, bm, cm = _ssd_inputs(rng, b, s, h, p, n)
    d = rng.normal(size=h).astype(np.float32)
    want_y, want_state = jssd_chunked(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a),
        jnp.asarray(bm[:, :, None]), jnp.asarray(cm[:, :, None]),
        jnp.asarray(d), chunk)
    y, state = tops.ssd_scan(_t(x), _t(dt), _t(a), _t(bm), _t(cm), chunk,
                             d=_t(d))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("groups,init", [(1, False), (2, True)])
def test_ssd_chunked_matches_reference(groups, init):
    """The port's `ssd_chunked` (ngroups 1 and 2, an initial state, bf16
    x, B, C) against the reference's: the same jnp algorithm in torch,
    rtol 1e-5 in float32 compute (y is rounded to bf16 on both sides from
    float32 sums that agree to 1e-5, so y may differ by one bf16 step)."""
    rng = np.random.default_rng(groups)
    b, s, h, p, n, chunk = 2, 48, 4, 8, 6, 16
    x, dt, a, bm, cm = _ssd_inputs(rng, b, s, h, p, n, groups=groups)
    d = rng.normal(size=h).astype(np.float32)
    s0 = rng.normal(size=(b, h, p, n)).astype(np.float32) if init else None
    jx, tx = _pair(x, "bfloat16")
    jb, tb = _pair(bm, "bfloat16")
    jc, tc = _pair(cm, "bfloat16")
    want_y, want_state = jssd_chunked(
        jx, jnp.asarray(dt), jnp.asarray(a), jb, jc, jnp.asarray(d), chunk,
        None if s0 is None else jnp.asarray(s0))
    y, state = ssd_chunked(tx, _t(dt), _t(a), tb, tc, _t(d), chunk,
                           None if s0 is None else _t(s0))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state),
                               rtol=1e-5, atol=1e-5)
    want = np.asarray(want_y, np.float32)
    assert np.all(np.abs(_np(y) - want) <= 2.0 ** -7 * np.abs(want) + 1e-6)


def test_ssd_plain_sequential_ground_truth():
    """Direct check against the raw recurrence, y and the final state
    (rtol = atol = 2e-3, the reference test's)."""
    rng = np.random.default_rng(7)
    b, s, h, p, n, chunk = 1, 32, 2, 8, 4, 8
    x, dt, a, bm, cm = _ssd_inputs(rng, b, s, h, p, n)
    state = np.zeros((b, h, p, n), np.float32)
    ys = []
    for t in range(s):
        da = np.exp(dt[:, t] * a[None])
        state = state * da[:, :, None, None] \
            + dt[:, t][:, :, None, None] * x[:, t][..., None] \
            * bm[:, t][:, None, None, :]
        ys.append(np.einsum("bhpn,bn->bhp", state, cm[:, t]))
    y, got_state = tss.ssd_scan_plain(_t(x), _t(dt), _t(a), _t(bm), _t(cm),
                                      chunk)
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(got_state.numpy(), state, rtol=2e-3,
                               atol=2e-3)


def test_lm_wrappers_run_plain_on_cpu_without_launching():
    tops.reset_launch_counts()
    rng = np.random.default_rng(3)
    q = _t(rng.normal(size=(1, 2, 10, 8)).astype(np.float32))
    assert torch.equal(tops.flash_attention_fwd(q, q, q),
                       tfa.flash_attention_fwd_plain(q, q, q))
    x, dt, a, bm, cm = (_t(v) for v in _ssd_inputs(rng, 1, 10, 2, 4, 3))
    y, st = tops.ssd_scan(x, dt, a, bm, cm, 4)
    y2, st2 = tss.ssd_scan_plain(x, dt, a, bm, cm, 4)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    counts = tops.launch_counts()
    assert counts["flash_attention_fwd"] == 0 and counts["ssd_scan"] == 0


def test_lm_wrappers_reject_bad_operands():
    with pytest.raises(ValueError):
        tops.ssd_scan(*(torch.zeros(1),) * 5, chunk=0)
    x = torch.zeros(1, 2, 3, 4)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(x, x, x.to("meta"))
