"""The plain reference's block of family "ssm" (Mamba2, arXiv:2405.21060):
per layer x += Mamba2(RMSNorm(x)): in_proj to [z, x, B, C, dt]; a
depthwise causal convolution with bias and SiLU over [x, B, C]; dt =
softplus(dt + dt_bias), A = -exp(A_log); the SSD recurrence h_t = exp(dt_t
A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t + D x_t, computed in chunks (the
paper's minimal SSD); y = RMSNorm(y * SiLU(z)); out_proj.  In float32;
`prec` as `lm.py` says.

It imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from shark_bench.reference.lm import Params, mm, rmsnorm


def _segsum(x):
    """x (..., T) -> (..., T, T): sum of x[j+1..i] at [i, j], -inf above
    the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd(x, a, bm, cm, chunk: int):
    """The paper's minimal SSD.  x (b, s, h, p) already times dt; a (b, s,
    h) = dt * A; bm, cm (b, s, g, n).  Returns y (b, s, h, p) without the
    D skip."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    pad = (-s) % chunk
    if pad:   # zero rows: no input, no decay; their outputs are dropped
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, 0, 0, pad))
    c = (s + pad) // chunk
    hg = h // g
    x = x.reshape(b, c, chunk, h, p)
    a = a.reshape(b, c, chunk, h).permute(0, 3, 1, 2)          # (b, h, c, l)
    bm = bm.reshape(b, c, chunk, g, n)
    cm = cm.reshape(b, c, chunk, g, n)
    a_cs = torch.cumsum(a, dim=-1)
    # 1. within a chunk
    L = torch.exp(_segsum(a))                                  # (b, h, c, l, l)
    cb = torch.einsum("bclgn,bcsgn->bcgls", cm, bm)
    cb = cb.repeat_interleave(hg, dim=2)                       # (b, c, h, l, l)
    y = torch.einsum("bchls,bcshp->bclhp", cb * L.permute(0, 2, 1, 3, 4), x)
    # 2. each chunk's state
    decay = torch.exp(a_cs[..., -1:] - a_cs)                   # (b, h, c, l)
    bh = bm.repeat_interleave(hg, dim=3)                       # (b, c, l, h, n)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", bh, decay, x)
    # 3. across chunks
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    dchunk = torch.exp(_segsum(F.pad(a_cs[..., -1], (1, 0))))  # (b, h, c+1, c+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", dchunk, states)[:, :-1]
    # 4. states to outputs
    ch = cm.repeat_interleave(hg, dim=3)
    y = y + torch.einsum("bclhn,bchpn,bhcl->bclhp", ch, states,
                         torch.exp(a_cs))
    return y.reshape(b, c * chunk, h, p)[:, :s]


def block(spec, prec, P: Params, i: int, x):
    """Layer i: x += Mamba2(RMSNorm(x))."""
    p = f"layers.{i}.mamba."
    sz = spec.sizes
    h = rmsnorm(x, P[f"layers.{i}.ln.w"], spec.eps)
    b, s, _ = x.shape
    di, nh, g, n = sz.d_inner, sz.ssm_heads, sz.ngroups, sz.d_state
    zxbcdt = mm(prec, h, P[p + "in_proj"])
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * g * n]
    dt = zxbcdt[..., 2 * di + 2 * g * n:]
    w = P[p + "conv_w"]                                       # (conv_dim, K)
    k = w.shape[1]
    conv = F.conv1d(F.pad(xbc.transpose(1, 2), (k - 1, 0)), w[:, None, :],
                    P[p + "conv_b"], groups=w.shape[0])
    xbc = F.silu(conv).transpose(1, 2)
    xs = xbc[..., :di].reshape(b, s, nh, sz.headdim)
    bm = xbc[..., di:di + g * n].reshape(b, s, g, n)
    cm = xbc[..., di + g * n:].reshape(b, s, g, n)
    dt = F.softplus(dt + P[p + "dt_bias"])
    A = -torch.exp(P[p + "A_log"])
    y = ssd(xs * dt[..., None], dt * A, bm, cm, sz.chunk)
    y = y + xs * P[p + "D"][:, None]
    y = rmsnorm(y.reshape(b, s, di) * F.silu(z), P[p + "norm_w"], spec.eps)
    return x + mm(prec, y, P[p + "out_proj"])
