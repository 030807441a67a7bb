"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) in PyTorch.

Prefill and training run the SSD scan through `kernels.ops.ssd_scan`: the
hand-written kernel (`kernels/csrc/ssd.cu`, one launch per B/C group) on
the card, `ssd_chunked` on the CPU; when autograd records, through
`SSDScan`, whose backward differentiates `ssd_chunked` (plain torch).
`ssd_chunked` is the chunked algorithm of the reference: within a chunk a
masked (attention-like) matmul, across chunks a recurrence on the
(H, P, N) state.  Decode is the linear recurrence
state' = da * state + dt * (B outer x); y = C . state', in plain torch
(the reference has no kernel for it).

Layer = [in_proj -> short causal conv (cached at decode) -> SSD -> gated
RMSNorm -> out_proj], matching the Mamba2 block.  Compute points follow
the reference: the conv, dt, the SSD and the gate in float32, each cast
back to the activation dtype where the reference casts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .common import _param, dense_init, named_scope, normal, rmsnorm


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    headdim: int = 64
    ngroups: int = 1
    d_conv: int = 4
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


class Mamba2(nn.Module):
    """One Mamba2 block's parameters (the reference's `mamba2_init`, one
    layer):
    in_proj (d, 2*di + 2*g*n + nh) emits [z, x, B, C, dt]; conv_w
    (conv_dim, d_conv) N(0, 0.1^2); conv_b, dt_bias, A_log zeros (A = -1);
    D and norm_w ones; out_proj (di, d)."""

    def __init__(self, d_model: int, cfg: SSMConfig, dtype=torch.bfloat16,
                 device=None, generator=None):
        super().__init__()
        di = cfg.d_inner(d_model)
        nh = cfg.n_heads(d_model)
        g, n = cfg.ngroups, cfg.d_state
        proj_out = 2 * di + 2 * g * n + nh
        conv_dim = di + 2 * g * n

        def vec(size, val):
            return _param(torch.full((size,), val, dtype=torch.float32,
                                     device=device))

        self.in_proj = _param(dense_init(d_model, proj_out, dtype, device,
                                         generator))
        self.conv_w = _param(normal((conv_dim, cfg.d_conv), 0.1, dtype,
                                    device, generator))
        self.conv_b = vec(conv_dim, 0.0)
        self.A_log = vec(nh, 0.0)        # A = -exp(A_log)
        self.D = vec(nh, 1.0)
        self.dt_bias = vec(nh, 0.0)
        self.norm_w = vec(di, 1.0)
        self.out_proj = _param(dense_init(di, d_model, dtype, device,
                                          generator))


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, g: int, n: int, nh: int):
    z = zxbcdt[..., :d_inner]
    x = zxbcdt[..., d_inner:2 * d_inner]
    B = zxbcdt[..., 2 * d_inner:2 * d_inner + g * n]
    C = zxbcdt[..., 2 * d_inner + g * n:2 * d_inner + 2 * g * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * g * n:]
    return z, x, B, C, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over sequence.  xbc: (B,S,C); w: (C,K)."""
    k = w.shape[-1]
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(k):  # K=4 taps, summed in the reference's order
        out = out + pad[:, i:i + s, :].float() * w[:, i].float()
    out = out + b.float()
    return F.silu(out).to(xbc.dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                chunk: int, init_state: Optional[torch.Tensor] = None):
    """SSD scan.  x: (b,s,h,p); dt: (b,s,h) (post-softplus); A: (h) (<0);
    B, C: (b,s,g,n).  Returns (y (b,s,h,p) incl. the D skip, in x's dtype;
    final_state (b,h,p,n) float32).  A ragged s is padded with dt = 0 rows:
    the state passes through them unchanged and their outputs are
    dropped."""
    b, s, h, p_ = x.shape
    g, n = B.shape[2], B.shape[3]
    s_orig = s
    if s % chunk != 0:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    hg = h // g  # heads per B/C group
    f32 = torch.float32

    xc = x.reshape(b, nc, chunk, h, p_).to(f32)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, g, n).to(f32)
    Cc = C.reshape(b, nc, chunk, g, n).to(f32)

    dA = dtc * A[None, None, None, :]                   # (b,nc,c,h) negative
    dA_cum = torch.cumsum(dA, dim=2)                    # within-chunk cumsum

    # intra-chunk: L[i,j] = exp(dA_cum[i] - dA_cum[j]) for i >= j; the
    # masked half is set to -inf before the exp (its exp may overflow, and
    # an inf there would make the gradient 0 * inf)
    seg = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]  # (b,nc,c,c,h)
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    L = torch.exp(torch.where(causal, seg, float("-inf")))
    CB = torch.einsum("bzcgn,bzdgn->bzcdg", Cc, Bc)     # (b,nc,c,c,g)
    CB = CB.repeat_interleave(hg, dim=-1)               # (b,nc,c,c,h)
    M = CB * L * dtc[:, :, None, :, :]                  # weight by dt_j
    y_intra = torch.einsum("bzcdh,bzdhp->bzchp", M, xc)

    # chunk summary states: S_z = sum_j exp(dA_cum[last]-dA_cum[j]) dt_j B_j x_j
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)    # (b,nc,c,h)
    B_h = Bc.repeat_interleave(hg, dim=3).reshape(b, nc, chunk, h, n)
    contrib = torch.einsum("bzch,bzchn,bzchp->bzhpn", decay_to_end * dtc,
                           B_h, xc)                     # (b,nc,h,p,n)
    chunk_decay = torch.exp(torch.sum(dA, dim=2))       # (b,nc,h)

    state = (init_state if init_state is not None
             else torch.zeros((b, h, p_, n), dtype=f32, device=x.device))
    y_inter = []
    for z in range(nc):
        # inter-chunk contribution: y_j += C_j . (decay_into_chunk * state)
        decay_from_start = torch.exp(dA_cum[:, z])      # (b,c,h)
        Cz_h = Cc[:, z].repeat_interleave(hg, dim=2).reshape(b, chunk, h, n)
        y_inter.append(torch.einsum("bchn,bhpn,bch->bchp", Cz_h, state,
                                    decay_from_start))
        state = state * chunk_decay[:, z, :, None, None] + contrib[:, z]
    y_inter = torch.stack(y_inter, dim=1)               # (b,nc,c,h,p)

    y = (y_intra + y_inter).reshape(b, s, h, p_)
    y = y + x.to(f32) * D[None, None, :, None]
    return y[:, :s_orig].to(x.dtype), state


def ssd_scan_vjp(x, dt, a, b, c, d, chunk: int, dy, dstate):
    """The gradients (x, dt, a, b, c, d) of the SSD scan, given those of
    its outputs y and final state: `ssd_scan_plain` recomputed under
    autograd at the same inputs, and its vector-Jacobian product."""
    from ..kernels.ssd_scan import ssd_scan_plain
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, dt, a, b, c, d)]
        y, state = ssd_scan_plain(*ins[:5], chunk, ins[5])
        grads = torch.autograd.grad((y, state), ins, (dy, dstate),
                                    allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for t, g in zip(ins, grads))


class SSDScan(torch.autograd.Function):
    """Kernel 12 (`kernels.ops.ssd_scan`) forward; the backward is
    `ssd_scan_vjp`: the reference trains Mamba2 through autodiff of its
    `ssd_chunked` and has no Pallas backward, so the port's backward is
    plain PyTorch by design."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk: int, d):
        y, state = ops.ssd_scan(x, dt, a, b, c, chunk, d=d)
        ctx.save_for_backward(x, dt, a, b, c, d)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, b, c, d = ctx.saved_tensors
        gx, gdt, ga, gb, gc, gd = ssd_scan_vjp(x, dt, a, b, c, d, ctx.chunk,
                                               dy, dstate)
        out = (gx, gdt, ga, gb, gc, None, gd)
        return tuple(g if need else None
                     for g, need in zip(out, ctx.needs_input_grad))


def ssd_scan(x, dt, a, b, c, chunk: int, d):
    """The SSD scan of a Mamba2 block: `SSDScan` where autograd records
    (grad mode on and an input that requires grad), else the kernel's
    call alone."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, b, c, d)):
        return SSDScan.apply(x, dt, a, b, c, chunk, d)
    return ops.ssd_scan(x, dt, a, b, c, chunk, d=d)


@named_scope("mamba")
def mamba2_forward(p: Mamba2, x: torch.Tensor, d_model: int, cfg: SSMConfig,
                   return_state: bool = False):
    """Full-sequence Mamba2 block (prefill).  x: (B,S,D).  With
    `return_state`, also the SSD's final state (B,H,P,N) float32 and the
    conv state: the last d_conv - 1 raw conv inputs (B, d_conv-1,
    conv_dim)."""
    b, s, _ = x.shape
    di = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    g, n = cfg.ngroups, cfg.d_state
    zxbcdt = x @ p.in_proj
    z, _, _, _, dt = _split_proj(zxbcdt, di, g, n, nh)
    xbc_raw = zxbcdt[..., di:2 * di + 2 * g * n]        # [x, B, C]
    xbc = _causal_conv(xbc_raw, p.conv_w, p.conv_b)
    xs, B, C = (xbc[..., :di], xbc[..., di:di + g * n],
                xbc[..., di + g * n:])
    dt = F.softplus(dt.float() + p.dt_bias[None, None, :])
    A = -torch.exp(p.A_log)
    y, state = ssd_scan(xs.reshape(b, s, nh, cfg.headdim), dt, A,
                        B.unflatten(-1, (g, n)), C.unflatten(-1, (g, n)),
                        min(cfg.chunk, s), p.D)
    y = y.reshape(b, s, di)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p.norm_w)
    out = y @ p.out_proj
    if return_state:
        conv_state = xbc_raw[:, -(cfg.d_conv - 1):, :]  # last K-1 raw inputs
        return out, state, conv_state
    return out


@named_scope("mamba")
def mamba2_decode(p: Mamba2, x: torch.Tensor, ssm_state: torch.Tensor,
                  conv_state: torch.Tensor, d_model: int, cfg: SSMConfig):
    """Single-token step.  x: (B,1,D); ssm_state: (B,H,P,N) fp32;
    conv_state: (B, d_conv-1, conv_dim).  Returns (y, new ssm_state, new
    conv_state); the inputs are not modified."""
    b = x.shape[0]
    di = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    g, n = cfg.ngroups, cfg.d_state
    zxbcdt = x @ p.in_proj
    z, _, _, _, dt = _split_proj(zxbcdt, di, g, n, nh)
    xbc_new = zxbcdt[..., di:2 * di + 2 * g * n]        # (B,1,conv_dim)
    window = torch.cat([conv_state, xbc_new], dim=1)    # (B,K,conv)
    conv_out = torch.einsum("bkc,ck->bc", window.float(),
                            p.conv_w.float()) + p.conv_b
    xbc = F.silu(conv_out)[:, None, :].to(x.dtype)
    new_conv_state = window[:, 1:, :]
    xs, B, C = (xbc[..., :di], xbc[..., di:di + g * n],
                xbc[..., di + g * n:])
    dt = F.softplus(dt.float() + p.dt_bias)[:, 0]      # (B,H)
    A = -torch.exp(p.A_log)
    da = torch.exp(dt * A[None, :])                     # (B,H)
    xh = xs.reshape(b, nh, cfg.headdim).float()
    Bh = B.reshape(b, g, n).repeat_interleave(nh // g, dim=1)  # (B,H,N)
    Ch = C.reshape(b, g, n).repeat_interleave(nh // g, dim=1)
    state = ssm_state * da[:, :, None, None] \
        + dt[:, :, None, None] * xh[..., :, None] * Bh.float()[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, Ch.float())
    y = y + xh * p.D[None, :, None]
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p.norm_w)
    return y @ p.out_proj, state, new_conv_state
