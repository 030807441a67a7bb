"""The port's cost count (`repro_torch/launch/cost.py`), the counterpart of
the reference's HLO walk (`repro/launch/hlo_cost.py`): the twins of
tests/test_hlo_cost.py's five tests on the port's own program, the kernel
formulas against the bounds in PERF.md's kernel table, and the two LM
kernels' wrappers counted as one operation each on the CPU and on the
meta device alike."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.launch.hlo_cost import analyze_hlo_program
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import ssd_scan as ks
from repro_torch.launch import cost
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import lm
from repro_torch.models import moe as moe_mod
from repro_torch.parallel import set_mesh

DEVICES = ("cpu", "meta")


def _count(fn, *args, device="cpu"):
    counter = cost.CostCounter(device)
    with counter:
        out = fn(*args)
    return counter, out


def _randn(*shape, device="cpu", dtype=torch.float32, seed=0):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)) \
        .to(dtype).to(device)


@pytest.mark.parametrize("device", DEVICES)
def test_loop_flops_match_unrolled(device):
    """Twin of test_scan_flops_match_unrolled: the port has no scan; a
    loop of 8 matmuls counts 8 x 2 x 256^3, as the reference's scan does
    once its trip count is applied."""
    x = _randn(256, 256, device=device)
    w = _randn(8, 256, 256, device=device, seed=1)

    def looped(x, w):
        for i in range(8):
            x = x @ w[i]
        return x

    c, _ = _count(looped, x, w, device=device)
    assert c.analyze()["program"]["dot_flops"] == 8 * 2 * 256 ** 3
    assert c.op_counts["mm"] == 8


@pytest.mark.parametrize("device", DEVICES)
def test_nested_loop_multiplicity(device):
    """Twin of test_nested_scan_multiplicity: 3 x 4 nested loops."""
    x = _randn(128, 128, device=device)
    w = _randn(3, 4, 128, 128, device=device, seed=1)

    def nested(x, w):
        for i in range(3):
            for j in range(4):
                x = x @ w[i, j]
        return x

    c, _ = _count(nested, x, w, device=device)
    assert c.analyze()["program"]["dot_flops"] == 12 * 2 * 128 ** 3


@pytest.mark.parametrize("device", DEVICES)
def test_dot_k_dimension(device):
    """Twin of test_dot_k_dimension_parsed: K is the contraction's."""
    a = _randn(64, 512, device=device)
    b = _randn(512, 32, device=device, seed=1)
    c, _ = _count(torch.matmul, a, b, device=device)
    prog = c.analyze()["program"]
    assert prog["dot_flops"] == 2 * 64 * 512 * 32
    assert prog["dot_flops_by_dtype"] == {"float32": 2 * 64 * 512 * 32}


def _ep_wire(cfg, x_shape, itemsize):
    """The ring model's all-to-all bytes of one EP layer call: two
    exchanges (there and back), each of ep slots' (ep, E_loc, cap, D)
    results, (ep - 1) / ep of each off its slot."""
    slots, bl, sl, cap = moe_mod.ep_layout(x_shape, cfg.moe)
    nb, ep = slots.shape
    e_loc = cfg.moe.num_experts // ep
    result = ep * e_loc * cap * x_shape[2] * itemsize
    return 2 * nb * ep * result * (ep - 1) / ep


@pytest.mark.parametrize("backward", [False, True])
def test_collective_wire_bytes_of_ep_exchange(backward):
    """Twin of test_collective_parse_synthetic: the reference reads an
    all-reduce's ring bytes from HLO text; the port's one collective is
    expert parallelism's exchange, counted by the same ring model
    (result_bytes (n - 1) / n, all-to-all) over 4 CPU slots; its
    backward exchanges again, as the transposed all-to-all does."""
    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b-smoke"),
                              moe_impl="ep_shardmap")
    layer = lm.build_model(cfg, device="cpu").layers[0].moe
    x = _randn(2, 8, cfg.d_model, dtype=torch.bfloat16)
    if backward:
        for p in layer.parameters():
            p.requires_grad_(True)
        x.requires_grad_(True)

    def run(layer, x):
        y = moe_mod.moe_apply_ep(layer, x, cfg.moe)
        if backward:
            y.float().sum().backward()
    with set_mesh(make_debug_mesh(1, 4, device="cpu")):
        c, _ = _count(run, layer, x)
        want = _ep_wire(cfg, x.shape, 2) * (2 if backward else 1)
    rl = c.analyze()["roofline"]
    assert want > 0
    assert rl["wire_bytes"] == pytest.approx(want, rel=1e-12)
    assert rl["by_op"] == {"all-to-all": pytest.approx(want, rel=1e-12)}
    assert rl["counts"] == {"all-to-all": 4 if backward else 2}
    assert c.analyze()["program"]["wire_by_scope"] == {
        "moe": pytest.approx(want / 2 if backward else want, rel=1e-12),
        **({"moe_bwd": pytest.approx(want / 2, rel=1e-12)}
           if backward else {})}


def test_collective_ring_model_matches_reference_formula():
    """The ring model of an all-to-all is the reference's: the bytes the
    port counts for n slots equal what the reference's HLO walk reads
    from an all-to-all of the same result over a group of n."""
    hlo = """HloModule test
ENTRY %main (p: f32[4,1024]) -> f32[4,1024] {
  %p = f32[4,1024]{1,0} parameter(0)
  ROOT %a2a = f32[4,1024]{1,0} all-to-all(%p), replica_groups=[1,4]<=[4], dimensions={0}
}
"""
    ref = analyze_hlo_program(hlo)
    c = cost.CostCounter("cpu")
    c.collective("all-to-all", [torch.zeros(4, 1024)], 4)
    assert c.wire_bytes == pytest.approx(ref.wire_bytes)
    assert c.collective_count["all-to-all"] \
        == ref.collective_count["all-to-all"] == 1


@pytest.mark.parametrize("device", DEVICES)
def test_traffic_counts_dot_operands(device):
    """Twin of test_traffic_counts_dot_operands: at least operands plus
    result; a view moves nothing."""
    a = _randn(256, 256, device=device)
    c, _ = _count(lambda a: a @ a, a, device=device)
    assert c.traffic_bytes >= 3 * 256 * 256 * 4
    c, _ = _count(lambda a: a.t().unsqueeze(0)[:, :10], a, device=device)
    assert c.traffic_bytes == 0 and c.ops == 3


def test_in_place_slice_write_counts_the_slice():
    """A write into a slice of a buffer counts the slice (read and
    written once each), not the buffer, as the reference counts a
    dynamic-update-slice."""
    buf = torch.zeros(1000, 64)
    row = torch.ones(2, 64)

    def write(buf, row):
        buf[10:12] = row
    c, _ = _count(write, buf, row)
    assert c.traffic_bytes == 2 * row.numel() * 4
    idx = torch.tensor([3, 7])

    def scatter(buf, idx, row):
        buf[idx] = row
    c, _ = _count(scatter, buf, idx, row)
    assert c.traffic_bytes == 2 * row.numel() * 4 + idx.numel() * 8


# --------------------------------------------------------------- kernels

# PERF.md's kernel table, rows 11, 11G, 11X and 12: the bound column
@pytest.mark.parametrize("row,args,want", [
    ("11", ("flash", 4, 32, 2048, 112, 2), 0.121656),
    ("11G", ("flash", 4, 32, 2048, 128, 2, 4), 0.139035),
    ("11X", ("flash", 4, 32, 2048, 128, 2, 8, 1601), 0.217273),
    ("12", ("ssd", 4, 2048, 64, 112, 64, 2), 0.073557),
])
def test_kernel_formulas_give_the_table_bounds(row, args, want):
    fn = cost.flash_cost if args[0] == "flash" else cost.ssd_cost
    ms, by = cost.H100.bound_ms(*fn(*args[1:]), "bfloat16")
    assert round(ms, 6) == want
    assert by == ("bytes" if row == "12" else "operations")


def test_flash_cost_causal_pairs():
    """Causal pairs are col <= row by absolute index: s (s + 1) / 2 at
    S == T, and every column for the rows past T."""
    _, f = cost.flash_cost(1, 1, 5, 1, 2, t=5, causal=True)
    assert f == 4 * 15
    _, f = cost.flash_cost(1, 1, 5, 1, 2, t=3, causal=True)
    assert f == 4 * (1 + 2 + 3 + 3 + 3)
    _, f = cost.flash_cost(1, 1, 5, 1, 2, t=3)
    assert f == 4 * 15


def _flash_inputs(device, dtype, hd, s=40, t=40):
    # the model's layout: (B, S, H, hd) seen as (B, H, S, hd)
    q = _randn(2, s, 4, hd, device=device, dtype=dtype).transpose(1, 2)
    k = _randn(2, t, 2, hd, device=device, dtype=dtype, seed=1) \
        .transpose(1, 2)
    v = _randn(2, t, 2, hd, device=device, dtype=dtype, seed=2) \
        .transpose(1, 2)
    return q, k, v


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 16, "tensor_core"), (torch.bfloat16, 12, "simt"),
    (torch.float32, 16, "simt")])
@pytest.mark.parametrize("return_lse", [False, True])
def test_flash_wrapper_counts_one_kernel_op(device, dtype, hd, route,
                                            return_lse):
    """One kernel operation on the card's route, by `flash_cost` (plus
    the log-sum-exp written when asked), and nothing that the operator
    runs inside: the plain version on the CPU, the fake implementation's
    empty outputs on meta."""
    q, k, v = _flash_inputs(device, dtype, hd)
    c, out = _count(kf.flash_attention_fwd, q, k, v, True, return_lse,
                    device=device)
    prog = c.analyze()["program"]
    assert c.ops == 1 and dict(c.op_counts) == {"flash_attention_fwd": 1}
    assert prog["kernel_calls"] == {"flash_attention_fwd": {route: 1}}
    nbytes, flops = cost.flash_cost(2, 4, 40, hd, q.element_size(), 2, 40,
                                    True)
    assert prog["traffic_bytes"] == nbytes + (4 * 2 * 4 * 40 if return_lse
                                              else 0)
    assert prog["dot_flops_by_dtype"] == {
        cost.ROUTE_DTYPES[route]: flops}
    o = out[0] if return_lse else out
    # in q's layout and dtype, as the kernel writes it
    assert o.shape == q.shape and o.dtype == q.dtype
    assert o.stride() == torch.empty_like(q).stride()
    if return_lse:
        assert out[1].shape == (2, 4, 40) and out[1].dtype == torch.float32
    # the operands and the live outputs are tracked, as any operator's;
    # the plain version's temporaries not
    assert c.live.peak == sum(cost.block_bytes(t.untyped_storage().nbytes())
                              for t in (q, k, v, *(out if return_lse
                                                   else (out,))))


def test_flash_cpu_route_values_unchanged():
    """The CPU route's output in q's layout holds the plain version's
    values."""
    q, k, v = _flash_inputs("cpu", torch.float32, 16, s=33, t=33)
    got = kf.flash_attention_fwd(q, k, v, True)
    want = kf.flash_attention_fwd_plain(q, k, v, True)
    assert torch.equal(got, want)


def _ssd_inputs(device, dtype, grouped=False):
    b, s, h, p, n = 2, 48, 4, 16, 16
    xbc = _randn(b, s, h * p + 2 * n, device=device, dtype=dtype)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    if grouped:
        bm, cm = bm[:, :, None], cm[:, :, None]
    dt = torch.nn.functional.softplus(_randn(b, s, h, device=device,
                                             seed=1))
    a = -torch.exp(_randn(h, device=device, seed=2))
    d = torch.ones(h, device=device)
    return x, dt, a, bm, cm, 16, d


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_core"),
                                         (torch.float32, "simt")])
@pytest.mark.parametrize("grouped", [False, True])
def test_ssd_wrapper_counts_one_kernel_op(device, dtype, route, grouped):
    args = _ssd_inputs(device, dtype, grouped)
    c, (y, state) = _count(ks.ssd_scan, *args, device=device)
    prog = c.analyze()["program"]
    assert c.ops == 1 and dict(c.op_counts) == {"ssd_scan": 1}
    assert prog["kernel_calls"] == {"ssd_scan": {route: 1}}
    nbytes, flops = cost.ssd_cost(2, 48, 4, 16, 16, args[0].element_size())
    assert prog["traffic_bytes"] == nbytes
    assert prog["dot_flops_by_dtype"] == {cost.ROUTE_DTYPES[route]: flops}
    assert y.shape == args[0].shape and y.dtype == dtype
    assert y.is_contiguous() and state.is_contiguous()
    assert state.shape == (2, 4, 16, 16) and state.dtype == torch.float32


def test_kernel_op_has_its_scope_and_backward():
    """Under autograd, kernel 11's forward counts in `attention`, and the
    plain backward's products in `attention_bwd`."""
    cfg = get_config("qwen2.5-3b-smoke")
    model = lm.build_model(cfg, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    tokens = torch.zeros(2, 16, dtype=torch.int32)
    c = cost.CostCounter("cpu")
    with c:
        lm.loss_fn(cfg, model, {"tokens": tokens, "labels": tokens}) \
            .backward()
    by_scope = c.analyze()["program"]["dot_flops_by_scope"]
    assert set(by_scope) == {"attention", "attention_bwd", "other",
                             "backward_other"}
    assert by_scope["attention_bwd"] > 0


def test_live_bytes_round_and_free():
    """Blocks of 512 bytes; a storage counts once however many views see
    it, and leaves when its last reference dies."""
    live = cost.LiveBytes()
    a = torch.zeros(10)                       # 40 bytes: one block
    b = torch.zeros(1000)                     # 4,000 bytes: 8 blocks
    live.track([a, a[2:], b.view(10, 100)])
    assert live.live == live.peak == 512 + 4096
    del b
    assert live.live == 512 and live.peak == 4608
    assert cost.block_bytes(0) == 0 and cost.block_bytes(513) == 1024


def test_roofline_terms_by_dtype():
    """The compute term takes each dtype's products at its own peak and
    the rest at the vector rate; the bound is the largest term."""
    c = cost.CostCounter("cpu")
    c.dot_flops.update({"bfloat16": 989e12, "float32": 67e12})
    c.elementwise_flops = 67e12
    c.traffic_bytes = 3.35e12 * 10
    rl = c.analyze()["roofline"]
    assert rl["compute_s"] == pytest.approx(3.0)
    assert rl["memory_s"] == pytest.approx(10.0)
    assert rl["dominant"] == "memory" and rl["collective_s"] == 0
