"""The frozen formulas against worked numbers, and the per-layer readers
against synthetic traces."""

from __future__ import annotations

import re

import pytest

from conftest import BENCH
from shark_bench import bench, trace, yardstick
from shark_bench.spec import load_spec, matmul_params, n_params


def qwen():
    return load_spec(BENCH / "configs/qwen2.5-3b.json")


def mamba():
    return load_spec(BENCH / "configs/mamba2-370m.json")


def test_parameter_counts():
    # Qwen2.5-3B: 3,085,938,688 parameters, as the program's model counts
    # them (PERF.md, phase 12b); Mamba2-370m tied, 50,288 rows: 368,346,624
    assert n_params(qwen()) == 3_085_938_688
    assert n_params(mamba()) == 368_346_624
    # every matrix and the tied head: all but the norms and biases
    q = qwen()
    assert matmul_params(q) == n_params(q) - (2 * 36 + 1) * 2048 \
        - 36 * (2048 + 2 * 256)


def test_flash_cost_worked():
    # 1 x 1 head of 2 rows, hd 4, bf16: 3 causal pairs, 4 FLOPs a pair and
    # dimension; q, k, v read and o written once
    nbytes, flops = yardstick.flash_cost(1, 1, 2, 4, 2)
    assert flops == 4 * 4 * 3
    assert nbytes == (2 * 1 * 2 + 2 * 1 * 2) * 4 * 2
    # grouped query heads read k and v with their own head count
    nbytes, flops = yardstick.flash_cost(4, 16, 2048, 128, 2, kv=2)
    assert nbytes == (2 * 16 * 2048 + 2 * 2 * 2048) * 4 * 128 * 2
    assert flops == 4.0 * 4 * 16 * 128 * 2048 * 2049 / 2


def test_ssd_cost_worked():
    nbytes, flops = yardstick.ssd_cost(1, 64, 1, 2, 3, 2)
    assert flops == 2.0 * 64 * (32 * 5 + 2 * 6)
    assert nbytes == (2 * 64 * 2 + 2 * 64 * 3) * 2 + 4 * 64 + 4 * 6 + 8


def test_model_flops_worked():
    q = qwen()
    # a training step of 4 x 2,048 tokens: 1.591e14 (PERF.md's prediction)
    assert yardstick.train_flops(q, 4, 2048) == pytest.approx(1.5909e14,
                                                              rel=1e-4)
    # prefill counts the head at the last position only
    full = yardstick.forward_flops(q, 2, 8192, head_rows=2 * 8192)
    assert full - yardstick.prefill_flops(q, 2, 8192) == pytest.approx(
        2.0 * 2048 * 151936 * (2 * 8192 - 2))
    assert yardstick.train_flops(mamba(), 16, 2048) == pytest.approx(
        7.917e13, rel=1e-3)


def test_trace_arithmetic():
    spans = [(0, 10), (5, 12), (20, 30), (30, 31), (40, 41)]
    assert yardstick.union(spans) == 12 + 11 + 1
    assert yardstick.gaps(spans) == [(12, 20), (31, 40)]
    ops = [("a", 0, 10), ("b", 0, 3), ("a", 20, 25)]
    assert yardstick.top_ops(ops, 1) == [["a", 15e-6]]


def _record(kind, spec, device_ops, host_ops=(), work=((4, 2048),)):
    rec = bench.Record(spec, kind, 2.0, list(work) * 3,
                       extra={"batch_ms": [0.5, 1.5]})
    rec.trace = trace.Trace(list(device_ops), list(host_ops))
    rec.traced_work = list(work)
    return rec


def test_readers_on_a_synthetic_trace():
    q = qwen()
    least_us = q.n_layers * yardstick.bound_s(
        yardstick.mixer_cost(q, 4, 2048)) * 1e6
    ops = [("void flash_fwd_tc<128>(...)", 0.0, least_us),
           ("void flash_fwd_tc<128>(...)", least_us, 3 * least_us),
           ("gemm", 3 * least_us, 4 * least_us),
           ("gemm", 6 * least_us, 8 * least_us)]
    rec = _record("train", q, ops, [("shark_bench.step", 0, 10 * least_us),
                                    ("aten::item", 4 * least_us,
                                     5.5 * least_us)])
    read = lambda name: bench.read_metric(name, rec)  # noqa: E731
    assert read("attention_roofline.prefill") is None
    assert read("ssd_roofline.train") is None
    assert read("device_idle_share.train") == pytest.approx(100 * 2 / 8)
    assert read("device_idle_share.prefill") is None
    assert read("batch_ms.train") == 1.0
    assert read("mfu.train") == pytest.approx(
        100 * 3 * yardstick.train_flops(q, 4, 2048) / (2.0 * 989e12))
    served = _record("prefill", q, ops)
    assert bench.read_metric("attention_roofline.prefill",
                             served) == pytest.approx(100 / 3)
    gap = rec.trace.breakdown()["idle_gaps"][0]
    assert gap[0] == "shark_bench.step: aten::item"
    assert gap[1] == pytest.approx(2 * least_us / 1e6)


def test_readers_find_nothing_without_a_trace():
    rec = bench.Record(mamba(), "prefill", 1.0, [(16, 2048)])
    for name in ("ssd_roofline.prefill", "device_idle_share.prefill",
                 "batch_ms.train"):
        assert bench.read_metric(name, rec) is None
    rec.trace = trace.Trace([("elementwise", 0.0, 5.0)], [])
    rec.traced_work = [(16, 2048)]
    # no kernel of the pattern ran: no share of a roofline, never 0
    assert bench.read_metric("ssd_roofline.prefill", rec) is None
    assert bench.read_metric("device_idle_share.prefill", rec) == 0.0


def test_kernel_patterns_match_the_kernels():
    # the kernels' names as the profiler reports them on an H100 (this
    # benchmark's traced runs, PERF.md section 5)
    names = {"attention": "void (anonymous namespace)::flash_fwd_tc<128>("
             "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, ...)",
             "ssd": "void (anonymous namespace)::ssd_fwd_tc<64, 128>(...)"}
    for metric, kernel in (("attention_roofline.prefill", "attention"),
                           ("ssd_roofline.train", "ssd")):
        src = (BENCH / "metrics" / f"{metric}.py").read_text()
        pattern = re.search(r're\.compile\(r"([^"]+)"\)', src).group(1)
        assert re.search(pattern, names[kernel])
        assert not re.search(pattern, "ampere_bf16_s16816gemm")


def test_ssd_bwd_cost_is_the_programs_at_the_cell_shape():
    """The frozen copy reads as `launch/cost.ssd_bwd_cost` at the training
    cell's shape (16 x 2,048 tokens, 32 heads of 64, state 128): 0.461 GB
    and 120.3 GFLOP, bound by the bytes at 0.1377 ms."""
    from repro_torch.launch import cost
    m = mamba()
    z = m.sizes
    shape = (16, 2048, z.ssm_heads, z.headdim, z.d_state, 2, z.ngroups)
    assert shape == (16, 2048, 32, 64, 128, 2, 1)
    nbytes, flops = yardstick.ssd_bwd_cost(*shape)
    assert (nbytes, flops) == cost.ssd_bwd_cost(*shape)
    assert nbytes == pytest.approx(0.4614e9, rel=1e-3)
    assert flops == pytest.approx(120.26e9, rel=1e-3)
    assert yardstick.bound_s((nbytes, flops)) == pytest.approx(
        0.1377e-3, rel=1e-3)


def test_ssd_bwd_roofline_reads_the_backward_kernel():
    """One backward a layer a traced step, over the time of the kernels
    named ssd_bwd; nothing where the family has no SSD scan, or where the
    backward ran no such kernel."""
    m = mamba()
    least_us = m.n_layers * yardstick.bound_s(yardstick.ssd_bwd_cost(
        16, 2048, 32, 64, 128, 2)) * 1e6
    ops = [("void (anonymous namespace)::ssd_bwd_tc<64, 128>(Args)", 0.0,
            10 * least_us),
           ("void (anonymous namespace)::ssd_fwd_tc<64, 128>(...)",
            10 * least_us, 11 * least_us)]
    rec = _record("train", m, ops, work=((16, 2048),))
    assert bench.read_metric("ssd_bwd_roofline.train", rec) == \
        pytest.approx(10.0)
    assert bench.read_metric("ssd_bwd_roofline.train",
                             _record("prefill", m, ops)) is None
    assert bench.read_metric("ssd_bwd_roofline.train",
                             _record("train", qwen(), ops)) is None
    assert bench.read_metric("ssd_bwd_roofline.train",
                             _record("train", m, ops[1:])) is None
