"""The Python logic that decides the port's kernel launches, on the CPU.

The flash wrapper picks one of two CUDA kernels by dtype and head dim
(`flash_route`) and checks TMA's alignment rules before the tensor-core
route (`_check_tma`); the group wrapper sizes its one launch of
csrc/group.cu with `group_plan`.  The kernels themselves run only on the
card (tests/test_torch_kernels.py, `cuda` marker); what is tested here is
pure Python that the CPU reaches.
"""

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import groupby_mxu as tgb

BLOCK_SMEM_LIMIT = 232448      # 227 KB, the most an H100 block may have


@pytest.mark.parametrize("hd", [8, 16, 32, 64, 96, 112, 120, 128])
def test_flash_route_bf16_legal_head_dim_takes_tensor_cores(hd):
    assert tfa.flash_route(torch.bfloat16, hd) == "tensor_core"


@pytest.mark.parametrize("hd", [1, 36 + 2, 63, 100 + 1, 127])
def test_flash_route_bf16_odd_head_dim_takes_simt(hd):
    assert tfa.flash_route(torch.bfloat16, hd) == "simt"


@pytest.mark.parametrize("hd", [8, 64, 112, 128, 63])
def test_flash_route_float32_takes_simt(hd):
    assert tfa.flash_route(torch.float32, hd) == "simt"


def test_flash_routes_are_counted_only_on_the_card():
    """CPU tensors run the plain version: no route is counted."""
    before = dict(tfa.ROUTES)
    q = torch.zeros(1, 2, 5, 64, dtype=torch.bfloat16)
    tfa.flash_attention_fwd(q, q, q)
    assert tfa.ROUTES == before
    assert set(tfa.ROUTES) == {"tensor_core", "simt"}


def test_check_tma_takes_the_models_strided_view():
    """(B, S, H, hd) seen as (B, H, S, hd): strides H * hd, hd, S * H * hd,
    all multiples of 8 at hd = 112."""
    x = torch.zeros(2, 100, 4, 112, dtype=torch.bfloat16).transpose(1, 2)
    tfa._check_tma(x, x, x)


def test_check_tma_raises_on_a_stride_off_eight():
    wide = torch.zeros(1, 64, 132, dtype=torch.bfloat16)
    odd = wide.as_strided((1, 2, 64, 64), (64 * 132, 64, 132, 1))
    with pytest.raises(ValueError, match="stride"):
        tfa._check_tma(odd, odd, odd)


def test_check_tma_raises_on_an_unaligned_base():
    size = 2 * 64 * 64
    flat = torch.zeros(size + 8, dtype=torch.bfloat16)
    at = (-flat.data_ptr() % 16) // 2          # first 16-byte aligned index
    aligned = flat[at:at + size].view(1, 2, 64, 64)
    tfa._check_tma(aligned, aligned, aligned)
    shifted = flat[at + 1:at + 1 + size].view(1, 2, 64, 64)
    with pytest.raises(ValueError, match="aligned"):
        tfa._check_tma(shifted, aligned, aligned)


def test_check_tma_ignores_strides_of_length_one_dims():
    x = torch.zeros(1, 3, 64, 64, dtype=torch.bfloat16)
    odd_batch = x.as_strided(x.shape, (5, 64 * 64, 64, 1))
    tfa._check_tma(odd_batch, x, x)


def test_check_raises_past_the_largest_head_dim():
    x = torch.zeros(1, 2, 8, tfa.MAX_HEAD_DIM + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tfa._check(x, x, x)


@pytest.mark.parametrize("with_minmax", [False, True])
@pytest.mark.parametrize("g", [1, 7, 50, 384, 512, 768, 1000, 1024])
def test_group_plan_fits_a_block(g, with_minmax):
    """Every variant's accumulators fit the shared-memory budget that lets
    two blocks share an SM (so a 16-block cluster fits), hence the 227 KB
    block limit; copies are a power of two up to one a warp."""
    for n in (0, 1, 93_750, 10 ** 6, 10 ** 8):
        plan = tgb.group_plan(n, g, with_minmax)
        assert plan.copies in (1, 2, 4, 8)
        lanes = tgb.lane_sum_bytes(g) if plan.lane_sums else 0
        assert plan.smem_bytes == (plan.copies * tgb.copy_bytes(g, with_minmax)
                                   + lanes)
        assert plan.smem_bytes <= tgb.SMEM_BUDGET < BLOCK_SMEM_LIMIT
        if plan.copies < 8:          # the most copies that fit
            assert 2 * plan.smem_bytes > tgb.SMEM_BUDGET


@pytest.mark.parametrize("g", [1, 7, 50, 53, 54, 100, 1024])
def test_group_plan_lane_sums_for_small_groups(g):
    """Sums go to lane-private columns (no float64 atomics) exactly when
    the columns fit beside 8 count copies; the merge never takes them."""
    plan = tgb.group_plan(93_750, g, False)
    fits = 8 * tgb.copy_bytes(g, False) + tgb.lane_sum_bytes(g) \
        <= tgb.SMEM_BUDGET
    assert plan.lane_sums == fits
    assert plan.lane_sums == (g <= 53)
    assert not tgb.group_plan(93_750, g, True).lane_sums


def test_group_plan_copy_bytes():
    """12 bytes a group for [sum, count] (float64, uint32), 32 with min,
    max and the NaN flag, rounded up to 8 bytes (group.cu's copy_bytes);
    lane-private sums take 8 bytes a group and thread."""
    assert tgb.copy_bytes(50, False) == 600
    assert tgb.copy_bytes(1, False) == 16
    assert tgb.copy_bytes(50, True) == 1600
    assert tgb.copy_bytes(1024, True) == 32 * 1024
    assert tgb.lane_sum_bytes(50) == 8 * 50 * 256


@pytest.mark.parametrize("n", [0, 1, 1023, 6144, 6145, 93_750, 98_304,
                               98_305, 10 ** 6, 10 ** 7, 10 ** 9])
def test_group_plan_grid_is_a_function_of_n_only(n):
    """Cluster and block counts depend on n alone (not on G or the
    variant), so the kernel's fold order is fixed for a given n."""
    plans = {(p.cluster, p.blocks)
             for p in (tgb.group_plan(n, g, mm) for g in (1, 50, 1024)
                       for mm in (False, True))}
    assert len(plans) == 1
    cluster, blocks = plans.pop()
    assert cluster in (1, 2, 4, 8, 16)
    assert blocks % cluster == 0
    assert blocks // cluster <= tgb.MAX_CLUSTERS
    rows = tgb.THREADS * tgb.ROWS_PER_THREAD
    if blocks > cluster:
        assert cluster == tgb.MAX_CLUSTER
    else:                             # one cluster covers n at the rate
        assert blocks * rows >= n or blocks == tgb.MAX_CLUSTER


def test_group_plan_main_path_partition_is_one_cluster_of_16():
    """A 93,750-row SQL partition: one 16-block cluster, no scratch;
    10**6 rows cross into several clusters (the ticket fold)."""
    plan = tgb.group_plan(93_750, 50, False)
    assert (plan.cluster, plan.blocks, plan.copies) == (16, 16, 8)
    assert plan.lane_sums
    big = tgb.group_plan(10 ** 6, 50, False)
    assert big.cluster == 16 and big.blocks // big.cluster > 1


def test_dtype_codes_keyed_by_torch_dtype():
    for dt, code in ((torch.int32, 0), (torch.int64, 1), (torch.float32, 2),
                     (torch.float64, 3), (torch.bfloat16, 4)):
        assert _build.dtype_code(torch.zeros(1, dtype=dt)) == code
    with pytest.raises(TypeError):
        _build.dtype_code(torch.zeros(1, dtype=torch.int16))


def test_build_signatures_match_the_wrappers():
    """The bound argument counts of the two redesigned entry points: flash
    takes a route code; group takes codes, values, n, G, its plan word,
    the output (scratch follows it) and the stream."""
    assert len(_build.SIGNATURES["flash"][1]) == 25
    assert len(_build.SIGNATURES["group"][1]) == 7


@pytest.mark.parametrize("n,g,mm", [(1, 1, False), (93_750, 50, False),
                                    (3_200, 50, True), (10 ** 6, 1024, True),
                                    (10 ** 9, 7, False)])
def test_group_plan_word_round_trips(n, g, mm):
    """group.cu decodes the plan word bit by bit (copies bits 8-11,
    cluster 12-16, blocks 20-31, with_minmax bit 4, lane sums bit 5); the
    dtype bits 0-3 stay free for the call."""
    plan = tgb.group_plan(n, g, mm)
    w = plan.word(mm)
    assert w & 15 == 0
    assert (w >> 4) & 1 == int(mm) and (w >> 5) & 1 == int(plan.lane_sums)
    assert (w >> 8) & 15 == plan.copies
    assert (w >> 12) & 31 == plan.cluster
    assert (w >> 20) & 4095 == plan.blocks


def test_group_launch_allocates_partials_only_past_one_cluster():
    word, extra = tgb._launch(93_750, 50, False)
    assert extra == 0
    word, extra = tgb._launch(10 ** 6, 50, True)
    clusters = tgb.group_plan(10 ** 6, 50, True).blocks // 16
    assert extra == clusters * 5 * 50 + 1


def test_groupby_sum_mixed_devices_raise():
    """The wrapper's fast device test leaves a CPU / other-device mix to
    on_cpu, which raises."""
    c = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tgb.groupby_sum(c, torch.zeros(4, dtype=torch.float64,
                                       device="meta"), 2)
