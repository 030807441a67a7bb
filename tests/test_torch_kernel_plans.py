"""The Python logic that decides the port's kernel launches, on the CPU.

The flash wrapper picks one of two CUDA kernels by dtype and head dim
(`flash_route`) and checks TMA's alignment rules before the tensor-core
route (`_check_tma`); the SSD wrapper picks one of two by dtype and (P, N)
(`ssd_route`) and checks cp.async's alignment rules before its tensor-core
route (`_check_tc`); the group wrapper sizes its one launch of
csrc/group.cu with `group_plan`, the decode wrappers theirs with
`decode_plan`, `bitpack_plan` and `rle_plan` / `rle_word` (and the
batched bit-pack decode packs its block descriptors), the gradient its
with `train_plan`, the top-k its with `topk_plan` (and its lanes entry
packs the lanes' addresses and weights).  The kernels
themselves run only on the card (tests/test_torch_kernels.py, `cuda`
marker); what is tested here is pure Python that the CPU reaches.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import REGISTRY
from repro_torch.kernels import _build
from repro_torch.kernels import colscan as tcs
from repro_torch.kernels import dictdecode as tdd
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import groupby_mxu as tgb
from repro_torch.kernels import ssd_scan as tss
from repro_torch.kernels import topk_similarity as ttk
from repro_torch.kernels import train_grad as ttg

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


ATTENTION_CONFIGS = sorted(
    n for n, c in REGISTRY.items() if c.family in ("dense", "hybrid"))


def test_attention_configs_cover_the_dense_and_hybrid_families():
    assert ATTENTION_CONFIGS == ["phi3-medium-14b", "qwen2.5-3b",
                                 "starcoder2-15b", "yi-9b", "zamba2-7b"]


@pytest.mark.parametrize("name", ATTENTION_CONFIGS)
def test_attention_configs_group_and_take_the_tensor_cores(name):
    """Every registered dense and hybrid configuration hands kernel 11
    whole groups of query heads (n_heads % n_kv_heads == 0) and a head dim
    that takes the tensor-core route in bfloat16 (the dense four: 128)."""
    cfg = REGISTRY[name]
    assert cfg.n_heads % cfg.n_kv_heads == 0
    assert cfg.hd <= tfa.MAX_HEAD_DIM
    assert tfa.flash_route(torch.bfloat16, cfg.hd) == "tensor_core"
    if cfg.family == "dense":
        assert cfg.hd == 128 and cfg.n_kv_heads < cfg.n_heads


def test_check_tma_checks_k_and_v_on_their_own_shapes():
    """GQA: q (B, H, S, hd) and k, v (B, KV, T, hd) in the model's strided
    layout pass; a k whose own row stride is off eight raises even though
    q's is legal."""
    q = torch.zeros(2, 100, 32, 128, dtype=torch.bfloat16).transpose(1, 2)
    kv = torch.zeros(2, 100, 4, 128, dtype=torch.bfloat16).transpose(1, 2)
    tfa._check(q, kv, kv)
    tfa._check_tma(q, kv, kv)
    wide = torch.zeros(2, 100, 4 * 128 + 4, dtype=torch.bfloat16)
    odd = wide[..., :4 * 128].view(2, 100, 4, 128).transpose(1, 2)
    with pytest.raises(ValueError, match="k's stride"):
        tfa._check_tma(q, odd, kv)


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
    """The bound argument counts of the redesigned entry points: flash
    takes a nullable LSE output, a route code and the kv head count; group takes codes, values, n, G, its plan word,
    the output (scratch follows it) and the stream; ssd takes a route code
    and a nullable D; decode takes input, table, output, n, table length,
    its plan word and the stream."""
    assert len(_build.SIGNATURES["flash"][1]) == 27
    assert len(_build.SIGNATURES["group"][1]) == 7
    assert len(_build.SIGNATURES["ssd"][1]) == 22
    assert len(_build.SIGNATURES["decode"][1]) == 7


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


def test_decode_signature_takes_the_word_as_an_unsigned_64_bit_value():
    """decode.cu's shark_decode(idx, table, out, n, table_len, word,
    stream) and shark_bitpack(descs, count, n, word, stream): pointers as
    c_void_p, sizes as c_longlong, and the plan word as c_ulonglong."""
    ct = _build.ctypes
    assert _build.SIGNATURES["decode"][1] == [
        ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_longlong, ct.c_longlong,
        ct.c_ulonglong, ct.c_void_p]
    assert _build.SIGNATURES["bitpack"][1] == [
        ct.c_void_p, ct.c_int, ct.c_longlong, ct.c_ulonglong, ct.c_void_p]
    assert _build.LIBRARY["bitpack"] == "decode"
    word = tdd.decode_plan(10 ** 9, 0, 8).word(2, 3)
    assert word >= 2 ** 11
    assert ct.c_ulonglong(word).value == word


def test_build_signatures_pass_every_pointer_as_a_pointer():
    """The ssd entry point's pointers (x, dt, a, d, b, c, y, state, stream)
    are c_void_p, its strides c_longlong: ctypes would cut either to 32
    bits as an int."""
    args = _build.SIGNATURES["ssd"][1]
    vp, ll = _build.ctypes.c_void_p, _build.ctypes.c_longlong
    assert [i for i, t in enumerate(args) if t is vp] == [0, 5, 6, 7, 8, 11,
                                                          19, 20, 21]
    assert [i for i, t in enumerate(args) if t is ll] == [3, 4, 9, 10, 12,
                                                          13]


# -- the SSD scan's routes and checks -------------------------------------


@pytest.mark.parametrize("p,n", [(112, 64), (64, 128), (16, 16)])
def test_ssd_route_bf16_config_shapes_take_tensor_cores(p, n):
    """Zamba2-7B (112 x 64), Mamba2-370m (64 x 128) and their smoke
    variants (16 x 16): every (P, N) the repo's configurations use."""
    assert tss.ssd_route(torch.bfloat16, p, n) == "tensor_core"


@pytest.mark.parametrize("p,n", [(112, 64), (64, 128), (16, 16), (1, 1),
                                 (128, 128), (48, 40)])
def test_ssd_route_float32_takes_simt(p, n):
    assert tss.ssd_route(torch.float32, p, n) == "simt"


@pytest.mark.parametrize("p,n", [(1, 1), (128, 128), (64, 64), (112, 128),
                                 (48, 40), (100, 64)])
def test_ssd_route_bf16_other_shapes_take_simt(p, n):
    assert tss.ssd_route(torch.bfloat16, p, n) == "simt"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("p,n", [(129, 64), (64, 129), (256, 256), (0, 64),
                                 (64, 0)])
def test_ssd_route_raises_past_the_tiles(dtype, p, n):
    with pytest.raises(ValueError, match="P"):
        tss.ssd_route(dtype, p, n)


def test_ssd_every_configured_shape_has_a_tensor_core_kernel():
    """Every (P, N) of a registered SSM or hybrid configuration, and of its
    smoke variant, is in TC_SHAPES, so its bf16 prefill runs on the tensor
    cores: a configuration at another (P, N) needs a launch_tc
    instantiation in csrc/ssd.cu and its TC_SHAPES entry, or its bf16 scan
    would run the SIMT kernel."""
    from repro_torch.configs.registry import REGISTRY, smoke_variant
    shapes = {}
    for cfg in REGISTRY.values():
        if cfg.ssm is not None:
            for c in (cfg, smoke_variant(cfg)):
                shapes[c.name] = (c.ssm.headdim, c.ssm.d_state)
    assert {"mamba2-370m", "zamba2-7b"} <= set(shapes)
    assert {name: s for name, s in shapes.items()
            if s not in tss.TC_SHAPES} == {}


def test_ssd_tc_shapes_fit_the_routes_rules():
    """The tensor-core kernel's static rules (csrc/ssd.cu TcShape): P and N
    multiples of 16, at most 128."""
    for p, n in tss.TC_SHAPES:
        assert p % 16 == 0 and n % 16 == 0
        assert p <= tss.MAX_HEADDIM and n <= tss.MAX_STATE


def _in_proj_slices(b, s, h, p, n, dtype=torch.bfloat16):
    """x, B, C as the model hands them: slices of one (B, S, H P + 2 N)
    conv output, viewed without a copy."""
    xbc = torch.zeros(b, s, h * p + 2 * n, dtype=dtype)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    return x, xbc[..., h * p:h * p + n], xbc[..., h * p + n:]


@pytest.mark.parametrize("p,n", [(112, 64), (64, 128), (16, 16)])
def test_ssd_check_tc_takes_the_models_slices(p, n):
    x, bm, cm = _in_proj_slices(2, 10, 4, p, n)
    assert x.data_ptr() != bm.data_ptr()        # views of one buffer
    tss._check_tc(x, bm, cm)


def test_ssd_check_tc_raises_on_a_sequence_stride_off_eight():
    x, bm, cm = _in_proj_slices(2, 10, 4, 112, 64)
    wide = torch.zeros(2, 10, 64 + 4, dtype=torch.bfloat16)
    odd = wide[..., :64]                        # row stride 68
    with pytest.raises(ValueError, match="stride"):
        tss._check_tc(x, odd, cm)
    with pytest.raises(ValueError, match="stride"):
        tss._check_tc(x, bm, odd)


def test_ssd_check_tc_raises_on_a_batch_stride_off_eight():
    x = torch.zeros(2 * 10 * 4 * 112 + 4, dtype=torch.bfloat16)
    at = (-x.data_ptr() % 16) // 2
    xv = x[at:].as_strided((2, 10, 4, 112), (10 * 448 + 4, 448, 112, 1))
    _, bm, cm = _in_proj_slices(2, 10, 4, 112, 64)
    with pytest.raises(ValueError, match="dim 0"):
        tss._check_tc(xv, bm, cm)


def test_ssd_check_tc_raises_on_an_unaligned_base():
    flat = torch.zeros(2 * 10 * 64 + 16, dtype=torch.bfloat16)
    at = (-flat.data_ptr() % 16) // 2          # first 16-byte aligned index
    aligned = flat[at:at + 2 * 10 * 64].view(2, 10, 64)
    x, _, _ = _in_proj_slices(2, 10, 4, 112, 64)
    tss._check_tc(x, aligned, aligned)
    shifted = flat[at + 1:at + 1 + 2 * 10 * 64].view(2, 10, 64)
    with pytest.raises(ValueError, match="aligned"):
        tss._check_tc(x, shifted, aligned)


def test_ssd_check_tc_ignores_strides_of_length_one_dims():
    """A batch of one, or a single row, may have any stride there."""
    x, bm, cm = _in_proj_slices(1, 1, 4, 112, 64)
    odd = x.as_strided(x.shape, (3, 5, 112, 1))
    tss._check_tc(odd, bm, cm)


def test_ssd_check_raises_on_non_dense_heads_and_float_types():
    x, bm, cm = _in_proj_slices(1, 8, 4, 16, 16)
    dt = torch.zeros(1, 8, 4)
    a = torch.zeros(4)
    tss._check(x, dt, a, bm, cm, torch.ones(4))
    with pytest.raises(ValueError, match="dense"):
        tss._check(x[:, :, :, :8], dt, a, bm[..., :16], cm[..., :16], None)
    with pytest.raises(TypeError, match="float32"):
        tss._check(x, dt, a, bm, cm, torch.ones(4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        tss._check(x, dt, a, bm, cm, torch.ones(8)[::2])


def test_ssd_routes_are_counted_only_on_the_card():
    """CPU tensors run the plain version: no launch and no route counted."""
    before, launches = dict(tss.ROUTES), dict(tss.LAUNCHES)
    x, bm, cm = _in_proj_slices(1, 5, 2, 16, 16)
    tss.ssd_scan(x, torch.ones(1, 5, 2), -torch.ones(2), bm, cm, 4,
                 d=torch.ones(2))
    assert tss.ROUTES == before and tss.LAUNCHES == launches
    assert set(tss.ROUTES) == {"tensor_core", "simt"}


def test_ssd_groups_are_the_one_group_scans_of_their_heads():
    """b, c (B, S, G, N): head h reads group h // (H / G), so the scan is
    the one-group scan of each group's heads on its B and C, joined along
    the heads (what the card runs, one launch a group, on these views)."""
    g, h, p, n = 2, 4, 16, 16
    rng = np.random.default_rng(7)
    xbc = torch.from_numpy(rng.normal(size=(2, 9, h * p + 2 * g * n))).float()
    x = xbc[..., :h * p].reshape(2, 9, h, p)
    bm = xbc[..., h * p:h * p + g * n].unflatten(-1, (g, n))
    cm = xbc[..., h * p + g * n:].unflatten(-1, (g, n))
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.normal(size=(2, 9, h))).float())
    a = -torch.exp(torch.from_numpy(rng.normal(size=h)).float())
    d = torch.from_numpy(rng.normal(size=h)).float()
    y, st = tss.ssd_scan(x, dt, a, bm, cm, 4, d=d)
    hg = h // g
    for k in range(g):
        hs = slice(k * hg, (k + 1) * hg)
        yk, sk = tss.ssd_scan(x[:, :, hs], dt[:, :, hs].contiguous(), a[hs],
                              bm[:, :, k], cm[:, :, k], 4, d=d[hs])
        torch.testing.assert_close(y[:, :, hs], yk, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(st[:, hs], sk, rtol=1e-5, atol=1e-5)


def test_ssd_groups_must_divide_the_heads():
    x = torch.zeros(1, 5, 3, 16)
    bm = torch.zeros(1, 5, 2, 16)
    with pytest.raises(ValueError, match="G dividing"):
        tss.ssd_scan(x, torch.ones(1, 5, 3), -torch.ones(3), bm, bm, 4)
    with pytest.raises(ValueError, match="G dividing"):
        tss.ssd_scan(x[:, :, :2], torch.ones(1, 5, 2), -torch.ones(2), bm,
                     bm[:, :, :1], 4)


# -- the decode plan ------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 4, 1023, 1024, 1025, 4097, 156_250,
                               10 ** 6, 10 ** 8])
def test_decode_plan_grid_is_a_function_of_n_only(n):
    """Blocks depend on n alone (not on the table or its dtype), 8 rows a
    thread, at most MAX_BLOCKS, and never past the word's 12 bits."""
    grids = {tdd.decode_plan(n, d, size).blocks
             for d in (0, 1, 11, 4000, 10 ** 5) for size in (4, 8)}
    assert len(grids) == 1
    blocks = grids.pop()
    assert blocks == tdd.grid_blocks(n, tdd.ROWS_PER_THREAD)
    assert 1 <= blocks <= 1056 < 2 ** 12         # the word's 12 bits
    assert blocks * 256 * 8 >= n or blocks == 1056


@pytest.mark.parametrize("n,d,size,staged", [
    (156_250, 4000, 8, False),     # phase 3's DICT block: 4,000 > 2,030 rows
    (156_250, 2030, 8, True), (156_250, 2031, 8, False),
    (156_250, 11, 8, True),
    (1, 1, 4, True), (1, 2, 4, False),
    (10 ** 8, 6144, 8, True),      # 48 KB exactly
    (10 ** 8, 6145, 8, False),     # past 48 KB
    (10 ** 8, 12288, 4, True), (10 ** 8, 12289, 4, False),
    (10 ** 6, 2045, 8, True), (10 ** 6, 2046, 8, False),
    (10, 0, 8, False),
])
def test_decode_plan_staging_rule(n, d, size, staged):
    """The dictionary is staged in shared memory when it fits in 48 KB and
    has no more values than the rows one block decodes."""
    plan = tdd.decode_plan(n, d, size)
    rows = -(-n // plan.blocks)
    assert plan.staged == staged
    assert plan.staged == (0 < d * size <= tdd.SMEM_BYTES and d <= rows)


@pytest.mark.parametrize("op", [0, 1, 2])
@pytest.mark.parametrize("n,d", [(1, 1), (156_250, 11), (156_250, 4000),
                                 (10 ** 9, 3)])
@pytest.mark.parametrize("code", range(4))
def test_decode_plan_word_round_trips(op, n, d, code):
    """decode.cu's Plan reads op (bits 0-1), dtype (2-3), staging (4) and
    blocks (11-22) back; no other bit is set (bit-pack's widths and biases
    travel in its descriptors)."""
    plan = tdd.decode_plan(n, d, 8)
    w = plan.word(op, code)
    assert 0 <= w < 2 ** 23
    assert w & 3 == op and (w >> 2) & 3 == code
    assert (w >> 4) & 1 == int(plan.staged)
    assert (w >> 5) & 63 == 0 and (w >> 11) & 4095 == plan.blocks


def test_decode_word_bitpack_and_rle_keep_four_rows_a_thread():
    """Only dict_decode's kernel steps over its rows by a grid of n alone;
    RLE decodes a 1,024-position tile a block, four positions a thread
    (phase 3's column: 153 blocks), at most RLE_MAX_BLOCKS, and bit-pack a
    128-row tile of every column a block (phase 3's partition: 1,221
    blocks), at most BITPACK_MAX_BLOCKS, whatever the widths."""
    n = 156_250
    w = tdd._word(tdd._OP_RLE, n, 7, torch.float64)
    assert (w >> 11) & 4095 == tdd.rle_plan(n).blocks == 153
    assert (w >> 4) & 1 == 0
    assert tdd.RLE_TILE == 1024 == 4 * 256
    assert tdd.rle_plan(1).blocks == tdd.rle_plan(1024).blocks == 1
    assert tdd.rle_plan(1025).blocks == 2
    assert tdd.rle_plan(2 ** 31 - 1).blocks == tdd.RLE_MAX_BLOCKS < 2 ** 12
    w = tdd._word(tdd._OP_BITPACK, n, 0, torch.float32)
    assert (w >> 11) & 4095 == tdd.bitpack_plan(n).blocks == 1221
    assert w & 3 == tdd._OP_BITPACK and (w >> 2) & 3 == 2
    assert tdd.bitpack_plan(1).blocks == tdd.bitpack_plan(128).blocks == 1
    assert tdd.bitpack_plan(129).blocks == 2
    assert tdd.bitpack_plan(10 ** 9).blocks == tdd.BITPACK_MAX_BLOCKS \
        == 2112 < 2 ** 12
    w = tdd._word(tdd._OP_DICT, n, 7, torch.float64)
    assert (w >> 11) & 4095 == tdd.decode_plan(n, 7, 8).blocks == 77


def test_decode_word_is_cached_per_size_and_dtype():
    """One lru_cache lookup a call: the same sizes give the same word
    object's value, another dtype another code."""
    w64 = tdd._word(tdd._OP_DICT, 156_250, 4000, torch.float64)
    w32 = tdd._word(tdd._OP_DICT, 156_250, 4000, torch.float32)
    assert w64 == tdd.decode_plan(156_250, 4000, 8).word(0, 3)
    assert w32 == tdd.decode_plan(156_250, 4000, 4).word(0, 2)
    info = tdd._word.cache_info()
    tdd._word(tdd._OP_DICT, 156_250, 4000, torch.float64)
    assert tdd._word.cache_info().hits == info.hits + 1


def test_dict_decode_raises_on_what_the_c_side_cannot_check():
    """dtypes, rank and contiguity are the wrapper's to check; the rest
    (an empty dictionary, alignment, the plan) decode.cu's."""
    codes = torch.zeros(8, dtype=torch.int32)
    dic = torch.zeros(4, dtype=torch.float64)
    tdd._check_dict(codes, dic)
    with pytest.raises(TypeError):
        tdd._check_dict(codes.long(), dic)
    with pytest.raises(TypeError):
        tdd._check_dict(codes, dic.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        tdd._check_dict(codes[::2], dic)
    with pytest.raises(ValueError, match="1-D"):
        tdd._check_dict(codes.view(2, 4), dic)


def test_dict_decode_mixed_devices_raise():
    """As groupby_sum's: a CPU / other-device mix reaches on_cpu, which
    raises."""
    codes = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        tdd.dict_decode(codes, torch.zeros(4, dtype=torch.float64,
                                           device="meta"))


# -- train_grad's plan ----------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 1023, 156_250, 10 ** 8])
@pytest.mark.parametrize("d", [1, 12, 32, 33, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_train_plan_word_round_trips(n, d, dtype):
    """train.cu's Plan reads float64 (bit 0), logistic (1), the width class
    (2-4) and the blocks (8-19) back."""
    plan = ttg.train_plan(n, d, dtype)
    for logistic in (False, True):
        w = plan.word(dtype == torch.float64, logistic)
        assert w & 1 == int(dtype == torch.float64)
        assert (w >> 1) & 1 == int(logistic)
        assert (w >> 2) & 7 == plan.width_class
        assert (w >> 8) & 4095 == plan.blocks
        assert w < 2 ** 20 and (w >> 5) & 7 == 0


@pytest.mark.parametrize("d,route,pad", [
    (1, "registers", 4), (4, "registers", 4), (5, "registers", 8),
    (12, "registers", 16), (16, "registers", 16), (17, "registers", 32),
    (31, "registers", 32), (32, "registers", 32), (33, "chunked", None),
    (64, "chunked", None), (2048, "chunked", None)])
def test_train_route_follows_d_at_the_limit(d, route, pad):
    """d <= REG_MAX_DIMS keeps its accumulators in registers, padded to 4,
    8, 16 or 32 (2 << width class); above it the chunked route."""
    assert ttg.REG_MAX_DIMS == 32
    for dtype in (torch.float32, torch.float64):
        plan = ttg.train_plan(156_250, d, dtype)
        assert plan.route == route
        if pad is None:
            assert plan.width_class == 0
        else:
            assert 2 << plan.width_class == pad


@pytest.mark.parametrize("n", [0, 1, 511, 512, 513, 156_250, 10 ** 6,
                               10 ** 9])
def test_train_grid_is_a_function_of_n_only(n):
    """The grid (and so the fold's order) depends on n alone: a block per
    512 rows, at most MAX_BLOCKS blocks, within the word's 12 bits."""
    grids = {ttg.train_plan(n, d, dt).blocks for d in (1, 12, 32, 33, 2048)
             for dt in (torch.float32, torch.float64)}
    assert grids == {tdd.grid_blocks(n, 2)}
    assert 1 <= grids.pop() <= 1056 < 2 ** 12
    assert ttg.train_plan(156_250, 12, torch.float32).blocks == 306


def test_train_plan_raises_outside_its_columns_and_dtypes():
    with pytest.raises(ValueError):
        ttg.train_plan(10, 0, torch.float32)
    with pytest.raises(ValueError):
        ttg.train_plan(10, 2049, torch.float32)
    with pytest.raises(TypeError):
        ttg.train_plan(10, 4, torch.bfloat16)


def test_train_launch_is_one_allocation_and_nine_plain_arguments():
    """One float64 buffer: the output (d), then a partial row per block;
    the C entry takes x, y, w, n, d, the plan word, the buffer, the ticket
    and the stream."""
    route, word, size = ttg._launch(156_250, 12, torch.float32, True)
    assert route == "registers" and size == 12 + 306 * 12
    assert word == ttg.train_plan(156_250, 12, torch.float32).word(False,
                                                                   True)
    ct = _build.ctypes
    assert _build.SIGNATURES["train"][1] == [
        ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_longlong, ct.c_int,
        ct.c_ulonglong, ct.c_void_p, ct.c_void_p, ct.c_void_p]


def test_train_fold_ticket_is_one_word_per_device_and_stream(monkeypatch):
    """Calls on one stream share its ticket (they run in order); another
    stream gets its own, so overlapping calls never share one; none is
    allocated inside a graph capture."""
    monkeypatch.setattr(ttg, "_TICKETS", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    dev = torch.device("cpu")
    first = ttg._ticket(dev, 1)
    assert first.dtype == torch.int32 and first.tolist() == [0]
    assert ttg._ticket(dev, 1) is first
    assert ttg._ticket(dev, 2) is not first
    assert ttg._ticket(dev, 2).data_ptr() != first.data_ptr()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert ttg._ticket(dev, 2) is ttg._ticket(dev, 2)
    with pytest.raises(RuntimeError, match="before a CUDA graph capture"):
        ttg._ticket(dev, 3)


def test_train_routes_are_counted_only_on_the_card():
    before, launches = dict(ttg.ROUTES), dict(ttg.LAUNCHES)
    x = torch.ones(5, 3)
    ttg.train_grad(x, torch.ones(5), torch.ones(3))
    assert ttg.ROUTES == before and ttg.LAUNCHES == launches
    assert set(ttg.ROUTES) == {"registers", "chunked"}


# -- the batched bit-pack decode ------------------------------------------


def _bitpack_block(n, width, bias, dtype, offset=0):
    words = torch.arange(offset, offset + -(-n // (32 // width)),
                         dtype=torch.int32)
    return tdd.BitpackBlock(words, width, bias, dtype)


def _unpack_descriptor(row) -> dict:
    words, dst, bias, tail = (int(v) for v in row)
    return {"words": words, "dst": dst, "bias": bias,
            "stride": tail & 0xFFFFFFFF, "bit_width": (tail >> 32) & 0xFF,
            "dtype_code": (tail >> 40) & 0xFF}


@pytest.mark.parametrize("width", [1, 4, 16])
@pytest.mark.parametrize("bias", [0, -7, 2 ** 40, -2 ** 63, 2 ** 63 - 1])
@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.int16,
                                   torch.uint16, torch.int32, torch.uint32,
                                   torch.int64, torch.uint64])
def test_bitpack_descriptors_pack_and_unpack(width, bias, dtype):
    """Four int64 a block: words and destination addresses, the int64
    bias, then stride | width << 32 | dtype code << 40 (decode.cu's
    32-byte BitpackDesc, little-endian)."""
    x = torch.zeros(100, 12, dtype=torch.float32)
    y = torch.zeros(100, dtype=torch.float32)
    blocks = [_bitpack_block(100, width, bias, dtype),
              _bitpack_block(100, 16, -1, torch.int64)]
    descs = tdd.pack_bitpack_descriptors(blocks, [x[:, 5], y])
    assert descs.shape == (2, 4) and descs.dtype == np.int64
    assert descs.nbytes == 2 * 32
    got = _unpack_descriptor(descs[0])
    assert got == {"words": blocks[0].words.data_ptr(),
                   "dst": x.data_ptr() + 5 * 4, "bias": bias, "stride": 12,
                   "bit_width": width,
                   "dtype_code": tdd.BITPACK_ORIG_CODES[dtype]}
    got = _unpack_descriptor(descs[1])
    assert got["dst"] == y.data_ptr() and got["stride"] == 1
    assert got["bit_width"] == 16 and got["bias"] == -1


def test_bitpack_batch_raises_past_the_descriptor_limit():
    """One launch's descriptors hold at most 32 blocks; the entry point
    takes any number, one launch per 32."""
    n = 64
    x = torch.zeros(n, 40)
    blocks = [_bitpack_block(n, 2, 0, torch.int64) for _ in range(40)]
    dests = [x[:, j] for j in range(40)]
    assert tdd.MAX_BITPACK_COLUMNS == 32
    assert tdd.pack_bitpack_descriptors(blocks[:32], dests[:32]).shape \
        == (32, 4)
    with pytest.raises(ValueError, match="1..32"):
        tdd.pack_bitpack_descriptors(blocks[:33], dests[:33])
    with pytest.raises(ValueError, match="1..32"):
        tdd.pack_bitpack_descriptors([], [])
    tdd._check_bitpack(blocks, dests, n)
    with pytest.raises(ValueError):
        tdd._check_bitpack([], [], n)
    with pytest.raises(ValueError):
        tdd._check_bitpack(blocks[:2], dests[:3], n)


def test_bitpack_batch_takes_more_blocks_than_one_launch_holds():
    """40 blocks, past one launch's 32 descriptors: every destination gets
    its column's values."""
    rng = np.random.default_rng(11)
    n, k = 300, 40
    x = torch.zeros(n, k, dtype=torch.float64)
    blocks, want = [], []
    for j in range(k):
        width, bias = 1 + j % 16, j * 1000 - 2 ** 35
        vals = rng.integers(0, 1 << width, n).astype(np.uint32)
        blocks.append(tdd.BitpackBlock(
            torch.from_numpy(_pack_words(vals, width).view(np.int32)), width,
            bias, torch.int64))
        want.append(torch.from_numpy(vals.astype(np.int64) + bias).double())
    tdd.bitpack_decode_into(blocks, [x[:, j] for j in range(k)], n)
    for j in range(k):
        assert torch.equal(x[:, j], want[j]), j


@pytest.mark.parametrize("width", [0, 17, 32])
def test_bitpack_batch_raises_on_widths_outside_1_to_16(width):
    n = 64
    block = tdd.BitpackBlock(torch.zeros(64, dtype=torch.int32), width, 0,
                             torch.int64)
    with pytest.raises(ValueError, match="bit widths"):
        tdd._check_bitpack([block], [torch.zeros(n)], n)


def test_bitpack_batch_raises_on_what_the_c_side_cannot_check():
    n = 64
    ok = _bitpack_block(n, 4, 0, torch.int64)
    dst = torch.zeros(n)
    assert tdd._check_bitpack([ok], [dst], n) == torch.float32
    with pytest.raises(ValueError, match="do not fit"):
        tdd._check_bitpack([ok], [torch.zeros(n + 8)], n + 8)
    with pytest.raises(TypeError):
        tdd._check_bitpack([ok._replace(words=ok.words.long())], [dst], n)
    with pytest.raises(TypeError):
        tdd._check_bitpack([ok._replace(dtype=torch.float32)], [dst], n)
    with pytest.raises(TypeError):
        tdd._check_bitpack([ok], [dst.to(torch.bfloat16)], n)
    with pytest.raises(ValueError, match="vector"):
        tdd._check_bitpack([ok, ok], [dst, dst.double()], n)
    with pytest.raises(ValueError, match="vector"):
        tdd._check_bitpack([ok], [torch.zeros(n - 1)], n)
    with pytest.raises(ValueError, match="int64"):
        tdd._check_bitpack([ok._replace(bias=2 ** 63)], [dst], n)


def test_bitpack_batch_mixed_devices_raise():
    n = 64
    block = _bitpack_block(n, 4, 0, torch.int64)
    with pytest.raises(ValueError):
        tdd.bitpack_decode_into([block], [torch.zeros(n, device="meta")], n)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("out", [torch.float32, torch.float64, torch.int32])
def test_bitpack_batch_plain_is_the_per_column_sequence(dtype, out):
    """On the CPU the batched entry writes, into each strided destination,
    exactly the int32 lanes widened, plus the int64 bias, cast to the
    block's dtype and then to the destination's."""
    rng = np.random.default_rng(3)
    n = 1001
    x = torch.full((n, 6), -1.0, dtype=out) if out.is_floating_point \
        else torch.full((n, 6), -1, dtype=out)
    blocks, want = [], []
    for j, (width, bias) in enumerate(((1, 0), (3, -2 ** 33), (7, 2 ** 31),
                                       (16, -5), (12, 2 ** 40 + 3))):
        vals = rng.integers(0, 1 << width, n).astype(np.uint32)
        words = _pack_words(vals, width)
        blocks.append(tdd.BitpackBlock(torch.from_numpy(words.view(np.int32)),
                                       width, bias, dtype))
        want.append(torch.from_numpy(vals.astype(np.int64) + bias)
                    .to(dtype).to(out))
    tdd.bitpack_decode_into(blocks, [x[:, j] for j in range(5)], n)
    for j in range(5):
        assert torch.equal(x[:, j], want[j])
    assert bool((x[:, 5] == -1).all())


def _pack_words(vals, width):
    per = 32 // width
    nw = -(-len(vals) // per)
    padded = np.zeros(nw * per, np.uint32)
    padded[:len(vals)] = vals
    words = np.zeros(nw, np.uint32)
    for j in range(per):
        words |= padded[j::per] << np.uint32(j * width)
    return words


# -- the top-k's routes, grid and lanes operand -----------------------------


@pytest.mark.parametrize("k,route", [(ttk.FUSED_MAX_K - 1, "fused"),
                                     (ttk.FUSED_MAX_K, "fused"),
                                     (ttk.FUSED_MAX_K + 1, "rounds")])
@pytest.mark.parametrize("lanes", [False, True])
def test_topk_route_at_the_fused_limit(k, route, lanes):
    """Route `fused` keeps m = min(k, n) <= FUSED_MAX_K rows a block list;
    one more takes the tiles-plus-rounds kernels.  A k above the limit
    over fewer rows is still fused: m counts, not k."""
    plan = ttk.topk_plan(10 ** 6, 64, k, torch.float32, lanes)
    assert plan.route == route and plan.m == k
    assert (plan.blocks >= 1) == (route == "fused")
    assert ttk.topk_plan(1000, 64, k, torch.float32, lanes).route == "fused"


@pytest.mark.parametrize("n,tiles,blocks", [(1, 1, 1), (256, 1, 1),
                                            (15_625, 62, 62),
                                            (15_872, 62, 62)])
def test_topk_grid_is_one_block_a_tile_up_to_the_fold(n, tiles, blocks):
    """Phase 4's partition (15,625 rows) is 62 tiles of 256, one block
    each; one tile is one block, which writes its list out itself."""
    plan = ttk.topk_plan(n, 64, 100, torch.float32)
    assert (plan.tiles, plan.blocks, plan.m) == (tiles, blocks, min(100, n))
    assert plan.word() == blocks    # the threshold fold: bit 12 clear


@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("m", [1, 100, 1000, ttk.FUSED_MAX_K])
def test_topk_grid_past_the_fold_takes_several_tiles_a_block(lanes, m):
    """With G + 1 tiles the grid stays at G, the most blocks whose lists
    one block folds in shared memory (at most one an SM); one block then
    walks two tiles.  The launch's shared memory fits a block."""
    g = ttk.max_fused_blocks(64, lanes, m)
    assert 1 <= g <= ttk.FUSED_MAX_BLOCKS
    assert ttk.fused_smem(64, lanes, m, g) <= ttk.SMEM_LIMIT \
        < BLOCK_SMEM_LIMIT
    assert g == ttk.FUSED_MAX_BLOCKS \
        or ttk.fused_smem(64, lanes, m, g + 1) > ttk.SMEM_LIMIT
    plan = ttk.topk_plan((g + 1) * 256, 64, m, torch.float32, lanes)
    assert (plan.tiles, plan.blocks) == (g + 1, g)
    plan = ttk.topk_plan(g * 256, 64, m, torch.float32, lanes)
    assert (plan.tiles, plan.blocks) == (g, g)


def test_topk_shared_memory_follows_topk_cu_layout():
    """fused_smem is topk.cu's Layout: at phase 4's plan the scoring part
    (q, two 36 KB stages, a tile's scores, sort exchange and list, two
    lists of 100) is 84,832 bytes; the fold, the larger of the fast path
    (16-entry prefixes of 62 lists, their subset, 256 survivor slots) and
    the merge rounds (62 lists, 31 for their output), then lengths,
    counts and offsets, 112,412, which a block asks for."""
    score = 8 * 64 + 2 * 256 * 144 + 32 * 256 + 24 * 100
    fast = 32 * 62 * 16 + 24 * 256
    rounds = 12 * 62 * 100 + 12 * 31 * 100
    fold = max(fast, rounds) + 4 * (3 * 62 + 1) + 4 * 16
    assert (score, fast, rounds, fold) == (84_832, 37_888, 111_600, 112_412)
    assert ttk.fused_smem(64, False, 100, 62) == fold
    # the lanes entry stages nothing: one block's tile and lists outweigh
    # its fold
    assert ttk.fused_smem(64, True, 100, 1) == 32 * 256 + 24 * 100
    # a wide x stages the same ring: q grows, the stages do not
    assert ttk.fused_smem(4096, False, 1, 1) == 8 * 4096 + 2 * 256 * 144 \
        + 32 * 256 + 24


@pytest.mark.parametrize("fold", ttk.FOLDS)
@pytest.mark.parametrize("n,k", [(1, 1), (15_625, 100), (10 ** 6, 2048),
                                 (10 ** 6, 5000)])
def test_topk_word_and_buffer_round_trip(fold, n, k):
    """topk.cu reads G from bits 0-11 and the fold from bit 12; the one
    allocation holds out_r, out_s, then G lists of m float64 scores and m
    int32 rows (fused), or four lists of tiles * min(m, 256) entries
    (rounds)."""
    plan = ttk.topk_plan(n, 64, k, torch.float64)._replace(fold=fold)
    m = min(n, k)
    if plan.route == "fused":
        w = plan.word()
        assert w & 4095 == plan.blocks and (w >> 12) == ttk.FOLDS.index(fold)
        assert 0 <= plan.buffer_words() * 8 - (16 * m + 12 * plan.blocks * m) \
            < 8
    else:
        assert plan.buffer_words() == 2 * m + 4 * plan.tiles * 256


def test_topk_plan_raises_outside_its_lanes_rows_and_dtypes():
    with pytest.raises(TypeError):
        ttk.topk_plan(10, 4, 3, torch.bfloat16)
    with pytest.raises(ValueError):
        ttk.topk_plan(10, ttk.MAX_DIMS + 1, 3, torch.float32)
    with pytest.raises(ValueError):
        ttk.topk_plan(10, ttk.MAX_LANES + 1, 3, torch.float32, lanes=True)
    with pytest.raises(ValueError):
        ttk.topk_plan(2 ** 31 - 1, 4, 3, torch.float32)
    assert ttk.topk_plan(10, ttk.MAX_LANES, 3, torch.float32,
                         lanes=True).route == "fused"


def test_topk_fused_signature():
    """shark_topk_fused(x, lanes, x_dt, q, n, d, m, word, buf, ticket,
    stream): pointers as c_void_p, n as c_longlong, the word unsigned."""
    ct = _build.ctypes
    assert _build.SIGNATURES["topk_fused"] == ("shark_topk_fused", [
        ct.c_void_p, ct.c_void_p, ct.c_int, ct.c_void_p, ct.c_longlong,
        ct.c_int, ct.c_int, ct.c_ulonglong, ct.c_void_p, ct.c_void_p,
        ct.c_void_p])
    assert _build.LIBRARY["topk_fused"] == "topk"


def test_topk_lane_descriptors_pack_addresses_then_weights():
    """The lanes operand: d addresses, then the d float64 weights' bits."""
    lanes = [torch.arange(5, dtype=torch.float32) + j for j in range(3)]
    w = np.array([0.5, -2.0, np.pi])
    desc = ttk.pack_lane_descriptors(lanes, w)
    assert desc.dtype == np.int64 and desc.shape == (6,)
    assert list(desc[:3]) == [t.data_ptr() for t in lanes]
    np.testing.assert_array_equal(desc[3:].view(np.float64), w)


@pytest.mark.parametrize("count", [0, ttk.MAX_LANES + 1])
def test_topk_lane_descriptors_refuse_what_the_parameters_cannot_hold(count):
    lanes = [torch.zeros(4)] * count
    with pytest.raises(ValueError, match="lanes"):
        ttk.pack_lane_descriptors(lanes, np.zeros(count))
    with pytest.raises(ValueError):
        ttk.pack_lane_descriptors([torch.zeros(4)] * 2, np.zeros(3))


def test_topk_search_route_names_the_lanes_it_can_read_in_place():
    f32 = [torch.zeros(10) for _ in range(64)]
    assert ttk.search_route(f32) == "lanes"
    assert ttk.search_route([t.double() for t in f32]) == "lanes"
    assert ttk.search_route(f32[:1]) == "lanes"
    assert ttk.search_route(f32[:-1] + [torch.zeros(10, dtype=torch.float64)]
                            ) == "stacked"                  # mixed dtypes
    assert ttk.search_route([t.long() for t in f32]) == "stacked"
    assert ttk.search_route([torch.zeros(20)[::2]] * 3) == "stacked"
    # a one-row column of a matrix keeps the matrix's stride: contiguous
    one = torch.zeros(1, 8)
    assert ttk.search_route([one[:, j].contiguous() for j in range(8)]) \
        == "lanes"
    assert ttk.search_route([torch.zeros(10)] * 2 + [torch.zeros(9)]) \
        == "stacked"
    assert ttk.search_route([torch.zeros(10)] * (ttk.MAX_LANES + 1)) \
        == "stacked"
    assert ttk.search_route([]) == "stacked"


def test_topk_routes_are_counted_only_on_the_card():
    """On the CPU neither entry launches: the kernel routes stay still."""
    before, launches = dict(ttk.ROUTES), dict(ttk.LAUNCHES)
    x = torch.rand(300, 4, dtype=torch.float64)
    ttk.topk_similarity(x, torch.rand(4, dtype=torch.float64), 5)
    ttk.topk_similarity_lanes(list(x.T.contiguous()), np.ones(4), 5)
    assert ttk.ROUTES == before and ttk.LAUNCHES == launches
    assert set(ttk.ROUTES) == {"fused", "rounds", "lanes", "stacked"}


def test_topk_fold_ticket_is_one_word_per_device_and_stream(monkeypatch):
    monkeypatch.setattr(ttk, "_TICKETS", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(_build, "stream_handle", lambda dev: 7)
    dev = torch.device("cpu")
    first = ttk._ticket(dev)
    assert first.dtype == torch.int32 and first.tolist() == [0]
    assert ttk._ticket(dev) is first
    monkeypatch.setattr(_build, "stream_handle", lambda dev: 8)
    assert ttk._ticket(dev) is not first
    monkeypatch.setattr(_build, "stream_handle", lambda dev: 9)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="topk_similarity's first call"):
        ttk._ticket(dev)


# -- RLE's tiles and plan word --------------------------------------------


@pytest.mark.parametrize("n,blocks", [(1, 1), (1024, 1), (1025, 2),
                                      (156_250, 153), (2_162_688, 2112),
                                      (2_162_689, 2112), (2 ** 31 - 1, 2112)])
def test_rle_plan_is_a_block_a_tile_up_to_the_cap(n, blocks):
    assert tdd.rle_plan(n).blocks == blocks
    assert not tdd.rle_plan(n).staged


@pytest.mark.parametrize("vals,out", [(torch.float64, torch.float32),
                                      (torch.int32, torch.int64),
                                      (torch.int64, torch.float64),
                                      (torch.float32, torch.int32)])
@pytest.mark.parametrize("stride", [1, 12, 2 ** 31 - 1])
@pytest.mark.parametrize("orig", [torch.int8, torch.uint64, None])
def test_rle_word_round_trips(vals, out, stride, orig):
    """decode.cu's Plan reads RLE's op (0-1), the values' dtype (2-3),
    blocks (11-22), the destination's dtype (23-24), the original dtype
    (25-27) and the stride (32-62) back; bits 4-10 and 28-31 stay clear."""
    n = 156_250
    odt = tdd.rle_odt(vals, orig)
    w = tdd.rle_word(n, vals, out, odt, stride)
    codes = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
             torch.float64: 3}
    assert w & 3 == tdd._OP_RLE and (w >> 2) & 3 == codes[vals]
    assert (w >> 4) & 127 == 0 and (w >> 28) & 15 == 0
    assert (w >> 11) & 4095 == 153
    assert (w >> 23) & 3 == codes[out] and (w >> 25) & 7 == odt
    assert (w >> 32) == stride < 2 ** 31
    assert _build.ctypes.c_ulonglong(w).value == w


def test_rle_casts_integer_values_through_their_original_dtype_only():
    """Integer run values take their block's original integer dtype (the
    kernel's OrigType codes); float values, and any other original dtype,
    keep the value (int64's code)."""
    keep = tdd.BITPACK_ORIG_CODES[torch.int64]
    assert tdd.RLE_KEEP == keep
    assert tdd.rle_odt(torch.int64, torch.int8) == 0
    assert tdd.rle_odt(torch.int64, torch.uint64) == 7
    assert tdd.rle_odt(torch.int32, torch.uint16) == 3
    assert tdd.rle_odt(torch.int64, None) == keep
    assert tdd.rle_odt(torch.int64, torch.bool) == keep
    assert tdd.rle_odt(torch.float64, torch.float16) == keep
    assert tdd.rle_odt(torch.float64, torch.int8) == keep


def test_rle_decode_into_raises_on_what_the_c_side_cannot_check():
    """dtypes, ranks, sizes, the destination and one device are the
    wrapper's to check; decode.cu refuses no runs and misalignment."""
    vals = torch.zeros(3, dtype=torch.float64)
    ends = torch.zeros(3, dtype=torch.int32)
    dst = torch.zeros(8, dtype=torch.float32)
    tdd._check_rle(vals, ends, 8, dst)
    tdd._check_rle(vals, ends, 4, torch.zeros((4, 12))[:, 3])
    with pytest.raises(ValueError, match="destination"):
        tdd._check_rle(vals, ends, 7, dst)
    with pytest.raises(ValueError, match="destination"):
        tdd._check_rle(vals, ends, 8, dst.to(torch.int16))
    with pytest.raises(ValueError, match="run ends"):
        tdd._check_rle(vals, ends[:2], 8, dst)
    with pytest.raises(TypeError):
        tdd._check_rle(vals, ends.long(), 8, dst)
    with pytest.raises(ValueError):          # a CPU / meta mix
        tdd.rle_decode_into(vals, ends, 8, dst.to("meta"))


# -- the one-launch scan: plan, word, signature ---------------------------


@pytest.mark.parametrize("n,blocks,warps", [
    (0, 1, 1), (1, 1, 1), (128, 1, 1), (129, 2, 1),
    (93_750, 132, 6),                   # phase 2's partition: 733 tiles
    (10 ** 6, 132, 32), (10 ** 7, 132, 32)])
def test_scan_plan_grid_at_sizes(n, blocks, warps):
    """Warp tiles of 128 rows (4 a lane) over at most 132 blocks (one an
    SM), with the warps that give each warp one tile a step, up to 32: the
    grid covers n in one step below 132 x 32 tiles."""
    plan = tcs.scan_plan(n)
    assert plan == (blocks, warps)
    assert tcs.TILE_ROWS == 128
    assert plan.blocks * plan.warps * tcs.TILE_ROWS >= n \
        or plan.warps == tcs.MAX_WARPS


@pytest.mark.parametrize("n", [0, 1, 255, 257, 93_750, 131_072, 131_073,
                               10 ** 6, 10 ** 7, 2 ** 39])
def test_scan_grid_is_a_function_of_n_only(n):
    """The blocks and warps in the plan word are the same for every dtype
    pair, coded or not, one column or two, and any dictionary."""
    grids = set()
    for f in range(4):
        for a in range(4):
            for coded, same, d in ((False, False, 0), (False, True, 0),
                                   (True, False, 11), (True, False, 10 ** 6)):
                w = tcs.scan_word(n, f, a, coded, same, d)
                grids.add(((w >> 7) & 63, (w >> 13) & 4095))
    assert len(grids) == 1
    warps, blocks = grids.pop()
    assert (blocks, warps) == tcs.scan_plan(n)
    assert 1 <= warps <= 32 and 1 <= blocks <= 132


@pytest.mark.parametrize("n,f,a,coded,same,d", [
    (93_750, 3, 3, False, True, 0), (93_750, 3, 3, True, False, 11),
    (93_750, 0, 2, False, False, 0), (10 ** 7, 1, 0, True, False, 4096),
    (10 ** 6, 2, 1, True, False, 2 ** 30 - 1), (1, 0, 0, True, False, 0)])
def test_scan_word_bits_round_trip(n, f, a, coded, same, d):
    """scan.cu reads the dtypes (bits 0-1, 2-3), codes (4), one column (5),
    the staged dictionary (6), warps (7-12), blocks (13-24) and the
    dictionary's length (25-54) back, and nothing above them."""
    plan = tcs.scan_plan(n)
    w = tcs.scan_word(n, f, a, coded, same, d)
    assert w & 3 == f and (w >> 2) & 3 == a
    assert (w >> 4) & 1 == int(coded) and (w >> 5) & 1 == int(same)
    assert (w >> 6) & 1 == int(coded and tcs.scan_staged(n, d))
    assert (w >> 7) & 63 == plan.warps and (w >> 13) & 4095 == plan.blocks
    assert (w >> 25) & (2 ** 30 - 1) == d
    assert w < 2 ** 55


@pytest.mark.parametrize("n,d,staged", [
    (93_750, 11, True),              # query b's L_DISCOUNT
    (93_750, 711, True),             # a block's 711 rows
    (93_750, 712, False),
    (10 ** 7, 4_096, True),          # 32 KB exactly
    (10 ** 7, 4_097, False),         # past 32 KB
    (300, 11, True), (300, 100, True), (300, 101, False),   # 3 blocks
    (1, 1, True), (1, 2, False), (10, 0, False)])
def test_scan_staging_rule(n, d, staged):
    """The dictionary is staged (as float64) when it fits in 32 KB and has
    no more values than the rows one block scans."""
    assert tcs.scan_staged(n, d) == staged
    rows = -(-n // tcs.scan_plan(n).blocks)
    assert staged == (0 < d * 8 <= tcs.STAGE_BYTES and d <= rows)


def test_scan_word_is_cached_per_size_dtypes_and_column():
    """One lru_cache lookup a call: the (word, buffer size) of (n, d,
    dtypes, codes, one column) is scan_word's and scan_buffer's."""
    f64 = torch.float64
    assert tcs._launch(93_750, 11, f64, f64, True, False) == (
        tcs.scan_word(93_750, 3, 3, True, False, 11), tcs.scan_buffer(93_750))
    assert tcs._launch(93_750, 0, torch.int32, f64, False, False) == (
        tcs.scan_word(93_750, 0, 3, False, False), tcs.scan_buffer(93_750))
    info = tcs._launch.cache_info()
    tcs._launch(93_750, 11, f64, f64, True, False)
    assert tcs._launch.cache_info().hits == info.hits + 1
    source = (_build.CSRC / "scan.cu").read_text()
    assert "constexpr int kMaxWarps = 32;" in source
    assert tcs.MAX_WARPS == 32


@pytest.mark.parametrize("n,doubles", [
    (0, 4), (1, 4), (128, 4), (129, 12), (93_750, 4 + 4 * 132),
    (10 ** 7, 4 + 4 * 132)])
def test_scan_buffer_is_the_answer_then_a_partial_a_block(n, doubles):
    """A call's one allocation: the 4-double answer, then 4 doubles a
    block for the partials the last block folds (none for one block,
    which writes the answer itself)."""
    assert tcs.scan_buffer(n) == doubles
    blocks = tcs.scan_plan(n).blocks
    assert doubles == 4 + (4 * blocks if blocks > 1 else 0)


def _c_arguments(source: str, entry: str) -> list:
    """The ctypes of a C entry point's arguments, read from its source."""
    text = source[source.index(f"extern \"C\" int {entry}("):]
    args = text[text.index("(") + 1:text.index(")")].split(",")
    ct = _build.ctypes
    kinds = []
    for arg in args:
        decl = " ".join(arg.split()[:-1]) + ("*" if "*" in arg else "")
        kinds.append(ct.c_void_p if "*" in decl or "cudaStream_t" in decl
                     else ct.c_ulonglong if "unsigned long long" in decl
                     else ct.c_longlong if "long long" in decl
                     else ct.c_double if "double" in decl
                     else ct.c_int)
    return kinds


def test_scan_signature_matches_the_c_entry():
    """shark_scan(filt, dict, agg, n, word, lo, hi, buf, ticket, stream):
    ten plain arguments, pointers and the stream as c_void_p, n as
    c_longlong, the plan word as c_ulonglong, the bounds as c_double."""
    ct = _build.ctypes
    name, args = _build.SIGNATURES["scan"]
    assert name == "shark_scan" and len(args) == 10
    assert args == [ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_longlong,
                    ct.c_ulonglong, ct.c_double, ct.c_double, ct.c_void_p,
                    ct.c_void_p, ct.c_void_p]
    source = (_build.CSRC / "scan.cu").read_text()
    assert _c_arguments(source, "shark_scan") == args
    word = tcs.scan_word(10 ** 7, 3, 3, True, False, 2 ** 30 - 1)
    assert ct.c_ulonglong(word).value == word


def test_scan_fold_ticket_is_one_word_per_device_and_stream(monkeypatch):
    """Both scan kernels take the ticket of `_common.stream_ticket`: calls
    on one stream share it (they run in order), another stream or device
    gets its own, and none is allocated inside a graph capture."""
    monkeypatch.setattr(tcs, "_TICKETS", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    dev = torch.device("cpu")
    first = tcs._ticket(dev, 7)
    assert first.dtype == torch.int32 and first.tolist() == [0]
    assert tcs._ticket(dev, 7) is first
    assert tcs._ticket(dev, 8) is not first
    assert tcs._TICKETS.keys() == {(None, 7), (None, 8)}
    for s in range(300):                 # no limit on the streams
        tcs._ticket(dev, 100 + s)
    assert tcs._ticket(dev, 399) is tcs._ticket(dev, 399)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert tcs._ticket(dev, 7) is first
    with pytest.raises(RuntimeError, match="scan's first call"):
        tcs._ticket(dev, 9)


def test_scan_launches_are_counted_only_on_the_card():
    launches = dict(tcs.LAUNCHES), dict(tdd.LAUNCHES)
    routes = dict(tcs.ROUTES)
    x = torch.arange(300, dtype=torch.float64)
    tcs.colscan(x, x, 3, 7)
    tdd.fused_decode_scan(torch.zeros(300, dtype=torch.int32), x[:3], x,
                          0, 1)
    assert (tcs.LAUNCHES, tdd.LAUNCHES) == launches
    assert tcs.ROUTES == routes


def test_scan_launch_passes_one_buffer_and_the_stream_ticket(monkeypatch):
    """launch_scan's one ctypes call (a stand-in entry on CPU tensors): the
    plan word, the buffer of scan_buffer(n) doubles whose first 4 are the
    answer, the stream's ticket and the stream; colscan's path counted in
    ROUTES (one column when the filter is the aggregate), none for codes."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(tcs, "_TICKETS", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(_build, "stream_handle", lambda dev: 5)
    monkeypatch.setattr(_build, "kernel_fn", lambda name: entry)
    monkeypatch.setattr(tcs, "ROUTES", {"one_column": 0, "two_columns": 0})
    n = 93_750
    x = torch.zeros(n, dtype=torch.float64)
    y = torch.zeros(n, dtype=torch.float32)
    c = torch.zeros(n, dtype=torch.int32)
    for filt, dic, agg, same in ((x, None, x, True), (y, None, x, False),
                                 (x[:n], None, x, True), (c, x[:11], x,
                                                          False)):
        out = tcs.launch_scan("scan", filt, dic, agg, 1.0, 2.0)
        args = calls[-1]
        assert len(args) == 10 and args[3] == n and args[9] == 5
        table = dic if dic is not None else filt
        d = 11 if dic is not None else 0
        assert args[4] == tcs.scan_word(
            n, tcs.SCAN_CODES[table.dtype], tcs.SCAN_CODES[agg.dtype],
            dic is not None, same, d)
        assert args[:3] == (filt.data_ptr(), None if dic is None
                            else dic.data_ptr(), agg.data_ptr())
        assert args[5:7] == (1.0, 2.0)
        assert out.shape == (4,) and out.data_ptr() == args[7]
        assert out.untyped_storage().nbytes() == 8 * tcs.scan_buffer(n)
        assert args[8] == tcs._ticket(x.device, 5).data_ptr()
    assert tcs.ROUTES == {"one_column": 2, "two_columns": 1}


def test_scan_launch_raises_before_the_kernel_on_what_scan_cu_cannot_see():
    """Rank, contiguity, dtypes (bf16 included), row counts, int32 codes:
    each raises in launch_scan before a library is loaded."""
    x = torch.zeros(8, dtype=torch.float64)
    c = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="1-D"):
        tcs.launch_scan("colscan", x.view(2, 4), None, x.view(2, 4), 0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tcs.launch_scan("colscan", torch.zeros(16)[::2], None, x, 0, 1)
    with pytest.raises(TypeError, match="bfloat16"):
        tcs.launch_scan("colscan", x.to(torch.bfloat16), None, x, 0, 1)
    with pytest.raises(ValueError, match="rows"):
        tcs.launch_scan("colscan", x[:7], None, x, 0, 1)
    with pytest.raises(TypeError, match="int32 codes"):
        tcs.launch_scan("fused_decode_scan", c.long(), x[:3], x, 0, 1)
    with pytest.raises(ValueError):
        tdd.fused_decode_scan(c, x[:3], x.to("meta"), 0, 1)


def test_radix_signature_matches_the_c_entry():
    """shark_radix(keys, n, B, word, out, scratch, stream): seven plain
    arguments, pointers and the stream as c_void_p, n as c_longlong, B as
    c_uint, the plan word as c_ulonglong."""
    ct = _build.ctypes
    name, args = _build.SIGNATURES["radix"]
    assert name == "shark_radix"
    assert args == [ct.c_void_p, ct.c_longlong, ct.c_uint, ct.c_ulonglong,
                    ct.c_void_p, ct.c_void_p, ct.c_void_p]
    source = (_build.CSRC / "radix.cu").read_text()
    parsed = _c_arguments(source, "shark_radix")
    assert "unsigned int num_buckets" in source
    assert parsed[:2] + parsed[3:] == args[:2] + args[3:]


def test_stream_scratch_is_one_fixed_zeroed_tensor_never_in_a_capture(
        monkeypatch):
    """radix.cu's look-back words: `stream_ticket` with `numel` keeps one
    zeroed tensor a (device, stream), never replaced (a graph captured
    after the first call keeps a live pointer), never allocated inside a
    graph capture, and refuses a request of another size."""
    from repro_torch.kernels._common import stream_ticket
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    words, dev = {}, torch.device("cpu")
    first = stream_ticket(words, dev, 7, "radix", 10, torch.int64)
    assert first.dtype == torch.int64 and first.tolist() == [0] * 10
    assert stream_ticket(words, dev, 7, "radix", 10, torch.int64) is first
    other = stream_ticket(words, dev, 8, "radix", 10, torch.int64)
    assert other is not first and other.numel() == 10
    with pytest.raises(ValueError, match="radix's stream words"):
        stream_ticket(words, dev, 7, "radix", 11, torch.int64)
    assert words[(None, 7)] is first
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert stream_ticket(words, dev, 7, "radix", 10, torch.int64) is first
    with pytest.raises(RuntimeError, match="radix's first call"):
        stream_ticket(words, dev, 9, "radix", 10, torch.int64)


@pytest.mark.parametrize("buckets", [1, 64, 1024, 1025, 8192])
def test_radix_scratch_is_the_most_any_call_uses(monkeypatch, buckets):
    """Every radix call asks the stream for the same SCRATCH_WORDS, which
    covers what any plan uses (two_launch's counters, one_launch's 264
    chunks of look-back words at 1,024 buckets)."""
    from repro_torch.kernels import radix_partition as rp
    assert rp.SCRATCH_WORDS == 2 + rp.GRID_MAX * rp.ONE_LAUNCH_MAX == 270338
    for n in (0, 50, 4096, 4097, 93750, 10 ** 7, rp.MAX_ROWS):
        for flags in (rp.IDS, rp.IDS | rp.COUNTS, rp.SPLIT):
            assert rp.radix_plan(n, buckets, flags).scratch <= rp.SCRATCH_WORDS
    asked = []
    monkeypatch.setattr(rp, "stream_ticket",
                        lambda *a: asked.append(a[4:]) or torch.zeros(1))
    monkeypatch.setattr(rp._build, "stream_handle", lambda dev: 3)
    monkeypatch.setattr(rp._build, "kernel_fn", lambda name: lambda *a: 0)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    monkeypatch.setattr(rp, "LAUNCHES", {"radix_partition": 0})
    monkeypatch.setattr(rp, "ROUTES", dict.fromkeys(rp.ROUTES, 0))
    for n in (5000, 93750):
        rp._launch(torch.zeros(n, dtype=torch.int64), buckets, rp.SPLIT)
    assert asked == [(rp.SCRATCH_WORDS, torch.int64)] * 2
