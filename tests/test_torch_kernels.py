"""The torch port's kernels against the JAX reference kernels.

Each test feeds the same numpy inputs, made from a seed, to the reference
Pallas kernel (interpret mode on the CPU, through `repro.kernels.ops`, as
tests/test_kernels.py and tests/test_kernels_topk.py run it, with float64
accumulation) and to the port's wrapper on CPU tensors, which runs the
kernel's plain PyTorch version.  Tolerances: counts, min, max, group ids,
bucket ids, decoded values, top-k row ids and their order exact; float64
sums and gradients to rtol 1e-12 (both sides accumulate in float64, in
different orders); top-k scores to rtol 1e-12 (the same float64 products,
summed in another order).

The flash-attention and SSD-scan kernels' twins against the reference are
in tests/test_torch_lm_kernels.py.  `test_cuda_kernel_matches_plain` holds
each CUDA kernel against its plain version on the card, and the
`test_cuda_*` tests below it each kernel's routes, dtypes, edge cases,
repeat-call bits and one-kernel-a-call; they need a CUDA device and skip
without one.
"""

import numpy as np
import pytest
import torch

try:
    import jax
    from repro.kernels import ops as jops
    from repro.kernels.radix_partition import radix_partition_ref
except ImportError:      # a GPU host without JAX runs the cuda test alone
    jax = jops = radix_partition_ref = None
from repro_torch.kernels import ops as tops
from repro_torch.kernels._common import graph_nodes
from repro_torch.kernels import colscan as tcolscan
from repro_torch.kernels import dictdecode as tdd
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import groupby_mxu as tgb
from repro_torch.kernels import radix_partition as trp
from repro_torch.kernels import segmented_merge as tsm
from repro_torch.kernels import ssd_scan as tss
from repro_torch.kernels import topk_similarity as ttk
from repro_torch.kernels import train_grad as ttg

SIZES = [1, 100, 1023, 8 * 128 * 3 + 17]
BOUNDS = [(-0.5, 0.5), (-np.inf, 0.25), (-0.25, np.inf), (np.inf, -np.inf)]
NP_DTYPES = {"int32": np.int32, "int64": np.int64, "float64": np.float64}


@pytest.fixture(autouse=True)
def _reference_installed(request):
    """Every test but the cuda-marked one compares with the JAX reference,
    which a GPU host may lack."""
    if jops is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("the JAX reference package is not installed")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scan_close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got[0] == want[0]                     # count
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12, atol=1e-9)
    # min, max exact; a NaN aggregate value makes both NaN on both sides
    np.testing.assert_array_equal(got[2:], want[2:])


def _filter_col(rng, n, nan_every=0):
    f = rng.normal(size=n)
    if nan_every:
        f[::nan_every] = np.nan         # NaN fails both bounds
    return f


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("agg_dtype", ["int32", "int64", "float64"])
@pytest.mark.parametrize("bounds", BOUNDS)
@pytest.mark.parametrize("nan", [0, 5])
def test_colscan_matches_reference(n, agg_dtype, bounds, nan):
    rng = np.random.default_rng(n * 7 + nan)
    f = _filter_col(rng, n, nan_every=nan)
    a = (rng.normal(size=n) * 100).astype(NP_DTYPES[agg_dtype])
    lo, hi = bounds
    with jax.enable_x64():
        want = np.asarray(jops.colscan(f, a, lo, hi, acc_dtype="float64"))
    got = tops.colscan(_t(f), _t(a), lo, hi)
    assert got.dtype == torch.float64 and got.shape == (4,)
    _scan_close(got.numpy(), want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("d", [3, 50, 4096])
@pytest.mark.parametrize("bounds", BOUNDS)
def test_fused_decode_scan_matches_reference(n, d, bounds):
    rng = np.random.default_rng(n + d)
    dic = np.sort(rng.normal(size=d))
    codes = rng.integers(0, d, n).astype(np.int32)
    a = rng.uniform(0, 1000, n)
    lo, hi = bounds
    with jax.enable_x64():
        want = np.asarray(jops.fused_decode_scan(codes, dic, a, lo, hi,
                                                 acc_dtype="float64"))
    got = tops.fused_decode_scan(_t(codes), _t(dic), _t(a), lo, hi)
    _scan_close(got.numpy(), want)


def test_fused_decode_scan_pad_code_fails_both_bounds():
    """Code d (one past the dictionary) reads NaN: excluded even under
    (-inf, inf), as the reference's padding is."""
    dic = np.array([1.0, 2.0, 3.0])
    codes = np.array([0, 3, 2, 3], np.int32)
    a = np.array([10.0, 20.0, 30.0, 40.0])
    got = tops.fused_decode_scan(_t(codes), _t(dic), _t(a), -np.inf, np.inf)
    assert got.tolist() == [2.0, 40.0, 10.0, 30.0]


def _codes_with_empty_groups(rng, n, g):
    """Codes over a strict subset of [0, g), so some groups are empty."""
    present = rng.choice(g, size=max(1, g // 2), replace=False)
    return present[rng.integers(0, len(present), n)].astype(np.int32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("g", [7, 50, 512])
@pytest.mark.parametrize("val_dtype", ["int32", "float64"])
def test_groupby_sum_matches_reference(n, g, val_dtype):
    rng = np.random.default_rng(n * 3 + g)
    codes = _codes_with_empty_groups(rng, n, g)
    vals = (rng.normal(size=n) * 50).astype(NP_DTYPES[val_dtype])
    with jax.enable_x64():
        want = np.asarray(jops.groupby_sum(codes, vals, g,
                                           acc_dtype="float64"))
    got = tops.groupby_sum(_t(codes), _t(vals), g).numpy()
    assert got.shape == (g, 2)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("g", [7, 50, 512])
def test_segmented_merge_matches_reference(n, g):
    rng = np.random.default_rng(n * 5 + g)
    codes = _codes_with_empty_groups(rng, n, g).astype(np.int64)
    vals = rng.normal(size=n) * 50
    with jax.enable_x64():
        want = np.asarray(jops.segmented_merge(codes, vals, g,
                                               acc_dtype="float64"))
    got = tops.segmented_merge(_t(codes), _t(vals), g).numpy()
    assert got.shape == (g, 4)
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-12, atol=1e-9)
    empty = got[:, 1] == 0
    assert empty.any()
    assert np.all(got[empty, 2] == np.inf) and np.all(got[empty, 3] == -np.inf)


@pytest.mark.parametrize("n", SIZES + [70001])
@pytest.mark.parametrize("b", [7, 32, 64])
def test_radix_partition_bit_identical(n, b):
    rng = np.random.default_rng(n + b)
    keys = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    ids_j, counts_j = jops.radix_partition(keys, num_buckets=b)
    ids_j, counts_j = np.asarray(ids_j), np.asarray(counts_j)
    ids_r, counts_r = radix_partition_ref(keys, b)
    for t in (_t(keys.view(np.int32)), _t(keys)):
        ids, counts = tops.radix_partition(t, b, with_counts=True)
        assert ids.dtype == torch.int32 and counts.dtype == torch.int32
        np.testing.assert_array_equal(ids.numpy(), ids_j)
        np.testing.assert_array_equal(ids.numpy(), ids_r)
        np.testing.assert_array_equal(counts.numpy(), counts_j)
        only, none = tops.radix_partition(t, b, with_counts=False)
        assert none is None
        np.testing.assert_array_equal(only.numpy(), ids_r)
    np.testing.assert_array_equal(trp.radix_partition_ref(keys, b)[0], ids_r)


def test_fold_keys_u32_torch_matches_numpy():
    from repro.kernels.radix_partition import fold_keys_u32 as jfold
    keys = np.random.default_rng(3).integers(-2 ** 62, 2 ** 62, 5000)
    want = jfold(keys)
    np.testing.assert_array_equal(trp.fold_keys_u32(keys), want)
    got = trp.fold_keys_u32(_t(keys))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# -- decode kernels (tests/test_kernels.py:29-62) ------------------------


def _pack(vals: np.ndarray, width: int) -> np.ndarray:
    per = 32 // width
    nw = -(-len(vals) // per)
    padded = np.zeros(nw * per, np.uint32)
    padded[:len(vals)] = vals
    words = np.zeros(nw, np.uint32)
    for j in range(per):
        words |= padded[j::per] << np.uint32(j * width)
    return words


@pytest.mark.parametrize("n,d", [(1, 3), (1000, 50), (8 * 128 * 2 + 5, 4096)])
@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64"])
def test_dict_decode_matches_reference(n, d, dtype):
    rng = np.random.default_rng(n + d)
    dic = (rng.normal(size=d) * 100).astype(dtype)
    codes = rng.integers(0, d, n).astype(np.int32)
    with jax.enable_x64():
        want = np.asarray(jops.dict_decode(codes, dic))
    got = tops.dict_decode(_t(codes), _t(dic))
    assert got.dtype == _t(dic).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_dict_decode_out_of_range_codes_follow_jnp_indexing():
    """Negative codes count from the end, then indices clamp."""
    from repro.kernels import ref as jref
    dic = np.arange(10, 20, dtype=np.int64)
    codes = np.array([5, -1, -5, 12, -30, 9, 10], np.int32)
    want = np.asarray(jref.dict_decode_ref(jax.numpy.asarray(codes),
                                           jax.numpy.asarray(dic)))
    np.testing.assert_array_equal(tops.dict_decode(_t(codes), _t(dic)).numpy(),
                                  want)


@pytest.mark.parametrize("width", range(1, 17))
@pytest.mark.parametrize("n", [1, 3000])
def test_bitpack_decode_matches_reference(width, n):
    rng = np.random.default_rng(width * 31 + n)
    vals = rng.integers(0, 1 << width, n).astype(np.uint32)
    words = _pack(vals, width)
    want = np.asarray(jops.bitpack_decode(words, width, -3, n))
    for w in (_t(words.view(np.int32)), _t(words.astype(np.int64))):
        got = tops.bitpack_decode(w, width, -3, n)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, vals.astype(np.int32) - 3)


@pytest.mark.parametrize("runs,n", [(1, 64), (5, 1000), (100, 8 * 128 * 2)])
@pytest.mark.parametrize("dtype", ["int64", "float32", "float64"])
def test_rle_decode_matches_reference(runs, n, dtype):
    rng = np.random.default_rng(runs + n)
    lens = np.maximum(1, rng.multinomial(n - runs, np.ones(runs) / runs) + 1)
    ends = np.cumsum(lens).astype(np.int32)
    vals = (rng.normal(size=runs) * 50).astype(dtype)
    total = int(ends[-1])
    with jax.enable_x64():
        want = np.asarray(jops.rle_decode(vals, ends, total))
        # positions past the last end clamp to the last run, as the TPU
        # kernel does
        past = np.asarray(jops.rle_decode(vals, ends, total + 7))
    np.testing.assert_array_equal(
        tops.rle_decode(_t(vals), _t(ends), total).numpy(), want)
    np.testing.assert_array_equal(
        tops.rle_decode(_t(vals), _t(ends), total + 7).numpy(), past)


@pytest.mark.parametrize("kind", ["ones", "one", "zeros", "past"])
@pytest.mark.parametrize("dst_dtype", [torch.float32, torch.float64,
                                       torch.int64])
def test_rle_decode_into_matches_reference_cast_into_a_column(kind,
                                                              dst_dtype):
    """rle_decode_into a strided column of a row-major matrix equals the
    reference's rle_decode cast to that column's dtype: runs of 1, one
    run, zero-length runs, and n past the last end (which clamps to the
    last run); the rest of the matrix untouched."""
    rng = np.random.default_rng(len(kind))
    n = 1500
    if kind == "ones":
        lens = np.ones(n, np.int64)
    elif kind == "one":
        lens = np.array([n])
    elif kind == "zeros":
        lens = rng.integers(0, 4, n)
        lens[-1] += max(0, n - lens.sum())
    else:
        lens = rng.integers(1, 9, 100)
    ends = np.cumsum(lens).astype(np.int32)
    vals = (rng.normal(size=len(lens)) * 50).astype(np.float64)
    with jax.enable_x64():
        want = np.asarray(jops.rle_decode(vals, ends, n))
    x = torch.full((n, 5), -1, dtype=dst_dtype)
    tops.rle_decode_into(_t(vals), _t(ends), n, x[:, 2])
    np.testing.assert_array_equal(x[:, 2].numpy(),
                                  torch.from_numpy(want).to(dst_dtype))
    assert bool((x[:, [0, 1, 3, 4]] == -1).all())


# -- topk_similarity and train_grad (tests/test_kernels_topk.py) ---------


def _topk_oracle(x, q, k):
    s = x.astype(np.float64) @ q.astype(np.float64)
    idx = np.argsort(-s, kind="stable")[: min(k, len(s))]
    return s[idx], idx


def _topk_both(x, q, k):
    """(reference, port) top-k of the same inputs."""
    with jax.enable_x64():
        want = jops.topk_similarity(x, q, k)
    got_s, got_i = tops.topk_similarity(_t(x), _t(q.astype(np.float64)), k)
    assert got_s.dtype == torch.float64 and got_i.dtype == torch.int64
    return want, (got_s.numpy(), got_i.numpy())


@pytest.mark.parametrize("n,d,k", [
    (1, 1, 1),
    (2048, 5, 1),
    (5000, 7, 10),
    (1024, 128, 128),
    (4096, 16, 200),
    (300, 3, 500),          # k > num_rows: trimmed to n
])
def test_topk_similarity_integer_ties_exact(n, d, k):
    """Integer-valued lanes: exact products, genuine ties, exact order."""
    rng = np.random.default_rng(n + d + k)
    x = rng.integers(-4, 5, size=(n, d)).astype(np.float64)
    q = rng.integers(-3, 4, size=d).astype(np.float64)
    (ws, wi), (gs, gi) = _topk_both(x, q, k)
    os_, oi = _topk_oracle(x, q, k)
    if n > 100:             # the sweep must actually contain ties
        assert len(np.unique(x @ q)) < n
    np.testing.assert_array_equal(gi, oi)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gs, os_)
    np.testing.assert_allclose(gs, ws, rtol=1e-12)


@pytest.mark.parametrize("n,d,k", [(3000, 12, 25), (777, 40, 33)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_topk_similarity_continuous(n, d, k, dtype):
    rng = np.random.default_rng(n * d)
    x = rng.normal(size=(n, d)).astype(dtype)
    q = rng.normal(size=d)
    (ws, wi), (gs, gi) = _topk_both(x, q, k)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gi, _topk_oracle(x, q, k)[1])
    np.testing.assert_allclose(gs, ws, rtol=1e-12)


def test_topk_similarity_all_tied():
    x = np.ones((512, 6))
    q = np.arange(6, dtype=np.float64)
    (ws, wi), (gs, gi) = _topk_both(x, q, 20)
    np.testing.assert_array_equal(gi, np.arange(20))
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, np.full(20, q.sum()))


@pytest.mark.parametrize("n", [255, 256, 257, 1023, 1024, 1025, 2048])
def test_topk_similarity_tile_boundaries(n):
    """n at the port's 256-row tiles and the reference's 1024-row tiles,
    and one off: padding never surfaces as a result."""
    rng = np.random.default_rng(n)
    x = rng.integers(-2, 3, size=(n, 4)).astype(np.float64)
    q = np.array([1.0, -1.0, 2.0, 0.5])
    (_, wi), (_, gi) = _topk_both(x, q, 64)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gi, _topk_oracle(x, q, 64)[1])
    assert gi.max() < n


def test_topk_similarity_nan_scores_rank_last():
    """NaN scores follow numpy's argsort: after every number, in row
    order; -0.0 ties with +0.0."""
    x = np.array([[np.nan], [1.0], [-0.0], [np.inf], [0.0], [np.nan],
                  [-np.inf]])
    q = np.array([1.0])
    s, i = tops.topk_similarity(_t(x), _t(q), 10)
    np.testing.assert_array_equal(i.numpy(), _topk_oracle(x, q, 10)[1])


def _lanes_both(x, q, k):
    """(reference over x, port's lanes entry over x's columns)."""
    with jax.enable_x64():
        want = jops.topk_similarity(x, q, k)
    lanes = [_t(np.ascontiguousarray(x[:, j])) for j in range(x.shape[1])]
    got_s, got_i = tops.topk_similarity_lanes(lanes, q, k)
    assert got_s.dtype == torch.float64 and got_i.dtype == torch.int64
    return want, (got_s.numpy(), got_i.numpy())


@pytest.mark.parametrize("case", ["ties", "continuous32", "continuous64",
                                  "all_tied", "k_past_n"])
def test_topk_similarity_lanes_matches_reference(case):
    """The lanes entry (its plain version here: the stacked lanes) against
    the reference kernel over the matrix: ids exact, scores to rtol 1e-12
    (exact against the float64 oracle on integer lanes)."""
    rng = np.random.default_rng(len(case))
    n, d, k = 3000, 12, 40
    if case == "ties":
        x = rng.integers(-4, 5, size=(n, d)).astype(np.float64)
        q = rng.integers(-3, 4, size=d).astype(np.float64)
    elif case == "all_tied":
        x, q = np.ones((777, 6), np.float32), np.arange(6, dtype=np.float64)
    elif case == "k_past_n":
        x = rng.integers(-2, 3, size=(300, 3)).astype(np.float64)
        q, k = np.array([1.0, -1.0, 0.5]), 500
    else:
        x = rng.normal(size=(n, d)).astype(
            np.float32 if case == "continuous32" else np.float64)
        q = rng.normal(size=d)
    (ws, wi), (gs, gi) = _lanes_both(x, q, k)
    os_, oi = _topk_oracle(x, q, k)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gi, oi)
    np.testing.assert_allclose(gs, ws, rtol=1e-12)
    if case in ("ties", "all_tied", "k_past_n"):
        np.testing.assert_array_equal(gs, os_)
    assert len(gi) == min(k, x.shape[0])


def test_topk_similarity_rejects_k_below_one():
    with pytest.raises(ValueError):
        tops.topk_similarity(_t(np.ones((3, 2))), _t(np.ones(2)), 0)


@pytest.mark.parametrize("kind", ["logistic", "linear"])
@pytest.mark.parametrize("n,d", [(1, 1), (4096, 24), (1023, 130)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_train_grad_matches_reference(kind, n, d, dtype):
    rng = np.random.default_rng(n + d)
    x = (rng.normal(size=(n, d)) * 3).astype(dtype)
    w = rng.normal(size=d).astype(dtype)
    y = (rng.uniform(size=n) < 0.5).astype(dtype)
    with jax.enable_x64():
        want = jops.train_grad(x, y, w, kind)
    got = tops.train_grad(_t(x), _t(y), _t(w), kind)
    assert got.dtype == torch.float64 and got.shape == (d,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_train_grad_stable_sigmoid_at_extremes():
    """Large |x . w| saturates without overflow or NaN."""
    x = np.array([[800.0], [-800.0], [0.0]])
    got = tops.train_grad(_t(x), _t(np.zeros(3)), _t(np.ones(1)),
                          "logistic").numpy()
    np.testing.assert_allclose(got, [800.0])


def test_train_grad_rejects_unknown_kind():
    with pytest.raises(ValueError):
        jops.train_grad(np.ones((4, 2)), np.ones(4), np.ones(2), "huber")
    with pytest.raises(ValueError):
        tops.train_grad(_t(np.ones((4, 2))), _t(np.ones(4)), _t(np.ones(2)),
                        "huber")


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain versions: no launch."""
    tops.reset_launch_counts()
    x = _t(np.arange(10.0))
    c = _t(np.arange(10, dtype=np.int32) % 3)
    tops.colscan(x, x, 0, 5)
    tops.fused_decode_scan(c, x[:3], x, 0, 5)
    tops.groupby_sum(c, x, 3)
    tops.segmented_merge(c, x, 3)
    tops.radix_partition(c, 4)
    tops.dict_decode(c, x)
    tops.bitpack_decode(c, 4, 0, 10)
    tops.rle_decode(x, c.cumsum(0).to(torch.int32) + 1, 10)
    tops.topk_similarity(x[:, None], x[:1], 3)
    tops.train_grad(x[:, None], x, x[:1])
    q = x.float().reshape(1, 1, 10, 1)
    tops.flash_attention_fwd(q, q, q)
    xs = x.float().reshape(1, 10, 1, 1)
    tops.ssd_scan(xs, xs[..., 0].abs(), -x[:1].float(), xs[..., 0],
                  xs[..., 0], 4)
    counts = tops.launch_counts()
    assert len(counts) == 12 and set(counts.values()) == {0}


def test_mixed_devices_raise():
    x = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError):
        tcolscan.colscan(x, x.to("meta"), 0, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1023, 93750])
def test_cuda_kernel_matches_plain(n):
    """Each CUDA kernel against its plain version on the card (exact
    counts, min, max and ids; sums to rtol 1e-12)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(n)
    f = _t(_filter_col(rng, n, nan_every=7))
    a = _t(rng.integers(0, 1000, n).astype(np.int32))
    for lo, hi in BOUNDS:
        _scan_close(tcolscan.colscan(f.cuda(), a.cuda(), lo, hi).cpu(),
                    tcolscan.colscan_plain(f, a, lo, hi))
    dic = _t(np.round(np.arange(11) * 0.01, 2))
    codes = _t(rng.integers(0, 11, n).astype(np.int32))
    _scan_close(tdd.fused_decode_scan(codes.cuda(), dic.cuda(), f.cuda(),
                                      0.05, 0.07).cpu(),
                tdd.fused_decode_scan_plain(codes, dic, f, 0.05, 0.07))
    for g in (7, 50, 512):
        c = _t(_codes_with_empty_groups(rng, n, g))
        v = _t(rng.normal(size=n))
        got = tgb.groupby_sum(c.cuda(), v.cuda(), g).cpu().numpy()
        want = tgb.groupby_sum_plain(c, v, g).numpy()
        np.testing.assert_array_equal(got[:, 1], want[:, 1])
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-12,
                                   atol=1e-9)
        got = tsm.segmented_merge(c.cuda(), v.cuda(), g).cpu().numpy()
        want = tsm.segmented_merge_plain(c, v, g).numpy()
        np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-12,
                                   atol=1e-9)
    keys = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    for b in (32, 64):
        ids, counts = trp.radix_partition(_t(keys.view(np.int32)).cuda(), b)
        want_ids, want_counts = trp.radix_partition_ref(keys, b)
        np.testing.assert_array_equal(ids.cpu().numpy(), want_ids)
        np.testing.assert_array_equal(counts.cpu().numpy(), want_counts)
        only, none = trp.radix_partition(_t(keys.view(np.int32)).cuda(), b,
                                         with_counts=False)
        assert none is None
        np.testing.assert_array_equal(only.cpu().numpy(), want_ids)
    # decode kernels: exact against their plain versions
    for dt in ("int32", "int64", "float32", "float64"):
        for d in (3, 4096):
            dic = _t((rng.normal(size=d) * 100).astype(dt))
            c = _t(rng.integers(-2, d + 2, n).astype(np.int32))
            assert torch.equal(tdd.dict_decode(c.cuda(), dic.cuda()).cpu(),
                               tdd.dict_decode_plain(c, dic))
    for width in range(1, 17):
        vals = rng.integers(0, 1 << width, n).astype(np.uint32)
        words = _t(_pack(vals, width).view(np.int32))
        assert torch.equal(tdd.bitpack_decode(words.cuda(), width, -3,
                                              n).cpu(),
                           tdd.bitpack_decode_plain(words, width, -3, n))
    for runs in (1, max(1, n // 5)):
        lens = rng.integers(1, 9, runs)
        ends = _t(np.cumsum(lens).astype(np.int32))
        vals = _t(rng.normal(size=runs))
        total = int(ends[-1])
        assert torch.equal(tdd.rle_decode(vals.cuda(), ends.cuda(),
                                          total).cpu(),
                           tdd.rle_decode_plain(vals, ends, total))
    # topk_similarity: ids and order exact, scores bitwise (same lane order)
    for x in (rng.integers(-3, 4, size=(n, 5)).astype(np.float64),
              rng.normal(size=(n, 64)).astype(np.float32)):
        q = _t(rng.normal(size=x.shape[1]))
        for k in (1, 100, n + 5):
            gs, gi = ttk.topk_similarity(_t(x).cuda(), q.cuda(), k)
            ps, pi = ttk.topk_similarity_plain(_t(x), q, k)
            assert torch.equal(gi.cpu(), pi) and torch.equal(gs.cpu(), ps)
    # train_grad: gradient sums to rtol 1e-12
    for dt in ("float32", "float64"):
        for d in (1, 12, 130):
            x = _t(rng.normal(size=(n, d)).astype(dt))
            y = _t((rng.uniform(size=n) < 0.5).astype(dt))
            w = _t(rng.normal(size=d).astype(dt))
            for kind in ttg.KINDS:
                got = ttg.train_grad(x.cuda(), y.cuda(), w.cuda(), kind)
                np.testing.assert_allclose(
                    got.cpu().numpy(),
                    ttg.train_grad_plain(x, y, w, kind).numpy(),
                    rtol=1e-12, atol=1e-9)
    # flash attention: rel max err < 0.03 in bf16, < 1e-4 in float32, at
    # a ragged S and hd 112 and 64, in the model's (B, S, H, hd) layout
    s = min(n, 1000)
    for dt, hd in ((torch.bfloat16, 112), (torch.float32, 112),
                   (torch.bfloat16, 64), (torch.float32, 128)):
        q, k, v = (_t(rng.normal(size=(2, s, 3, hd))).to(dt).cuda()
                   .transpose(1, 2) for _ in range(3))
        for causal in (True, False):
            got = tfa.flash_attention_fwd(q, k, v, causal).float()
            want = tfa.flash_attention_fwd_plain(q, k, v, causal).float()
            rel = float((got - want).abs().max() / want.abs().max())
            assert rel < (0.03 if dt == torch.bfloat16 else 1e-4), rel
    # SSD scan: y and the final state to rtol = atol = 1e-3 (a bf16 y also
    # one bf16 rounding step, as both sides round it once), ragged S
    for dt, p, nst in ((torch.bfloat16, 112, 64), (torch.float32, 112, 64),
                       (torch.float32, 64, 128)):
        h = 4
        x = _t(rng.normal(size=(2, s, h, p))).to(dt).cuda()
        dts = torch.nn.functional.softplus(
            _t(rng.normal(size=(2, s, h))).float()).cuda()
        a = -torch.exp(_t(rng.normal(size=h)).float()).cuda()
        bm, cm = (_t(rng.normal(size=(2, s, nst))).to(dt).cuda()
                  for _ in range(2))
        d = _t(rng.normal(size=h)).float().cuda()
        y, st = tss.ssd_scan(x, dts, a, bm, cm, 256, d=d)
        yp, sp = tss.ssd_scan_plain(x, dts, a, bm, cm, 256, d=d)
        rtol = 1e-3 + (2.0 ** -7 if dt == torch.bfloat16 else 0.0)
        y, yp = y.float().cpu(), yp.float().cpu()
        assert bool(((y - yp).abs() <= 1e-3 + rtol * yp.abs()).all())
        np.testing.assert_allclose(st.cpu().numpy(), sp.cpu().numpy(),
                                   rtol=1e-3, atol=1e-3)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _flash_inputs(rng, b, s, h, hd, dt, layout):
    """q, k, v on the card as (B, H, S, hd): the model's (B, S, H, hd)
    tensors through `.transpose(1, 2)`, or dense (B, H, S, hd)."""
    shape = (b, s, h, hd) if layout == "model" else (b, h, s, hd)
    out = []
    for _ in range(3):
        x = _t(rng.normal(size=shape)).to(dt).cuda()
        out.append(x.transpose(1, 2) if layout == "model" else x)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("s", [1, 63, 65, 1000, 2048])
@pytest.mark.parametrize("hd", [64, 112, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_routes_match_plain(dtype, s, hd, causal):
    """Both flash routes against the plain version on the card: rel max
    error < 0.03 in bfloat16 (the tensor-core route rounds P to bfloat16),
    < 1e-4 in float32, in the model's strided layout and dense; every bf16
    call takes the tensor-core route, every float32 call the SIMT one."""
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(s * 7 + hd)
    for layout in ("model", "dense"):
        q, k, v = _flash_inputs(rng, 2, s, 3, hd, dt, layout)
        before = dict(tfa.ROUTES)
        got = tfa.flash_attention_fwd(q, k, v, causal)
        route = "tensor_core" if dt == torch.bfloat16 else "simt"
        assert tfa.ROUTES[route] == before[route] + 1
        assert got.shape == q.shape and got.stride() == q.stride()
        got = got.float()
        want = tfa.flash_attention_fwd_plain(q, k, v, causal).float()
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel < (0.03 if dt == torch.bfloat16 else 1e-4), (layout, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,h,n_kv,s,t,hd", [
    (2, 8, 2, 256, 201, 128),        # Llama-3.2-Vision's groups, ragged T
    (1, 8, 2, 125, 201, 128),
    (2, 4, 4, 188, 188, 64),         # Whisper's encoder, S == T
    (2, 4, 4, 8, 188, 64),           # Whisper's decoder against frames
    (1, 4, 2, 300, 65, 64),          # S > T, one valid column in a tile
])
def test_cuda_flash_cross_shapes_match_plain(dtype, b, h, n_kv, s, t, hd):
    """Kernel 11 non-causal at S != T and ragged T (cross-attention, the
    vlm and encdec families), both routes, against its plain version on
    the card (chip_smoke.py phase 1's shapes, smaller), each kv head's
    values offset apart: rel max error < 0.03 in bf16 (tensor-core route),
    < 1e-4 in float32 (SIMT)."""
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(s * 3 + t)
    off = 3.0 * np.arange(n_kv)[None, None, :, None]

    def card(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dt).cuda() \
            .transpose(1, 2)

    q = card(rng.normal(size=(b, s, h, hd)))
    k = card(rng.normal(size=(b, t, n_kv, hd)))
    v = card(rng.normal(size=(b, t, n_kv, hd)) + off)
    before = dict(tfa.ROUTES)
    got = tfa.flash_attention_fwd(q, k, v, False)
    route = "tensor_core" if dt == torch.bfloat16 else "simt"
    assert tfa.ROUTES[route] == before[route] + 1
    got = got.float()
    want = tfa.flash_attention_fwd_plain(q, k, v, False).float()
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < (0.03 if dt == torch.bfloat16 else 1e-4), rel


@pytest.mark.cuda
def test_cuda_flash_bf16_odd_head_dim_takes_simt():
    _cuda_or_skip()
    rng = np.random.default_rng(3)
    q, k, v = _flash_inputs(rng, 2, 100, 3, 36 + 2, torch.bfloat16, "model")
    before = tfa.ROUTES["simt"]
    got = tfa.flash_attention_fwd(q, k, v).float()
    assert tfa.ROUTES["simt"] == before + 1
    want = tfa.flash_attention_fwd_plain(q, k, v).float()
    assert float((got - want).abs().max() / want.abs().max()) < 0.03


@pytest.mark.cuda
def test_cuda_flash_raises_on_what_its_routes_cannot_take():
    """hd > 128, a sequence stride that is no multiple of 8 elements and a
    base that is not 16-byte aligned raise on the tensor-core route; the
    wrapper never copies."""
    _cuda_or_skip()
    x = torch.zeros(1, 2, 64, 136, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(x, x, x)                 # hd 136 > 128
    wide = torch.zeros(1, 64, 2 * 64 + 4, dtype=torch.bfloat16,
                       device="cuda")
    odd = wide.as_strided((1, 2, 64, 64), (64 * 132, 64, 132, 1))
    with pytest.raises(ValueError, match="stride"):
        tfa.flash_attention_fwd(odd, odd, odd)           # row stride 132
    flat = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16, device="cuda")
    shifted = flat[1:].view(1, 2, 64, 64)
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_attention_fwd(shifted, shifted, shifted)


def _gqa_inputs(rng, b, s, h, n_kv, hd, dt):
    """q (B, H, S, hd) and k, v (B, KV, S, hd) on the card in the model's
    layout, each kv head's values offset from the others' (k by 0.5, v by
    3 a head), so that a query head reading a wrong kv head cannot pass."""
    q = _t(rng.normal(size=(b, s, h, hd))).to(dt).cuda().transpose(1, 2)
    k = _t(rng.normal(size=(b, s, n_kv, hd))
           + 0.5 * np.arange(n_kv)[:, None]).to(dt).cuda().transpose(1, 2)
    v = _t(rng.normal(size=(b, s, n_kv, hd))
           + 3.0 * np.arange(n_kv)[:, None]).to(dt).cuda().transpose(1, 2)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("g", [1, 4, 8, 12])
@pytest.mark.parametrize("s", [65, 1000, 2048])
@pytest.mark.parametrize("hd", [64, 128])
def test_cuda_flash_gqa_routes_match_plain(dtype, g, s, hd):
    """Grouped-query attention on both routes: q with 2g heads over k and
    v with 2 kv heads, causal and not, against the plain version (rel max
    error < 0.03 in bfloat16, < 1e-4 in float32); the output in q's
    layout; one kernel a call, k and v never repeated."""
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(g * 100 + s + hd)
    q, k, v = _gqa_inputs(rng, 2, s, 2 * g, 2, hd, dt)
    route = "tensor_core" if dt == torch.bfloat16 else "simt"
    for causal in (True, False):
        before = dict(tfa.ROUTES)
        got = tfa.flash_attention_fwd(q, k, v, causal)
        assert tfa.ROUTES[route] == before[route] + 1
        assert got.shape == q.shape and got.stride() == q.stride()
        want = tfa.flash_attention_fwd_plain(q, k, v, causal).float()
        rel = float((got.float() - want).abs().max() / want.abs().max())
        assert rel < (0.03 if dt == torch.bfloat16 else 1e-4), (causal, rel)
    assert graph_nodes(lambda: tfa.flash_attention_fwd(q, k, v)) \
        == {"kernel": 1}


# csrc/flash.cu's kv-head indexing, and the query-head indexing of the MHA
# kernel it replaced: with them swapped back, the source computes what the
# kernel computed before it took KV heads
MHA_INDEXING = (
    ("const T* kp = k + b * ks.b + kvh * ks.h;",
     "const T* kp = k + b * ks.b + h * ks.h;", 1),
    ("const T* vp = v + b * vs.b + kvh * vs.h;",
     "const T* vp = v + b * vs.b + h * vs.h;", 1),
    ("kt * kTcBK, kvh, b);", "kt * kTcBK, h, b);", 2),
    ("encode_operand(&km, &kc, k, b, kv, t,",
     "encode_operand(&km, &kc, k, b, h, t,", 1),
    ("encode_operand(&vm, &vc, v, b, kv, t,",
     "encode_operand(&vm, &vc, v, b, h, t,", 1),
    ("!tma_ok(k, ks, b, kv, t) || !tma_ok(v, vs, b, kv, t)",
     "!tma_ok(k, ks, b, h, t) || !tma_ok(v, vs, b, h, t)", 1),
)


def _mha_flash_library():
    """csrc/flash.cu with MHA_INDEXING swapped back, built with the
    package's nvcc flags beside the kernels; its entry point bound with
    the same signature."""
    import ctypes
    import subprocess
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash.cu").read_text()
    for gqa, mha, count in MHA_INDEXING:
        assert src.count(gqa) == count, (
            f"csrc/flash.cu changed: {gqa!r} not found {count} times; "
            f"update MHA_INDEXING")
        src = src.replace(gqa, mha)
    out = _build.build_dir()
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "test_flash_mha.cu", out / "test_flash_mha.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(so)), _build.SIGNATURES["flash"][0])
    fn.argtypes, fn.restype = _build.SIGNATURES["flash"][1], ctypes.c_int
    return fn


@pytest.mark.cuda
def test_cuda_flash_mha_is_bit_identical_to_the_mha_kernel():
    """KV == H: the GQA kernel gives the same bits as the kernel with
    query-head indexing (MHA_INDEXING) at Zamba2-7B's prefill shape (4,
    32, 2048, 112) in bfloat16 on the tensor-core route, and at a ragged
    float32 shape on the SIMT route, both in the model's layout."""
    from repro_torch.kernels import _build
    _cuda_or_skip()
    mha = _mha_flash_library()
    rng = np.random.default_rng(11)
    for (b, h, s, hd), dt in (((4, 32, 2048, 112), torch.bfloat16),
                              ((2, 8, 1000, 112), torch.float32)):
        q, k, v = _flash_inputs(rng, b, s, h, hd, dt, "model")
        got = tfa.flash_attention_fwd(q, k, v)
        want = torch.empty_like(q)
        route = tfa._ROUTE_CODES[tfa.flash_route(dt, hd)]
        rc = mha(q.data_ptr(), k.data_ptr(), v.data_ptr(), want.data_ptr(),
                 None, _build.dtype_code(q), route, b, h, h, s, s, hd, 1,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *want.stride()[:3], _build.stream_handle(q.device))
        assert rc == 0
        torch.cuda.synchronize()
        assert torch.equal(got, want), (b, h, s, hd, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 7, 50, 1024])
@pytest.mark.parametrize("code_dtype", ["int32", "int64"])
@pytest.mark.parametrize("n", [1, 93750, 10 ** 6])
def test_cuda_group_kernels_one_launch_match_plain(g, code_dtype, n):
    """groupby_sum and segmented_merge on the card at the main path's
    partition (93,750 rows: one 16-block cluster) and past one cluster
    (10**6 rows: the ticket fold), ids out of range and NaN values
    included: counts, min and max exact and identical on two calls, sums
    to rtol 1e-12."""
    _cuda_or_skip()
    rng = np.random.default_rng(g * 31 + n)
    codes = rng.integers(-2, g + 2, n).astype(NP_DTYPES[code_dtype])
    vals = rng.normal(size=n) * 50
    vals[::97] = np.nan
    c, v = _t(codes), _t(vals)
    finite = _t(np.nan_to_num(vals))
    got = tgb.groupby_sum(c.cuda(), finite.cuda(), g).cpu().numpy()
    again = tgb.groupby_sum(c.cuda(), finite.cuda(), g).cpu().numpy()
    want = tgb.groupby_sum_plain(c, finite, g).numpy()
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_array_equal(got[:, 1], again[:, 1])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-12, atol=1e-9)
    got = tsm.segmented_merge(c.cuda(), v.cuda(), g).cpu().numpy()
    again = tsm.segmented_merge(c.cuda(), v.cuda(), g).cpu().numpy()
    want = tsm.segmented_merge_plain(c, v, g).numpy()
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
    np.testing.assert_array_equal(got[:, 1:], again[:, 1:])
    sums = ~np.isnan(want[:, 0])
    np.testing.assert_allclose(got[sums, 0], want[sums, 0], rtol=1e-12,
                               atol=1e-9)
    assert np.array_equal(np.isnan(got[:, 0]), ~sums)


def _ssd_inputs_cuda(rng, b, s, h, p, n, dtype=torch.bfloat16):
    """x, B, C as the model hands them (slices of one conv output, no
    copy), dt after softplus, a < 0 and D, on the card."""
    xbc = _t(rng.normal(size=(b, s, h * p + 2 * n))).to(dtype).cuda()
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.nn.functional.softplus(
        _t(rng.normal(size=(b, s, h))).float()).cuda()
    a = -torch.exp(_t(rng.normal(size=h)).float()).cuda()
    d = _t(rng.normal(size=h)).float().cuda()
    return x, dt, a, bm, cm, d


def _ssd_within_tolerance(y, st, yp, sp, dtype):
    """chip_smoke.py's SSD tolerance: y to atol 1e-3 and rtol 1e-3 (plus
    one bf16 step for a bf16 y, which both sides round once), the final
    state to rtol = atol = 1e-3."""
    rtol = 1e-3 + (2.0 ** -7 if dtype == torch.bfloat16 else 0.0)
    y, yp = y.float().cpu(), yp.float().cpu()
    assert bool(torch.isfinite(y).all())
    over_y = float(((y - yp).abs() - 1e-3 - rtol * yp.abs()).max())
    over_s = float(((st.cpu() - sp.cpu()).abs() - 1e-3
                    - 1e-3 * sp.cpu().abs()).max())
    assert over_y <= 0 and over_s <= 0, (over_y, over_s)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 63, 1000, 2048])
@pytest.mark.parametrize("p,n", [(112, 64), (64, 128)])
@pytest.mark.parametrize("with_d", [True, False])
def test_cuda_ssd_tensor_core_route_matches_plain(s, p, n, with_d):
    """The bf16 tensor-core SSD route against the plain version on the
    card at ragged S, at Zamba2-7B's and Mamba2-370m's head geometry, with
    and without the fused D skip: one launch on the tensor-core route, y
    in bf16 in (B, S, H, P), the state float32 in (B, H, P, N)."""
    _cuda_or_skip()
    rng = np.random.default_rng(s * 31 + p + n)
    x, dt, a, bm, cm, d = _ssd_inputs_cuda(rng, 2, s, 6, p, n)
    d = d if with_d else None
    before, launches = dict(tss.ROUTES), tss.LAUNCHES["ssd_scan"]
    y, st = tss.ssd_scan(x, dt, a, bm, cm, 256, d=d)
    assert tss.ROUTES["tensor_core"] == before["tensor_core"] + 1
    assert tss.ROUTES["simt"] == before["simt"]
    assert tss.LAUNCHES["ssd_scan"] == launches + 1
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert y.is_contiguous()
    assert st.dtype == torch.float32 and st.shape == (2, 6, p, n)
    yp, sp = tss.ssd_scan_plain(x, dt, a, bm, cm, 256, d=d)
    _ssd_within_tolerance(y, st, yp, sp, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_ssd_one_device_kernel_per_call(dtype):
    """One ssd_scan call is one device kernel on either route: no float32
    y, no D-skip or cast pass in the wrapper."""
    _cuda_or_skip()
    rng = np.random.default_rng(5)
    x, dt, a, bm, cm, d = _ssd_inputs_cuda(rng, 2, 300, 4, 112, 64,
                                           getattr(torch, dtype))
    route = "tensor_core" if dtype == "bfloat16" else "simt"
    before = tss.ROUTES[route]
    assert graph_nodes(
        lambda: tss.ssd_scan(x, dt, a, bm, cm, 256, d=d)) == {"kernel": 1}
    assert tss.ROUTES[route] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,p,n", [("bfloat16", 16, 16),
                                       ("bfloat16", 64, 128),
                                       ("float32", 64, 128)])
def test_cuda_ssd_two_groups_match_plain(dtype, p, n):
    """ngroups = 2: b and c (B, S, 2, N), views of one conv output as the
    model hands them, run one launch a group on the group's heads and match
    `ssd_chunked` with two groups."""
    _cuda_or_skip()
    rng = np.random.default_rng(p + n)
    g, h, s = 2, 6, 300
    xbc = _t(rng.normal(size=(2, s, h * p + 2 * g * n))).to(
        getattr(torch, dtype)).cuda()
    x = xbc[..., :h * p].reshape(2, s, h, p)
    bm = xbc[..., h * p:h * p + g * n].unflatten(-1, (g, n))
    cm = xbc[..., h * p + g * n:].unflatten(-1, (g, n))
    dt = torch.nn.functional.softplus(
        _t(rng.normal(size=(2, s, h))).float()).cuda()
    a = -torch.exp(_t(rng.normal(size=h)).float()).cuda()
    d = _t(rng.normal(size=h)).float().cuda()
    route = "tensor_core" if dtype == "bfloat16" else "simt"
    before, launches = tss.ROUTES[route], tss.LAUNCHES["ssd_scan"]
    y, st = tss.ssd_scan(x, dt, a, bm, cm, 256, d=d)
    assert tss.LAUNCHES["ssd_scan"] == launches + g
    assert tss.ROUTES[route] == before + g
    assert y.shape == x.shape and st.shape == (2, h, p, n)
    yp, sp = tss.ssd_scan_plain(x, dt, a, bm, cm, 256, d=d)
    _ssd_within_tolerance(y, st, yp, sp, getattr(torch, dtype))


@pytest.mark.cuda
def test_cuda_dict_decode_one_device_kernel_per_call():
    _cuda_or_skip()
    codes = torch.arange(156_250, dtype=torch.int32, device="cuda") % 4000
    dic = torch.arange(4000, dtype=torch.float64, device="cuda")
    assert graph_nodes(lambda: tdd.dict_decode(codes, dic)) == {"kernel": 1}


@pytest.mark.cuda
def test_cuda_ssd_raises_on_what_the_tensor_core_route_cannot_take():
    """An unaligned base or a sequence stride off 8 elements raises on the
    tensor-core route; the wrapper never copies nor switches routes."""
    _cuda_or_skip()
    rng = np.random.default_rng(6)
    x, dt, a, bm, cm, d = _ssd_inputs_cuda(rng, 1, 64, 2, 112, 64)
    before = dict(tss.ROUTES)
    flat = torch.zeros(64 * 64 + 1, dtype=torch.bfloat16, device="cuda")
    shifted = flat[1:].view(1, 64, 64)
    with pytest.raises(ValueError, match="aligned"):
        tss.ssd_scan(x, dt, a, shifted, cm, 256, d=d)
    wide = torch.zeros(1, 64, 68, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="stride"):
        tss.ssd_scan(x, dt, a, wide[..., :64], cm, 256, d=d)
    assert tss.ROUTES == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4097, 156_250])
@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64"])
def test_cuda_dict_decode_exact(n, dtype):
    """dict_decode on the card equals its plain version exactly: negative
    and out-of-range codes (jnp's rule), each table dtype, codes seen
    through a view that does not start on 16 bytes, and both staging plans
    (a small dictionary staged in shared memory, a large one read through
    the read-only path)."""
    _cuda_or_skip()
    rng = np.random.default_rng(n + len(dtype))
    for d in (1, 11, 4000):
        dic = _t((rng.normal(size=d) * 1000).astype(dtype)).cuda()
        plan = tdd.decode_plan(n, d, dic.element_size())
        assert plan.staged == (d <= -(-n // plan.blocks))
        raw = _t(rng.integers(-d - 3, d + 3, n + 3).astype(np.int32)).cuda()
        for off in (0, 1, 2, 3):       # 16-byte aligned, then not
            codes = raw[off:off + n]
            got = tdd.dict_decode(codes, dic)
            assert got.dtype == dic.dtype and got.shape == (n,)
            assert torch.equal(got.cpu(), tdd.dict_decode_plain(
                codes.cpu(), dic.cpu()))


@pytest.mark.cuda
def test_cuda_decode_rejects_what_the_c_side_checks():
    """An empty dictionary reaches decode.cu, whose error code raises."""
    _cuda_or_skip()
    codes = torch.zeros(5, dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="dict_decode"):
        tdd.dict_decode(codes, torch.zeros(0, device="cuda"))


def _train_inputs_cuda(rng, n, d, dtype, offset=0):
    """x (n, d) on the card, starting `offset` elements into its buffer (an
    offset of 1 leaves its rows off 16 bytes: the scalar loads), y and w."""
    flat = _t((rng.normal(size=n * d + offset) * 2).astype(dtype)).cuda()
    x = flat[offset:].view(n, d)
    y = _t((rng.uniform(size=n) < 0.5).astype(dtype)).cuda()
    w = _t(rng.normal(size=d).astype(dtype)).cuda()
    return x, y, w


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 5, 12, 16, 31, 32, 33, 64, 130])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_train_grad_routes_match_plain_and_repeat(d, dtype):
    """Both routes (registers for d <= 32, padded to 4..32 columns; chunked
    above) against the plain version to rtol 1e-12, with 16-byte and
    scalar row loads; two calls give the same bits (the fold's order is a
    function of n and d)."""
    _cuda_or_skip()
    rng = np.random.default_rng(d)
    route = ttg.train_plan(1, d, getattr(torch, dtype)).route
    assert route == ("registers" if d <= 32 else "chunked")
    for n in (1, 511, 1023, 156_250):
        for offset in (0, 1):
            x, y, w = _train_inputs_cuda(rng, n, d, dtype, offset)
            for kind in ttg.KINDS:
                before = ttg.ROUTES[route]
                got = ttg.train_grad(x, y, w, kind)
                assert ttg.ROUTES[route] == before + 1
                again = ttg.train_grad(x, y, w, kind)
                assert torch.equal(got, again)
                assert got.dtype == torch.float64 and got.shape == (d,)
                np.testing.assert_allclose(
                    got.cpu().numpy(),
                    ttg.train_grad_plain(x, y, w, kind).cpu().numpy(),
                    rtol=1e-12, atol=1e-9)


@pytest.mark.cuda
def test_cuda_train_grad_widest_rows():
    """d = 2048, the chunked route's most columns, at a ragged n."""
    _cuda_or_skip()
    rng = np.random.default_rng(2048)
    x, y, w = _train_inputs_cuda(rng, 1023, 2048, "float64")
    got = ttg.train_grad(x, y, w, "logistic")
    assert torch.equal(got, ttg.train_grad(x, y, w, "logistic"))
    np.testing.assert_allclose(
        got.cpu().numpy(), ttg.train_grad_plain(x, y, w).cpu().numpy(),
        rtol=1e-12, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [12, 64])
def test_cuda_train_grad_one_device_kernel_per_call(d):
    """One call is one kernel node: the fold runs in the same launch, and
    the ticket needs no memset."""
    _cuda_or_skip()
    x, y, w = _train_inputs_cuda(np.random.default_rng(7), 156_250, d,
                                 "float32")
    assert graph_nodes(lambda: ttg.train_grad(x, y, w)) == {"kernel": 1}


@pytest.mark.cuda
def test_cuda_train_grad_streams_keep_their_own_tickets():
    """Calls on two streams fold with two tickets and give the default
    stream's bits."""
    _cuda_or_skip()
    x, y, w = _train_inputs_cuda(np.random.default_rng(8), 156_250, 12,
                                 "float32")
    want = ttg.train_grad(x, y, w)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [ttg.train_grad(x, y, w) for _ in range(3)]
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(g, want) for g in got)
    dev = x.device
    assert ttg._ticket(dev, side.cuda_stream).data_ptr() != ttg._ticket(
        dev, torch.cuda.current_stream().cuda_stream).data_ptr()


def _bitpack_encs(rng, n, widths):
    """BITPACK blocks of n rows at the given widths: int64 columns with
    biases outside int32 (either sign), int32 columns with a negative
    bias."""
    from repro_torch.core.compression import Encoding, encode
    encs = []
    for j, width in enumerate(widths):
        if j % 2:
            lo = -(2 ** 40) if j % 4 == 1 else 2 ** 35 + 7
            dt = np.int64
        else:
            lo, dt = -(1 << (width - 1)) - 3, np.int32
        vals = (lo + rng.integers(0, 1 << width, n)).astype(dt)
        vals[:2] = [lo + (1 << width) - 1, lo][:n]     # the full width
        enc = encode(vals, Encoding.BITPACK)
        assert n == 1 or (enc.bit_width == width and enc.bias == lo)
        encs.append(enc)
    return encs


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1023, 156_251])
@pytest.mark.parametrize("out", ["float32", "float64"])
def test_cuda_bitpack_batch_equals_per_column_sequence(n, out):
    """One batched call over widths 1..16 and a label, into the columns of
    a row-major x and into y, equals `decode_torch(enc).to(dt)` per column
    (on the card, and the plain version's on the CPU) bit for bit."""
    from repro_torch.core.compression import bitpack_block, decode_torch
    _cuda_or_skip()
    rng = np.random.default_rng(n)
    dt = getattr(torch, out)
    encs = _bitpack_encs(rng, n, list(range(1, 17)) + [1])
    d = 16
    buf = torch.full((n * (d + 1),), -1, dtype=dt, device="cuda")
    x, y = buf[:n * d].view(n, d), buf[n * d:]
    dests = [x[:, j] for j in range(d)] + [y]
    launches = tdd.LAUNCHES["bitpack_decode"]
    tdd.bitpack_decode_into([bitpack_block(e, "cuda") for e in encs], dests,
                            n)
    assert tdd.LAUNCHES["bitpack_decode"] == launches + 1
    for e, dst in zip(encs, dests):
        want = decode_torch(e, "cuda").to(dt)
        assert torch.equal(dst, want)
        assert torch.equal(dst.cpu(), decode_torch(e, "cpu").to(dt))


@pytest.mark.cuda
def test_cuda_bitpack_batch_past_one_launch_takes_two():
    """40 blocks, past one launch's 32 descriptors: two launches, and every
    column equals `decode_torch(enc).to(dt)`."""
    from repro_torch.core.compression import bitpack_block, decode_torch
    _cuda_or_skip()
    n, k = 5003, 40
    encs = _bitpack_encs(np.random.default_rng(40), n,
                         [1 + j % 16 for j in range(k)])
    x = torch.full((n, k), -1.0, dtype=torch.float64, device="cuda")
    launches = tdd.LAUNCHES["bitpack_decode"]
    tdd.bitpack_decode_into([bitpack_block(e, "cuda") for e in encs],
                            [x[:, j] for j in range(k)], n)
    assert tdd.LAUNCHES["bitpack_decode"] == launches + 2
    for j, e in enumerate(encs):
        assert torch.equal(x[:, j], decode_torch(e, "cuda").double()), j


@pytest.mark.cuda
def test_cuda_bitpack_batch_one_device_kernel_per_call():
    """Phase 3's partition (8 BITPACK features of 1-4 bits and a 1-bit
    label, 156,250 rows, float32 x of 12 columns): one kernel node."""
    from repro_torch.core.compression import bitpack_block
    _cuda_or_skip()
    n = 156_250
    encs = _bitpack_encs(np.random.default_rng(3), n,
                         [1, 2, 2, 3, 3, 4, 4, 4, 1])
    blocks = [bitpack_block(e, "cuda") for e in encs]
    buf = torch.empty(n * 13, dtype=torch.float32, device="cuda")
    x, y = buf[:n * 12].view(n, 12), buf[n * 12:]
    dests = [x[:, j] for j in range(8)] + [y]
    assert graph_nodes(
        lambda: tdd.bitpack_decode_into(blocks, dests, n)) == {"kernel": 1}


@pytest.mark.cuda
def test_cuda_bitpack_one_column_api_keeps_its_contract():
    """bitpack_decode(words, width, bias, n): int32 lanes plus an int32
    bias, every width, through the batched entry."""
    _cuda_or_skip()
    rng = np.random.default_rng(9)
    for width in range(1, 17):
        for n in (1, 1000, 156_250):
            vals = rng.integers(0, 1 << width, n).astype(np.uint32)
            words = _t(_pack(vals, width).view(np.int32))
            got = tdd.bitpack_decode(words.cuda(), width, -2 ** 31 + 5, n)
            assert got.dtype == torch.int32
            assert torch.equal(got.cpu(), tdd.bitpack_decode_plain(
                words, width, -2 ** 31 + 5, n))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "uint16",
                                   "uint32", "uint64"])
def test_cuda_bitpack_narrow_and_unsigned_blocks(dtype):
    """Blocks of every other integer dtype: decode_torch on the card and a
    batched call into float32 equal the CPU's per-column decode."""
    from repro_torch.core.compression import (Encoding, bitpack_block,
                                              decode_torch, encode)
    _cuda_or_skip()
    info = np.iinfo(dtype)
    lo = max(int(info.min), -1000) if info.min < 0 else 7
    vals = (lo + np.random.default_rng(4).integers(0, 300, 5001)).astype(
        dtype)
    enc = encode(vals, Encoding.BITPACK)
    got = decode_torch(enc, "cuda")
    assert got.dtype == torch.from_numpy(vals).dtype
    assert torch.equal(got.cpu(), decode_torch(enc, "cpu"))
    out = torch.empty(5001, dtype=torch.float32, device="cuda")
    tdd.bitpack_decode_into([bitpack_block(enc, "cuda")], [out], 5001)
    assert torch.equal(out.cpu(), decode_torch(enc, "cpu").to(torch.float32))


# -- topk_similarity's fused route and lanes entry, RLE into a column ----


def _topk_call(x, q, k, fold=None):
    """topk_similarity on the card, on the plan's route and, when given,
    the fold variant `fold`."""
    if fold is None:
        return ttk.topk_similarity(x, q, k)
    n, d = x.shape
    plan = ttk.topk_plan(n, d, k, x.dtype)._replace(fold=fold)
    return ttk._launch(plan, x.data_ptr(), None, _build_code(x),
                       q.data_ptr(), n, d, k, x.device)


def _build_code(t):
    from repro_torch.kernels import _build
    return _build.dtype_code(t)


def _topk_cases(rng, n):
    """Integer lanes with ties (float64), continuous float32 lanes at the
    search path's width, and all rows tied."""
    return (rng.integers(-3, 4, size=(n, 5)).astype(np.float64),
            rng.normal(size=(n, 64)).astype(np.float32),
            np.ones((n, 6), np.float32))


def _bitwise(got, want):
    gs, gi = got
    ws, wi = want
    return (torch.equal(gi.cpu(), wi.cpu()) and gs.dtype == ws.dtype
            and torch.equal(gs.cpu().view(torch.int64),
                            ws.cpu().view(torch.int64)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 256, 257, 1023, 1024, 1025, 15_625,
                               10 ** 6])
def test_cuda_topk_routes_match_plain_bitwise(n):
    """Both routes (fused up to FUSED_MAX_K, rounds above) and both fused
    folds: ids and scores bitwise equal to the plain version at k = 1,
    100, the fused limit +-1 and n + 5; repeat calls give the same bits
    (the fold's ticket resets)."""
    _cuda_or_skip()
    rng = np.random.default_rng(n)
    lim = ttk.FUSED_MAX_K
    for x in _topk_cases(rng, n):
        if n == 10 ** 6 and x.shape[1] != 64:
            continue
        xt = _t(x).cuda()
        q = _t(rng.normal(size=x.shape[1])).cuda()
        for k in (1, 100, lim - 1, lim, lim + 1, n + 5):
            want = ttk.topk_similarity_plain(xt, q, k)
            plan = ttk.topk_plan(n, x.shape[1], k, xt.dtype)
            assert plan.route == ("fused" if min(k, n) <= lim else "rounds")
            folds = ["threshold", "rounds"] if plan.route == "fused" \
                else [None]
            for fold in folds:
                got = _topk_call(xt, q, k, fold)
                assert _bitwise(got, want), (x.dtype, k, fold)
                assert _bitwise(_topk_call(xt, q, k, fold), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 257, 15_625, 100_003])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_topk_lanes_equal_the_matrix_entry(n, dtype):
    """The lanes entry over x's columns equals topk_similarity over x to
    the bit, on both routes; it counts one fused launch a call."""
    _cuda_or_skip()
    rng = np.random.default_rng(n + 3)
    x = _t(rng.normal(size=(n, 64)).astype(dtype)).cuda()
    lanes = [x[:, j].contiguous() for j in range(64)]
    w = rng.normal(size=64)
    q = _t(w).cuda()
    for k in (1, 100, ttk.FUSED_MAX_K + 1):
        before = dict(ttk.ROUTES)
        got = ttk.topk_similarity_lanes(lanes, w, k)
        if min(k, n) <= ttk.FUSED_MAX_K:
            assert ttk.ROUTES["fused"] == before["fused"] + 1
        assert _bitwise(got, ttk.topk_similarity(x, q, k))
        assert _bitwise(got, ttk.topk_similarity_plain(x, q, k))


@pytest.mark.cuda
def test_cuda_topk_one_device_kernel_per_call():
    """At phase 4's partition (15,625 x 64 float32, k = 100) the matrix
    entry and the lanes entry each put one kernel on the device."""
    _cuda_or_skip()
    rng = np.random.default_rng(15)
    x = _t(rng.normal(size=(15_625, 64)).astype(np.float32)).cuda()
    q = _t(rng.normal(size=64)).cuda()
    lanes = [x[:, j].contiguous() for j in range(64)]
    w = q.cpu().numpy()
    assert ttk.topk_plan(15_625, 64, 100, torch.float32).blocks == 62
    assert graph_nodes(lambda: ttk.topk_similarity(x, q, 100)) \
        == {"kernel": 1}
    assert graph_nodes(lambda: ttk.topk_similarity_lanes(lanes, w, 100)) \
        == {"kernel": 1}


def _rle_runs(rng, n, kind):
    """Cumulative int32 run ends of n positions: runs of 1, one run, runs
    of 8, zero-length runs, ends short of n, and a tile spanning more
    zero-length runs than the kernel stages."""
    if kind == "ones":
        lens = np.ones(n, np.int64)
    elif kind == "one":
        lens = np.array([n])
    elif kind == "eights":
        lens = np.full(-(-n // 8), 8)
    elif kind == "zeros":
        lens = rng.integers(0, 4, n)
    elif kind == "short":
        lens = rng.integers(1, 9, max(1, n // 10))
    else:
        lens = np.array([n // 2] + [0] * 2500 + [n - n // 2], np.int64)
    return _t(np.cumsum(lens).astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1023, 1025, 2049, 156_250])
@pytest.mark.parametrize("kind", ["ones", "one", "eights", "zeros", "short",
                                  "heavy"])
def test_cuda_rle_decode_and_into_exact(n, kind):
    """rle_decode and rle_decode_into on the card equal their plain
    versions exactly: every values dtype into every destination dtype, a
    contiguous destination, one off 16 bytes and a column of a row-major
    (n, 12) matrix."""
    _cuda_or_skip()
    rng = np.random.default_rng(n + len(kind))
    ends = _rle_runs(rng, n, kind).cuda()
    r = ends.shape[0]
    for vdt in ("int32", "int64", "float32", "float64"):
        vals = _t((rng.normal(size=r) * 100).astype(vdt)).cuda()
        got = tdd.rle_decode(vals, ends, n)
        assert torch.equal(got.cpu(), tdd.rle_decode_plain(
            vals.cpu(), ends.cpu(), n))
        for odt in (torch.int32, torch.int64, torch.float32, torch.float64):
            flat = torch.full((n * 12 + 1,), -7, dtype=odt, device="cuda")
            for dst in (flat[:n], flat[1:n + 1],
                        flat[:n * 12].view(n, 12)[:, 5]):
                want = flat.cpu().clone()
                wdst = want[dst.storage_offset():][::dst.stride(0)][:n]
                tdd.rle_decode_into_plain(vals.cpu(), ends.cpu(), n, wdst)
                tdd.rle_decode_into(vals, ends, n, dst)
                assert torch.equal(flat.cpu(), want), (vdt, odt)


@pytest.mark.cuda
def test_cuda_rle_into_casts_through_the_original_dtype():
    """int64 run values of a narrower or unsigned block: cast to it, then
    to the destination, as decode_torch(enc).to(dt) does."""
    _cuda_or_skip()
    rng = np.random.default_rng(21)
    ends = _t(np.cumsum(np.full(300, 7)).astype(np.int32)).cuda()
    vals = _t(rng.integers(-2 ** 62, 2 ** 62, 300)).cuda()
    for orig in (torch.int8, torch.uint8, torch.int16, torch.int32,
                 torch.uint32, torch.uint64):
        dst = torch.empty(2100, dtype=torch.float32, device="cuda")
        tdd.rle_decode_into(vals, ends, 2100, dst, orig)
        want = torch.empty(2100, dtype=torch.float32)
        tdd.rle_decode_into_plain(vals.cpu(), ends.cpu(), 2100, want, orig)
        assert torch.equal(dst.cpu(), want), orig


@pytest.mark.cuda
def test_cuda_rle_one_device_kernel_per_call():
    """At phase 3's column (156,250 positions in runs of 8) rle_decode and
    rle_decode_into a column of a row-major (n, 12) float32 x each put one
    kernel on the device."""
    _cuda_or_skip()
    n = 156_250
    ends = _t(np.cumsum(np.full(n // 8 + 1, 8)).astype(np.int32)).cuda()
    vals = torch.arange(ends.shape[0], dtype=torch.float64, device="cuda")
    x = torch.empty((n, 12), dtype=torch.float32, device="cuda")
    assert graph_nodes(lambda: tdd.rle_decode(vals, ends, n)) \
        == {"kernel": 1}
    assert graph_nodes(lambda: tdd.rle_decode_into(vals, ends, n, x[:, 3])) \
        == {"kernel": 1}


# -- the one-launch scan (colscan, fused_decode_scan) on the card ----------

SCAN_DTYPES = ("int32", "int64", "float32", "float64")
SCAN_SIZES = [0, 1, 255, 256, 257, 1023, 1024, 1025, 93_750, 10 ** 6,
              10 ** 7]


def _scan_column(rng, n, dtype, nan_every=0):
    """A column of `dtype` on the card: integers in [-100, 100), floats
    from a normal (NaN every `nan_every` rows when given)."""
    if dtype.startswith("int"):
        return _t(rng.integers(-100, 100, n).astype(dtype)).cuda()
    v = rng.normal(size=n) * 50
    if nan_every:
        v[::nan_every] = np.nan
    return _t(v.astype(dtype)).cuda()


def _scan_both(fn, plain, *args):
    got = fn(*args)
    assert got.dtype == torch.float64 and got.shape == (4,)
    _scan_close(got.cpu().numpy(), plain(*args).cpu().numpy())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n", SCAN_SIZES)
def test_cuda_scan_every_dtype_pair_matches_plain(n):
    """Both policies against their plain versions (exact count, min and
    max, the sum to rtol 1e-12) for every filter (or dictionary) and
    aggregate dtype, on one block and many, with codes below 0, at the pad
    code d and past it."""
    _cuda_or_skip()
    rng = np.random.default_rng(n % 9973)
    codes = _t(rng.integers(-2, 14, n).astype(np.int32)).cuda()
    aggs = {dt: _scan_column(rng, n, dt, 7) for dt in SCAN_DTYPES}
    for fdt in SCAN_DTYPES:
        f = _scan_column(rng, n, fdt, 5)
        dic = _scan_column(rng, 11, fdt)
        for adt, a in aggs.items():
            _scan_both(tcolscan.colscan, tcolscan.colscan_plain, f, a,
                       -20, 30)
            _scan_both(tdd.fused_decode_scan, tdd.fused_decode_scan_plain,
                       codes, dic, a, -40, 40)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 93_750, 10 ** 6])
def test_cuda_scan_nan_inf_bounds_and_codes(n):
    """NaN filter values fail ±inf bounds, NaN aggregate values make min
    and max NaN, (-inf, inf) selects every finite row and (inf, -inf)
    none; negative, pad (d) and larger codes read NaN."""
    _cuda_or_skip()
    rng = np.random.default_rng(n)
    f = _scan_column(rng, n, "float64", 3)
    a = _scan_column(rng, n, "float64")
    a_nan = a.clone()
    a_nan[n // 2] = float("nan")
    dic = _t(np.arange(11) * 0.01).cuda()
    codes = _t(rng.integers(-3, 15, n).astype(np.int32)).cuda()
    for lo, hi in ((-np.inf, np.inf), (np.inf, -np.inf), (-np.inf, 0.0),
                   (0.0, np.inf), (-10.0, 10.0)):
        for agg in (a, a_nan):
            got = _scan_both(tcolscan.colscan, tcolscan.colscan_plain, f,
                             agg, lo, hi)
            _scan_both(tdd.fused_decode_scan, tdd.fused_decode_scan_plain,
                       codes, dic, agg, lo, hi)
            if lo > hi:
                assert got.cpu().tolist() == [0.0, 0.0, np.inf, -np.inf]
    every = tdd.fused_decode_scan(codes, dic, a, -np.inf, np.inf).cpu()
    valid = ((codes >= 0) & (codes < 11)).sum().item()
    assert every[0].item() == valid < n


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,staged", [(93_750, 11, True),
                                        (93_750, 711, True),
                                        (93_750, 712, False),
                                        (93_750, 100_000, False),
                                        (10 ** 7, 4_096, True),
                                        (10 ** 7, 4_097, False),
                                        (300, 11, True), (300, 300, False)])
def test_cuda_fused_decode_scan_staged_and_global_dictionaries(n, d, staged):
    """A dictionary that fits the shared-memory stage (32 KB as float64,
    no more values than a block's rows) is staged; a larger one is read
    through __ldg; both match the plain version."""
    _cuda_or_skip()
    assert tcolscan.scan_staged(n, d) == staged
    rng = np.random.default_rng(d)
    dic = _t(np.sort(rng.normal(size=d))).cuda()
    codes = _t(rng.integers(-1, d + 2, n).astype(np.int32)).cuda()
    a = _scan_column(rng, n, "float64")
    for dt in ("float32", "int64"):
        _scan_both(tdd.fused_decode_scan, tdd.fused_decode_scan_plain,
                   codes, dic.to(getattr(torch, dt)), a, -0.5, 1.0)
    _scan_both(tdd.fused_decode_scan, tdd.fused_decode_scan_plain, codes,
               dic, a, -0.5, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [257, 93_750, 10 ** 6])
@pytest.mark.parametrize("dtype", SCAN_DTYPES)
def test_cuda_colscan_one_tensor_as_filter_and_aggregate(n, dtype):
    """One tensor as both operands takes the one-column path: the plain
    version's answer, to the bit the two-column path's over a copy."""
    _cuda_or_skip()
    x = _scan_column(np.random.default_rng(n), n, dtype, 11)
    routes = dict(tcolscan.ROUTES)
    got = _scan_both(tcolscan.colscan, tcolscan.colscan_plain, x, x, -30,
                     40)
    assert tcolscan.ROUTES["one_column"] == routes["one_column"] + 1
    assert torch.equal(got, tcolscan.colscan(x, x.clone(), -30, 40))
    assert tcolscan.ROUTES["two_columns"] == routes["two_columns"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1025, 93_750, 10 ** 6])
def test_cuda_scan_views_off_16_bytes(n):
    """Views one element into their buffers (not on 16 bytes) take scalar
    loads: the plain version's answer, to the bit the aligned copies'."""
    _cuda_or_skip()
    rng = np.random.default_rng(n + 1)
    for fdt, adt in (("float64", "float64"), ("int32", "float64"),
                     ("float32", "int32"), ("int64", "float32")):
        fb = _scan_column(rng, n + 1, fdt, 5)
        ab = _scan_column(rng, n + 1, adt)
        f, a = fb[1:], ab[1:]
        for fv, av in ((f, a), (f, ab[:n]), (fb[:n], a)):
            got = _scan_both(tcolscan.colscan, tcolscan.colscan_plain, fv,
                             av, -25, 25)
            assert torch.equal(got, tcolscan.colscan(
                fv.clone(), av.clone(), -25, 25))
        got = _scan_both(tcolscan.colscan, tcolscan.colscan_plain, f, f,
                         -25, 25)
        assert torch.equal(got, tcolscan.colscan(f.clone(), f.clone(), -25,
                                                 25))
    cb = _t(rng.integers(-1, 12, n + 3).astype(np.int32)).cuda()
    dic = _t(np.arange(11) * 0.01).cuda()
    a = _scan_column(rng, n + 1, "float64")
    for off in (1, 2, 3):
        codes = cb[off:off + n]
        got = _scan_both(tdd.fused_decode_scan, tdd.fused_decode_scan_plain,
                         codes, dic, a[1:], 0.02, 0.08)
        assert torch.equal(got, tdd.fused_decode_scan(
            codes.clone(), dic, a[1:].clone(), 0.02, 0.08))


@pytest.mark.cuda
def test_cuda_scan_repeat_calls_bit_equal():
    """Repeat calls give the same bits on one block and on many; the
    ticket word returns to 0 after every launch, whatever ran before it
    on the stream."""
    _cuda_or_skip()
    rng = np.random.default_rng(3)
    cases = []
    for n in (93_750, 10 ** 6, 140_000, 200, 5):
        f = _scan_column(rng, n, "float64", 13)
        a = _scan_column(rng, n, "float64")
        cases.append((f, a, tcolscan.colscan(f, a, -40, 40)))
    launches = tcolscan.LAUNCHES["colscan"]
    for _ in range(5):
        for f, a, first in cases:
            assert torch.equal(tcolscan.colscan(f, a, -40, 40), first)
    assert tcolscan.LAUNCHES["colscan"] == launches + 25


@pytest.mark.cuda
def test_cuda_scan_calls_on_two_streams():
    """Calls overlapping on two streams hold separate tickets (the
    partials are each call's own) and give the one-stream answers."""
    _cuda_or_skip()
    rng = np.random.default_rng(4)
    n = 10 ** 6
    f = [_scan_column(rng, n, "float64", 9) for _ in range(2)]
    a = _scan_column(rng, n, "float64")
    want = [tcolscan.colscan(x, a, -30, 30) for x in f]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    tickets = {tcolscan._ticket(a.device, s.cuda_stream).data_ptr()
               for s in streams}
    assert len(tickets) == 2
    got = [[], []]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(tcolscan.colscan(f[i], a, -30, 30))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(g, want[i]) for g in got[i])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 93_750, 10 ** 6])
def test_cuda_scan_one_device_kernel_per_call(n):
    _cuda_or_skip()
    rng = np.random.default_rng(n)
    f = _scan_column(rng, n, "float64")
    a = _scan_column(rng, n, "float64")
    codes = _t(rng.integers(0, 11, n).astype(np.int32)).cuda()
    dic = _t(np.arange(11) * 0.01).cuda()
    for call in (lambda: tcolscan.colscan(f, f, -10, 10),
                 lambda: tcolscan.colscan(f, a, -10, 10),
                 lambda: tdd.fused_decode_scan(codes, dic, a, 0.02, 0.05)):
        assert graph_nodes(call) == {"kernel": 1}


# -- radix_split: the shuffle's map-side split (csrc/radix.cu) ------------

RADIX_SIZES = [0, 1, 50, 1023, 4096, 4097, 93_750]
RADIX_BUCKETS = [1, 7, 64, 1000, 8192]


def _radix_keys(rng, n, kind):
    """int64 key hashes with negatives and repeats, or 32-bit lanes as
    uint32 or int32 bits."""
    if kind == "int64":
        k = rng.integers(-2 ** 62, 2 ** 62, n)
        k[::7] = -1
        if n:
            k[3::11] = k[0]
        return k
    k = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    k[::5] = 12345
    return k if kind == "uint32" else k.view(np.int32)


def _radix_tensor(k):
    t = _t(k)
    return t.view(torch.uint32) if k.dtype == np.uint32 else t


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int64", "uint32", "int32"])
@pytest.mark.parametrize("n", RADIX_SIZES)
def test_cuda_radix_split_matches_plain(n, kind):
    """order and bounds bit for bit against the plain version (and the
    numpy oracle) at every bucket count, both routes."""
    _cuda_or_skip()
    rng = np.random.default_rng(n + len(kind))
    k = _radix_keys(rng, n, kind)
    t = _radix_tensor(k)
    for b in RADIX_BUCKETS:
        order, bounds = trp.radix_split(t.cuda(), b)
        po, pb = trp.radix_split_plain(t, b)
        ro, rb = trp.radix_split_ref(k, b)
        assert order.dtype == bounds.dtype == torch.int32
        np.testing.assert_array_equal(order.cpu().numpy(), po.numpy())
        np.testing.assert_array_equal(bounds.cpu().numpy(), pb.numpy())
        np.testing.assert_array_equal(po.numpy(), ro)
        np.testing.assert_array_equal(pb.numpy(), rb)
        if kind != "int64":
            lanes = t if kind == "int32" else t.view(torch.int32)
            ids, counts = trp.radix_partition(lanes.cuda(), b)
            pids, pcounts = trp.radix_partition_plain(lanes, b)
            assert torch.equal(ids.cpu(), pids)
            assert torch.equal(counts.cpu(), pcounts)
            only, none = trp.radix_partition(lanes.cuda(), b, False)
            assert none is None and torch.equal(only.cpu(), pids)
            np.testing.assert_array_equal(
                only.cpu().numpy(),
                trp.radix_partition_ref(lanes.numpy().view(np.uint32), b)[0])


@pytest.mark.cuda
def test_cuda_radix_split_large_one_bucket_and_repeats():
    """10^7 keys (2,442 tiles over the grid), every key in one bucket,
    and repeat calls bitwise."""
    _cuda_or_skip()
    rng = np.random.default_rng(19)
    for k in (_radix_keys(rng, 10 ** 7, "int64"),
              np.full(93_750, -7, np.int64), np.full(10 ** 6, 3, np.int64)):
        t = _t(k)
        tc = t.cuda()
        for b in (64, 1000, 8192) if len(k) == 10 ** 7 else (64, 1024):
            want = trp.radix_split_plain(t, b)
            got = [trp.radix_split(tc, b) for _ in range(3)]
            torch.cuda.synchronize()
            for order, bounds in got:
                assert torch.equal(order.cpu(), want[0])
                assert torch.equal(bounds.cpu(), want[1])
        if len(k) == 10 ** 7:
            # ids alone over chunks of many tiles (one_launch, B = 64)
            lanes = _t(trp.fold_keys_u32(k).view(np.int32))
            only, none = trp.radix_partition(lanes.cuda(), 64, False)
            assert none is None
            assert torch.equal(only.cpu(),
                               trp.radix_partition_plain(lanes, 64, False)[0])


@pytest.mark.cuda
def test_cuda_radix_split_on_two_streams():
    """Calls overlapping on two streams keep their own look-back words and
    give the one-stream answers."""
    _cuda_or_skip()
    rng = np.random.default_rng(5)
    keys = [_t(_radix_keys(rng, 93_750 + i, "int64")).cuda()
            for i in range(2)]
    want = [trp.radix_split(k, 64) for k in keys]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(trp.radix_split(keys[i], 64))
    torch.cuda.synchronize()
    for i in range(2):
        for order, bounds in got[i]:
            assert torch.equal(order, want[i][0])
            assert torch.equal(bounds, want[i][1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [50, 93_750, 10 ** 6])
def test_cuda_radix_one_device_kernel_per_call(n):
    """One kernel node a call on route one_launch (the counts written in
    the launch, no memset); two on two_launch."""
    _cuda_or_skip()
    rng = np.random.default_rng(n)
    keys = _t(_radix_keys(rng, n, "int64")).cuda()
    lanes = _t(_radix_keys(rng, n, "int32")).cuda()
    assert graph_nodes(lambda: trp.radix_split(keys, 64)) == {"kernel": 1}
    assert graph_nodes(lambda: trp.radix_partition(lanes, 64)) \
        == {"kernel": 1}
    assert graph_nodes(lambda: trp.radix_partition(lanes, 64, False)) \
        == {"kernel": 1}
    assert graph_nodes(lambda: trp.radix_split(keys, 8192)) == {"kernel": 2}
    assert graph_nodes(lambda: trp.radix_partition(lanes, 8192, False)) \
        == {"kernel": 1}


@pytest.mark.cuda
def test_cuda_radix_graph_replays_after_a_larger_call():
    """A graph captured around a small multi-chunk call replays right
    after calls that use more of the stream's look-back words (the words
    are never replaced)."""
    _cuda_or_skip()
    rng = np.random.default_rng(23)
    small = _t(_radix_keys(rng, 10_000, "int64")).cuda()
    large = _t(_radix_keys(rng, 10 ** 6, "int64")).cuda()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        trp.radix_split(small, 64)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            got = trp.radix_split(small, 64)
        for b in (64, 1024):
            big = trp.radix_split(large, b)
        graph.replay()
    torch.cuda.synchronize()
    want = trp.radix_split_plain(small.cpu(), 64)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(big[0].cpu(), trp.radix_split_plain(large.cpu(),
                                                           1024)[0])


@pytest.mark.cuda
def test_cuda_two_server_clients_on_forced_kernel_routes():
    """Two clients of one SharkServer run queries at once on the card with
    every SQL kernel route forced (colscan, fused_decode_scan, groupby_sum,
    radix_split and segmented_merge on the executor's threads): each
    answer equals the one-client answer (counts exactly, sums to rtol
    1e-12), every launch is counted (the stream's fold tickets, the
    threads' pinned key buffers and the launch counters are shared), and
    the scans keep their one-column route."""
    _cuda_or_skip()
    import threading

    from repro_torch.core import DType, Schema
    from repro_torch.core.pde import PDEConfig
    from repro_torch.kernels import colscan as tcs
    from repro_torch.server import SharkServer

    rng = np.random.default_rng(41)
    n = 120_000
    data = {"g": rng.integers(0, 40, n).astype(np.int32),
            "v": np.round(rng.uniform(0, 100, n), 2),
            "d": np.round(rng.integers(0, 11, n) * 0.01, 2)}
    queries = [
        "SELECT COUNT(*) AS c, SUM(v) AS s, MIN(v) AS mn, MAX(v) AS mx "
        "FROM t WHERE v BETWEEN 20 AND 60",
        "SELECT COUNT(*) AS c, SUM(v) AS s FROM t WHERE d BETWEEN 0.03 "
        "AND 0.07",
        # a SUM alone merges its partial states through segmented_merge
        "SELECT g, SUM(v) AS s FROM t GROUP BY g"]
    kernels = ("colscan", "fused_decode_scan", "groupby_sum",
               "radix_partition", "segmented_merge")
    cfg = PDEConfig(segment_force_kernels=True, reduce_force_compiled=True,
                    segment_kernel_min_rows=256)
    srv = SharkServer(device="cuda", num_workers=4, max_threads=4,
                      default_partitions=8, default_shuffle_buckets=16,
                      pde_config=cfg, enable_result_cache=False,
                      max_concurrent_queries=2)
    srv.create_table("t", Schema.of(g=DType.INT32, v=DType.FLOAT64,
                                    d=DType.FLOAT64), data)

    def answers(sess):
        out = []
        for q in queries:
            got = sess.sql_np(q)
            order = np.argsort(got["g"]) if "g" in got else slice(None)
            out.append({k: np.asarray(v)[order] for k, v in got.items()})
        return out

    def launches():
        counts = tops.launch_counts()
        return {k: counts[k] for k in kernels}

    try:
        tops.reset_launch_counts()
        want = answers(srv.session("alone"))
        alone = launches()
        assert all(alone.values()), alone
        tops.reset_launch_counts()
        one_col = tcs.ROUTES["one_column"]
        got, errors = {}, []

        def client(name):
            try:
                sess = srv.session(name)
                got[name] = [answers(sess) for _ in range(2)]
            except Exception as e:       # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(f"c{i}",))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        assert launches() == {k: 4 * v for k, v in alone.items()}
        assert tcs.ROUTES["one_column"] - one_col == 4 * alone["colscan"]
        for runs in got.values():
            for run in runs:
                for g, w in zip(run, want):
                    for k in w:
                        if w[k].dtype.kind == "f":
                            np.testing.assert_allclose(g[k], w[k],
                                                       rtol=1e-12)
                        else:
                            np.testing.assert_array_equal(g[k], w[k])
    finally:
        srv.shutdown()
