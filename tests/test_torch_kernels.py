"""The torch port's five engine kernels against the JAX reference kernels.

Each test feeds the same numpy inputs, made from a seed, to the reference
Pallas kernel (interpret mode on the CPU, through `repro.kernels.ops`, as
tests/test_kernels.py runs it, with float64 accumulation) and to the
port's wrapper on CPU tensors, which runs the kernel's plain PyTorch
version.  Tolerances: counts, min, max, group ids and bucket ids exact;
float64 sums to rtol 1e-12 (both sides accumulate in float64, in
different orders).

`test_cuda_kernel_matches_plain` holds each CUDA kernel against its plain
version on the card; it needs a CUDA device and skips without one.
"""

import jax
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.radix_partition import radix_partition_ref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import colscan as tcolscan
from repro_torch.kernels import dictdecode as tdd
from repro_torch.kernels import groupby_mxu as tgb
from repro_torch.kernels import radix_partition as trp
from repro_torch.kernels import segmented_merge as tsm

SIZES = [1, 100, 1023, 8 * 128 * 3 + 17]
BOUNDS = [(-0.5, 0.5), (-np.inf, 0.25), (-0.25, np.inf), (np.inf, -np.inf)]
NP_DTYPES = {"int32": np.int32, "int64": np.int64, "float64": np.float64}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scan_close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got[0] == want[0]                     # count
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12, atol=1e-9)
    assert got[2] == want[2] and got[3] == want[3]   # min, max exact


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
    assert set(tops.launch_counts().values()) == {0}


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
