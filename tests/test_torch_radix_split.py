"""The shuffle's map-side split on the torch port against the JAX reference.

`radix_split(keys, B)` is a shuffle's whole map side: the rows grouped by
bucket (`order`, stable) and the bucket starts (`bounds`).  The same seeded
keys go to the reference's Pallas radix kernel (interpret mode, as
tests/test_kernels.py runs it), whose bucket ids, stable-argsorted and
searchsorted on the host, are the split the shuffle cut before; to the
port's plain version (`radix_split_plain`, what the wrapper runs on CPU
tensors); and to its numpy oracle (`radix_split_ref`).  All three must be
equal exactly: order, bounds and the histogram are integers.  int64 keys
(the host's key hashes, negatives and repeats among them) are folded on
the port's side of the call; the reference is handed
`fold_keys_u32(keys)`, as its host did.  uint32 / int32 keys are 32-bit
lanes and are not folded.

The shuffle's forced kernel route on `device="cpu"` must cut pieces
byte-identical to the host slicing of the same ids
(`split_bucket_pieces(batch, ids, B)`) without a host argsort.
"""

import numpy as np
import pytest
import torch

from repro.kernels.radix_partition import fold_keys_u32 as jax_fold
from repro.kernels.radix_partition import radix_partition as jax_radix
from repro_torch.core.batch import ColumnVal, PartitionBatch
from repro_torch.core import shuffle
from repro_torch.core.columnar import hash_key_values
from repro_torch.kernels import ops
from repro_torch.kernels import radix_partition as rp

SIZES = [0, 1, 50, 1023, 4096, 4097, 93_750]
BUCKETS = [1, 7, 64, 1000, 8192]
KINDS = ["int64", "uint32", "int32"]


def _keys(n, b, kind):
    """Seeded keys: int64 hashes with negatives and repeats, or 32-bit
    lanes (uint32, or int32 bits with negatives) with repeats."""
    rng = np.random.default_rng(1000 * n + b + len(kind))
    if kind == "int64":
        k = rng.integers(-2 ** 62, 2 ** 62, n)
        k[::7] = -1
        if n:
            k[3::11] = k[0]
        return k
    k = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    k[::5] = 0xFFFFFFF0
    return k if kind == "uint32" else k.view(np.int32)


def _lanes(k):
    """The uint32 lanes the reference kernel takes."""
    return jax_fold(k) if k.dtype == np.int64 else k.view(np.uint32)


def _reference_split(k, b):
    ids, counts = jax_radix(_lanes(k), num_buckets=b, interpret=True)
    ids, counts = np.asarray(ids), np.asarray(counts)
    order = np.argsort(ids, kind="stable")
    bounds = np.searchsorted(ids[order], np.arange(b + 1))
    return order, bounds, counts


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b", BUCKETS)
@pytest.mark.parametrize("n", SIZES)
def test_radix_split_matches_reference(n, b, kind):
    k = _keys(n, b, kind)
    want_order, want_bounds, want_counts = _reference_split(k, b)
    order, bounds = rp.radix_split(torch.from_numpy(k), b)
    assert order.dtype == bounds.dtype == torch.int32
    assert bounds.shape == (b + 1,)
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(bounds.numpy(), want_bounds)
    np.testing.assert_array_equal(np.diff(bounds.numpy()), want_counts)
    ref_order, ref_bounds = rp.radix_split_ref(k, b)
    np.testing.assert_array_equal(ref_order, want_order)
    np.testing.assert_array_equal(ref_bounds, want_bounds)


@pytest.mark.parametrize("b", [1, 64, 8192])
def test_radix_split_all_keys_in_one_bucket(b):
    """Every key equal: one bucket holds the rows in row order."""
    k = np.full(4097, -(2 ** 40) - 3, np.int64)
    order, bounds = rp.radix_split(torch.from_numpy(k), b)
    np.testing.assert_array_equal(order.numpy(), np.arange(4097))
    (bucket,) = np.flatnonzero(np.diff(bounds.numpy()))
    assert bounds[bucket + 1] - bounds[bucket] == 4097
    np.testing.assert_array_equal(bounds.numpy(),
                                  rp.radix_split_ref(k, b)[1])


def test_radix_plan_routes():
    """B <= 1024 takes the one launch at any n, a tile a chunk up to
    GRID_MAX tiles, then chunks of whole tiles; above 1024, two launches;
    ids alone a grid-stride pass.  Look-back words only past one chunk."""
    for n in (0, 50, 4096, 93_750, 264 * 4096, 264 * 4096 + 1, 10 ** 7):
        tiles = max(1, -(-n // rp.TILE))
        for b in (1, 64, 1024):
            plan = rp.radix_plan(n, b, rp.SPLIT)
            assert plan.route == "one_launch" and plan.launches == 1
            assert plan.blocks == plan.chunks <= rp.GRID_MAX
            assert (plan.chunks - 1) * plan.per < tiles <= (plan.chunks
                                                             * plan.per)
            assert plan.per == (1 if tiles <= rp.GRID_MAX
                                else -(-tiles // rp.GRID_MAX))
            assert plan.scratch == (2 + plan.chunks * b if plan.chunks > 1
                                    else 0)
            assert plan.size == n + b + 1
        plan = rp.radix_plan(n, 1025, rp.SPLIT)
        assert plan.route == "two_launch" and plan.launches == 2
        assert plan.per * plan.blocks >= n and plan.per % 32 == 0
        assert rp.radix_plan(n, 8192, rp.IDS | rp.COUNTS).launches == 1
        # ids alone take the route of the rest: no kernel of their own
        assert rp.radix_plan(n, 64, rp.IDS).route == "one_launch"
        assert rp.radix_plan(n, 8192, rp.IDS).route == "two_launch"
    assert rp.one_launch_chunks(10 ** 7) == (245, 10)   # 2,442 tiles
    with pytest.raises(ValueError):
        rp.radix_plan(10, 8193, rp.SPLIT)
    with pytest.raises(ValueError):
        rp.radix_plan(10, 0, rp.SPLIT)


def test_plan_word_round_trips():
    plan = rp.radix_plan(93_750, 64, rp.SPLIT)
    word = plan.word(True, rp.SPLIT)
    assert word & 1 and word & 0xE == rp.SPLIT
    assert word >> 4 & 3 == rp.ROUTE_CODES["one_launch"]
    assert word >> 8 & 0xFFFF == plan.blocks == 23
    assert word >> 24 & 0xFFFF == plan.chunks == 23
    assert word >> 40 == plan.per == 1
    big = rp.radix_plan(10 ** 7, 64, rp.SPLIT)
    assert big.word(True, rp.SPLIT) >> 40 == big.per == 10


def test_radix_split_on_cpu_launches_nothing():
    ops.reset_launch_counts()
    routes = dict(rp.ROUTES)
    rp.radix_split(torch.arange(100, dtype=torch.int64), 8)
    assert ops.launch_counts()["radix_partition"] == 0
    assert rp.ROUTES == routes


def _batch(n, seed):
    """A map task's batch: an int64 key, a second int key, a float, and a
    dictionary-coded string column."""
    rng = np.random.default_rng(seed)
    words = np.array(["ash", "birch", "cedar", "elm", "fir", "oak"])
    return PartitionBatch({
        "k": ColumnVal(rng.integers(-500, 500, n).astype(np.int64)),
        "j": ColumnVal(rng.integers(0, 9, n).astype(np.int32)),
        "v": ColumnVal(rng.normal(size=n)),
        "s": ColumnVal(rng.integers(0, len(words), n).astype(np.int32),
                       words, True),
    })


def _assert_pieces_identical(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g.cols) == list(w.cols)
        for name in w.cols:
            ga, wa = np.asarray(g.cols[name].arr), np.asarray(w.cols[name].arr)
            assert ga.dtype == wa.dtype and ga.shape == wa.shape
            assert ga.tobytes() == wa.tobytes()
            assert g.cols[name].sdict is w.cols[name].sdict


@pytest.mark.parametrize("n", [0, 50, 4097, 20_000])
@pytest.mark.parametrize("b", [1, 8, 64, 2000])
def test_kernel_route_pieces_byte_identical_without_host_argsort(
        n, b, monkeypatch):
    """The forced kernel route on the CPU: a `BucketSplit` whose pieces
    equal, byte for byte, the host slicing of the kernel's ids (the
    reference's radix ids of the folded key hashes) — for a single key, a
    composite key and a string key — and no np.argsort or np.searchsorted
    runs."""
    batch = _batch(n, n + b)
    cases = []
    for keys, part in (
            (["k"], shuffle.bucket_by_hash("k", b, kernel="cpu")),
            (["s"], shuffle.bucket_by_hash("s", b, kernel=True)),
            (["k", "j", "s"],
             shuffle.bucket_by_composite(["k", "j", "s"], b, kernel="cpu"))):
        h = np.zeros(n, np.int64)
        for key in keys:
            h = h * np.int64(1000003) + shuffle._row_keys(batch, key)
        ids = np.asarray(jax_radix(jax_fold(h), num_buckets=b,
                                   interpret=True)[0])
        cases.append((part, shuffle.split_bucket_pieces(batch, ids, b)))
    if n:
        np.testing.assert_array_equal(shuffle._row_keys(batch, "k"),
                                      hash_key_values(batch.col("k").arr))

    def forbidden(*a, **k):
        raise AssertionError("the kernel route ran a host sort")

    monkeypatch.setattr(np, "argsort", forbidden)
    monkeypatch.setattr(np, "searchsorted", forbidden)
    before = shuffle.RADIX_KERNEL_CALLS["count"]
    for part, want in cases:
        split = part(batch)
        assert isinstance(split, shuffle.BucketSplit)
        _assert_pieces_identical(
            shuffle.split_bucket_pieces(batch, split, b), want)
    assert shuffle.RADIX_KERNEL_CALLS["count"] == before + 3


def test_host_route_keeps_its_ids():
    """Without a kernel the partitioner still returns the host's 64-bit
    mix ids, and the pieces are the legacy slicing of them."""
    batch = _batch(1000, 3)
    ids = shuffle.bucket_by_hash("k", 16)(batch)
    assert isinstance(ids, np.ndarray) and ids.dtype == np.int32
    np.testing.assert_array_equal(
        ids, shuffle._mix_mod(shuffle._row_keys(batch, "k"), 16))
