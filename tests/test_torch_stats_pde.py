"""PDE statistics (paper §3.1) on the torch port against the JAX
reference: the twin of tests/test_stats_pde.py (log-encoded sizes, heavy
hitters, decisions, greedy bin-packing).

Each body runs on both packages (`torch_twin.twin`) and returns what it
observed (codes, payloads, decisions), which must equal the reference's.
The two Hypothesis properties run derandomized, so every run draws the
same examples and counts the same.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st

from torch_twin import P, twin


def _log_encoding_error_bound(nbytes):
    """Paper: one byte represents up to 32 GB with at most 10% error."""
    code = P.m("core.stats").encode_size(nbytes)
    assert 0 <= code <= 255
    rel_err = abs(P.m("core.stats").decode_size(code) - nbytes) / nbytes
    assert rel_err <= 0.10, (nbytes, code, P.m("core.stats").decode_size(code), rel_err)
    return code, P.m("core.stats").decode_size(code)


@settings(max_examples=100, deadline=None, derandomize=True)
@given(st.integers(min_value=1, max_value=32 << 30))
def test_log_encoding_error_bound(nbytes):
    twin(_log_encoding_error_bound, nbytes)


def _stats_payload_bounded():
    """Paper: statistics are limited to 1-2 KB per task."""
    acc = P.m("core.stats").SizeAccumulator(num_buckets=64)
    hh = P.m("core.stats").HeavyHitterAccumulator("k", k=64)
    batch = P.m("core.batch").PartitionBatch.from_numpy(
        {"k": np.arange(1000) % 7, "v": np.ones(1000)})
    for b in range(64):
        acc.update(b, batch)
        hh.update(b, batch)
    ts = P.m("core.stats").TaskStats(0, 0, {"sizes": acc.payload(),
                          "heavy_hitters": hh.payload()})
    assert ts.nbytes() <= 2048, ts.nbytes()
    return ts.nbytes(), list(acc.payload()), list(hh.payload())


def test_stats_payload_bounded():
    twin(_stats_payload_bounded)


def _heavy_hitters_find_frequent():
    hh = P.m("core.stats").HeavyHitterAccumulator("k", k=8)
    rng = np.random.default_rng(0)
    skewed = np.concatenate([np.full(5000, 42), rng.integers(100, 10000, 500)])
    batch = P.m("core.batch").PartitionBatch.from_numpy({"k": skewed})
    hh.update(0, batch)
    top = list(hh.payload())
    assert top[0] == 42
    return top


def test_heavy_hitters_find_frequent():
    twin(_heavy_hitters_find_frequent)


def _decide_join_broadcast_small():
    acc = P.m("core.stats").SizeAccumulator(4)
    small = P.m("core.batch").PartitionBatch.from_numpy({"k": np.arange(10)})
    for b in range(4):
        acc.update(b, small)
    stats = P.m("core.stats").StageStats(0)
    stats.add(P.m("core.stats").TaskStats(0, 0, {"sizes": acc.payload()}))
    d = P.m("core.pde").decide_join(stats, None, P.m("core.pde").PDEConfig(broadcast_threshold_bytes=1 << 20))
    assert d.choice == P.m("core.pde").JoinChoice.BROADCAST_LEFT
    return d.choice.value


def test_decide_join_broadcast_small():
    twin(_decide_join_broadcast_small)


def _decide_join_shuffle_large():
    acc = P.m("core.stats").SizeAccumulator(4)
    big = P.m("core.batch").PartitionBatch.from_numpy(
        {"k": np.arange(3_000_000, dtype=np.int64)})
    for b in range(4):
        acc.update(b, big)
    stats = P.m("core.stats").StageStats(0)
    stats.add(P.m("core.stats").TaskStats(0, 0, {"sizes": acc.payload()}))
    d = P.m("core.pde").decide_join(stats, None, P.m("core.pde").PDEConfig(broadcast_threshold_bytes=1 << 20))
    assert d.choice == P.m("core.pde").JoinChoice.SHUFFLE
    return d.choice.value


def test_decide_join_shuffle_large():
    twin(_decide_join_shuffle_large)


def _property_binpack_balance(sizes, bins):
    """Greedy bin-packing: max bin <= average + max item (LPT bound-ish),
    and every item is assigned exactly once."""
    groups = P.m("core.stats").greedy_bin_pack(sizes, bins)
    flat = sorted(i for g in groups for i in g)
    assert flat == list(range(len(sizes)))
    loads = [sum(sizes[i] for i in g) for g in groups if g]
    if loads and sum(sizes) > 0:
        assert max(loads) <= sum(sizes) / min(bins, len(sizes)) + max(sizes) + 1e-6
    return [list(g) for g in groups]


@settings(max_examples=50, deadline=None, derandomize=True)
@given(st.lists(st.floats(min_value=0, max_value=1e9, allow_nan=False),
                min_size=1, max_size=200),
       st.integers(min_value=1, max_value=32))
def test_property_binpack_balance(sizes, bins):
    twin(_property_binpack_balance, sizes, bins)


def _decide_parallelism_coalesces():
    acc = P.m("core.stats").SizeAccumulator(64)
    tiny = P.m("core.batch").PartitionBatch.from_numpy({"k": np.arange(100, dtype=np.int64)})
    for b in range(64):
        acc.update(b, tiny)
    stats = P.m("core.stats").StageStats(1)
    stats.add(P.m("core.stats").TaskStats(0, 1, {"sizes": acc.payload()}))
    d = P.m("core.pde").decide_parallelism(stats, 64, P.m("core.pde").PDEConfig(target_reduce_bytes=1 << 20))
    assert d.num_reducers < 64
    covered = sorted(i for g in d.bucket_groups for i in g)
    assert covered == list(range(64))
    return d.num_reducers, [list(g) for g in d.bucket_groups]


def test_decide_parallelism_coalesces():
    twin(_decide_parallelism_coalesces)


def _likely_small_side_prior():
    # a filtered, initially-smaller side should be scheduled first (§6.3.2)
    assert P.m("core.pde").likely_small_side(1 << 20, 1 << 40, True, False) == "left"
    assert P.m("core.pde").likely_small_side(1 << 40, 1 << 20, False, True) == "right"
    return [P.m("core.pde").likely_small_side(a, b, fa, fb)
            for a, b, fa, fb in ((1 << 20, 1 << 40, True, False),
                                 (1 << 40, 1 << 20, False, True),
                                 (1 << 30, 1 << 30, False, False))]


def test_likely_small_side_prior():
    twin(_likely_small_side_prior)


