"""Join-order properties on the torch port against the JAX reference: a
deterministic twin of tests/test_join_property.py.

Its derandomized Hypothesis seeds (the same on every run;
`torch_twin.twin_given`) load the same random star data into both
packages; every join order must give the same rows in each, and the
port's rows and estimated plan costs must equal the reference's (floats
to rtol 1e-12).  The reference's docstring follows.

Property tests (hypothesis): join-order invariance and ordering-cost
sanity for 3-table star joins.

  1. Every valid left-deep join order of the same 3-table query produces
     row-identical results (joins are commutative/associative for inner
     equi-joins — and PDE's per-boundary strategy choices must not change
     that).
  2. The optimizer's chosen order never loses to the WORST order on
     estimated cost (plan.estimate_plan_cost, the objective order_joins
     minimizes).

A deterministic single-dataset twin of these properties runs unconditionally
in tests/test_multiway_join.py; this file explores random data shapes when
hypothesis is installed.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis")

from hypothesis import strategies as st

from torch_twin import P, observed, per_pkg, twin_given


@pytest.fixture(scope="module")
def sess():
    built = per_pkg(_make_sess)
    yield built
    for v in built.values():
        v.shutdown()


def _make_sess():
    s = P.SharkSession(num_workers=2, max_threads=2, default_partitions=3,
                     default_shuffle_buckets=4)
    return s


def _register(sess, seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(100, 1500))
    d1 = int(rng.integers(3, 40))
    d2 = int(rng.integers(3, 40))
    sess.create_table("pf", P.Schema.of(
        k1=P.DType.INT64, k2=P.DType.INT64, rev=P.DType.FLOAT64),
        {"k1": rng.integers(0, d1, n).astype(np.int64),
         "k2": rng.integers(0, d2, n).astype(np.int64),
         "rev": rng.uniform(0, 10, n)})
    sess.create_table("pd1", P.Schema.of(p1=P.DType.INT64, x1=P.DType.INT64),
                      {"p1": np.arange(d1, dtype=np.int64),
                       "x1": rng.integers(0, 5, d1).astype(np.int64)})
    sess.create_table("pd2", P.Schema.of(p2=P.DType.INT64, x2=P.DType.INT64),
                      {"p2": np.arange(d2, dtype=np.int64),
                       "x2": rng.integers(0, 5, d2).astype(np.int64)})


def _orders(sess):
    """All valid left-deep join orders of pf ⋈ pd1 ⋈ pd2 as frames (each
    newly attached relation must connect via an equi predicate)."""
    f, a, b = (lambda: sess.table("pf"), lambda: sess.table("pd1"),
               lambda: sess.table("pd2"))
    return [
        f().join(a(), on=("k1", "p1")).join(b(), on=("k2", "p2")),
        f().join(b(), on=("k2", "p2")).join(a(), on=("k1", "p1")),
        a().join(f(), on=("p1", "k1")).join(b(), on=("k2", "p2")),
        b().join(f(), on=("p2", "k2")).join(a(), on=("k1", "p1")),
    ]


def _all_join_orders_row_identical(sess, seed):
    _register(sess, seed)
    results = []
    for frame in _orders(sess):
        out = frame.select("rev", "x1", "x2").to_numpy()
        rows = sorted(zip(np.round(out["rev"], 9).tolist(),
                          out["x1"].tolist(), out["x2"].tolist()))
        results.append(rows)
    assert all(r == results[0] for r in results[1:]), \
        "join orders disagree on result rows"
    return observed(locals())


def test_all_join_orders_row_identical(sess):
    twin_given(lambda: (st.integers(0, 2**31 - 1),),
               _all_join_orders_row_identical, sess, max_examples=10)


def _chosen_order_never_loses_to_worst(sess, seed):
    _register(sess, seed)
    raw_costs = [P.m("core.plan").estimate_plan_cost(fr.logical_plan(), sess.catalog)
                 for fr in _orders(sess)]
    chosen_costs = [P.m("core.plan").estimate_plan_cost(fr.optimized_plan(), sess.catalog)
                    for fr in _orders(sess)]
    worst = max(raw_costs)
    for c in chosen_costs:
        assert c <= worst + 1e-9, \
            f"optimizer chose cost {c} > worst raw order {worst}"
    return observed(locals())


def test_chosen_order_never_loses_to_worst(sess):
    twin_given(lambda: (st.integers(0, 2**31 - 1),),
               _chosen_order_never_loses_to_worst, sess, max_examples=10)


