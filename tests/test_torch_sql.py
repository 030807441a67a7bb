"""The slice as a whole: SQL filter / aggregate / group-by / join queries on
the torch port against the JAX reference, on byte-identical tables.

`tests/oracle.py`'s QueryGen draws seeded queries over `make_star_data`.
The reference session loads the tables; the port's session is given the
same per-partition encoded blocks through `table_from_encoded`, so both
engines scan byte-identical data.  Every query runs on both, under four
configurations: the kernel routes forced on or off
(`segment_force_kernels`, with `segment_kernel_min_rows` lowered so the
small partitions qualify) and the compiled reduce forced on or off
(`reduce_force_compiled`).  Rows must be equal — integers and strings
exactly, floats to rtol 1e-12 — and so must `explain()`, the plan
fingerprint and `ExecMetrics.segment_routes()`.
"""

import numpy as np
import pytest

pytest.importorskip("pandas")

from repro.core import SharkSession as JaxSession
from repro.core.pde import PDEConfig as JaxPDEConfig
from repro.server.result_cache import plan_fingerprint as jax_fingerprint
from repro_torch.core import SharkSession as TorchSession
from repro_torch.core.columnar import table_from_encoded
from repro_torch.core.pde import PDEConfig as TorchPDEConfig
from repro_torch.core.plan import optimize as torch_optimize
from repro_torch.core.plan import plan_fingerprint as torch_fingerprint
from repro.core.plan import optimize as jax_optimize

from oracle import QueryGen, make_star_data, register_star_tables

N_QUERIES = 24
CONFIGS = {
    "plain": dict(),
    "kernels": dict(segment_force_kernels=True),
    "reduce": dict(reduce_force_compiled=True),
    "kernels+reduce": dict(segment_force_kernels=True,
                           reduce_force_compiled=True),
}
# speculation off: a speculative backup task would tally its partition's
# route a second time, and route counts are compared exactly
SESSION_KW = dict(num_workers=2, max_threads=4, default_partitions=3,
                  default_shuffle_buckets=4, speculation=False)
BLOCK_FIELDS = ("data", "codes", "dictionary", "run_values", "run_lengths",
                "words")


def encoded_partitions(table):
    """A reference Table's blocks as plain numpy arrays and attributes."""
    parts = []
    for p in table.partitions:
        cols = {}
        for name, b in p.columns.items():
            e = b.enc
            cols[name] = {"encoding": e.encoding.value, "bit_width":
                          e.bit_width, "bias": e.bias, "n": e.n,
                          "orig_dtype": e.orig_dtype, "str_dict": b.str_dict,
                          **{k: getattr(e, k) for k in BLOCK_FIELDS}}
        parts.append(cols)
    return parts


def load_twin(jsess, tsess):
    # registration order decides catalog versions, which the fingerprint
    # hashes: replay the reference's order
    for name, t in jsess.catalog._tables.items():
        tsess.catalog.register_table(table_from_encoded(
            name, [(f.name, f.dtype.value) for f in t.schema.fields],
            encoded_partitions(t), distribute_key=t.distribute_key))


@pytest.fixture(scope="module")
def sessions():
    data = make_star_data(seed=0)
    made = {}
    for key, kw in CONFIGS.items():
        cfg = dict(segment_kernel_min_rows=64, **kw)
        js = JaxSession(pde_config=JaxPDEConfig(**cfg), **SESSION_KW)
        register_star_tables(js, data)
        ts = TorchSession(device="cpu", pde_config=TorchPDEConfig(**cfg),
                          **SESSION_KW)
        load_twin(js, ts)
        made[key] = (js, ts)
    yield data, made
    for js, ts in made.values():
        js.shutdown()
        ts.shutdown()


def assert_rows_equal(got, want, sql):
    assert sorted(got) == sorted(want), sql
    for name, w in want.items():
        g = np.asarray(got[name])
        w = np.asarray(w)
        assert g.shape == w.shape, (name, sql)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12,
                                       err_msg=f"{name}: {sql}")
        else:
            assert g.dtype.kind == w.dtype.kind, (name, sql)
            np.testing.assert_array_equal(g, w, err_msg=f"{name}: {sql}")


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("seed", range(N_QUERIES))
def test_slice_matches_reference(sessions, config, seed):
    data, made = sessions
    js, ts = made[config]
    sql = QueryGen(data, seed).gen().sql()
    assert ts.explain(sql) == js.explain(sql)
    jfp = jax_fingerprint(jax_optimize(js.plan(sql), js.catalog), js.catalog)
    tfp = torch_fingerprint(torch_optimize(ts.plan(sql), ts.catalog),
                            ts.catalog)
    assert tfp == jfp
    want = js.sql_np(sql)
    got = ts.sql_np(sql)
    assert_rows_equal(got, want, sql)
    assert (ts.metrics().segment_routes()
            == js.metrics().segment_routes()), sql


def test_forced_kernel_routes_fire(sessions):
    """The forced configuration really takes the five kernel routes on
    the port (plain versions on the CPU)."""
    from repro_torch.core.shuffle import RADIX_KERNEL_CALLS
    data, made = sessions
    js, ts = made["kernels+reduce"]
    radix_before = RADIX_KERNEL_CALLS["count"]
    routes = {}
    for sql in ("SELECT COUNT(*) AS c, SUM(fv) AS s FROM fact "
                "WHERE fv BETWEEN 2 AND 7",
                "SELECT fs, SUM(fv) AS s FROM fact GROUP BY fs",
                "SELECT fn, SUM(fv) AS s, MIN(fv) AS m FROM fact "
                "GROUP BY fn"):
        assert_rows_equal(ts.sql_np(sql), js.sql_np(sql), sql)
        for r, c in ts.metrics().segment_routes().items():
            routes[r] = routes.get(r, 0) + c
    assert routes.get("colscan", 0) + routes.get("fused_decode_scan", 0) > 0
    assert routes.get("groupby_mxu", 0) > 0
    assert routes.get("segmented_merge", 0) > 0
    assert RADIX_KERNEL_CALLS["count"] > radix_before


def test_double_buffered_kernel_dispatch(sessions, monkeypatch):
    """Partitions of at least two chunks run the colscan kernel route (and
    the radix partitioner) chunk by chunk with one launch in flight; the
    answer matches the reference and the dispatch counter moves."""
    from repro_torch.kernels import ops
    data, made = sessions
    js, ts = made["kernels+reduce"]
    monkeypatch.setitem(ops.DOUBLE_BUFFER, "chunk_rows", 64)
    before = ops.DOUBLE_BUFFER["dispatches"]
    for sql in ("SELECT COUNT(*) AS c, SUM(fv) AS s, MIN(fv) AS lo "
                "FROM fact WHERE fn BETWEEN 10 AND 70",
                "SELECT fk1, COUNT(*) AS c FROM fact WHERE fv > 2 "
                "GROUP BY fk1"):
        assert_rows_equal(ts.sql_np(sql), js.sql_np(sql), sql)
    assert ops.DOUBLE_BUFFER["dispatches"] > before
