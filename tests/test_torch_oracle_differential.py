"""Differential testing on the torch port against the JAX reference: the
twin of tests/test_oracle_differential.py, case for case (each seeded query
stays a parametrised case).

Each body runs on both packages (`torch_twin.twin`; the port's sessions on
`device="cpu"`), holds every answer to pandas and across backends as the
reference test does, and the port's answers are held to the reference's
as row multisets (floats to rtol 1e-12).  ORDER BY ... LIMIT answers may
rightly pick different tied rows, so for those queries only the pandas
checks and the sorted order-column values are compared.

The reference's docstring follows.

Differential testing: ~200 seeded random queries (multi-way star joins,
filters, group-by/having, order/limit — see tests/oracle.py) execute on the
engine and on a pure-pandas reference; results must agree.

This is the correctness oracle for the compiled-vectorized-execution
surface: every query runs under BOTH execution backends —

  * ``backend="compiled"``: pipeline segments execute as jit-compiled
    columnar functions (with per-partition kernel/jit/numpy routing), and
  * ``backend="numpy"``: the same segments run the evaluate() oracle —

and both must match pandas AND each other row-identically.  ExecMetrics is
asserted on every query: zero standalone interpreted filter/project
operators on the scan path (the tentpole invariant), and per query
archetype at least one query must actually have taken a compiled route.
"""

import numpy as np
import pytest

pd = pytest.importorskip("pandas")


from oracle import QueryGen, compare, make_star_data
from torch_twin import P, per_pkg, twin


N_QUERIES = 200

SESSION_KW = dict(num_workers=2, max_threads=4, default_partitions=3,
                  default_shuffle_buckets=4)


def _archetypes(query):
    out = []
    if len(query.tables) > 1:
        out.append("join")
    if query.aggs and query.group_by:
        out.append("groupby")
    elif query.aggs:
        out.append("agg")
    else:
        out.append("scan")
    if query.limit is not None:
        out.append("limit")
    return out


_DATA = make_star_data(seed=0)


def _register_star(sess, data) -> None:
    """oracle.register_star_tables with the current package's types."""
    D = P.DType
    sess.create_table("fact", P.Schema.of(
        fk1=D.INT64, fk2=D.INT64, fk3=D.INT64,
        fn=D.INT64, fv=D.FLOAT64, fs=D.STRING), data["fact"])
    sess.create_table("dim1", P.Schema.of(
        pk1=D.INT64, a1=D.INT64, s1=D.STRING), data["dim1"])
    sess.create_table("dim2", P.Schema.of(pk2=D.INT64, a2=D.INT64),
                      data["dim2"])
    sess.create_table("dim3", P.Schema.of(pk3=D.INT64, a3=D.FLOAT64),
                      data["dim3"])


def _unlimited(seed):
    """Whether seed's query has no LIMIT (its answers are then the same
    rows in both packages)."""
    return QueryGen(_DATA, seed).gen().limit is None


def _shutdown(envs, n):
    for e in envs.values():
        for s in e[:n]:
            s.shutdown()


@pytest.fixture(scope="module")
def env():
    envs = per_pkg(_make_env)
    yield envs
    _shutdown(envs, 2)


def _make_env():
    data = make_star_data(seed=0)
    sess_c = P.SharkSession(backend="compiled", **SESSION_KW)
    sess_n = P.SharkSession(backend="numpy", **SESSION_KW)
    _register_star(sess_c, data)
    _register_star(sess_n, data)
    dfs = {name: pd.DataFrame({k: v for k, v in cols.items()})
           for name, cols in data.items()}
    coverage = {}   # archetype -> compiled partitions observed
    return sess_c, sess_n, data, dfs, coverage


def _rows(got, names):
    arrays = []
    for n in names:
        a = np.asarray(got[n])
        arrays.append(a.tolist())
    return sorted(zip(*arrays)) if arrays else []


def assert_backend_parity(query, got_c, got_n, sql):
    """Compiled and numpy backends must produce row-identical results:
    exact on ints/bools/strings, to rounding on floats (XLA may reorder
    float reductions)."""
    names = (query.group_by + [a.alias for a in query.aggs]
             if query.aggs else list(query.select_cols))
    assert bool(got_c) == bool(got_n), f"one backend returned nothing\n  {sql}"
    if not got_c:
        return
    rows_c = _rows(got_c, names)
    rows_n = _rows(got_n, names)
    assert len(rows_c) == len(rows_n), \
        f"row counts differ: {len(rows_c)} vs {len(rows_n)}\n  {sql}"
    for rc, rn in zip(rows_c, rows_n):
        for vc, vn, name in zip(rc, rn, names):
            if isinstance(vn, float):
                # vc == vn first: covers the ±inf identity sentinels of
                # MIN/MAX over empty inputs (inf - inf is nan)
                assert vc == vn or abs(vc - vn) <= 1e-9 + 1e-9 * abs(vn), \
                    f"{name}: {vc!r} != {vn!r}\n  {sql}"
            else:
                assert vc == vn, f"{name}: {vc!r} != {vn!r}\n  {sql}"


def _run_one(env, seed):
    sess_c, sess_n, data, dfs, coverage = env
    query = QueryGen(data, seed).gen()
    sql = query.sql()
    got_c = sess_c.sql_np(sql)
    mc = sess_c.metrics()
    # the tentpole invariant: the scan path never runs interpreted
    # operator-at-a-time filter/project
    assert mc.interpreted_scan_ops == 0, sql
    if len(query.tables) == 1:
        assert len(mc.segments) >= 1, \
            f"single-table SELECT did not go through a PipelineSegment\n  {sql}"
    got_n = sess_n.sql_np(sql)
    assert sess_n.metrics().interpreted_scan_ops == 0, sql
    assert sess_n.metrics().compiled_partitions() == 0, \
        f"numpy backend took a compiled route\n  {sql}"
    for arch in _archetypes(query):
        coverage[arch] = coverage.get(arch, 0) + mc.compiled_partitions()
    return query, sql, got_c, got_n


def _random_query_matches_pandas(env, seed):
    _, _, _, dfs, _ = env
    query, sql, got_c, got_n = _run_one(env, seed)
    ref = query.pandas(dfs)
    compare(query, got_c, ref)
    compare(query, got_n, ref)
    assert_backend_parity(query, got_c, got_n, sql)
    return _observed(query, got_c)


def _observed(query, got):
    """What both packages must agree on: the answer, or under LIMIT the
    row count and the sorted values of the ORDER BY column."""
    if query.limit is None:
        return got
    n = len(next(iter(got.values()))) if got else 0
    if query.order_by is None:
        return n
    return n, np.sort(np.asarray(got[query.order_by[0]]))


@pytest.mark.parametrize("seed", range(N_QUERIES))
def test_random_query_matches_pandas(env, seed):
    twin(_random_query_matches_pandas, env, seed, rows=True,
         record=_unlimited(seed))


def _compiled_path_taken_per_archetype(env):
    """≥1 query per archetype must actually have executed on a compiled
    route (jit or kernel), observed via ExecMetrics."""
    _, _, _, _, coverage = env
    required = ("scan", "join", "agg", "groupby", "limit")
    if any(coverage.get(a, 0) == 0 for a in required):
        # standalone / partial-selection run: generate coverage ourselves
        for seed in range(60):
            _run_one(env, seed)
    for arch in required:
        assert coverage.get(arch, 0) > 0, \
            f"archetype {arch!r} never took the compiled path: {coverage}"
    return sorted(a for a in required if coverage.get(a, 0) > 0)


def test_compiled_path_taken_per_archetype(env):
    twin(_compiled_path_taken_per_archetype, env)


N_EXCHANGE_SEEDS = 60


@pytest.fixture(scope="module")
def exchange_env(env):
    envs = per_pkg(_make_exchange_env, env)
    yield envs
    _shutdown(envs, 2)


def _make_exchange_env(env):
    """Two more executors over the SAME data: the compiled reduce path
    FORCED ON over the dictionary-preserving exchange, and the legacy
    decoded exchange with the numpy backend (compiled reduce forced off) —
    the two extremes of the new exchange surface (DESIGN.md §11)."""
    PDEConfig = P.m("core.pde").PDEConfig
    _, _, data, dfs, _ = env
    sess_f = P.SharkSession(backend="compiled", exchange="coded",
                          pde_config=PDEConfig(reduce_force_compiled=True),
                          **SESSION_KW)
    sess_l = P.SharkSession(backend="numpy", exchange="decoded", **SESSION_KW)
    _register_star(sess_f, data)
    _register_star(sess_l, data)
    return sess_f, sess_l, data, dfs


def _compiled_reduce_forced_on_off_parity(exchange_env, seed):
    """Row-identical parity between the forced compiled reduce path (coded
    exchange) and the fully interpreted legacy path (decoded exchange,
    numpy backend), both checked against pandas."""
    sess_f, sess_l, data, dfs = exchange_env
    query = QueryGen(data, seed).gen()
    sql = query.sql()
    got_f = sess_f.sql_np(sql)
    got_l = sess_l.sql_np(sql)
    ref = query.pandas(dfs)
    compare(query, got_f, ref)
    compare(query, got_l, ref)
    assert_backend_parity(query, got_f, got_l, sql)
    # the forced session must never take a numpy reduce route
    for s in sess_f.metrics().segments:
        if s.consumer in ("merge_aggregate", "join_probe"):
            assert s.routes.get("numpy", 0) == s.fallbacks, s.describe()
    return _observed(query, got_f)


@pytest.mark.parametrize("seed", range(N_EXCHANGE_SEEDS))
def test_compiled_reduce_forced_on_off_parity(exchange_env, seed):
    twin(_compiled_reduce_forced_on_off_parity, exchange_env, seed,
         rows=True, record=_unlimited(seed))


N_STORAGE_SEEDS = 40


@pytest.fixture(scope="module")
def storage_env(env):
    envs = per_pkg(_make_storage_env, env)
    yield envs
    _shutdown(envs, 2)


def _make_storage_env(env):
    """Two more executors over the SAME data for the storage tier
    (DESIGN.md §12): compressed-domain execution forced ON over adaptively
    recompressed blocks (FOR/RLE layouts produced by the WARM-tier pass),
    and forced OFF (every block decodes before the segment runs).  Wrong
    code-bound translation or run-level aggregation shows up here as a
    parity break against pandas or against the decoded twin."""
    PDEConfig = P.m("core.pde").PDEConfig
    _, _, data, dfs, _ = env
    sess_on = P.SharkSession(backend="compiled",
                           pde_config=PDEConfig(compressed_domain=True),
                           **SESSION_KW)
    sess_off = P.SharkSession(backend="compiled",
                            pde_config=PDEConfig(compressed_domain=False),
                            **SESSION_KW)
    _register_star(sess_on, data)
    _register_star(sess_off, data)
    # Force FOR / RLE layouts onto numeric columns (the star columns are
    # narrow-range, so adaptive recompression would pick BITPACK and the
    # grid would never touch the compressed-domain routes).  Predicates the
    # grid generates against these columns now hit the code-bound and
    # run-level paths in the cd-on session.
    Encoding = P.m("core.compression").Encoding
    encode = P.m("core.compression").encode
    force = {"fact": {"fn": Encoding.FOR, "fk2": Encoding.FOR,
                      "fk3": Encoding.RLE},
             "dim1": {"a1": Encoding.RLE},
             "dim2": {"a2": Encoding.RLE}}
    for sess in (sess_on, sess_off):
        for tname, cols in force.items():
            for part in sess.catalog.get(tname).partitions:
                for cname, target in cols.items():
                    blk = part._columns[cname]
                    blk.enc = encode(blk.values(), target)
                    blk.drop_decoded()
    return sess_on, sess_off, data, dfs


def _compressed_domain_forced_on_off_parity(storage_env, seed):
    """Row-identical parity between compressed-domain execution (range
    predicates on FOR codes, run-level RLE scans) and decode-first
    execution, both checked against pandas."""
    sess_on, sess_off, data, dfs = storage_env
    query = QueryGen(data, seed).gen()
    sql = query.sql()
    got_on = sess_on.sql_np(sql)
    got_off = sess_off.sql_np(sql)
    ref = query.pandas(dfs)
    compare(query, got_on, ref)
    compare(query, got_off, ref)
    assert_backend_parity(query, got_on, got_off, sql)
    # forced OFF must never take a compressed-domain route
    for s in sess_off.metrics().segments:
        assert s.routes.get("for-colscan", 0) == 0, s.describe()
        assert s.routes.get("rle-scan", 0) == 0, s.describe()
    return _observed(query, got_on)


@pytest.mark.parametrize("seed", range(N_STORAGE_SEEDS))
def test_compressed_domain_forced_on_off_parity(storage_env, seed):
    twin(_compressed_domain_forced_on_off_parity, storage_env, seed,
         rows=True, record=_unlimited(seed))


def _compressed_domain_routes_fire_on_forced_layouts(storage_env):
    """The random grid rarely draws the exact colscan shape, so pin it:
    a range predicate over a FOR column and an RLE column must take the
    code-bound / run-level routes when forced on, the decoded routes when
    forced off, and agree either way."""
    sess_on, sess_off, _, _ = storage_env
    cases = [
        ("SELECT COUNT(*) AS c, SUM(fv) AS s FROM fact "
         "WHERE fn BETWEEN 20 AND 70", "for-colscan"),
        # fact, not a dim: partitions must clear the 64-row compiled
        # threshold; AVG not SUM: int64 SUM keeps integer accumulators and
        # is excluded from kernel colscan shapes
        ("SELECT COUNT(*) AS c, AVG(fk3) AS m FROM fact "
         "WHERE fk3 BETWEEN 2 AND 9", "rle-scan"),
    ]
    for sql, route in cases:
        got_on = sess_on.sql_np(sql)
        assert route in sess_on.metrics().segment_routes(), \
            f"{route} never fired for {sql}: " \
            f"{sess_on.metrics().segment_routes()}"
        got_off = sess_off.sql_np(sql)
        assert route not in sess_off.metrics().segment_routes()
        for k in got_on:
            np.testing.assert_allclose(got_on[k], got_off[k], rtol=1e-12)


def test_compressed_domain_routes_fire_on_forced_layouts(storage_env):
    twin(_compressed_domain_routes_fire_on_forced_layouts, storage_env)


def _oracle_grid_covers_multiway_joins(env):
    """The seeded grid must actually exercise the tentpole surface: 3-way
    and 4-way joins, both join styles, grouping, having, and limits."""
    sess_c, _, data, dfs, _ = env
    queries = [QueryGen(data, s).gen() for s in range(N_QUERIES)]
    n_tables = {len(q.tables) for q in queries}
    assert {3, 4} <= n_tables, f"join-depth coverage hole: {n_tables}"
    styles = {q.join_style for q in queries if len(q.tables) > 2}
    assert styles == {"explicit", "comma"}
    assert any(q.having is not None for q in queries)
    assert any(q.limit is not None and q.aggs for q in queries)
    assert any(q.limit is not None and not q.aggs for q in queries)
    return [q.sql() for q in queries]


def test_oracle_grid_covers_multiway_joins(env):
    twin(_oracle_grid_covers_multiway_joins, env)


# -- whole-stage fusion differential (DESIGN.md §14) --------------------------

N_FUSION_SEEDS = 60


@pytest.fixture(scope="module")
def fusion_env(env):
    envs = per_pkg(_make_fusion_env, env)
    yield envs
    _shutdown(envs, 2)


def _make_fusion_env(env):
    """Three-way fusion differential over the SAME data: whole-stage
    compilation FORCED (every eligible partition runs the fused stage
    program), fusion OFF (the segment-at-a-time path with its host seams —
    the semantic oracle for the fused path), and the fully interpreted
    numpy backend from `env`.  All three must agree row-identically."""
    _, sess_n, data, dfs, _ = env
    sess_ws = P.SharkSession(backend="compiled", exchange="coded",
                           stage_fusion="force", **SESSION_KW)
    sess_seam = P.SharkSession(backend="compiled", exchange="coded",
                             stage_fusion="off", **SESSION_KW)
    _register_star(sess_ws, data)
    _register_star(sess_seam, data)
    fusion_coverage = {}   # archetype -> fused (whole-stage) partitions
    return sess_ws, sess_seam, sess_n, data, dfs, fusion_coverage


def _run_one_fused(fusion_env, seed):
    sess_ws, sess_seam, sess_n, data, dfs, fusion_coverage = fusion_env
    query = QueryGen(data, seed).gen()
    sql = query.sql()
    got_ws = sess_ws.sql_np(sql)
    mws = sess_ws.metrics()
    # fused partitions surface as the synthetic "whole-stage" route key and
    # never as interpreted scan work
    assert mws.interpreted_scan_ops == 0, sql
    routes = mws.segment_routes()
    assert routes.get("whole-stage", 0) == mws.fused_partitions(), sql
    got_seam = sess_seam.sql_np(sql)
    mseam = sess_seam.metrics()
    assert mseam.interpreted_scan_ops == 0, sql
    assert mseam.fused_partitions() == 0, \
        f"stage_fusion='off' still fused a stage\n  {sql}"
    assert "whole-stage" not in mseam.segment_routes(), sql
    got_n = sess_n.sql_np(sql)
    assert sess_n.metrics().fused_partitions() == 0, sql
    for arch in _archetypes(query):
        fusion_coverage[arch] = (fusion_coverage.get(arch, 0)
                                 + mws.fused_partitions())
    return query, sql, got_ws, got_seam, got_n


def _stage_fusion_forced_on_off_parity(fusion_env, seed):
    """Whole-stage FORCED vs segment-at-a-time vs fully interpreted: all
    three row-identical to each other and to pandas."""
    _, _, _, _, dfs, _ = fusion_env
    query, sql, got_ws, got_seam, got_n = _run_one_fused(fusion_env, seed)
    ref = query.pandas(dfs)
    compare(query, got_ws, ref)
    compare(query, got_seam, ref)
    compare(query, got_n, ref)
    assert_backend_parity(query, got_ws, got_seam, sql)
    assert_backend_parity(query, got_ws, got_n, sql)
    return _observed(query, got_ws)


@pytest.mark.parametrize("seed", range(N_FUSION_SEEDS))
def test_stage_fusion_forced_on_off_parity(fusion_env, seed):
    twin(_stage_fusion_forced_on_off_parity, fusion_env, seed, rows=True,
         record=_unlimited(seed))


def _whole_stage_route_fired_per_archetype(fusion_env):
    """The whole-stage route must actually fire for every archetype with a
    shuffle boundary (join exchanges, global aggregates, group-bys, limits;
    plain scans have no map stage to fuse).  Aggregated across seeds —
    individual seeds may legitimately fall back (tiny partitions, numpy
    oracle rungs)."""
    _, _, _, _, _, fusion_coverage = fusion_env
    required = ("join", "agg", "groupby", "limit")
    if any(fusion_coverage.get(a, 0) == 0 for a in required):
        # standalone / partial-selection run: generate coverage ourselves
        for seed in range(N_FUSION_SEEDS):
            _run_one_fused(fusion_env, seed)
    for arch in required:
        assert fusion_coverage.get(arch, 0) > 0, \
            f"archetype {arch!r} never fused a whole stage: {fusion_coverage}"
    return sorted(a for a in required if fusion_coverage.get(a, 0) > 0)


def test_whole_stage_route_fired_per_archetype(fusion_env):
    twin(_whole_stage_route_fired_per_archetype, fusion_env)


