"""The cluster tier's mesh-sharded execution on the torch port against the
JAX reference: the twin of tests/test_cluster.py, and the port's own cases.

Each twin body runs on both packages (`torch_twin.twin`): the reference on
its XLA devices (one in this process), the port on as many CPU slots
(`pk.mesh(n)`, `MeshContext(devices=[cpu] * n)`); the body asserts what
its reference test asserts, and the port's answers (rtol 1e-9, the
reference test's own tolerance), mesh routes and reports must equal the
reference's.  The reference's multi-device cases (`TestMultiDevice`, the
multi-device body of `test_generation_bumps_and_mesh_shrinks_on_kill`)
skip on one XLA device; here their bodies run on the port at 4 and 8 CPU
slots against the port's single-host session (`mesh=None`).
`test_exchange_equals_reference_on_four_devices` runs the reference on 4
XLA devices in a subprocess and holds the port's 4-slot exchange and
colscan to it exactly.  The `cuda`-marked tests run on a card only: 4
slots sharing `cuda:0` against 4 CPU slots, and the launches a dispatch.
The reference's docstring follows.

Cluster tier — mesh-sharded execution (DESIGN.md §13.1).

The oracle grid is the tentpole invariant: with mesh sharding ON the
engine must return ROW-IDENTICAL results (same order, same dtypes, values
to float tolerance) to the single-host path, and explain()/plan
fingerprints must be byte-identical — placement is physical-layer state.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

try:
    import jax
    N_DEV = len(jax.devices())
except ImportError:      # a GPU host without JAX runs the cuda tests alone
    N_DEV = 1

from torch_twin import TORCH, P, twin

SLOTS = (4, 8)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(n=50_000, seed=7):
    rng = np.random.default_rng(seed)
    return {
        "k": rng.integers(0, 40, n).astype(np.int64),
        "k32": rng.integers(0, 500, n).astype(np.int32),
        "x": rng.uniform(-100.0, 100.0, n),
        "v": rng.uniform(0.0, 10.0, n),
        "i32": rng.integers(0, 1000, n).astype(np.int32),
        "s": rng.choice(np.array(["ca", "ny", "tx", "wa"]), n),
    }


def _schema():
    return P.Schema.of(k=P.DType.INT64, k32=P.DType.INT32,
                       x=P.DType.FLOAT64, v=P.DType.FLOAT64,
                       i32=P.DType.INT32, s=P.DType.STRING)


def _session(mesh, parts=12):
    sess = P.SharkSession(num_workers=4, default_partitions=parts, mesh=mesh)
    sess.create_table("t", _schema(), _data())
    return sess


# the differential grid: every aggregate shape the mesh routes handle plus
# shapes that must take the single-host route
GRID = [
    "SELECT COUNT(*) AS c FROM t WHERE x BETWEEN -20 AND 60",
    "SELECT COUNT(*) AS c, SUM(v) AS sv, MIN(v) AS mn, MAX(v) AS mx "
    "FROM t WHERE x BETWEEN -20 AND 60",
    "SELECT AVG(v) AS a FROM t WHERE x >= 10",
    "SELECT SUM(i32) AS si FROM t WHERE x < 0",
    "SELECT k, COUNT(*) AS c, SUM(v) AS sv FROM t GROUP BY k",
    "SELECT k, AVG(v) AS a FROM t GROUP BY k",
    "SELECT k32, SUM(i32) AS si FROM t GROUP BY k32",
    # single-host routes: multi-col predicate, string group key, string
    # aggregate input, int64 SUM exactness, expression argument
    "SELECT COUNT(*) AS c FROM t WHERE v > 5 AND x < 0",
    "SELECT s, COUNT(*) AS c FROM t GROUP BY s",
    "SELECT COUNT(DISTINCT s) AS d FROM t WHERE x > 0",
    "SELECT k, SUM(k) AS sk FROM t GROUP BY k",
    "SELECT SUM(v + 1.0) AS sv FROM t WHERE x > 0",
]
MESH_ROUTES = ("mesh-colscan", "mesh-exchange")


def _mesh_routes(sess):
    routes = sess.metrics().segment_routes()
    return {r: routes.get(r, 0) for r in MESH_ROUTES}


def _on_vs_off(on, off):
    """The reference test's grid assertions; per query, its mesh routes
    and metrics."""
    mesh_routed = 0
    seen = []
    for q in GRID:
        r1, r0 = on.sql_np(q), off.sql_np(q)
        assert list(r1) == list(r0), q
        for c in r0:
            a1, a0 = r1[c], r0[c]
            assert a1.dtype == a0.dtype, (q, c, a1.dtype, a0.dtype)
            assert a1.shape == a0.shape, (q, c)
            if a0.dtype.kind in "iuU":
                # integer and string columns exactly, IN ORDER
                assert np.array_equal(a1, a0), (q, c)
            else:
                assert np.allclose(a1, a0, rtol=1e-9, atol=1e-9), (q, c)
        routes = _mesh_routes(on)
        mesh_routed += sum(routes.values())
        m = on.metrics()
        seen.append([routes, m.mesh_partitions, m.mesh_devices,
                     m.mesh_shipped_rows])
    # the grid must actually exercise the mesh, not take the host route
    # everywhere (7 eligible queries x >= 1 routed partition)
    assert mesh_routed >= 7, mesh_routed
    return seen


class TestMeshOracleGrid:
    def _mesh_on_vs_off_row_identical(self):
        on, off = _session(P.mesh(N_DEV)), _session(None)
        try:
            return _on_vs_off(on, off)
        finally:
            on.shutdown()
            off.shutdown()

    def test_mesh_on_vs_off_row_identical(self):
        twin(self._mesh_on_vs_off_row_identical, rtol=1e-9)

    @pytest.mark.parametrize("n", SLOTS)
    def test_mesh_on_vs_off_row_identical_on_slots(self, n):
        P.pkg = TORCH
        on, off = _session(TORCH.mesh(n)), _session(None)
        try:
            seen = _on_vs_off(on, off)
        finally:
            on.shutdown()
            off.shutdown()
        # the eligible shapes ran on all n slots
        assert [s[2] for s in seen[:7]] == [n] * 7, seen

    def _fallback_queries_take_host_routes(self):
        on = _session(P.mesh(N_DEV))
        try:
            for q in GRID[7:]:
                on.sql_np(q)
                routes = on.metrics().segment_routes()
                assert "mesh-colscan" not in routes, q
                assert "mesh-exchange" not in routes, q
            return on.metrics().mesh_partitions
        finally:
            on.shutdown()

    def test_fallback_queries_take_host_routes(self):
        twin(self._fallback_queries_take_host_routes, rtol=1e-9)

    def _explain_and_fingerprint_identical_with_sharding(self):
        plan_fingerprint = P.m("server.result_cache").plan_fingerprint
        optimize = P.m("core.plan").optimize
        on, off = _session(P.mesh(N_DEV)), _session(None)
        try:
            out = []
            for q in GRID:
                assert on.explain(q) == off.explain(q), q
                n1 = optimize(on.plan(q), on.catalog)
                n0 = optimize(off.plan(q), off.catalog)
                fp1, _ = plan_fingerprint(n1, on.catalog)
                fp0, _ = plan_fingerprint(n0, off.catalog)
                assert fp1 == fp0, q
                out.append([on.explain(q), fp1])
            return out
        finally:
            on.shutdown()
            off.shutdown()

    def test_explain_and_fingerprint_identical_with_sharding(self):
        twin(self._explain_and_fingerprint_identical_with_sharding)


class TestMeshPlacement:
    def _round_robin_over_alive_slots(self, ctx):
        p = ctx.place(10)
        n = len(ctx.devices)
        assert p.device_of == tuple(i % n for i in range(10))
        assert p.n_devices == n
        return [list(p.device_of), p.n_devices, p.parts_per_device,
                p.generation]

    def test_round_robin_over_alive_slots(self):
        twin(lambda: self._round_robin_over_alive_slots(P.mesh(N_DEV)))

    @pytest.mark.parametrize("n", SLOTS)
    def test_round_robin_over_alive_slots_on_slots(self, n):
        got = self._round_robin_over_alive_slots(TORCH.mesh(n))
        assert got[2] == -(-10 // n)

    @pytest.mark.parametrize("n", SLOTS)
    def test_generation_bumps_and_mesh_shrinks_on_kill(self, n):
        """The reference body (it skips on one XLA device), on n CPU
        slots; the port's mesh is the alive slots' devices of a placement
        (`slot_devices`)."""
        ctx = TORCH.mesh(n)
        g0 = ctx.generation
        ctx.kill_device(1)
        assert ctx.generation == g0 + 1
        assert 1 not in ctx.alive_slots()
        p = ctx.place(n)
        assert len(ctx.slot_devices(p)) == n - 1
        assert p.generation == ctx.generation
        p = ctx.place(6)
        assert all(s != 1 for s in (p.alive_slots[d] for d in p.device_of))

    def _cannot_kill_last_device(self):
        ctx = P.mesh(1)
        with pytest.raises(RuntimeError):
            ctx.kill_device(0)
        return ctx.stats()

    def test_cannot_kill_last_device(self):
        twin(self._cannot_kill_last_device)


def _exchange_input(seed=5, parts=13, hi=64, with_vals=True,
                    dtype=np.int64):
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, hi, n).astype(dtype)
            for n in rng.integers(10, 400, parts)]
    vals = ([rng.uniform(0, 5, k.shape[0]) for k in keys] if with_vals
            else None)
    return keys, vals


def _exchange_partitions_by_key(ctx):
    """The reference test's assertions over one exchange of `ctx`."""
    n_dev = len(ctx.devices)
    keys, vals = _exchange_input()
    out, rep = P.m("cluster.shard_exec").mesh_group_exchange(ctx, keys, vals)
    assert rep["devices"] == n_dev
    allk = np.concatenate(keys)
    gotk = np.concatenate([k for k, _ in out])
    assert sorted(allk.tolist()) == sorted(gotk.tolist())
    owner = {}
    for d, (k, _) in enumerate(out):
        for kk in set(k.tolist()):
            assert owner.setdefault(kk, d) == d, "key on two devices"
    # per-key value sums survive the exchange
    want, got = {}, {}
    for k, v in zip(allk, np.concatenate(vals)):
        want[int(k)] = want.get(int(k), 0.0) + v
    for kd, vd in out:
        for k, v in zip(kd, vd):
            got[int(k)] = got.get(int(k), 0.0) + v
    for k in want:
        assert np.isclose(want[k], got[k])
    return [[k, v] for k, v in out], rep["counts"], rep["shipped_rows"]


def _mirror_counts(keys, n_dev):
    """The reference's host mirror (shard_exec.py:234-240): per source
    slot, the bincount of `mix_u32(fold_keys_u32(k)) % n`, over the
    round-robin placement."""
    from repro_torch.kernels.radix_partition import (fold_keys_u32,
                                                     radix_partition_ref)
    counts = np.zeros((n_dev, n_dev), np.int64)
    for s in range(n_dev):
        ks = [k for p, k in enumerate(keys) if p % n_dev == s]
        if ks:
            k = np.concatenate(ks).astype(np.int64)
            ids = radix_partition_ref(fold_keys_u32(k), n_dev)[0]
            counts[s] = np.bincount(ids, minlength=n_dev)
    return counts


class TestMeshExchange:
    def test_exchange_partitions_by_key_and_preserves_rows(self):
        twin(lambda: _exchange_partitions_by_key(P.mesh(N_DEV)))

    @pytest.mark.parametrize("n", SLOTS)
    def test_exchange_partitions_by_key_on_slots(self, n):
        P.pkg = TORCH
        out, counts, shipped = _exchange_partitions_by_key(TORCH.mesh(n))
        keys, _ = _exchange_input()
        assert np.array_equal(counts, _mirror_counts(keys, n))
        assert shipped == counts.sum() - np.trace(counts) > 0

    def _host_mirror_counts_match_device_hash(self, ctx):
        rng = np.random.default_rng(6)
        keys = [rng.integers(0, 1000, 300).astype(np.int64)
                for _ in range(5)]
        out, rep = P.m("cluster.shard_exec").mesh_group_exchange(ctx, keys,
                                                                 None)
        counts = rep["counts"]
        assert counts.sum() == sum(k.shape[0] for k in keys)
        # received rows per device == the mirror's column sums
        for d, (kd, vd) in enumerate(out):
            assert vd is None
            assert kd.shape[0] == int(counts[:, d].sum())
        return counts, [kd for kd, _ in out]

    def test_host_mirror_counts_match_device_hash(self):
        twin(lambda: self._host_mirror_counts_match_device_hash(
            P.mesh(N_DEV)))

    @pytest.mark.parametrize("n", SLOTS)
    def test_host_mirror_counts_match_device_hash_on_slots(self, n):
        P.pkg = TORCH
        counts, _ = self._host_mirror_counts_match_device_hash(TORCH.mesh(n))
        rng = np.random.default_rng(6)
        keys = [rng.integers(0, 1000, 300).astype(np.int64)
                for _ in range(5)]
        assert np.array_equal(counts, _mirror_counts(keys, n))


# -- the reference's multi-device cases, on the port's CPU slots ---------------


def _port_session(mesh):
    P.pkg = TORCH
    return _session(mesh)


@pytest.mark.parametrize("n", SLOTS)
class TestMultiDevice:
    def test_runs_on_many_devices(self, n):
        mesh = TORCH.mesh(n)
        assert len(mesh.devices) == mesh.n_alive == n >= 2

    def test_exchange_ships_rows_across_devices(self, n):
        on, off = _port_session(TORCH.mesh(n)), _port_session(None)
        try:
            q = "SELECT k, SUM(v) AS sv FROM t GROUP BY k"
            got, want = on.sql_np(q), off.sql_np(q)
            m = on.metrics()
            assert m.mesh_devices == n
            assert m.mesh_shipped_rows > 0      # buckets crossed slots
            assert m.mesh_partitions == 12
            assert np.array_equal(got["k"], want["k"])
            assert np.allclose(got["sv"], want["sv"], rtol=1e-9)
        finally:
            on.shutdown()
            off.shutdown()

    def test_device_loss_mid_query_recomputes_identically(self, n):
        mesh = TORCH.mesh(n)
        on, off = _port_session(mesh), _port_session(None)
        DeviceLost = TORCH.mod("cluster").DeviceLost
        try:
            q = "SELECT k, COUNT(*) AS c, SUM(v) AS sv FROM t GROUP BY k"
            expect = off.sql_np(q)

            fired = []

            def killer(ctx, ordinal):
                if not fired:
                    fired.append(ordinal)
                    victim = ctx.alive_slots()[-1]
                    ctx.kill_device(victim)
                    raise DeviceLost(victim)

            mesh.on_dispatch = killer
            got = on.sql_np(q)
            assert mesh.retries >= 1
            assert on.metrics().mesh_retries >= 1
            assert on.metrics().mesh_devices == n - 1
            assert np.array_equal(got["k"], expect["k"])
            assert np.array_equal(got["c"], expect["c"])
            assert np.allclose(got["sv"], expect["sv"], rtol=1e-9)
        finally:
            on.shutdown()
            off.shutdown()

    def test_colscan_shards_partitions_across_devices(self, n):
        mesh = TORCH.mesh(n)
        on, off = _port_session(mesh), _port_session(None)
        try:
            q = ("SELECT COUNT(*) AS c, SUM(v) AS sv FROM t "
                 "WHERE x BETWEEN -50 AND 50")
            got, want = on.sql_np(q), off.sql_np(q)
            m = on.metrics()
            assert m.mesh_partitions == 12
            assert m.mesh_devices == n
            assert m.mesh_shipped_rows == 0     # colscan needs no exchange
            p = mesh.place(12)
            assert len(set(p.device_of)) == min(n, 12)
            assert np.array_equal(got["c"], want["c"])
            assert np.allclose(got["sv"], want["sv"], rtol=1e-9)
        finally:
            on.shutdown()
            off.shutdown()


# -- the exchange against the reference's on 4 XLA devices ---------------------

_REFERENCE_4 = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
import numpy as np
sys.path.insert(0, os.path.join(sys.argv[2], "tests"))
from test_torch_cluster import exchange_cases
from repro.cluster import MeshContext, shard_exec
ctx = MeshContext()
assert len(ctx.devices) == 4, ctx.devices
dump = {}
for name, (keys, vals, fcols, acols, lo, hi) in exchange_cases().items():
    out, rep = shard_exec.mesh_group_exchange(ctx, keys, vals)
    dump[name + ".counts"] = rep["counts"]
    for d, (k, v) in enumerate(out):
        dump[f"{name}.k{d}"] = k
        if v is not None:
            dump[f"{name}.v{d}"] = v
    states, rep = shard_exec.mesh_colscan(ctx, fcols, acols, lo, hi)
    dump[name + ".states"] = np.array(states, np.float64)
np.savez(sys.argv[1], **dump)
print("REFERENCE_OK")
"""


def exchange_cases():
    """13 ragged partitions: int64 and int32 keys, with and without
    values; each case's colscan over float64 filter / aggregate columns
    (NaN filter values and an empty partition included)."""
    out = {}
    for name, dtype, with_vals in (("i64v", np.int64, True),
                                   ("i64", np.int64, False),
                                   ("i32v", np.int32, True),
                                   ("i32", np.int32, False)):
        keys, vals = _exchange_input(seed=21, parts=13, hi=1 << 20,
                                     with_vals=with_vals, dtype=dtype)
        keys[3] = keys[3] - (1 << 19)           # negative keys fold too
        rng = np.random.default_rng(22)
        fcols = [rng.uniform(-100, 100, k.shape[0]) for k in keys]
        fcols[5][::7] = np.nan
        fcols[7] = fcols[7][:0]
        acols = [rng.uniform(0, 10, f.shape[0]) for f in fcols]
        out[name] = (keys, vals, fcols, acols, -20.0, 60.0)
    return out


def test_exchange_equals_reference_on_four_devices(tmp_path):
    """The reference's 4-device `shard_map` exchange and colscan against
    the port's 4 CPU slots: per-slot keys, order and counts exactly,
    values bit for bit, partial states to rtol 1e-12."""
    path = str(tmp_path / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _REFERENCE_4, path, REPO],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert run.returncode == 0 and "REFERENCE_OK" in run.stdout, \
        run.stdout + run.stderr
    ref = np.load(path)
    shard_exec = TORCH.mod("cluster.shard_exec")
    ctx = TORCH.mesh(4)
    for name, (keys, vals, fcols, acols, lo, hi) in exchange_cases().items():
        out, rep = shard_exec.mesh_group_exchange(ctx, keys, vals)
        np.testing.assert_array_equal(rep["counts"], ref[name + ".counts"])
        assert rep["shipped_rows"] > 0
        for d, (k, v) in enumerate(out):
            want = ref[f"{name}.k{d}"]
            assert k.dtype == want.dtype == keys[0].dtype, name
            np.testing.assert_array_equal(k, want, err_msg=f"{name} {d}")
            if vals is None:
                assert v is None
            else:
                assert v.dtype == ref[f"{name}.v{d}"].dtype
                assert v.tobytes() == ref[f"{name}.v{d}"].tobytes(), \
                    f"{name} {d}"
        states, _ = shard_exec.mesh_colscan(ctx, fcols, acols, lo, hi)
        np.testing.assert_allclose(np.array(states, np.float64),
                                   ref[name + ".states"], rtol=1e-12,
                                   atol=0)


# -- the port's own cases ------------------------------------------------------


def test_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TORCH.mod("cluster").MeshContext()


def test_slots_of_another_device_type_raise():
    MeshContext = TORCH.mod("cluster").MeshContext
    mesh = MeshContext(devices=["meta"] * 2)
    with pytest.raises(ValueError, match="meta devices but the engine "
                                         "computes on cpu"):
        TORCH.session(mesh=mesh)
    with pytest.raises(ValueError, match="computes on cpu"):
        TORCH.server(mesh=mesh)
    with pytest.raises(ValueError, match="several device types"):
        MeshContext(devices=["cpu", "meta"])


def test_mesh_group_by_over_spilled_partitions(tmp_path):
    """A mesh server with a storage tier under a tight budget answers a
    group-by and a range scan as the unlimited-budget server does, its map
    sides on the mesh while partitions spill and fault back."""
    rng = np.random.default_rng(12)
    n = 120_000
    data = {"k": rng.integers(0, 64, n).astype(np.int64),
            "x": rng.uniform(-100.0, 100.0, n),
            "v": rng.uniform(0.0, 10.0, n)}
    schema = TORCH.schema(k="INT64", x="FLOAT64", v="FLOAT64")
    queries = ["SELECT k, SUM(v) AS s, COUNT(*) AS c FROM t GROUP BY k",
               "SELECT COUNT(*) AS c, SUM(v) AS s FROM t "
               "WHERE x BETWEEN -30 AND 45"]

    def serve(**kw):
        srv = TORCH.server(num_workers=2, max_threads=2,
                           enable_result_cache=False, default_partitions=8,
                           default_shuffle_buckets=8, **kw)
        srv.create_table("t", schema, data)
        return srv

    ref = serve()
    try:
        want = [ref.sql_np(q) for q in queries]
    finally:
        ref.shutdown()
    mesh = TORCH.mesh(4)
    srv = serve(mesh=mesh, spill_dir=str(tmp_path), spill_mode="spill",
                cache_budget_bytes=1_000_000)
    try:
        for _ in range(2):
            for q, w in zip(queries, want):
                res = srv.sql(q)
                got = res.to_numpy()
                assert sorted(got) == sorted(w)
                for c in w:
                    np.testing.assert_allclose(got[c], w[c], rtol=1e-9)
                assert res.metrics.mesh_partitions == 8
                assert res.metrics.mesh_devices == 4
        assert srv.storage.stats()["spills"] > 0
        assert srv.storage.stats()["spill_reads"] > 0
        assert mesh.stats()["dispatches"] == 4
    finally:
        srv.shutdown()


@pytest.mark.parametrize("rows,ndv,values", [
    (0, 1, "f64"), (40, 8, "f64"), (5_000, 64, "f64"), (5_000, 64, "i32"),
    (5_000, 64, None), (20_000, 700, "f64")])
def test_slot_groupby_equals_partial_aggregate(rows, ndv, values):
    """A slot's received rows reduced where they lie (`slot_groupby`: the
    numpy oracle for a tiny slot, else group ids on the device and
    `groupby_sum`'s plain version on CPU tensors, also past the kernel's
    NDV) give the numpy oracle's partial states on the same rows: keys and
    counts exactly, sums to rtol 1e-12."""
    phys = TORCH.mod("core.physical")
    plan = TORCH.mod("core.plan")
    rng = np.random.default_rng(rows + ndv)
    pool = rng.choice(np.arange(-ndv, 3 * ndv), ndv, replace=False)
    keys = pool[rng.integers(0, ndv, rows)]
    cols = {"k": keys.astype(np.int32)}
    aggs = [plan.AggSpec("c", plan.AggFunc.COUNT, None)]
    vt = None
    if values is not None:
        v = (rng.uniform(-5, 5, rows) if values == "f64"
             else rng.integers(-1000, 1000, rows).astype(np.int32))
        cols["v"] = v
        vt = torch.from_numpy(v)
        aggs += [plan.AggSpec("s", plan.AggFunc.SUM, phys.Col("v")),
                 plan.AggSpec("a", plan.AggFunc.AVG, phys.Col("v"))]
    got = phys.slot_groupby(torch.from_numpy(keys.astype(np.int64)), vt,
                            np.dtype(np.int32), ["k"], aggs,
                            phys.PDEConfig())
    want = phys.partial_aggregate(
        phys.PartitionBatch({c: phys.ColumnVal(a) for c, a in cols.items()}),
        ["k"], aggs)
    assert sorted(got.names()) == sorted(want.names())
    order = np.argsort(np.asarray(got.col("k").arr), kind="stable")
    worder = np.argsort(np.asarray(want.col("k").arr), kind="stable")
    for c in want.names():
        g = np.asarray(got.col(c).arr)[order]
        w = np.asarray(want.col(c).arr)[worder]
        assert g.dtype == w.dtype, c
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=c)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-9,
                                       err_msg=c)


# -- on the card ---------------------------------------------------------------


def _cuda_slots(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return TORCH.mod("cluster").MeshContext(
        devices=[torch.device("cuda", 0)] * n)


@pytest.mark.cuda
def test_cuda_slots_equal_cpu_slots():
    """4 slots sharing cuda:0 against 4 CPU slots: the exchange's per-slot
    keys, values and counts exactly, the colscan states to rtol 1e-12."""
    ctx = _cuda_slots(4)
    shard_exec = TORCH.mod("cluster.shard_exec")
    cpu = TORCH.mesh(4)
    for name, (keys, vals, fcols, acols, lo, hi) in exchange_cases().items():
        got, grep = shard_exec.mesh_group_exchange(ctx, keys, vals)
        want, wrep = shard_exec.mesh_group_exchange(cpu, keys, vals)
        np.testing.assert_array_equal(grep["counts"], wrep["counts"])
        for (gk, gv), (wk, wv) in zip(got, want):
            assert gk.dtype == wk.dtype
            np.testing.assert_array_equal(gk, wk, err_msg=name)
            assert (gv is None) == (wv is None)
            if gv is not None:
                assert gv.tobytes() == wv.tobytes(), name
        gs, _ = shard_exec.mesh_colscan(ctx, fcols, acols, lo, hi)
        ws, _ = shard_exec.mesh_colscan(cpu, fcols, acols, lo, hi)
        np.testing.assert_allclose(np.array(gs), np.array(ws), rtol=1e-12,
                                   atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4, 8])
def test_cuda_mesh_launches_a_dispatch(n, monkeypatch):
    """One `colscan` launch a placed partition per mesh-colscan dispatch
    and, per exchange dispatch, one `radix_split` launch a slot (route
    one_launch) and one `groupby_sum` a slot that receives as many rows as
    the single-host route gives the kernel (`segment_kernel_min_rows`;
    fewer take its plain version there), counted around the dispatches
    themselves (the reduce-side shuffle of the partial states splits on
    the card too), and the answers of the single-host card session."""
    from repro_torch.kernels import colscan as kc, ops
    from repro_torch.kernels import radix_partition as kr
    mesh = _cuda_slots(n)
    shard_exec = TORCH.mod("cluster.shard_exec")
    calls, received = [], []

    def counted(fn, parts):
        def call(ctx, first, *rest, **kw):
            l0, r0 = ops.launch_counts(), dict(kr.ROUTES)
            d0 = ctx.stats()["dispatches"]
            out = fn(ctx, first, *rest, **kw)
            l1 = ops.launch_counts()
            calls.append((fn.__name__, len(first), out[1]["devices"],
                          ctx.stats()["dispatches"] - d0,
                          l1["colscan"] - l0["colscan"],
                          l1["radix_partition"] - l0["radix_partition"],
                          kr.ROUTES["one_launch"] - r0["one_launch"],
                          l1["groupby_sum"] - l0["groupby_sum"]))
            if "counts" in out[1]:
                received.extend(out[1]["counts"].sum(axis=0).tolist())
            return out
        return call

    for name in ("mesh_colscan", "mesh_group_exchange"):
        monkeypatch.setattr(shard_exec, name,
                            counted(getattr(shard_exec, name), name))
    P.pkg = TORCH
    SharkSession = TORCH.mod("core").SharkSession
    sessions = [SharkSession(num_workers=4, default_partitions=12, mesh=m,
                             device="cuda") for m in (mesh, None)]
    on, off = sessions
    for s in sessions:
        s.create_table("t", _schema(), _data())
    try:
        for q in (GRID[1], "SELECT k, SUM(v) AS sv FROM t GROUP BY k"):
            expect = off.sql_np(q)
            got = on.sql_np(q)
            for c in expect:
                np.testing.assert_allclose(got[c], expect[c], rtol=1e-9)
        kernel_min = TORCH.mod("core.pde").PDEConfig().segment_kernel_min_rows
        reduced = sum(r >= kernel_min for r in received)
        assert len(received) == n and reduced >= 1
        assert calls == [
            ("mesh_colscan", 12, n, 1, 12, 0, 0, 0),
            ("mesh_group_exchange", 12, n, 1, 0, n, n, reduced)], calls
        assert on.metrics().mesh_devices == n
    finally:
        for s in sessions:
            s.shutdown()
