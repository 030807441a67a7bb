"""The out-of-core storage tier on the torch port against the JAX
reference: the twin of tests/test_storage.py, and the port's own cases.

Each body runs on both packages (`torch_twin.twin`; the port's sessions
and servers on `device="cpu"`), asserts what its reference test asserts,
and its answers, errors and plain-data locals (bytes freed, encodings,
the StorageManager's counters) must equal the reference's.  Each package
spills into a directory of its own.  The server cases compare answers and
the counters the two rung orders share: the port puts the storage rungs
before result entries (ROADMAP C.7), so `result_evictions` and the spill
counts may differ where results and resident partitions are both held
under pressure (`test_storage_rungs_go_before_result_entries` shows
where).  The port's own cases follow the twins: spill segments that cross
between the packages byte for byte, the two hazards of the memory manager
the tier would have turned into faults (the memo-byte sum and device
copies of cold partitions), a kernel-route shuffle block that spills,
shutdown cleanup, and two thread cases on the forced kernel routes.

The reference's docstring follows.

Out-of-core storage tier (DESIGN.md §12): adaptive recompression,
spill-segment round-trip + corruption handling, StorageManager tiering with
lineage fallback, server-level budget enforcement through the spill rungs,
and the compressed-domain execution routes (for-colscan / rle-scan)."""

import glob
import os
import threading

import numpy as np
import pytest

from torch_twin import JAX, PKGS, TORCH, P, PerPkg, observed, raises, twin


def _m(path):
    return P.m(path)


def SCHEMA():
    F, D = _m("core.types").Field, P.DType
    return P.Schema([F("k", D.INT64), F("v", D.FLOAT64), F("g", D.STRING)])


def _partition(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    data = {"k": rng.integers(10**6, 10**6 + (1 << 20), n),
            "v": rng.normal(size=n),
            "g": rng.choice(np.array(["aa", "bb", "cc"]), n)}
    return _m("core.columnar").build_partition(0, SCHEMA(), data), data


def dirs(tmp_path):
    """A directory of each package's own under `tmp_path`."""
    out = PerPkg()
    for pk in PKGS:
        d = tmp_path / pk.name
        d.mkdir(exist_ok=True)
        out[pk.name] = d
    return out


# ---------------------------------------------------------------------------
# Frame-of-reference encoding + adaptive recompression
# ---------------------------------------------------------------------------


class TestRecompression:
    def _for_round_trip_lanes(self):
        comp = _m("core.compression")
        lanes = []
        for lo, span, dtype in [(-500, 200, np.int64), (0, 60000, np.int32),
                                (7 * 10**9, 2**31, np.int64)]:
            rng = np.random.default_rng(span % 97)
            vals = (lo + rng.integers(0, span + 1, 3000)).astype(dtype)
            enc = comp.encode(vals, comp.Encoding.FOR)
            assert enc.encoding == comp.Encoding.FOR
            np.testing.assert_array_equal(comp.decode_np(enc), vals)
            assert enc.codes.dtype.itemsize < np.dtype(dtype).itemsize
            lanes.append([enc.codes.dtype.str, int(enc.bias), enc.nbytes])
        return lanes

    def test_for_round_trip_lanes(self):
        twin(self._for_round_trip_lanes)

    def _choose_recompression_signals(self):
        comp = _m("core.compression")
        rng = np.random.default_rng(1)
        runs = np.repeat(rng.integers(0, 5, 40), 500)
        assert comp.choose_recompression(runs) == comp.Encoding.RLE
        wide = rng.integers(10**9, 10**9 + (1 << 20), 5000).astype(np.int64)
        assert comp.choose_recompression(wide) == comp.Encoding.FOR
        noise = rng.normal(size=5000)
        assert comp.choose_recompression(noise) == comp.Encoding.PLAIN
        return [comp.choose_recompression(a).value
                for a in (runs, wide, noise)]

    def test_choose_recompression_signals(self):
        twin(self._choose_recompression_signals)

    def _recompress_never_grows_and_round_trips(self):
        comp = _m("core.compression")
        rng = np.random.default_rng(2)
        seen = []
        for vals in [rng.integers(-1000, 4 * 10**9, 2000).astype(np.int64),
                     np.repeat(rng.integers(0, 3, 30), 100),
                     rng.normal(size=1000),
                     rng.integers(0, 100, 1000).astype(np.int32)]:
            enc = comp.encode(np.asarray(vals), comp.Encoding.PLAIN)
            out = comp.recompress(enc)
            assert out.nbytes <= enc.nbytes
            np.testing.assert_array_equal(comp.decode_np(out),
                                          comp.decode_np(enc))
            seen.append([out.encoding.value, out.nbytes])
        return seen

    def test_recompress_never_grows_and_round_trips(self):
        twin(self._recompress_never_grows_and_round_trips)

    def _block_recompress_updates_stats_and_spaces(self):
        rng = np.random.default_rng(3)
        vals = rng.integers(10**8, 10**8 + (1 << 24), 4000).astype(np.int64)
        part = _m("core.columnar").build_partition(
            0, P.Schema([_m("core.types").Field("k", P.DType.INT64)]),
            {"k": vals})
        blk = part.columns["k"]
        blk.values()                       # populate the decode memo
        assert blk.enc.decoded_nbytes > 0
        freed = blk.recompress()
        assert freed > 0
        assert blk.enc.encoding == _m("core.compression").Encoding.FOR
        assert blk.stats.nbytes == blk.enc.nbytes
        assert blk.enc.decoded_nbytes == 0     # WARM drops the memo
        codes, bias = blk.frame_space()
        np.testing.assert_array_equal(
            codes.astype(np.int64) + bias, vals)
        return [freed, blk.enc.nbytes, int(bias)]

    def test_block_recompress_updates_stats_and_spaces(self):
        twin(self._block_recompress_updates_stats_and_spaces)


# ---------------------------------------------------------------------------
# Spill segment format
# ---------------------------------------------------------------------------


class TestSegmentFormat:
    def _round_trip(self):
        st = _m("core.storage")
        part, data = _partition()
        blob = st.serialize_partition(part.index, part.columns)
        idx, cols = st.deserialize_partition(blob)
        assert idx == part.index
        assert set(cols) == set(part.columns)
        for name, blk in cols.items():
            np.testing.assert_array_equal(blk.decoded(),
                                          part.columns[name].decoded())
            assert blk.enc.encoding == part.columns[name].enc.encoding
            assert blk.stats.min == part.columns[name].stats.min
            assert blk.stats.max == part.columns[name].stats.max
        return [len(blob), idx, sorted(cols),
                {n: b.decoded() for n, b in cols.items()}]

    def test_round_trip(self):
        twin(self._round_trip)

    def _round_trip_after_recompress(self):
        st = _m("core.storage")
        part, _ = _partition(seed=5)
        for blk in part.columns.values():
            blk.recompress()
        blob = st.serialize_partition(0, part.columns)
        _, cols = st.deserialize_partition(blob)
        for name, blk in cols.items():
            np.testing.assert_array_equal(blk.decoded(),
                                          part.columns[name].decoded())
        return [len(blob), {n: b.enc.encoding.value for n, b in cols.items()}]

    def test_round_trip_after_recompress(self):
        twin(self._round_trip_after_recompress)

    def _corruption_detected(self):
        st = _m("core.storage")
        part, _ = _partition(seed=6)
        blob = bytearray(st.serialize_partition(0, part.columns))
        with raises(st.SpillCorrupt):
            st.deserialize_partition(b"NOTSPILL" + bytes(blob[8:]))
        flipped = bytearray(blob)
        flipped[len(flipped) // 2] ^= 0xFF
        with raises(st.SpillCorrupt):
            st.deserialize_partition(bytes(flipped))
        with raises(st.SpillCorrupt):
            st.deserialize_partition(bytes(blob[: len(blob) // 2]))
        return len(blob)

    def test_corruption_detected(self):
        twin(self._corruption_detected)


# ---------------------------------------------------------------------------
# StorageManager tiering
# ---------------------------------------------------------------------------


def _lineage(data):
    build = _m("core.columnar").build_partition
    schema = SCHEMA()
    return lambda: build(0, schema, data).columns


class TestStorageManager:
    def _spill_and_fault_in(self, tmp):
        sm = _m("core.storage").StorageManager(spill_dir=str(tmp),
                                               async_write=True)
        part, data = _partition(seed=7)
        expect = {n: part.columns[n].decoded() for n in part.columns}
        freed = sm.evict("t", part)
        assert freed > 0 and not part.resident
        assert part.nbytes > 0          # stats snapshot, no fault-in
        assert not part.resident
        # read-your-writes: fault-in may race the write-behind flush
        got = {n: part.columns[n].decoded() for n in part.columns}
        assert part.resident
        for n in expect:
            np.testing.assert_array_equal(got[n], expect[n])
        st = sm.stats()
        assert st["spills"] == 1 and st["spill_reads"] == 1
        assert st["spill_bytes"] == 0   # segment retired on fault-in
        sm.shutdown()
        return observed(locals())

    def test_spill_and_fault_in(self, tmp_path):
        twin(self._spill_and_fault_in, dirs(tmp_path))

    def _flush_then_fault_reads_file(self, tmp):
        sm = _m("core.storage").StorageManager(spill_dir=str(tmp),
                                               async_write=True)
        part, _ = _partition(seed=8)
        expect = part.columns["k"].decoded().copy()
        sm.evict("t", part)
        sm.flush()
        files = glob.glob(os.path.join(str(tmp), "spill-*.shk"))
        assert len(files) == 1
        segment = open(files[0], "rb").read()
        np.testing.assert_array_equal(part.columns["k"].decoded(), expect)
        assert sm.stats()["spill_reads"] == 1
        assert glob.glob(os.path.join(str(tmp), "spill-*.shk")) == []
        sm.shutdown()
        return [os.path.basename(files[0]), segment.hex(), sm.stats()]

    def test_flush_then_fault_reads_file(self, tmp_path):
        twin(self._flush_then_fault_reads_file, dirs(tmp_path))

    def _lost_file_falls_back_to_lineage(self, tmp):
        sm = _m("core.storage").StorageManager(spill_dir=str(tmp),
                                               async_write=False)
        part, data = _partition(seed=9)
        part.lineage = _lineage(data)
        sm.evict("t", part)
        for f in glob.glob(os.path.join(str(tmp), "*.shk")):
            os.remove(f)
        np.testing.assert_array_equal(part.columns["k"].decoded(), data["k"])
        st = sm.stats()
        assert st["spill_lost"] == 1 and st["lineage_faults"] == 1
        sm.shutdown()
        return st

    def test_lost_file_falls_back_to_lineage(self, tmp_path):
        twin(self._lost_file_falls_back_to_lineage, dirs(tmp_path))

    def _corrupt_file_falls_back_to_lineage(self, tmp):
        sm = _m("core.storage").StorageManager(spill_dir=str(tmp),
                                               async_write=False)
        part, data = _partition(seed=10)
        part.lineage = _lineage(data)
        sm.evict("t", part)
        [f] = glob.glob(os.path.join(str(tmp), "*.shk"))
        raw = bytearray(open(f, "rb").read())
        raw[len(raw) // 3] ^= 0x55
        open(f, "wb").write(bytes(raw))
        np.testing.assert_array_equal(part.columns["v"].decoded(), data["v"])
        st = sm.stats()
        assert st["spill_corrupt"] == 1 and st["lineage_faults"] == 1
        sm.shutdown()
        return st

    def test_corrupt_file_falls_back_to_lineage(self, tmp_path):
        twin(self._corrupt_file_falls_back_to_lineage, dirs(tmp_path))

    def _lost_file_without_lineage_raises(self, tmp):
        sm = _m("core.storage").StorageManager(spill_dir=str(tmp),
                                               async_write=False)
        part, _ = _partition(seed=11)
        sm.evict("t", part)
        for f in glob.glob(os.path.join(str(tmp), "*.shk")):
            os.remove(f)
        with raises(RuntimeError, match="lineage"):
            _ = part.columns
        stats = sm.stats()
        sm.shutdown()
        return stats

    def test_lost_file_without_lineage_raises(self, tmp_path):
        twin(self._lost_file_without_lineage_raises, dirs(tmp_path))

    def _drop_mode_recomputes(self, tmp):
        sm = _m("core.storage").StorageManager(spill_dir=str(tmp),
                                               mode="drop")
        part, data = _partition(seed=12)
        part.lineage = _lineage(data)
        sm.evict("t", part)
        assert glob.glob(os.path.join(str(tmp), "*.shk")) == []
        np.testing.assert_array_equal(part.columns["k"].decoded(), data["k"])
        st = sm.stats()
        assert st["drops"] == 1 and st["lineage_faults"] == 1
        assert st["spills"] == 0
        sm.shutdown()
        return st

    def test_drop_mode_recomputes(self, tmp_path):
        twin(self._drop_mode_recomputes, dirs(tmp_path))


# ---------------------------------------------------------------------------
# Server-level integration: budget pressure drives the storage hierarchy
# ---------------------------------------------------------------------------


N_ROWS = 120_000


def _loader(seed=21):
    def load():
        rng = np.random.default_rng(seed)
        return {"k": rng.integers(10**6, 10**6 + (1 << 20), N_ROWS),
                "v": rng.normal(size=N_ROWS),
                "g": rng.choice(np.array(["x", "y", "z", "w"]), N_ROWS)}
    return load


QUERIES = [
    "SELECT g, COUNT(*) AS c, SUM(v) AS s FROM t "
    "WHERE k >= 1200000 GROUP BY g ORDER BY g",
    "SELECT COUNT(*) AS c, MIN(v) AS mn, MAX(v) AS mx FROM t "
    "WHERE k BETWEEN 1100000 AND 1900000",
    "SELECT k, v FROM t WHERE k > 2000000 ORDER BY k LIMIT 50",
]

# counters both rung orders give alike on these workloads
SHARED = ("spills", "spill_reads", "lineage_faults", "recompressions")


def _server(spill_mode, budget, spill_dir=None, **kw):
    srv = _m("server").SharkServer(num_workers=2, max_threads=4,
                                   cache_budget_bytes=budget,
                                   default_partitions=6,
                                   spill_mode=spill_mode, spill_dir=spill_dir,
                                   **kw)
    srv.register_external(P.m("core.catalog").ExternalSource(
        "t", SCHEMA(), _loader(), 6))
    return srv


def _run_server(spill_mode, budget, spill_dir=None, n_rounds=3):
    srv = _server(spill_mode, budget, spill_dir)
    sess = srv.session()
    outs = []
    for _ in range(n_rounds):
        for q in QUERIES:
            outs.append(sess.sql_np(q))
    stats = srv.memory.stats()
    srv.shutdown()
    return outs, stats


def _assert_same(outs_a, outs_b):
    assert len(outs_a) == len(outs_b)
    for a, b in zip(outs_a, outs_b):
        assert set(a) == set(b)
        for k in a:
            if a[k].dtype.kind == "U":
                np.testing.assert_array_equal(a[k], b[k])
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-9)


class TestServerSpill:
    def _spill_under_pressure_correct_and_counted(self, tmp):
        baseline, _ = _run_server(None, None)
        spilled, stats = _run_server("spill", 300_000,
                                     spill_dir=str(tmp / "sp"))
        _assert_same(baseline, spilled)
        assert stats["spills"] > 0
        assert stats["spill_reads"] > 0
        assert stats["spill_bytes"] >= 0
        # the four storage counters are always present (zeros without it)
        base_stats = _run_server(None, None, n_rounds=1)[1]
        for key in ("spills", "spill_bytes", "spill_reads",
                    "recompressions"):
            assert key in base_stats and base_stats[key] == 0
        return {k: base_stats[k] for k in SHARED}

    def test_spill_under_pressure_correct_and_counted(self, tmp_path):
        twin(self._spill_under_pressure_correct_and_counted, dirs(tmp_path))

    def _deleted_spill_files_recover_via_lineage(self, tmp, results=True):
        spill_dir = tmp / "sp"
        baseline, _ = _run_server(None, None)
        srv = _server("spill", 300_000, str(spill_dir),
                      enable_result_cache=results)
        sess = srv.session()
        outs = []
        for i in range(3):
            for q in QUERIES:
                outs.append(sess.sql_np(q))
            # hostile filesystem: every spilled segment vanishes mid-run
            srv.storage.flush()
            for f in glob.glob(str(spill_dir / "*.shk")):
                os.remove(f)
        stats = srv.memory.stats()
        srv.shutdown()
        _assert_same(baseline, outs)
        if results and P.pkg is TORCH:
            # ROADMAP C.7: the port spills partitions before it evicts a
            # result, so rounds 2 and 3 are result-cache hits and nothing
            # faults; the case without results runs the recovery path
            assert stats["result_evictions"] == 0
            assert stats["lineage_faults"] == 0
        else:
            assert stats["lineage_faults"] > 0  # recovery path exercised
        return len(outs)

    def test_deleted_spill_files_recover_via_lineage(self, tmp_path):
        twin(self._deleted_spill_files_recover_via_lineage, dirs(tmp_path))

    def test_deleted_spill_files_recover_via_lineage_every_round(
            self, tmp_path):
        """The port's own: the same hostile filesystem with every round
        executed (no result cache), so both packages recover the deleted
        segments from lineage."""
        twin(self._deleted_spill_files_recover_via_lineage, dirs(tmp_path),
             results=False)

    def _drop_mode_is_recompute_baseline(self, tmp):
        baseline, _ = _run_server(None, None)
        dropped, stats = _run_server("drop", 300_000,
                                     spill_dir=str(tmp / "sp"))
        _assert_same(baseline, dropped)
        assert stats["lineage_faults"] > 0
        assert stats["spills"] == 0
        assert glob.glob(str(tmp / "sp" / "*.shk")) == []
        return stats["spills"]

    def test_drop_mode_is_recompute_baseline(self, tmp_path):
        twin(self._drop_mode_is_recompute_baseline, dirs(tmp_path))


# ---------------------------------------------------------------------------
# Shuffle-block spill (working-set rung)
# ---------------------------------------------------------------------------


class TestShuffleSpill:
    def _batch_segment_round_trip(self):
        st, ColumnVal = _m("core.storage"), _m("core.expr").ColumnVal
        rng = np.random.default_rng(9)
        batch = _m("core.batch").PartitionBatch({
            "k": ColumnVal(rng.integers(0, 100, 500).astype(np.int64)),
            "v": ColumnVal(rng.normal(size=500)),
            "g": ColumnVal(rng.integers(0, 3, 500).astype(np.int32),
                           sdict=np.array(["aa", "bb", "cc"]),
                           sorted_dict=True)})
        blob = st.serialize_batch(batch)
        out = st.deserialize_batch(blob)
        assert out.names() == batch.names()
        for name in batch.names():
            np.testing.assert_array_equal(np.asarray(out.col(name).arr),
                                          np.asarray(batch.col(name).arr))
        np.testing.assert_array_equal(out.col("g").sdict,
                                      batch.col("g").sdict)
        assert out.col("g").sorted_dict
        return [blob.hex(), out.names()]

    def test_batch_segment_round_trip(self):
        twin(self._batch_segment_round_trip)

    def _segment_kinds_do_not_cross(self):
        st, ColumnVal = _m("core.storage"), _m("core.expr").ColumnVal
        part, _ = _partition(seed=8)
        pblob = st.serialize_partition(0, part.columns)
        with raises(st.SpillCorrupt):
            st.deserialize_batch(pblob)
        sblob = st.serialize_batch(_m("core.batch").PartitionBatch(
            {"v": ColumnVal(np.arange(10.0))}))
        with raises(st.SpillCorrupt):
            st.deserialize_partition(sblob)
        flipped = bytearray(sblob)
        flipped[len(flipped) // 2] ^= 0xFF
        with raises(st.SpillCorrupt):
            st.deserialize_batch(bytes(flipped))
        return [len(pblob), len(sblob)]

    def test_segment_kinds_do_not_cross(self):
        twin(self._segment_kinds_do_not_cross)

    def _budgeted_shuffle_spills_and_results_identical(self, tmp):
        rng = np.random.default_rng(5)
        n = 60_000
        data = {"k": rng.integers(0, 2000, n).astype(np.int64),
                "v": rng.normal(size=n)}
        schema = P.pkg.schema(k="INT64", v="FLOAT64")
        q = ("SELECT k, SUM(v) AS s, COUNT(*) AS c FROM t "
             "GROUP BY k ORDER BY k")

        def run(budget):
            sess = P.SharkSession(num_workers=2, max_threads=4,
                                  default_partitions=4)
            sess.create_table("t", schema,
                              {k: v.copy() for k, v in data.items()})
            st = None
            if budget:
                mm = _m("server.memory").MemoryManager(
                    sess.ctx.block_manager, budget_bytes=budget)
                mm.attach_catalog(sess.catalog)
                st = _m("core.storage").StorageManager(
                    spill_dir=str(tmp), async_write=False)
                mm.attach_storage(st)
            r = sess.sql_np(q)
            return r, st, sess

        base, _, _ = run(None)
        out, st, sess = run(120_000)
        for k in base:
            np.testing.assert_allclose(base[k], out[k], rtol=1e-9)
        stats = st.stats()
        assert stats["shuffle_spills"] > 0
        assert stats["shuffle_faults"] > 0
        assert stats["shuffle_lost"] == 0
        # releasing the shuffles retires every spilled segment (the server
        # tier calls this per completed query)
        sess.release_shuffles()
        assert sess.ctx.block_manager.spilled_shuffle == {}
        assert glob.glob(str(tmp / "shuf-*.shk")) == []
        return stats["shuffle_lost"]

    def test_budgeted_shuffle_spills_and_results_identical(self, tmp_path):
        twin(self._budgeted_shuffle_spills_and_results_identical,
             dirs(tmp_path))

    def _lost_shuffle_segment_recomputes_from_lineage(self, tmp):
        rng = np.random.default_rng(6)
        n = 60_000
        data = {"k": rng.integers(0, 2000, n).astype(np.int64),
                "v": rng.normal(size=n)}
        schema = P.pkg.schema(k="INT64", v="FLOAT64")
        q = ("SELECT k, SUM(v) AS s, COUNT(*) AS c FROM t "
             "GROUP BY k ORDER BY k")
        base_sess = P.SharkSession(num_workers=2, max_threads=4,
                                   default_partitions=4)
        base_sess.create_table("t", schema,
                               {k: v.copy() for k, v in data.items()})
        base = base_sess.sql_np(q)

        sess = P.SharkSession(num_workers=2, max_threads=4,
                              default_partitions=4)
        sess.create_table("t", schema, {k: v.copy() for k, v in data.items()})
        mm = _m("server.memory").MemoryManager(sess.ctx.block_manager,
                                               budget_bytes=120_000)
        mm.attach_catalog(sess.catalog)
        st = _m("core.storage").StorageManager(spill_dir=str(tmp),
                                               async_write=False)
        mm.attach_storage(st)
        # hostile filesystem: the first faulted segment of each fetch is
        # gone — the fetch must degrade to FetchFailed -> lineage recompute
        real = st.fault_shuffle
        state = {"dropped": 0}

        def flaky(ref):
            if state["dropped"] < 3:
                state["dropped"] += 1
                st.forget_shuffle(ref)
                return None
            return real(ref)

        st.fault_shuffle = flaky
        out = sess.sql_np(q)
        for k in base:
            np.testing.assert_allclose(base[k], out[k], rtol=1e-9)
        assert state["dropped"] > 0
        assert sess.ctx.block_manager.shuffle_spill_lost > 0
        return state["dropped"]

    def test_lost_shuffle_segment_recomputes_from_lineage(self, tmp_path):
        twin(self._lost_shuffle_segment_recomputes_from_lineage,
             dirs(tmp_path))


# ---------------------------------------------------------------------------
# Compressed-domain execution routes
# ---------------------------------------------------------------------------


def _for_session(cd: bool):
    rng = np.random.default_rng(33)
    n = 40_000
    data = {"k": rng.integers(5 * 10**6, 5 * 10**6 + (1 << 20),
                              n).astype(np.int64),
            "r": np.repeat(rng.integers(0, 40, 200),
                           n // 200).astype(np.int32),
            "v": rng.normal(size=n)}
    schema = P.pkg.schema(k="INT64", r="INT32", v="FLOAT64")
    sess = P.SharkSession(num_workers=2, max_threads=4, default_partitions=4,
                          pde_config=_m("core.pde").PDEConfig(
                              compressed_domain=cd))
    sess.create_table("t", schema, data)
    for part in sess.catalog.get("t").partitions:
        for blk in part._columns.values():
            blk.recompress()
    encs = {n_: b.enc.encoding
            for p in sess.catalog.get("t").partitions
            for n_, b in p._columns.items()}
    Encoding = _m("core.compression").Encoding
    assert encs["k"] == Encoding.FOR and encs["r"] == Encoding.RLE
    return sess


class TestCompressedDomainRoutes:
    def _for_colscan_route_and_parity(self):
        on, off = _for_session(True), _for_session(False)
        q = ("SELECT COUNT(*) AS c, SUM(v) AS s, MIN(v) AS mn FROM t "
             "WHERE k BETWEEN 5200000 AND 5700000")
        r_on, r_off = on.sql_np(q), off.sql_np(q)
        assert "for-colscan" in on.metrics().segment_routes()
        assert "for-colscan" not in off.metrics().segment_routes()
        for k in r_on:
            np.testing.assert_allclose(r_on[k], r_off[k], rtol=1e-12)
        return [on.metrics().segment_routes(),
                off.metrics().segment_routes()]

    def test_for_colscan_route_and_parity(self):
        twin(self._for_colscan_route_and_parity)

    def _rle_scan_route_and_parity(self):
        on, off = _for_session(True), _for_session(False)
        routes = []
        for q in ("SELECT COUNT(*) AS c, SUM(r) AS s, MAX(r) AS mx FROM t "
                  "WHERE r BETWEEN 5 AND 25",
                  "SELECT COUNT(*) AS c, SUM(v) AS s FROM t "
                  "WHERE r BETWEEN 5 AND 25"):
            r_on, r_off = on.sql_np(q), off.sql_np(q)
            assert "rle-scan" in on.metrics().segment_routes()
            assert "rle-scan" not in off.metrics().segment_routes()
            for k in r_on:
                np.testing.assert_allclose(r_on[k], r_off[k], rtol=1e-12)
            routes.append(on.metrics().segment_routes())
        return routes

    def test_rle_scan_route_and_parity(self):
        twin(self._rle_scan_route_and_parity)

    def _bitpack_colscan_route_and_parity(self):
        # small-range ints BITPACK-encode at load; the colscan must compare
        # biased codes on the packed lanes (host-translated bounds) instead
        # of widening the filter column
        def _bp_session(cd: bool):
            rng = np.random.default_rng(7)
            n = 40_000
            data = {"b": rng.integers(-50, 50, n).astype(np.int64),
                    "v": rng.normal(size=n)}
            schema = P.pkg.schema(b="INT64", v="FLOAT64")
            sess = P.SharkSession(num_workers=2, max_threads=4,
                                  default_partitions=4,
                                  pde_config=_m("core.pde").PDEConfig(
                                      compressed_domain=cd))
            sess.create_table("t", schema, data)
            encs = {nm: blk.enc.encoding
                    for p in sess.catalog.get("t").partitions
                    for nm, blk in p._columns.items()}
            assert encs["b"] == _m("core.compression").Encoding.BITPACK
            return sess

        on, off = _bp_session(True), _bp_session(False)
        routes = []
        for q in ("SELECT COUNT(*) AS c, SUM(v) AS s, MIN(v) AS mn, "
                  "MAX(v) AS mx FROM t WHERE b BETWEEN -30 AND 20",
                  "SELECT COUNT(*) AS c, SUM(v) AS s FROM t WHERE b >= 44"):
            r_on, r_off = on.sql_np(q), off.sql_np(q)
            assert "bitpack-colscan" in on.metrics().segment_routes()
            assert "bitpack-colscan" not in off.metrics().segment_routes()
            for k in r_on:
                np.testing.assert_allclose(r_on[k], r_off[k], rtol=1e-12)
            routes.append(on.metrics().segment_routes())
        return routes

    def test_bitpack_colscan_route_and_parity(self):
        twin(self._bitpack_colscan_route_and_parity)

    def _for_filter_projection_parity(self):
        on, off = _for_session(True), _for_session(False)
        q = "SELECT k, v FROM t WHERE k > 5900000 ORDER BY k"
        r_on, r_off = on.sql_np(q), off.sql_np(q)
        for k in r_on:
            np.testing.assert_array_equal(r_on[k], r_off[k])
        return len(r_on["k"])

    def test_for_filter_projection_parity(self):
        twin(self._for_filter_projection_parity)

    def _explain_identical_on_off(self):
        on, off = _for_session(True), _for_session(False)
        plans = []
        for q in ["SELECT COUNT(*) AS c FROM t WHERE k BETWEEN 5200000 "
                  "AND 5700000",
                  "SELECT k, v FROM t WHERE k > 5900000 ORDER BY k"]:
            assert on.explain(q) == off.explain(q)
            plans.append(on.explain(q))
        return plans

    def test_explain_identical_on_off(self):
        twin(self._explain_identical_on_off)

    def _exec_metrics_carry_spill_deltas(self, tmp):
        rng = np.random.default_rng(44)
        n = 60_000
        data = {"k": rng.integers(0, 10**9, n),
                "v": rng.normal(size=n)}
        schema = P.pkg.schema(k="INT64", v="FLOAT64")
        sess = P.SharkSession(num_workers=2, max_threads=4,
                              default_partitions=4)
        mm = _m("server.memory").MemoryManager(sess.ctx.block_manager,
                                               budget_bytes=150_000)
        mm.attach_catalog(sess.catalog)
        storage = _m("core.storage").StorageManager(spill_dir=str(tmp),
                                                    async_write=False)
        mm.attach_storage(storage)
        src = P.m("core.catalog").ExternalSource(
            "t", schema, lambda: {k: v.copy() for k, v in data.items()}, 4)
        sess.register_external(src)
        r1 = sess.sql_np("SELECT COUNT(*) AS c, SUM(v) AS s FROM t "
                         "WHERE k > 500000000")
        mm.enforce()
        r2 = sess.sql_np("SELECT COUNT(*) AS c, SUM(v) AS s FROM t "
                         "WHERE k > 500000000")
        m = sess.metrics()
        np.testing.assert_allclose(r1["c"], r2["c"])
        assert storage.stats()["spills"] > 0
        assert m.spill_reads > 0        # faulted segments back this query
        storage.shutdown()
        # how many spills and reads follows the task threads' timing
        return [storage.stats()["spills"] > 0, m.spill_reads > 0]

    def test_exec_metrics_carry_spill_deltas(self, tmp_path):
        twin(self._exec_metrics_carry_spill_deltas, dirs(tmp_path))


# ---------------------------------------------------------------------------
# The port's own cases
# ---------------------------------------------------------------------------


def _both_partitions(recompressed: bool):
    """The same partition built by each package: {name: (module, part)}."""
    out = {}
    for pk in PKGS:
        P.pkg = pk
        part, _ = _partition(seed=13)
        if recompressed:
            for blk in part.columns.values():
                blk.recompress()
        out[pk.name] = (_m("core.storage"), part)
    return out


@pytest.mark.parametrize("recompressed", [False, True],
                         ids=["plain", "recompressed"])
def test_partition_segments_cross_packages(recompressed):
    """A partition segment the port writes is the reference's byte for
    byte, and each package reads the other's."""
    made = _both_partitions(recompressed)
    (jst, jpart), (tst, tpart) = made["jax"], made["torch"]
    jblob = jst.serialize_partition(jpart.index, jpart.columns)
    tblob = tst.serialize_partition(tpart.index, tpart.columns)
    assert tblob == jblob
    for reader, blob, want in ((jst, tblob, tpart), (tst, jblob, jpart)):
        idx, cols = reader.deserialize_partition(blob)
        assert idx == want.index
        for name, blk in cols.items():
            ref = want.columns[name]
            assert blk.enc.encoding.value == ref.enc.encoding.value
            np.testing.assert_array_equal(blk.decoded(), ref.decoded())
            assert blk.stats.min == ref.stats.min
            assert blk.stats.max == ref.stats.max
    plain = {n: b.enc.encoding for n, b in _partition(seed=13)[0]
             .columns.items()}
    encs = {n: b.enc.encoding for n, b in tpart.columns.items()}
    assert (encs != plain) == recompressed


def test_shuffle_segments_cross_packages():
    rng = np.random.default_rng(9)
    cols = {"k": rng.integers(0, 100, 500).astype(np.int64),
            "v": rng.normal(size=500),
            "g": rng.integers(0, 3, 500).astype(np.int32)}
    blobs, mods = {}, {}
    for pk in PKGS:
        P.pkg = pk
        ColumnVal = _m("core.expr").ColumnVal
        batch = _m("core.batch").PartitionBatch({
            "k": ColumnVal(cols["k"]), "v": ColumnVal(cols["v"]),
            "g": ColumnVal(cols["g"], sdict=np.array(["aa", "bb", "cc"]),
                           sorted_dict=True)})
        mods[pk.name] = _m("core.storage")
        blobs[pk.name] = mods[pk.name].serialize_batch(batch)
    assert blobs["torch"] == blobs["jax"]
    for reader, writer in (("jax", "torch"), ("torch", "jax")):
        out = mods[reader].deserialize_batch(blobs[writer])
        for name, want in cols.items():
            np.testing.assert_array_equal(np.asarray(out.col(name).arr), want)
        np.testing.assert_array_equal(out.col("g").sdict, ["aa", "bb", "cc"])


def test_storage_rungs_go_before_result_entries(tmp_path):
    """ROADMAP C.7: with results and resident partitions both held over
    the budget, the reference evicts a result first on every pass, so its
    repeated rounds execute again; the port spills (and recompresses)
    first, keeps every result, and answers rounds 2 and 3 from the result
    cache.  The answers are the same; `result_evictions` and `spills`
    are where the counters part."""
    def body(pk, d):
        P.pkg = pk
        # no speculative backups: they would scan and spill again
        srv = _server("spill", 300_000, str(d), speculation=False)
        sess = srv.session()
        outs, cached = [], []
        for _ in range(3):
            for q in QUERIES:
                h = sess.submit(q)
                outs.append(h.result(timeout=120).to_numpy())
                cached.append(h.cached)
        stats = srv.memory.stats()
        srv.shutdown()
        return outs, cached, stats

    d = dirs(tmp_path)
    jouts, jcached, jst = body(JAX, d["jax"])
    touts, tcached, tst = body(TORCH, d["torch"])
    _assert_same(jouts, touts)
    assert jst["result_evictions"] > 0 and tst["result_evictions"] == 0
    assert jst["result_evictions"] > 0 and tst["result_evictions"] == 0
    assert not any(jcached)              # every reference round executes
    assert tcached == [False] * 3 + [True] * 6
    assert 0 < tst["spills"] < jst["spills"]
    assert tst["recompressions"] == jst["recompressions"]


def test_warm_pass_does_not_decode_a_settled_block():
    """The memory manager's WARM pass recompresses every resident block on
    every pass.  A block that is already its own recompression is not
    decoded again on the port (`Encoded._settled`); the bytes freed and
    the encodings are the reference's on every pass."""
    seen = {}
    for pk in PKGS:
        P.pkg = pk
        part, _ = _partition(seed=14)
        passes, decodes = [], []
        for _ in range(3):
            passes.append([part.recompress(),
                           {n: b.enc.encoding.value
                            for n, b in part.columns.items()}])
            decodes.append(sum(b.enc.decode_count
                               for b in part.columns.values()))
        seen[pk.name] = passes, decodes
    assert seen["torch"][0] == seen["jax"][0]
    assert seen["jax"][0][0][0] > 0 and seen["jax"][0][2][0] == 0
    jd, td = seen["jax"][1], seen["torch"][1]
    assert jd[2] > jd[1] and td[2] == td[1]


def _memo_catalog(tmp, mode="spill"):
    """A port session's catalog with one two-partition table under a
    memory manager with a storage tier attached."""
    from repro_torch.core import DType, SharkSession
    from repro_torch.core.catalog import ExternalSource
    from repro_torch.core.storage import StorageManager
    from repro_torch.server.memory import MemoryManager
    rng = np.random.default_rng(3)
    data = {"k": rng.integers(0, 1 << 30, 5000),
            "d": rng.integers(0, 7, 5000) * 3 - 5,
            "v": rng.normal(size=5000)}
    sess = SharkSession(num_workers=2, max_threads=2, device="cpu")
    sess.register_external(ExternalSource(
        "t", TORCH.schema(k="INT64", d="INT64", v="FLOAT64"),
        lambda: {k: v.copy() for k, v in data.items()}, 2))
    sess.sql_np("SELECT COUNT(*) AS c FROM t")      # materialize
    mm = MemoryManager(sess.ctx.block_manager)
    mm.attach_catalog(sess.catalog)
    storage = StorageManager(spill_dir=str(tmp), mode=mode,
                             async_write=False)
    mm.attach_storage(storage)
    return sess, mm, storage, sess.catalog.get("t")


def _fresh_memo_sum(catalog) -> int:
    return sum(b.enc.decoded_nbytes for t in catalog.tables().values()
               for p in t.partitions if p.resident
               for b in p._columns.values())


@pytest.mark.parametrize("mode", ["spill", "drop"])
def test_memo_byte_sum_stays_true_across_spill_and_fault_in(tmp_path, mode):
    """The manager keeps its sum of host decode-memo bytes until a memo or
    the catalog changes; a COLD transition drops a partition's memos with
    its blocks and a fault-in brings blocks back, and each must show in
    `decoded_cache_bytes()`."""
    sess, mm, storage, table = _memo_catalog(tmp_path, mode)
    part = table.partitions[0]
    for blk in part.columns.values():
        blk.values()                          # host decode memos
    held = _fresh_memo_sum(sess.catalog)
    assert held > 0 and mm.decoded_cache_bytes() == held
    storage.evict("t", part)
    assert not part.resident
    assert mm.decoded_cache_bytes() == _fresh_memo_sum(sess.catalog) == 0
    _ = part.columns                          # fault in: new blocks
    assert part.resident
    assert mm.decoded_cache_bytes() == _fresh_memo_sum(sess.catalog) == 0
    for blk in part.columns.values():
        blk.values()
    assert mm.decoded_cache_bytes() == _fresh_memo_sum(sess.catalog) == held
    # a fault-in that comes back with memos shows too
    storage.evict("t", part)
    memoed = part.lineage()
    for blk in memoed.values():
        blk.values()
    part.restore_columns(memoed)
    assert mm.decoded_cache_bytes() == _fresh_memo_sum(sess.catalog) == held
    storage.shutdown()
    sess.shutdown()


@pytest.mark.parametrize("mode", ["spill", "drop"])
def test_cold_partition_keeps_no_device_memo(tmp_path, mode):
    """A block held by a cached scan batch keeps its encoded arrays, but
    the device copies go when its partition goes cold (the CPU's memos
    stand for the card's)."""
    from repro_torch.core.pde import PDEConfig
    srv = TORCH.server(num_workers=2, max_threads=2, default_partitions=2,
                       spill_mode=mode, spill_dir=str(tmp_path),
                       pde_config=PDEConfig(segment_force_kernels=True),
                       enable_result_cache=False)
    rng = np.random.default_rng(4)
    data = {"a": rng.integers(0, 9, 8000), "b": rng.uniform(0, 1, 8000)}
    srv.register_external(P.m("core.catalog").ExternalSource(
        "t", TORCH.schema(a="INT64", b="FLOAT64"),
        lambda: {k: v.copy() for k, v in data.items()}, 2))
    try:
        srv.sql_np("SELECT COUNT(*) AS c, SUM(b) AS s FROM t "
                   "WHERE b BETWEEN 0.25 AND 0.5")
        part = srv.catalog.get("t").partitions[0]
        blocks = list(part.columns.values())
        for blk in blocks:
            blk.device_array("values", "cpu")
        bm = srv.ctx.block_manager
        with bm.lock:
            held = [v.block for _, batch in bm.blocks.values()
                    for v in batch.cols.values() if v.block is not None]
        assert any(any(h is b for h in held) for b in blocks), \
            "no cached scan batch holds the partition's blocks"
        assert all(b.enc._device for b in blocks)
        srv.storage.evict("t", part)
        assert not part.resident
        assert all(not b.enc._device for b in blocks)
        assert all(b.enc.nbytes > 0 for b in blocks)     # still held
        # a scan through the stale batch copies for the call only
        from repro_torch.core.compression import device_stream
        for blk in blocks:
            blk.device_array("values", "cpu")
            stream = {"plain": "data", "dict": "codes", "for": "codes",
                      "bitpack": "words", "rle": "run_values"}
            device_stream(blk.enc, stream[blk.enc.encoding.value], "cpu")
        assert all(not b.enc._device for b in blocks)
        got = srv.sql_np("SELECT COUNT(*) AS c, SUM(b) AS s FROM t")
        assert int(got["c"][0]) == 8000
        np.testing.assert_allclose(got["s"][0], data["b"].sum(), rtol=1e-12)
    finally:
        srv.shutdown()


def test_kernel_route_shuffle_blocks_spill(tmp_path):
    """Shuffle blocks of the forced kernel routes (the radix split's
    pieces, the compiled merge's partials) spill to segments and fault
    back: the working-set rung works on the port's own routes, and a
    column a route left as a torch tensor serializes too."""
    from repro_torch.core.batch import PartitionBatch
    from repro_torch.core.expr import ColumnVal
    from repro_torch.core.pde import PDEConfig
    from repro_torch.core.storage import (StorageManager, deserialize_batch,
                                          serialize_batch)
    from repro_torch.server.memory import MemoryManager
    import torch
    rng = np.random.default_rng(5)
    n = 60_000
    data = {"k": rng.integers(0, 2000, n).astype(np.int64),
            "v": rng.normal(size=n)}
    q = "SELECT k, SUM(v) AS s, COUNT(*) AS c FROM t GROUP BY k ORDER BY k"
    cfg = PDEConfig(segment_force_kernels=True, reduce_force_compiled=True)

    def run(budget):
        sess = TORCH.session(num_workers=2, max_threads=4,
                             default_partitions=4, pde_config=cfg)
        sess.create_table("t", TORCH.schema(k="INT64", v="FLOAT64"),
                          {k: v.copy() for k, v in data.items()})
        st = None
        if budget:
            mm = MemoryManager(sess.ctx.block_manager, budget_bytes=budget)
            mm.attach_catalog(sess.catalog)
            st = StorageManager(spill_dir=str(tmp_path), async_write=False)
            mm.attach_storage(st)
        return sess.sql_np(q), st, sess

    from repro_torch.core.shuffle import RADIX_KERNEL_CALLS
    base, _, _ = run(None)
    splits = RADIX_KERNEL_CALLS["count"]
    out, st, sess = run(120_000)
    assert RADIX_KERNEL_CALLS["count"] > splits      # the kernel route's
    for k in base:
        np.testing.assert_allclose(out[k], base[k], rtol=1e-12)
    stats = st.stats()
    assert stats["shuffle_spills"] > 0 and stats["shuffle_faults"] > 0
    assert stats["shuffle_lost"] == 0
    sess.release_shuffles()
    assert glob.glob(str(tmp_path / "shuf-*.shk")) == []
    st.shutdown()
    # a column left as a torch tensor
    t = torch.arange(7, dtype=torch.float64)
    blob = serialize_batch(PartitionBatch({"x": ColumnVal(t)}))
    assert blob == serialize_batch(PartitionBatch(
        {"x": ColumnVal(np.arange(7, dtype=np.float64))}))
    np.testing.assert_array_equal(deserialize_batch(blob).col("x").arr,
                                  t.numpy())


@pytest.mark.parametrize("own_dir", [True, False], ids=["own", "given"])
def test_shutdown_leaves_no_segment_and_joins_the_writer(tmp_path, own_dir,
                                                        monkeypatch):
    given = tmp_path / "given"
    monkeypatch.delenv("SHARK_SPILL_DIR")     # the server makes its own
    srv = _m_torch_server(None if own_dir else str(given))
    sess = srv.session()
    for q in QUERIES:
        sess.sql_np(q)
    storage = srv.storage
    writer = storage._writer
    assert writer is not None and writer.is_alive()
    assert storage.stats()["spills"] > 0
    spill_dir = storage.dir
    srv.storage.flush()
    srv.shutdown()
    writer.join(timeout=10)
    assert not writer.is_alive()
    assert storage._writer is None
    left = glob.glob(os.path.join(spill_dir, "*.shk*"))
    assert left == []
    assert os.path.isdir(spill_dir) == (not own_dir)


def _m_torch_server(spill_dir, **kw):
    P.pkg = TORCH
    kw.setdefault("enable_result_cache", False)
    return _server("spill", 300_000, spill_dir, **kw)


def _threads_server(tmp_path, mode, loader):
    from repro_torch.core.pde import PDEConfig
    cfg = PDEConfig(segment_force_kernels=True, reduce_force_compiled=True)
    srv = TORCH.server(num_workers=4, max_threads=4, default_partitions=2,
                       spill_mode=mode, spill_dir=str(tmp_path),
                       pde_config=cfg, enable_result_cache=False)
    srv.register_external(P.m("core.catalog").ExternalSource(
        "t", TORCH.schema(a="INT64", b="FLOAT64"), loader, 2))
    return srv


THREAD_QUERY = ("SELECT COUNT(*) AS c, SUM(b) AS s FROM t "
                "WHERE b BETWEEN 0.25 AND 0.75")


def _thread_data():
    rng = np.random.default_rng(8)
    return {"a": rng.integers(0, 9, 20_000), "b": rng.uniform(0, 1, 20_000)}


def _check_thread_answer(got, data):
    sel = (data["b"] >= 0.25) & (data["b"] <= 0.75)
    assert int(got["c"][0]) == int(sel.sum())
    np.testing.assert_allclose(got["s"][0], data["b"][sel].sum(), rtol=1e-12)


def test_two_clients_fault_one_cold_partition_once(tmp_path):
    """Two clients scan the same cold partition at once, on the forced
    kernel routes: both reach the fault-in, one reads the segment, and
    both get the same right answer."""
    data = _thread_data()
    srv = _threads_server(tmp_path, "spill",
                          lambda: {k: v.copy() for k, v in data.items()})
    try:
        _check_thread_answer(srv.sql_np(THREAD_QUERY), data)
        part = srv.catalog.get("t").partitions[0]
        srv.storage.evict("t", part)
        srv.storage.flush()
        srv.scan_cache.clear()          # no cached batch answers the scan
        real, meet = srv.storage.fault_in, threading.Barrier(2, timeout=20)
        entered = []

        def fault_in(p):
            entered.append(threading.get_ident())
            meet.wait()
            return real(p)

        srv.storage.fault_in = fault_in
        outs = [None, None]

        def client(i):
            outs[i] = srv.session(f"c{i}").sql_np(THREAD_QUERY)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert len(set(entered)) == 2, entered
        st = srv.storage.stats()
        assert st["spill_reads"] == 1 and st["lineage_faults"] == 0
        for got in outs:
            _check_thread_answer(got, data)
        assert outs[0]["s"].tobytes() == outs[1]["s"].tobytes()
    finally:
        srv.shutdown()


def test_evict_never_waits_on_a_fault_in_in_the_other_order(tmp_path):
    """`evict` runs under `MemoryManager.lock` (from `on_put`) and takes
    the storage lock; a fault-in holds the storage lock and never takes
    the manager's.  A fault-in from lineage that is under way while
    another thread holds the manager's lock and waits to evict finishes,
    and then the eviction does."""
    data = _thread_data()
    armed, inside, go = (threading.Event() for _ in range(3))

    def loader():
        if armed.is_set():
            inside.set()
            assert go.wait(timeout=20)
            # let the evictor reach the storage lock and wait on it
            threading.Event().wait(0.2)
        return {k: v.copy() for k, v in data.items()}

    srv = _threads_server(tmp_path, "drop", loader)
    try:
        _check_thread_answer(srv.sql_np(THREAD_QUERY), data)
        table = srv.catalog.get("t")
        srv.storage.evict("t", table.partitions[0])
        srv.scan_cache.clear()
        armed.set()
        done = {}

        def client():
            done["answer"] = srv.session("c").sql_np(THREAD_QUERY)

        def evictor():
            assert inside.wait(timeout=20)
            with srv.memory.lock:
                go.set()
                done["freed"] = srv.memory._spill_coldest()

        threads = [threading.Thread(target=client),
                   threading.Thread(target=evictor)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "deadlock"
        _check_thread_answer(done["answer"], data)
        assert done["freed"] > 0
        st = srv.storage.stats()
        assert st["drops"] == 2 and st["lineage_faults"] >= 1
    finally:
        srv.shutdown()
