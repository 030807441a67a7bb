#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Shark (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py                          # the card, full size
    python3 chip_smoke.py --device cpu --rows 300000   # CPU rehearsal

Phase 0 builds the CUDA kernels from `src/repro_torch/kernels/csrc/`.
Phase 1 holds each kernel against its plain PyTorch version on the card,
at the main path's partition sizes and at ragged sizes, and times both.
Phase 2 runs the SQL main path end to end: a `SharkSession` on the card
loads a TPC-H `lineitem` table (6,000,000 rows, scale factor 1, in 64
partitions of 93,750 rows, columns drawn from dbgen's domains with numpy
from `--seed`) and answers four filter / aggregate / group-by queries,
each checked against numpy over the generated arrays (integers exactly,
floats to rtol 1e-9).  The launch counts of the main path's run must show
all five kernels.

Output: the card's name and power limit, per-phase lines, a `kernels`
JSON line, and last `{"ok": true, "device": {...}}`.  Without a CUDA
device (and without `--device cpu`), or outside a checkout of the repo,
it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
# the guide's table lists no float64 rate; the float32 rate outside the
# tensor cores (67 TFLOP/s) is the nearest listed peak for these kernels'
# scalar float work
PEAK_OPS_PER_S = 67e12
# 64 partitions put 64 x 50 = 3,200 partial-state rows into query (c)'s
# reduce, past PDEConfig.reduce_min_compiled_rows (2048), so the merge
# takes segmented_merge; the main path is timed over REPS runs
PARTITIONS = 64
REPS = 3
SHIP_MODES = np.array(["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL",
                       "FOB"])
TPU_KERNELS = {
    "colscan": "src/repro/kernels/colscan.py:74",
    "fused_decode_scan": "src/repro/kernels/dictdecode.py:153",
    "groupby_sum": "src/repro/kernels/groupby_mxu.py:56",
    "radix_partition": "src/repro/kernels/radix_partition.py:107",
    "segmented_merge": "src/repro/kernels/segmented_merge.py:64",
}
SOURCES = {
    "colscan": "src/repro_torch/kernels/csrc/scan.cu",
    "fused_decode_scan": "src/repro_torch/kernels/csrc/scan.cu",
    "groupby_sum": "src/repro_torch/kernels/csrc/group.cu",
    "radix_partition": "src/repro_torch/kernels/csrc/radix.cu",
    "segmented_merge": "src/repro_torch/kernels/csrc/group.cu",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------- timing


class Timer:
    """Time per call of `fn()` over `reps` back-to-back calls after
    `warmup` calls: CUDA events on the card, the host clock on the CPU
    rehearsal.  It includes the host's cost per call wherever that exceeds
    the device's; `graphed` takes the device's alone."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = device.type == "cuda"

    def __call__(self, fn, reps: int = 50, warmup: int = 5) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        if self.cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    def graphed(self, fn, calls: int = 20, replays: int = 10):
        """Device time of one `fn()`: `calls` calls captured in one CUDA
        graph, replayed `replays` times between CUDA events, so the host's
        cost per call (allocation, ctypes) drops out.  None on the CPU."""
        torch = self.torch
        if not self.cuda:
            return None
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (replays * calls)


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 1


def scan_err(got, want) -> float:
    """Exact count / min / max, sum to rtol 1e-12; returns the largest
    absolute difference."""
    g = got.cpu().double().numpy()
    w = want.cpu().double().numpy()
    if not (g[0] == w[0] and g[2] == w[2] and g[3] == w[3]):
        fail(f"scan count/min/max differ: kernel {g} plain {w}")
    if not np.allclose(g[1], w[1], rtol=1e-12, atol=1e-9):
        fail(f"scan sum differs: kernel {g[1]!r} plain {w[1]!r}")
    return float(abs(g[1] - w[1]))


def group_err(got, want) -> float:
    """Exact counts (and min / max), sums to rtol 1e-12."""
    g = got.cpu().numpy()
    w = want.cpu().numpy()
    if not np.array_equal(g[:, 1:], w[:, 1:]):
        fail("group counts/min/max differ from the plain version")
    if not np.allclose(g[:, 0], w[:, 0], rtol=1e-12, atol=1e-9):
        fail("group sums differ from the plain version")
    return float(np.max(np.abs(g[:, 0] - w[:, 0]), initial=0.0))


def phase_kernels(torch, device, seed: int) -> dict:
    """Every kernel against its plain version, on the device, at the main
    path's sizes and ragged ones; then each timed at its main-path shape."""
    from repro_torch.kernels import colscan as kc
    from repro_torch.kernels import dictdecode as kd
    from repro_torch.kernels import groupby_mxu as kg
    from repro_torch.kernels import radix_partition as kr
    from repro_torch.kernels import segmented_merge as km

    rng = np.random.default_rng(seed)
    dev = device
    err = {k: 0.0 for k in TPU_KERNELS}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    bounds = [(20000.0, 40000.0), (-np.inf, 30000.0), (50000.0, np.inf),
              (np.inf, -np.inf)]
    for n in (1, 1023, 93750, 375001):
        price = np.round(rng.uniform(900, 105000, n), 2)
        fcol = price.copy()
        fcol[::13] = np.nan                        # NaN filter values
        qty = rng.integers(1, 51, n).astype(np.int32)
        for f, a in ((fcol, price), (qty.astype(np.float64), qty),
                     (qty, price)):
            for lo, hi in bounds:
                err["colscan"] = max(err["colscan"], scan_err(
                    kc.colscan(t(f), t(a), lo, hi),
                    kc.colscan_plain(t(f), t(a), lo, hi)))
        disc = np.round(np.arange(11) * 0.01, 2)
        codes = rng.integers(0, 11, n).astype(np.int32)
        codes[::17] = 11                           # the pad code
        for lo, hi in ((0.05, 0.07), (-np.inf, np.inf), (0.02, np.inf)):
            err["fused_decode_scan"] = max(err["fused_decode_scan"], scan_err(
                kd.fused_decode_scan(t(codes), t(disc), t(price), lo, hi),
                kd.fused_decode_scan_plain(t(codes), t(disc), t(price), lo,
                                           hi)))
        for g in (7, 50, 512):
            present = rng.choice(g, size=max(1, g // 2), replace=False)
            gc = present[rng.integers(0, len(present), n)].astype(np.int32)
            for vals in (price, qty):
                err["groupby_sum"] = max(err["groupby_sum"], group_err(
                    kg.groupby_sum(t(gc), t(vals), g),
                    kg.groupby_sum_plain(t(gc), t(vals), g)))
            inv = gc.astype(np.int64)
            err["segmented_merge"] = max(err["segmented_merge"], group_err(
                km.segmented_merge(t(inv), t(price), g),
                km.segmented_merge_plain(t(inv), t(price), g)))
        keys = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
        kt = t(keys.view(np.int32))
        for b in (32, 64):
            want_ids, want_counts = kr.radix_partition_ref(keys, b)
            for with_counts in (True, False):
                ids, counts = kr.radix_partition(kt, b, with_counts)
                plain_ids, _ = kr.radix_partition_plain(kt, b, with_counts)
                if not (np.array_equal(ids.cpu().numpy(), want_ids)
                        and np.array_equal(plain_ids.cpu().numpy(),
                                           want_ids)):
                    fail(f"radix ids differ (n={n}, B={b})")
                if with_counts and not np.array_equal(counts.cpu().numpy(),
                                                      want_counts):
                    fail(f"radix counts differ (n={n}, B={b})")
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"phase 1: 5 kernels match their plain versions, max abs err "
          f"{json.dumps(err)}", flush=True)

    # timing at the shapes the main path gives each kernel
    timer = Timer(torch, device)
    n = 93750
    price = t(np.round(rng.uniform(900, 105000, n), 2))
    codes = t(rng.integers(0, 11, n).astype(np.int32))
    disc = t(np.round(np.arange(11) * 0.01, 2))
    qcodes = t(rng.integers(0, 50, n).astype(np.int32))
    m_rows, m_groups = 64 * 50, 50
    minv = t(rng.integers(0, m_groups, m_rows).astype(np.int64))
    mval = t(rng.uniform(1e7, 2e7, m_rows))
    rkeys = t(rng.integers(0, 2 ** 32, 50, dtype=np.uint64)
              .astype(np.uint32).view(np.int32))
    stacked = torch.stack([price, torch.ones_like(price)], dim=1)

    def index_add_groupby():
        torch.zeros((50, 2), dtype=torch.float64, device=dev).index_add_(
            0, qcodes, stacked)

    cases = {
        "colscan": (lambda: kc.colscan(price, price, 20000.0, 40000.0),
                    lambda: kc.colscan_plain(price, price, 20000.0, 40000.0),
                    None, 16.0 * n + 32, 4.0 * n),
        "fused_decode_scan": (
            lambda: kd.fused_decode_scan(codes, disc, price, 0.05, 0.07),
            lambda: kd.fused_decode_scan_plain(codes, disc, price, 0.05,
                                               0.07),
            None, 12.0 * n + 8 * 11 + 32, 4.0 * n),
        "groupby_sum": (lambda: kg.groupby_sum(qcodes, price, 50),
                        lambda: kg.groupby_sum_plain(qcodes, price, 50),
                        index_add_groupby, 12.0 * n + 16 * 50, 2.0 * n),
        "segmented_merge": (
            lambda: km.segmented_merge(minv, mval, m_groups),
            lambda: km.segmented_merge_plain(minv, mval, m_groups),
            None, 16.0 * m_rows + 32 * m_groups, 4.0 * m_rows),
        "radix_partition": (
            lambda: kr.radix_partition(rkeys, 64, with_counts=False),
            lambda: kr.radix_partition_plain(rkeys, 64, with_counts=False),
            None, 8.0 * 50, 8.0 * 50),
    }
    out = {}
    for name, (kern, plain, lib, nbytes, ops) in cases.items():
        b_ms, b_by = bound(nbytes, ops)
        out[name] = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": 0,
            "max_abs_err": err[name], "ms": timer(kern),
            "device_ms": timer.graphed(kern),
            "plain_ms": timer(plain), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer(lib) if lib is not None else None,
        }
    return out


# ---------------------------------------------------------------- phase 2


def lineitem(rows: int, seed: int) -> dict:
    """TPC-H lineitem columns from dbgen's domains (spec §4.2.3)."""
    rng = np.random.default_rng(seed)
    qty = rng.integers(1, 51, rows).astype(np.int32)
    retail = np.round(rng.uniform(900.0, 2100.0, rows), 2)
    orderdate = rng.integers(8035, 10440, rows)       # 1992-01-01 .. 1998
    return {
        "L_QUANTITY": qty,
        "L_EXTENDEDPRICE": np.round(qty * retail, 2),
        "L_DISCOUNT": np.round(rng.integers(0, 11, rows) * 0.01, 2),
        "L_SHIPMODE": SHIP_MODES[rng.integers(0, len(SHIP_MODES), rows)],
        "L_SHIPDATE": (orderdate + rng.integers(1, 122, rows)).astype(
            np.int32),
    }


QUERIES = {
    "a": ("SELECT COUNT(*) AS c, SUM(L_EXTENDEDPRICE) AS s, "
          "MIN(L_EXTENDEDPRICE) AS mn, MAX(L_EXTENDEDPRICE) AS mx "
          "FROM lineitem WHERE L_EXTENDEDPRICE BETWEEN 20000 AND 40000"),
    "b": ("SELECT COUNT(*) AS c, SUM(L_EXTENDEDPRICE) AS s FROM lineitem "
          "WHERE L_DISCOUNT BETWEEN 0.05 AND 0.07"),
    "c": ("SELECT L_QUANTITY, SUM(L_EXTENDEDPRICE) AS rev FROM lineitem "
          "GROUP BY L_QUANTITY"),
    "d": ("SELECT L_SHIPMODE, COUNT(*) AS c, AVG(L_EXTENDEDPRICE) AS a "
          "FROM lineitem GROUP BY L_SHIPMODE"),
}
EXPECTED_ROUTE = {"a": "colscan", "b": "fused_decode_scan",
                  "c": "groupby_mxu", "d": "groupby_mxu"}


def expected(data: dict) -> dict:
    p, q = data["L_EXTENDEDPRICE"], data["L_QUANTITY"]
    sel = (p >= 20000) & (p <= 40000)
    dsel = (data["L_DISCOUNT"] >= 0.05) & (data["L_DISCOUNT"] <= 0.07)
    modes, inv = np.unique(data["L_SHIPMODE"], return_inverse=True)
    qs = np.unique(q)
    cnt = np.bincount(inv)
    return {
        "a": {"c": np.array([sel.sum()]), "s": np.array([p[sel].sum()]),
              "mn": np.array([p[sel].min()]), "mx": np.array([p[sel].max()])},
        "b": {"c": np.array([dsel.sum()]), "s": np.array([p[dsel].sum()])},
        "c": {"L_QUANTITY": qs,
              "rev": np.bincount(q, weights=p)[qs]},
        "d": {"L_SHIPMODE": modes, "c": cnt,
              "a": np.bincount(inv, weights=p) / cnt},
    }


def check(name: str, got: dict, want: dict) -> None:
    key = next(iter(want))
    order = np.argsort(np.asarray(got[key]), kind="stable")
    for col, w in want.items():
        g = np.asarray(got[col])[order]
        if g.shape != w.shape:
            fail(f"query {name} column {col}: shape {g.shape} != {w.shape}")
        if w.dtype.kind == "f":
            ok = np.allclose(g, w, rtol=1e-9, atol=0)
        else:
            ok = np.array_equal(g, w)
        if not ok or (w.dtype.kind == "f" and not np.all(np.isfinite(g))):
            fail(f"query {name} column {col}: {g[:5]} != {w[:5]}")


def phase_sql(torch, device, rows: int, seed: int) -> dict:
    from repro_torch.core import DType, Schema, SharkSession
    from repro_torch.core.pde import PDEConfig
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    data = lineitem(rows, seed)
    # the CPU rehearsal forces the kernel routes (their plain versions)
    rehearsal = device.type != "cuda"
    cfg = PDEConfig(segment_force_kernels=rehearsal,
                    reduce_force_compiled=rehearsal)
    sess = SharkSession(device=str(device), num_workers=8, max_threads=8,
                        default_shuffle_buckets=64, pde_config=cfg)
    sess.create_table("lineitem", Schema.of(
        L_QUANTITY=DType.INT32, L_EXTENDEDPRICE=DType.FLOAT64,
        L_DISCOUNT=DType.FLOAT64, L_SHIPMODE=DType.STRING,
        L_SHIPDATE=DType.DATE), data, num_partitions=PARTITIONS)
    want = expected(data)
    print(f"phase 2: lineitem {rows} rows in {PARTITIONS} partitions "
          f"loaded in {time.perf_counter() - t0:.3f} s", flush=True)

    def run(name: str) -> float:
        t = time.perf_counter()
        got = sess.sql_np(QUERIES[name])
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        check(name, got, want[name])
        return ms

    try:
        # first run: columns move to the card once and stay there
        first = {name: run(name) for name in QUERIES}
        # the main path's counted run
        ops.reset_launch_counts()
        timed = {name: [] for name in QUERIES}
        routes = {}
        for _ in range(REPS):
            for name in QUERIES:
                timed[name].append(run(name))
                routes[name] = sess.metrics().segment_routes()
        launches = ops.launch_counts()
    finally:
        sess.shutdown()
    for name in QUERIES:
        if routes[name].get(EXPECTED_ROUTE[name], 0) == 0:
            fail(f"query {name} took routes {routes[name]}, not "
                 f"{EXPECTED_ROUTE[name]}")
        print(f"query {name}: first {first[name]:.3f} ms, then "
              f"{', '.join(f'{m:.3f}' for m in timed[name])} ms; routes "
              f"{json.dumps(routes[name], sort_keys=True)}", flush=True)
    print(f"phase 2: main-path launches {json.dumps(launches)}", flush=True)
    if device.type == "cuda":
        idle = [k for k, v in launches.items() if v == 0]
        if idle:
            fail(f"kernels never launched on the main path: {idle}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=6_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        fail("no CUDA device (run with --device cpu to rehearse)")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{src}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, str(src))

    if device.type == "cuda":
        print(card_line(), flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]}", flush=True)
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.build_all()
        print(f"phase 0: kernels built in {time.perf_counter() - t0:.3f} s",
              flush=True)

    kernels = phase_kernels(torch, device, args.seed)
    launches = phase_sql(torch, device, args.rows, args.seed)
    for name, rec in kernels.items():
        rec["launches"] = launches[name]
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": torch.cuda.device_count()}
    else:
        dev = {"platform": "cpu", "kind": "cpu rehearsal", "count": 0}
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
