#!/usr/bin/env python3
"""Where the two redesigned kernels spend their time, on one GPU.

    python3 scripts/kernel_probe.py

1. Flash attention's tensor-core route at Zamba2-7B's prefill shape
   ((4, 32, 2048, 112) bf16, causal, in the model's (B, S, H, hd) layout):
   a copy of `csrc/flash.cu` with clock64() counters around each phase of
   a consumer warpgroup's key tile (stage wait, Q K^T, softmax, P V) and
   around a block's prologue and epilogue, built beside the kernels and run
   once; cycles per tile and per warpgroup.  The counters' atomics slow the
   kernel; the shares, not the sum, are the reading.
2. The group kernel at the SQL main path's partition (93,750 int32 codes,
   float64 values, G = 50): device time of one call (a CUDA graph of 20
   calls, replayed) under its own plan and under the plans it did not take
   — accumulator copies with float64 shared-memory atomics in place of
   lane-private sums, and 8 clusters of 16 blocks in place of one — beside
   `index_add_`; and the shared-memory atomics the compiler emitted.

Each line of output is one JSON object.  Needs a CUDA device and `nvcc`.
"""

from __future__ import annotations

import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# the consumer loop's anchors in csrc/flash.cu and the counters added there
PHASES = ("wait_full", "qk", "softmax", "pv")
PROBES = (
    ("// ------------------------------------------------ route 1: tensor "
     "cores",
     "\n__device__ unsigned long long g_probe[16];\n"
     "#define PROBE(i, v) atomicAdd(&g_probe[i], "
     "static_cast<unsigned long long>(v))\n"),
    ("  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;",
     "\n  const long long t_start = clock64();"),
    ("  mbar_wait(q_full, 0);\n",
     "  const bool lead = (tid & 127) == 0;\n"
     "  if (lead) PROBE(5, clock64() - t_start);\n"
     "  long long t0 = clock64(), t1, t2, t3;\n"),
    ("    mbar_wait(full0 + 8 * st, (kt / kTcStages) & 1);\n",
     "    t1 = clock64();\n    if (lead) PROBE(0, t1 - t0);\n"),
    ("    wgmma_wait_all();\n    reg_fence(s);\n",
     "    t2 = clock64();\n    if (lead) PROBE(1, t2 - t1);\n"),
    ("    // O += P V: k-step kk",
     None),
    ("    wgmma_wait_all();\n    reg_fence(acc);\n",
     "    t0 = clock64();\n"
     "    if (lead) { PROBE(3, t0 - t3); PROBE(4, 1); }\n"),
)


def instrumented_flash(src: str) -> str:
    for anchor, code in PROBES:
        if src.count(anchor) != 1:
            raise SystemExit(f"csrc/flash.cu changed: anchor {anchor!r} "
                             f"not found once; update kernel_probe.py")
        if code is None:        # before the P V product: softmax ends
            code = ("    t3 = clock64();\n    if (lead) PROBE(2, t3 - t2);\n")
            src = src.replace(anchor, code + anchor)
        else:
            src = src.replace(anchor, anchor + code)
    end = src.index("\n}\n", src.index("__nv_bfloat16* op = o + b * os.b"))
    src = (src[:end] + "\n  if (lead) { PROBE(6, clock64() - t0); "
           "PROBE(7, clock64() - t_start); PROBE(8, 1); }" + src[end:])
    return src + (
        "\nextern \"C\" int shark_flash_probe(unsigned long long* out, "
        "int reset) {\n"
        "  unsigned long long zero[16] = {0};\n"
        "  return reset ? cudaMemcpyToSymbol(g_probe, zero, sizeof(zero))\n"
        "               : cudaMemcpyFromSymbol(out, g_probe, "
        "sizeof(zero));\n}\n")


def nvcc_build(src: Path, out: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                          str(src)], capture_output=True, text=True)
    if run.returncode:
        raise SystemExit(f"nvcc failed for {src}:\n{run.stdout}{run.stderr}")
    return ctypes.CDLL(str(out))


def probe_flash(torch, np) -> None:
    from repro_torch.kernels import _build, flash_attention as kf
    build = _build.build_dir()
    build.mkdir(parents=True, exist_ok=True)
    src = build / "flash_probe.cu"
    src.write_text(instrumented_flash(
        (_build.CSRC / "flash.cu").read_text()))
    lib = nvcc_build(src, build / "flash_probe.so")
    run = lib.shark_flash_attention_fwd
    run.argtypes, run.restype = _build.SIGNATURES["flash"][1], ctypes.c_int
    read = lib.shark_flash_probe
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(4, 2048, 32, 112)))
               .to("cuda").to(torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    out = torch.empty_like(q)
    b, h, s, hd = q.shape

    def call():       # bf16 (dtype code 4), route 1, causal
        rc = run(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 4, 1, b, h, s, k.shape[2], hd, 1,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"instrumented flash failed: cudaError {rc}")

    call()
    torch.cuda.synchronize()
    read(None, 1)
    call()
    torch.cuda.synchronize()
    counts = (ctypes.c_ulonglong * 16)()
    read(ctypes.cast(counts, ctypes.c_void_p), 0)
    c = list(counts)
    want = kf.flash_attention_fwd_plain(q, k, v).float()
    rel = float((out.float() - want).abs().max() / want.abs().max())
    tiles, groups = c[4], c[8]
    per_tile = {p: c[i] / tiles for i, p in enumerate(PHASES)}
    print(json.dumps({
        "probe": "flash tensor-core route, cycles of one consumer "
                 "warpgroup", "key_tiles": tiles, "warpgroups": groups,
        "per_tile": per_tile,
        "share": {p: x / sum(per_tile.values()) for p, x in per_tile.items()},
        "per_warpgroup": {"prologue": c[5] / groups,
                          "epilogue": c[6] / groups,
                          "total": c[7] / groups},
        "rel_err_vs_plain": rel}), flush=True)


def probe_group(torch, np) -> None:
    import chip_smoke
    from repro_torch.kernels import _build, groupby_mxu as kg
    timer = chip_smoke.Timer(torch, torch.device("cuda"))
    n, g = 93_750, 50
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(np.round(rng.uniform(900, 105000, n), 2)).cuda()
    codes = torch.from_numpy(rng.integers(0, g, n).astype(np.int32)).cuda()
    want = kg.groupby_sum_plain(codes.cpu(), vals.cpu(), g).numpy()
    fn = _build.kernel_fn("group")
    own = kg.group_plan(n, g, False)

    def with_plan(plan):
        clusters = plan.blocks // plan.cluster
        extra = clusters * 2 * g + 1 if clusters > 1 else 0
        word = plan.word(False) | 3 << 2          # int32 codes, float64

        def call():
            buf = torch.empty(2 * g + extra, dtype=torch.float64,
                              device="cuda")
            rc = fn(codes.data_ptr(), vals.data_ptr(), n, g, word,
                    buf.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"group kernel failed: cudaError {rc}")
            return buf[:2 * g].view(g, 2)
        return call

    copies = own._replace(lane_sums=False)
    plans = {"own plan (lane sums, 1 cluster of 16)": own,
             "atomic copies, 1 cluster of 16": copies,
             "lane sums, 8 clusters of 16": own._replace(blocks=128),
             "atomic copies, 8 clusters of 16": copies._replace(blocks=128)}
    stacked = torch.stack([vals, torch.ones_like(vals)], dim=1)
    calls = {name: with_plan(p) for name, p in plans.items()}
    calls["index_add_"] = lambda: torch.zeros(
        (g, 2), dtype=torch.float64, device="cuda").index_add_(
            0, codes, stacked)
    for name, call in calls.items():
        got = call().cpu().numpy()
        if not (np.array_equal(got[:, 1], want[:, 1])
                and np.allclose(got[:, 0], want[:, 0], rtol=1e-12)):
            raise SystemExit(f"group probe {name!r} differs from plain")
    device_ms = {}
    for name in list(calls) + list(reversed(list(calls))):   # in turns
        device_ms.setdefault(name, []).append(timer.graphed(calls[name]))
    lib = next(iter(sorted(_build.build_dir().glob("group-*.so"))))
    sass = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"),
                           "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    atomics = collections.Counter(re.findall(r"\bATOMS\.[A-Z0-9.]+", sass))
    print(json.dumps({"probe": "group kernel, 93,750 rows, G = 50",
                      "device_ms_in_turns": device_ms,
                      "shared_atomics_in_sass": dict(atomics)}), flush=True)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_probe: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    _build.build_all()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    probe_flash(torch, np)
    probe_group(torch, np)
    return 0


if __name__ == "__main__":
    sys.exit(main())
