#!/usr/bin/env python3
"""Where the redesigned kernels spend their time, on one GPU.

    python3 scripts/kernel_probe.py [flash] [group] [ssd] [decode]
                                                       # default: all

1. flash: flash attention's tensor-core route at Zamba2-7B's prefill
   shape ((4, 32, 2048, 112) bf16, causal, in the model's (B, S, H, hd)
   layout): a copy of `csrc/flash.cu` with clock64() counters around each
   phase of a consumer warpgroup's key tile (stage wait, Q K^T, softmax,
   P V) and around a block's prologue and epilogue, built beside the
   kernels and run once; cycles per tile and per warpgroup.  The counters'
   atomics slow the kernel; the shares, not the sum, are the reading.
2. group: the group kernel at the SQL main path's partition (93,750 int32
   codes, float64 values, G = 50): device time of one call (a CUDA graph
   of 20 calls, replayed) under its own plan and under the plans it did
   not take — accumulator copies with float64 shared-memory atomics in
   place of lane-private sums, and 8 clusters of 16 blocks in place of one
   — beside `index_add_`; and the shared-memory atomics the compiler
   emitted.
3. ssd: the SSD scan's tensor-core route at Zamba2-7B's prefill shape (x
   (4, 2048, 64, 112) bf16 as the in-projection's slice, N = 64): a copy
   of `csrc/ssd.cu` with clock64() counters at the phases of a chunk
   (wait for the tiles, the dt * a scan, C . state, G = C B^T, M, M x,
   state update, epilogue), read by lane 0 of every warp; cycles per chunk
   and warp, and each phase's share.  Beside it, in turns, the device time
   of the shipped kernel and of copies that undo one design choice each
   (expf in place of ex2.approx; one block an SM in place of two), each
   held to chip_smoke.py's SSD tolerance, and each kernel's registers and
   spills from `nvcc -Xptxas -v`.
4. decode: `dict_decode` at phase 3's block (156,250 codes into 4,000
   float64 values): device time under one, two (its plan) and four 4-code
   steps a thread, and its `ms`, host cost included, against
   `dictionary[codes]` in turns.

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


def nvcc_build_all(sources: dict) -> dict:
    """{name: CUDA source text} -> {name: CDLL}, one nvcc each, in
    parallel, beside the kernels."""
    from repro_torch.kernels import _build
    build = _build.build_dir()
    build.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        stem = "probe_" + re.sub(r"\W+", "_", name)   # one file a build
        src, out = build / f"{stem}.cu", build / f"{stem}.so"
        src.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def probe_flash(torch, np) -> None:
    from repro_torch.kernels import _build, flash_attention as kf
    lib = nvcc_build_all({"flash": instrumented_flash(
        (_build.CSRC / "flash.cu").read_text())})["flash"]
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


# the phases of csrc/ssd.cu's tensor-core chunk loop, by their anchors
SSD_PHASES = ("wait", "scan", "cstate", "g", "m", "mx", "state",
              "epilogue")
SSD_PROBES = (
    ("// ------------------------------------------------ route 1: tensor "
     "cores",
     "\n__device__ unsigned long long g_probe[16];\n"
     "#define PROBE(i, v) atomicAdd(&g_probe[i], "
     "static_cast<unsigned long long>(v))\n"
     "#define STAMP(k) { const long long now_ = clock64(); "
     "if (lane == 0 && cur_ >= 0) PROBE(cur_, now_ - t_prev_); "
     "cur_ = (k); t_prev_ = now_; }\n"),
    ("  const int i0 = 16 * mt + g;",
     "\n  long long t_prev_ = clock64();\n  int cur_ = -1;"),
) + tuple((f"    // [phase {name}]", f"    STAMP({i});\n")
          for i, name in enumerate(SSD_PHASES)) + (
    ("  float* so = state_out + static_cast<long long>(bh) * P * N;\n"
     "#pragma unroll",
     None),
)


def instrumented_ssd(src: str) -> str:
    for anchor, code in SSD_PROBES:
        if src.count(anchor) != 1:
            raise SystemExit(f"csrc/ssd.cu changed: anchor {anchor!r} not "
                             f"found once; update kernel_probe.py")
        if code is None:        # after the walk: close the last phase
            src = src.replace(anchor, "  STAMP(-1);\n  if (lane == 0) "
                              "PROBE(9, 1);\n" + anchor)
        elif anchor.lstrip().startswith("// [phase"):   # before the phase
            src = src.replace(anchor, code + anchor)
        else:
            src = src.replace(anchor, anchor + code)
    # chunks walked, counted by lane 0 of every warp
    src = src.replace("    STAMP(0);", "    STAMP(0);\n    if (lane == 0) "
                      "PROBE(8, 1);")
    return src + (
        "\nextern \"C\" int shark_ssd_probe(unsigned long long* out, "
        "int reset) {\n"
        "  unsigned long long zero[16] = {0};\n"
        "  return reset ? cudaMemcpyToSymbol(g_probe, zero, sizeof(zero))\n"
        "               : cudaMemcpyFromSymbol(out, g_probe, "
        "sizeof(zero));\n}\n")


def ptxas_report(src: Path) -> dict:
    """Registers and spill bytes of each kernel in `src`, from ptxas."""
    from repro_torch.kernels import _build
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                          "-v", "-o", "/dev/null", str(src)],
                         capture_output=True, text=True)
    out, name = {}, None
    for line in (run.stdout + run.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            for short in ("ssd_fwd_tc", "ssd_fwd"):
                if short in name:
                    tmpl = re.search(r"ILi(\d+)ELi(\d+)E", name)
                    name = short + (f"<{tmpl.group(1)},{tmpl.group(2)}>"
                                    if tmpl else
                                    "<bf16>" if "bfloat16" in name
                                    else "<f32>")
                    break
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out.setdefault(name, {})["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


# the tensor-core route's design choices, undone one at a time: csrc/ssd.cu
# with expf where it takes ex2.approx on cum in log2 units, and with one
# block an SM where it asks for two (ptxas then spills nothing)
SSD_VARIANTS = {
    "expf, not ex2.approx": (
        ("const float a_h = a[h] * 1.4426950408889634f;",
         "const float a_h = a[h];"),
        ("const float e0 = ex2(cum_i0), e1 = ex2(cum_i1);",
         "const float e0 = expf(cum_i0), e1 = expf(cum_i1);"),
    ) + tuple((f"gacc[t][{k}] * ex2(cum_i{k // 2} - cj{k % 2})",
               f"gacc[t][{k}] * expf(cum_i{k // 2} - cj{k % 2})")
              for k in range(4)) + (
        ("const float el = ex2(cum_last);",
         "const float el = expf(cum_last);"),
        ("const float w0 = ex2(cum_last - cum0)",
         "const float w0 = expf(cum_last - cum0)"),
        ("const float w1 = ex2(cum_last - cum1)",
         "const float w1 = expf(cum_last - cum1)"),
    ),
    "one block an SM": (
        ("static constexpr int kBlocksPerSm = 2 * (kSmem + 1024) <= kSmSmem "
         "? 2 : 1;", "static constexpr int kBlocksPerSm = 1;"),
    ),
}


def patched(src: str, pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"csrc/ssd.cu changed: {old!r} not found once; "
                             f"update kernel_probe.py")
        src = src.replace(old, new)
    return src


def probe_ssd(torch, np) -> None:
    import chip_smoke
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ssd_scan as ks
    shipped = (_build.CSRC / "ssd.cu").read_text()
    libs = nvcc_build_all(
        {"instrumented": instrumented_ssd(shipped),
         **{name: patched(shipped, pairs)
            for name, pairs in SSD_VARIANTS.items()}})
    for lib in libs.values():
        lib.shark_ssd_scan.argtypes = _build.SIGNATURES["ssd"][1]
        lib.shark_ssd_scan.restype = ctypes.c_int
    read = libs["instrumented"].shark_ssd_probe
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    rng = np.random.default_rng(0)
    b, s, h, p, n = 4, 2048, 64, 112, 64
    dev = "cuda"
    xbc = torch.from_numpy(rng.normal(size=(b, s, h * p + 2 * n))).to(
        dev).to(torch.bfloat16)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = F.softplus(torch.from_numpy(rng.normal(size=(b, s, h))).to(
        dev).float())
    a = -torch.exp(torch.from_numpy(rng.normal(size=h)).to(dev).float())
    d = torch.ones(h, device=dev)
    yp, sp = ks.ssd_scan_plain(x, dt, a, bm, cm, 256, d=d)

    def caller(run):
        """One call of a build's entry point: bf16 (dtype code 4), route 1
        (tensor cores)."""
        def call():
            y = torch.empty((b, s, h, p), dtype=torch.bfloat16, device=dev)
            st = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
            rc = run(x.data_ptr(), 4, 1, x.stride(0), x.stride(1),
                     dt.data_ptr(), a.data_ptr(), d.data_ptr(), bm.data_ptr(),
                     bm.stride(0), bm.stride(1), cm.data_ptr(), cm.stride(0),
                     cm.stride(1), b, s, h, p, n, y.data_ptr(),
                     st.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"ssd probe build failed: cudaError {rc}")
            return y, st
        return call

    def beyond_tolerance(y, st):
        """chip_smoke.py's SSD tolerance: <= 0 inside it."""
        rtol = 1e-3 + chip_smoke.BF16_STEP
        return max(float(((y.float() - yp.float()).abs() - 1e-3
                          - rtol * yp.float().abs()).max()),
                   float(((st - sp).abs() - 1e-3 - 1e-3 * sp.abs()).max()))

    instrumented = caller(libs["instrumented"].shark_ssd_scan)
    instrumented()
    torch.cuda.synchronize()
    read(None, 1)
    y, st = instrumented()
    torch.cuda.synchronize()
    counts = (ctypes.c_ulonglong * 16)()
    read(ctypes.cast(counts, ctypes.c_void_p), 0)
    c = list(counts)
    warp_chunks, warps = c[8], c[9]
    per_chunk = {ph: c[i] / warp_chunks for i, ph in enumerate(SSD_PHASES)}
    timer = chip_smoke.Timer(torch, torch.device("cuda"))
    calls = {"shipped": caller(_build.kernel_fn("ssd"))}
    calls.update({name: caller(libs[name].shark_ssd_scan)
                  for name in SSD_VARIANTS})
    over = {name: beyond_tolerance(*call()) for name, call in calls.items()}
    device_ms = {}
    for name in list(calls) + list(reversed(list(calls))):   # in turns
        device_ms.setdefault(name, []).append(
            timer.graphed(calls[name], calls=5, replays=4))
    print(json.dumps({
        "probe": "ssd tensor-core route, cycles of one warp a chunk",
        "warps": warps, "warp_chunks": warp_chunks,
        "per_chunk": per_chunk,
        "share": {ph: v / sum(per_chunk.values())
                  for ph, v in per_chunk.items()},
        "instrumented_beyond_tolerance": beyond_tolerance(y, st),
        "device_ms_in_turns": device_ms,
        "beyond_tolerance": over,
        "ptxas": ptxas_report(_build.CSRC / "ssd.cu")}), flush=True)


def probe_decode(torch, np) -> None:
    """dict_decode at phase 3's block (156,250 int32 codes into 4,000
    float64 values): device time under 1, 2 (its plan) and 4 four-code
    steps a thread, and `ms` (host cost included) against
    `dictionary[codes]` in turns."""
    import chip_smoke
    from repro_torch.kernels import _build, dictdecode as kd
    n, d = 156_250, 4_000
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, d, n).astype(np.int32)).cuda()
    dic = torch.from_numpy(np.round(np.arange(d) * 0.01, 2)).cuda()
    want = kd.dict_decode_plain(codes, dic)
    fn = _build.kernel_fn("decode")
    timer = chip_smoke.Timer(torch, torch.device("cuda"))
    quads = -(-n // 4)

    def with_steps(steps):
        word = kd.DecodePlan(-(-quads // (256 * steps)), False).word(0, 3)

        def call():
            out = torch.empty(n, dtype=torch.float64, device="cuda")
            rc = fn(codes.data_ptr(), dic.data_ptr(), out.data_ptr(), n, d,
                    word, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"decode probe failed: cudaError {rc}")
            return out
        return call

    grids = {f"{k} step(s) a thread": with_steps(k) for k in (1, 2, 4)}
    for name, call in grids.items():
        if not torch.equal(call(), want):
            raise SystemExit(f"decode probe {name!r} differs from plain")
    device_ms = {}
    for name in list(grids) + list(reversed(list(grids))):
        device_ms.setdefault(name, []).append(timer.graphed(grids[name]))
    hosts = {"dict_decode": lambda: kd.dict_decode(codes, dic),
             "dictionary[codes]": lambda: dic[codes]}
    ms = {name: [] for name in hosts}
    for r in range(4):
        for name in (list(hosts) if r % 2 == 0 else reversed(list(hosts))):
            ms[name].append(timer(hosts[name], reps=200, warmup=20))
    print(json.dumps({"probe": "dict_decode, 156,250 codes, 4,000 float64",
                      "plan_blocks": kd.decode_plan(n, d, 8).blocks,
                      "device_ms_in_turns": device_ms,
                      "ms_in_turns": ms}), flush=True)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_probe: needs a CUDA device", file=sys.stderr)
        return 1
    probes = {"flash": probe_flash, "group": probe_group, "ssd": probe_ssd,
              "decode": probe_decode}
    chosen = sys.argv[1:] or list(probes)
    unknown = set(chosen) - set(probes)
    if unknown:
        print(f"kernel_probe: unknown probe(s) {sorted(unknown)}; choose from "
              f"{sorted(probes)}", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.build_all()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for name in chosen:
        probes[name](torch, np)
    return 0


if __name__ == "__main__":
    sys.exit(main())
