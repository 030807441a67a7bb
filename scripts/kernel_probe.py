#!/usr/bin/env python3
"""Where the redesigned kernels spend their time, on one GPU.

    python3 scripts/kernel_probe.py [flash] [group] [ssd] [decode] [train]
                                    [bitpack] [topk] [rle] [scan] [radix]
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

5. train: `train_grad` at phase 3's partition (156,250 x 12 float32,
   logistic): device time of one call on its register route under grids
   of twice, once (its plan), a half, a quarter and an eighth its blocks,
   and of copies that undo one design choice each (the two-branch
   sigmoid; no register cap; 2 rows a lane a step in place of 4)
   under three of them, each with the rows a lane takes and the blocks an
   SM holds at once (the occupancy API); beside them, in turns, the
   chunked route at the same shape, the linear residual and the library's
   `x.T @ (sigmoid(x @ w) - y)`; per-block timestamps of an instrumented
   copy (when blocks start, end their loop and their partial row, and the
   fold's span); ptxas's registers and spills of the d <= 16 float32
   kernels.
6. bitpack: the batched bit-pack decode of a phase-3 partition (8 BITPACK
   features of 1-4 bits into float32 x (n, 12), a 1-bit label into y)
   against the per-column sequence it replaced (bitpack_decode's int32
   lanes, the int64 bias, the casts, the stack), `ms` and device time in
   turns in one process; the same batched call into 9 contiguous vectors
   (stride 1); copies of the kernel that undo one design choice each (the
   columns' constants read from the parameter bank; tiles of 64 rows in
   place of 128); per-block timestamps of an instrumented copy (start
   after the constants' staging, end).
7. topk: `topk_similarity` at phase 4's partition (15,625 x 64 float32,
   k = 100): device time in turns of the fused route under its plan (62
   blocks, the threshold fold), the rounds fold, grids of 31 and 16
   blocks (several tiles a block), copies with 256-byte stage chunks, 128
   bytes of lane loads in flight and 8-entry fold prefixes, the lanes
   entry, the rounds route (the previous kernels), `topk(x @ q)` and a
   one-element `fill_` (a launch that does nothing); per-block timestamps of an
   instrumented copy (a block's start, its first tile scored, its sorts
   and merges done, and the fold's span in the last block with the end
   of each step of its fast path), for the matrix and the lanes entries;
   ptxas's registers and spills.
8. rle: `rle_decode` at phase 3's column (156,250 positions in runs of 8,
   float64): `ms` and device time in turns of the shipped kernel, into a
   float32 column of a row-major (n, 12) x, 2,048-position tiles, the
   per-position search of all ends that it replaced, decode-then-`copy_`
   and `repeat_interleave`; per-block timestamps (start, runs bounded,
   runs staged, end).
9. scan: `colscan` and `fused_decode_scan` at phase 2's partition (93,750
   rows: query a's one float64 column, two float64 columns, query b's
   int32 codes into 11 float64 values with a float64 aggregate): device
   time in turns of the plan (132 blocks) against 66 and 264 blocks,
   copies of `csrc/scan.cu` with 8 and 16 rows a thread, scalar loads,
   the branch on the predicate (the aggregate loaded after the test),
   block 0 polling words the other blocks post with relaxed stores (no
   fence, no atomic), the cluster fold over 16 blocks and no fold at all,
   the dictionary through `__ldg`, and a one-element `fill_`; per-block
   timestamps (start, loads issued, scan done, ticket passed, fold done);
   the plan, 264 blocks, 16 and 8 warps a block and scalar loads at 10^7
   rows beside the bound; ptxas's registers and spills.
10. radix: `radix_split` of int64 keys into 64 buckets at a lineitem
   partition of query e (93,750 keys, 23 one-tile chunks) and at
   10,000,000 keys (2,442 tiles in 245 chunks): device time in turns of
   the plan against copies of `csrc/radix.cu` that undo one design choice
   each — tiles of 2,048 and 8,192 rows in place of 4,096, a look-back
   window of one word a lane in place of 8, a warp's ranks and counts
   from `__match_any_sync` peers and counters in shared memory (the path
   of B > 64) in place of bucket-bit ballots and counters in registers,
   and that path with one shared atomic a row in place of the match
   (timing only: its order within a bucket is not stable) — the two launches of route two_launch
   (a histogram launch, then the scatter) in place of the look-back, and a
   one-element `fill_`; per-block timestamps of an instrumented copy (a
   block's start, its phase 1 done, the done count reached, its end, and
   its time in look-back); ptxas's registers and spills.

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
                 None, 4, 1, b, h, k.shape[1], s, k.shape[2], hd, 1,
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
            tmpl = re.search(r"(grad_registers|grad_chunked)I([fd])"
                             r"(?:Li(\d+)E)?Lb(\d)E", name)
            if tmpl:
                kind, t, dpad, logistic = tmpl.groups()
                name = (f"{kind}<{'float' if t == 'f' else 'double'}"
                        f"{',' + dpad if dpad else ''},"
                        f"{'logistic' if logistic == '1' else 'linear'}>")
            tmpl = re.search(r"scan_kernelI(\w)(\w)Li(\d)E", name)
            if tmpl:
                name = f"scan_kernel<{','.join(tmpl.groups())}>"
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
            raise SystemExit(f"a csrc/ source changed: {old!r} not found "
                             f"once; update kernel_probe.py")
        src = src.replace(old, new)
    return src


# per-block timestamps (the global nanosecond timer) for the train and
# bit-pack probes: g_ts[4 b .. 4 b + 3] = block start, end of its main
# phase, end of its last phase, its SM; g_fold = the fold's start and end
TIMESTAMPS = (
    "\n__device__ unsigned long long g_ts[4 * 4096];\n"
    "__device__ unsigned long long g_fold[2];\n"
    "__device__ __forceinline__ unsigned long long gtime() {\n"
    "  unsigned long long t;\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
    "  return t;\n}\n"
    "__device__ __forceinline__ unsigned smid() {\n"
    "  unsigned s;\n  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(s));\n"
    "  return s;\n}\n"
    "#define STAMP_BLOCK(a, b) if (threadIdx.x == 0 && blockIdx.x < 4096) "
    "{ g_ts[4 * blockIdx.x] = (a); g_ts[4 * blockIdx.x + 1] = (b); "
    "g_ts[4 * blockIdx.x + 2] = gtime(); g_ts[4 * blockIdx.x + 3] = "
    "smid(); }\n")
TIMESTAMP_READER = (
    "\nextern \"C\" int shark_ts_read(unsigned long long* ts, "
    "unsigned long long* fold) {\n"
    "  int rc = cudaMemcpyFromSymbol(ts, g_ts, sizeof(g_ts));\n"
    "  return rc ? rc : cudaMemcpyFromSymbol(fold, g_fold, "
    "sizeof(g_fold));\n}\n")
# the occupancy query the train probe adds to each copy of train.cu it
# builds: blocks of the plan word's kernel one SM holds at once (the
# compiler's registers and the shared memory allow)
TRAIN_OCCUPANCY = """
extern "C" int shark_train_occupancy(unsigned long long word, int d) {
  const Plan pl(word);
  const void* kernel =
      pl.f64 ? pick_kernel<double>(pl) : pick_kernel<float>(pl);
  if (kernel == nullptr || d < 1 || d > kMaxDims) return -1;
  int blocks = 0;
  const size_t smem = pl.width_class == 0 ? chunked_smem(d) : 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}
"""
TRAIN_STAMPS = (
    ("constexpr int kMaxDims = 2048;\n", "constexpr int kMaxDims = 2048;\n"
     + TIMESTAMPS),
    ("  if (!s_last) return;\n", "  if (!s_last) return;\n"
     "  const unsigned long long tf0 = gtime();\n"),
    ("  if (t == 0) *ticket = 0u;", "  if (t == 0) { g_fold[0] = tf0; "
     "g_fold[1] = gtime(); }\n  if (t == 0) *ticket = 0u;"),
    ("  __shared__ double s_warp[kWarps][D];\n  const int t = threadIdx.x;\n",
     "  __shared__ double s_warp[kWarps][D];\n  const int t = threadIdx.x;\n"
     "  const unsigned long long ts0 = gtime();\n"),
    ("  // lanes that own the same chunk add across the warp",
     "  const unsigned long long ts1 = gtime();\n"
     "  // lanes that own the same chunk add across the warp"),
    ("    partials[static_cast<long long>(blockIdx.x) * d + t] = s;\n  }\n"
     "  fold_if_last(",
     "    partials[static_cast<long long>(blockIdx.x) * d + t] = s;\n  }\n"
     "  STAMP_BLOCK(ts0, ts1);\n  fold_if_last("),
)
BITPACK_STAMPS = (
    ("constexpr int kTileRows = 128;\n", "constexpr int kTileRows = 128;\n"
     + TIMESTAMPS),
    ("  __syncthreads();\n  for (int r0 = blockIdx.x * kTileRows; r0 < n;",
     "  __syncthreads();\n  const unsigned long long ts0 = gtime();\n"
     "  for (int r0 = blockIdx.x * kTileRows; r0 < n;"),
    ("          orig_cast<O>(static_cast<long long>(lane) + cc.bias, "
     "cc.odt);\n    }\n  }\n",
     "          orig_cast<O>(static_cast<long long>(lane) + cc.bias, "
     "cc.odt);\n    }\n  }\n  STAMP_BLOCK(ts0, ts0);\n"),
)
# the bit-pack kernel's design choices, undone one at a time: its loop
# reading each column's constants from the parameter bank (the shipped
# kernel stages them in shared memory), and 64-row tiles in place of 128
BITPACK_VARIANTS = {
    "columns read from the parameter bank": (
        ("      const ColConst& cc = s_col[c];",
         "      const ColConst cc = col_const(batch.col[c]);"),),
    "64-row tiles": (
        ("constexpr int kTileRows = 128;", "constexpr int kTileRows = 64;"),),
}


def block_timeline(np, ts, fold, blocks: int) -> dict:
    """Microseconds from the first block's start: when blocks start and end
    their main phase and their last, and the fold's span."""
    ts = np.asarray(ts[:4 * blocks], np.float64).reshape(blocks, 4)
    t0 = ts[:, 0].min()
    main = (ts[:, 1] - ts[:, 0]) / 1e3
    rest = (ts[:, 2] - ts[:, 1]) / 1e3
    out = {"blocks": blocks, "sms_used": int(len(set(ts[:, 3]))),
           "last_block_start_us": float((ts[:, 0].max() - t0) / 1e3),
           "main_phase_us": [float(np.percentile(main, q))
                             for q in (0, 50, 100)],
           "last_phase_us": [float(np.percentile(rest, q))
                             for q in (0, 50, 100)],
           "last_block_end_us": float((ts[:, 2].max() - t0) / 1e3)}
    if fold[1]:
        out["fold_us"] = [float((fold[0] - t0) / 1e3),
                          float((fold[1] - t0) / 1e3)]
    return out


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


# the register route's choices, undone one at a time: the sigmoid's two
# branches (a warp whose rows differ in sign ran both), no cap on the
# registers a thread (the linear residual then took 122, 2 blocks an SM),
# and 2 rows a lane a step in place of 4
TRAIN_VARIANTS = {
    "two-branch sigmoid": (
        ("  const double e = exp(-fabs(z));\n"
         "  return (z >= 0.0 ? 1.0 : e) / (1.0 + e);",
         "  if (z >= 0.0) return 1.0 / (1.0 + exp(-z));\n"
         "  const double e = exp(z);\n  return e / (1.0 + e);"),),
    "no register cap": (
        ("__global__ void __launch_bounds__(kThreads, 3)\ngrad_registers(",
         "__global__ void __launch_bounds__(kThreads)\ngrad_registers("),),
    "2 rows a lane a step": (
        ("  constexpr int kRows = 4;", "  constexpr int kRows = 2;"),),
}


def probe_train(torch, np) -> None:
    """train_grad's register route at phase 3's partition under five
    grids, and copies that undo one design choice each under three, with
    the occupancy each gets; the chunked route, the linear residual and the
    library call beside them, in turns; per-block timestamps."""
    import chip_smoke
    from repro_torch.kernels import _build, train_grad as kg
    n, d, sms = 156_250, 12, torch.cuda.get_device_properties(0) \
        .multi_processor_count
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).cuda()
    y = torch.from_numpy((rng.uniform(size=n) < 0.5).astype(np.float32)) \
        .cuda()
    w = torch.from_numpy(rng.normal(size=d).astype(np.float32)).cuda()
    want = kg.train_grad_plain(x, y, w).cpu().numpy()
    ticket = kg._ticket(x.device, _build.stream_handle(x.device))
    timer = chip_smoke.Timer(torch, torch.device("cuda"))
    plan = kg.train_plan(n, d, torch.float32)
    src = (_build.CSRC / "train.cu").read_text()
    libs = nvcc_build_all(dict(
        {"train_ts": patched(src, TRAIN_STAMPS) + TIMESTAMP_READER,
         "shipped": src + TRAIN_OCCUPANCY},
        **{name: patched(src, pairs) + TRAIN_OCCUPANCY
           for name, pairs in TRAIN_VARIANTS.items()}))
    entries = {}
    for name in ["shipped", *TRAIN_VARIANTS]:
        f, occ = libs[name].shark_train_grad, libs[name].shark_train_occupancy
        f.argtypes = _build.SIGNATURES["train"][1]
        occ.argtypes = [ctypes.c_ulonglong, ctypes.c_int]
        entries[name] = (f, occ)

    def call_of(entry, width_class, blocks, logistic=True):
        fn, occupancy = entries[entry]
        word = kg.TrainPlan("", width_class, blocks).word(False, logistic)
        buf = torch.empty(d + blocks * d, dtype=torch.float64,
                          device="cuda")

        def call():
            rc = fn(x.data_ptr(), y.data_ptr(), w.data_ptr(), n, d, word,
                    buf.data_ptr(), ticket.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"train probe failed: cudaError {rc}")
            return buf[:d]
        return call, occupancy(word, d)

    # lanes a row on the register route: d padded, over 4 float32 a chunk
    tpr = (2 << plan.width_class) // 4
    variants, info = {}, {}
    grids = (2 * plan.blocks, plan.blocks, -(-plan.blocks // 2),
             -(-plan.blocks // 4), -(-plan.blocks // 8))
    for entry in entries:
        for blocks in (grids if entry == "shipped" else grids[1:4]):
            name = f"{entry}, {blocks} blocks"
            variants[name], resident = call_of(entry, plan.width_class,
                                               blocks)
            info[name] = {"rows_a_lane": n / (blocks * 256 / tpr),
                          "resident_blocks_per_sm": resident,
                          "waves": blocks / (resident * sms)}
    name = f"chunked, {plan.blocks} blocks"
    variants[name], resident = call_of("shipped", 0, plan.blocks)
    info[name] = {"resident_blocks_per_sm": resident}
    for name, call in variants.items():
        got = call().cpu().numpy()
        if not np.allclose(got, want, rtol=1e-12, atol=1e-9):
            raise SystemExit(f"train probe {name!r} differs from plain")
    variants["shipped, linear residual"] = call_of(
        "shipped", plan.width_class, plan.blocks, logistic=False)[0]
    variants["library x.T @ (sigmoid(x @ w) - y)"] = \
        lambda: x.T @ (torch.sigmoid(x @ w) - y)
    device_ms = {}
    for name in list(variants) + list(reversed(list(variants))):
        device_ms.setdefault(name, []).append(timer.graphed(variants[name]))
    # where one call's time goes: per-block timestamps of an instrumented
    # copy at the plan's grid
    lib = libs["train_ts"]
    f = lib.shark_train_grad
    f.argtypes = _build.SIGNATURES["train"][1]
    buf = torch.empty(d + plan.blocks * d, dtype=torch.float64,
                      device="cuda")
    word = plan.word(False, True)
    timeline = []
    for _ in range(3):
        rc = f(x.data_ptr(), y.data_ptr(), w.data_ptr(), n, d, word,
               buf.data_ptr(), ticket.data_ptr(),
               torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        ts = (ctypes.c_ulonglong * (4 * 4096))()
        fold = (ctypes.c_ulonglong * 2)()
        rc = rc or lib.shark_ts_read(ts, fold)
        if rc:
            raise SystemExit(f"train timestamps failed: {rc}")
        timeline.append(block_timeline(np, ts, fold, plan.blocks))
    if not np.allclose(buf[:d].cpu().numpy(), want, rtol=1e-12, atol=1e-9):
        raise SystemExit("instrumented train_grad differs from plain")
    ptxas = {k: v for k, v in ptxas_report(_build.CSRC / "train.cu").items()
             if "float" in k}
    print(json.dumps({"probe": "train_grad, 156,250 x 12 float32, logistic",
                      "plan_blocks": plan.blocks, "sms": sms,
                      "grids": info, "device_ms_in_turns": device_ms,
                      "timeline_us": timeline, "ptxas": ptxas}),
          flush=True)


def probe_bitpack(torch, np) -> None:
    """The batched bit-pack call of a phase-3 partition against the
    per-column sequence it replaced, and into contiguous vectors."""
    import chip_smoke
    from repro_torch.core.compression import Encoding, bitpack_block, encode
    from repro_torch.kernels import _build, dictdecode as kd
    n, dims = 156_250, 12
    rng = np.random.default_rng(0)
    encs = [encode(rng.integers(0, span, n).astype(np.int64),
                   Encoding.BITPACK) for span in chip_smoke.INT_SPANS + (2,)]
    blocks = [bitpack_block(e, "cuda") for e in encs]
    buf = torch.empty(n * (dims + 1), dtype=torch.float32, device="cuda")
    x = buf[:n * dims].view(n, dims)
    dests = [x[:, j] for j in range(len(blocks) - 1)] + [buf[n * dims:]]
    flat = [torch.empty(n, dtype=torch.float32, device="cuda")
            for _ in blocks]

    def per_column():
        cols = [(kd.bitpack_decode(b.words, b.bit_width, 0, n)
                 .to(torch.int64) + b.bias).to(b.dtype).to(torch.float32)
                for b in blocks]
        return torch.stack(cols[:-1], dim=1), cols[-1]

    src = (_build.CSRC / "decode.cu").read_text()
    libs = nvcc_build_all(dict(
        {"bitpack_ts": patched(src, BITPACK_STAMPS) + TIMESTAMP_READER},
        **{name: patched(src, pairs)
           for name, pairs in BITPACK_VARIANTS.items()}))
    entry = {}
    for name, lib in libs.items():
        entry[name] = lib.shark_bitpack
        entry[name].argtypes = _build.SIGNATURES["bitpack"][1]
    descs = kd.pack_bitpack_descriptors(blocks, dests)

    def raw(name):
        tile = re.search(r"(\d+)-row tiles", name)
        grid = re.search(r"(\d+) blocks", name)
        word = kd.DecodePlan(-(-n // int(tile.group(1))) if tile
                             else int(grid.group(1)) if grid
                             else kd.bitpack_plan(n).blocks,
                             False).word(kd._OP_BITPACK, 2)

        def call():
            rc = entry[name](descs.ctypes.data, len(blocks), n, word,
                             torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"bitpack probe {name} failed: {rc}")
        return call

    calls = {"batched into x and y":
             lambda: kd.bitpack_decode_into(blocks, dests, n),
             "batched into contiguous vectors":
             lambda: kd.bitpack_decode_into(blocks, flat, n),
             "per-column sequence": per_column}
    calls.update({name: raw(name) for name in BITPACK_VARIANTS})
    calls["batched into x and y"]()
    calls["batched into contiguous vectors"]()
    xs, ys = per_column()
    if not (torch.equal(x[:, :len(blocks) - 1], xs)
            and torch.equal(buf[n * dims:], ys)
            and all(torch.equal(f, dst) for f, dst in zip(flat, dests))):
        raise SystemExit("bitpack probe: the batched call differs from the "
                         "per-column sequence")
    for name in BITPACK_VARIANTS:
        x.zero_()
        raw(name)()
        if not torch.equal(x[:, :len(blocks) - 1], xs):
            raise SystemExit(f"bitpack probe: variant {name!r} differs")
    timer = chip_smoke.Timer(torch, torch.device("cuda"))
    ms, device_ms = {name: [] for name in calls}, {name: [] for name in calls}
    for r in range(4):
        order = list(calls) if r % 2 == 0 else list(reversed(list(calls)))
        for name in order:
            ms[name].append(timer(calls[name], reps=200, warmup=20))
            device_ms[name].append(timer.graphed(calls[name]))
    timeline = []
    for _ in range(3):
        raw("bitpack_ts")()
        torch.cuda.synchronize()
        ts = (ctypes.c_ulonglong * (4 * 4096))()
        fold = (ctypes.c_ulonglong * 2)()
        if libs["bitpack_ts"].shark_ts_read(ts, fold):
            raise SystemExit("bitpack timestamps failed")
        timeline.append(block_timeline(np, ts, fold,
                                       kd.bitpack_plan(n).blocks))
    print(json.dumps({"probe": "bit-pack, phase 3's partition: 9 blocks of "
                               "156,250 rows, 1-4 bits, float32",
                      "widths": [b.bit_width for b in blocks],
                      "plan_blocks": kd.bitpack_plan(n).blocks,
                      "ms_in_turns": ms,
                      "device_ms_in_turns": device_ms,
                      "timeline_us": timeline,
                      "ptxas": ptxas_report(_build.CSRC / "decode.cu")}),
          flush=True)


# sub-phase timestamps: g_sub[i] = the global timer when thread 0 passes
# point i (the fold's steps; RLE: each block's end of its run search)
SUB_STAMPS = (
    "__device__ unsigned long long g_sub[4096];\n"
    "#define SUB(i) if (threadIdx.x == 0) g_sub[i] = gtime();\n")
SUB_READER = (
    "\nextern \"C\" int shark_sub_read(unsigned long long* sub) {\n"
    "  return cudaMemcpyFromSymbol(sub, g_sub, sizeof(g_sub));\n}\n")
# per-block timestamps of the fused top-k: a block's start, the end of its
# first tile's scoring, the end of its tiles' sorts and merges; the fold's
# span in the last block and its fast path's steps
TOPK_STAMPS = (
    ("constexpr int kSmemLimit = 232448 - 1024;  // dynamic; the rest is "
     "static\n", "constexpr int kSmemLimit = 232448 - 1024;  // dynamic; the "
     "rest is static\n" + TIMESTAMPS + SUB_STAMPS),
    ("  int cur = 0, len = 0;\n",
     "  int cur = 0, len = 0;\n  const unsigned long long ts0 = gtime();\n"
     "  unsigned long long ts1 = 0;\n"),
    ("      const double s = valid ? score_lanes<T>(l, d, first + t) : 0.0;\n",
     "      const double s = valid ? score_lanes<T>(l, d, first + t) : 0.0;\n"
     "      if (i == 0) ts1 = gtime();\n"),
    ("      if (c == chunks - 1) {\n",
     "      if (c == chunks - 1) {\n"
     "        if (s == chunks - 1) ts1 = gtime();\n"),
    ("  const double* ls = run_s + cur * m;\n",
     "  STAMP_BLOCK(ts0, ts1);\n  const double* ls = run_s + cur * m;\n"),
    ("  fold_lists(a, L, smem, g);\n",
     "  const unsigned long long tf0 = gtime();\n  fold_lists(a, L, smem, g);\n"
     "  if (t == 0) { g_fold[0] = tf0; g_fold[1] = gtime(); }\n"),
    ("  const int j = __syncthreads_count(t < kPrefix && cj[t] < m) + 1;\n",
     "  SUB(0);\n"
     "  const int j = __syncthreads_count(t < kPrefix && cj[t] < m) + 1;\n"),
    ("  // each list's prefix no worse than the bound, within the entries "
     "read:\n",
     "  SUB(1);\n  // each list's prefix no worse than the bound, within "
     "the entries read:\n"),
    ("  const int total = s_total;\n",
     "  const int total = s_total;\n  SUB(2);\n"),
    ("    a.out_r[t] = r;\n  }\n  return true;\n",
     "    a.out_r[t] = r;\n  }\n  SUB(3);\n  return true;\n"),
)
FOLD_STEPS = ("prefixes read", "bound found", "survivors gathered",
              "placed")
# the fused route's choices, undone one at a time: stages of 256-byte row
# chunks in place of 128, 128 bytes of lane loads in flight in place of 256
TOPK_VARIANTS = {
    "256-byte chunks": (
        ("constexpr int kChunkBytes = 128; ",
         "constexpr int kChunkBytes = 256; "),),
    "128 lane bytes in flight": (
        ("constexpr int kLaneBytes = 256; ",
         "constexpr int kLaneBytes = 128; "),),
    "8-entry prefixes": (
        ("constexpr int kPrefix = 16; ", "constexpr int kPrefix = 8; "),),
}


def probe_topk(torch, np) -> None:
    """topk_similarity at phase 4's partition (15,625 x 64 float32, k =
    100): device time of the fused route under its plan (62 blocks, the
    threshold fold) and under other grids, the rounds fold, copies that
    undo one design choice each, the lanes entry, the rounds route (the
    previous kernels) and `topk(x @ q)`, in turns; per-block timestamps of
    an instrumented copy, for the matrix and the lanes entries."""
    import chip_smoke
    from repro_torch.kernels import _build, topk_similarity as kt
    n, d, k = chip_smoke.DOCS_ROWS, chip_smoke.EMB_DIM, chip_smoke.TOP_K
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).cuda()
    w = rng.normal(size=d)
    q = torch.from_numpy(w).cuda()
    q32 = q.float()
    lanes = [x[:, j].contiguous() for j in range(d)]
    desc = kt.pack_lane_descriptors(lanes, w)
    want = kt.topk_similarity_plain(x, q, k)
    src = (_build.CSRC / "topk.cu").read_text()
    libs = nvcc_build_all(dict(
        {"topk_ts": patched(src, TOPK_STAMPS) + TIMESTAMP_READER
         + SUB_READER},
        **{name: patched(src, pairs) for name, pairs in TOPK_VARIANTS.items()}))
    entry = {"shipped": _build.kernel_fn("topk_fused")}
    for name, lib in libs.items():
        entry[name] = lib.shark_topk_fused
        entry[name].argtypes = _build.SIGNATURES["topk_fused"][1]
    ticket = kt._ticket(x.device)
    plan = kt.topk_plan(n, d, k, torch.float32)
    lplan = kt.topk_plan(n, d, k, torch.float32, lanes=True)

    def raw(name, plan, lanes_entry=False):
        buf = torch.empty(plan.buffer_words(), dtype=torch.int64,
                          device="cuda")

        def call():
            rc = entry[name](
                None if lanes_entry else x.data_ptr(),
                desc.ctypes.data if lanes_entry else None, 2,
                None if lanes_entry else q.data_ptr(), n, d, plan.m,
                plan.word(), buf.data_ptr(), ticket.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"topk probe {name} failed: {rc}")
            return buf[k:2 * k].view(torch.float64), buf[:k]
        return call

    rounds = kt.TopkPlan("rounds", k, plan.tiles, 0, "threshold")
    one = torch.zeros(1, device="cuda")
    calls = {
        f"fused, {plan.blocks} blocks (plan), threshold fold":
            raw("shipped", plan),
        f"fused, {plan.blocks} blocks, rounds fold":
            raw("shipped", plan._replace(fold="rounds")),
        "fused, 31 blocks (2 tiles a block)":
            raw("shipped", plan._replace(blocks=31)),
        "fused, 16 blocks (4 tiles a block)":
            raw("shipped", plan._replace(blocks=16)),
        "lanes entry, 62 blocks": raw("shipped", lplan, True),
        "rounds route (the previous kernels)": lambda: kt._launch(
            rounds, x.data_ptr(), None, 2, q.data_ptr(), n, d, k, x.device),
        "library topk(x @ q)": lambda: torch.topk(x @ q32, k),
        "a one-element fill_ (one launch, no work)": lambda: one.fill_(1.0),
    }
    calls.update({f"{name}, {plan.blocks} blocks": raw(name, plan)
                  for name in TOPK_VARIANTS})
    calls["128 lane bytes in flight, lanes entry"] = raw(
        "128 lane bytes in flight", lplan, True)
    for name, call in calls.items():
        if "library" in name or "fill_" in name:
            continue
        got = call()
        if not (torch.equal(got[1], want[1]) and torch.equal(
                got[0].view(torch.int64), want[0].view(torch.int64))):
            raise SystemExit(f"topk probe {name!r} differs from plain")
    timer = chip_smoke.Timer(torch, torch.device("cuda"))
    device_ms = {name: [] for name in calls}
    for r in range(4):
        order = list(calls) if r % 2 == 0 else list(reversed(list(calls)))
        for name in order:
            device_ms[name].append(timer.graphed(calls[name]))
    timeline = {}
    for label, lanes_entry, pl in (("matrix", False, plan),
                                   ("lanes", True, lplan)):
        timeline[label] = []
        for _ in range(3):
            raw("topk_ts", pl, lanes_entry)()
            torch.cuda.synchronize()
            ts = (ctypes.c_ulonglong * (4 * 4096))()
            fold = (ctypes.c_ulonglong * 2)()
            sub = (ctypes.c_ulonglong * 4096)()
            if libs["topk_ts"].shark_ts_read(ts, fold) \
                    or libs["topk_ts"].shark_sub_read(sub):
                raise SystemExit("topk timestamps failed")
            rec = block_timeline(np, ts, fold, pl.blocks)
            t0 = min(ts[4 * b] for b in range(pl.blocks))
            rec["fold_steps_us"] = {
                step: (sub[i] - t0) / 1e3 if sub[i] >= fold[0] else None
                for i, step in enumerate(FOLD_STEPS)}
            timeline[label].append(rec)
    print(json.dumps({"probe": "topk_similarity, 15,625 x 64 float32, "
                               "k = 100",
                      "plan": plan._asdict(),
                      "smem_bytes": kt.fused_smem(d, False, k, plan.blocks),
                      "device_ms_in_turns": device_ms,
                      "timeline_us": timeline,
                      "ptxas": {key: v for key, v in ptxas_report(
                          _build.CSRC / "topk.cu").items()
                          if "fused" in key}}), flush=True)


# per-block timestamps of rle_decode: a block's start, the end of its first
# tile's run search (g_sub) and staging, its end
RLE_STAMPS = (
    ("constexpr int kRleStage = kRleTile;  // runs it stages\n",
     "constexpr int kRleStage = kRleTile;  // runs it stages\n" + TIMESTAMPS
     + SUB_STAMPS),
    ("  const long long tiles = (n + kRleTile - 1) / kRleTile;\n",
     "  const long long tiles = (n + kRleTile - 1) / kRleTile;\n"
     "  const unsigned long long ts0 = gtime();\n"
     "  unsigned long long ts1 = 0;\n"),
    ("    bound_ends(ends, r, p0, p0 + pn - 1, &a0, &a1);   // (barriers "
     "inside)\n",
     "    bound_ends(ends, r, p0, p0 + pn - 1, &a0, &a1);   // (barriers "
     "inside)\n"
     "    if (tile == blockIdx.x && threadIdx.x == 0 && blockIdx.x < 4096) "
     "g_sub[blockIdx.x] = gtime();\n"),
    ("    const int last = static_cast<int>(r - 1 - a0);   // the clamp, "
     "locally\n",
     "    if (tile == blockIdx.x) ts1 = gtime();\n"
     "    const int last = static_cast<int>(r - 1 - a0);   // the clamp, "
     "locally\n"),
    ("    __syncthreads();          // the stage is read before the next "
     "tile's\n  }\n",
     "    __syncthreads();          // the stage is read before the next "
     "tile's\n  }\n  STAMP_BLOCK(ts0, ts1);\n"),
)
RLE_VARIANTS = {
    "2048-position tiles": (
        ("constexpr int kRleTile = 1024; ",
         "constexpr int kRleTile = 2048; "),),
}
# the kernel this PR replaced, for its device time in the same process:
# each position binary-searches all r ends in device memory
RLE_SEARCH = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void rle_search(const int32_t* __restrict__ ends,
                           const double* __restrict__ vals, long long r,
                           long long n, double* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * 256;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n; i += stride) {
    long long lo = 0, hi = r;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (static_cast<long long>(__ldg(ends + mid)) <= i) lo = mid + 1;
      else hi = mid;
    }
    out[i] = __ldg(vals + (lo < r - 1 ? lo : r - 1));
  }
}
extern "C" int shark_rle_search(const int32_t* ends, const double* vals,
                                long long r, long long n, double* out,
                                int blocks, cudaStream_t stream) {
  rle_search<<<blocks, 256, 0, stream>>>(ends, vals, r, n, out);
  return static_cast<int>(cudaGetLastError());
}
"""


def probe_rle(torch, np) -> None:
    """rle_decode at phase 3's column (156,250 positions in runs of 8,
    float64 values): device time of the shipped kernel, into a float32
    column of a row-major (n, 12) x, with 1,024-position tiles, the
    per-position search it replaced, decode-then-copy_ and
    `repeat_interleave`, in turns; per-block timestamps."""
    import chip_smoke
    from repro_torch.kernels import _build, dictdecode as kd
    n = chip_smoke.TRAIN_ROWS
    runs = n // 8
    rng = np.random.default_rng(0)
    ends = torch.from_numpy(np.cumsum(np.full(runs, 8)).astype(np.int32)) \
        .cuda()
    lengths = torch.full((runs,), 8, dtype=torch.int64, device="cuda")
    vals = torch.from_numpy(rng.normal(size=runs)).cuda()
    x = torch.empty((n, 12), dtype=torch.float32, device="cuda")
    out = torch.empty(n, dtype=torch.float64, device="cuda")
    want = kd.rle_decode_plain(vals, ends, n)
    src = (_build.CSRC / "decode.cu").read_text()
    libs = nvcc_build_all(dict(
        {"rle_ts": patched(src, RLE_STAMPS) + TIMESTAMP_READER + SUB_READER,
         "rle_search": RLE_SEARCH},
        **{name: patched(src, pairs) for name, pairs in RLE_VARIANTS.items()}))
    search = libs["rle_search"].shark_rle_search
    search.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]

    def raw(name, tile=kd.RLE_TILE):
        fn = getattr(libs[name], "shark_decode")
        fn.argtypes = _build.SIGNATURES["decode"][1]
        word = kd.DecodePlan(-(-n // tile), False).word(kd._OP_RLE, 3) \
            | 3 << 23 | kd.RLE_KEEP << 25 | 1 << 32

        def call():
            rc = fn(ends.data_ptr(), vals.data_ptr(), out.data_ptr(), n, runs,
                    word, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"rle probe {name} failed: {rc}")
            return out
        return call

    def searched():
        rc = search(ends.data_ptr(), vals.data_ptr(), runs, n,
                    out.data_ptr(), -(-n // 1024),
                    torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"rle search probe failed: {rc}")
        return out

    calls = {
        f"rle_decode ({kd.rle_plan(n).blocks} blocks of {kd.RLE_TILE:,})":
            lambda: kd.rle_decode(vals, ends, n),
        "rle_decode_into a float32 column of x":
            lambda: kd.rle_decode_into(vals, ends, n, x[:, 10]),
        "decode then copy_ into the column":
            lambda: x[:, 10].copy_(kd.rle_decode(vals, ends, n)),
        "2048-position tiles": raw("2048-position tiles", 2048),
        "per-position search of all ends (the previous kernel)": searched,
        # its n is the runs' 156,248 positions (the kernels clamp the last
        # two to the last run)
        "library repeat_interleave": lambda: torch.repeat_interleave(
            vals, lengths, output_size=8 * runs),
    }
    for name in (next(iter(calls)), "2048-position tiles",
                 "per-position search of all ends (the previous kernel)"):
        if not torch.equal(calls[name](), want):
            raise SystemExit(f"rle probe {name!r} differs from plain")
    timer = chip_smoke.Timer(torch, torch.device("cuda"))
    ms, device_ms = {name: [] for name in calls}, {name: [] for name in calls}
    for r in range(4):
        order = list(calls) if r % 2 == 0 else list(reversed(list(calls)))
        for name in order:
            ms[name].append(timer(calls[name], reps=200, warmup=20))
            device_ms[name].append(timer.graphed(calls[name]))
    timeline = []
    for _ in range(3):
        raw("rle_ts")()
        torch.cuda.synchronize()
        ts = (ctypes.c_ulonglong * (4 * 4096))()
        fold = (ctypes.c_ulonglong * 2)()
        sub = (ctypes.c_ulonglong * 4096)()
        if libs["rle_ts"].shark_ts_read(ts, fold) \
                or libs["rle_ts"].shark_sub_read(sub):
            raise SystemExit("rle timestamps failed")
        blocks = kd.rle_plan(n).blocks
        rec = block_timeline(np, ts, fold, blocks)
        search = np.array([sub[b] - ts[4 * b] for b in range(blocks)]) / 1e3
        rec["run_search_us"] = [float(np.percentile(search, q))
                                for q in (0, 50, 100)]
        timeline.append(rec)
    print(json.dumps({"probe": "rle_decode, 156,250 positions in runs of 8, "
                               "float64",
                      "plan_blocks": kd.rle_plan(n).blocks,
                      "ms_in_turns": ms, "device_ms_in_turns": device_ms,
                      "timeline_us": timeline}), flush=True)


# per-block timestamps of the scan: a block's start, its first step's
# loads issued (and a staged dictionary's stage), its scan and block fold
# done; the fold's span (the ticket passed, the answer written) in the
# last block
SCAN_STAMPS = (
    ("constexpr int kMaxStageBytes = 32 * 1024;  // under the 48 KB default\n",
     "constexpr int kMaxStageBytes = 32 * 1024;  // under the 48 KB default\n"
     + TIMESTAMPS),
    ("  extern __shared__ double s_dict[];\n",
     "  extern __shared__ double s_dict[];\n"
     "  const unsigned long long ts0 = gtime();\n"
     "  unsigned long long ts1 = 0;\n"),
    ("    while (tile < full) {\n",
     "    ts1 = gtime();\n    while (tile < full) {\n"),
    ("  acc = block_fold(acc);\n  if (threadIdx.x >= 32) return;",
     "  acc = block_fold(acc);\n  STAMP_BLOCK(ts0, ts1);\n"
     "  if (threadIdx.x >= 32) return;"),
    ("  __syncwarp();                             // lane 0's acquire, for "
     "the warp\n",
     "  __syncwarp();                             // lane 0's acquire, for "
     "the warp\n  const unsigned long long tb = gtime();\n"),
    ("  a = warp_fold(a);\n  if (lane == 0) put(args.out, a);\n}\n",
     "  a = warp_fold(a);\n  if (lane == 0) put(args.out, a);\n"
     "  if (lane == 0) { g_fold[0] = tb; g_fold[1] = gtime(); }\n}\n"),
)
# the folds the ticket was held against, spliced in after the blocks' own
# folds: block 0 gathering the others' results from 8 marked words a
# block, posted with relaxed stores and polled (no fence, no atomic; it
# lost: block 0 polled for about 3.5 us, PERF.md), and one thread-block
# cluster (16 blocks at most, the non-portable size; block 0 folds over
# distributed shared memory after a cluster barrier)
SCAN_ONE_BLOCK = """  if (gridDim.x == 1) {
    if (threadIdx.x == 0) put(args.out, acc);
    return;
  }
"""
SCAN_POLL_DECLS = ("__device__ unsigned long long g_words[8 * 1024];"
                   "\n\n" + '// The words a block posts its result in: 8 a block, each a 32-bit half\n// of one of its 4 doubles under a nonzero mark in the high 32 bits, so a\n// word read with the mark set holds this launch\'s half whatever order the\n// words land in.  Relaxed stores and loads at gpu scope: no fence.\n__device__ __forceinline__ void post_raw(unsigned long long* p,\n                                         unsigned long long v) {\n  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v)\n               : "memory");\n}\n__device__ __forceinline__ void post(unsigned long long* p,\n                                     unsigned long long half) {\n  post_raw(p, (1ULL << 32) | half);\n}\n__device__ __forceinline__ unsigned long long peek(\n    const unsigned long long* p) {\n  unsigned long long v;\n  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)\n               : "memory");\n  return v;\n}\n\n')
SCAN_POLL_TAIL = SCAN_ONE_BLOCK + "  unsigned long long* words = g_words;\n  if (blockIdx.x != 0) {\n    // lanes 0-7 of warp 0 post the block's result (lane 0's) as 8 words\n    if (threadIdx.x < 8) {\n      const int k = threadIdx.x >> 1;\n      const double cnt = static_cast<double>(__shfl_sync(0xffu, acc.cnt, 0));\n      const double sum = __shfl_sync(0xffu, acc.sum, 0);\n      const double mn = __shfl_sync(0xffu, acc.mn, 0);\n      const double mx = __shfl_sync(0xffu, acc.mx, 0);\n      const unsigned long long bits = static_cast<unsigned long long>(\n          __double_as_longlong(k == 0 ? cnt : k == 1 ? sum : k == 2 ? mn\n                                                                    : mx));\n      post(words + 8 * blockIdx.x + threadIdx.x,\n           (threadIdx.x & 1) ? bits >> 32 : bits & 0xffffffffULL);\n    }\n    return;\n  }\n  // block 0 gathers: thread t takes blocks t, t + blockDim.x, ... in\n  // order (its own result for block 0), each once its 8 words are posted,\n  // clearing them for the next launch on the stream; then the block's\n  // fold in a fixed order\n  const Acc own = acc;\n  Acc a = empty_acc();\n  for (unsigned int b = threadIdx.x; b < gridDim.x; b += blockDim.x) {\n    if (b == 0) {\n      a = join(a, own);\n      continue;\n    }\n    unsigned long long* w = words + 8 * b;\n    unsigned long long x[8];\n    bool ready;\n    do {\n#pragma unroll\n      for (int k = 0; k < 8; ++k) x[k] = peek(w + k);\n      ready = true;\n#pragma unroll\n      for (int k = 0; k < 8; ++k) ready = ready && (x[k] >> 32) != 0;\n    } while (!ready);\n#pragma unroll\n    for (int k = 0; k < 8; ++k) post_raw(w + k, 0ULL);\n    double f[4];\n#pragma unroll\n    for (int k = 0; k < 4; ++k)\n      f[k] = __longlong_as_double(static_cast<long long>(\n          (x[2 * k] & 0xffffffffULL) | (x[2 * k + 1] << 32)));\n    Acc q;\n    q.cnt = static_cast<long long>(f[0]);\n    q.sum = f[1];\n    q.mn = f[2];\n    q.mx = f[3];\n    a = join(a, q);\n  }\n  a = block_fold(a);\n  if (threadIdx.x == 0) put(args.out, a);\n}\n"
SCAN_CLUSTER_TAIL = SCAN_ONE_BLOCK + """  __shared__ double s_blk[4];
  if (threadIdx.x == 0) put(s_blk, acc);
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0 && threadIdx.x < 32) {
    Acc a = empty_acc();
    if (lane < static_cast<int>(cluster.num_blocks())) {
      const double* p = cluster.map_shared_rank(s_blk, lane);
      a.cnt = static_cast<long long>(p[0]);
      a.sum = p[1];
      a.mn = p[2];
      a.mx = p[3];
    }
    a = warp_fold(a);
    if (lane == 0) put(args.out, a);
  }
  cluster.sync();
}
"""
SCAN_CLUSTER_LAUNCH = """  auto kernel = scan_kernel<F, A, kMode>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
"""


def scan_tail_variant(src: str, tail: str, decls: str = "",
                      cluster: bool = False) -> str:
    """csrc/scan.cu with `tail` in place of the ticket fold after the
    blocks' own folds (and `decls` after the constants; `cluster`:
    launched as one thread-block cluster)."""
    head = "  acc = block_fold(acc);\n  if (threadIdx.x >= 32) return;"
    tail_end = "  a = warp_fold(a);\n  if (lane == 0) put(args.out, a);\n}\n"
    partials = ("constexpr int kMaxStageBytes = 32 * 1024;  // under the 48 "
                "KB default\n")
    launch = ("  scan_kernel<F, A, kMode><<<blocks, 32 * warps, smem, "
              "stream>>>(a);\n  return static_cast<int>(cudaGetLastError());"
              "\n")
    for anchor in (head, tail_end, partials, launch,
                   "#include <cuda_runtime.h>\n"):
        if src.count(anchor) != 1:
            raise SystemExit(f"csrc/scan.cu changed: {anchor!r} not found "
                             f"once; update kernel_probe.py")
    i = src.index(head) + len("  acc = block_fold(acc);\n")
    j = src.index(tail_end) + len(tail_end)
    src = src[:i] + tail + src[j:]
    src = src.replace(partials, partials + decls)
    if cluster:
        src = src.replace(launch, SCAN_CLUSTER_LAUNCH).replace(
            "#include <cuda_runtime.h>\n",
            "#include <cooperative_groups.h>\n#include <cuda_runtime.h>\n")
    return src


# the scan's choices, undone one at a time: 8 and 16 rows a thread in
# place of 4, scalar loads in place of 8- and 16-byte vectors, and the
# aggregate loaded only for the rows that pass, behind a branch
SCAN_VARIANTS = {
    "8 rows a thread": (("constexpr int kRows = 4; ",
                         "constexpr int kRows = 8; "),),
    "16 rows a thread": (("constexpr int kRows = 4; ",
                          "constexpr int kRows = 16; "),),
    "scalar loads": (
        ("    run(std::true_type{});\n  else\n", "    run(std::false_type{});"
         "\n  else\n"),),
    "branch, the aggregate loaded after the test": (
        ("          if constexpr (kMode != kSame) a[s * kW + j] = __ldg(ap + "
         "r);\n", ""),
        ("        if constexpr (kMode != kSame) load_vec<A, kW>(ap + i, a + s "
         "* kW);\n", ""),
        ("      double v;\n      if constexpr (kMode == kSame)\n        v = "
         "fv[k];\n      else\n        v = static_cast<double>(a[k]);\n"
         "      const bool sel = (!kMask || row(base, k) < n) && lo <= fv[k] "
         "&&\n                       fv[k] <= hi;\n"
         "      acc.cnt += sel;\n      acc.sum += sel ? v : 0.0;\n"
         "      acc.mn = sel ? nan_min(acc.mn, v) : acc.mn;\n"
         "      acc.mx = sel ? nan_max(acc.mx, v) : acc.mx;\n",
         "      const long long r = row(base, k);\n"
         "      if ((!kMask || r < n) && lo <= fv[k] && fv[k] <= hi) {\n"
         "        double v;\n        if constexpr (kMode == kSame)\n"
         "          v = fv[k];\n        else\n"
         "          v = static_cast<double>(__ldg(ap + r));\n"
         "        acc.cnt += 1;\n        acc.sum += v;\n"
         "        acc.mn = nan_min(acc.mn, v);\n"
         "        acc.mx = nan_max(acc.mx, v);\n      }\n"),
        ("  template <bool kMask>\n  __device__ __forceinline__ void "
         "fold(",
         "  const A* ap;\n  template <bool kMask>\n  __device__ "
         "__forceinline__ void fold("),
        ("  T t;\n", "  T t;\n  t.ap = ap;\n"),),
}
SCAN_ROWS = {"8 rows a thread": 8, "16 rows a thread": 16}


def scan_grid(n: int, cap: int = 132, rows: int = 4, max_warps: int = 32):
    """(blocks, warps a block) of a scan grid: colscan.scan_plan's rule
    with another block cap, rows a thread or warps a block."""
    tiles = max(1, -(-n // (32 * rows)))
    blocks = min(cap, tiles)
    return blocks, min(max_warps, -(-tiles // blocks))


def probe_scan(torch, np) -> None:
    """colscan and fused_decode_scan at phase 2's partition (93,750 rows:
    query a's one float64 column, two float64 columns, query b's int32
    codes into 11 float64 values and a float64 aggregate): device time in
    turns of the plan (132 blocks), 66 and 264 blocks, copies of scan.cu
    with 8 and 16 rows a thread, scalar loads, the branch on the predicate
    with the aggregate loaded after it, block 0 polling the blocks' posted
    words, the cluster fold over 16 blocks and no fold at all, the
    dictionary read through __ldg, and a one-element `fill_`; per-block
    timestamps of the plan; at 10^7 rows the plan, 264 blocks, 16 and 8
    warps a block and scalar loads beside the bound; ptxas's registers
    and spills."""
    import chip_smoke
    from repro_torch.kernels import _build, colscan as kc, dictdecode as kd
    from repro_torch.launch.cost import H100
    hbm = H100.hbm_bytes_per_s
    src = (_build.CSRC / "scan.cu").read_text()
    sources = {
        "scan_ts": patched(src, SCAN_STAMPS) + TIMESTAMP_READER,
        "block 0 polls posted words": scan_tail_variant(
            src, SCAN_POLL_TAIL, SCAN_POLL_DECLS),
        "cluster fold": scan_tail_variant(src, SCAN_CLUSTER_TAIL,
                                          cluster=True),
        # blocks stop after their own fold: the fold's cost, by difference
        "no fold (timing only)": scan_tail_variant(src, "}\n")}
    sources.update({name: patched(src, pairs)
                    for name, pairs in SCAN_VARIANTS.items()})
    libs = nvcc_build_all(sources)
    entry = {"shipped": _build.kernel_fn("scan")}
    for name, lib in libs.items():
        entry[name] = lib.shark_scan
        entry[name].argtypes = _build.SIGNATURES["scan"][1]
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def operands(n):
        price = torch.from_numpy(np.round(rng.uniform(900, 105000, n), 2)
                                 ).to(dev)
        other = torch.from_numpy(np.round(rng.uniform(900, 105000, n), 2)
                                 ).to(dev)
        codes = torch.from_numpy(rng.integers(0, 11, n).astype(np.int32)
                                 ).to(dev)
        disc = torch.from_numpy(np.round(np.arange(11) * 0.01, 2)).to(dev)
        return {"a": (price, None, price, 20000.0, 40000.0, 8 * n + 32),
                "1b": (other, None, price, 20000.0, 40000.0, 16 * n + 32),
                "b": (codes, disc, price, 0.05, 0.07, 12 * n + 88 + 32)}

    def raw(name, case, grid, staged=None):
        filt, dic, agg, lo, hi, _ = case
        n = agg.shape[0]
        coded = dic is not None
        blocks, warps = grid
        if staged is None:
            staged = coded and kc.scan_staged(n, 11)
        word = (3 | 3 << 2 | int(coded) << 4 | int(filt is agg) << 5
                | int(staged) << 6 | warps << 7 | blocks << 13
                | (11 if coded else 0) << 25)
        buf = torch.empty(4 + 4 * blocks, dtype=torch.float64, device=dev)

        def call():
            stream = torch.cuda.current_stream().cuda_stream
            rc = entry[name](filt.data_ptr(),
                             dic.data_ptr() if coded else None,
                             agg.data_ptr(), n, word, lo, hi, buf.data_ptr(),
                             kc._ticket(dev, stream).data_ptr(), stream)
            if rc:
                raise SystemExit(f"scan probe {name} failed: {rc}")
            return buf[:4]
        return call

    def wrapper(case):
        filt, dic, agg, lo, hi, _ = case
        if dic is None:
            return lambda: kc.colscan(filt, agg, lo, hi)
        return lambda: kd.fused_decode_scan(filt, dic, agg, lo, hi)

    def plain(case):
        filt, dic, agg, lo, hi, _ = case
        if dic is None:
            return kc.colscan_plain(filt, agg, lo, hi)
        return kd.fused_decode_scan_plain(filt, dic, agg, lo, hi)

    def check(label, got, want):
        g, w = got.cpu().numpy(), want.cpu().numpy()
        if not (g[0] == w[0] and g[2] == w[2] and g[3] == w[3]
                and abs(g[1] - w[1]) <= 1e-12 * abs(w[1]) + 1e-9):
            raise SystemExit(f"scan probe {label!r} differs from plain: "
                             f"{g} {w}")

    timer = chip_smoke.Timer(torch, dev)
    one = torch.zeros(1, device=dev)
    n = 6_000_000 // chip_smoke.PARTITIONS        # phase 2's partition
    cases = operands(n)
    calls = {}
    for q, case in cases.items():
        plan = kc.scan_plan(n)
        calls[f"{q}: plan ({plan.blocks} blocks of {plan.warps} warps)"] = (
            wrapper(case), case)
        for cap in (66, 264):
            b, w = scan_grid(n, cap)
            calls[f"{q}: {b} blocks of {w} warps"] = (
                raw("shipped", case, (b, w)), case)
        for name in SCAN_VARIANTS:
            calls[f"{q}: {name}"] = (raw(name, case, scan_grid(
                n, rows=SCAN_ROWS.get(name, 4))), case)
        calls[f"{q}: block 0 polls posted words"] = (
            raw("block 0 polls posted words", case, scan_grid(n)), case)
        calls[f"{q}: cluster fold, 16 blocks"] = (
            raw("cluster fold", case, scan_grid(n, 16)), case)
        calls[f"{q}: no fold (timing only)"] = (
            raw("no fold (timing only)", case, scan_grid(n)), case)
        if q == "b":
            calls["b: dictionary through __ldg"] = (
                raw("shipped", case, scan_grid(n), staged=False), case)
    for label, (call, case) in calls.items():
        if "timing only" not in label:
            check(label, call(), plain(case))
    calls["a one-element fill_ (one launch, no work)"] = (
        lambda: one.fill_(1.0), None)
    device_ms = {label: [] for label in calls}
    for r in range(4):
        order = list(calls) if r % 2 == 0 else list(reversed(list(calls)))
        for label in order:
            device_ms[label].append(timer.graphed(calls[label][0]))
    timeline = {}
    for q in ("a", "b"):
        call = raw("scan_ts", cases[q], scan_grid(n))
        timeline[q] = []
        for _ in range(3):
            call()
            torch.cuda.synchronize()
            ts = (ctypes.c_ulonglong * (4 * 4096))()
            fold = (ctypes.c_ulonglong * 2)()
            if libs["scan_ts"].shark_ts_read(ts, fold):
                raise SystemExit("scan timestamps failed")
            timeline[q].append(block_timeline(np, ts, fold,
                                              scan_grid(n)[0]))
    print(json.dumps({"probe": "scan at 93,750 rows",
                      "bound_ms": {q: c[5] / hbm * 1e3
                                   for q, c in cases.items()},
                      "device_ms_in_turns": device_ms,
                      "timeline_us": timeline}), flush=True)
    del cases, calls
    big = 10_000_000
    cases = operands(big)
    out = {}
    for q in ("1b", "b", "a"):
        case = cases[q]
        want = plain(case)
        runs = {"plan": wrapper(case)}
        for label, grid in (("264 blocks", scan_grid(big, 264)),
                            ("16 warps a block", scan_grid(big,
                                                           max_warps=16)),
                            ("8 warps a block", scan_grid(big,
                                                          max_warps=8))):
            runs[f"{label} ({grid[0]} x {grid[1]})"] = raw("shipped", case,
                                                          grid)
        runs["scalar loads"] = raw("scalar loads", case, scan_grid(big))
        rec = {"bound_ms": case[5] / hbm * 1e3}
        for label, call in runs.items():
            check(f"{q} {label} at 10^7", call(), want)
            rec[label] = [timer.graphed(call, calls=5, replays=4)
                          for _ in range(2)]
        out[q] = rec
    print(json.dumps({"probe": "scan at 10^7 rows", "plan":
                      kc.scan_plan(big)._asdict(), "device_ms": out,
                      "ptxas": ptxas_report(_build.CSRC / "scan.cu")}),
          flush=True)


# radix.cu's one-launch route with per-block timestamps: g_rts[8 b ..
# 8 b + 7] = start, phase 1 done, the done count reached, end, SM, and
# the ns of phase 1 in look-back, in ranking (one-tile chunks) and in
# counting (longer chunks)
RADIX_STAMPS = (
    ("constexpr uint32_t kField = 0x7fffffffu;\n",
     "constexpr uint32_t kField = 0x7fffffffu;\n"
     "__device__ unsigned long long g_rts[8 * 4096];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("  uint32_t bk[kRows], rk[kRows];\n",
     "  uint32_t bk[kRows], rk[kRows];\n"
     "  const unsigned long long ts0 = gtime();\n"
     "  unsigned long long tlb = 0, trk = 0, thi = 0;\n"),
    ("      look_back(p, c, ex);\n",
     "      const unsigned long long tl0 = gtime();\n"
     "      look_back(p, c, ex);\n      tlb += gtime() - tl0;\n"),
    ("      tile_ranks<k64, kReg>(p, c, bk, rk, hw, cnt);\n      kept = c;\n",
     "      const unsigned long long tr0 = gtime();\n"
     "      tile_ranks<k64, kReg>(p, c, bk, rk, hw, cnt);\n      kept = c;\n"
     "      trk += gtime() - tr0;\n"),
    ("      chunk_hist<k64, kReg>(p, c * K, min(p.tiles, (c + 1) * K), cnt);"
     "\n      __syncthreads();\n",
     "      const unsigned long long th0 = gtime();\n"
     "      chunk_hist<k64, kReg>(p, c * K, min(p.tiles, (c + 1) * K), cnt);"
     "\n      __syncthreads();\n      thi += gtime() - th0;\n"),
    ("  if (threadIdx.x == 0) {\n    if (taken > 0) {",
     "  const unsigned long long ts1 = gtime();\n"
     "  if (threadIdx.x == 0) {\n    if (taken > 0) {"),
    ("  // phase 2: the bucket starts",
     "  const unsigned long long ts2 = gtime();\n"
     "  // phase 2: the bucket starts"),
    ("  // the block to exit last leaves the scratch",
     "  if (threadIdx.x == 0 && blockIdx.x < 4096) {\n"
     "    unsigned long long* r = g_rts + 8 * blockIdx.x;\n"
     "    unsigned sm;\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
     "    r[0] = ts0; r[1] = ts1; r[2] = ts2; r[3] = gtime(); r[4] = sm;\n"
     "    r[5] = tlb; r[6] = trk; r[7] = thi;\n  }\n"
     "  // the block to exit last leaves the scratch"),
)
RADIX_READER = (
    "\nextern \"C\" int shark_rts_read(unsigned long long* ts) {\n"
    "  return cudaMemcpyFromSymbol(ts, g_rts, sizeof(g_rts));\n}\n")
# the one-launch route's choices, undone one at a time; B = 64 sent down
# the path of B > 64 (per-warp counts in shared memory, match-any peers)
RADIX_SMEM = ("    if (B <= kRegBuckets)\n", "    if (false)\n")
RADIX_VARIANTS = {
    "tiles of 2,048 rows": (("constexpr int kRows = 16; ",
                             "constexpr int kRows = 8; "),),
    "tiles of 8,192 rows": (("constexpr int kRows = 16; ",
                             "constexpr int kRows = 32; "),),
    "look-back window of 1": (("constexpr int kWindow = 8; ",
                               "constexpr int kWindow = 1; "),),
    "match-any ranks in shared memory, not ballots": (RADIX_SMEM,),
    "shared atomics, not match-any (timing only)": (
        RADIX_SMEM,
        ("          const unsigned peers = __match_any_sync(0xffffffffu, "
         "bk[s]);\n"
         "          if (bk[s] < p.B && (peers & lt) == 0)\n"
         "            atomicAdd(cnt + bk[s], static_cast<uint32_t>(__popc("
         "peers)));\n",
         "          if (bk[s] < p.B) atomicAdd(cnt + bk[s], 1u);\n"),
        ("        const unsigned peers = __match_any_sync(0xffffffffu, b);\n"
         "        const uint32_t pre = b < B ? mine[b] : 0;\n"
         "        rk[s] = pre + __popc(peers & lt);\n"
         "        __syncwarp();\n"
         "        if (b < B && (peers & lt) == 0) mine[b] = pre + "
         "__popc(peers);\n        __syncwarp();\n",
         "        rk[s] = b < B ? atomicAdd(mine + b, 1u) : 0u;\n"),),
}
RADIX_TILES = {"tiles of 2,048 rows": 2048, "tiles of 8,192 rows": 8192}


def probe_radix(torch, np) -> None:
    """radix_split of int64 keys into 64 buckets at 93,750 and 10^7 keys:
    device time in turns of the plan, the copies of radix.cu in
    RADIX_VARIANTS, route two_launch and a one-element fill_; per-block
    timestamps of an instrumented copy; ptxas's registers and spills."""
    import chip_smoke
    from repro_torch.kernels import _build, radix_partition as rp
    from repro_torch.kernels._common import stream_ticket
    b = chip_smoke.RADIX_BUCKETS
    src = (_build.CSRC / "radix.cu").read_text()
    libs = nvcc_build_all(dict(
        {"radix_ts": patched(src, RADIX_STAMPS) + RADIX_READER},
        **{name: patched(src, pairs)
           for name, pairs in RADIX_VARIANTS.items()}))
    dev = torch.device("cuda", torch.cuda.current_device())
    timer = chip_smoke.Timer(torch, dev)
    one = torch.zeros(1, device=dev)

    def raw(name, keys, route="one_launch", tile=rp.TILE):
        fn = getattr(libs[name], "shark_radix")
        fn.argtypes = _build.SIGNATURES["radix"][1]
        n = int(keys.shape[0])
        if route == "one_launch":
            chunks, per = rp.one_launch_chunks(n, tile)
            plan = rp.RadixPlan(route, chunks, chunks, per, n + b + 1,
                                2 + chunks * b, 1)
        else:
            chunks = min(rp.CHUNKS_MAX, max(1, -(-n // rp.TILE)))
            rows = -(-max(1, -(-n // chunks)) // 32) * 32
            plan = rp.RadixPlan(route, chunks, 0, rows,
                                n + b + 1 + chunks * b, 2, 2)
        word = plan.word(True, rp.SPLIT)

        def call():
            stream = _build.stream_handle(dev)
            out = torch.empty(plan.size, dtype=torch.int32, device=dev)
            scratch = stream_ticket(rp._SCRATCH, dev, stream, "radix",
                                    rp.SCRATCH_WORDS, torch.int64)
            rc = fn(keys.data_ptr(), n, b, word, out.data_ptr(),
                    scratch.data_ptr(), stream)
            if rc:
                raise SystemExit(f"radix probe {name} failed: {rc}")
            return out[:n], out[n:n + b + 1]
        return call

    shipped = "radix_ts"        # the instrumented copy, timed as the plan
    results = []
    for n in (chip_smoke.RADIX_ROWS["medium"], chip_smoke.RADIX_ROWS["large"]):
        keys = torch.from_numpy(chip_smoke.radix_keys(
            np.random.default_rng(n), n)).to(dev)
        want = rp.radix_split_plain(keys, b)
        calls = {"plan": lambda: rp.radix_split(keys, b)}
        for name in RADIX_VARIANTS:
            calls[name] = raw(name, keys, tile=RADIX_TILES.get(name,
                                                               rp.TILE))
        calls["two launches (route two_launch)"] = raw(shipped, keys,
                                                       "two_launch")
        for label, call in calls.items():
            order, bounds = call()
            if not torch.equal(bounds, want[1]):
                raise SystemExit(f"radix probe {label!r}: bounds differ")
            if "timing only" not in label and not torch.equal(order,
                                                              want[0]):
                raise SystemExit(f"radix probe {label!r}: order differs")
        calls["a one-element fill_ (one launch, no work)"] = \
            lambda: one.fill_(1.0)
        reps = 20 if n < 10 ** 6 else 5
        device_ms = {label: [] for label in calls}
        for r in range(4):
            order = list(calls) if r % 2 == 0 else list(reversed(list(calls)))
            for label in order:
                device_ms[label].append(timer.graphed(calls[label],
                                                      calls=reps, replays=4))
        stamped = raw(shipped, keys)
        timeline = []
        chunks = rp.one_launch_chunks(n)[0]
        for _ in range(3):
            stamped()
            torch.cuda.synchronize()
            ts = (ctypes.c_ulonglong * (8 * 4096))()
            if libs[shipped].shark_rts_read(ts):
                raise SystemExit("radix timestamps failed")
            t = np.asarray(ts[:8 * chunks], np.float64).reshape(chunks, 8)
            t0 = t[:, 0].min()

            def pct(v):
                return [float(np.percentile(v, q)) for q in (0, 50, 100)]
            timeline.append({
                "blocks": chunks, "sms_used": int(len(set(t[:, 4]))),
                "last_block_start_us": float((t[:, 0].max() - t0) / 1e3),
                "phase1_us": pct((t[:, 1] - t[:, 0]) / 1e3),
                "look_back_us": pct(t[:, 5] / 1e3),
                "ranks_us": pct(t[:, 6] / 1e3),
                "counts_us": pct(t[:, 7] / 1e3),
                "wait_us": pct((t[:, 2] - t[:, 1]) / 1e3),
                "phase2_us": pct((t[:, 3] - t[:, 2]) / 1e3),
                "done_reached_us": pct((t[:, 2] - t0) / 1e3),
                "last_block_end_us": float((t[:, 3].max() - t0) / 1e3)})
        results.append({"probe": f"radix_split at {n} int64 keys, B = {b}",
                        "plan": rp.radix_plan(n, b, rp.SPLIT)._asdict(),
                        "bound_ms": chip_smoke.radix_bytes(n) / 3.35e12 * 1e3,
                        "device_ms_in_turns": device_ms,
                        "timeline_us": timeline})
        print(json.dumps(results[-1]), flush=True)
        del keys, want
    print(json.dumps({"probe": "radix ptxas and SASS",
                      "ptxas": ptxas_report(_build.CSRC / "radix.cu"),
                      "sass": sass_counts(_build._target("radix"))}),
          flush=True)


def sass_counts(lib: Path) -> dict:
    """Per kernel of a built library: its instructions by opcode family
    (global and local loads and stores, match, barriers), from
    cuobjdump -sass."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)[-40:]
            out[name] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if m and name:
            op = m.group(1)
            if op in ("LDG", "STG", "LDL", "STL", "MATCH", "BAR", "ATOMS",
                      "LDS", "STS", "CALL", "WARPSYNC"):
                out[name][op] += 1
    return {k: dict(v) for k, v in out.items()}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_probe: needs a CUDA device", file=sys.stderr)
        return 1
    probes = {"flash": probe_flash, "group": probe_group, "ssd": probe_ssd,
              "decode": probe_decode, "train": probe_train,
              "bitpack": probe_bitpack, "topk": probe_topk, "rle": probe_rle,
              "scan": probe_scan, "radix": probe_radix}
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
