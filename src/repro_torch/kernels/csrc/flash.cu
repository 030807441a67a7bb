// Causal flash attention, forward — the Hopper kernels behind
// kernels/flash_attention.py (the prefill attention of the dense family's
// every layer and of the hybrid family's shared block).
//
// Replaces: repro/kernels/flash_attention.py:flash_attention_fwd
// (_flash_fwd_kernel).
//
// Computes o = softmax(q k^T / sqrt(hd)) v per (batch, head), with the
// causal mask col <= row by absolute index, for q (B, H, S, hd) and k, v
// (B, KV, T, hd) with H % KV == 0: grouped-query attention, query head h
// reading kv head h / (H / KV) (KV == H is MHA).  k and v are never
// repeated: the grid stays (query tiles, B * H), and the H / KV query heads
// of one kv head are adjacent in blockIdx.y, so their blocks read the same
// k / v tiles close together in time and L2 serves the repeats.  Scores,
// the running max m, the running denominator l and the output accumulator
// are float32; the output is acc / max(l, 1e-30) in q's dtype, as the
// reference kernel's finalize writes it.  Where the caller asks for it,
// each row's log-sum-exp of its scaled scores, m + log l (natural log),
// float32 (B, H, S), is written too: the backward recomputes the
// probabilities from it, as the reference's oracle
// (repro/models/flash.py:_flash_fwd_impl) returns it for its backward
// (the Pallas kernel itself does not).  Every operand is read through
// its batch, head and sequence strides, so a (B, S, H, hd) tensor seen as
// (B, H, S, hd) is not copied; any S and T (rows past S and keys past T are
// masked).
//
// What bounds it on an H100: operations.  Causal attention at Zamba2's
// prefill shape (B=4, H=32, S=2048, hd=112) does 4 * B * H * hd * S(S+1)/2
// = 120 GFLOP against 235 MB of q, k, v and o, 510 flops a byte: above the
// card's bf16 ridge (989 TFLOP/s over 3.35 TB/s = 295 flops a byte), so the
// bound is 0.12 ms at the bf16 tensor-core rate.  At Yi-9B's (B=4, H=32
// over KV=4, S=2048, hd=128) it does 137 GFLOP against 151 MB (q and o
// 134 MB, k and v 17 MB read once): 0.139 ms, operation-bound.
//
// Two kernels; the wrapper picks one by dtype and head dim (route 1 for
// bfloat16 with hd % 8 == 0, route 0 otherwise) and counts each route.
//
// Route 1, flash_fwd_tc (bfloat16 on the tensor cores):
//   * one block of 288 threads per (128-row query tile, batch * head), the
//     tiles with most causal work launched first: two consumer warpgroups
//     of 64 query rows each and one producer warp;
//   * the producer's one thread loads the query tile once and then walks a
//     2-stage ring of 128-key K and V tiles in shared memory with TMA (160
//     KB with the query tile), each stage guarded by a full and an empty
//     mbarrier, so the next tile is in flight while the consumers compute.
//     Key tiles above the diagonal are never loaded.  The tensor maps are
//     4-D (hd, then the three outer dimensions in order of stride), encoded
//     on the host per call through the runtime's driver entry point (no
//     -lcuda); rows past S or T and columns past hd arrive as zeros (TMA's
//     out-of-bounds fill);
//   * every tile is stored 128-byte swizzled, 64 columns (128 bytes) a box:
//     hd = 112 is two boxes, 64 + 48 columns, the second zero-filled to 64;
//   * S = Q K^T is a wgmma (m64n128k16, both operands in shared memory,
//     K-major) accumulated in float32 registers over hd / 16 k-steps (7 at
//     hd = 112); masks apply only to the diagonal and the ragged last tile.
//     128-key tiles halve the per-tile costs (barrier waits, max and sum
//     shuffles, wgmma latencies) of 64-key ones, which measured slower;
//   * online softmax in float32 on log2(e)-prescaled scores, one
//     ex2.approx instruction an element, masked scores excluded before the
//     exponential, and a row that has seen no unmasked score keeps its
//     exponent offset at 0 (the guard against a fully masked row); O is
//     rescaled only when a row of the warp found a larger max;
//   * P is rounded to bfloat16 in registers — the accumulator layout of
//     S is the A-operand layout of the next product — and O += P V is a
//     wgmma with A in registers and V in shared memory read MN-major
//     (m64nHDk16, HD = 64, 112 or 128), the O accumulator float32 in
//     registers.  P never touches shared memory;
//   * tensor-core route limits: hd % 8 == 0 and hd <= 128, base addresses
//     16-byte aligned and strides multiples of 8 elements (TMA's rules);
//     the wrapper checks them and raises, it never copies.
//
// Route 0, flash_fwd_simt (float32, and bfloat16 at a head dim the tensor
// cores cannot take): float32 FMAs on the CUDA cores (67 TFLOP/s peak),
// so the 1e-4 float32 tolerance holds (TF32 keeps about three digits):
//   * one block of 128 threads per (64-row query tile, batch * head), the
//     tiles with most causal work launched first;
//   * the query tile sits in shared memory transposed ([hd][64], q's
//     dtype), each 64-row key tile the same way, its value tile row-major
//     with columns up to 128 (columns >= hd stay zero);
//   * thread (rg, cg) = (tid / 8, tid % 8) owns score rows 4rg..4rg+3 and
//     columns 8cg..8cg+7 of the 64 x 64 score tile (float32 registers), and
//     output columns 16cg..16cg+15 of the same four rows; a row's running
//     max and sum reduce over its eight threads with warp shuffles;
//   * the probabilities go through shared memory (float32) to the P V
//     product; the accumulator rescales by exp(m_old - m_new) per tile;
//   * key tiles entirely above the diagonal are never loaded; hd is a
//     runtime parameter up to 128.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // key rows per tile (== kBQ)
constexpr int kThreads = 128;
constexpr int kMaxHd = 128;
constexpr int kPitchT = kBQ + 8;     // transposed q / k tiles: [hd][kPitchT]
constexpr int kPitchV = kMaxHd + 8;  // v tile: [kBK][kPitchV]
constexpr int kPitchP = kBK + 4;     // probabilities: [kBQ][kPitchP] float
constexpr float kNegInf = -1e30f;

enum DType { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3,
             kBFloat16 = 4 };

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N consecutive shared-memory elements (N a multiple of 4, 4-aligned) as
// floats: float4 loads for float, 8-byte loads of 4 bf16 for bfloat16.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
  }
}
template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p + i);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    out[i] = a.x; out[i + 1] = a.y; out[i + 2] = b.x; out[i + 3] = b.y;
  }
}

struct Strides {
  long long b, h, s;
};

template <typename T>
size_t smem_bytes(int hd) {
  return (2 * static_cast<size_t>(hd) * kPitchT + kBK * kPitchV) * sizeof(T)
         + kBQ * kPitchP * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int heads, int group, int s_len,
          int t_len, int hd, int causal, float scale, Strides qs,
          Strides ks, Strides vs, Strides os) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_qt = reinterpret_cast<T*>(smem_raw);            // [hd][kPitchT]
  T* s_kt = s_qt + hd * kPitchT;                       // [hd][kPitchT]
  T* s_v = s_kt + hd * kPitchT;                        // [kBK][kPitchV]
  float* s_p = reinterpret_cast<float*>(s_v + kBK * kPitchV);

  const int tid = threadIdx.x;
  const int rg = tid >> 3;                 // rows 4rg .. 4rg+3
  const int cg = tid & 7;                  // score cols 8cg.., out 16cg..
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int kvh = h / group;               // the query head's kv head
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + kvh * ks.h;
  const T* vp = v + b * vs.b + kvh * vs.h;
  T* op = o + b * os.b + h * os.h;
  const T zero = from_f<T>(0.f);

  for (int idx = tid; idx < kBQ * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd;
    const int row = q0 + r;
    s_qt[d * kPitchT + r] = row < s_len ? qp[row * qs.s + d] : zero;
  }
  for (int idx = tid; idx < kBK * kPitchV; idx += kThreads) s_v[idx] = zero;

  float m[4], l[4], acc[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[i][c] = 0.f;
  }

  const int row_end = min(q0 + kBQ, s_len);
  int n_tiles = (t_len + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (row_end - 1) / kBK + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                       // the last tile's readers are done
    for (int idx = tid; idx < kBK * hd; idx += kThreads) {
      const int r = idx / hd, d = idx - r * hd;
      const int col = k0 + r;
      const bool ok = col < t_len;
      s_kt[d * kPitchT + r] = ok ? kp[col * ks.s + d] : zero;
      s_v[r * kPitchV + d] = ok ? vp[col * vs.s + d] : zero;
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[8];
      load_vec<4>(s_qt + d * kPitchT + rg * 4, qv);
      load_vec<8>(s_kt + d * kPitchT + cg * 8, kv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + cg * 8 + j;
        const bool ok = col < t_len && (!causal || col <= row);
        sc[i][j] = ok ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // a masked score contributes nothing, even when its whole row is
        // masked in this tile
        const float p = sc[i][j] > 0.5f * kNegInf ? expf(sc[i][j] - m_new)
                                                  : 0.f;
        sum += p;
        sc[i][j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[i][c] *= corr;
      float* pr = s_p + (rg * 4 + i) * kPitchP + cg * 8;
      *reinterpret_cast<float4*>(pr) =
          make_float4(sc[i][0], sc[i][1], sc[i][2], sc[i][3]);
      *reinterpret_cast<float4*>(pr + 4) =
          make_float4(sc[i][4], sc[i][5], sc[i][6], sc[i][7]);
    }
    __syncthreads();

    const int k_end = min(kBK, t_len - k0);
    for (int kk = 0; kk < k_end; ++kk) {
      float pv[4], vv[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_p[(rg * 4 + i) * kPitchP + kk];
      load_vec<16>(s_v + kk * kPitchV + cg * 16, vv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= s_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    // m is in units of the scaled score: lse = m + log l, natural log
    if (lse != nullptr && cg == 0)
      lse[static_cast<long long>(blockIdx.y) * s_len + row] =
          m[i] + logf(denom);
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int col = cg * 16 + c;
      if (col < hd) op[row * os.s + col] = from_f<T>(acc[i][c] / denom);
    }
  }
}

// ------------------------------------------------ route 1: tensor cores

constexpr int kTcBQ = 128;           // query rows per block (2 x 64)
constexpr int kTcBK = 128;           // key rows per tile
constexpr int kTcStages = 2;         // depth of the K / V ring
constexpr int kTcConsumers = 256;    // two warpgroups
constexpr int kTcThreads = kTcConsumers + 32;   // and one producer warp
constexpr int kBoxCols = 64;         // bf16 columns in 128 bytes
constexpr int kRowBytes = 128;       // one swizzled box row
constexpr int kQBoxBytes = kTcBQ * kRowBytes;
constexpr int kKBoxBytes = kTcBK * kRowBytes;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory plan of the tensor-core kernel for a padded head dim HD
// (64, 112 or 128): the query tile, then per stage the K and the V tile,
// each as HD / 64 rounded up boxes of 64 columns; then the mbarriers.
template <int HD>
struct TcPlan {
  static constexpr int kBoxes = (HD + kBoxCols - 1) / kBoxCols;
  static constexpr int kKSteps = HD / 16;
  static constexpr int kQBytes = kBoxes * kQBoxBytes;
  static constexpr int kTileBytes = kBoxes * kKBoxBytes;  // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarBytes = 8 * (1 + 2 * kTcStages);
  // 1024 bytes of slack: the swizzle pattern is anchored to 1024-byte
  // aligned shared addresses
  static constexpr size_t kSmem =
      1024 + kQBytes + kTcStages * kStageBytes + kBarBytes;
};

// Which TMA coordinate (1..3) holds an operand's sequence row, head and
// batch index: the encoder orders the outer dimensions by stride.
struct TmaCoords {
  int row, head, batch;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of parity `parity`.  A
// wait here lasts a tile's load or compute, microseconds; one that spins
// for seconds has lost an arrival, and traps (a launch failure the wrapper
// reports) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0; !mbar_try_wait(bar, parity); ++spins)
    if (spins == (1u << 24)) __trap();
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, TmaCoords at, int col,
                                         int row, int head, int batch) {
  int c[4];
  c[0] = col;
  c[at.row] = row;
  c[at.head] = head;
  c[at.batch] = batch;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3])
      : "memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled tile at shared address
// `addr`: leading and stride byte offsets, layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// 2^x in one MUFU instruction (exp2f adds range fix-ups); a result under
// 2^-126 flushes to 0, far below what a bf16 probability keeps
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128) (+)= A (64 x 16) B^T: A and B in shared memory, K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64) += A (64 x 16, registers) B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// D (64 x 112) += A (64 x 16, registers) B (16 x 112, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[56],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// D (64 x 128) += A (64 x 16, registers) B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap q_map,
             const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map, TmaCoords qc,
             TmaCoords kc, TmaCoords vc, __nv_bfloat16* __restrict__ o,
             float* __restrict__ lse, Strides os, int heads, int group,
             int s_len, int t_len, int hd, int causal, float scale_log2) {
  using Plan = TcPlan<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + Plan::kQBytes;   // stage st at st * kStageBytes
  const uint32_t bars = kv_s + kTcStages * Plan::kStageBytes;
  const uint32_t q_full = bars;
  const uint32_t full0 = bars + 8;                   // + 8 * stage
  const uint32_t empty0 = bars + 8 + 8 * kTcStages;  // + 8 * stage

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int kvh = h / group;               // the query head's kv head
  // consumer warpgroups that own at least one row, and the key tiles that
  // warpgroup g reads (causal: up to its last row's diagonal)
  const int groups = q0 + 64 < s_len ? 2 : 1;
  auto tiles_for = [&](int g) {
    int n = (t_len + kTcBK - 1) / kTcBK;
    if (causal) n = min(n, (min(q0 + 64 * (g + 1), s_len) - 1) / kTcBK + 1);
    return n;
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kTcStages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 4 * groups);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kTcConsumers) {
    // producer: one thread issues every TMA load of the block
    if (tid == kTcConsumers) {
      const int n_tiles = tiles_for(groups - 1);
      mbar_expect_tx(q_full, Plan::kQBytes);
      for (int bx = 0; bx < Plan::kBoxes; ++bx)
        tma_load(q_s + bx * kQBoxBytes, &q_map, q_full, qc, bx * kBoxCols,
                 q0, h, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % kTcStages;
        if (kt >= kTcStages)   // the consumers released the stage's last use
          mbar_wait(empty0 + 8 * st, (kt / kTcStages - 1) & 1);
        const uint32_t k_s = kv_s + st * Plan::kStageBytes;
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, Plan::kStageBytes);
        for (int bx = 0; bx < Plan::kBoxes; ++bx) {
          tma_load(k_s + bx * kKBoxBytes, &k_map, full, kc, bx * kBoxCols,
                   kt * kTcBK, kvh, b);
          tma_load(k_s + Plan::kTileBytes + bx * kKBoxBytes, &v_map, full, vc,
                   bx * kBoxCols, kt * kTcBK, kvh, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup g owns query rows q0 + 64g .. q0 + 64g + 63; in
  // the wgmma accumulator layout thread (warp, lane) holds rows row0 and
  // row0 + 8, and in each 8-column block j columns 8j + c0 and 8j + c0 + 1
  const int g = tid >> 7;
  if (g >= groups) return;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int row0 = q0 + 64 * g + 16 * warp + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const int n_tiles = tiles_for(g);
  const uint32_t q_g = q_s + g * 64 * kRowBytes;

  float acc[HD / 2], s[64];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % kTcStages;
    mbar_wait(full0 + 8 * st, (kt / kTcStages) & 1);
    const uint32_t k_s = kv_s + st * Plan::kStageBytes;
    const uint32_t v_s = k_s + Plan::kTileBytes;

    // S = Q K^T: k-step ks reads 16 columns, 32 bytes into box ks / 4
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < Plan::kKSteps; ++ks) {
      const uint32_t col = (ks & 3) * 32;
      wgmma_ss_n128(s,
                   sw128_desc(q_g + (ks >> 2) * kQBoxBytes + col, 16, 1024),
                   sw128_desc(k_s + (ks >> 2) * kKBoxBytes + col, 16, 1024),
                   ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);

    // mask before exp: the diagonal tile and the ragged last tile only
    const int k0 = kt * kTcBK;
    const bool masked =
        (causal && k0 + kTcBK - 1 > q0 + 64 * g) || k0 + kTcBK > t_len;
    if (masked) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int col = k0 + 8 * j + c0 + (r & 1);
          const int row = row0 + 8 * (r >> 1);
          if (col >= t_len || (causal && col > row)) s[4 * j + r] = kNegInf;
        }
    }

    // online softmax per row (i = 0: row0, i = 1: row0 + 8); a row's four
    // threads are lanes 4k .. 4k + 3
    float offset[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      // a row with no unmasked score so far keeps its offset at 0
      offset[i] = m_new > 0.5f * kNegInf ? m_new * scale_log2 : 0.f;
      corr[i] = ex2(m[i] * scale_log2 - offset[i]);
      m[i] = m_new;
    }
    // p = 2^(s log2(e) / sqrt(hd) - offset); a masked score gives 0 (only
    // masked tiles pay for the test)
    uint32_t p[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * kk + half;
        float e[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = s[4 * j + r];
          e[r] = ex2(fmaf(x, scale_log2, -offset[r >> 1]));
          if (masked && !(x > 0.5f * kNegInf)) e[r] = 0.f;
        }
        sum[0] += e[0] + e[1];
        sum[1] += e[2] + e[3];
        p[kk][2 * half] = pack_bf16(e[0], e[1]);
        p[kk][2 * half + 1] = pack_bf16(e[2], e[3]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
    // rescale O unless no row of the warp found a larger max
    if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j] *= corr[0];
        acc[4 * j + 1] *= corr[0];
        acc[4 * j + 2] *= corr[1];
        acc[4 * j + 3] *= corr[1];
      }
    }

    // O += P V: k-step kk reads keys 16kk .. 16kk + 15 (rows of every box)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs(acc, p[kk],
               sw128_desc(v_s + kk * 16 * kRowBytes, kKBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  __nv_bfloat16* op = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float inv = 1.f / fmaxf(li, 1e-30f);
    const int row = row0 + 8 * i;
    if (row >= s_len) continue;
    // m is the raw score's max and l sums 2^(s log2(e) / sqrt(hd) -
    // offset): lse = (offset + log2 l) ln 2 in units of the scaled score,
    // the offset as the softmax loop set it (0 for a row with no unmasked
    // score, whose lse is then kNegInf like the SIMT route's)
    if (lse != nullptr && c0 == 0)
      lse[static_cast<long long>(blockIdx.y) * s_len + row] =
          m[i] > 0.5f * kNegInf
              ? (m[i] * scale_log2 + log2f(fmaxf(li, 1e-30f)))
                    * 0.6931471805599453f
              : kNegInf + logf(fmaxf(li, 1e-30f));
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + c0;
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(op + row * os.s + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv,
                                  acc[4 * j + 2 * i + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so that the library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of one (batch, heads, rows, hd) bfloat16 operand with
// element strides `st`: hd innermost, then the three outer dimensions in
// order of increasing stride (a dimension of size 1 goes last), in boxes of
// 64 columns by `box_rows` rows, 128-byte swizzled, zeros out of bounds.
// `at` receives the coordinate positions of row, head and batch.
int encode_operand(CUtensorMap* map, TmaCoords* at, const void* ptr,
                   int batch, int heads, int rows, int hd, Strides st,
                   int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  struct Outer {
    cuuint64_t size, stride;
    cuuint32_t box;
    int role;   // 0 row, 1 head, 2 batch
  } d[3] = {{static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(st.s) * 2,
             static_cast<cuuint32_t>(box_rows), 0},
            {static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(st.h) * 2,
             1, 1},
            {static_cast<cuuint64_t>(batch), static_cast<cuuint64_t>(st.b) * 2,
             1, 2}};
  cuuint64_t extent = 16;
  for (const Outer& x : d)
    if (x.size > 1) extent = extent > x.size * x.stride ? extent
                                                        : x.size * x.stride;
  for (Outer& x : d)
    if (x.size == 1) x.stride = extent;   // never read: any legal stride
  for (int i = 1; i < 3; ++i)              // insertion sort by stride
    for (int j = i; j > 0 && d[j].stride < d[j - 1].stride; --j) {
      const Outer t = d[j];
      d[j] = d[j - 1];
      d[j - 1] = t;
    }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), d[0].size,
                              d[1].size, d[2].size};
  const cuuint64_t strides[3] = {d[0].stride, d[1].stride, d[2].stride};
  const cuuint32_t box[4] = {kBoxCols, d[0].box, d[1].box, d[2].box};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  int pos[3];
  for (int i = 0; i < 3; ++i) pos[d[i].role] = i + 1;
  *at = TmaCoords{pos[0], pos[1], pos[2]};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int b, int h, int kv, int s, int t, int hd,
              int causal, Strides qs,
              Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  // set once, on the first (eager) call: a call inside a CUDA graph
  // capture sets nothing
  static const cudaError_t configured = cudaFuncSetAttribute(
      flash_fwd_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(TcPlan<HD>::kSmem));
  if (configured != cudaSuccess) return configured;
  CUtensorMap qm, km, vm;
  TmaCoords qc, kc, vc;
  int err = encode_operand(&qm, &qc, q, b, h, s, hd, qs, kTcBQ);
  if (err == 0) err = encode_operand(&km, &kc, k, b, kv, t, hd, ks, kTcBK);
  if (err == 0) err = encode_operand(&vm, &vc, v, b, kv, t, hd, vs, kTcBK);
  if (err != 0) return err;
  const float scale_log2 =
      static_cast<float>(kLog2e / sqrt(static_cast<double>(hd)));
  const dim3 grid((s + kTcBQ - 1) / kTcBQ, b * h);
  flash_fwd_tc<HD><<<grid, kTcThreads, TcPlan<HD>::kSmem, stream>>>(
      qm, km, vm, qc, kc, vc, static_cast<__nv_bfloat16*>(o), lse, os, h,
      h / kv, s, t, hd, causal, scale_log2);
  return cudaGetLastError();
}

// TMA's rules for the tensor-core route: 16-byte aligned bases and strides
// of a multiple of 8 bfloat16 elements in every dimension longer than 1
bool tma_ok(const void* p, Strides st, int b, int h, int rows) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0
         && (b == 1 || (st.b > 0 && st.b % 8 == 0))
         && (h == 1 || (st.h > 0 && st.h % 8 == 0))
         && (rows == 1 || (st.s > 0 && st.s % 8 == 0));
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                float* lse, int b, int h, int kv, int s, int t, int hd,
                int causal, Strides qs,
                Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(hd);
  // raise the kernel's dynamic shared-memory limit once, to the most any
  // shape takes (a later call, inside a CUDA graph capture, sets nothing)
  static const cudaError_t configured = cudaFuncSetAttribute(
      flash_fwd_simt<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<T>(kMaxHd)));
  if (configured != cudaSuccess) return configured;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  const dim3 grid((s + kBQ - 1) / kBQ, b * h);
  flash_fwd_simt<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, h, h / kv, s, t,
      hd, causal, scale, qs, ks, vs, os);
  return cudaGetLastError();
}

}  // namespace

// route 0: flash_fwd_simt (float32 or bfloat16); route 1: flash_fwd_tc
// (bfloat16, hd % 8 == 0, TMA-legal bases and strides).  q has h heads, k
// and v kv heads (h % kv == 0).  Strides are in elements.  `lse`, when not
// null, receives each row's log-sum-exp of its scaled scores, float32
// (B, H, S) contiguous: what the backward recomputes the probabilities
// from.  Returns a cudaError_t.
extern "C" int shark_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse_ptr,
    int dtype,
    int route, int b, int h, int kv, int s, int t, int hd, int causal,
    long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss,
    void* stream) {
  if (hd < 1 || hd > kMaxHd || s < 1 || t < 1 || b < 1 || h < 1 || kv < 1
      || h % kv != 0 || static_cast<long long>(b) * h > 65535)
    return cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_ptr);
  if (route == 1) {
    if (dtype != kBFloat16 || hd % 8 != 0 || !tma_ok(q, qs, b, h, s)
        || !tma_ok(k, ks, b, kv, t) || !tma_ok(v, vs, b, kv, t)
        || reinterpret_cast<uintptr_t>(o) % 4 != 0 || os.s % 2 != 0)
      return cudaErrorInvalidValue;
    if (hd <= 64)
      return launch_tc<64>(q, k, v, o, lse, b, h, kv, s, t, hd, causal, qs,
                           ks, vs, os, st);
    if (hd <= 112)
      return launch_tc<112>(q, k, v, o, lse, b, h, kv, s, t, hd, causal, qs,
                            ks, vs, os, st);
    return launch_tc<128>(q, k, v, o, lse, b, h, kv, s, t, hd, causal, qs,
                          ks, vs, os, st);
  }
  if (route != 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case kFloat32:
      return launch_simt<float>(q, k, v, o, lse, b, h, kv, s, t, hd, causal,
                                qs, ks, vs, os, st);
    case kBFloat16:
      return launch_simt<__nv_bfloat16>(q, k, v, o, lse, b, h, kv, s, t,
                                        hd, causal, qs, ks, vs, os, st);
    default:
      return cudaErrorInvalidValue;
  }
}
