// Mamba2 SSD scan, forward — the Hopper kernels behind kernels/ssd_scan.py
// (every Mamba2 prefill of the ssm and hybrid families).
//
// Replaces: repro/kernels/ssd_scan.py:ssd_scan (_ssd_kernel).
//
// Per (batch b, head h), over the sequence, with ngroups = 1 (one B and C
// for all heads) and cum the running sum of dt * a inside a chunk:
//   y_i    = sum_{j <= i in chunk} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//            + exp(cum_i) (C_i . state) + D x_i
//   state' = exp(cum_last) state + sum_j B_j exp(cum_last - cum_j) dt_j x_j
// x (B, S, H, P) and B, C (B, S, N) in bfloat16 or float32, dt (B, S, H),
// a (H,) and D (H,) float32.  y is summed in float32, D skip included, and
// written once in x's dtype, as ssd_chunked does; the final state goes out
// in the reference's (B, H, P, N) float32 layout (the TPU kernel kept it in
// scratch and dropped it; prefill hands it to the decode cache).  One call
// is one launch: the wrapper allocates y and the state and does nothing
// else.
//
// What bounds it on an H100: bytes.  At Zamba2's prefill shape (B=4,
// S=2048, H=64, P=112, N=64) with 64-row chunks, each row costs
// 2 * (32 * (N + P) + 2 * N * P) flops per head (the causal halves of
// C B^T and of M x, C . state and its share of the state update): 20.9
// GFLOP against 246 MB of x, dt, B, C, y (bfloat16) and the state, 85
// flops a byte, under the card's bf16 ridge (295): 0.073 ms of HBM
// traffic.  But the walk over the sequence is sequential per (batch,
// head), so what a design can reach is the products' rate on one SM
// times the blocks in flight.
//
// Both routes keep the TPU kernel's structure: one block walks one
// (batch, head)'s sequence chunk by chunk, 64 rows a chunk, and the running
// N x P float32 state never leaves the chip, so HBM traffic is the bound's
// bytes.  (The TPU kernel's 256-row chunk holds a 256 x 256 float32 tile,
// over a block's 227 KB; the result depends on the chunk length only
// through rounding.)  Rows past S read as dt = 0 and x = B = C = 0
// (ssd_chunked's padding): the state passes through them and their y is
// not written.  x, B and C are read through their batch and sequence
// strides, so the in-projection's slices are not copied, and B and C once
// per head by batch index (the TPU wrapper's per-head broadcast copies are
// never made).
//
// Route 1, ssd_fwd_tc (bfloat16 x, B, C on the tensor cores; the shapes
// the repo's configurations use, P x N = 112 x 64 (Zamba2-7B), 64 x 128
// (Mamba2-370m) and 16 x 16 (their smoke variants), each compiled with its
// sizes fixed so every tile loop unrolls into registers):
//   * one block of 8 warps per (batch, head).  Warp w owns chunk rows
//     16 (w % 4) .. + 15 of y and half w / 4 of the P columns; for the
//     state, N rows 16 (w % 4 + 4 k) .. + 15 and the same P half.  The
//     running state lives in those warps' mma accumulators (float32
//     registers) for the whole walk;
//   * loads: cp.async, 16 bytes a thread, into a 2-stage ring of x, B, C
//     and dt tiles (rows padded by 16 bytes so ldmatrix reads are free of
//     bank conflicts); chunk t + 1's tiles are in flight while chunk t
//     computes;
//   * every warp scans dt * a over the chunk itself (two rows a lane, a
//     shuffle scan) and reads the cum and dt values of other rows by
//     shuffle: no warp waits for another's scan;
//   * four products per chunk, all mma.sync m16n8k16 bf16 with float32
//     accumulators, operands from shared memory by ldmatrix:
//       y   = C . state   (scaled per row by exp(cum_i) afterwards)
//       G   = C B^T       (only the causal column tiles)
//       y  += M x         with M = G o L o dt_j built in registers from G's
//                         accumulators (the accumulator layout is the A
//                         operand's), the exponential taken only where
//                         j <= i (the masked half may overflow)
//       state = exp(cum_last) state + (w o B)^T x, w_j = exp(cum_last -
//               cum_j) dt_j, B^T read by ldmatrix.trans and scaled by w in
//               registers;
//   * precision: C, B and x arrive as bf16, so their products are exact in
//     float32.  Three operands are float32 values — M, w o B and the state
//     that C . state reads — and go to the tensor cores as a bf16 pair
//     hi + lo (hi = bf16(v), lo = bf16(v - hi): 16 significant bits, a
//     relative error under 2^-16), two MMAs each.  TF32 (10 bits, 2^-11)
//     would spend about half of the 1e-3 tolerance on rounding the
//     operands alone; the pair keeps the result float32-close at twice the
//     MMAs of those three products, which the card has to spare here.
//     Exponentials are one ex2.approx each, on cum kept in log2 units;
//   * the state's bf16 pair goes to shared memory once a chunk for the
//     next chunk's C . state (every warp needs all N rows of its P half);
//     two barriers a chunk (tiles ready; every C . state read done before
//     the state is rewritten);
//   * epilogue: y += D x in float32 from the staged x tile, one rounding
//     to bf16, stored from the accumulators.
//
// Route 0, ssd_fwd (float32, and bfloat16 at any other P, N <= 128, on the
// CUDA cores): one block of 256 threads per (batch, head), the state
// (N x P float32) in shared memory; each 64-row step stages x, B^T and C^T
// as float32, scans dt * a with warp shuffles, builds M with exp taken
// only where j <= i, then y = M x + exp(cum) (C state) + D x for the
// chunk's rows and the state update, each thread owning a 4 x 8 (rows x P)
// and an 8 x 8 (N x P) register block of float32 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum DType { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3,
             kBFloat16 = 4 };
enum Route { kSimt = 0, kTensorCore = 1 };

constexpr int kMaxN = 128;
constexpr int kMaxP = 128;
constexpr int kT = 64;              // rows per chunk, both routes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ------------------------------------------------ route 0: CUDA cores

constexpr int kThreads = 256;
constexpr int kPitch = kT + 4;      // B^T, C^T: [N][kPitch]; M: [kT][kPitch]

size_t smem_bytes(int p, int n) {
  return sizeof(float) * (static_cast<size_t>(kT) * p + 2 * n * kPitch
                          + kT * kPitch + static_cast<size_t>(n) * p
                          + 3 * kT);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_fwd(const T* __restrict__ x, long long xsb, long long xss,
        const float* __restrict__ dt, const float* __restrict__ a,
        const float* __restrict__ dskip,
        const T* __restrict__ bm, long long bsb, long long bss,
        const T* __restrict__ cm, long long csb, long long css, int seq,
        int heads, int P, int N, T* __restrict__ y,
        float* __restrict__ state_out) {
  extern __shared__ __align__(16) float smem[];
  float* s_x = smem;                       // [kT][P]
  float* s_bt = s_x + kT * P;              // [N][kPitch]
  float* s_ct = s_bt + N * kPitch;         // [N][kPitch]
  float* s_m = s_ct + N * kPitch;          // [kT][kPitch]
  float* s_state = s_m + kT * kPitch;      // [N][P]
  float* s_dt = s_state + N * P;           // [kT]
  float* s_cum = s_dt + kT;                // [kT]
  float* s_w = s_cum + kT;                 // [kT] exp(cum_last - cum_j) dt_j

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const T* xp = x + b * xsb + static_cast<long long>(h) * P;
  const float* dtp = dt + static_cast<long long>(b) * seq * heads + h;
  const T* bp = bm + b * bsb;
  const T* cp = cm + b * csb;
  const float a_h = a[h];
  const float d_h = dskip != nullptr ? dskip[h] : 0.f;
  const int rg = tid >> 4;                 // rows 4rg.. / state rows rg+16k
  const int cg = tid & 15;                 // P columns cg + 16c
  const int i0 = rg * 4;
  const int j0 = cg * 4;

  for (int idx = tid; idx < N * P; idx += kThreads) s_state[idx] = 0.f;

  for (int t0 = 0; t0 < seq; t0 += kT) {
    const int rows = min(kT, seq - t0);
    __syncthreads();                       // the last step's readers are done
    for (int idx = tid; idx < kT * P; idx += kThreads) {
      const int j = idx / P, p = idx - j * P;
      s_x[idx] = j < rows ? to_f(xp[(t0 + j) * xss + p]) : 0.f;
    }
    for (int idx = tid; idx < kT * N; idx += kThreads) {
      const int j = idx / N, n = idx - j * N;
      const bool ok = j < rows;
      s_bt[n * kPitch + j] = ok ? to_f(bp[(t0 + j) * bss + n]) : 0.f;
      s_ct[n * kPitch + j] = ok ? to_f(cp[(t0 + j) * css + n]) : 0.f;
    }
    if (tid < kT)
      s_dt[tid] = tid < rows
          ? dtp[static_cast<long long>(t0 + tid) * heads] : 0.f;
    __syncthreads();

    // cum = inclusive running sum of dt * a over the chunk: warp 0, two
    // rows a lane, a shuffle scan over the lanes' pair sums
    if (tid < 32) {
      const float d0 = s_dt[2 * tid] * a_h;
      const float d1 = s_dt[2 * tid + 1] * a_h;
      float incl = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      s_cum[2 * tid] = excl + d0;
      s_cum[2 * tid + 1] = (excl + d0) + d1;
    }
    __syncthreads();
    const float cum_last = s_cum[kT - 1];  // rows past S add nothing

    // M[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
    {
      float g[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
      if (j0 <= i0 + 3) {
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(
              s_ct + n * kPitch + i0);
          const float4 bv = *reinterpret_cast<const float4*>(
              s_bt + n * kPitch + j0);
          const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
          const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = fmaf(c4[i], b4[j], g[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ii = i0 + i, jj = j0 + j;
          float mv = 0.f;
          if (jj <= ii)                    // mask before exp
            mv = g[i][j] * expf(s_cum[ii] - s_cum[jj]) * s_dt[jj];
          s_m[ii * kPitch + jj] = mv;
        }
    }
    if (tid < kT) s_w[tid] = expf(cum_last - s_cum[tid]) * s_dt[tid];
    __syncthreads();

    // y = M x + exp(cum_i) (C_i . state) + D x, rows i0..i0+3, cols
    // cg + 16c
    {
      float acc[4][8], inter[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = inter[i][c] = 0.f;
      const int j_end = min(i0 + 4, rows);
      for (int j = 0; j < j_end; ++j) {
        float mv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = s_m[(i0 + i) * kPitch + j];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int p = cg + 16 * c;
          if (p < P) {
            const float xv = s_x[j * P + p];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(mv[i], xv, acc[i][c]);
          }
        }
      }
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(
            s_ct + n * kPitch + i0);
        const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int p = cg + 16 * c;
          if (p < P) {
            const float sv = s_state[n * P + p];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              inter[i][c] = fmaf(c4[i], sv, inter[i][c]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = t0 + i0 + i;
        if (i0 + i >= rows) continue;
        const float decay = expf(s_cum[i0 + i]);
        T* yr = y + ((static_cast<long long>(b) * seq + row) * heads + h) * P;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int p = cg + 16 * c;
          if (p < P)
            yr[p] = from_f<T>(acc[i][c] + decay * inter[i][c]
                              + s_x[(i0 + i) * P + p] * d_h);
        }
      }
    }
    __syncthreads();                       // every read of the state is done

    // state = exp(cum_last) state + sum_j B_j w_j x_j, rows rg + 16k
    {
      const float dl = expf(cum_last);
      float st[8][8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = rg + 16 * k, p = cg + 16 * c;
          st[k][c] = (n < N && p < P) ? s_state[n * P + p] * dl : 0.f;
        }
      for (int j = 0; j < rows; ++j) {
        const float wj = s_w[j];
        float xv[8], bw[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int p = cg + 16 * c;
          xv[c] = p < P ? s_x[j * P + p] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int n = rg + 16 * k;
          bw[k] = n < N ? s_bt[n * kPitch + j] * wj : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k)
#pragma unroll
          for (int c = 0; c < 8; ++c) st[k][c] = fmaf(bw[k], xv[c], st[k][c]);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = rg + 16 * k, p = cg + 16 * c;
          if (n < N && p < P) s_state[n * P + p] = st[k][c];
        }
    }
  }
  __syncthreads();
  // the final state, transposed to (B, H, P, N)
  float* so = state_out + static_cast<long long>(bh) * P * N;
  for (int idx = tid; idx < N * P; idx += kThreads) {
    const int p = idx / N, n = idx - p * N;
    so[idx] = s_state[n * P + p];
  }
}

// ------------------------------------------------ route 1: tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kBlockSmemLimit = 232448;   // 227 KB, an H100 block's most
constexpr int kSmSmem = 233472;           // 228 KB an SM, 1 KB of it per block

template <int P, int N>
struct TcShape {
  static_assert(P % 16 == 0 && N % 16 == 0 && P <= kMaxP && N <= kMaxN,
                "tensor-core route: P and N multiples of 16, at most 128");
  static constexpr int XP = P + 8;        // x and state row pitch (elements)
  static constexpr int BP = N + 8;        // B and C row pitch
  static constexpr int PT = P / 16;       // n8 tiles in a warp's P half
  static constexpr int NT = N / 16;       // m16 tiles of state rows
  static constexpr int NW = (NT + 3) / 4; // state m16 tiles a warp owns
  // one ring stage: x [kT][XP], B and C [kT][BP] bf16, dt [kT] float32
  static constexpr int kStage = 2 * kT * (XP + 2 * BP) + 4 * kT;
  // the state's bf16 pair: hi and lo, each [N][XP]
  static constexpr int kSmem = 2 * kStage + 2 * 2 * N * XP;
  static_assert(kSmem <= kBlockSmemLimit, "tensor-core route smem");
  static constexpr int kBlocksPerSm = 2 * (kSmem + 1024) <= kSmSmem ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x in one MUFU instruction (expf adds a multiply and range fix-ups);
// the route keeps cum in log2 units, so exp(c) is ex2(c * log2(e)).  A
// result under 2^-126 flushes to 0: a decay that small weighs nothing
// beside the 1e-3 tolerance
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 (or 4) bytes global -> shared, asynchronously; `ok` false fills the
// destination with zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, "
               "[%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr) : "memory");
}

// d (16 x 8, float32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) as the bf16 pair hi + lo: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// The B operands (k16 x n8, one per n8 tile of the warp's P half) of rows
// k0 .. k0 + 15 of a row-major [k][p] bf16 tile (x, or the state's hi or
// lo half) at shared address `base` with row pitch `pitch` elements.
template <int PT>
__device__ __forceinline__ void load_b_rows(uint32_t (&bf)[PT][2],
                                            uint32_t base, int pitch,
                                            int k0, int p0, int lane) {
  const int row = k0 + (lane & 15);
#pragma unroll
  for (int t = 0; t + 1 < PT; t += 2) {
    uint32_t r[4];
    ldsm_x4_t(r, base + 2 * (row * pitch + p0 + 8 * t + (lane >> 4) * 8));
    bf[t][0] = r[0];
    bf[t][1] = r[1];
    bf[t + 1][0] = r[2];
    bf[t + 1][1] = r[3];
  }
  if (PT & 1)
    ldsm_x2_t(bf[PT - 1][0], bf[PT - 1][1],
              base + 2 * (row * pitch + p0 + 8 * (PT - 1)));
}

// Chunk rows [t0, t0 + rows) of x, B, C and dt into one ring stage
// (rows past `rows` zero-filled).
template <int P, int N>
__device__ __forceinline__ void load_chunk(
    uint32_t st, const bf16* xp, long long xss, const bf16* bp, long long bss,
    const bf16* cp, long long css, const float* dtp, int heads, int t0,
    int rows, int tid) {
  using S = TcShape<P, N>;
  constexpr int kXc = P / 8, kBc = N / 8;     // 16-byte pieces a row
  const uint32_t sx = st;
  const uint32_t sb = sx + 2 * kT * S::XP;
  const uint32_t sc = sb + 2 * kT * S::BP;
  const uint32_t sd = sc + 2 * kT * S::BP;
  for (int i = tid; i < kT * kXc; i += kTcThreads) {
    const int j = i / kXc, c = i - j * kXc;
    const bool ok = j < rows;
    cp_async16(sx + 2 * (j * S::XP + 8 * c),
               ok ? xp + (t0 + j) * xss + 8 * c : xp, ok);
  }
  for (int i = tid; i < kT * kBc; i += kTcThreads) {
    const int j = i / kBc, c = i - j * kBc;
    const bool ok = j < rows;
    const uint32_t off = 2 * (j * S::BP + 8 * c);
    cp_async16(sb + off, ok ? bp + (t0 + j) * bss + 8 * c : bp, ok);
    cp_async16(sc + off, ok ? cp + (t0 + j) * css + 8 * c : cp, ok);
  }
  if (tid < kT) {
    const bool ok = tid < rows;
    cp_async4(sd + 4 * tid,
              ok ? dtp + static_cast<long long>(t0 + tid) * heads : dtp, ok);
  }
  cp_async_commit();
}

template <int P, int N>
__global__ void __launch_bounds__(kTcThreads, TcShape<P, N>::kBlocksPerSm)
ssd_fwd_tc(const bf16* __restrict__ x, long long xsb, long long xss,
           const float* __restrict__ dt, const float* __restrict__ a,
           const float* __restrict__ dskip,
           const bf16* __restrict__ bm, long long bsb, long long bss,
           const bf16* __restrict__ cm, long long csb, long long css,
           int seq, int heads, bf16* __restrict__ y,
           float* __restrict__ state_out) {
  using S = TcShape<P, N>;
  constexpr int PT = S::PT, NT = S::NT, NW = S::NW;
  constexpr int XP = S::XP, BP = S::BP;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp & 3;           // y rows 16 mt ..; state tiles mt + 4k
  const int p0 = (warp >> 2) * (P / 2);  // the warp's P half
  const int g = lane >> 2, q = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const bf16* xp = x + b * xsb + static_cast<long long>(h) * P;
  const float* dtp = dt + static_cast<long long>(b) * seq * heads + h;
  const bf16* bp = bm + b * bsb;
  const bf16* cp = cm + b * csb;
  const float a_h = a[h] * 1.4426950408889634f;   // log2(e): cum in log2
  const float d_h = dskip != nullptr ? dskip[h] : 0.f;
  const uint32_t s0 = smem_u32(tc_smem);
  const uint32_t s_hi = s0 + 2 * S::kStage;     // state, bf16 hi [N][XP]
  const uint32_t s_lo = s_hi + 2 * N * XP;      // state, bf16 lo [N][XP]
  const int i0 = 16 * mt + g;                   // this lane's y rows i0, i0+8

  // the running state: rows 16 (mt + 4k) + g (+8), cols p0 + 8t + 2q (+1)
  float st[NW][PT][4];
#pragma unroll
  for (int k = 0; k < NW; ++k)
#pragma unroll
    for (int t = 0; t < PT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[k][t][e] = 0.f;
  {
    uint32_t* z = reinterpret_cast<uint32_t*>(tc_smem + 2 * S::kStage);
    for (int i = tid; i < 2 * N * XP / 2; i += kTcThreads) z[i] = 0u;
  }

  const int chunks = (seq + kT - 1) / kT;
  load_chunk<P, N>(s0, xp, xss, bp, bss, cp, css, dtp, heads, 0,
                   min(kT, seq), tid);
  for (int ck = 0; ck < chunks; ++ck) {
    const int t0 = ck * kT;
    const int rows = min(kT, seq - t0);
    const uint32_t sx = s0 + (ck & 1) * S::kStage;
    const uint32_t sb = sx + 2 * kT * XP;
    const uint32_t sc = sb + 2 * kT * BP;
    const float* sdt = reinterpret_cast<const float*>(
        tc_smem + (ck & 1) * S::kStage + 2 * kT * (XP + 2 * BP));
    // [phase wait]
    cp_async_wait_all();
    __syncthreads();       // chunk ck landed; the other stage is free
    if (ck + 1 < chunks)
      load_chunk<P, N>(s0 + ((ck + 1) & 1) * S::kStage, xp, xss, bp, bss, cp,
                       css, dtp, heads, t0 + kT, min(kT, seq - t0 - kT), tid);

    // [phase scan]  cum: every warp scans dt * a (in log2 units) itself,
    // rows 2 lane and 2 lane + 1
    const float2 dtl = reinterpret_cast<const float2*>(sdt)[lane];
    const float da0 = dtl.x * a_h, da1 = dtl.y * a_h;
    float incl = da0 + da1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    const float cum0 = excl + da0;
    const float cum1 = cum0 + da1;
    const float cum_last = __shfl_sync(0xffffffffu, cum1, 31);
    float cum_i0, cum_i1;                // rows i0, i0 + 8
    {
      const float e0 = __shfl_sync(0xffffffffu, cum0, i0 >> 1);
      const float o0 = __shfl_sync(0xffffffffu, cum1, i0 >> 1);
      const float e1 = __shfl_sync(0xffffffffu, cum0, (i0 + 8) >> 1);
      const float o1 = __shfl_sync(0xffffffffu, cum1, (i0 + 8) >> 1);
      cum_i0 = (g & 1) ? o0 : e0;
      cum_i1 = (g & 1) ? o1 : e1;
    }

    // [phase cstate]  y = exp(cum_i) (C_i . state)
    float yacc[PT][4];
#pragma unroll
    for (int t = 0; t < PT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, sc + 2 * ((16 * mt + (lane & 15)) * BP + 16 * kk
                            + (lane >> 4) * 8));
      uint32_t bh_[PT][2], bl_[PT][2];
      load_b_rows<PT>(bh_, s_hi, XP, 16 * kk, p0, lane);
      load_b_rows<PT>(bl_, s_lo, XP, 16 * kk, p0, lane);
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        mma16816(yacc[t], af, bh_[t][0], bh_[t][1]);
        mma16816(yacc[t], af, bl_[t][0], bl_[t][1]);
      }
    }
    {
      const float e0 = ex2(cum_i0), e1 = ex2(cum_i1);
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        yacc[t][0] *= e0;
        yacc[t][1] *= e0;
        yacc[t][2] *= e1;
        yacc[t][3] *= e1;
      }
    }

    // [phase g]  G = C B^T over the causal column tiles 0 .. 2 mt + 1
    float gacc[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, sc + 2 * ((16 * mt + (lane & 15)) * BP + 16 * kk
                            + (lane >> 4) * 8));
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) {
        if (jt > mt) continue;
        uint32_t r[4];
        ldsm_x4(r, sb + 2 * ((16 * jt + (lane & 7) + ((lane >> 4) << 3)) * BP
                             + 16 * kk + ((lane >> 3) & 1) * 8));
        mma16816(gacc[2 * jt], af, r[0], r[1]);
        mma16816(gacc[2 * jt + 1], af, r[2], r[3]);
      }
    }

    // [phase m]  M = G o exp(cum_i - cum_j) o dt_j (j <= i), as bf16 hi +
    // lo A operands, one per 16-column k-step
    uint32_t mhi[4][4], mlo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > mt) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = 2 * kk + half;
        const int src = 4 * t + q;       // holds rows 8t + 2q and + 1
        const float cj0 = __shfl_sync(0xffffffffu, cum0, src);
        const float cj1 = __shfl_sync(0xffffffffu, cum1, src);
        const float dj0 = __shfl_sync(0xffffffffu, dtl.x, src);
        const float dj1 = __shfl_sync(0xffffffffu, dtl.y, src);
        const int j = 8 * t + 2 * q;
        const float m00 = j <= i0 ?
            gacc[t][0] * ex2(cum_i0 - cj0) * dj0 : 0.f;
        const float m01 = j + 1 <= i0 ?
            gacc[t][1] * ex2(cum_i0 - cj1) * dj1 : 0.f;
        const float m10 = j <= i0 + 8 ?
            gacc[t][2] * ex2(cum_i1 - cj0) * dj0 : 0.f;
        const float m11 = j + 1 <= i0 + 8 ?
            gacc[t][3] * ex2(cum_i1 - cj1) * dj1 : 0.f;
        split2(m00, m01, mhi[kk][2 * half], mlo[kk][2 * half]);
        split2(m10, m11, mhi[kk][2 * half + 1], mlo[kk][2 * half + 1]);
      }
    }

    // [phase mx]  y += M x over the causal k-steps
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > mt) continue;
      uint32_t xf[PT][2];
      load_b_rows<PT>(xf, sx, XP, 16 * kk, p0, lane);
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        mma16816(yacc[t], mhi[kk], xf[t][0], xf[t][1]);
        mma16816(yacc[t], mlo[kk], xf[t][0], xf[t][1]);
      }
    }

    // [phase state]  state = exp(cum_last) state + (w o B)^T x
    {
      const float el = ex2(cum_last);
#pragma unroll
      for (int k = 0; k < NW; ++k)
#pragma unroll
        for (int t = 0; t < PT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[k][t][e] *= el;
    }
    const float w0 = ex2(cum_last - cum0) * dtl.x;
    const float w1 = ex2(cum_last - cum1) * dtl.y;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // w of chunk rows 16 kk + 2q (+1) and 16 kk + 8 + 2q (+1)
      const float wa0 = __shfl_sync(0xffffffffu, w0, 8 * kk + q);
      const float wa1 = __shfl_sync(0xffffffffu, w1, 8 * kk + q);
      const float wb0 = __shfl_sync(0xffffffffu, w0, 8 * kk + 4 + q);
      const float wb1 = __shfl_sync(0xffffffffu, w1, 8 * kk + 4 + q);
      uint32_t xf[PT][2];
      load_b_rows<PT>(xf, sx, XP, 16 * kk, p0, lane);
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        const int nt = mt + 4 * k;
        if (nt >= NT) continue;
        // A[n][j] = B_j[n]: B^T by ldmatrix.trans, then scaled by w_j
        uint32_t r[4], ahi[4], alo[4];
        ldsm_x4_t(r, sb + 2 * ((16 * kk + (lane & 7) + (lane >> 4) * 8) * BP
                               + 16 * nt + ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 v = unpack2(r[e]);
          const float s0_ = e < 2 ? wa0 : wb0, s1_ = e < 2 ? wa1 : wb1;
          split2(v.x * s0_, v.y * s1_, ahi[e], alo[e]);
        }
#pragma unroll
        for (int t = 0; t < PT; ++t) {
          mma16816(st[k][t], ahi, xf[t][0], xf[t][1]);
          mma16816(st[k][t], alo, xf[t][0], xf[t][1]);
        }
      }
    }

    // [phase epilogue]
    __syncthreads();       // every warp's C . state read is done
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const int nt = mt + 4 * k;
      if (nt >= NT) continue;
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        const int p = p0 + 8 * t + 2 * q;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = 16 * nt + g + 8 * r;
          uint32_t hi, lo;
          split2(st[k][t][2 * r], st[k][t][2 * r + 1], hi, lo);
          asm volatile("st.shared.b32 [%0], %1;\n" ::
                       "r"(s_hi + 2 * (n * XP + p)), "r"(hi) : "memory");
          asm volatile("st.shared.b32 [%0], %1;\n" ::
                       "r"(s_lo + 2 * (n * XP + p)), "r"(lo) : "memory");
        }
      }
    }
    // y (+= D x, one rounding to bf16) from the accumulators
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;
      if (i >= rows) continue;
      bf16* yr = y + ((static_cast<long long>(b) * seq + t0 + i) * heads + h)
                     * P;
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        const int p = p0 + 8 * t + 2 * q;
        uint32_t xv;
        asm volatile("ld.shared.b32 %0, [%1];\n"
                     : "=r"(xv) : "r"(sx + 2 * (i * XP + p)) : "memory");
        const float2 xf = unpack2(xv);
        *reinterpret_cast<__nv_bfloat162*>(yr + p) = __floats2bfloat162_rn(
            yacc[t][2 * r] + xf.x * d_h, yacc[t][2 * r + 1] + xf.y * d_h);
      }
    }
  }

  // the final state, transposed to (B, H, P, N)
  float* so = state_out + static_cast<long long>(bh) * P * N;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const int nt = mt + 4 * k;
    if (nt >= NT) continue;
#pragma unroll
    for (int t = 0; t < PT; ++t) {
      const int p = p0 + 8 * t + 2 * q;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 16 * nt + g + 8 * (e >> 1);
        so[(p + (e & 1)) * N + n] = st[k][t][e];
      }
    }
  }
}

struct Args {
  const void* x;
  long long xsb, xss;
  const float* dt;
  const float* a;
  const float* d;
  const void* bm;
  long long bsb, bss;
  const void* cm;
  long long csb, css;
  int bsz, seq, heads, p, n;
  void* y;
  float* state;
  cudaStream_t stream;
};

template <typename T>
int launch_simt(const Args& g) {
  // raise the kernel's dynamic shared-memory limit once, to the most any
  // shape takes (a later call, inside a CUDA graph capture, sets nothing)
  static const cudaError_t configured = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxP, kMaxN)));
  if (configured != cudaSuccess) return configured;
  ssd_fwd<T><<<g.bsz * g.heads, kThreads, smem_bytes(g.p, g.n), g.stream>>>(
      static_cast<const T*>(g.x), g.xsb, g.xss, g.dt, g.a, g.d,
      static_cast<const T*>(g.bm), g.bsb, g.bss, static_cast<const T*>(g.cm),
      g.csb, g.css, g.seq, g.heads, g.p, g.n, static_cast<T*>(g.y), g.state);
  return cudaGetLastError();
}

template <int P, int N>
int launch_tc(const Args& g) {
  using S = TcShape<P, N>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      ssd_fwd_tc<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmem);
  if (configured != cudaSuccess) return configured;
  ssd_fwd_tc<P, N><<<g.bsz * g.heads, kTcThreads, S::kSmem, g.stream>>>(
      static_cast<const bf16*>(g.x), g.xsb, g.xss, g.dt, g.a, g.d,
      static_cast<const bf16*>(g.bm), g.bsb, g.bss,
      static_cast<const bf16*>(g.cm), g.csb, g.css, g.seq, g.heads,
      static_cast<bf16*>(g.y), g.state);
  return cudaGetLastError();
}

// a 16-byte aligned base, and batch and sequence strides of a multiple of
// 8 elements wherever that dimension is longer than 1 (cp.async's rule)
bool aligned16(const void* p, long long sb, long long ss, int bsz, int seq) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0
         && (bsz == 1 || sb % 8 == 0) && (seq == 1 || ss % 8 == 0);
}

}  // namespace

// One SSD scan: y (B, S, H, P) dense in x's dtype, D skip added when `d`
// is not null; state (B, H, P, N) float32.  Route 1 (tensor cores) takes
// bfloat16 at P x N = 112 x 64, 64 x 128 or 16 x 16 with 16-byte aligned
// x, B, C and batch / sequence strides of a multiple of 8 elements (the
// wrapper checks these and raises; here they return cudaErrorInvalidValue
// as well).  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int shark_ssd_scan(const void* x, int dtype, int route,
                              long long xsb, long long xss, const void* dt,
                              const void* a, const void* d, const void* bm,
                              long long bsb, long long bss, const void* cm,
                              long long csb, long long css, int bsz, int seq,
                              int heads, int p, int n, void* y, void* state,
                              void* stream) {
  if (p < 1 || p > kMaxP || n < 1 || n > kMaxN || seq < 1 || bsz < 1
      || heads < 1)
    return cudaErrorInvalidValue;
  const Args g{x, xsb, xss, static_cast<const float*>(dt),
               static_cast<const float*>(a), static_cast<const float*>(d),
               bm, bsb, bss, cm, csb, css, bsz, seq, heads, p, n, y,
               static_cast<float*>(state), static_cast<cudaStream_t>(stream)};
  if (route == kTensorCore) {
    if (dtype != kBFloat16 || !aligned16(x, xsb, xss, bsz, seq)
        || !aligned16(bm, bsb, bss, bsz, seq)
        || !aligned16(cm, csb, css, bsz, seq))
      return cudaErrorInvalidValue;
    if (p == 112 && n == 64) return launch_tc<112, 64>(g);
    if (p == 64 && n == 128) return launch_tc<64, 128>(g);
    if (p == 16 && n == 16) return launch_tc<16, 16>(g);
    return cudaErrorInvalidValue;
  }
  if (route != kSimt) return cudaErrorInvalidValue;
  switch (dtype) {
    case kFloat32:
      return launch_simt<float>(g);
    case kBFloat16:
      return launch_simt<__nv_bfloat16>(g);
    default:
      return cudaErrorInvalidValue;
  }
}
