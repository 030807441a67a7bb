// Mamba2 SSD scan, forward — the Hopper kernel behind kernels/ssd_scan.py
// (every Mamba2 prefill of the ssm and hybrid families).
//
// Replaces: repro/kernels/ssd_scan.py:ssd_scan (_ssd_kernel).
//
// Per (batch b, head h), over the sequence, with ngroups = 1 (one B and C
// for all heads) and cum the running sum of dt * a inside a tile:
//   y_i    = sum_{j <= i in tile} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//            + exp(cum_i) (C_i . state)
//   state' = exp(cum_last) state + sum_j B_j exp(cum_last - cum_j) dt_j x_j
// x (B, S, H, P) and B, C (B, S, N) in bfloat16 or float32, dt (B, S, H)
// and a (H,) float32.  It writes y WITHOUT the D skip as float32 (the
// wrapper adds x * D and casts once, as ssd_chunked does) and, unlike the
// TPU kernel, which kept the state in scratch and dropped it, the final
// state in the reference's (B, H, P, N) float32 layout: prefill hands it to
// the decode cache.
//
// What bounds it on an H100: bytes.  At Zamba2's prefill shape (B=4,
// S=2048, H=64, P=112, N=64) with 64-row tiles, each row costs
// 2 * (32 * (N + P) + 2 * N * P) flops per head (the causal halves of
// C B^T and of M x, C . state and its share of the state update): 20.9
// GFLOP against 246 MB of x, dt, B, C, y (bfloat16) and the state, 85
// flops a byte, under the card's bf16 ridge (295): 0.073 ms of HBM
// traffic.  This first kernel does its products with float32 FMAs on the
// CUDA cores (67 TFLOP/s peak), so it sits above that bound.  C B^T is the
// same for every head and is recomputed per head here; sharing it, and
// tensor-core tiles, are the work of a later PR.
//
// Design:
//   * Hopper has no sequential grid: one block of 256 threads per
//     (batch, head) walks the sequence in a loop, its running state (N x P
//     float32, the TPU scratch's layout: 28 KB for Zamba2, 32 KB for
//     Mamba2-370m) in shared memory.  B * H blocks: 256 for Zamba2 at
//     batch 4, 32 for Mamba2-370m at batch 1;
//   * the TPU kernel's 256-row chunk holds a 256 x 256 float32 tile
//     (256 KB, over the 227 KB a block may have).  This kernel steps 64 rows
//     at a time: the 64 x 64 tile M = (C B^T) o L o dt_j is 17 KB.  The SSD
//     result does not depend on the tile length except through rounding;
//   * each step stages x, B^T and C^T (float32) in shared memory, scans
//     dt * a over the tile with warp shuffles, builds M with exp taken only
//     where j <= i (exp(cum_i - cum_j) of the masked half may overflow, and
//     inf * 0 is NaN), then y = M x + exp(cum) (C state) for the tile's
//     rows and the state update, each thread owning a 4 x 8 (rows x P) and
//     an 8 x 8 (N x P) register block;
//   * B and C are read once per head by batch index: the TPU wrapper's
//     per-head broadcast copies are never made;
//   * rows past S read as dt = 0, x = B = C = 0 (ssd_chunked's padding):
//     the state passes through them, and their y is not written;
//   * x, B and C are read through their batch and sequence strides, so the
//     in-projection's slices are not copied.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;              // rows per step
constexpr int kThreads = 256;
constexpr int kMaxN = 128;
constexpr int kMaxP = 128;
constexpr int kPitch = kT + 4;      // B^T, C^T: [N][kPitch]; M: [kT][kPitch]

enum DType { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3,
             kBFloat16 = 4 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

size_t smem_bytes(int p, int n) {
  return sizeof(float) * (static_cast<size_t>(kT) * p + 2 * n * kPitch
                          + kT * kPitch + static_cast<size_t>(n) * p
                          + 3 * kT);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_fwd(const T* __restrict__ x, long long xsb, long long xss,
        const float* __restrict__ dt, const float* __restrict__ a,
        const T* __restrict__ bm, long long bsb, long long bss,
        const T* __restrict__ cm, long long csb, long long css, int seq,
        int heads, int P, int N, float* __restrict__ y,
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

    // cum = inclusive running sum of dt * a over the tile: warp 0, two rows
    // a lane, a shuffle scan over the lanes' pair sums
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

    // y = M x + exp(cum_i) (C_i . state), rows i0..i0+3, cols cg + 16c
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
        float* yr = y + ((static_cast<long long>(b) * seq + row) * heads + h)
                        * P;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int p = cg + 16 * c;
          if (p < P) yr[p] = acc[i][c] + decay * inter[i][c];
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

template <typename T>
int launch(const void* x, long long xsb, long long xss, const float* dt,
           const float* a, const void* bm, long long bsb, long long bss,
           const void* cm, long long csb, long long css, int bsz, int seq,
           int heads, int p, int n, float* y, float* state,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(p, n);
  // raise the kernel's dynamic shared-memory limit once, to the most any
  // shape takes (a later call, inside a CUDA graph capture, sets nothing)
  static const cudaError_t configured = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxP, kMaxN)));
  if (configured != cudaSuccess) return configured;
  ssd_fwd<T><<<bsz * heads, kThreads, smem, stream>>>(
      static_cast<const T*>(x), xsb, xss, dt, a, static_cast<const T*>(bm),
      bsb, bss, static_cast<const T*>(cm), csb, css, seq, heads, p, n, y,
      state);
  return cudaGetLastError();
}

}  // namespace

extern "C" int shark_ssd_scan(const void* x, int dtype, long long xsb,
                              long long xss, const void* dt, const void* a,
                              const void* bm, long long bsb, long long bss,
                              const void* cm, long long csb, long long css,
                              int bsz, int seq, int heads, int p, int n,
                              void* y, void* state, void* stream) {
  if (p < 1 || p > kMaxP || n < 1 || n > kMaxN || seq < 1 || bsz < 1
      || heads < 1)
    return cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(x, xsb, xss, dtf, af, bm, bsb, bss, cm, csb, css,
                           bsz, seq, heads, p, n, yf, sf, st);
    case kBFloat16:
      return launch<__nv_bfloat16>(x, xsb, xss, dtf, af, bm, bsb, bss, cm,
                                   csb, css, bsz, seq, heads, p, n, yf, sf,
                                   st);
    default:
      return cudaErrorInvalidValue;
  }
}
