// Causal flash attention, forward — the Hopper kernel behind
// kernels/flash_attention.py (the hybrid family's shared-attention
// prefill).
//
// Replaces: repro/kernels/flash_attention.py:flash_attention_fwd
// (_flash_fwd_kernel).
//
// Computes o = softmax(q k^T / sqrt(hd)) v per (batch, head), with the
// causal mask col <= row by absolute index, for q (B, H, S, hd) and k, v
// (B, H, T, hd), bfloat16 or float32.  Scores, the running max m, the
// running denominator l and the output accumulator are float32; the
// output is acc / max(l, 1e-30) in q's dtype, as the reference kernel's
// finalize writes it.
//
// What bounds it on an H100: operations.  Causal attention at Zamba2's
// prefill shape (B=4, H=32, S=2048, hd=112) does 4 * B * H * hd * S(S+1)/2
// = 120 GFLOP against 235 MB of q, k, v and o, 510 flops a byte: above the
// card's bf16 ridge (989 TFLOP/s over 3.35 TB/s = 295 flops a byte), so the
// bound is 0.12 ms at the bf16 tensor-core rate.  This first kernel does
// its products with float32 FMAs on the CUDA cores (67 TFLOP/s peak), so it
// sits well above that bound; mma.sync / wgmma tiles with TMA loads are
// the work of a later PR.
//
// Design:
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
//   * key tiles entirely above the diagonal are never loaded;
//   * hd is a runtime parameter up to 128 (Zamba2's 112 is not a power of
//     two); rows past S and keys past T are masked, so any S and T work
//     (the reference wrapper asserts S % block_q == 0);
//   * every operand is read through its batch, head and sequence strides,
//     so a (B, S, H, hd) tensor seen as (B, H, S, hd) is not copied.

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
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int heads, int s_len,
          int t_len, int hd, int causal, float scale, Strides qs, Strides ks,
          Strides vs, Strides os) {
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
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + h * ks.h;
  const T* vp = v + b * vs.b + h * vs.h;
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
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int col = cg * 16 + c;
      if (col < hd) op[row * os.s + col] = from_f<T>(acc[i][c] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int s, int t, int hd, int causal, Strides qs, Strides ks,
           Strides vs, Strides os, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(hd);
  // raise the kernel's dynamic shared-memory limit once, to the most any
  // shape takes (a later call, inside a CUDA graph capture, sets nothing)
  static const cudaError_t configured = cudaFuncSetAttribute(
      flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<T>(kMaxHd)));
  if (configured != cudaSuccess) return configured;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  const dim3 grid((s + kBQ - 1) / kBQ, b * h);
  flash_fwd<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), h, s, t, hd, causal,
      scale, qs, ks, vs, os);
  return cudaGetLastError();
}

}  // namespace

extern "C" int shark_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int b,
    int h, int s, int t, int hd, int causal, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, void* stream) {
  if (hd < 1 || hd > kMaxHd || s < 1 || t < 1 || b < 1 || h < 1
      || static_cast<long long>(b) * h > 65535)
    return cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(q, k, v, o, b, h, s, t, hd, causal, qs, ks, vs,
                           os, st);
    case kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, o, b, h, s, t, hd, causal, qs,
                                   ks, vs, os, st);
    default:
      return cudaErrorInvalidValue;
  }
}
