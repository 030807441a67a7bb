// Fused range filter + [count, sum, min, max] scan, optionally through a
// dictionary — the Hopper kernel behind kernels/colscan.py and the
// fused_decode_scan of kernels/dictdecode.py.
//
// Replaces: repro/kernels/colscan.py:colscan (_colscan_kernel) and
//           repro/kernels/dictdecode.py:fused_decode_scan
//           (_fused_decode_scan_kernel).
//
// What bounds it on an H100: the bytes read from HBM (the filter column or
// its int32 codes, plus the aggregate column); it does four flops a row.
// A 93,750-row float64 partition is 1.5 MB, under half a microsecond at
// 3.35 TB/s, so at main-path sizes the launch itself dominates.
//
// Design:
//   * one template, parametrised by the filter policy: PlainFilter reads
//     the filter column, DictGather reads an int32 code and gathers the
//     value from the (small, L1-resident) dictionary — the decoded filter
//     column never exists in HBM;
//   * a grid-stride loop: every thread folds count (int64), sum, min, max
//     in float64 registers, reading each input in its own dtype;
//   * a warp-shuffle then shared-memory block reduction writes one partial
//     per block; a second one-block launch folds the partials in a fixed
//     order.  The grid size is a function of n only, so a result is the
//     same on every run.  No floating-point atomics;
//   * the predicate is `lo <= (double)f && (double)f <= hi`, so NaN filter
//     values (and out-of-range codes, the pad code d) fail both bounds even
//     when a bound is +-inf, as in the TPU kernel;
//   * min / max propagate NaN aggregate values like jnp.min / jnp.max.
//
// Accumulation is float64 (the TPU kernel used float32, its vector unit's
// native type): the kernel is bandwidth-bound and Hopper has float64
// units, so the wider accumulator costs nothing that matters and the
// card's answers match the CPU reference to rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ double nan_value() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// min / max that propagate NaN: once the accumulator is NaN it stays NaN.
__device__ __forceinline__ double nan_min(double acc, double v) {
  return (v < acc || isnan(v)) ? v : acc;
}
__device__ __forceinline__ double nan_max(double acc, double v) {
  return (v > acc || isnan(v)) ? v : acc;
}

template <typename F>
struct PlainFilter {
  const F* f;
  __device__ __forceinline__ double operator()(long long i) const {
    return static_cast<double>(__ldg(f + i));
  }
};

template <typename F>
struct DictGather {
  const int32_t* codes;
  const F* dict;
  long long dict_len;
  __device__ __forceinline__ double operator()(long long i) const {
    const int32_t c = __ldg(codes + i);
    return (c >= 0 && c < dict_len) ? static_cast<double>(__ldg(dict + c))
                                    : nan_value();
  }
};

struct Acc {
  long long cnt;
  double sum, mn, mx;
};

__device__ __forceinline__ Acc warp_fold(Acc a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long c = __shfl_down_sync(0xffffffffu, a.cnt, off);
    const double s = __shfl_down_sync(0xffffffffu, a.sum, off);
    const double lo = __shfl_down_sync(0xffffffffu, a.mn, off);
    const double hi = __shfl_down_sync(0xffffffffu, a.mx, off);
    a.cnt += c;
    a.sum += s;
    a.mn = nan_min(a.mn, lo);
    a.mx = nan_max(a.mx, hi);
  }
  return a;
}

// Block-wide fold in a fixed order; thread 0 returns the block's result.
__device__ __forceinline__ Acc block_fold(Acc a) {
  __shared__ long long s_cnt[kWarps];
  __shared__ double s_sum[kWarps], s_mn[kWarps], s_mx[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = warp_fold(a);
  if (lane == 0) {
    s_cnt[warp] = a.cnt;
    s_sum[warp] = a.sum;
    s_mn[warp] = a.mn;
    s_mx[warp] = a.mx;
  }
  __syncthreads();
  if (warp == 0) {
    if (lane < kWarps) {
      a.cnt = s_cnt[lane];
      a.sum = s_sum[lane];
      a.mn = s_mn[lane];
      a.mx = s_mx[lane];
    } else {
      a.cnt = 0;
      a.sum = 0.0;
      a.mn = __longlong_as_double(0x7ff0000000000000LL);   // +inf
      a.mx = __longlong_as_double(0xfff0000000000000LL);   // -inf
    }
    a = warp_fold(a);
  }
  return a;
}

__device__ __forceinline__ Acc empty_acc() {
  Acc a;
  a.cnt = 0;
  a.sum = 0.0;
  a.mn = __longlong_as_double(0x7ff0000000000000LL);
  a.mx = __longlong_as_double(0xfff0000000000000LL);
  return a;
}

template <typename Filter, typename A>
__global__ void __launch_bounds__(kThreads)
scan_partials(Filter filt, const A* __restrict__ agg, long long n, double lo,
              double hi, double* __restrict__ partials) {
  Acc acc = empty_acc();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const double f = filt(i);
    if (lo <= f && f <= hi) {
      const double v = static_cast<double>(__ldg(agg + i));
      acc.cnt += 1;
      acc.sum += v;
      acc.mn = nan_min(acc.mn, v);
      acc.mx = nan_max(acc.mx, v);
    }
  }
  acc = block_fold(acc);
  if (threadIdx.x == 0) {
    double* p = partials + 4 * static_cast<long long>(blockIdx.x);
    p[0] = static_cast<double>(acc.cnt);
    p[1] = acc.sum;
    p[2] = acc.mn;
    p[3] = acc.mx;
  }
}

// One block folds the per-block partials in a fixed order.
__global__ void __launch_bounds__(kThreads)
scan_finish(const double* __restrict__ partials, int num_blocks,
            double* __restrict__ out) {
  Acc acc = empty_acc();
  for (int b = threadIdx.x; b < num_blocks; b += kThreads) {
    const double* p = partials + 4 * static_cast<long long>(b);
    acc.cnt += static_cast<long long>(p[0]);
    acc.sum += p[1];
    acc.mn = nan_min(acc.mn, p[2]);
    acc.mx = nan_max(acc.mx, p[3]);
  }
  acc = block_fold(acc);
  if (threadIdx.x == 0) {
    out[0] = static_cast<double>(acc.cnt);
    out[1] = acc.sum;
    out[2] = acc.mn;
    out[3] = acc.mx;
  }
}

// dtype codes shared with the Python wrappers (kernels/_build.py)
enum DType { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3 };

template <typename Filter>
int launch_with_filter(Filter filt, const void* a, int a_dt, long long n,
                       double lo, double hi, double* partials, int num_blocks,
                       double* out, cudaStream_t stream) {
  switch (a_dt) {
    case kInt32:
      scan_partials<<<num_blocks, kThreads, 0, stream>>>(
          filt, static_cast<const int32_t*>(a), n, lo, hi, partials);
      break;
    case kInt64:
      scan_partials<<<num_blocks, kThreads, 0, stream>>>(
          filt, static_cast<const long long*>(a), n, lo, hi, partials);
      break;
    case kFloat32:
      scan_partials<<<num_blocks, kThreads, 0, stream>>>(
          filt, static_cast<const float*>(a), n, lo, hi, partials);
      break;
    case kFloat64:
      scan_partials<<<num_blocks, kThreads, 0, stream>>>(
          filt, static_cast<const double*>(a), n, lo, hi, partials);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_finish<<<1, kThreads, 0, stream>>>(partials, num_blocks, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int launch_typed(const F* f, const int32_t* codes, long long dict_len,
                 const void* a, int a_dt, long long n, double lo, double hi,
                 double* partials, int num_blocks, double* out,
                 cudaStream_t stream) {
  if (codes == nullptr) {
    PlainFilter<F> filt{f};
    return launch_with_filter(filt, a, a_dt, n, lo, hi, partials, num_blocks,
                              out, stream);
  }
  DictGather<F> filt{codes, f, dict_len};
  return launch_with_filter(filt, a, a_dt, n, lo, hi, partials, num_blocks,
                            out, stream);
}

}  // namespace

// [count, sum, min, max] of `a` over rows with lo <= filter <= hi.
// codes == NULL: `f` is the filter column (n values).
// codes != NULL: `f` is a dictionary of dict_len values and the filter
//                value of row i is f[codes[i]].
// `partials` holds 4 * num_blocks doubles of scratch; `out` 4 doubles.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int shark_colscan(const void* f, int f_dt, const int32_t* codes,
                             long long dict_len, const void* a, int a_dt,
                             long long n, double lo, double hi,
                             double* partials, int num_blocks, double* out,
                             cudaStream_t stream) {
  if (num_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (f_dt) {
    case kInt32:
      return launch_typed(static_cast<const int32_t*>(f), codes, dict_len, a,
                          a_dt, n, lo, hi, partials, num_blocks, out, stream);
    case kInt64:
      return launch_typed(static_cast<const long long*>(f), codes, dict_len,
                          a, a_dt, n, lo, hi, partials, num_blocks, out,
                          stream);
    case kFloat32:
      return launch_typed(static_cast<const float*>(f), codes, dict_len, a,
                          a_dt, n, lo, hi, partials, num_blocks, out, stream);
    case kFloat64:
      return launch_typed(static_cast<const double*>(f), codes, dict_len, a,
                          a_dt, n, lo, hi, partials, num_blocks, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
