// Per-group reduction over small group-id spaces — the Hopper kernel behind
// kernels/groupby_mxu.py (groupby_sum: per-group [sum, count]) and
// kernels/segmented_merge.py (per-group [sum, count, min, max]).
//
// Replaces: repro/kernels/groupby_mxu.py:groupby_sum (_groupby_kernel) and
//           repro/kernels/segmented_merge.py:segmented_merge
//           (_segmerge_kernel).
//
// What bounds it on an H100: the bytes read (a code and a value per row);
// the TPU kernels' one-hot matmul did G multiply-adds a row to suit the
// MXU, but Hopper has no reason to: this kernel does one add per row and
// lane.  With few groups the limit in practice is contention on the
// shared-memory accumulators, not HBM.
//
// Design:
//   * per block, shared-memory accumulators for the G <= 1024 groups:
//     float64 sum, int64 count, and for the merge an order-preserving
//     unsigned encoding of float64 min / max, so that integer atomicMin /
//     atomicMax give the exact min and max in any order;
//   * a grid-stride loop adds each row into its group with shared-memory
//     atomics; ids outside [0, G) contribute nothing (the TPU kernels'
//     out-of-range pad id);
//   * each block writes its partials; a second launch, one thread per
//     group, folds them in block order.  Counts, min and max are exact and
//     the same on every run; sums are the only output whose rounding
//     depends on the order of the shared-memory atomics (tolerance
//     rtol 1e-12 against the plain version);
//   * NaN values make the group's min and max NaN, like jnp.min / jnp.max;
//   * an empty group gives sum 0, count 0, min +inf, max -inf.
//
// Accumulation is float64, as in scan.cu, so the card's answers match the
// CPU reference to rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kSign = 0x8000000000000000ULL;

// Order-preserving map of a float64 onto unsigned 64-bit integers.
__device__ __forceinline__ unsigned long long order_bits(double x) {
  const unsigned long long b =
      static_cast<unsigned long long>(__double_as_longlong(x));
  return (b & kSign) ? ~b : (b | kSign);
}

__device__ __forceinline__ double from_order_bits(unsigned long long u) {
  const unsigned long long b = (u & kSign) ? (u & ~kSign) : ~u;
  return __longlong_as_double(static_cast<long long>(b));
}

// Scratch lanes, each num_blocks * G doubles: sum, count, min bits,
// max bits, NaN flag.
template <typename C, typename V, bool kMinMax>
__global__ void __launch_bounds__(kThreads)
group_partials(const C* __restrict__ codes, const V* __restrict__ vals,
               long long n, int G, double* __restrict__ scratch) {
  extern __shared__ unsigned long long smem[];
  double* s_sum = reinterpret_cast<double*>(smem);
  unsigned long long* s_cnt = smem + G;
  unsigned long long* s_min = smem + 2 * G;
  unsigned long long* s_max = smem + 3 * G;
  int* s_nan = reinterpret_cast<int*>(smem + (kMinMax ? 4 : 2) * G);

  const unsigned long long pos_inf = order_bits(__longlong_as_double(0x7ff0000000000000LL));
  const unsigned long long neg_inf = order_bits(__longlong_as_double(0xfff0000000000000LL));
  for (int g = threadIdx.x; g < G; g += kThreads) {
    s_sum[g] = 0.0;
    s_cnt[g] = 0ULL;
    if (kMinMax) {
      s_min[g] = pos_inf;
      s_max[g] = neg_inf;
      s_nan[g] = 0;
    }
  }
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const long long c = static_cast<long long>(__ldg(codes + i));
    if (c < 0 || c >= G) continue;
    const double v = static_cast<double>(__ldg(vals + i));
    atomicAdd(s_sum + c, v);
    atomicAdd(s_cnt + c, 1ULL);
    if (kMinMax) {
      if (isnan(v)) {
        s_nan[c] = 1;
      } else {
        const unsigned long long o = order_bits(v);
        atomicMin(s_min + c, o);
        atomicMax(s_max + c, o);
      }
    }
  }
  __syncthreads();

  const long long lane = static_cast<long long>(gridDim.x) * G;
  const long long base = static_cast<long long>(blockIdx.x) * G;
  unsigned long long* bits = reinterpret_cast<unsigned long long*>(scratch);
  for (int g = threadIdx.x; g < G; g += kThreads) {
    scratch[base + g] = s_sum[g];
    scratch[lane + base + g] = static_cast<double>(s_cnt[g]);
    if (kMinMax) {
      bits[2 * lane + base + g] = s_min[g];
      bits[3 * lane + base + g] = s_max[g];
      scratch[4 * lane + base + g] = s_nan[g] ? 1.0 : 0.0;
    }
  }
}

// One thread per group folds the block partials in block order into
// out[g * width + {0: sum, 1: count, 2: min, 3: max}].
template <bool kMinMax>
__global__ void __launch_bounds__(kThreads)
group_finish(const double* __restrict__ scratch, int num_blocks, int G,
             double* __restrict__ out) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= G) return;
  const long long lane = static_cast<long long>(num_blocks) * G;
  const unsigned long long* bits =
      reinterpret_cast<const unsigned long long*>(scratch);
  double sum = 0.0, cnt = 0.0;
  unsigned long long mn = ~0ULL, mx = 0ULL;
  bool any_nan = false;
  for (int b = 0; b < num_blocks; ++b) {
    const long long at = static_cast<long long>(b) * G + g;
    sum += scratch[at];
    cnt += scratch[lane + at];
    if (kMinMax) {
      const unsigned long long lo = bits[2 * lane + at];
      const unsigned long long hi = bits[3 * lane + at];
      mn = lo < mn ? lo : mn;
      mx = hi > mx ? hi : mx;
      any_nan = any_nan || scratch[4 * lane + at] != 0.0;
    }
  }
  if (kMinMax) {
    double* o = out + 4LL * g;
    o[0] = sum;
    o[1] = cnt;
    const double nan = __longlong_as_double(0x7ff8000000000000LL);
    o[2] = any_nan ? nan : from_order_bits(mn);
    o[3] = any_nan ? nan : from_order_bits(mx);
  } else {
    double* o = out + 2LL * g;
    o[0] = sum;
    o[1] = cnt;
  }
}

enum DType { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3 };

template <typename C, typename V>
int launch_values(const C* codes, const V* vals, long long n, int G,
                  bool minmax, double* scratch, int num_blocks, double* out,
                  cudaStream_t stream) {
  const size_t smem = minmax ? (4 * sizeof(unsigned long long) + sizeof(int)) * G
                             : 2 * sizeof(unsigned long long) * G;
  const int finish_blocks = (G + kThreads - 1) / kThreads;
  if (minmax) {
    group_partials<C, V, true><<<num_blocks, kThreads, smem, stream>>>(
        codes, vals, n, G, scratch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    group_finish<true><<<finish_blocks, kThreads, 0, stream>>>(
        scratch, num_blocks, G, out);
  } else {
    group_partials<C, V, false><<<num_blocks, kThreads, smem, stream>>>(
        codes, vals, n, G, scratch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    group_finish<false><<<finish_blocks, kThreads, 0, stream>>>(
        scratch, num_blocks, G, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename C>
int launch_codes(const C* codes, const void* vals, int vals_dt, long long n,
                 int G, bool minmax, double* scratch, int num_blocks,
                 double* out, cudaStream_t stream) {
  switch (vals_dt) {
    case kInt32:
      return launch_values(codes, static_cast<const int32_t*>(vals), n, G,
                           minmax, scratch, num_blocks, out, stream);
    case kInt64:
      return launch_values(codes, static_cast<const long long*>(vals), n, G,
                           minmax, scratch, num_blocks, out, stream);
    case kFloat32:
      return launch_values(codes, static_cast<const float*>(vals), n, G,
                           minmax, scratch, num_blocks, out, stream);
    case kFloat64:
      return launch_values(codes, static_cast<const double*>(vals), n, G,
                           minmax, scratch, num_blocks, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Per-group reduction of `vals` by `codes` (ids in [0, G); others skipped).
// with_minmax == 0: out is (G, 2) [sum, count]       (groupby_sum)
// with_minmax != 0: out is (G, 4) [sum, count, min, max] (segmented_merge)
// `scratch` holds 5 * num_blocks * G doubles.  Returns cudaGetLastError().
extern "C" int shark_group_reduce(const void* codes, int codes_dt,
                                  const void* vals, int vals_dt, long long n,
                                  int num_groups, int with_minmax,
                                  double* scratch, int num_blocks,
                                  double* out, cudaStream_t stream) {
  if (num_blocks < 1 || num_groups < 1 || num_groups > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool minmax = with_minmax != 0;
  switch (codes_dt) {
    case kInt32:
      return launch_codes(static_cast<const int32_t*>(codes), vals, vals_dt,
                          n, num_groups, minmax, scratch, num_blocks, out,
                          stream);
    case kInt64:
      return launch_codes(static_cast<const long long*>(codes), vals, vals_dt,
                          n, num_groups, minmax, scratch, num_blocks, out,
                          stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
