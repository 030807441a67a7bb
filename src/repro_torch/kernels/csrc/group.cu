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
// lane.  At the main path's partitions (93,750 rows, G = 50) the bound is
// a third of a microsecond, so what costs is the launch, the latency of
// the loads and the folds, and contention on the accumulators.
//
// Design — one launch per call, no second fold kernel:
//   * the grid is `clusters` thread-block clusters of `cluster` blocks of
//     256 threads (up to 16 a cluster, the non-portable size); one 16-block
//     cluster covers a 93,750-row partition at about 23 rows a thread.  The
//     plan (kernels/groupby_mxu.py:group_plan) is a function of n, so the
//     fold order below is the same on every run;
//   * shared memory runs float64 atomicAdd and 64-bit atomics as
//     compare-and-swap loops (SASS ATOMS.CAST.SPIN.64) that retry on every
//     collision of a warp's lanes, so the hot loop avoids them where it
//     can: counts are uint32 (native atomics), and for the sums of a small
//     G each thread adds into its own column of a [G][256] float64 array
//     with plain loads and stores (lane_sums); a larger G, and the merge,
//     add into per-warp copies of the accumulators (8 copies, one a warp,
//     where the shared memory allows) with atomics.  The merge keeps an
//     order-preserving unsigned encoding of float64 min / max, so integer
//     atomicMin / atomicMax give the exact min and max in any order, and a
//     NaN flag;
//   * a grid-stride loop, four rows in flight a thread, adds each row into
//     its group; ids outside [0, G) contribute nothing (the TPU kernels'
//     out-of-range pad id);
//   * each block folds its copies into copy 0 in copy order (lane sums:
//     each warp folds its groups' 256 columns in a fixed order); after a
//     cluster barrier the cluster's rank-0 block folds the blocks' copy 0
//     over distributed shared memory in rank order, and writes the answer
//     (one cluster) or the cluster's partials to scratch;
//   * with several clusters, the last cluster to finish — a ticket counter
//     in the call's own scratch, zeroed on the stream by the same C call,
//     and __threadfence() — folds the clusters' partials in cluster order.
//     The main path's 93,750-row partitions are one cluster: no scratch,
//     no counter, no memset;
//   * counts, min and max are exact and the same on every run; sums are
//     the only output whose rounding depends on the order of the
//     shared-memory atomics (tolerance rtol 1e-12 against the plain
//     version);
//   * NaN values make the group's min and max NaN, like jnp.min / jnp.max;
//   * an empty group gives sum 0, count 0, min +inf, max -inf.
//
// Accumulation is float64, as in scan.cu, so the card's answers match the
// CPU reference to rounding.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 1024;
constexpr int kMaxCluster = 16;
constexpr int kMaxCopies = 8;             // one per warp
constexpr int kUnroll = 4;                // rows in flight per thread
// a block's 227 KB less 1 KB for the static flag and the runtime's share
constexpr size_t kMaxSmem = 232448 - 1024;
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

// One copy of the accumulators: G float64 sums, for the merge G min and
// max bits, then G uint32 counts and for the merge G NaN flags.  Counts are
// 32-bit so that their shared-memory atomics are native; a block's rows
// stay below 2^32 (the wrapper takes n < 2^40 over at most 256 blocks).
__host__ __device__ constexpr size_t copy_bytes(int G, bool minmax) {
  return ((minmax ? 32 : 12) * static_cast<size_t>(G) + 7) / 8 * 8;
}

// Bytes of the lane-private sums: G float64 per thread ([G][kThreads]).
__host__ __device__ constexpr size_t lane_sum_bytes(int G) {
  return 8 * static_cast<size_t>(G) * kThreads;
}

struct Acc {
  double* sum;
  unsigned long long* mn;
  unsigned long long* mx;
  unsigned int* cnt;
  int* nan;
};

template <bool kMinMax>
__device__ __forceinline__ Acc acc_at(unsigned char* base, int G) {
  Acc a;
  a.sum = reinterpret_cast<double*>(base);
  a.mn = reinterpret_cast<unsigned long long*>(base) + G;
  a.mx = a.mn + G;
  a.cnt = reinterpret_cast<unsigned int*>(base + (kMinMax ? 24 : 8) *
                                                     static_cast<size_t>(G));
  a.nan = reinterpret_cast<int*>(a.cnt + G);
  return a;
}

// Fold group g of `src` into `dst` (dst first, so the order is the
// caller's).
template <bool kMinMax>
__device__ __forceinline__ void fold(Acc dst, Acc src, int g) {
  dst.sum[g] += src.sum[g];
  dst.cnt[g] += src.cnt[g];
  if (kMinMax) {
    dst.mn[g] = min(dst.mn[g], src.mn[g]);
    dst.mx[g] = max(dst.mx[g], src.mx[g]);
    dst.nan[g] |= src.nan[g];
  }
}

// out[g * width + {0: sum, 1: count, 2: min, 3: max}]
template <bool kMinMax>
__device__ __forceinline__ void finish(double sum, unsigned long long cnt,
                                       unsigned long long mn,
                                       unsigned long long mx, bool any_nan,
                                       int g, double* out) {
  double* o = out + (kMinMax ? 4LL : 2LL) * g;
  o[0] = sum;
  o[1] = static_cast<double>(cnt);
  if (kMinMax) {
    const double nan = __longlong_as_double(0x7ff8000000000000LL);
    o[2] = any_nan ? nan : from_order_bits(mn);
    o[3] = any_nan ? nan : from_order_bits(mx);
  }
}

// Scratch of a multi-cluster call: per cluster, lanes of G words (sum,
// count, and for the merge min bits, max bits, NaN flag), then the ticket.
// kLaneSums (sums only, small G): every thread adds its rows' values into
// its own column of a [G][kThreads] float64 array with plain loads and
// stores — no float64 atomics, which shared memory runs as compare-and-swap
// loops that retry on every collision of a warp's lanes — and the counts
// go to the warp's copy with native 32-bit atomics.
template <typename C, typename V, bool kMinMax, bool kLaneSums>
__global__ void __launch_bounds__(kThreads)
group_reduce(const C* __restrict__ codes, const V* __restrict__ vals,
             long long n, int G, int copies, int clusters,
             unsigned long long* __restrict__ scratch,
             unsigned int* __restrict__ ticket, double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kLanes = kMinMax ? 5 : 2;
  cg::cluster_group cluster = cg::this_cluster();
  const size_t stride_bytes = copy_bytes(G, kMinMax);
  double* lane_sums = reinterpret_cast<double*>(smem + copies * stride_bytes);
  const unsigned long long pos_inf =
      order_bits(__longlong_as_double(0x7ff0000000000000LL));
  const unsigned long long neg_inf =
      order_bits(__longlong_as_double(0xfff0000000000000LL));

  for (int c = 0; c < copies; ++c) {
    const Acc a = acc_at<kMinMax>(smem + c * stride_bytes, G);
    for (int g = threadIdx.x; g < G; g += kThreads) {
      a.sum[g] = 0.0;
      a.cnt[g] = 0u;
      if (kMinMax) {
        a.mn[g] = pos_inf;
        a.mx[g] = neg_inf;
        a.nan[g] = 0;
      }
    }
  }
  if (kLaneSums)
    for (int g = 0; g < G; ++g) lane_sums[g * kThreads + threadIdx.x] = 0.0;
  __syncthreads();

  // grid-stride over the rows, kUnroll loads in flight before the adds
  const Acc mine = acc_at<kMinMax>(
      smem + ((threadIdx.x >> 5) % copies) * stride_bytes, G);
  double* my_sums = lane_sums + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i < n; i += kUnroll * step) {
    long long c[kUnroll];
    double v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long at = i + u * step;
      c[u] = at < n ? static_cast<long long>(__ldg(codes + at)) : -1;
      v[u] = at < n ? static_cast<double>(__ldg(vals + at)) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c[u] < 0 || c[u] >= G) continue;
      if (kLaneSums) {
        my_sums[c[u] * kThreads] += v[u];
      } else {
        atomicAdd(mine.sum + c[u], v[u]);
      }
      atomicAdd(mine.cnt + c[u], 1u);
      if (kMinMax) {
        if (isnan(v[u])) {
          mine.nan[c[u]] = 1;
        } else {
          const unsigned long long o = order_bits(v[u]);
          atomicMin(mine.mn + c[u], o);
          atomicMax(mine.mx + c[u], o);
        }
      }
    }
  }
  __syncthreads();

  // the block's copies into copy 0, in copy order
  const Acc own = acc_at<kMinMax>(smem, G);
  for (int c = 1; c < copies; ++c) {
    const Acc a = acc_at<kMinMax>(smem + c * stride_bytes, G);
    for (int g = threadIdx.x; g < G; g += kThreads) fold<kMinMax>(own, a, g);
  }
  if (kLaneSums) {
    __syncthreads();   // the copies' (zero) sums are folded
    // warp w folds groups w, w + 8, ...: each lane its 8 columns in order,
    // then a fixed shuffle tree across the lanes
    const int lane = threadIdx.x & 31;
    for (int g = threadIdx.x >> 5; g < G; g += kThreads / 32) {
      const double* col = lane_sums + g * kThreads + lane;
      double sum = col[0];
#pragma unroll
      for (int k = 1; k < kThreads / 32; ++k) sum += col[32 * k];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, d);
      if (lane == 0) own.sum[g] = sum;
    }
  }
  cluster.sync();   // every block's copy 0 is final and visible

  // rank 0 folds the cluster's blocks over distributed shared memory, in
  // rank order
  const unsigned int rank = cluster.block_rank();
  const int size = static_cast<int>(cluster.num_blocks());
  const int cid = blockIdx.x / size;
  if (rank == 0) {
    for (int g = threadIdx.x; g < G; g += kThreads) {
      // every rank's values in flight at once, then folded in rank order
      double sums[kMaxCluster];
      unsigned long long mns[kMaxCluster], mxs[kMaxCluster];
      unsigned int cnts[kMaxCluster];
      int nans[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r >= size) break;
        const Acc a = acc_at<kMinMax>(cluster.map_shared_rank(smem, r), G);
        sums[r] = a.sum[g];
        cnts[r] = a.cnt[g];
        if (kMinMax) {
          mns[r] = a.mn[g];
          mxs[r] = a.mx[g];
          nans[r] = a.nan[g];
        }
      }
      double sum = sums[0];
      unsigned long long cnt = cnts[0];
      unsigned long long mn = kMinMax ? mns[0] : 0, mx = kMinMax ? mxs[0] : 0;
      bool any_nan = kMinMax && nans[0] != 0;
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r) {
        if (r >= size) break;
        sum += sums[r];
        cnt += cnts[r];
        if (kMinMax) {
          mn = min(mn, mns[r]);
          mx = max(mx, mxs[r]);
          any_nan = any_nan || nans[r] != 0;
        }
      }
      if (clusters == 1) {
        finish<kMinMax>(sum, cnt, mn, mx, any_nan, g, out);
      } else {
        unsigned long long* p =
            scratch + static_cast<long long>(cid) * kLanes * G;
        p[g] = static_cast<unsigned long long>(__double_as_longlong(sum));
        p[G + g] = cnt;
        if (kMinMax) {
          p[2 * G + g] = mn;
          p[3 * G + g] = mx;
          p[4 * G + g] = any_nan ? 1ULL : 0ULL;
        }
      }
    }
  }
  cluster.sync();   // no block leaves while rank 0 still reads its memory

  if (clusters == 1 || rank != 0) return;
  // the last cluster to finish folds every cluster's partials in order
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == clusters - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int g = threadIdx.x; g < G; g += kThreads) {
    double sum = 0.0;
    unsigned long long cnt = 0, mn = ~0ULL, mx = 0;
    bool any_nan = false;
    for (int k = 0; k < clusters; ++k) {
      const unsigned long long* p =
          scratch + static_cast<long long>(k) * kLanes * G;
      sum += __longlong_as_double(static_cast<long long>(__ldcg(p + g)));
      cnt += __ldcg(p + G + g);
      if (kMinMax) {
        mn = min(mn, __ldcg(p + 2 * G + g));
        mx = max(mx, __ldcg(p + 3 * G + g));
        any_nan = any_nan || __ldcg(p + 4 * G + g) != 0;
      }
    }
    finish<kMinMax>(sum, cnt, mn, mx, any_nan, g, out);
  }
}

enum DType { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3 };

struct Plan {
  int cluster, blocks, copies;
  bool lane_sums;
};

template <typename C, typename V, bool kMinMax, bool kLaneSums>
int launch_one(const C* codes, const V* vals, long long n, int G, Plan plan,
               unsigned long long* scratch, unsigned int* ticket,
               double* out, cudaStream_t stream) {
  auto kernel = group_reduce<C, V, kMinMax, kLaneSums>;
  // set once, on the first (eager) call: a call inside a CUDA graph
  // capture sets nothing
  static const cudaError_t configured = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmem));
    return e;
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int clusters = plan.blocks / plan.cluster;
  if (clusters > 1) {
    const cudaError_t e =
        cudaMemsetAsync(ticket, 0, sizeof(unsigned int), stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes =
      plan.copies * copy_bytes(G, kMinMax) + (kLaneSums ? lane_sum_bytes(G)
                                                         : 0);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, codes, vals, n, G,
                                           plan.copies, clusters, scratch,
                                           ticket, out);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename C, typename V>
int launch_values(const C* codes, const V* vals, long long n, int G,
                  bool minmax, Plan plan, unsigned long long* scratch,
                  unsigned int* ticket, double* out, cudaStream_t stream) {
  if (minmax)
    return launch_one<C, V, true, false>(codes, vals, n, G, plan, scratch,
                                         ticket, out, stream);
  if (plan.lane_sums)
    return launch_one<C, V, false, true>(codes, vals, n, G, plan, scratch,
                                         ticket, out, stream);
  return launch_one<C, V, false, false>(codes, vals, n, G, plan, scratch,
                                        ticket, out, stream);
}

template <typename C>
int launch_codes(const C* codes, const void* vals, int vals_dt, long long n,
                 int G, bool minmax, Plan plan, unsigned long long* scratch,
                 unsigned int* ticket, double* out, cudaStream_t stream) {
  switch (vals_dt) {
    case kInt32:
      return launch_values(codes, static_cast<const int32_t*>(vals), n, G,
                           minmax, plan, scratch, ticket, out, stream);
    case kInt64:
      return launch_values(codes, static_cast<const long long*>(vals), n, G,
                           minmax, plan, scratch, ticket, out, stream);
    case kFloat32:
      return launch_values(codes, static_cast<const float*>(vals), n, G,
                           minmax, plan, scratch, ticket, out, stream);
    case kFloat64:
      return launch_values(codes, static_cast<const double*>(vals), n, G,
                           minmax, plan, scratch, ticket, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Per-group reduction of `vals` by `codes` (ids in [0, G); others skipped)
// in one launch.  `plan` packs what the wrapper's launch plan fixes
// (kernels/groupby_mxu.py:plan_word), so that a call crosses ctypes with
// seven arguments:
//   bits 0-1 codes dtype, 2-3 values dtype, 4 with_minmax, 5 lane_sums,
//   8-11 accumulator copies a block, 12-16 blocks a cluster, 20-31 blocks.
// with_minmax == 0: out is (G, 2) [sum, count]       (groupby_sum)
// with_minmax != 0: out is (G, 4) [sum, count, min, max] (segmented_merge)
// With more than one cluster, `out` is followed by the clusters' partials,
// (2 or 5) * G words a cluster, and then the ticket counter.
// Returns a cudaError_t.
extern "C" int shark_group_reduce(const void* codes, const void* vals,
                                  long long n, int num_groups,
                                  long long plan, double* out,
                                  cudaStream_t stream) {
  const int codes_dt = plan & 3;
  const int vals_dt = (plan >> 2) & 3;
  const bool minmax = (plan >> 4) & 1;
  const bool lane_sums = (plan >> 5) & 1;
  const int copies = (plan >> 8) & 15;
  const int cluster = (plan >> 12) & 31;
  const int blocks = (plan >> 20) & 4095;
  const size_t smem = copies * copy_bytes(num_groups, minmax)
                      + (lane_sums ? lane_sum_bytes(num_groups) : 0);
  if (num_groups < 1 || num_groups > kMaxGroups || cluster < 1
      || cluster > kMaxCluster || blocks < cluster || blocks % cluster != 0
      || copies < 1 || copies > kMaxCopies || smem > kMaxSmem
      || (lane_sums && minmax) || n < 0 || n >= (1LL << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{cluster, blocks, copies, lane_sums};
  auto* sc = reinterpret_cast<unsigned long long*>(
      out + (minmax ? 4 : 2) * static_cast<long long>(num_groups));
  auto* tk = reinterpret_cast<unsigned int*>(
      sc + static_cast<long long>(blocks / cluster) * (minmax ? 5 : 2)
               * num_groups);
  switch (codes_dt) {
    case kInt32:
      return launch_codes(static_cast<const int32_t*>(codes), vals, vals_dt,
                          n, num_groups, minmax, p, sc, tk, out, stream);
    case kInt64:
      return launch_codes(static_cast<const long long*>(codes), vals, vals_dt,
                          n, num_groups, minmax, p, sc, tk, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
