// Fused range filter + [count, sum, min, max] scan, optionally through a
// dictionary — the Hopper kernel behind kernels/colscan.py and the
// fused_decode_scan of kernels/dictdecode.py.
//
// Replaces: repro/kernels/colscan.py:colscan (_colscan_kernel) and
//           repro/kernels/dictdecode.py:fused_decode_scan
//           (_fused_decode_scan_kernel).
//
// What bounds it on an H100: the bytes read from HBM (the filter column or
// its int32 codes, plus the aggregate column, or one column when the two
// are the same); it does four flops a row.  A 93,750-row float64
// partition is 750 KB, a quarter of a microsecond at 3.35 TB/s: at the
// main path's sizes all of it fits in flight at once, so what costs is the
// launch, the round trips to memory and the fold across blocks.  Each
// dependent round trip costs about half a microsecond (per-block
// timestamps, scripts/kernel_probe.py scan), so the design counts them:
// one for the rows, three for the fold.
//
// Design — one launch a call:
//   * one template, three sources of a row: Plain (the filter column and
//     the aggregate column), Same (one column that is both: read once) and
//     Dict (int32 codes gathered through a dictionary, staged in shared
//     memory as float64 when the plan says it fits, else read with __ldg;
//     the decoded filter column never exists).  A code outside [0, d) —
//     the TPU kernel's pad code d — reads NaN;
//   * rows go to warps in tiles of 32 * kRows; tile j belongs to warp
//     (j / blocks) % warps of block j % blocks, so the tiles spread evenly
//     over the blocks, at most one block an SM.  Lane l of a tile holds W
//     rows at l * W in each of kRows / W slices, W = 16 bytes over the
//     wider operand's element, so one load instruction of a warp covers
//     32 * W neighbouring rows;
//   * every load of a tile (filter or codes, and the aggregate) is issued
//     before any predicate is evaluated; the aggregate is read
//     unconditionally and selected, not branched on.  The full tiles take
//     one path for the whole loop — 16-byte (for the narrower operand
//     8-byte) vector loads when every operand is on that size, else
//     scalar loads, as for a view at an element offset — so no branch
//     joins a load to its use; the ragged last tile takes scalar loads
//     with its rows past n masked.  The rows a thread owns, and so the
//     result's bits, do not depend on the path;
//   * each warp folds its lanes, each block its warps (fixed shuffle
//     trees, then warp order); lane 0 of each block writes the block's
//     partial and takes a ticket with one acq_rel atomic (release orders
//     the partial before it, acquire the others' after it; wrapping at the
//     grid size, so the word is back at 0 for the next launch); warp 0 of
//     the last block folds every partial, lane l those of blocks l,
//     l + 32, ... with all its loads in flight, then the warp's tree.  The
//     partials follow the answer in the call's one buffer; the ticket is a
//     word per (device, stream) that the wrapper keeps
//     (kernels/_common.py:stream_ticket, as for train.cu and topk.cu):
//     launches on one stream run in order, launches on two never share a
//     word.  The grid is a function of n only, so the result has the same
//     bits on every run.  No floating-point atomics;
//   * the predicate is `lo <= (double)f && (double)f <= hi`, so NaN filter
//     values (and out-of-range codes) fail both bounds even when a bound
//     is +-inf, as in the TPU kernel; min / max propagate NaN aggregate
//     values like jnp.min / jnp.max; the count is exact.
//
// Accumulation is float64 (the TPU kernel used float32, its vector unit's
// native type): the kernel is bandwidth-bound and Hopper has float64
// units, so the wider accumulator costs nothing that matters and the
// card's answers match the CPU reference to rounding.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kRows = 4;                  // rows a thread takes a step
constexpr int kTileRows = 32 * kRows;     // rows of a warp's tile
constexpr int kMaxWarps = 32;
constexpr int kFoldBatch = 5;             // partials a lane loads at once
constexpr int kMaxStageBytes = 32 * 1024;  // under the 48 KB default

enum Mode { kPlain = 0, kSame = 1, kDictGlobal = 2, kDictStaged = 3 };

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

struct Acc {
  long long cnt;
  double sum, mn, mx;
};

__device__ __forceinline__ Acc empty_acc() {
  Acc a;
  a.cnt = 0;
  a.sum = 0.0;
  a.mn = __longlong_as_double(0x7ff0000000000000LL);   // +inf
  a.mx = __longlong_as_double(0xfff0000000000000LL);   // -inf
  return a;
}

__device__ __forceinline__ Acc join(Acc a, const Acc& b) {
  a.cnt += b.cnt;
  a.sum += b.sum;
  a.mn = nan_min(a.mn, b.mn);
  a.mx = nan_max(a.mx, b.mx);
  return a;
}

// lane 0 returns the warp's fold (a fixed tree)
__device__ __forceinline__ Acc warp_fold(Acc a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Acc b;
    b.cnt = __shfl_down_sync(0xffffffffu, a.cnt, off);
    b.sum = __shfl_down_sync(0xffffffffu, a.sum, off);
    b.mn = __shfl_down_sync(0xffffffffu, a.mn, off);
    b.mx = __shfl_down_sync(0xffffffffu, a.mx, off);
    a = join(a, b);
  }
  return a;
}

// Block-wide fold in a fixed order; thread 0 returns the block's result.
__device__ __forceinline__ Acc block_fold(Acc a) {
  __shared__ long long s_cnt[kMaxWarps];
  __shared__ double s_sum[kMaxWarps], s_mn[kMaxWarps], s_mx[kMaxWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  a = warp_fold(a);
  if (warps == 1) return a;
  if (lane == 0) {
    s_cnt[warp] = a.cnt;
    s_sum[warp] = a.sum;
    s_mn[warp] = a.mn;
    s_mx[warp] = a.mx;
  }
  __syncthreads();
  if (warp == 0) {
    a = empty_acc();
    if (lane < warps) {
      a.cnt = s_cnt[lane];
      a.sum = s_sum[lane];
      a.mn = s_mn[lane];
      a.mx = s_mx[lane];
    }
    a = warp_fold(a);
  }
  return a;
}

__device__ __forceinline__ void put(double* p, const Acc& a) {
  p[0] = static_cast<double>(a.cnt);
  p[1] = a.sum;
  p[2] = a.mn;
  p[3] = a.mx;
}

// The ticket: release orders this thread's partial before it, acquire the
// other blocks' partials after it; wraps to 0 at `last`.
__device__ __forceinline__ unsigned int take_ticket(unsigned int* p,
                                                    unsigned int last) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(last) : "memory");
  return old;
}

// 16 / W bytes of W values from p: one vector load.
template <typename T, int W>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, T* out) {
  constexpr int kBytes = W * static_cast<int>(sizeof(T));
  static_assert(kBytes == 8 || kBytes == 16, "8- or 16-byte vectors");
  if constexpr (kBytes == 16) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(out, &w, 16);
  } else {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    memcpy(out, &w, 8);
  }
}

struct Args {
  const void* filt;     // the filter column, or the codes
  const void* dict;     // the dictionary (Dict) or NULL
  const void* agg;      // the aggregate column (Same: the filter column)
  long long n;
  long long dict_len;
  double lo, hi;
  double* out;          // [count, sum, min, max]
  double* partials;     // 4 doubles a block, after out in the call's buffer
  unsigned int* ticket; // the stream's fold ticket, 0 between launches
};

// A thread's rows of one warp tile: lane l holds W rows at l * W in each
// of kRows / W slices of 32 * W rows.  F: the filter column's (Dict: the
// dictionary's) type; A: the aggregate's (Same: F).
template <typename F, typename A, int kMode>
struct Tile {
  static constexpr bool kDict = kMode == kDictGlobal || kMode == kDictStaged;
  using R = typename std::conditional<kDict, int32_t, F>::type;  // per row
  static constexpr int kWide = sizeof(R) > sizeof(A) ? sizeof(R) : sizeof(A);
  static constexpr int kW = 16 / kWide;     // rows a vector load covers
  static constexpr int kSlices = kRows / kW;
  static_assert(kRows % kW == 0, "kRows is a multiple of the vector rows");

  R f[kRows];
  A a[kRows];

  __device__ __forceinline__ static long long row(long long base, int k) {
    return base + static_cast<long long>(k / kW) * 32 * kW + k % kW;
  }

  // Issue every load of the tile at `base` (this lane's first row): vector
  // loads (kVec), or scalar ones; kMask clamps rows past n to row n - 1
  // (read, then masked in fold).  Nothing here waits on a load.
  template <bool kVec, bool kMask>
  __device__ __forceinline__ void issue(const R* __restrict__ fp,
                                        const A* __restrict__ ap,
                                        long long base, long long n) {
#pragma unroll
    for (int s = 0; s < kSlices; ++s) {
      const long long i = base + static_cast<long long>(s) * 32 * kW;
      if constexpr (kVec) {
        load_vec<R, kW>(fp + i, f + s * kW);
        if constexpr (kMode != kSame) load_vec<A, kW>(ap + i, a + s * kW);
      } else {
#pragma unroll
        for (int j = 0; j < kW; ++j) {
          const long long r = kMask ? min(i + j, n - 1) : i + j;
          f[s * kW + j] = __ldg(fp + r);
          if constexpr (kMode != kSame) a[s * kW + j] = __ldg(ap + r);
        }
      }
    }
  }

  // Add the tile's selected rows to acc (kMask: only rows below n).
  template <bool kMask>
  __device__ __forceinline__ void fold(Acc& acc, long long base, long long n,
                                       double lo, double hi,
                                       const F* __restrict__ dp,
                                       long long d, const double* s_dict) {
    double fv[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if constexpr (kDict) {
        const int32_t c = f[k];
        fv[k] = nan_value();
        if (c >= 0 && c < d) {
          if constexpr (kMode == kDictStaged)
            fv[k] = s_dict[c];
          else
            fv[k] = static_cast<double>(__ldg(dp + c));
        }
      } else {
        fv[k] = static_cast<double>(f[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      double v;
      if constexpr (kMode == kSame)
        v = fv[k];
      else
        v = static_cast<double>(a[k]);
      const bool sel = (!kMask || row(base, k) < n) && lo <= fv[k] &&
                       fv[k] <= hi;
      acc.cnt += sel;
      acc.sum += sel ? v : 0.0;
      acc.mn = sel ? nan_min(acc.mn, v) : acc.mn;
      acc.mx = sel ? nan_max(acc.mx, v) : acc.mx;
    }
  }
};

template <typename F, typename A, int kMode>
__global__ void __launch_bounds__(1024, 1) scan_kernel(const Args args) {
  using T = Tile<F, A, kMode>;
  using R = typename T::R;
  extern __shared__ double s_dict[];
  const R* __restrict__ fp = static_cast<const R*>(args.filt);
  const A* __restrict__ ap = static_cast<const A*>(args.agg);
  const F* __restrict__ dp = static_cast<const F*>(args.dict);
  const long long n = args.n;
  const int lane = threadIdx.x & 31;
  const long long full = n / kTileRows;     // tiles with every row below n
  const long long stride = static_cast<long long>(gridDim.x) *
                           (blockDim.x >> 5);
  long long tile = static_cast<long long>(threadIdx.x >> 5) * gridDim.x +
                   blockIdx.x;
  T t;
  Acc acc = empty_acc();
  // the full tiles, each step's loads all issued before its first test;
  // one path for the whole loop (vector loads when every operand is on 16
  // bytes), so no branch joins a load to its use
  auto run = [&](auto vec) {
    constexpr bool kVec = decltype(vec)::value;
    if (tile < full) t.template issue<kVec, false>(fp, ap, tile * kTileRows +
                                                   lane * T::kW, n);
    if constexpr (kMode == kDictStaged) {   // under the first step's loads
      for (long long j = threadIdx.x; j < args.dict_len; j += blockDim.x)
        s_dict[j] = static_cast<double>(__ldg(dp + j));
      __syncthreads();
    }
    while (tile < full) {
      const long long base = tile * kTileRows + lane * T::kW;
      t.template fold<false>(acc, base, n, args.lo, args.hi, dp,
                             args.dict_len, s_dict);
      tile += stride;
      if (tile < full) t.template issue<kVec, false>(fp, ap, tile * kTileRows +
                                                     lane * T::kW, n);
    }
  };
  constexpr uintptr_t kFAlign = T::kW * sizeof(R), kAAlign = T::kW * sizeof(A);
  if (reinterpret_cast<uintptr_t>(fp) % kFAlign == 0 &&
      reinterpret_cast<uintptr_t>(ap) % kAAlign == 0)
    run(std::true_type{});
  else
    run(std::false_type{});
  if (tile == full && full * kTileRows < n) {   // the ragged last tile
    const long long base = tile * kTileRows + lane * T::kW;
    t.template issue<false, true>(fp, ap, base, n);
    t.template fold<true>(acc, base, n, args.lo, args.hi, dp, args.dict_len,
                          s_dict);
  }

  acc = block_fold(acc);
  if (threadIdx.x >= 32) return;            // warp 0 goes on
  if (gridDim.x == 1) {
    if (lane == 0) put(args.out, acc);
    return;
  }
  const unsigned int nb = gridDim.x;
  double* partials = args.partials;
  unsigned int last = 0;
  if (lane == 0) {
    put(partials + 4 * blockIdx.x, acc);
    last = take_ticket(args.ticket, nb - 1) == nb - 1;
  }
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __syncwarp();                             // lane 0's acquire, for the warp
  // the last block's warp folds the partials: lane l those of blocks l,
  // l + 32, ... in order, kFoldBatch loads in flight, then the warp's tree
  Acc a = empty_acc();
  for (unsigned int b0 = lane; b0 < nb; b0 += 32 * kFoldBatch) {
    double2 p[kFoldBatch][2];
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k) {
      const unsigned int b = b0 + 32 * k;
      if (b < nb) {
        const double2* q =
            reinterpret_cast<const double2*>(partials + 4 * b);
        p[k][0] = __ldcg(q);
        p[k][1] = __ldcg(q + 1);
      }
    }
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k) {
      if (b0 + 32 * k < nb) {
        Acc q;
        q.cnt = static_cast<long long>(p[k][0].x);
        q.sum = p[k][0].y;
        q.mn = p[k][1].x;
        q.mx = p[k][1].y;
        a = join(a, q);
      }
    }
  }
  a = warp_fold(a);
  if (lane == 0) put(args.out, a);
}

// dtype codes shared with the Python wrappers (kernels/_build.py)
enum DType { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3 };

template <typename F, typename A, int kMode>
int launch(const Args& a, int blocks, int warps, size_t smem,
           cudaStream_t stream) {
  scan_kernel<F, A, kMode><<<blocks, 32 * warps, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename F, int kMode>
int by_agg(int adt, const Args& a, int blocks, int warps, size_t smem,
           cudaStream_t stream) {
  switch (adt) {
    case kInt32:
      return launch<F, int32_t, kMode>(a, blocks, warps, smem, stream);
    case kInt64:
      return launch<F, long long, kMode>(a, blocks, warps, smem, stream);
    case kFloat32:
      return launch<F, float, kMode>(a, blocks, warps, smem, stream);
    case kFloat64:
      return launch<F, double, kMode>(a, blocks, warps, smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename F>
int by_mode(int mode, int adt, const Args& a, int blocks, int warps,
            size_t smem, cudaStream_t stream) {
  switch (mode) {
    case kPlain:
      return by_agg<F, kPlain>(adt, a, blocks, warps, smem, stream);
    case kSame:
      return launch<F, F, kSame>(a, blocks, warps, smem, stream);
    case kDictGlobal:
      return by_agg<F, kDictGlobal>(adt, a, blocks, warps, smem, stream);
    default:
      return by_agg<F, kDictStaged>(adt, a, blocks, warps, smem, stream);
  }
}

}  // namespace

// [count, sum, min, max] of the aggregate over rows with
// lo <= filter <= hi, in one launch.  `word` packs what the wrapper's plan
// fixes (kernels/colscan.py:scan_word), so a call crosses ctypes with ten
// plain arguments:
//   bits 0-1 the filter's dtype (codes: the dictionary's), 2-3 the
//   aggregate's, 4 codes (`filt` holds n int32 codes into `dict`), 5 one
//   column (`agg` is `filt`, read once), 6 the dictionary staged in shared
//   memory, 7-12 warps a block (1-32), 13-24 blocks, 25-54 the
//   dictionary's length.
// `buf` receives the answer, 4 doubles, and above one block holds the
// blocks' partials after it (4 more doubles a block); `ticket` is the
// stream's fold ticket, a word that is 0 between launches (unused by one
// block).  Returns a cudaError_t (0 on success).
extern "C" int shark_scan(const void* filt, const void* dict, const void* agg,
                          long long n, unsigned long long word, double lo,
                          double hi, double* buf, unsigned int* ticket,
                          cudaStream_t stream) {
  const int fdt = static_cast<int>(word & 3);
  const int adt = static_cast<int>((word >> 2) & 3);
  const bool coded = (word >> 4) & 1;
  const bool same = (word >> 5) & 1;
  const bool staged = (word >> 6) & 1;
  const int warps = static_cast<int>((word >> 7) & 63);
  const int blocks = static_cast<int>((word >> 13) & 4095);
  const long long dict_len = static_cast<long long>((word >> 25) &
                                                    ((1ULL << 30) - 1));
  if (n < 0 || n >= (1LL << 40) || warps < 1 || warps > kMaxWarps ||
      blocks < 1 || (blocks > 1 && ticket == nullptr) || (same && coded) ||
      (staged && (!coded || dict_len * 8 > kMaxStageBytes)) ||
      (coded && dict_len > 0 && dict == nullptr) || buf == nullptr ||
      (n > 0 && (filt == nullptr || (!same && agg == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.filt = filt;
  a.dict = dict;
  a.agg = same ? filt : agg;
  a.n = n;
  a.dict_len = dict_len;
  a.lo = lo;
  a.hi = hi;
  a.out = buf;
  a.partials = buf + 4;
  a.ticket = ticket;
  const int mode = coded ? (staged ? kDictStaged : kDictGlobal)
                         : (same ? kSame : kPlain);
  const size_t smem = staged ? static_cast<size_t>(dict_len) * 8 : 0;
  switch (fdt) {
    case kInt32:
      return by_mode<int32_t>(mode, adt, a, blocks, warps, smem, stream);
    case kInt64:
      return by_mode<long long>(mode, adt, a, blocks, warps, smem, stream);
    case kFloat32:
      return by_mode<float>(mode, adt, a, blocks, warps, smem, stream);
    default:
      return by_mode<double>(mode, adt, a, blocks, warps, smem, stream);
  }
}
