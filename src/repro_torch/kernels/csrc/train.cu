// Full-batch gradient of the in-engine estimators — the Hopper kernel
// behind kernels/train_grad.py.
//
// Replaces: repro/kernels/train_grad.py:train_grad (_grad_kernel).
//
// Computes g = sum_i x_i * r_i over the rows of x (n, d), row-major, where
// r_i = sigmoid(x_i . w) - y_i (logistic) or x_i . w - y_i (linear), as the
// unnormalised (d,) float64 sum; x, y and w share one dtype (float32 or
// float64) and every product and sum is taken in float64.
//
// What bounds it on an H100: one read of x.  It does about 4 flops per
// element of x (the dot product, then the weighted add), 1 flop per byte
// in float32, far under the card's float64 rate, so a 156,250 x 12 float32
// partition (7.5 MB) is bounded by 2.2 us of HBM traffic.  Tensor cores do
// not help at this intensity: the TPU kernel's two MXU products per
// 1024-row tile become plain float64 arithmetic here.  At that size the
// whole of x fits in flight at once, so the design is about latency: one
// launch, every row's load issued before any arithmetic waits on it, and a
// short fold.
//
// Design:
//   * one launch a call.  Each block writes one partial row (d doubles);
//     the last block to finish — a ticket counter taken after a
//     __threadfence() — folds all partial rows in a fixed order (a
//     function of the grid and d only) and resets the ticket to 0 for the
//     next launch.  The ticket is a word per (device, stream) that the
//     wrapper allocates at the stream's first call: launches on one stream
//     run in order, so two never hold it at once, and no memset runs per
//     call.
//     The grid is a function of n only, so the result has the same bits on
//     every run;
//   * route `registers` (d <= 32): the row's columns pad to D = 4, 8, 16
//     or 32 (a template) and split into chunks of one 16-byte load (4
//     float32 or 2 float64 columns); D / chunk neighbouring lanes share a
//     row, each owning one chunk, so a warp reads 32 / (lanes a row)
//     consecutive rows as one contiguous span (scalar loads where d *
//     sizeof(T) is not a multiple of 16 or x does not start on 16 bytes).
//     A lane takes 4 rows a step of a grid-stride loop and issues all
//     their loads, and y's, before any arithmetic; it adds its chunk's
//     products, the row's lanes add their partial z in a fixed butterfly
//     (all end with the same bits), each computes r and adds r * x_j into
//     its chunk's float64 accumulators in registers.  No shared memory,
//     no barrier and no second read of x inside the loop, and few
//     registers (a chunk, not a row, a lane), so many blocks an SM.  At
//     the end lanes owning the same chunk add across the warp in a fixed
//     butterfly, warps add in warp order, and thread j < d writes column
//     j of the block's partial row;
//   * route `chunked` (d > 32): each block walks a fixed row range in
//     chunks of 256 rows: thread t computes z = x_t . w for row t of the
//     chunk (w in shared memory), then r into shared memory; then
//     G = 256 / min(d, 256) groups of column owners add r_i * x_ij for
//     their rows and columns into per-group shared-memory slots (the chunk
//     is still in L1), and the block folds its G groups in order;
//   * rows past n are never read: the ragged edge is masked, and x is not
//     padded in device memory (the TPU wrapper's zero-padded copy was a
//     second pass over x);
//   * the sigmoid is the stable two-branch form: 1 / (1 + e^-z) for z >= 0,
//     e^z / (1 + e^z) below.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDims = 2048;
constexpr int kFoldBatch = 16;      // the fold's loads in flight a thread

// 1 / (1 + e^-z) for z >= 0, e^z / (1 + e^z) below, with e = exp(-|z|):
// the two branches' values from one exp and one divide, so a warp whose
// rows differ in sign does not run both
__device__ __forceinline__ double stable_sigmoid(double z) {
  const double e = exp(-fabs(z));
  return (z >= 0.0 ? 1.0 : e) / (1.0 + e);
}

// The last block to take a ticket folds the nb partial rows (d doubles
// each) into out, in an order fixed by nb and d: thread (g, c) of G groups
// of min(d, 256) column slots adds rows g, g + G, ... of its column, then
// the G group sums add in group order.  Call after the block's partial row
// is written, from every thread of the block.
__device__ void fold_if_last(const double* __restrict__ partials, int nb,
                             int d, unsigned int* __restrict__ ticket,
                             double* __restrict__ out) {
  __shared__ double s_fold[kThreads];
  __shared__ bool s_last;
  __threadfence();                  // this block's row, before its ticket
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == nb - 1u;
  __syncthreads();
  if (!s_last) return;
  __threadfence();                  // every other block's row, after it
  const int t = threadIdx.x;
  const int cpp = d < kThreads ? d : kThreads;
  const int groups = kThreads / cpp;
  const int g = t / cpp;
  for (int j0 = 0; j0 < d; j0 += cpp) {
    const int j = j0 + t % cpp;
    double s = 0.0;
    if (g < groups && j < d) {
      // kFoldBatch loads in flight, then their adds in row order
      for (int b0 = g; b0 < nb; b0 += kFoldBatch * groups) {
        double v[kFoldBatch];
#pragma unroll
        for (int k = 0; k < kFoldBatch; ++k) {
          const int b = b0 + k * groups;
          v[k] = b < nb
                 ? __ldcg(partials + static_cast<long long>(b) * d + j)
                 : 0.0;
        }
#pragma unroll
        for (int k = 0; k < kFoldBatch; ++k)
          if (b0 + k * groups < nb) s += v[k];
      }
    }
    if (groups == 1) {
      if (g == 0 && j < d) out[j] = s;
      continue;
    }
    s_fold[t] = s;                  // groups > 1 only when d <= 128
    __syncthreads();
    if (t < d) {
      double tot = 0.0;
      for (int k = 0; k < groups; ++k) tot += s_fold[k * cpp + t];
      out[t] = tot;
    }
  }
  if (t == 0) *ticket = 0u;         // the next launch starts from 0
}

// Route `registers`: a row's columns, padded to D, split into D / kVec
// chunks of kVec = 16 / sizeof(T) columns (one 16-byte load); a group of
// kTpr = D / kVec neighbouring lanes shares each row, lane `sub` of the
// group owning chunk `sub`.  A warp reads 32 / kTpr rows a step as one
// contiguous span.
template <typename T, int D, bool kLogistic>
__global__ void __launch_bounds__(kThreads, 3)
grad_registers(const T* __restrict__ x, const T* __restrict__ y,
               const T* __restrict__ w, long long n, int d,
               double* __restrict__ partials,
               unsigned int* __restrict__ ticket, double* __restrict__ out) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kTpr = D / kVec;                   // lanes a row
  constexpr int kRows = 4;                         // rows a step a lane
  constexpr int kMin = kTpr < kRows ? kTpr : kRows;
  constexpr int kPer = kRows > kTpr ? kRows / kTpr : 1;   // residuals a lane
  static_assert(kTpr >= 1 && kTpr <= 32 && D % kVec == 0, "D");
  __shared__ double s_warp[kWarps][D];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int sub = lane % kTpr;
  const int c0 = sub * kVec;                       // first column owned
  const bool vec = (static_cast<long long>(d) * sizeof(T)) % 16 == 0
                   && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const long long slots =
      static_cast<long long>(gridDim.x) * kThreads / kTpr;
  const long long step = kRows * slots;
  // rows i, i + slots, ... of one step into (v, yv): every load before
  // any arithmetic
  auto load = [&](T (&v)[kRows][kVec], T (&yv)[kRows], long long i) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long row = i + r * slots;
      const T* xr = x + row * d + c0;
      if (row < n && c0 < d && vec) {
        if constexpr (sizeof(T) == 4) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(xr));
          v[r][0] = q.x; v[r][1] = q.y; v[r][2] = q.z; v[r][3] = q.w;
        } else {
          const double2 q = __ldg(reinterpret_cast<const double2*>(xr));
          v[r][0] = q.x; v[r][1] = q.y;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          v[r][k] = row < n && c0 + k < d ? __ldg(xr + k) : T(0);
      }
      yv[r] = row < n ? __ldg(y + row) : T(0);
    }
  };
  double wr[kVec], acc[kVec];
  // one step's rows into acc
  auto accumulate = [&](const T (&v)[kRows][kVec], const T (&yv)[kRows],
                        long long i) {
    double z[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      z[r] = 0.0;
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        z[r] += static_cast<double>(v[r][k]) * wr[k];
      // the group's chunks, added in a fixed butterfly: every lane of the
      // group ends with the same bits
#pragma unroll
      for (int off = 1; off < kTpr; off <<= 1)
        z[r] += __shfl_xor_sync(0xffffffffu, z[r], off);
    }
    // each lane of a group computes the residuals of rows
    // sub % kMin + j * kTpr (kPer of them), not all kRows: the group's
    // float64 exp and divide are not repeated kTpr times
    double mine[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      double zs = 0.0, ys = 0.0;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r == sub % kMin + j * kTpr) {
          zs = z[r];
          ys = static_cast<double>(yv[r]);
        }
      mine[j] = (kLogistic ? stable_sigmoid(zs) : zs) - ys;
    }
    const int base = lane - sub;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
#pragma unroll
      for (int s = 0; s < kMin; ++s) {
        const int r = s + j * kTpr;
        const double res = __shfl_sync(0xffffffffu, mine[j], base + s);
        if (r < kRows && i + r * slots < n) {
#pragma unroll
          for (int k = 0; k < kVec; ++k)
            acc[k] += res * static_cast<double>(v[r][k]);
        }
      }
    }
  };
  // the warp's first row: the loop runs warp-uniform, so every shuffle
  // sees all 32 lanes; rows past n are masked.  The first step's loads go
  // out before w's, whose conversion would otherwise hold them back
  const long long warp_first =
      (static_cast<long long>(blockIdx.x) * kThreads + (t & ~31)) / kTpr;
  T v[kRows][kVec];
  T yv[kRows];
  if (warp_first < n) load(v, yv, warp_first + lane / kTpr);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    wr[k] = c0 + k < d ? static_cast<double>(w[c0 + k]) : 0.0;
    acc[k] = 0.0;
  }
  for (long long i0 = warp_first; i0 < n; i0 += step) {
    const long long i = i0 + lane / kTpr;
    accumulate(v, yv, i);
    if (i0 + step < n) load(v, yv, i + step);
  }
  // lanes that own the same chunk add across the warp (a fixed butterfly),
  // then the warps add in warp order
#pragma unroll
  for (int k = 0; k < kVec; ++k)
#pragma unroll
    for (int off = kTpr; off < 32; off <<= 1)
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  if (lane < kTpr) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) s_warp[t >> 5][c0 + k] = acc[k];
  }
  __syncthreads();
  if (t < d) {
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += s_warp[k][t];
    partials[static_cast<long long>(blockIdx.x) * d + t] = s;
  }
  fold_if_last(partials, gridDim.x, d, ticket, out);
}

template <typename T, bool kLogistic>
__global__ void __launch_bounds__(kThreads)
grad_chunked(const T* __restrict__ x, const T* __restrict__ y,
             const T* __restrict__ w, long long n, int d,
             double* __restrict__ partials, unsigned int* __restrict__ ticket,
             double* __restrict__ out) {
  extern __shared__ double smem[];
  const int cpp = d < kThreads ? d : kThreads;     // columns per pass
  const int groups = kThreads / cpp;
  double* s_w = smem;                              // d
  double* s_r = smem + d;                          // kThreads
  double* s_acc = smem + d + kThreads;             // groups * d
  const int t = threadIdx.x;
  for (int j = t; j < d; j += kThreads) s_w[j] = static_cast<double>(w[j]);
  for (int j = t; j < groups * d; j += kThreads) s_acc[j] = 0.0;
  __syncthreads();

  const int g = t / cpp;
  const int c = t % cpp;
  const bool owner = g < groups;
  const long long rows_per_block = (n + gridDim.x - 1) / gridDim.x;
  const long long begin = static_cast<long long>(blockIdx.x) * rows_per_block;
  long long end = begin + rows_per_block;
  if (end > n) end = n;
  for (long long chunk = begin; chunk < end; chunk += kThreads) {
    const long long left = end - chunk;
    const int rows = left < kThreads ? static_cast<int>(left) : kThreads;
    if (t < rows) {
      const T* xr = x + (chunk + t) * static_cast<long long>(d);
      double z = 0.0;
      for (int j = 0; j < d; ++j) z += static_cast<double>(xr[j]) * s_w[j];
      const double yv = static_cast<double>(y[chunk + t]);
      s_r[t] = (kLogistic ? stable_sigmoid(z) : z) - yv;
    }
    __syncthreads();
    if (owner) {
      double* acc = s_acc + g * d;
      for (int i = g; i < rows; i += groups) {
        const double r = s_r[i];
        const T* xr = x + (chunk + i) * static_cast<long long>(d);
        for (int j = c; j < d; j += cpp)
          acc[j] += r * static_cast<double>(xr[j]);
      }
    }
    __syncthreads();
  }
  for (int j = t; j < d; j += kThreads) {
    double s = 0.0;
    for (int k = 0; k < groups; ++k) s += s_acc[k * d + j];
    partials[static_cast<long long>(blockIdx.x) * d + j] = s;
  }
  fold_if_last(partials, gridDim.x, d, ticket, out);
}

// the plan word's fields (kernels/train_grad.py, TrainPlan.word)
struct Plan {
  bool f64, logistic;
  int width_class, blocks;    // width_class 0: chunked; k: D = 2 << k
  explicit Plan(unsigned long long w)
      : f64((w & 1) != 0), logistic((w & 2) != 0),
        width_class(static_cast<int>((w >> 2) & 7)),
        blocks(static_cast<int>((w >> 8) & 4095)) {}
};

template <typename T, bool kLogistic>
const void* registers_kernel(int width_class) {
  switch (width_class) {
    case 1: return reinterpret_cast<const void*>(
        &grad_registers<T, 4, kLogistic>);
    case 2: return reinterpret_cast<const void*>(
        &grad_registers<T, 8, kLogistic>);
    case 3: return reinterpret_cast<const void*>(
        &grad_registers<T, 16, kLogistic>);
    case 4: return reinterpret_cast<const void*>(
        &grad_registers<T, 32, kLogistic>);
    default: return nullptr;
  }
}

template <typename T>
const void* pick_kernel(const Plan& pl) {
  if (pl.width_class == 0)
    return pl.logistic
               ? reinterpret_cast<const void*>(&grad_chunked<T, true>)
               : reinterpret_cast<const void*>(&grad_chunked<T, false>);
  return pl.logistic ? registers_kernel<T, true>(pl.width_class)
                     : registers_kernel<T, false>(pl.width_class);
}

size_t chunked_smem(int d) {
  const int cpp = d < kThreads ? d : kThreads;
  const int groups = kThreads / cpp;
  return (static_cast<size_t>(d) + kThreads
          + static_cast<size_t>(groups) * d) * sizeof(double);
}

}  // namespace

// Unnormalised gradient of x (n, d) against y (n,) at w (d,), one launch.
// `word` (kernels/train_grad.py, TrainPlan.word): bit 0 x is float64 (else
// float32), bit 1 logistic (else linear), bits 2-4 the route (0 chunked;
// 1-4 registers with d padded to 4, 8, 16, 32), bits 8-19 the blocks.
// `buf` holds d + blocks * d doubles: out (d) first, then the blocks'
// partial rows.  `ticket` is a device word that is 0 between launches.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments it rejects.
extern "C" int shark_train_grad(const void* x, const void* y, const void* w,
                                long long n, int d, unsigned long long word,
                                double* buf, unsigned int* ticket,
                                cudaStream_t stream) {
  const Plan pl(word);
  if (pl.blocks < 1 || d < 1 || d > kMaxDims || n < 0 || x == nullptr
      || y == nullptr || w == nullptr || buf == nullptr || ticket == nullptr
      || pl.width_class > 4
      || (pl.width_class > 0 && d > (2 << pl.width_class)))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel =
      pl.f64 ? pick_kernel<double>(pl) : pick_kernel<float>(pl);
  const size_t smem = pl.width_class == 0 ? chunked_smem(d) : 0;
  double* out = buf;
  double* partials = buf + d;
  void* args[] = {const_cast<void**>(&x), const_cast<void**>(&y),
                  const_cast<void**>(&w), &n, &d, &partials, &ticket, &out};
  cudaError_t err = cudaLaunchKernel(kernel, dim3(pl.blocks), dim3(kThreads),
                                     args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
