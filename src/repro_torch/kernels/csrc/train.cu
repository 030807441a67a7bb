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
// 1024-row tile become plain float64 arithmetic here.
//
// Design:
//   * each block takes a fixed contiguous range of rows (a function of n
//     only) and walks it in chunks of 256 rows.  w sits in shared memory;
//     thread t computes z = x_t . w for row t of the chunk (columns in
//     order), then r_t, into shared memory;
//   * the threads then split as G = 256 / min(d, 256) groups of min(d, 256)
//     column owners: thread (g, c) adds r_i * x_ij for the chunk's rows
//     i = g, g + G, ... and its columns j = c, c + 256, ... into its own
//     shared-memory slot acc[g][j] (the chunk is still in L1).  No two
//     threads share a slot, so no atomics;
//   * at the end each block folds its G groups in order into one partial
//     row; a second one-block launch folds the partial rows in block order.
//     The result is the same on every run;
//   * rows past n are never read: the ragged edge is masked, and x is not
//     padded in device memory (the TPU wrapper's zero-padded copy was a
//     second pass over x);
//   * the sigmoid is the stable two-branch form: 1 / (1 + e^-z) for z >= 0,
//     e^z / (1 + e^z) below.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum DType { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3 };

__device__ __forceinline__ double stable_sigmoid(double z) {
  if (z >= 0.0) return 1.0 / (1.0 + exp(-z));
  const double e = exp(z);
  return e / (1.0 + e);
}

template <typename T, bool kLogistic>
__global__ void __launch_bounds__(kThreads)
grad_partials(const T* __restrict__ x, const T* __restrict__ y,
              const T* __restrict__ w, long long n, int d,
              long long rows_per_block, double* __restrict__ partials) {
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
        for (int j = c; j < d; j += cpp) acc[j] += r * static_cast<double>(xr[j]);
      }
    }
    __syncthreads();
  }
  for (int j = t; j < d; j += kThreads) {
    double s = 0.0;
    for (int k = 0; k < groups; ++k) s += s_acc[k * d + j];
    partials[static_cast<long long>(blockIdx.x) * d + j] = s;
  }
}

// One block folds the per-block partial rows in block order.
__global__ void __launch_bounds__(kThreads)
grad_finish(const double* __restrict__ partials, int num_blocks, int d,
            double* __restrict__ out) {
  for (int j = threadIdx.x; j < d; j += kThreads) {
    double s = 0.0;
    for (int b = 0; b < num_blocks; ++b)
      s += partials[static_cast<long long>(b) * d + j];
    out[j] = s;
  }
}

template <typename T>
int launch_typed(const T* x, const T* y, const T* w, long long n, int d,
                 int logistic, double* partials, int num_blocks, double* out,
                 cudaStream_t stream) {
  const int cpp = d < kThreads ? d : kThreads;
  const int groups = kThreads / cpp;
  const size_t smem =
      (static_cast<size_t>(d) + kThreads + static_cast<size_t>(groups) * d) *
      sizeof(double);
  const long long rows_per_block = (n + num_blocks - 1) / num_blocks;
  if (logistic) {
    grad_partials<T, true><<<num_blocks, kThreads, smem, stream>>>(
        x, y, w, n, d, rows_per_block, partials);
  } else {
    grad_partials<T, false><<<num_blocks, kThreads, smem, stream>>>(
        x, y, w, n, d, rows_per_block, partials);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grad_finish<<<1, kThreads, 0, stream>>>(partials, num_blocks, d, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Unnormalised gradient of x (n, d) against y (n,) at w (d,), all of dtype
// x_dt (float32 or float64), into out (d,) float64.  logistic != 0 takes
// the sigmoid residual, 0 the linear one.  `partials` holds
// num_blocks * d doubles of scratch.  Returns cudaGetLastError().
extern "C" int shark_train_grad(const void* x, int x_dt, const void* y,
                                const void* w, long long n, int d,
                                int logistic, double* partials,
                                int num_blocks, double* out,
                                cudaStream_t stream) {
  if (num_blocks < 1 || d < 1 || d > 2048 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (x_dt) {
    case kFloat32:
      return launch_typed(static_cast<const float*>(x),
                          static_cast<const float*>(y),
                          static_cast<const float*>(w), n, d, logistic,
                          partials, num_blocks, out, stream);
    case kFloat64:
      return launch_typed(static_cast<const double*>(x),
                          static_cast<const double*>(y),
                          static_cast<const double*>(w), n, d, logistic,
                          partials, num_blocks, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
