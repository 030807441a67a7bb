// Map-side shuffle bucketing (radix partition) — the Hopper kernel behind
// kernels/radix_partition.py.
//
// Replaces: repro/kernels/radix_partition.py:radix_partition, both the
//           ids-only variant (_radix_ids_kernel) and the variant with the
//           bucket histogram (_radix_kernel).
//
// What bounds it on an H100: bytes — 4 read and 4 written a row, plus a
// handful of integer operations.  The TPU kernel histogrammed with a
// one-hot matmul on the MXU; here the histogram is shared-memory int32
// counters, flushed to the output with one integer atomic per bucket and
// block, so counts are exact at any size and the same on every run.
//
// Bucket ids are bit-identical to radix_partition_ref: the 32-bit golden
// ratio mix in uint32 arithmetic (wrap-around multiply, logical shifts),
// then `% B`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix_u32(uint32_t h) {
  h = h * 2654435761u;
  h ^= h >> 15;
  h = h * 0x85EBCA6Bu;
  h ^= h >> 13;
  return h;
}

template <bool kCounts>
__global__ void __launch_bounds__(kThreads)
radix_kernel(const uint32_t* __restrict__ keys, long long n, uint32_t B,
             int32_t* __restrict__ ids, int32_t* __restrict__ counts) {
  extern __shared__ int32_t s_hist[];
  if (kCounts) {
    for (uint32_t b = threadIdx.x; b < B; b += kThreads) s_hist[b] = 0;
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const uint32_t b = mix_u32(__ldg(keys + i)) % B;
    ids[i] = static_cast<int32_t>(b);
    if (kCounts) atomicAdd(s_hist + b, 1);
  }
  if (kCounts) {
    __syncthreads();
    for (uint32_t b = threadIdx.x; b < B; b += kThreads) {
      const int32_t c = s_hist[b];
      if (c) atomicAdd(counts + b, c);
    }
  }
}

}  // namespace

// ids[i] = mix_u32(keys[i]) % num_buckets; when counts != NULL it must hold
// num_buckets zeroed int32s and receives the per-bucket histogram.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int shark_radix(const uint32_t* keys, long long n,
                           unsigned int num_buckets, int32_t* ids,
                           int32_t* counts, int num_blocks,
                           cudaStream_t stream) {
  if (num_blocks < 1 || num_buckets < 1 || num_buckets > 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  if (counts != nullptr) {
    radix_kernel<true><<<num_blocks, kThreads,
                         num_buckets * sizeof(int32_t), stream>>>(
        keys, n, num_buckets, ids, counts);
  } else {
    radix_kernel<false><<<num_blocks, kThreads, 0, stream>>>(
        keys, n, num_buckets, ids, counts);
  }
  return static_cast<int>(cudaGetLastError());
}
