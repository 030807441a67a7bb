// Dictionary, bit-pack and run-length decode of one encoded column block —
// the Hopper kernels behind kernels/dictdecode.py's dict_decode,
// bitpack_decode and rle_decode.
//
// Replaces: repro/kernels/dictdecode.py:dict_decode (_dict_decode_kernel),
//           repro/kernels/dictdecode.py:bitpack_decode (_bitpack_kernel)
//           and repro/kernels/dictdecode.py:rle_decode (_rle_kernel).
//
// What bounds them on an H100: the bytes moved.  Each is one elementwise
// pass that reads the encoded stream once and writes the decoded column
// once (a DICT block of 156,250 int32 codes into float64 is 1.9 MB, about
// 0.6 us at 3.35 TB/s); none does more than a few integer operations per
// output, so at feature-partition sizes the launch dominates.
//
// Design:
//   * dict_decode: one thread per row (grid-stride), gathering from the
//     dictionary.  When the wrapper asks for it (a dictionary that fits in
//     48 KB and is small beside the rows each block decodes) every block
//     first stages the dictionary in shared memory; otherwise the gather
//     reads it through L1 (__ldg).  Codes outside [0, d) follow jnp
//     indexing, as the reference's oracle does: a negative code counts from
//     the end, then the index clamps to [0, d - 1];
//   * bitpack_decode: one thread per output lane reads its uint32 word
//     (passed as int32 bits), shifts and masks: 32 / w lanes per word, low
//     lane first, as int32 plus an int32 bias — the TPU kernel's semantics;
//   * rle_decode: one thread per position binary-searches the cumulative
//     exclusive run ends for the number of ends <= position (side="right"),
//     clamps it to r - 1 as the TPU kernel does, and gathers the run value.
// No kernel allocates; each launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum DType { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3 };
enum Op { kDict = 0, kBitpack = 1, kRle = 2 };

__device__ __forceinline__ long long clamp_code(long long c, long long d) {
  if (c < 0) c += d;
  if (c < 0) c = 0;
  if (c > d - 1) c = d - 1;
  return c;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dict_decode_kernel(const int32_t* __restrict__ codes,
                   const T* __restrict__ dict, long long d, long long n,
                   int use_smem, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_dict = reinterpret_cast<T*>(smem_raw);
  if (use_smem) {
    for (long long j = threadIdx.x; j < d; j += kThreads) s_dict[j] = dict[j];
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const long long c = clamp_code(__ldg(codes + i), d);
    out[i] = use_smem ? s_dict[c] : __ldg(dict + c);
  }
}

__global__ void __launch_bounds__(kThreads)
bitpack_decode_kernel(const int32_t* __restrict__ words, int width, int bias,
                      long long n, int32_t* __restrict__ out) {
  const int per_word = 32 / width;
  const uint32_t mask = (width == 32) ? 0xffffffffu : ((1u << width) - 1u);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const uint32_t word = static_cast<uint32_t>(__ldg(words + i / per_word));
    const int shift = static_cast<int>(i % per_word) * width;
    out[i] = static_cast<int32_t>((word >> shift) & mask) + bias;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rle_decode_kernel(const int32_t* __restrict__ ends, const T* __restrict__ vals,
                  long long r, long long n, T* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    // number of ends <= i: the first index whose end exceeds i
    long long lo = 0, hi = r;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (static_cast<long long>(__ldg(ends + mid)) <= i) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    out[i] = __ldg(vals + (lo < r - 1 ? lo : r - 1));
  }
}

template <typename T>
int launch_typed(int op, const int32_t* idx, const T* table,
                 long long table_len, int use_smem, T* out, long long n,
                 int num_blocks, cudaStream_t stream) {
  if (op == kDict) {
    const size_t smem = use_smem ? table_len * sizeof(T) : 0;
    dict_decode_kernel<T><<<num_blocks, kThreads, smem, stream>>>(
        idx, table, table_len, n, use_smem, out);
  } else {
    rle_decode_kernel<T><<<num_blocks, kThreads, 0, stream>>>(
        idx, table, table_len, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One decode pass into `out` (n values).
//   op 0 (dict):    idx = int32 codes (n), table = dictionary (table_len)
//                   of dtype table_dt; out has the dictionary's dtype;
//                   use_smem stages the dictionary in shared memory.
//   op 1 (bitpack): idx = packed words as int32 bits; out int32 lanes of
//                   `bit_width` bits plus `bias`.
//   op 2 (rle):     idx = cumulative exclusive run ends (table_len),
//                   table = run values (table_len); out has their dtype.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int shark_decode(int op, const int32_t* idx, const void* table,
                            int table_dt, long long table_len, int bit_width,
                            int bias, int use_smem, void* out, long long n,
                            int num_blocks, cudaStream_t stream) {
  if (num_blocks < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (op == kBitpack) {
    if (bit_width < 1 || bit_width > 32)
      return static_cast<int>(cudaErrorInvalidValue);
    bitpack_decode_kernel<<<num_blocks, kThreads, 0, stream>>>(
        idx, bit_width, bias, n, static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  if ((op != kDict && op != kRle) || table_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (table_dt) {
    case kInt32:
      return launch_typed(op, idx, static_cast<const int32_t*>(table),
                          table_len, use_smem, static_cast<int32_t*>(out), n,
                          num_blocks, stream);
    case kInt64:
      return launch_typed(op, idx, static_cast<const long long*>(table),
                          table_len, use_smem, static_cast<long long*>(out),
                          n, num_blocks, stream);
    case kFloat32:
      return launch_typed(op, idx, static_cast<const float*>(table),
                          table_len, use_smem, static_cast<float*>(out), n,
                          num_blocks, stream);
    case kFloat64:
      return launch_typed(op, idx, static_cast<const double*>(table),
                          table_len, use_smem, static_cast<double*>(out), n,
                          num_blocks, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
