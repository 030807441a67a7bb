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
//   * one C entry point for all three, of seven arguments (input stream,
//     table, output, n, table length, a 64-bit plan word, stream): the
//     wrapper's plan (kernels/dictdecode.py, decode_plan) packs the op, the
//     table's dtype, the shared-memory staging flag, the bit width, the
//     grid and the bias into the word, and this side validates what it
//     can (an error code, never a fallback);
//   * dict_decode: each thread decodes 4 rows a step of a grid-stride loop
//     (the grid a function of n only, two steps a thread at phase 3's
//     156,250 rows): one 16-byte load of 4 int32 codes
//     (4 scalar loads when the codes are a view that does not start on 16
//     bytes), 4 gathers, and 16 bytes stored at a time (two 16-byte stores
//     of float64 or int64); the last n % 4 rows one a thread.  When the
//     plan says so (a dictionary that fits in 48 KB and is small beside the
//     rows each block decodes) every block first stages the dictionary in
//     shared memory; otherwise the gather reads it through the read-only
//     path (__ldg).  Codes outside [0, d) follow jnp indexing, as the
//     reference's oracle does: a negative code counts from the end, then
//     the index clamps to [0, d - 1];
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

__device__ __forceinline__ void store4(int32_t* p, int32_t a, int32_t b,
                                       int32_t c, int32_t d) {
  *reinterpret_cast<int4*>(p) = make_int4(a, b, c, d);
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(long long* p, long long a,
                                       long long b, long long c,
                                       long long d) {
  reinterpret_cast<longlong2*>(p)[0] = make_longlong2(a, b);
  reinterpret_cast<longlong2*>(p)[1] = make_longlong2(c, d);
}
__device__ __forceinline__ void store4(double* p, double a, double b,
                                       double c, double d) {
  reinterpret_cast<double2*>(p)[0] = make_double2(a, b);
  reinterpret_cast<double2*>(p)[1] = make_double2(c, d);
}

template <typename T, bool kStaged>
__device__ __forceinline__ T lookup(const T* table, int32_t c, long long d) {
  const long long i = clamp_code(c, d);
  return kStaged ? table[i] : __ldg(table + i);
}

// out (16-byte aligned, the wrapper's allocation) = dict[codes]
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
dict_decode_kernel(const int32_t* __restrict__ codes,
                   const T* __restrict__ dict, long long d, long long n,
                   T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* table = dict;
  if (kStaged) {
    T* s_dict = reinterpret_cast<T*>(smem_raw);
    for (long long j = threadIdx.x; j < d; j += kThreads)
      s_dict[j] = __ldg(dict + j);
    __syncthreads();
    table = s_dict;
  }
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long quads = n >> 2;
  const bool vec = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  for (long long k = first; k < quads; k += stride) {
    int4 c;
    if (vec) {
      c = __ldg(reinterpret_cast<const int4*>(codes) + k);
    } else {
      const int32_t* cp = codes + 4 * k;
      c = make_int4(__ldg(cp), __ldg(cp + 1), __ldg(cp + 2), __ldg(cp + 3));
    }
    store4(out + 4 * k, lookup<T, kStaged>(table, c.x, d),
           lookup<T, kStaged>(table, c.y, d),
           lookup<T, kStaged>(table, c.z, d),
           lookup<T, kStaged>(table, c.w, d));
  }
  if (first < (n & 3)) {
    const long long i = 4 * quads + first;
    out[i] = lookup<T, kStaged>(table, __ldg(codes + i), d);
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

// the plan word's fields (kernels/dictdecode.py, DecodePlan.word)
struct Plan {
  int op, dtype, staged, width, blocks, bias;
  explicit Plan(unsigned long long w)
      : op(static_cast<int>(w & 3)), dtype(static_cast<int>((w >> 2) & 3)),
        staged(static_cast<int>((w >> 4) & 1)),
        width(static_cast<int>((w >> 5) & 63)),
        blocks(static_cast<int>((w >> 11) & 4095)),
        bias(static_cast<int32_t>(static_cast<uint32_t>(w >> 32))) {}
};

constexpr long long kStageBytes = 48 * 1024;   // static shared memory

template <typename T>
int launch_typed(const Plan& pl, const int32_t* idx, const T* table,
                 long long table_len, T* out, long long n,
                 cudaStream_t stream) {
  if (pl.op == kDict) {
    if ((reinterpret_cast<uintptr_t>(out) & 15) != 0
        || (pl.staged && table_len * static_cast<long long>(sizeof(T))
                             > kStageBytes))
      return static_cast<int>(cudaErrorInvalidValue);
    if (pl.staged)
      dict_decode_kernel<T, true><<<pl.blocks, kThreads,
                                    table_len * sizeof(T), stream>>>(
          idx, table, table_len, n, out);
    else
      dict_decode_kernel<T, false><<<pl.blocks, kThreads, 0, stream>>>(
          idx, table, table_len, n, out);
  } else {
    rle_decode_kernel<T><<<pl.blocks, kThreads, 0, stream>>>(
        idx, table, table_len, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The entry point: one decode pass into `out` (n values), on `stream`.
//   dict (op 0):    idx = int32 codes (n), table = dictionary (table_len)
//                   of the word's dtype; out has the dictionary's dtype
//                   and is 16-byte aligned.
//   bitpack (op 1): idx = packed words as int32 bits (table_len words);
//                   out int32 lanes of the word's bit width plus its bias.
//   rle (op 2):     idx = cumulative exclusive run ends (table_len),
//                   table = run values (table_len); out has their dtype.
// `word`: bits 0-1 op, 2-3 dtype (int32, int64, float32, float64), 4 stage
// the dictionary in shared memory, 5-10 bit width, 11-22 blocks, 32-63
// bias.  Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments it rejects.
extern "C" int shark_decode(const int32_t* idx, const void* table,
                            void* out, long long n, long long table_len,
                            unsigned long long word, cudaStream_t stream) {
  const Plan pl(word);
  if (pl.blocks < 1 || n < 0 || idx == nullptr || out == nullptr
      || (reinterpret_cast<uintptr_t>(idx) & 3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  if (pl.op == kBitpack) {
    if (pl.width < 1 || pl.width > 32
        || n > table_len * static_cast<long long>(32 / pl.width))
      return static_cast<int>(cudaErrorInvalidValue);
    bitpack_decode_kernel<<<pl.blocks, kThreads, 0, stream>>>(
        idx, pl.width, pl.bias, n, static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  if ((pl.op != kDict && pl.op != kRle) || table_len < 1 || table == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (pl.dtype) {
    case kInt32:
      return launch_typed(pl, idx, static_cast<const int32_t*>(table),
                          table_len, static_cast<int32_t*>(out), n, stream);
    case kInt64:
      return launch_typed(pl, idx, static_cast<const long long*>(table),
                          table_len, static_cast<long long*>(out), n,
                          stream);
    case kFloat32:
      return launch_typed(pl, idx, static_cast<const float*>(table),
                          table_len, static_cast<float*>(out), n, stream);
    default:
      return launch_typed(pl, idx, static_cast<const double*>(table),
                          table_len, static_cast<double*>(out), n, stream);
  }
}
