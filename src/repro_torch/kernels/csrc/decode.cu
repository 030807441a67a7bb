// Dictionary, bit-pack and run-length decode of encoded column blocks —
// the Hopper kernels behind kernels/dictdecode.py's dict_decode,
// bitpack_decode_into (and its one-column case bitpack_decode) and
// rle_decode.
//
// Replaces: repro/kernels/dictdecode.py:dict_decode (_dict_decode_kernel),
//           repro/kernels/dictdecode.py:bitpack_decode (_bitpack_kernel)
//           and repro/kernels/dictdecode.py:rle_decode (_rle_kernel).
//
// What bounds them on an H100: the bytes moved.  Each is one elementwise
// pass that reads the encoded stream once and writes the decoded column
// once (a DICT block of 156,250 int32 codes into float64 is 1.9 MB, about
// 0.6 us at 3.35 TB/s); none does more than a few integer operations per
// output, so at feature-partition sizes the launch dominates — and the
// count of launches, which is why bit-pack decodes a partition's blocks in
// one.
//
// Design:
//   * dict and RLE share one C entry point of seven arguments (input
//     stream, table, output, n, table length, a 64-bit plan word, stream):
//     the wrapper's plan (kernels/dictdecode.py, decode_plan) packs the op,
//     the table's dtype, the shared-memory staging flag and the grid into
//     the word, and this side validates what it can (an error code, never
//     a fallback);
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
//   * bit-pack: one launch decodes up to 32 blocks of n rows each, every
//     block described by 32 bytes passed by value in the kernel's
//     parameters (a __grid_constant__ struct: no host-to-device copy, no
//     synchronisation): its words (uint32 as int32 bits, 32 / w lanes a
//     word, low lane first), bit width w in 1..16, an int64 bias, the
//     block's original integer dtype, and a destination pointer with an
//     element stride — a column of the train step's row-major x, its y,
//     or a dense vector.  Each value is (lane + bias) in int64, cast to
//     the original dtype, then to the output type (float32, float64,
//     int32 or int64): the conversions of decode_torch(enc).to(dt).  A
//     block takes tiles of 128 rows of every column, a row's columns by
//     consecutive threads, so the 8 neighbouring BITPACK columns of a
//     phase-3 row fill one or two 32-byte sectors (a thread a packed word
//     writing its lanes down one column touched a sector a value, and
//     took 0.032 ms of device time at phase 3's partition, H100).  The
//     columns' constants are staged in shared memory once a block: read
//     from the parameters by a column that differs across a warp, the
//     constant bank serves one address at a time (0.025 ms, H100);
//   * rle_decode (and rle_decode_into, a strided destination of another
//     dtype): position i takes run min(#{ends <= i}, r - 1), as the TPU
//     kernel clamps.  A block decodes tiles of kRleTile consecutive
//     positions.  For a tile it bounds the runs of its first and last
//     position together, all threads at once: 256 samples of the ends
//     split the interval left into 256 pieces, a __syncthreads_count
//     picks the piece, until the ends between the two bounds fit in the
//     stage (one dependent load at phase 3's 19,532 runs, where a search
//     per position took about 15).  It stages those runs' ends and values
//     in shared memory, and each thread finds the run of its 4
//     consecutive positions there (for the first, a search that starts
//     where evenly spread runs would put it: two loads at phase 3's runs
//     of 8; a walk for the rest) and stores them 16 bytes at a time into
//     a contiguous, aligned destination, one at a time otherwise.  A tile
//     spans at most kRleTile runs of positive length, so only zero-length
//     runs can outgrow the stage; such a tile searches the device-memory
//     ends between its two bounds for every position instead.  The value
//     is cast to the block's original dtype (an integer one; floats are
//     exact in the values' dtype), then to the destination's, the
//     conversions of decode_torch(enc).to(dt).  RLE keeps shark_decode's
//     seven-argument entry: the destination's dtype, stride and the
//     original dtype ride in the plan word's high bits.
// No kernel allocates; each launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

enum DType { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3 };
enum Op { kDict = 0, kBitpack = 1, kRle = 2 };   // kBitpack: shark_bitpack

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

// one bit-packed block of a batched decode (kernels/dictdecode.py,
// pack_bitpack_descriptors: four int64 words, little-endian)
struct BitpackDesc {
  const uint32_t* words;
  void* dst;                  // element (row 0), of the launch's out type
  long long bias;
  int stride;                 // elements between rows of dst
  unsigned char width;        // 1..16
  unsigned char odt;          // enum OrigType
  unsigned short pad;
};
static_assert(sizeof(BitpackDesc) == 32, "descriptor is 32 bytes");

constexpr int kMaxBitpackCols = 32;
struct BitpackBatch {
  BitpackDesc col[kMaxBitpackCols];
};

// the original integer dtype of a block
enum OrigType { kI8 = 0, kU8, kI16, kU16, kI32, kU32, kI64, kU64 };

// v cast to the block's original dtype, then to the output type
template <typename O>
__device__ __forceinline__ O orig_cast(long long v, int odt) {
  switch (odt) {
    case kI8: return static_cast<O>(static_cast<int8_t>(v));
    case kU8: return static_cast<O>(static_cast<uint8_t>(v));
    case kI16: return static_cast<O>(static_cast<int16_t>(v));
    case kU16: return static_cast<O>(static_cast<uint16_t>(v));
    case kI32: return static_cast<O>(static_cast<int32_t>(v));
    case kU32: return static_cast<O>(static_cast<uint32_t>(v));
    case kU64: return static_cast<O>(static_cast<unsigned long long>(v));
    default: return static_cast<O>(v);
  }
}

constexpr int kTileRows = 128;

// A column's constants, staged in shared memory once a block: the loop
// indexes them by a column that differs across a warp, which shared
// memory serves at once and the parameter (constant) bank one address at
// a time.
struct ColConst {
  const uint32_t* words;
  void* dst;
  long long bias;
  int stride, odt;
  unsigned width, per_word;
};

__device__ __forceinline__ ColConst col_const(const BitpackDesc& dc) {
  return {dc.words, dc.dst, dc.bias, dc.stride, dc.odt, dc.width,
          32u / dc.width};
}

// A block takes tiles of kTileRows rows of every column; consecutive
// threads take a row's columns in turn, so neighbouring columns of a
// row-major x land in the same 32-byte sectors, and a word, read through
// L1, serves the rows it packs.
template <typename O>
__global__ void __launch_bounds__(kThreads)
bitpack_batch_kernel(const __grid_constant__ BitpackBatch batch, int count,
                     int n) {
  __shared__ ColConst s_col[kMaxBitpackCols];
  if (threadIdx.x < count) s_col[threadIdx.x] = col_const(
      batch.col[threadIdx.x]);
  __syncthreads();
  for (int r0 = blockIdx.x * kTileRows; r0 < n;
       r0 += gridDim.x * kTileRows) {
    const int rows = n - r0 < kTileRows ? n - r0 : kTileRows;
#pragma unroll 4
    for (int e = threadIdx.x; e < count * rows; e += kThreads) {
      const int r = e / count, c = e % count;
      const ColConst& cc = s_col[c];
      const unsigned row = static_cast<unsigned>(r0 + r);
      const unsigned q = row / cc.per_word;
      const uint32_t word = __ldg(cc.words + q);
      const uint32_t lane = (word >> ((row - q * cc.per_word) * cc.width))
                            & ((1u << cc.width) - 1u);
      static_cast<O*>(cc.dst)[static_cast<long long>(row) * cc.stride] =
          orig_cast<O>(static_cast<long long>(lane) + cc.bias, cc.odt);
    }
  }
}

constexpr int kRleTile = 1024;      // positions a block decodes at once
constexpr int kRleStage = kRleTile;  // runs it stages

// Bounds on #{i : ends[i] <= p} for p = p0 and p = p1 (non-decreasing
// ends), by the whole block: each step samples the last end of 256 equal
// pieces of the interval left, and __syncthreads_count of "sample <= p"
// names the piece holding the answer.  It stops once the ends from the
// first interval's start to the second's end fit in the stage (one step
// at phase 3's 19,532 runs; none for up to kRleStage runs), or when both
// answers are exact.  Every thread returns lo0 <= count(p0) and
// hi1 >= count(p1).
__device__ __forceinline__ void bound_ends(const int32_t* __restrict__ ends,
                                           long long r, long long p0,
                                           long long p1, long long* lo,
                                           long long* hi) {
  const int t = threadIdx.x;
  long long lo0 = 0, hi0 = r, lo1 = 0, hi1 = r;   // answers in [lo, hi]
  while (hi1 - lo0 >= kRleStage && (hi0 > lo0 || hi1 > lo1)) {
    const long long st0 = (hi0 - lo0 + kThreads - 1) / kThreads;
    const long long st1 = (hi1 - lo1 + kThreads - 1) / kThreads;
    const long long s0 = st0 > 0 ? st0 : 1, s1 = st1 > 0 ? st1 : 1;
    const long long i0 = lo0 + (t + 1) * s0 - 1, i1 = lo1 + (t + 1) * s1 - 1;
    const bool f0 = i0 < hi0 && __ldg(ends + i0) <= p0;
    const bool f1 = i1 < hi1 && __ldg(ends + i1) <= p1;
    const long long n0 = __syncthreads_count(f0);
    const long long n1 = __syncthreads_count(f1);
    const long long h0 = lo0 + (n0 + 1) * s0 - 1;
    const long long h1 = lo1 + (n1 + 1) * s1 - 1;
    hi0 = h0 < hi0 ? h0 : hi0;
    hi1 = h1 < hi1 ? h1 : hi1;
    lo0 += n0 * s0;
    lo1 += n1 * s1;
  }
  *lo = lo0;
  *hi = hi1;
}

// a run value, cast to the block's original dtype, then to the output's
template <typename V, typename O>
__device__ __forceinline__ O rle_cast(V v, int odt) {
  if constexpr (std::is_integral<V>::value) {
    return orig_cast<O>(static_cast<long long>(v), odt);
  } else {
    return static_cast<O>(v);
  }
}

template <typename V, typename O>
__global__ void __launch_bounds__(kThreads)
rle_decode_kernel(const int32_t* __restrict__ ends, const V* __restrict__ vals,
                  long long r, long long n, O* __restrict__ out,
                  long long stride, int odt) {
  __shared__ int32_t s_end[kRleStage];
  __shared__ V s_val[kRleStage];
  const int t = threadIdx.x;
  const bool vec = stride == 1 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const long long tiles = (n + kRleTile - 1) / kRleTile;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = tile * kRleTile;
    const long long pn = n - p0 < kRleTile ? n - p0 : kRleTile;
    // runs a0 .. a1 hold the tile's positions: position p takes run
    // min(a0 + #{ends[a0 .. a1] <= p}, r - 1)
    long long a0, a1;
    bound_ends(ends, r, p0, p0 + pn - 1, &a0, &a1);   // (barriers inside)
    a0 = a0 < r - 1 ? a0 : r - 1;
    a1 = a1 < r - 1 ? a1 : r - 1;
    const int count = static_cast<int>(a1 - a0 + 1 < kRleStage + 1
                                       ? a1 - a0 + 1 : kRleStage + 1);
    const bool staged = count <= kRleStage;
    if (staged) {
      for (int i = t; i < count; i += kThreads) {
        s_end[i] = __ldg(ends + a0 + i);
        s_val[i] = __ldg(vals + a0 + i);
      }
    }
    __syncthreads();
    const int last = static_cast<int>(r - 1 - a0);   // the clamp, locally
    for (int g = t; 4 * g < pn; g += kThreads) {
      const long long p = p0 + 4 * g;
      // runs of the group's positions, relative to a0
      int idx[4];
      if (staged) {
        // #{staged ends <= p}: from the place runs spread evenly over the
        // tile would give, galloping out, then a binary search between
        int lo, hi;
        const int guess = static_cast<int>((p - p0) * count / pn);
        if (s_end[guess] <= p) {
          lo = guess + 1;
          hi = count;
          for (int q = lo, step = 1; q < count; q += step, step <<= 1) {
            if (s_end[q] > p) {
              hi = q;
              break;
            }
            lo = q + 1;
          }
        } else {
          lo = 0;
          hi = guess;
          for (int q = guess - 1, step = 1; q >= 0; q -= step, step <<= 1) {
            if (s_end[q] <= p) {
              lo = q + 1;
              break;
            }
            hi = q;
          }
        }
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_end[mid] <= p) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        idx[0] = lo;
#pragma unroll
        for (int u = 1; u < 4; ++u) {
          while (lo < count && s_end[lo] <= p + u) ++lo;
          idx[u] = lo;
        }
      } else {
        const long long span = a1 - a0 + 1;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          long long lo = 0, hi = span;
          while (lo < hi) {
            const long long mid = (lo + hi) >> 1;
            if (static_cast<long long>(__ldg(ends + a0 + mid)) <= p + u) {
              lo = mid + 1;
            } else {
              hi = mid;
            }
          }
          idx[u] = static_cast<int>(lo < last ? lo : last);
        }
      }
      O o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = idx[u] < last ? idx[u] : last;
        o[u] = rle_cast<V, O>(staged ? s_val[k] : __ldg(vals + a0 + k), odt);
      }
      if (vec && p + 4 <= n) {
        store4(out + p, o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (p + u < n) out[(p + u) * stride] = o[u];
      }
    }
    __syncthreads();          // the stage is read before the next tile's
  }
}

// the plan word's fields (kernels/dictdecode.py, DecodePlan.word and, for
// RLE, rle_word)
struct Plan {
  int op, dtype, staged, blocks, out_dtype, odt;
  long long stride;
  explicit Plan(unsigned long long w)
      : op(static_cast<int>(w & 3)), dtype(static_cast<int>((w >> 2) & 3)),
        staged(static_cast<int>((w >> 4) & 1)),
        blocks(static_cast<int>((w >> 11) & 4095)),
        out_dtype(static_cast<int>((w >> 23) & 3)),
        odt(static_cast<int>((w >> 25) & 7)),
        stride(static_cast<long long>((w >> 32) & 0x7fffffffULL)) {}
};

constexpr long long kStageBytes = 48 * 1024;   // static shared memory

template <typename T>
int launch_dict(const Plan& pl, const int32_t* idx, const T* table,
                long long table_len, T* out, long long n,
                cudaStream_t stream) {
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
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename O>
int launch_rle(const Plan& pl, const int32_t* ends, const void* vals,
               long long r, void* out, long long n, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(vals) & (sizeof(V) - 1)) != 0
      || (reinterpret_cast<uintptr_t>(out) & (sizeof(O) - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  rle_decode_kernel<V, O><<<pl.blocks, kThreads, 0, stream>>>(
      ends, static_cast<const V*>(vals), r, n, static_cast<O*>(out),
      pl.stride, pl.odt);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch_rle_to(const Plan& pl, const int32_t* ends, const void* vals,
                  long long r, void* out, long long n, cudaStream_t stream) {
  switch (pl.out_dtype) {
    case kInt32:
      return launch_rle<V, int32_t>(pl, ends, vals, r, out, n, stream);
    case kInt64:
      return launch_rle<V, long long>(pl, ends, vals, r, out, n, stream);
    case kFloat32:
      return launch_rle<V, float>(pl, ends, vals, r, out, n, stream);
    default:
      return launch_rle<V, double>(pl, ends, vals, r, out, n, stream);
  }
}

}  // namespace

// Dict and RLE decode: one pass into `out` (n values), on `stream`.
//   dict (op 0):    idx = int32 codes (n), table = dictionary (table_len)
//                   of the word's dtype; out has the dictionary's dtype
//                   and is 16-byte aligned.
//   rle (op 2):     idx = cumulative exclusive run ends (table_len, non-
//                   decreasing), table = run values (table_len); out has
//                   the word's out dtype and element stride.
// `word`: bits 0-1 op, 2-3 dtype (int32, int64, float32, float64) of the
// table, 4 stage the dictionary in shared memory, 11-22 blocks; RLE also
// 23-24 the out dtype, 25-27 the values' original integer dtype (enum
// OrigType; kI64 keeps the value) and 32-62 the out stride (>= 1).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments it rejects.
extern "C" int shark_decode(const int32_t* idx, const void* table,
                            void* out, long long n, long long table_len,
                            unsigned long long word, cudaStream_t stream) {
  const Plan pl(word);
  if (pl.blocks < 1 || n < 0 || idx == nullptr || out == nullptr
      || (reinterpret_cast<uintptr_t>(idx) & 3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  if ((pl.op != kDict && pl.op != kRle) || table_len < 1 || table == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pl.op == kRle) {
    if (pl.stride < 1) return static_cast<int>(cudaErrorInvalidValue);
    switch (pl.dtype) {
      case kInt32:
        return launch_rle_to<int32_t>(pl, idx, table, table_len, out, n,
                                      stream);
      case kInt64:
        return launch_rle_to<long long>(pl, idx, table, table_len, out, n,
                                        stream);
      case kFloat32:
        return launch_rle_to<float>(pl, idx, table, table_len, out, n,
                                    stream);
      default:
        return launch_rle_to<double>(pl, idx, table, table_len, out, n,
                                     stream);
    }
  }
  switch (pl.dtype) {
    case kInt32:
      return launch_dict(pl, idx, static_cast<const int32_t*>(table),
                         table_len, static_cast<int32_t*>(out), n, stream);
    case kInt64:
      return launch_dict(pl, idx, static_cast<const long long*>(table),
                         table_len, static_cast<long long*>(out), n,
                         stream);
    case kFloat32:
      return launch_dict(pl, idx, static_cast<const float*>(table),
                         table_len, static_cast<float*>(out), n, stream);
    default:
      return launch_dict(pl, idx, static_cast<const double*>(table),
                         table_len, static_cast<double*>(out), n, stream);
  }
}

// Bit-pack decode of `count` blocks (1..32) of n < 2^31 rows each, one
// launch: `descs` points to `count` host-side BitpackDesc (copied into the
// kernel's parameters at the launch).  `word`: bits 2-3 the out type
// (int32, int64, float32, float64), 11-22 the blocks (each walks 128-row
// tiles).  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a descriptor it rejects (a width
// outside 1..16, a null or misaligned pointer, a stride below 1, an
// unknown dtype).
extern "C" int shark_bitpack(const void* descs, int count, long long n,
                             unsigned long long word, cudaStream_t stream) {
  const Plan pl(word);
  if (descs == nullptr || count < 1 || count > kMaxBitpackCols || n < 0
      || n >= (1ll << 31) || pl.blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static const size_t kOutSize[4] = {4, 8, 4, 8};
  const size_t osize = kOutSize[pl.dtype];
  BitpackBatch batch = {};
  const BitpackDesc* src = static_cast<const BitpackDesc*>(descs);
  for (int c = 0; c < count; ++c) {
    const BitpackDesc& dsc = src[c];
    if (dsc.width < 1 || dsc.width > 16 || dsc.odt > kU64 || dsc.stride < 1
        || dsc.words == nullptr || dsc.dst == nullptr
        || (reinterpret_cast<uintptr_t>(dsc.words) & 3) != 0
        || (reinterpret_cast<uintptr_t>(dsc.dst) & (osize - 1)) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    batch.col[c] = dsc;
  }
  if (n == 0) return 0;
  const int rows = static_cast<int>(n);
  switch (pl.dtype) {
    case kInt32:
      bitpack_batch_kernel<int32_t><<<pl.blocks, kThreads, 0, stream>>>(
          batch, count, rows);
      break;
    case kInt64:
      bitpack_batch_kernel<long long><<<pl.blocks, kThreads, 0, stream>>>(
          batch, count, rows);
      break;
    case kFloat32:
      bitpack_batch_kernel<float><<<pl.blocks, kThreads, 0, stream>>>(
          batch, count, rows);
      break;
    default:
      bitpack_batch_kernel<double><<<pl.blocks, kThreads, 0, stream>>>(
          batch, count, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
