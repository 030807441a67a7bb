// Top-k dot-product similarity search — the Hopper kernel behind
// kernels/topk_similarity.py.
//
// Replaces: repro/kernels/topk_similarity.py:topk_similarity (_topk_kernel).
//
// Returns the m = min(k, n) rows of x (n, d) with the highest score
// s_i = x_i . q, as float64 scores and int64 row ids, ordered by score
// descending, then row ascending: np.argsort(-s, kind="stable")[:k].  NaN
// scores rank below every number (numpy's argsort puts them last), and
// -0.0 ties with +0.0.
//
// What bounds it on an H100: one read of x (a 15,625 x 64 float32
// partition is 4 MB, 1.2 us at 3.35 TB/s); the selection touches only
// tile-sized lists.
//
// The TPU kernel carries a running top-k across its sequential grid in one
// output block.  Hopper blocks run in no order, so nothing carries between
// them.  Instead:
//   1. each block scores a tile of 256 rows, one row per thread, with q in
//      shared memory and the dot product in float64 in lane order, each
//      product and sum rounded on its own (__dmul_rn / __dadd_rn), so the
//      plain version's lane-by-lane sum gives the same bits.  It ranks its
//      tile by the TPU kernel's own rule, rank_i = #{j : s_j beats s_i},
//      where "beats" is a higher score or an equal score at a lower row,
//      and writes its best min(k, rows in tile) in order;
//   2. rounds of pairwise merges, one launch each: an element's position in
//      the merged list is its index in its own list plus the number of
//      elements of the other list that beat it, found by binary search.
//      (score, row) pairs are distinct, so positions form a permutation;
//      positions >= k are dropped.  The rounds repeat until one list is
//      left, ceil(log2(tiles)) of them.
// Every list but the last of a round has the same length, so a round's
// layout is three integers, computed on the host; nothing is data
// dependent, and the answer is the same on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;
constexpr int kThreads = 256;

enum DType { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3 };

// Order key of a score: larger key = better.  NaN gets 0, below every
// number; -0.0 is folded onto +0.0 first.
__device__ __forceinline__ unsigned long long score_key(double s) {
  if (s != s) return 0ULL;
  const unsigned long long b =
      static_cast<unsigned long long>(__double_as_longlong(s + 0.0));
  return (b & 0x8000000000000000ULL) ? ~b : (b | 0x8000000000000000ULL);
}

// Does (ka, ra) come before (kb, rb)?
__device__ __forceinline__ bool beats(unsigned long long ka, long long ra,
                                      unsigned long long kb, long long rb) {
  return ka > kb || (ka == kb && ra < rb);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_tiles(const T* __restrict__ x, const double* __restrict__ q, long long n,
           int d, int k, int stride, double* __restrict__ out_s,
           long long* __restrict__ out_r) {
  extern __shared__ double s_q[];                  // d
  __shared__ unsigned long long s_key[kTile];
  const int t = threadIdx.x;
  for (int j = t; j < d; j += kThreads) s_q[j] = q[j];
  __syncthreads();
  const long long first = static_cast<long long>(blockIdx.x) * kTile;
  const long long left = n - first;
  const int rows = left < kTile ? static_cast<int>(left) : kTile;
  double s = 0.0;
  if (t < rows) {
    const T* xr = x + (first + t) * static_cast<long long>(d);
    for (int j = 0; j < d; ++j)
      s = __dadd_rn(s, __dmul_rn(static_cast<double>(xr[j]), s_q[j]));
  }
  const unsigned long long key = score_key(s);
  s_key[t] = key;
  __syncthreads();
  if (t >= rows) return;
  int rank = 0;
  for (int j = 0; j < rows; ++j) {
    const unsigned long long kj = s_key[j];
    rank += (kj > key || (kj == key && j < t)) ? 1 : 0;
  }
  if (rank < k) {
    const long long at = static_cast<long long>(blockIdx.x) * stride + rank;
    out_s[at] = s;
    out_r[at] = first + t;
  }
}

// Number of the first `len` entries of a sorted list that beat (key, row).
__device__ __forceinline__ int count_beating(const double* s,
                                             const long long* r, int len,
                                             unsigned long long key,
                                             long long row) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (beats(score_key(s[mid]), r[mid], key, row)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One merge round: lists 2p and 2p+1 of `count` lists (stride `len`, each
// `len` long but the last, `last_len`) merge into list p of the output
// (stride out_stride), keeping the first min(k, lenA + lenB).
__global__ void __launch_bounds__(kThreads)
topk_merge(const double* __restrict__ in_s, const long long* __restrict__ in_r,
           int count, int len, int last_len, int k, int out_stride,
           double* __restrict__ out_s, long long* __restrict__ out_r) {
  const int p = blockIdx.x;
  const int a = 2 * p, b = 2 * p + 1;
  const int len_a = (a == count - 1) ? last_len : len;
  const int len_b = (b < count) ? ((b == count - 1) ? last_len : len) : 0;
  const int total = len_a + len_b;
  const int m = total < k ? total : k;
  const double* a_s = in_s + static_cast<long long>(a) * len;
  const long long* a_r = in_r + static_cast<long long>(a) * len;
  const double* b_s = in_s + static_cast<long long>(b) * len;
  const long long* b_r = in_r + static_cast<long long>(b) * len;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  double s;
  long long r;
  int pos;
  if (e < len) {
    if (e >= len_a) return;
    s = a_s[e];
    r = a_r[e];
    pos = e + count_beating(b_s, b_r, len_b, score_key(s), r);
  } else {
    const int j = e - len;
    if (j >= len_b) return;
    s = b_s[j];
    r = b_r[j];
    pos = j + count_beating(a_s, a_r, len_a, score_key(s), r);
  }
  if (pos < m) {
    const long long at = static_cast<long long>(p) * out_stride + pos;
    out_s[at] = s;
    out_r[at] = r;
  }
}

template <typename T>
int launch_tiles(const T* x, const double* q, long long n, int d, int k,
                 int stride, int tiles, double* s, long long* r,
                 cudaStream_t stream) {
  topk_tiles<T><<<tiles, kThreads, d * sizeof(double), stream>>>(
      x, q, n, d, k, stride, s, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Top min(k, n) rows of x (n, d; x_dt float32 or float64) by x . q (q: d
// float64) into out_s (float64) / out_r (int64).  buf_* are two scratch
// buffers of tiles * min(k, 256) entries each, tiles = ceil(n / 256).
// Returns cudaGetLastError() after the last launch (0 on success).
extern "C" int shark_topk(const void* x, int x_dt, const double* q,
                          long long n, int d, int k, double* buf0_s,
                          long long* buf0_r, double* buf1_s,
                          long long* buf1_r, double* out_s, long long* out_r,
                          cudaStream_t stream) {
  if (n < 1 || d < 1 || d > 4096 || k < 1 || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_ll = (n + kTile - 1) / kTile;
  const int tiles = static_cast<int>(tiles_ll);
  int len = k < kTile ? k : kTile;
  const long long last_rows = n - (tiles_ll - 1) * kTile;
  int last_len = static_cast<int>(last_rows < len ? last_rows : len);
  double* cur_s = (tiles == 1) ? out_s : buf0_s;
  long long* cur_r = (tiles == 1) ? out_r : buf0_r;
  int rc;
  switch (x_dt) {
    case kFloat32:
      rc = launch_tiles(static_cast<const float*>(x), q, n, d, k, len, tiles,
                        cur_s, cur_r, stream);
      break;
    case kFloat64:
      rc = launch_tiles(static_cast<const double*>(x), q, n, d, k, len,
                        tiles, cur_s, cur_r, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  int count = tiles;
  while (count > 1) {
    const int pairs = (count + 1) / 2;
    const int out_stride = (2LL * len < k) ? 2 * len : k;
    // the last output list merges the last one or two input lists
    const int last_a = (count % 2 == 1) ? last_len : len;
    const int last_b = (count % 2 == 1) ? 0 : last_len;
    const int next_last = (last_a + last_b < k) ? last_a + last_b : k;
    const bool final_round = pairs == 1;
    double* dst_s = final_round ? out_s : (cur_s == buf0_s ? buf1_s : buf0_s);
    long long* dst_r = final_round ? out_r
                                   : (cur_r == buf0_r ? buf1_r : buf0_r);
    const dim3 grid(pairs, (2 * len + kThreads - 1) / kThreads);
    topk_merge<<<grid, kThreads, 0, stream>>>(cur_s, cur_r, count, len,
                                              last_len, k, out_stride, dst_s,
                                              dst_r);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cur_s = dst_s;
    cur_r = dst_r;
    count = pairs;
    len = out_stride;
    last_len = next_last;
  }
  return 0;
}
