// Top-k dot-product similarity search — the Hopper kernels behind
// kernels/topk_similarity.py.
//
// Replaces: repro/kernels/topk_similarity.py:topk_similarity (_topk_kernel).
//
// Returns the m = min(k, n) rows of x (n, d) with the highest score
// s_i = x_i . q, as float64 scores and int64 row ids, ordered by score
// descending, then row ascending: np.argsort(-s, kind="stable")[:k].  NaN
// scores rank below every number (numpy's argsort puts them last), and
// -0.0 ties with +0.0.  Every score is summed in float64 in lane order,
// each product and sum rounded on its own (__dmul_rn / __dadd_rn), so the
// plain version's lane-by-lane sum gives the same bits.
//
// What bounds it on an H100: one read of x (a 15,625 x 64 float32
// partition is 4 MB, 1.2 us at 3.35 TB/s); the selection touches only
// lists of m entries a block.
//
// The TPU kernel carries a running top-k across its sequential grid in one
// output block.  Hopper blocks run in no order, so the carry becomes two
// levels, both in one launch (route `fused`, m <= kMaxFusedK):
//   * a block walks its tiles of 256 rows (tile b, b + G, ... of a grid of
//     G blocks, G a function of (n, k) only).  From a row-major x it
//     stages each tile in 128-byte column chunks through a two-stage
//     cp.async ring (16-byte copies along x's contiguous rows, 4-byte ones
//     where the rows or x are not 16-byte aligned; each staged row padded
//     by 16 bytes, so the 16-byte reads of a quarter warp hit distinct
//     banks), and thread t sums row t from shared memory in lane order.
//     From lane columns (the `lanes` entry) thread t reads row t of each
//     lane straight from device memory (a warp reads 128 contiguous bytes
//     a lane), 256 bytes of loads in flight a thread; the lanes' pointers
//     and q's weights ride in the kernel's parameters (a __grid_constant__
//     struct of kMaxLanes of each: no stack of the lanes, no copy of q);
//   * each tile's (order key, index in the tile) pairs are sorted best
//     first by a bitonic network (shuffles below a distance of 32, shared
//     memory above), and its best m merge into the block's running top m
//     by rank, as the TPU kernel merges: an element's place
//     is its index in its own list plus the number of entries of the other
//     list that beat it (binary search; (score, row) pairs are distinct,
//     so places form a permutation and places >= m drop out);
//   * each block writes its list; the last block to take a ticket (after
//     a __threadfence, as csrc/train.cu folds) reads the G lists into
//     shared memory and folds them in an order fixed by (n, G), then
//     resets the ticket, one word per (device, stream) that the wrapper
//     allocates at the stream's first call.  The fold (a bit of the plan
//     word) is either
//       0 `threshold`: it reads only the first kPrefix entries of each
//         list.  The m-th best of the lists' first j entries (j the least
//         with at least m of them) is a real row, so every row of the top
//         m is at least as good; each list keeps the prefix no worse than
//         it.  When those prefixes end inside the entries read and number
//         at most 256, the same bitonic network sorts them, one a thread,
//         and the first m are the answer (at phase 4's partition about 150
//         survivors of 62 lists; the first j entries, 124 there, are
//         sorted so too to find the bound); otherwise (many equal scores,
//         or a list holding many of the top m) the fold goes on as
//       1 `rounds`: the full lists, merged in pairs in shared memory by
//         the same rank rule until one is left.
// A grid of one block writes its list out directly.  Nothing is data
// dependent but the work, and the answer is the same on every run.
//
// Route `rounds` (m > kMaxFusedK, where the block lists no longer fit in
// shared memory) is the first port: a launch scores and ranks tiles of 256
// rows, one row a thread read from device memory, then rounds of pairwise
// merges, one launch each, ceil(log2(tiles)) of them.

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

// Does (ka, ra) come before (kb, rb)?  (No branch: it sits in the inner
// loops of the fold.)
__device__ __forceinline__ bool beats(unsigned long long ka, long long ra,
                                      unsigned long long kb, long long rb) {
  return (ka > kb) | ((ka == kb) & (ra < rb));
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


// ------------------------------------------------------------ route fused

constexpr int kMaxFusedK = 2048;
constexpr int kMaxLanes = 256;
constexpr int kMaxFusedBlocks = 132;      // one block on each SM
constexpr int kChunkBytes = 128;          // bytes of a row a stage holds
constexpr int kRowStride = kChunkBytes + 16;
constexpr int kStages = 2;
constexpr int kStageBytes = kTile * kRowStride;
constexpr int kSurvivorCap = kThreads;
constexpr int kPrefix = 16;               // entries of each list the fold
                                          // reads first
constexpr int kLaneBytes = 256;           // lane bytes in flight a thread
constexpr int kSentinelRow = 0x7fffffff;  // after every row: padding
constexpr int kSmemLimit = 232448 - 1024;  // dynamic; the rest is static

struct FusedArgs {
  const void* x;          // (n, d) row-major; null on the lanes entry
  const double* q;        // (d,); null on the lanes entry
  long long n;
  int d, m, tiles, fold;  // fold: 0 threshold, 1 rounds
  double* scr_s;          // G lists of m scores
  int* scr_r;             // G lists of m rows
  unsigned int* ticket;
  double* out_s;
  long long* out_r;
};

template <int N>
struct LaneArgs {
  const void* lane[N];
  double w[N];
};

// Byte offsets of the dynamic shared memory: the scoring part (q, the
// stage ring, a tile's scores, its sort's exchange, its sorted list, two
// running lists), then, reusing it, the last block's fold: the fast
// path's list prefixes, the subset they give and the survivors (256
// slots, its sorts' exchange), or in their place the full lists and half
// as many for the merge rounds' output; then lengths, counts, offsets.
// The wrapper's fused_smem computes the same sizes.
struct Layout {
  int q, stage, tile_sc, tile_k, tile_ls, tile_r, tile_lr, run_s, run_r,
      score_end;
  int p_k, p_s, sub_k, sv_k, sv_s, p_r, sub_r, sv_r, sv_p;
  int a_s, b_s, a_r, b_r, len, len2, off, cj, fold_end;
  __host__ __device__ Layout(int dq, bool staged, int m, int g) {
    int o = 0;
    q = o;
    o += 8 * dq;
    o = (o + 15) & ~15;
    stage = o;
    o += staged ? kStages * kStageBytes : 0;
    tile_sc = o;
    o += 8 * kTile;
    tile_k = o;
    o += 8 * kTile;
    tile_ls = o;
    o += 8 * kTile;
    tile_r = o;
    o += 4 * kTile;
    tile_lr = o;
    o += 4 * kTile;
    run_s = o;
    o += 16 * m;
    run_r = o;
    o += 8 * m;
    score_end = o;
    const int gp = g * kPrefix;
    o = 0;                      // the fast path
    p_k = o;
    o += 8 * gp;
    p_s = o;
    o += 8 * gp;
    sub_k = o;
    o += 8 * gp;
    sv_k = o;
    o += 8 * kSurvivorCap;
    sv_s = o;
    o += 8 * kSurvivorCap;
    p_r = o;
    o += 4 * gp;
    sub_r = o;
    o += 4 * gp;
    sv_r = o;
    o += 4 * kSurvivorCap;
    sv_p = o;
    o += 4 * kSurvivorCap;
    const int fast_end = o;
    const int half = (g + 1) / 2;
    o = 0;                      // the merge rounds, over it
    a_s = o;
    o += 8 * g * m;
    b_s = o;
    o += 8 * half * m;
    a_r = o;
    o += 4 * g * m;
    b_r = o;
    o += 4 * half * m;
    o = o > fast_end ? o : fast_end;
    len = o;
    o += 4 * g;
    len2 = o;
    o += 4 * g;
    off = o;
    o += 4 * (g + 1);
    cj = o;
    o += 4 * kPrefix;
    fold_end = o;
  }
  __host__ __device__ int bytes() const {
    return score_end > fold_end ? score_end : fold_end;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ bool beats_s(double sa, int ra, double sb,
                                        int rb) {
  return beats(score_key(sa), ra, score_key(sb), rb);
}

// Entries of the sorted list (s, r, len) that beat (key, row).
__device__ __forceinline__ int count_beating_s(const double* s, const int* r,
                                               int len,
                                               unsigned long long key,
                                               int row) {
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

// The first min(m, la + lb) entries of lists a and b merged, into o.
// Called by every thread; ends with a barrier.
__device__ void merge_pair(const double* as, const int* ar, int la,
                           const double* bs, const int* br, int lb,
                           double* os, int* orow, int m) {
  for (int e = threadIdx.x; e < la + lb; e += kThreads) {
    double s;
    int r, pos;
    if (e < la) {
      s = as[e];
      r = ar[e];
      pos = e + count_beating_s(bs, br, lb, score_key(s), r);
    } else {
      s = bs[e - la];
      r = br[e - la];
      pos = e - la + count_beating_s(as, ar, la, score_key(s), r);
    }
    if (pos < m) {
      os[pos] = s;
      orow[pos] = r;
    }
  }
  __syncthreads();
}

// Sort the first N (key, row) pairs best first, one a thread, with a
// payload riding along (kPay), by a bitonic network: shuffles below a
// distance of 32, the exchange arrays xk, xr, xp (kThreads slots) above.
// Afterwards thread t < N holds the t-th best.  Every thread calls it; it
// ends with a barrier.
template <int N, bool kPay>
__device__ void bitonic_sort(unsigned long long& key, int& row, int& pay,
                             unsigned long long* xk, int* xr, int* xp) {
  static_assert(N >= 64 && N <= kThreads, "N");
  const int t = threadIdx.x;
  for (int size = 2; size <= N; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      unsigned long long okey;
      int orow, opay = 0;
      if (stride >= 32) {
        xk[t] = key;
        xr[t] = row;
        if (kPay) xp[t] = pay;
        __syncthreads();
        okey = xk[t ^ stride];
        orow = xr[t ^ stride];
        if (kPay) opay = xp[t ^ stride];
        __syncthreads();
      } else {
        okey = __shfl_xor_sync(0xffffffffu, key, stride);
        orow = __shfl_xor_sync(0xffffffffu, row, stride);
        if (kPay) opay = __shfl_xor_sync(0xffffffffu, pay, stride);
      }
      // the lower place of a pair keeps the better entry in a run sorted
      // best first ((t & size) == 0), the worse one in a run sorted the
      // other way
      const bool lower = (t & stride) == 0;
      const bool best_first = (t & size) == 0;
      if (lower == best_first ? beats(okey, orow, key, row)
                              : beats(key, row, okey, orow)) {
        key = okey;
        row = orow;
        pay = opay;
      }
    }
  }
}

// The tile's 256 (key, index) pairs sorted best first; entries placed
// below `keep` go to (ls, lr): ls[p] = sc[index], lr[p] = first + index.
// Every thread calls it; it ends with a barrier.
__device__ void select_tile(unsigned long long key, int idx, int keep,
                            const double* sc, long long first,
                            unsigned long long* rk, int* ri, double* ls,
                            int* lr) {
  const int t = threadIdx.x;
  int none = 0;
  bitonic_sort<kTile, false>(key, idx, none, rk, ri, nullptr);
  if (t < keep) {
    ls[t] = sc[idx];
    lr[t] = static_cast<int>(first + idx);
  }
  __syncthreads();
}

// A scored tile (thread t: the score of row first + t, valid or not)
// merged into the running list run[*cur] of *len entries (the first tile
// placed straight into it).  Every thread calls it.  A row past n comes
// after every row (key 0, as NaN, at a larger index).
__device__ void take_tile(double s, long long first, bool valid, int rows,
                          int m, double* sc, unsigned long long* rk, int* ri,
                          double* ts, int* tr, double* run_s, int* run_r,
                          int* cur, int* len) {
  const int t = threadIdx.x;
  sc[t] = s;
  const unsigned long long key = valid ? score_key(s) : 0ULL;
  const int b = rows < m ? rows : m;
  if (*len == 0) {
    select_tile(key, t, b, sc, first, rk, ri, run_s + *cur * m,
                run_r + *cur * m);
    *len = b;
    return;
  }
  select_tile(key, t, b, sc, first, rk, ri, ts, tr);
  double* as = run_s + *cur * m;
  int* ar = run_r + *cur * m;
  // a tile whose best entry does not beat a full list's last adds nothing
  if (*len == m && !beats_s(ts[0], tr[0], as[m - 1], ar[m - 1])) return;
  merge_pair(as, ar, *len, ts, tr, b, run_s + (*cur ^ 1) * m,
             run_r + (*cur ^ 1) * m, m);
  *cur ^= 1;
  *len = *len + b < m ? *len + b : m;
}

template <typename T>
__device__ __forceinline__ void load16(const unsigned char* p,
                                       T (&v)[16 / sizeof(T)]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int u = 0; u < static_cast<int>(16 / sizeof(T)); ++u) {
    if constexpr (sizeof(T) == 4) {
      v[u] = static_cast<T>(__uint_as_float(w[u]));
    } else {
      v[u] = static_cast<T>(__hiloint2double(static_cast<int>(w[2 * u + 1]),
                                             static_cast<int>(w[2 * u])));
    }
  }
}

// s plus a staged chunk's cnt lanes of one row, in lane order
template <typename T>
__device__ __forceinline__ double score_chunk(double s,
                                              const unsigned char* rowp,
                                              const double* q, int cnt) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kVecs = kChunkBytes / 16;
  if (cnt == kVecs * kPer) {
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      T vals[kPer];
      load16<T>(rowp + 16 * v, vals);
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        s = __dadd_rn(s, __dmul_rn(static_cast<double>(vals[u]),
                                   q[v * kPer + u]));
    }
  } else {
    const T* row = reinterpret_cast<const T*>(rowp);
    for (int j = 0; j < cnt; ++j)
      s = __dadd_rn(s, __dmul_rn(static_cast<double>(row[j]), q[j]));
  }
  return s;
}

// Start copying chunk c (kChunkBytes of each row) of tile `tile` into the
// stage at shared address dst; one commit group.
template <typename T>
__device__ __forceinline__ void issue_stage(const FusedArgs& a, int tile,
                                            int c, uint32_t dst, bool vec) {
  const long long first = static_cast<long long>(tile) * kTile;
  const long long left = a.n - first;
  const int rows = left < kTile ? static_cast<int>(left) : kTile;
  const long long row_bytes = static_cast<long long>(a.d) * sizeof(T);
  const long long off = static_cast<long long>(c) * kChunkBytes;
  const int cb = row_bytes - off < kChunkBytes
                 ? static_cast<int>(row_bytes - off) : kChunkBytes;
  const unsigned char* src =
      static_cast<const unsigned char*>(a.x) + first * row_bytes + off;
  if (vec) {
    const int pieces = cb >> 4;
    for (int i = threadIdx.x; i < rows * (kChunkBytes / 16); i += kThreads) {
      const int r = i / (kChunkBytes / 16), p = i % (kChunkBytes / 16);
      if (p < pieces)
        cp_async16(dst + r * kRowStride + p * 16, src + r * row_bytes + p * 16);
    }
  } else {
    const int pieces = cb >> 2;
    for (int i = threadIdx.x; i < rows * (kChunkBytes / 4); i += kThreads) {
      const int r = i / (kChunkBytes / 4), p = i % (kChunkBytes / 4);
      if (p < pieces)
        cp_async4(dst + r * kRowStride + p * 4, src + r * row_bytes + p * 4);
    }
  }
  cp_async_commit();
}

// row `row` of the lanes: lane order, kLaneBytes of loads in flight
// before their sums
template <typename T, int N>
__device__ __forceinline__ double score_lanes(const LaneArgs<N>& l, int d,
                                              long long row) {
  constexpr int kLaneBatch = kLaneBytes / static_cast<int>(sizeof(T));
  double s = 0.0;
  for (int j0 = 0; j0 < d; j0 += kLaneBatch) {
    T v[kLaneBatch];
#pragma unroll
    for (int u = 0; u < kLaneBatch; ++u)
      if (j0 + u < d) v[u] = __ldg(static_cast<const T*>(l.lane[j0 + u]) + row);
#pragma unroll
    for (int u = 0; u < kLaneBatch; ++u)
      if (j0 + u < d)
        s = __dadd_rn(s, __dmul_rn(static_cast<double>(v[u]), l.w[j0 + u]));
  }
  return s;
}

// Block exclusive scan of v (thread t < count holds it); off[0..count]
// gets the offsets and the total.  Ends with a barrier.
__device__ void scan_counts(const int* v, int count, int* off) {
  __shared__ int s_warp[kThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int x = t < count ? v[t] : 0;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += s_warp[w];
  if (t < count) off[t] = base + inc - x;
  if (t == count - 1) off[count] = base + inc;
  __syncthreads();
}

// The length of block b's list: min(m, the rows of its tiles b, b + G,
// ...), the last tile n - 256 (tiles - 1) rows.
__device__ __forceinline__ int list_len(const FusedArgs& a, int b, int g) {
  const long long tiles_b = (a.tiles - b + g - 1) / g;
  long long rows = tiles_b * kTile;
  if ((a.tiles - 1) % g == b) rows -= static_cast<long long>(a.tiles) * kTile
                                      - a.n;
  return rows < a.m ? static_cast<int>(rows) : a.m;
}

// The fold's fast path: from each list's first kPrefix entries only.
// The m-th best of the lists' first j entries (j the least that gives at
// least m) is a real row, so every row of the top m is at least as good;
// each list's entries no worse than it are a prefix of it.  When every
// such prefix ends inside the entries read, and they number at most
// kSurvivorCap, each survivor's place is the count of survivors that beat
// it, and the output is written: true.  Otherwise false (many equal
// scores, or a list holding many of the top m), and nothing is written.
__device__ bool fold_prefixes(const FusedArgs& a, const Layout& L,
                              unsigned char* smem, int g, const int* len) {
  const int t = threadIdx.x, m = a.m, gp = g * kPrefix;
  const int warp = t >> 5, lane = t & 31;
  unsigned long long* pk =
      reinterpret_cast<unsigned long long*>(smem + L.p_k);
  double* ps = reinterpret_cast<double*>(smem + L.p_s);
  int* pr = reinterpret_cast<int*>(smem + L.p_r);
  unsigned long long* subk =
      reinterpret_cast<unsigned long long*>(smem + L.sub_k);
  int* subr = reinterpret_cast<int*>(smem + L.sub_r);
  int* cnt = reinterpret_cast<int*>(smem + L.len2);
  int* off = reinterpret_cast<int*>(smem + L.off);
  int* cj = reinterpret_cast<int*>(smem + L.cj);
  __shared__ unsigned long long s_lbk;
  __shared__ int s_lbr;
  // the prefixes, every load in flight before the first store
  constexpr int kPer = 8;
  for (int e0 = t; e0 < gp; e0 += kThreads * kPer) {
    double sv[kPer];
    int rv[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = e0 + u * kThreads, i = e % kPrefix;
      if (e < gp && i < m) {
        const long long at = static_cast<long long>(e / kPrefix) * m + i;
        sv[u] = __ldcg(a.scr_s + at);
        rv[u] = __ldcg(a.scr_r + at);
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = e0 + u * kThreads;
      if (e < gp && e % kPrefix < m) {
        ps[e] = sv[u];
        pk[e] = score_key(sv[u]);
        pr[e] = rv[u];
      }
    }
  }
  // cj[j - 1]: the entries of the lists' first j, a warp a j
  for (int jj = warp; jj < kPrefix; jj += kThreads / 32) {
    int c = 0;
    for (int b = lane; b < g; b += 32) c += len[b] < jj + 1 ? len[b] : jj + 1;
    c = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0) cj[jj] = c;
  }
  __syncthreads();
  const int j = __syncthreads_count(t < kPrefix && cj[t] < m) + 1;
  if (j > kPrefix) return false;
  // the subset (each list's first j), contiguous, and its m-th best
  int nsub = g * j;
  if (cj[j - 1] == nsub) {                      // every list gives j
    for (int e = t; e < nsub; e += kThreads) {
      const int b = e / j, i = e - b * j;
      subk[e] = pk[b * kPrefix + i];
      subr[e] = pr[b * kPrefix + i];
    }
  } else {
    for (int b = t; b < g; b += kThreads) cnt[b] = len[b] < j ? len[b] : j;
    __syncthreads();
    scan_counts(cnt, g, off);
    nsub = off[g];
    for (int e = t; e < g * j; e += kThreads) {
      const int b = e / j, i = e - b * j;
      if (i < cnt[b]) {
        subk[off[b] + i] = pk[b * kPrefix + i];
        subr[off[b] + i] = pr[b * kPrefix + i];
      }
    }
  }
  __syncthreads();
  if (nsub <= kThreads) {                       // sorted, one a thread
    unsigned long long key = t < nsub ? subk[t] : 0ULL;
    int r = t < nsub ? subr[t] : kSentinelRow, none = 0;
    unsigned long long* xk =
        reinterpret_cast<unsigned long long*>(smem + L.sv_k);
    int* xr = reinterpret_cast<int*>(smem + L.sv_r);
    if (nsub <= kThreads / 2) {
      bitonic_sort<kThreads / 2, false>(key, r, none, xk, xr, nullptr);
    } else {
      bitonic_sort<kThreads, false>(key, r, none, xk, xr, nullptr);
    }
    if (t == m - 1) {
      s_lbk = key;
      s_lbr = r;
    }
  } else {                                      // ranked by counting
    for (int e = t; e < nsub; e += kThreads) {
      const unsigned long long key = subk[e];
      const int r = subr[e];
      int rank = 0;
      for (int q = 0; q < nsub; ++q) rank += beats(subk[q], subr[q], key, r);
      if (rank == m - 1) {
        s_lbk = key;
        s_lbr = r;
      }
    }
  }
  __syncthreads();
  // each list's prefix no worse than the bound, within the entries read:
  // the survivors, gathered in any order (a slot counter taken a warp at a
  // time), as they are sorted next
  const unsigned long long lbk = s_lbk;
  const int lbr = s_lbr;
  unsigned long long* svk =
      reinterpret_cast<unsigned long long*>(smem + L.sv_k);
  double* svs = reinterpret_cast<double*>(smem + L.sv_s);
  int* svr = reinterpret_cast<int*>(smem + L.sv_r);
  __shared__ int s_total;
  if (t == 0) s_total = 0;
  __syncthreads();
  bool more = false;
  for (int e = t; e < ((gp + 31) & ~31); e += kThreads) {
    const int b = e / kPrefix, i = e - b * kPrefix;
    const bool keep = e < gp && i < (len[b] < kPrefix ? len[b] : kPrefix)
                      && !beats(lbk, lbr, pk[e], pr[e]);
    more |= keep && i == kPrefix - 1 && len[b] > kPrefix;
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    int base = 0;
    if (lane == 0 && mask) base = atomicAdd(&s_total, __popc(mask));
    base = __shfl_sync(0xffffffffu, base, 0);
    const int slot = base + __popc(mask & ((1u << lane) - 1u));
    if (keep && slot < kSurvivorCap) {
      svk[slot] = pk[e];
      svs[slot] = ps[e];
      svr[slot] = pr[e];
    }
  }
  if (__syncthreads_or(more) || s_total > kSurvivorCap) return false;
  const int total = s_total;
  // the survivors sorted, one a thread (total <= kSurvivorCap = kThreads):
  // the first m are the answer
  unsigned long long key = t < total ? svk[t] : 0ULL;
  int r = t < total ? svr[t] : kSentinelRow, slot = t;
  bitonic_sort<kThreads, true>(key, r, slot, svk, svr,
                               reinterpret_cast<int*>(smem + L.sv_p));
  if (t < m) {
    a.out_s[t] = svs[slot];
    a.out_r[t] = r;
  }
  return true;
}

// The last block: the G lists of scratch into the top m, written out —
// by the prefixes (fold 0) or, when they do not settle it or fold 1 asks,
// by rounds of pairwise merges of the full lists in shared memory.
__device__ void fold_lists(const FusedArgs& a, const Layout& L,
                           unsigned char* smem, int g) {
  const int t = threadIdx.x, m = a.m;
  int* len = reinterpret_cast<int*>(smem + L.len);
  for (int b = t; b < g; b += kThreads) len[b] = list_len(a, b, g);
  __syncthreads();
  if (a.fold == 0 && fold_prefixes(a, L, smem, g, len)) return;
  __syncthreads();              // the fast path's arrays are overwritten
  double* as = reinterpret_cast<double*>(smem + L.a_s);
  int* ar = reinterpret_cast<int*>(smem + L.a_r);
  double* bs = reinterpret_cast<double*>(smem + L.b_s);
  int* br = reinterpret_cast<int*>(smem + L.b_r);
  const int gm = g * m;
  constexpr int kPer = 8;
  for (int e0 = t; e0 < gm; e0 += kThreads * kPer) {
    double sv[kPer];
    int rv[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = e0 + u * kThreads;
      if (e < gm) {
        sv[u] = __ldcg(a.scr_s + e);
        rv[u] = __ldcg(a.scr_r + e);
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = e0 + u * kThreads;
      if (e < gm) {
        as[e] = sv[u];
        ar[e] = rv[u];
      }
    }
  }
  __syncthreads();
  // rounds of pairwise merges: lists 2p and 2p + 1 into list p (an odd
  // last list carries over), every pair in one pass a round
  int* lens = len;
  int* nlen = reinterpret_cast<int*>(smem + L.len2);
  double* src_s = as;
  int* src_r = ar;
  double* dst_s = bs;
  int* dst_r = br;
  for (int count = g; count > 1; count = (count + 1) / 2) {
    for (int e = t; e < count * m; e += kThreads) {
      const int li = e / m, i = e - li * m;
      if (i >= lens[li]) continue;
      const double s = src_s[e];
      const int r = src_r[e], pi = li ^ 1;
      const int pos = i + (pi < count
                           ? count_beating_s(src_s + pi * m, src_r + pi * m,
                                             lens[pi], score_key(s), r)
                           : 0);
      if (pos < m) {
        dst_s[(li >> 1) * m + pos] = s;
        dst_r[(li >> 1) * m + pos] = r;
      }
    }
    for (int p = t; p < (count + 1) / 2; p += kThreads) {
      const int l = lens[2 * p] + (2 * p + 1 < count ? lens[2 * p + 1] : 0);
      nlen[p] = l < m ? l : m;
    }
    __syncthreads();
    int* tl = lens;
    lens = nlen;
    nlen = tl;
    double* tsw = src_s;
    src_s = dst_s;
    dst_s = tsw;
    int* trw = src_r;
    src_r = dst_r;
    dst_r = trw;
  }
  for (int i = t; i < m; i += kThreads) {
    a.out_s[i] = src_s[i];
    a.out_r[i] = src_r[i];
  }
}

template <typename T, bool kLanes>
__global__ void __launch_bounds__(kThreads, 1)
topk_fused(const __grid_constant__ FusedArgs a,
           const __grid_constant__ LaneArgs<kLanes ? kMaxLanes : 1> l) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, g = gridDim.x, m = a.m, d = a.d;
  const Layout L(kLanes ? 0 : d, !kLanes, m, g);
  double* sc = reinterpret_cast<double*>(smem + L.tile_sc);
  unsigned long long* rk =
      reinterpret_cast<unsigned long long*>(smem + L.tile_k);
  int* ri = reinterpret_cast<int*>(smem + L.tile_r);
  double* ts = reinterpret_cast<double*>(smem + L.tile_ls);
  int* tr = reinterpret_cast<int*>(smem + L.tile_lr);
  double* run_s = reinterpret_cast<double*>(smem + L.run_s);
  int* run_r = reinterpret_cast<int*>(smem + L.run_r);
  int cur = 0, len = 0;
  const int my_tiles = (a.tiles - static_cast<int>(blockIdx.x) + g - 1) / g;
  if (kLanes) {
    for (int i = 0; i < my_tiles; ++i) {
      const long long first =
          static_cast<long long>(blockIdx.x + i * g) * kTile;
      const long long left = a.n - first;
      const int rows = left < kTile ? static_cast<int>(left) : kTile;
      const bool valid = t < rows;
      const double s = valid ? score_lanes<T>(l, d, first + t) : 0.0;
      take_tile(s, first, valid, rows, m, sc, rk, ri, ts, tr, run_s, run_r,
                &cur, &len);
    }
  } else {
    double* s_q = reinterpret_cast<double*>(smem + L.q);
    for (int j = t; j < d; j += kThreads) s_q[j] = a.q[j];
    const long long row_bytes = static_cast<long long>(d) * sizeof(T);
    const int chunks =
        static_cast<int>((row_bytes + kChunkBytes - 1) / kChunkBytes);
    const int per_chunk = kChunkBytes / static_cast<int>(sizeof(T));
    const int total = my_tiles * chunks;
    const bool vec = (row_bytes & 15) == 0
                     && (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
    const uint32_t ring = smem_addr(smem + L.stage);
    issue_stage<T>(a, blockIdx.x, 0, ring, vec);
    double acc = 0.0;
    for (int s = 0; s < total; ++s) {
      // the next stage's buffer held stage s - 1, which every thread
      // finished reading at the barrier that ended step s - 1
      if (s + 1 < total) {
        issue_stage<T>(a, blockIdx.x + ((s + 1) / chunks) * g,
                       (s + 1) % chunks, ring + ((s + 1) & 1) * kStageBytes,
                       vec);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int i = s / chunks, c = s % chunks;
      const long long first =
          static_cast<long long>(blockIdx.x + i * g) * kTile;
      const long long left = a.n - first;
      const int rows = left < kTile ? static_cast<int>(left) : kTile;
      const int cnt = d - c * per_chunk < per_chunk ? d - c * per_chunk
                                                    : per_chunk;
      if (t < rows)
        acc = score_chunk<T>(acc, smem + L.stage + (s & 1) * kStageBytes
                                      + t * kRowStride,
                             s_q + c * per_chunk, cnt);
      if (c == chunks - 1) {
        take_tile(acc, first, t < rows, rows, m, sc, rk, ri, ts, tr, run_s,
                  run_r, &cur, &len);
        acc = 0.0;
      }
      __syncthreads();
    }
  }
  const double* ls = run_s + cur * m;
  const int* lr = run_r + cur * m;
  if (g == 1) {                       // one list: the answer
    for (int i = t; i < m; i += kThreads) {
      a.out_s[i] = ls[i];
      a.out_r[i] = lr[i];
    }
    return;
  }
  const long long base = static_cast<long long>(blockIdx.x) * m;
  for (int i = t; i < len; i += kThreads) {
    a.scr_s[base + i] = ls[i];
    a.scr_r[base + i] = lr[i];
  }
  __shared__ bool s_last;
  __threadfence();                    // this block's list, before its ticket
  __syncthreads();
  if (t == 0) s_last = atomicAdd(a.ticket, 1u) == static_cast<unsigned>(g - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();                    // every other block's list, after it
  fold_lists(a, L, smem, g);
  if (t == 0) *a.ticket = 0u;         // the next launch starts from 0
}

template <typename T, bool kLanes>
int launch_fused(const FusedArgs& a, const LaneArgs<kLanes ? kMaxLanes : 1>& l,
                 int g, cudaStream_t stream) {
  const Layout L(kLanes ? 0 : a.d, !kLanes, a.m, g);
  const int smem = L.bytes();
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t configured = cudaFuncSetAttribute(
      topk_fused<T, kLanes>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  topk_fused<T, kLanes><<<g, kThreads, smem, stream>>>(a, l);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Route `rounds`: the top min(k, n) rows of x (n, d; x_dt float32 or
// float64) by x . q (q: d float64) into out_s (float64) / out_r (int64).
// buf_* are two scratch buffers of tiles * min(k, 256) entries each,
// tiles = ceil(n / 256).
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

// Route `fused`: the top m = min(k, n) rows, m <= kMaxFusedK, in one
// launch.  The rows are x (n, d, row-major, x_dt float32 or float64) with
// q (d float64), or, when `lanes` is not null, d lane columns of n values
// of x_dt: `lanes` points to d lane addresses then d float64 weights, in
// host memory, copied into the kernel's parameters (d <= kMaxLanes).
// `word`: bits 0-11 the blocks G (1..kMaxFusedBlocks, at most the tiles),
// bit 12 the fold (0 threshold, 1 rounds).  `buf` (8-byte aligned): out_r
// (m int64), out_s (m float64), then G * m float64 scores and G * m int32
// rows of scratch.  `ticket`: an int32 zero that the
// launch leaves at zero.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments it rejects.
extern "C" int shark_topk_fused(const void* x, const void* lanes, int x_dt,
                                const double* q, long long n, int d, int m,
                                unsigned long long word, void* buf,
                                unsigned int* ticket, cudaStream_t stream) {
  const int g = static_cast<int>(word & 4095), fold = (word >> 12) & 1;
  const long long tiles = (n + kTile - 1) / kTile;
  if (n < 1 || n >= kSentinelRow || d < 1 || d > 4096 || m < 1
      || m > kMaxFusedK || m > n || g < 1 || g > kMaxFusedBlocks
      || g > tiles || buf == nullptr
      || (reinterpret_cast<uintptr_t>(buf) & 7) != 0
      || (g > 1 && ticket == nullptr)
      || (x_dt != kFloat32 && x_dt != kFloat64))
    return static_cast<int>(cudaErrorInvalidValue);
  FusedArgs a;
  a.x = x;
  a.q = q;
  a.n = n;
  a.d = d;
  a.m = m;
  a.tiles = static_cast<int>(tiles);
  a.fold = fold;
  a.out_r = static_cast<long long*>(buf);
  a.out_s = reinterpret_cast<double*>(a.out_r + m);
  a.scr_s = a.out_s + m;
  a.scr_r = reinterpret_cast<int*>(a.scr_s + static_cast<long long>(g) * m);
  a.ticket = ticket;
  if (lanes != nullptr) {
    if (d > kMaxLanes) return static_cast<int>(cudaErrorInvalidValue);
    LaneArgs<kMaxLanes> l = {};
    const unsigned long long* src =
        static_cast<const unsigned long long*>(lanes);
    for (int j = 0; j < d; ++j) {
      l.lane[j] = reinterpret_cast<const void*>(src[j]);
      l.w[j] = reinterpret_cast<const double*>(src + d)[j];
      const uintptr_t align = x_dt == kFloat32 ? 3 : 7;
      if (l.lane[j] == nullptr
          || (reinterpret_cast<uintptr_t>(l.lane[j]) & align) != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return x_dt == kFloat32 ? launch_fused<float, true>(a, l, g, stream)
                            : launch_fused<double, true>(a, l, g, stream);
  }
  if (x == nullptr || q == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const LaneArgs<1> none = {};
  return x_dt == kFloat32 ? launch_fused<float, false>(a, none, g, stream)
                          : launch_fused<double, false>(a, none, g, stream);
}
