// Map-side shuffle partition (radix partition) — the Hopper kernel behind
// kernels/radix_partition.py.
//
// Replaces: repro/kernels/radix_partition.py:radix_partition, both the
//           ids-only variant (_radix_ids_kernel) and the variant with the
//           bucket histogram (_radix_kernel).  The TPU kernel stopped at
//           ids and a histogram because its host did the rest of a
//           shuffle's map side; on this card one launch does all of it.
//
// What it computes, by flag (the wrapper's plan word):
//   ids[i]   = mix_u32(fold(keys[i])) % B, bit-identical to
//              radix_partition_ref (the 32-bit golden-ratio mix in uint32
//              arithmetic, logical shifts), with fold the xor of an int64
//              key's halves, as the host's fold_keys_u32 (uint32 / int32
//              keys are not folded);
//   counts   the int32 histogram of the ids, written (not accumulated), so
//              nothing is zeroed before the launch;
//   order    the row indices grouped by bucket, ascending within a bucket:
//              exactly np.argsort(ids, kind="stable");
//   bounds   the exclusive prefix of the counts with n appended: exactly
//              np.searchsorted(ids[order], arange(B + 1)).
//
// What bounds it on an H100: bytes — a key read (8 or 4 bytes) and an
// order entry written (4 bytes) a row.  At the shuffle's sizes (50 to
// 93,750 keys) the launch and the dependent round trips to L2 cost more
// than the bytes, so the design counts round trips.
//
// Design of route one_launch (B <= 1024, every shuffle of the executor):
//   * a tile is 4,096 rows: 8 warps of 16 steps of 32 neighbouring rows.
//     A row's rank among the tile's rows of its bucket follows row order:
//     within a step, a lane's peers with the same bucket, and __popc of
//     the lower ones; across steps, a warp's running counts; across
//     warps, the per-warp counts scanned.  For B <= 64 (the executor's
//     buckets) the peers come from one ballot of each bucket bit and the
//     running counts sit in registers (lane j: buckets j and j + 32);
//     above, from __match_any_sync, the counts in shared memory (1.6x the
//     device time at B = 64, scripts/kernel_probe.py radix).  Steps past
//     n are skipped (a warp-uniform test), so 50 keys take 2 steps of one
//     warp.  For B <= 64 a ranked tile is staged in shared memory in
//     bucket order and written out in bucket runs, neighbouring threads
//     on neighbouring positions;
//   * one tile (n <= 4,096, the 50-key partials of a GROUP BY) is the
//     whole call: one block ranks, scans its counts into bounds and
//     writes the order, with no word in global memory;
//   * more tiles are cut into at most 264 chunks of whole tiles (a tile a
//     chunk up to 264 tiles), one block a chunk.  Blocks take chunk
//     numbers from the stream's ticket (kernels/_common.py:stream_ticket,
//     as scan.cu, train.cu and topk.cu), never from blockIdx, so a chunk
//     only ever waits on chunks that running blocks hold.  Phase 1: a
//     chunk counts its buckets (a one-tile chunk ranks its rows and keeps
//     them in registers), publishes a 64-bit word a bucket — flag, count
//     and, once known, the exclusive prefix — as AGGREGATE (PREFIX for
//     chunk 0), then looks back over the earlier chunks (decoupled
//     look-back, as CUB's one-sweep: a group of lanes a bucket reads a
//     window of 8 chunks a lane with every load in flight, and stops at
//     the nearest PREFIX) and publishes its PREFIX.  Each block adds its
//     chunks to a done count (release).  Phase 2, once the done count
//     reaches the chunks (acquire): the last chunk's word gives the
//     totals, scanned in the block into the bucket starts; a block
//     scatters the chunks it took, the last one from registers when it
//     is one tile, the others ranked again from the keys.  A block waits
//     for the done count only after the ticket ran out, when every chunk
//     is held by a running block: no wait depends on a block being
//     resident;
//   * the words live in the stream's scratch, which every launch leaves
//     zeroed as it found it (the ticket and the exit count wrap to 0 with
//     atom.inc, the block that exits last clears the done count and the
//     last chunk's words, the others clear their own chunks' words): a
//     word that is not zero at the start would be read as a published
//     count, and a call's own allocation would need a memset before the
//     kernel.
// Route two_launch (B > 1024, up to 8,192): 8 warps' counters of every
// bucket do not fit in shared memory, so a histogram launch counts each
// of up to 256 chunks of rows and the last of its blocks to take a ticket
// scans the chunk counts bucket by bucket into the chunks' starts and the
// bucket starts; then a scatter launch walks each chunk in row order with
// one warp.
// A call that asks for ids alone takes the same routes: ids are written
// where a tile's buckets are first computed.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                    // rows of a thread in a tile
constexpr int kWarpRows = 32 * kRows;        // 512
constexpr int kTile = kWarps * kWarpRows;    // 4,096
constexpr int kMaxChunks = 264;              // radix_partition.GRID_MAX
constexpr int kWindow = 8;                   // look-back words a lane loads
constexpr unsigned kOneLaunchMax = 1024;
constexpr unsigned kRegBuckets = 64;         // ranks in registers up to here
constexpr unsigned kMaxBuckets = 8192;
// a look-back word: flag (bits 62-63), count (31-61), exclusive prefix
// (0-30, PREFIX only)
constexpr unsigned long long kAgg = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kFlags = 3ull << 62;
constexpr uint32_t kField = 0x7fffffffu;

// plan word (kernels/radix_partition.py:RadixPlan.word)
constexpr unsigned long long kKeys64 = 1, kIds = 2, kCounts = 4,
                             kSplit = 8;
enum Route { kRouteOne = 0, kRouteTwo = 1 };

__device__ __forceinline__ uint32_t mix_u32(uint32_t h) {
  h = h * 2654435761u;
  h ^= h >> 15;
  h = h * 0x85EBCA6Bu;
  h ^= h >> 13;
  return h;
}

struct Params {
  const void* keys;
  long long n;
  uint32_t B;
  uint32_t mask;             // B - 1 when B is a power of two, else 0
  long long tiles;           // one_launch: tiles; two_launch: chunk rows
  long long chunks;          // one_launch: chunks
  long long chunk_tiles;     // one_launch: tiles a chunk
  int32_t* order;            // NULL unless kSplit
  int32_t* bounds;           // NULL unless kSplit
  int32_t* ids;              // NULL unless kIds
  int32_t* counts;           // NULL unless kCounts
  int32_t* chunk_counts;     // two_launch: chunks x B
  unsigned* head;            // the scratch's counters: ticket, done, exit,
                             // the chunk fold's ticket
  unsigned long long* words; // one_launch: chunks x B look-back words
};

// bucket of a key: int64 keys fold with a logical shift, as numpy's
template <bool k64>
__device__ __forceinline__ uint32_t bucket_of_key(
    const Params& p, typename std::conditional<k64, unsigned long long,
                                               uint32_t>::type k) {
  uint32_t h;
  if constexpr (k64)
    h = static_cast<uint32_t>(k ^ (k >> 32));
  else
    h = k;
  h = mix_u32(h);
  return p.mask ? h & p.mask : h % p.B;
}

// bucket of row i
template <bool k64>
__device__ __forceinline__ uint32_t bucket_of(const Params& p, long long i) {
  using Key = typename std::conditional<k64, unsigned long long,
                                        uint32_t>::type;
  return bucket_of_key<k64>(p, __ldg(static_cast<const Key*>(p.keys) + i));
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ unsigned long long ld_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_word(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// release orders the block's stores before it, acquire the other blocks'
// after it; wraps to 0 after `last`
__device__ __forceinline__ unsigned take_ticket(unsigned* p, unsigned last) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(last) : "memory");
  return old;
}

__device__ __forceinline__ uint32_t word_count(unsigned long long w) {
  return static_cast<uint32_t>(w >> 31) & kField;
}

__device__ __forceinline__ uint32_t word_excl(unsigned long long w) {
  return static_cast<uint32_t>(w) & kField;
}

// what a word adds to a later chunk's prefix: its count, and for PREFIX
// its own exclusive prefix too
__device__ __forceinline__ uint32_t word_incl(unsigned long long w) {
  return word_count(w) + ((w & kFlags) == kPrefix ? word_excl(w) : 0u);
}

// Exclusive scan of a[0..m) in shared memory, in place; returns the total
// to every thread.  s_warp holds kWarps + 1 words.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t* a,
                                                         unsigned m,
                                                         uint32_t* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned per = (m + kThreads - 1) / kThreads;
  const unsigned lo = min(m, threadIdx.x * per), hi = min(m, lo + per);
  uint32_t sum = 0;
  for (unsigned i = lo; i < hi; ++i) sum += a[i];
  uint32_t incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < kWarps ? s_warp[lane] : 0;
    uint32_t wi = w;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const uint32_t v = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += v;
    }
    if (lane < kWarps) s_warp[lane] = wi - w;
    if (lane == kWarps - 1) s_warp[kWarps] = wi;
  }
  __syncthreads();
  uint32_t run = s_warp[warp] + incl - sum;
  for (unsigned i = lo; i < hi; ++i) {
    const uint32_t c = a[i];
    a[i] = run;
    run += c;
  }
  const uint32_t total = s_warp[kWarps];
  __syncthreads();
  return total;
}

// Exclusive scan of in[0..B) into out, B <= 64, by warp 0 (two values a
// lane); the other warps pass by.  The caller's barrier publishes it.
__device__ __forceinline__ void warp_exclusive_scan64(const uint32_t* in,
                                                      uint32_t* out,
                                                      uint32_t B) {
  if (threadIdx.x >= 32) return;
  const unsigned lane = threadIdx.x;
  const uint32_t x = lane < B ? in[lane] : 0u;
  const uint32_t y = lane + 32 < B ? in[lane + 32] : 0u;
  uint32_t ix = x, iy = y;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t vx = __shfl_up_sync(0xffffffffu, ix, o);
    const uint32_t vy = __shfl_up_sync(0xffffffffu, iy, o);
    if (lane >= static_cast<unsigned>(o)) {
      ix += vx;
      iy += vy;
    }
  }
  const uint32_t total_x = __shfl_sync(0xffffffffu, ix, 31);
  if (lane < B) out[lane] = ix - x;
  if (lane + 32 < B) out[lane + 32] = total_x + iy - y;
}

// Exclusive scan of a[0..B) in place, with a barrier after it.
template <bool kReg>
__device__ __forceinline__ void bucket_scan(uint32_t* a, uint32_t B,
                                            uint32_t* s_warp) {
  if constexpr (kReg) {
    warp_exclusive_scan64(a, a, B);
    __syncthreads();
  } else {
    block_exclusive_scan(a, B, s_warp);
  }
}

// The first row of this warp's step 0 in tile t.
__device__ __forceinline__ long long warp_row0(long long t) {
  return t * kTile + (threadIdx.x >> 5) * kWarpRows;
}

// The buckets of a thread's rows of tile t (B for a row past n): every
// key load issued before the first is used.
template <bool k64>
__device__ __forceinline__ void tile_buckets(const Params& p, long long t,
                                             uint32_t (&bk)[kRows]) {
  using Key = typename std::conditional<k64, unsigned long long,
                                        uint32_t>::type;
  const Key* keys = static_cast<const Key*>(p.keys);
  const long long r0 = warp_row0(t) + (threadIdx.x & 31);
  Key kv[kRows];
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const long long i = r0 + s * 32;
    kv[s] = i < p.n ? __ldg(keys + i) : Key(0);
  }
#pragma unroll
  for (int s = 0; s < kRows; ++s)
    bk[s] = r0 + s * 32 < p.n ? bucket_of_key<k64>(p, kv[s]) : p.B;
  if (p.ids != nullptr) {
#pragma unroll
    for (int s = 0; s < kRows; ++s)
      if (bk[s] < p.B) p.ids[r0 + s * 32] = static_cast<int32_t>(bk[s]);
  }
}

// A warp's peers in one step, for B <= kRegBuckets: the lanes whose
// bucket equals `b` (`mine`) and, for lane j, the lanes in buckets j and
// j + 32 (`lo`, `hi`), from one ballot of each bucket bit; rows past n
// (b >= B) are no one's peers.
struct StepPeers {
  unsigned mine, lo, hi;
};

__device__ __forceinline__ StepPeers step_peers(uint32_t b, uint32_t B) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned valid = __ballot_sync(0xffffffffu, b < B);
  unsigned bal[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) bal[k] = __ballot_sync(0xffffffffu, (b >> k) & 1u);
  unsigned mine = valid, lanes = valid;
#pragma unroll
  for (int k = 0; k < 6; ++k) mine &= ((b >> k) & 1u) ? bal[k] : ~bal[k];
#pragma unroll
  for (int k = 0; k < 5; ++k) lanes &= ((lane >> k) & 1u) ? bal[k] : ~bal[k];
  return {mine, lanes & ~bal[5], lanes & bal[5]};
}

// The counts of buckets of tiles t0 .. t1-1 added to cnt[0..B).  kReg
// (B <= kRegBuckets): a warp counts in registers, lane j buckets j and
// j + 32, from ballots; else warp-aggregated shared atomics.
template <bool k64, bool kReg>
__device__ __forceinline__ void chunk_hist(const Params& p, long long t0,
                                           long long t1, uint32_t* cnt) {
  const unsigned lane = threadIdx.x & 31, lt = lanemask_lt();
  uint32_t c0 = 0, c1 = 0;
  for (long long t = t0; t < t1; ++t) {
    uint32_t bk[kRows];
    tile_buckets<k64>(p, t, bk);
    const long long w0 = warp_row0(t);
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      if (w0 + s * 32 < p.n) {
        if constexpr (kReg) {
          const StepPeers q = step_peers(bk[s], p.B);
          c0 += __popc(q.lo);
          c1 += __popc(q.hi);
        } else {
          const unsigned peers = __match_any_sync(0xffffffffu, bk[s]);
          if (bk[s] < p.B && (peers & lt) == 0)
            atomicAdd(cnt + bk[s], static_cast<uint32_t>(__popc(peers)));
        }
      }
    }
  }
  if constexpr (kReg) {
    if (c0) atomicAdd(cnt + lane, c0);
    if (c1) atomicAdd(cnt + lane + 32, c1);
  }
}

// Tile t's buckets (bk) and each row's rank among the earlier rows of its
// bucket in its warp (rk); hw[w * B + b] ends as warp w's first position
// in the tile's bucket b, cnt[b] as the tile's count.  kReg: a warp's
// running counts in registers (lane j: buckets j and j + 32), a row's
// read with a shuffle before the step adds its own; else in shared
// memory, read and written once a step by the lanes of a bucket.
template <bool k64, bool kReg>
__device__ __forceinline__ void tile_ranks(const Params& p, long long t,
                                           uint32_t (&bk)[kRows],
                                           uint32_t (&rk)[kRows],
                                           uint32_t* hw, uint32_t* cnt) {
  const uint32_t B = p.B;
  tile_buckets<k64>(p, t, bk);
  uint32_t* mine = hw + (threadIdx.x >> 5) * B;
  const long long w0 = warp_row0(t);
  const unsigned lane = threadIdx.x & 31, lt = lanemask_lt();
  if constexpr (kReg) {
    uint32_t c0 = 0, c1 = 0;
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      rk[s] = 0;
      if (w0 + s * 32 < p.n) {
        const uint32_t b = bk[s];
        const StepPeers q = step_peers(b, B);
        const uint32_t v0 = __shfl_sync(0xffffffffu, c0, b & 31);
        const uint32_t v1 = __shfl_sync(0xffffffffu, c1, b & 31);
        rk[s] = ((b & 32) ? v1 : v0) + __popc(q.mine & lt);
        c0 += __popc(q.lo);
        c1 += __popc(q.hi);
      }
    }
    if (lane < B) mine[lane] = c0;
    if (lane + 32 < B) mine[lane + 32] = c1;
  } else {
    for (unsigned i = threadIdx.x; i < kWarps * B; i += kThreads) hw[i] = 0;
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      rk[s] = 0;
      if (w0 + s * 32 < p.n) {
        const uint32_t b = bk[s];
        const unsigned peers = __match_any_sync(0xffffffffu, b);
        const uint32_t pre = b < B ? mine[b] : 0;
        rk[s] = pre + __popc(peers & lt);
        __syncwarp();
        if (b < B && (peers & lt) == 0) mine[b] = pre + __popc(peers);
        __syncwarp();
      }
    }
  }
  __syncthreads();
  for (unsigned b = threadIdx.x; b < B; b += kThreads) {
    uint32_t run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = hw[w * B + b];
      hw[w * B + b] = run;
      run += c;
    }
    cnt[b] = run;
  }
  __syncthreads();
}

// Rows of tile t to their positions: hw[w * B + b] holds warp w's first
// position of bucket b in the whole order.
__device__ __forceinline__ void scatter(const Params& p, long long t,
                                        const uint32_t (&bk)[kRows],
                                        const uint32_t (&rk)[kRows],
                                        const uint32_t* hw) {
  const long long r0 = warp_row0(t) + (threadIdx.x & 31);
  const uint32_t* mine = hw + (threadIdx.x >> 5) * p.B;
#pragma unroll
  for (int s = 0; s < kRows; ++s)
    if (bk[s] < p.B)
      p.order[mine[bk[s]] + rk[s]] = static_cast<int32_t>(r0 + s * 32);
}

// Rows of tile t (ranked by tile_ranks: bk, rk, hw, cnt) to their
// positions, gstart[b] the tile's first position of bucket b in the whole
// order.  kReg: the tile is staged in shared memory in bucket order
// (s_row, s_bkt), then written out with neighbouring threads on
// neighbouring positions, a run a bucket; else each row stored where it
// goes (through hw, which it changes).  Ends with the block's barrier.
template <bool kReg>
__device__ __forceinline__ void place(const Params& p, long long t,
                                      const uint32_t (&bk)[kRows],
                                      const uint32_t (&rk)[kRows],
                                      uint32_t* hw, const uint32_t* cnt,
                                      const uint32_t* gstart, uint32_t* ls,
                                      uint32_t* s_row, uint8_t* s_bkt) {
  const uint32_t B = p.B;
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (kReg) {
    warp_exclusive_scan64(cnt, ls, B);   // the tile's bucket starts
    __syncthreads();
    const long long r0 = warp_row0(t) + lane;
    const uint32_t* mine = hw + warp * B;
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const uint32_t b = bk[s];
      if (b < B) {
        const uint32_t at = ls[b] + mine[b] + rk[s];
        s_row[at] = static_cast<uint32_t>(r0 + s * 32);
        s_bkt[at] = static_cast<uint8_t>(b);
      }
    }
    __syncthreads();
    const unsigned rows =
        static_cast<unsigned>(min(static_cast<long long>(kTile),
                                  p.n - t * kTile));
    for (unsigned i = threadIdx.x; i < rows; i += kThreads) {
      const uint32_t b = s_bkt[i];
      p.order[gstart[b] + i - ls[b]] = static_cast<int32_t>(s_row[i]);
    }
  } else {
    for (unsigned b = threadIdx.x; b < B; b += kThreads) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) hw[w * B + b] += gstart[b];
    }
    __syncthreads();
    scatter(p, t, bk, rk, hw);
  }
  __syncthreads();
}

// Decoupled look-back of chunk c > 0: ex[b] = the count of bucket b in
// chunks 0 .. c-1.  W lanes a bucket, each loading kWindow words at once,
// read W * kWindow earlier chunks a round trip.
__device__ __forceinline__ void look_back(const Params& p, long long c,
                                          uint32_t* ex) {
  const uint32_t B = p.B;
  unsigned W = 1;
  while (W < 32 && W * 2 * B <= kThreads) W <<= 1;
  const unsigned lane = threadIdx.x & 31;
  const unsigned k = lane & (W - 1);
  const unsigned base_lane = lane & ~(W - 1);
  const unsigned gmask = (W == 32 ? 0xffffffffu : ((1u << W) - 1))
                         << base_lane;
  const unsigned groups = kThreads / W;
  for (uint32_t b = threadIdx.x / W; b < B; b += groups) {
    uint32_t acc = 0;
    for (long long j0 = c - 1 - static_cast<long long>(k) * kWindow;;
         j0 -= static_cast<long long>(W) * kWindow) {
      unsigned long long w[kWindow];
#pragma unroll
      for (int i = 0; i < kWindow; ++i)
        w[i] = j0 - i >= 0 ? ld_word(p.words + (j0 - i) * B + b) : kPrefix;
#pragma unroll
      for (int i = 0; i < kWindow; ++i)
        while ((w[i] & kFlags) == 0) w[i] = ld_word(p.words + (j0 - i) * B + b);
      // this lane's sum down to its nearest PREFIX
      uint32_t s = 0;
      bool found = false;
#pragma unroll
      for (int i = 0; i < kWindow; ++i) {
        if (!found) s += word_incl(w[i]);
        found = found || (w[i] & kFlags) == kPrefix;
      }
      const unsigned pre =
          (__ballot_sync(gmask, found) & gmask) >> base_lane;
      if (pre != 0 && k > static_cast<unsigned>(__ffs(pre) - 1)) s = 0;
      for (unsigned o = W >> 1; o > 0; o >>= 1)
        s += __shfl_xor_sync(gmask, s, o, W);
      acc += s;
      if (pre != 0) break;
    }
    if (k == 0) ex[b] = acc;
  }
}

// Route one_launch.  Shared memory (uint32): hw[kWarps * B], cnt[B],
// ex[B] (the last chunk's exclusive prefix, then the tile's first
// positions), sb[B] (the bucket starts), s_warp[kWarps + 1], s_tile,
// s_list[kMaxChunks] (the chunks this block took); kReg: also ls[B] (a
// tile's bucket starts), s_row[kTile], then s_bkt[kTile] bytes.
template <bool k64, bool kReg>
__global__ void __launch_bounds__(kThreads)
one_launch_kernel(Params p) {
  extern __shared__ uint32_t smem[];
  const uint32_t B = p.B;
  uint32_t* hw = smem;
  uint32_t* cnt = hw + kWarps * B;
  uint32_t* ex = cnt + B;
  uint32_t* sb = ex + B;
  uint32_t* s_warp = sb + B;
  uint32_t* s_tile = s_warp + kWarps + 1;
  uint32_t* s_list = s_tile + 1;
  uint32_t* ls = s_list + kMaxChunks;
  uint32_t* s_row = ls + B;
  uint8_t* s_bkt = reinterpret_cast<uint8_t*>(s_row + kTile);
  uint32_t bk[kRows], rk[kRows];

  if (p.chunks == 1) {          // the whole call is one tile
    tile_ranks<k64, kReg>(p, 0, bk, rk, hw, cnt);
    for (unsigned b = threadIdx.x; b < B; b += kThreads) {
      sb[b] = cnt[b];
      if (p.counts != nullptr) p.counts[b] = static_cast<int32_t>(cnt[b]);
    }
    __syncthreads();
    bucket_scan<kReg>(sb, B, s_warp);
    if (p.order == nullptr) return;
    for (unsigned b = threadIdx.x; b < B; b += kThreads)
      p.bounds[b] = static_cast<int32_t>(sb[b]);
    if (threadIdx.x == 0) p.bounds[B] = static_cast<int32_t>(p.n);
    place<kReg>(p, 0, bk, rk, hw, cnt, sb, ls, s_row, s_bkt);
    return;
  }

  // phase 1: chunks by ticket, counted and published, then looked back
  const long long C = p.chunks, K = p.chunk_tiles;
  const unsigned G = gridDim.x;
  unsigned taken = 0;
  long long kept = -1;          // the one-tile chunk held in registers
  for (;;) {
    if (threadIdx.x == 0)
      *s_tile = take_ticket(p.head, static_cast<unsigned>(C) + G - 1);
    if (K > 1)
      for (unsigned b = threadIdx.x; b < B; b += kThreads) cnt[b] = 0;
    __syncthreads();
    const long long c = *s_tile;
    if (c >= C) break;
    if (K == 1) {
      tile_ranks<k64, kReg>(p, c, bk, rk, hw, cnt);
      kept = c;
    } else {
      chunk_hist<k64, kReg>(p, c * K, min(p.tiles, (c + 1) * K), cnt);
      __syncthreads();
    }
    unsigned long long* mine = p.words + c * B;
    for (unsigned b = threadIdx.x; b < B; b += kThreads) {
      const unsigned long long w =
          static_cast<unsigned long long>(cnt[b]) << 31;
      st_word(mine + b, (c == 0 ? kPrefix : kAgg) | w);
      if (c == 0) ex[b] = 0;
    }
    if (c > 0) {
      look_back(p, c, ex);
      __syncthreads();
      for (unsigned b = threadIdx.x; b < B; b += kThreads)
        st_word(mine + b, kPrefix |
                              static_cast<unsigned long long>(cnt[b]) << 31 |
                              ex[b]);
    }
    if (threadIdx.x == 0) s_list[taken] = static_cast<uint32_t>(c);
    ++taken;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (taken > 0) {
      __threadfence();
      atomicAdd(p.head + 1, taken);
    }
    while (ld_acquire(p.head + 1) < static_cast<unsigned>(C)) {
    }
    __threadfence();
  }
  __syncthreads();

  // phase 2: the bucket starts from the last chunk's word, then the
  // scatter of this block's chunks, the one in registers first
  const unsigned long long* last = p.words + (C - 1) * B;
  for (unsigned b = threadIdx.x; b < B; b += kThreads) {
    const uint32_t total = word_incl(ld_word(last + b));
    sb[b] = total;
    if (p.counts != nullptr && blockIdx.x == 0)
      p.counts[b] = static_cast<int32_t>(total);
  }
  __syncthreads();
  bucket_scan<kReg>(sb, B, s_warp);
  if (p.order != nullptr && blockIdx.x == 0) {
    for (unsigned b = threadIdx.x; b < B; b += kThreads)
      p.bounds[b] = static_cast<int32_t>(sb[b]);
    if (threadIdx.x == 0) p.bounds[B] = static_cast<int32_t>(p.n);
  }
  if (p.order != nullptr && kept >= 0) {
    for (unsigned b = threadIdx.x; b < B; b += kThreads) ex[b] += sb[b];
    __syncthreads();
    place<kReg>(p, kept, bk, rk, hw, cnt, ex, ls, s_row, s_bkt);
  }
  for (unsigned i = 0; i < taken; ++i) {
    const long long c = s_list[i];
    unsigned long long* mine = p.words + c * B;
    if (p.order != nullptr && c != kept) {
      for (unsigned b = threadIdx.x; b < B; b += kThreads)
        ex[b] = sb[b] + word_excl(ld_word(mine + b));
      const long long t1 = min(p.tiles, (c + 1) * K);
      for (long long t = c * K; t < t1; ++t) {
        tile_ranks<k64, kReg>(p, t, bk, rk, hw, cnt);
        place<kReg>(p, t, bk, rk, hw, cnt, ex, ls, s_row, s_bkt);
        for (unsigned b = threadIdx.x; b < B; b += kThreads) ex[b] += cnt[b];
      }
    }
    if (c != C - 1)
      for (unsigned b = threadIdx.x; b < B; b += kThreads) st_word(mine + b, 0);
  }

  // the block to exit last leaves the scratch as the launch found it
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *s_tile = take_ticket(p.head + 2, G - 1) == G - 1;
  }
  __syncthreads();
  if (*s_tile) {
    unsigned long long* lastw = p.words + (C - 1) * B;
    for (unsigned b = threadIdx.x; b < B; b += kThreads) st_word(lastw + b, 0);
    if (threadIdx.x == 0) atomicExch(p.head + 1, 0u);
  }
}

// Route two_launch, launch 1: chunk g's counts into chunk_counts[g * B +
// b]; the last block to take a ticket turns them into each chunk's start
// of each bucket and writes counts and bounds.
template <bool k64>
__global__ void __launch_bounds__(kThreads)
chunk_hist_kernel(Params p) {
  extern __shared__ uint32_t smem[];
  const uint32_t B = p.B;
  uint32_t* hist = smem;
  uint32_t* s_warp = hist + B;
  uint32_t* s_last = s_warp + kWarps + 1;
  const long long chunk = p.tiles;
  const long long lo = blockIdx.x * chunk;
  const long long hi = min(p.n, lo + chunk);
  for (unsigned b = threadIdx.x; b < B; b += kThreads) hist[b] = 0;
  __syncthreads();
  const unsigned lt = lanemask_lt();
  for (long long i0 = lo; i0 < hi; i0 += kThreads) {
    const long long i = i0 + threadIdx.x;
    const uint32_t b = i < hi ? bucket_of<k64>(p, i) : B;
    if (b < B && p.ids != nullptr) p.ids[i] = static_cast<int32_t>(b);
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (b < B && (peers & lt) == 0)
      atomicAdd(hist + b, static_cast<uint32_t>(__popc(peers)));
  }
  __syncthreads();
  int32_t* mine = p.chunk_counts + blockIdx.x * static_cast<long long>(B);
  for (unsigned b = threadIdx.x; b < B; b += kThreads)
    mine[b] = static_cast<int32_t>(hist[b]);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *s_last = take_ticket(p.head + 3, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!*s_last) return;
  for (unsigned b = threadIdx.x; b < B; b += kThreads) {
    uint32_t run = 0;
    for (unsigned g = 0; g < gridDim.x; ++g) {
      int32_t* c = p.chunk_counts + g * static_cast<long long>(B) + b;
      const uint32_t v = static_cast<uint32_t>(__ldcg(c));
      *c = static_cast<int32_t>(run);
      run += v;
    }
    hist[b] = run;
    if (p.counts != nullptr) p.counts[b] = static_cast<int32_t>(run);
  }
  __syncthreads();
  if (p.bounds == nullptr) return;
  block_exclusive_scan(hist, B, s_warp);
  for (unsigned b = threadIdx.x; b < B; b += kThreads)
    p.bounds[b] = static_cast<int32_t>(hist[b]);
  if (threadIdx.x == 0) p.bounds[B] = static_cast<int32_t>(p.n);
}

// Route two_launch, launch 2: one warp walks chunk g in row order.
template <bool k64>
__global__ void __launch_bounds__(32)
chunk_scatter_kernel(Params p) {
  extern __shared__ uint32_t run[];
  const uint32_t B = p.B;
  const unsigned lane = threadIdx.x;
  const long long chunk = p.tiles;
  const long long lo = blockIdx.x * chunk;
  const long long hi = min(p.n, lo + chunk);
  const int32_t* mine =
      p.chunk_counts + blockIdx.x * static_cast<long long>(B);
  for (unsigned b = lane; b < B; b += 32)
    run[b] = static_cast<uint32_t>(mine[b] + p.bounds[b]);
  __syncwarp();
  const unsigned lt = lanemask_lt();
  for (long long i0 = lo; i0 < hi; i0 += 32 * kRows) {
    uint32_t bk[kRows];
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const long long i = i0 + s * 32 + lane;
      bk[s] = i < hi ? bucket_of<k64>(p, i) : B;
    }
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const uint32_t b = bk[s];
      const unsigned peers = __match_any_sync(0xffffffffu, b);
      const uint32_t pre = b < B ? run[b] : 0;
      if (b < B)
        p.order[pre + __popc(peers & lt)] =
            static_cast<int32_t>(i0 + s * 32 + lane);
      __syncwarp();
      if (b < B && (peers & lt) == 0) run[b] = pre + __popc(peers);
      __syncwarp();
    }
  }
}

template <bool k64>
int launch(const Params& p, int route, int blocks, bool split,
           cudaStream_t stream) {
  const uint32_t B = p.B;
  if (route == kRouteOne) {
    const size_t smem =
        ((kWarps + 3) * B + kWarps + 2 + kMaxChunks) * sizeof(uint32_t);
    if (B <= kRegBuckets)
      one_launch_kernel<k64, true><<<blocks, kThreads,
                                     smem + (B + kTile) * sizeof(uint32_t) +
                                         kTile,
                                     stream>>>(p);
    else
      one_launch_kernel<k64, false><<<blocks, kThreads, smem, stream>>>(p);
  } else {
    const size_t smem = (B + kWarps + 2) * sizeof(uint32_t);
    chunk_hist_kernel<k64><<<blocks, kThreads, smem, stream>>>(p);
    if (split) {
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
      chunk_scatter_kernel<k64><<<blocks, 32, B * sizeof(uint32_t),
                                  stream>>>(p);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One call of the radix partition.  `word` (RadixPlan.word): bit 0 int64
// keys (folded here), bits 1-3 the outputs (ids, counts, split), bits 4-5
// the route (0 one_launch, 1 two_launch), bits 8-23 the blocks, bits
// 24-39 the chunks, bits 40-63 the tiles a chunk (one_launch) or a
// chunk's rows (two_launch).  `out` is the call's one int32 allocation:
// order (n) and bounds (B + 1) when split, then ids (n) when asked, then
// counts (B) when asked, then the chunks' counts (blocks x B) on
// two_launch.  `scratch` is the stream's zeroed words
// (radix_partition.SCRATCH_WORDS; none needed for one chunk), left
// zeroed.  Returns cudaGetLastError() after the launches (0 on success).
extern "C" int shark_radix(const void* keys, long long n,
                           unsigned int num_buckets, unsigned long long word,
                           int32_t* out, unsigned long long* scratch,
                           cudaStream_t stream) {
  const int route = static_cast<int>((word >> 4) & 3);
  const int blocks = static_cast<int>((word >> 8) & 0xffff);
  const long long chunks = static_cast<long long>((word >> 24) & 0xffff);
  const long long per = static_cast<long long>(word >> 40);
  const long long tiles = n > kTile ? (n + kTile - 1) / kTile : 1;
  const bool ids = word & kIds, counts = word & kCounts,
             split = word & kSplit;
  if (n < 0 || n > 0x7fffffffLL || blocks < 1 || num_buckets < 1 ||
      num_buckets > kMaxBuckets || route > kRouteTwo ||
      (route == kRouteOne &&
       (num_buckets > kOneLaunchMax || per < 1 || chunks > kMaxChunks ||
        chunks != (tiles + per - 1) / per || blocks != chunks ||
        (chunks == 1 && tiles != 1) ||
        (chunks > 1 && scratch == nullptr))) ||
      (route == kRouteTwo && (per * blocks < n || scratch == nullptr)) ||
      !(ids || counts || split) || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.keys = keys;
  p.n = n;
  p.B = num_buckets;
  p.mask = (num_buckets & (num_buckets - 1)) == 0 ? num_buckets - 1 : 0;
  p.tiles = route == kRouteTwo ? per : tiles;
  p.chunks = chunks;
  p.chunk_tiles = per;
  int32_t* at = out;
  p.order = split ? at : nullptr;
  at += split ? n : 0;
  p.bounds = split ? at : nullptr;
  at += split ? num_buckets + 1 : 0;
  p.ids = ids ? at : nullptr;
  at += ids ? n : 0;
  p.counts = counts ? at : nullptr;
  at += counts ? num_buckets : 0;
  p.chunk_counts = route == kRouteTwo ? at : nullptr;
  p.head = reinterpret_cast<unsigned*>(scratch);
  p.words = scratch != nullptr ? scratch + 2 : nullptr;
  return word & kKeys64 ? launch<true>(p, route, blocks, split, stream)
                        : launch<false>(p, route, blocks, split, stream);
}
